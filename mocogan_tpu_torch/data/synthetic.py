"""Synthetic MovingMNIST-style clips and a uint8 clip store made of them.

Clips are bouncing coloured rectangles with constant velocity: enough
temporal structure for D_V to have signal. Pure numpy, deterministic from
an integer seed; class labels encode the number of sprites minus one.
The real MUG corpus is not in the repository, so this store stands in for
it on both training paths; ``batch_iterator`` feeds the toy config's float
batches straight to the host-fed trainer.

Render a store (one (T, H, W, C) uint8 .npy per clip):
    python -m mocogan_tpu_torch.data.synthetic --out data/synth96 \
        --clips 96 --frames 32 --size 96
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, Tuple

import numpy as np


def make_batch(seed: int, batch: int, t: int = 16, size: int = 64,
               channels: int = 3, n_classes: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (videos (B,T,H,W,C) float32 in [-1,1], labels (B,) int32)."""
    rng = np.random.default_rng(seed)
    videos = np.full((batch, t, size, size, channels), -1.0, np.float32)
    max_sprites = max(n_classes, 2)
    labels = rng.integers(0, max_sprites, size=batch) if n_classes == 0 \
        else rng.integers(0, n_classes, size=batch)
    for b in range(batch):
        n_sprites = int(labels[b]) + 1
        for _ in range(n_sprites):
            w = int(rng.integers(size // 8, size // 3))
            h = int(rng.integers(size // 8, size // 3))
            x = float(rng.uniform(0, size - w))
            y = float(rng.uniform(0, size - h))
            vx = float(rng.uniform(-3, 3))
            vy = float(rng.uniform(-3, 3))
            color = rng.uniform(-0.2, 1.0, size=channels).astype(np.float32)
            for ti in range(t):
                xi, yi = int(round(x)), int(round(y))
                videos[b, ti, yi:yi + h, xi:xi + w] = color
                x += vx
                y += vy
                if x < 0 or x > size - w:
                    vx = -vx
                    x = min(max(x, 0.0), float(size - w))
                if y < 0 or y > size - h:
                    vy = -vy
                    y = min(max(y, 0.0), float(size - h))
    return videos, labels.astype(np.int32)


def batch_iterator(seed: int, batch: int, t: int = 16, size: int = 64,
                   channels: int = 3, n_classes: int = 0,
                   start_batch: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless stream of ``make_batch`` batches; batch k is a pure function
    of (seed, k), so a run restarted at ``start_batch`` = the restored step
    continues the same stream."""
    i = int(start_batch)
    while True:
        yield make_batch(seed * 1_000_003 + i, batch, t, size, channels,
                         n_classes)
        i += 1


def render_clip(seed: int, i: int, frames: int, size: int,
                classes: int = 0) -> Tuple[np.ndarray, int]:
    """Clip i of a store: ((T, H, W, 3) uint8, label)."""
    vids, labels = make_batch(seed * 7_777_777 + i, 1, t=frames, size=size,
                              n_classes=classes)
    u8 = np.clip((vids[0] + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return u8, int(labels[0])


def write_store(out: str, clips: int = 96, frames: int = 32, size: int = 96,
                classes: int = 0, seed: int = 0) -> str:
    """Write a clip store: <out>/[class<k>/]clip<i>.npy. Returns `out`."""
    for i in range(clips):
        u8, label = render_clip(seed, i, frames, size, classes)
        d = os.path.join(out, f"class{label}") if classes else out
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"clip{i:04d}.npy"), u8)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", required=True, help="clip-store directory")
    ap.add_argument("--clips", type=int, default=96)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--classes", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    write_store(a.out, a.clips, a.frames, a.size, a.classes, a.seed)
    print(f"[synthetic store] wrote {a.clips} clips ({a.frames}f @ "
          f"{a.size}px, classes={a.classes or 1}) to {a.out}")


if __name__ == "__main__":
    main()
