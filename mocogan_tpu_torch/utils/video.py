"""Sample export: tile clips into a grid and write it as an animated GIF,
one GIF per clip, or an mp4 where OpenCV has a codec.

GIFs are written with PIL, each frame quantized to its own 256-colour
palette. Where PIL is not installed, the uint8 frames go to a ``.npy``
file beside the requested path instead (the same array the GIF would
hold) and one line says so.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def tile_videos(videos: np.ndarray, cols: Optional[int] = None) -> np.ndarray:
    """(N, T, H, W, C) uint8 -> (T, rows*H, cols*W, C) tiled grid."""
    n, t, h, w, c = videos.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    pad = rows * cols - n
    if pad:
        videos = np.concatenate(
            [videos, np.zeros((pad, t, h, w, c), videos.dtype)], axis=0)
    grid = videos.reshape(rows, cols, t, h, w, c)
    grid = grid.transpose(2, 0, 3, 1, 4, 5)          # (T, rows, H, cols, W, C)
    return grid.reshape(t, rows * h, cols * w, c)


def save_gif(frames: np.ndarray, path: str, fps: int = 12) -> str:
    """frames: (T, H, W, C) uint8. Returns the path written: `path`, or,
    without PIL, `path` with the extension ``.npy`` holding `frames`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        npy = os.path.splitext(path)[0] + ".npy"
        np.save(npy, frames)
        print(f"[video] PIL is not installed: wrote the uint8 frames "
              f"{frames.shape} to {npy} instead of a GIF")
        return npy
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    # a 256-colour palette per frame by fast octree quantization: PIL's
    # default for RGB frames, median cut, took seconds a sample grid and
    # stalled the trainer that long (PERF.md)
    imgs = [Image.fromarray(f).quantize(256,
                                        method=Image.Quantize.FASTOCTREE)
            for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1, int(1000 / fps)), loop=0)
    return path


def save_video_grid(videos: np.ndarray, path: str, fps: int = 12,
                    cols: Optional[int] = None) -> str:
    """(N, T, H, W, C) uint8 -> tiled animated GIF at `path` (``.npy``
    without PIL). Returns the path written."""
    return save_gif(tile_videos(videos, cols), path, fps)


def save_individual_gifs(videos: np.ndarray, out_dir: str,
                         prefix: str = "clip", fps: int = 12) -> list:
    """One GIF per clip: (N, T, H, W, C) uint8 -> out_dir/prefix_i.gif."""
    os.makedirs(out_dir, exist_ok=True)
    return [save_gif(v, os.path.join(out_dir, f"{prefix}_{i:03d}.gif"), fps)
            for i, v in enumerate(videos)]


def save_mp4(frames: np.ndarray, path: str, fps: int = 12) -> Optional[str]:
    """Best-effort mp4 via OpenCV; returns None if no codec works."""
    try:
        import cv2
    except ImportError:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t, h, w, c = frames.shape
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        return None
    for f in frames:
        if c == 1:
            f = np.repeat(f, 3, axis=-1)
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    return path
