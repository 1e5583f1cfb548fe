"""Timers of the port's training and sampling paths, with the JAX package's
names, defaults and return contract.

Every timer reports the median and the best over back-to-back windows,
``{"best", "median", "windows"}`` (the rates of the windows, rounded to 2
decimals). The median is the central tendency; the best shows how far a
window can be held back by its host, which shares its cores with others.

Traps on the card, and what the timers do about them:
  * Nothing in a timed window reads the device, except the one host read
    at its end. Streams run in order, so that read bounds all the queued
    work. No ``torch.cuda.synchronize()`` runs inside a window, and
    ``state.debug_nans`` stays off (it is ``False`` in a fresh state;
    ``train.step._check_finite`` reads every step's losses when it is on).
  * The rate is the host clock over the window, as in the JAX package, not
    CUDA events: a step's host work (its plan, its noise draws and their
    uploads) is part of what it costs.
  * Warm-up covers first use: the first ``cached_multi_train_step`` builds
    ``csrc/resize_norm.cu`` with nvcc and picks cuDNN algorithms, and the
    first ``generate`` builds its own cuDNN plans. A window that paid a
    build would read as a slow first window.
  * Precision is the caller's: a timer leaves the TF32 switches as it finds
    them (``chip_smoke.py`` turns TF32 off, so fp32 is full fp32).
  * ``generate`` runs the deconvs' own deterministic routes
    (``ops/layers.py``), with no cuDNN flag.

Each timer takes ``device`` (``None`` means ``cuda``; it raises when no GPU
is visible unless ``device="cpu"``) and builds its state from the config's
seed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mocogan_tpu_torch.data import synthetic
from mocogan_tpu_torch.models import generator
from mocogan_tpu_torch.ops import preproc
from mocogan_tpu_torch.train import state as train_state
from mocogan_tpu_torch.train import step as train_step
from mocogan_tpu_torch.utils.platform import resolve_device


def _stats(rates: List[float]) -> Dict[str, float]:
    return {"best": float(max(rates)),
            "median": float(np.median(rates)),
            "windows": [round(r, 2) for r in rates]}


def _read(metrics: Dict[str, torch.Tensor]) -> np.ndarray:
    """One host copy of all the metrics: the window's only device read."""
    return torch.stack([v.float() for v in metrics.values()]).cpu().numpy()


def time_single_step(cfg, steps: int = 50, warmup: int = 6,
                     windows: int = 3, *, device=None) -> Dict[str, float]:
    """Steps/s of ``train_step`` called once per step on one resident
    synthetic batch. Each step draws its noise on the host and uploads it,
    the port's counterpart of the draw JAX makes inside its jitted step.
    Returns {"best", "median", "windows"} over `windows` back-to-back
    windows of `steps` steps, after `warmup` steps and a read."""
    dev = resolve_device(device)
    s = train_state.create(cfg, device=dev)
    mc = cfg.model
    vids, labels = synthetic.make_batch(0, cfg.train.batch_size,
                                        t=mc.video_length,
                                        size=mc.image_size,
                                        channels=mc.channels,
                                        n_classes=mc.n_classes)
    v = torch.from_numpy(vids).to(dev)
    lab = torch.from_numpy(labels).to(dev) if mc.conditional else None
    for _ in range(warmup):
        m = train_step.train_step(s, v, labels=lab)
    _read(m)
    rates = []
    for _ in range(max(1, windows)):
        t0 = time.perf_counter()
        for _ in range(steps):
            m = train_step.train_step(s, v, labels=lab)
        _read(m)
        rates.append(steps / (time.perf_counter() - t0))
    return _stats(rates)


def time_cached_scan(cfg, k: int = 16, reps: int = 4, n_clips: int = 64,
                     windows: int = 2, *, device=None) -> Dict[str, float]:
    """Steps/s of the production device-cached path:
    ``cached_multi_train_step`` with a uint8 pool resident on the device,
    k steps a call, each gathering and resizing its batch in one launch of
    the ingest kernel. Returns {"best", "median", "windows"}; a window
    queues `reps` calls with no read between them, as the trainer does, and
    its rate is k * reps over its seconds.

    The pool is the JAX timer's, from the same generator: random uint8
    clips of T + 8 frames stored at cfg.data.raw_size (96 px for mug), not
    at the training size, so the resize does its real 96 -> 64 work."""
    dev = resolve_device(device)
    m = cfg.model
    raw = max(cfg.data.raw_size, m.image_size)
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, (n_clips, m.video_length + 8, raw, raw,
                                 m.channels), dtype=np.uint8)
    lengths = np.full((n_clips,), m.video_length + 8, np.int32)
    labels: Optional[torch.Tensor] = None
    if m.conditional:
        labels = torch.from_numpy(
            rng.integers(0, m.n_classes, (n_clips,)).astype(np.int32))
    pool_d = torch.from_numpy(pool).to(dev)
    lengths_t = torch.from_numpy(lengths)
    rh, rw = preproc.resize_weights(raw, raw, m.image_size, dev)
    s = train_state.create(cfg, device=dev)

    def call():
        return train_step.cached_multi_train_step(s, pool_d, lengths_t, k,
                                                  rh, rw, labels=labels)

    _read(call())
    rates = []
    for _ in range(max(1, windows)):
        t0 = time.perf_counter()
        for _ in range(max(1, reps)):
            metrics = call()
        _read(metrics)
        rates.append(k * max(1, reps) / (time.perf_counter() - t0))
    return _stats(rates)


def time_generate(cfg, n_clips: int, reps: int = 10, windows: int = 3, *,
                  device=None) -> Dict[str, float]:
    """Inference clips/s of ``generate`` at `n_clips` clips a call, with
    the JAX timer's keys as seeds (0 for the warm-up, then
    w * reps + i + 1). Returns {"best", "median", "windows"}; each window
    ends in a host read of one element of its last clips."""
    dev = resolve_device(device)
    g = train_state.create(cfg, device=dev).nets["gen"]
    out = generator.generate(g, n_clips, seed=0)
    out[0, 0, 0, 0, :1].cpu()
    rates = []
    for w in range(max(1, windows)):
        t0 = time.perf_counter()
        for i in range(reps):
            out = generator.generate(g, n_clips, seed=w * reps + i + 1)
        out[0, 0, 0, 0, :1].cpu()
        rates.append(n_clips * reps / (time.perf_counter() - t0))
    return _stats(rates)
