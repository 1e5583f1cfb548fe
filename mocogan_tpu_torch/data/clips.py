"""The uint8 clip store: <data_dir>/[<class>/]<clip>.npy, one (T, H, W, C)
uint8 array per clip. Class subdirectories give the labels.

Two ways to feed it to the trainer:
  * device-cached: ``load_pool`` reads the whole store into one padded
    array, which the trainer uploads once;
  * host-fed: ``clip_batch_iterator`` assembles each batch's windows on the
    host (through the native store, ``data/native.py``, where it builds) and
    the trainer uploads them.
Both read the windows of ``ops.sampling.batch_plan``, so for one (seed,
step) the two paths train on the same frames.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from mocogan_tpu_torch.configs import ExperimentConfig
from mocogan_tpu_torch.ops import sampling


class ClipDataset:
    """Indexes <data_dir>/[<class>/]<clip>.npy files of uint8 frames."""

    def __init__(self, data_dir: str, video_length: int):
        self.data_dir = data_dir
        self.video_length = video_length
        self.files: List[str] = []
        self.labels: List[int] = []
        self.class_names: List[str] = []
        # Class dirs are subdirectories holding at least one .npy; others
        # (logs/, an empty class) are ignored. Mixing class dirs with
        # top-level clips is refused.
        subdirs = sorted(
            d for d in os.listdir(data_dir)
            if os.path.isdir(os.path.join(data_dir, d)) and any(
                f.endswith(".npy")
                for f in os.listdir(os.path.join(data_dir, d))))
        flat = sorted(f for f in os.listdir(data_dir) if f.endswith(".npy"))
        if subdirs and flat:
            raise ValueError(
                f"{data_dir} mixes class subdirectories {subdirs} with "
                f"top-level clips ({len(flat)} .npy); use one layout")
        if subdirs:
            self.class_names = subdirs
            for ci, d in enumerate(subdirs):
                for f in sorted(os.listdir(os.path.join(data_dir, d))):
                    if f.endswith(".npy"):
                        self.files.append(os.path.join(data_dir, d, f))
                        self.labels.append(ci)
        else:
            self.files = [os.path.join(data_dir, f) for f in flat]
            self.labels = [0] * len(self.files)
        if not self.files:
            raise FileNotFoundError(f"no .npy clips under {data_dir}")

    def __len__(self) -> int:
        return len(self.files)

    @property
    def n_classes(self) -> int:
        return max(1, len(self.class_names))

    def get_example(self, i: int, rng: np.random.Generator
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """(raw clip uint8 (T_raw, H, W, C), window indices (T,), label): a
        random contiguous window of video_length frames; a clip shorter
        than the window is looped."""
        clip = np.load(self.files[i], mmap_mode="r")
        t_raw = clip.shape[0]
        t = self.video_length
        if t_raw >= t:
            start = int(rng.integers(0, t_raw - t + 1))
            idx = np.arange(start, start + t)
        else:
            idx = np.arange(t) % t_raw
        return np.asarray(clip), idx.astype(np.int32), self.labels[i]


def load_pool(data_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The whole store as one padded array for the device-resident cache:
    (pool (N, T_max, H, W, C) uint8, lengths (N,) int32, labels (N,)
    int32). Shorter clips are zero-padded; `lengths` bounds the window
    sampling so padding is never read."""
    ds = ClipDataset(data_dir, video_length=1)
    clips_list = [np.load(f, mmap_mode="r") for f in ds.files]
    t_max = max(c.shape[0] for c in clips_list)
    h, w, c = clips_list[0].shape[1:]
    pool = np.zeros((len(clips_list), t_max, h, w, c), np.uint8)
    lengths = np.empty((len(clips_list),), np.int32)
    for i, clip in enumerate(clips_list):
        if clip.dtype != np.uint8 or clip.shape[1:] != (h, w, c):
            raise ValueError(f"{ds.files[i]}: {clip.dtype} {clip.shape[1:]}, "
                             f"want uint8 {(h, w, c)}")
        pool[i, :clip.shape[0]] = clip
        lengths[i] = clip.shape[0]
    return pool, lengths, np.asarray(ds.labels, np.int32)


def assemble_numpy(files: List[str], lengths: np.ndarray, sel: np.ndarray,
                   starts: np.ndarray, t: int) -> np.ndarray:
    """(B, t, H, W, C) uint8 windows, frames (start + j) % length of each
    selected clip: the native store's ``fill_batch`` in numpy."""
    return np.stack([
        np.asarray(np.load(files[int(i)], mmap_mode="r")[
            (int(st) + np.arange(t)) % int(lengths[int(i)])])
        for i, st in zip(sel, starts)])


def _open_native(ds: ClipDataset, use_native: Optional[bool]):
    """The native store over `ds`, or None: ``use_native=None`` takes it
    where it builds and warns otherwise, True raises where it cannot."""
    if use_native is False:
        return None
    from mocogan_tpu_torch.data import native

    if not native.native_available():
        if use_native:
            raise RuntimeError("native clipstore requested but unavailable")
        return None
    try:
        return native.NativeClipStore(ds.files, ds.labels)
    except (ValueError, RuntimeError) as e:
        if use_native:
            raise
        warnings.warn(f"native clipstore rejected dataset: {e}")
        return None


def clip_batch_iterator(cfg: ExperimentConfig,
                        dataset: Optional[ClipDataset] = None,
                        seed: Optional[int] = None,
                        use_native: Optional[bool] = None,
                        start_batch: int = 0
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless {"raw" (B, T, H, W, C) uint8, "frame_idx" (B, T) int32,
    "labels" (B,) int32} batches of clip windows.

    Batch k reads the windows ``sampling.batch_plan(seed, k, ...)`` selects,
    the plan the device-cached path draws for step k, so a run restarted at
    ``start_batch`` = the restored step continues the same stream, and the
    stream is byte-identical whether the native store or numpy assembles
    it. All clips must share (H, W, C)."""
    ds = dataset or ClipDataset(cfg.data.data_dir, cfg.model.video_length)
    if cfg.model.conditional and ds.n_classes > cfg.model.n_classes:
        raise ValueError(f"dataset has {ds.n_classes} classes but "
                         f"model.n_classes={cfg.model.n_classes}")
    base_seed = cfg.train.seed if seed is None else seed
    b = cfg.train.batch_size
    t = cfg.model.video_length
    trivial_idx = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    store = _open_native(ds, use_native)
    labels = np.asarray(ds.labels, np.int32)
    lengths = (np.asarray([store.clip_frames(i) for i in range(len(ds))])
               if store is not None else
               np.asarray([np.load(f, mmap_mode="r").shape[0]
                           for f in ds.files]))
    k = int(start_batch)
    while True:
        sel, starts = (x.numpy() for x in sampling.batch_plan(
            base_seed, k, b, lengths, t, cfg.data.epoch_shuffle))
        k += 1
        raw = (store.fill_batch(sel, starts, t) if store is not None else
               assemble_numpy(ds.files, lengths, sel, starts, t))
        yield {"raw": raw, "frame_idx": trivial_idx, "labels": labels[sel]}
