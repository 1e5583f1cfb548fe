"""ctypes bindings for the native clip store (``csrc/clipstore.cc``):
mmap'd .npy clips and batch assembly in C++, one memcpy per run of frames.

The library is built with g++ at first use into ``mocogan_tpu_torch/
build/`` (``utils.cuda_build.load_host``). ``load_library()`` returns None
when it cannot be built or loaded; ``clips.clip_batch_iterator`` then
assembles batches with numpy, byte for byte the same.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mocogan_tpu_torch.utils import cuda_build

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native library; None on failure."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib, _ = cuda_build.load_host("clipstore")
    except (OSError, RuntimeError) as e:
        warnings.warn(f"native clipstore unavailable: {e}")
        _lib_failed = True
        return None
    lib.cs_open.restype = ctypes.c_void_p
    lib.cs_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_char_p, ctypes.c_int]
    lib.cs_clip_count.restype = ctypes.c_int
    lib.cs_clip_count.argtypes = [ctypes.c_void_p]
    lib.cs_clip_frames.restype = ctypes.c_int64
    lib.cs_clip_frames.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cs_dims.restype = None
    lib.cs_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.cs_fill_batch.restype = ctypes.c_int
    lib.cs_fill_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.cs_close.restype = None
    lib.cs_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return load_library() is not None


class NativeClipStore:
    """mmap-backed store over .npy uint8 clips with batch assembly in C++."""

    def __init__(self, paths: Sequence[str], labels: Sequence[int]):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native clipstore library unavailable")
        self._lib = lib
        self.paths: List[str] = list(paths)
        self.labels = np.asarray(labels, np.int32)
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in self.paths])
        err = ctypes.create_string_buffer(512)
        self._h = lib.cs_open(arr, len(paths), err, len(err))
        if not self._h:
            raise ValueError(f"cs_open: {err.value.decode()}")
        dims = (ctypes.c_int64 * 3)()
        lib.cs_dims(self._h, dims)
        self.frame_shape: Tuple[int, int, int] = (dims[0], dims[1], dims[2])

    def __len__(self) -> int:
        return self._lib.cs_clip_count(self._h)

    def clip_frames(self, i: int) -> int:
        return int(self._lib.cs_clip_frames(self._h, i))

    def fill_batch(self, clip_idx: np.ndarray, starts: np.ndarray,
                   t: int) -> np.ndarray:
        """Assemble (B, t, H, W, C) uint8; frames (start + j) % length, so
        short clips wrap."""
        b = len(clip_idx)
        h, w, c = self.frame_shape
        out = np.empty((b, t, h, w, c), np.uint8)
        ci = np.ascontiguousarray(clip_idx, np.int32)
        ss = np.ascontiguousarray(starts, np.int64)
        rc = self._lib.cs_fill_batch(
            self._h,
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ss.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b, t, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IndexError("cs_fill_batch: clip index out of range")
        return out

    def close(self):
        if self._h:
            self._lib.cs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError):
            pass
