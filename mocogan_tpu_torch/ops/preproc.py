"""Fused on-device video ingest: temporal gather -> bilinear resize ->
[-1, 1], for the device-cached training path.

Bilinear resize is two matrix products per (H, W) plane,
``Z = R_h X R_w``, with the half-pixel-centre, edge-clamped weights of
cv2's INTER_LINEAR (``bilinear_matrix``). On the card this is one launch of
the hand-written CUDA kernel ``csrc/resize_norm.cu``, which takes the same
weights as 2-tap tables (``resize_taps``); on the CPU it is the plain
PyTorch version beside it, which is also what the card's kernel is held
against. A CUDA tensor goes through the kernel or raises: there is no
fallback.

Under data parallelism each rank launches the kernel on its own rows of
the global batch plan (``train.step.shard_draws``), the counterpart of the
JAX package's ``resize_normalize_sharded``: no collective is involved.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mocogan_tpu_torch.utils import cuda_build

# Launches of each kernel of this module; a run resets and reads it to show
# that its path went through the kernel.
LAUNCHES = {"resize_norm": 0}

_SCALE = 2.0 / 255.0
_OFFSET = -1.0
# Output rows per block of the kernel, halved until a block's shared memory
# (16 (S + band) bytes of tap tables + the staged input rows, as
# csrc/resize_norm.cu lays it out) fits in 48 KB.
_BAND = 16
_SMEM = 48 * 1024


@functools.lru_cache(maxsize=None)
def bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation weights, half-pixel centers,
    edges clamped (cv2.INTER_LINEAR convention). Read-only."""
    m = np.zeros((dst, src), np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        lo = min(max(x0, 0), src - 1)
        hi = min(max(x0 + 1, 0), src - 1)
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    m.setflags(write=False)
    return m


@functools.lru_cache(maxsize=None)
def resize_weights(h: int, w: int, out_size: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R_h (S, H), R_w (W, S)) float32 on `device`; cached per
    (h, w, out_size, device), so the tensors are shared: do not modify."""
    rh = torch.tensor(bilinear_matrix(h, out_size), device=device)
    rw = torch.tensor(bilinear_matrix(w, out_size).T.copy(), device=device)
    return rh, rw


@functools.lru_cache(maxsize=None)
def bilinear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """``bilinear_matrix(src, dst)`` as 2-tap tables: (2, dst) int32 source
    indices and (2, dst) float32 weights. Each row's non-zero weights sit in
    at most two adjacent columns; both weights are the matrix's own values
    (at a clamped edge the one non-zero is ``(1 - frac) + frac`` summed in
    fp32). A row with one non-zero keeps it as tap 0 and gives tap 1 the
    same index and weight 0. Read-only."""
    m = bilinear_matrix(src, dst)
    idx = np.zeros((2, dst), np.int32)
    wts = np.zeros((2, dst), np.float32)
    for i, row in enumerate(m):
        nz = np.flatnonzero(row)
        idx[:, i] = nz[0], nz[-1]
        wts[0, i] = row[nz[0]]
        wts[1, i] = row[nz[-1]] if len(nz) == 2 else 0.0
    # the kernel stages the input rows [idx[0, s0], idx[1, s_last]] of a band
    assert (np.diff(idx, axis=1) >= 0).all()
    idx.setflags(write=False)
    wts.setflags(write=False)
    return idx, wts


class Taps(NamedTuple):
    """(R_h, R_w) as the kernel reads them, on one device."""
    idx: torch.Tensor   # (4, S) int32: ih0, ih1, iw0, iw1
    wts: torch.Tensor   # (4, S) float32: wh0, wh1, ww0, ww1


@functools.lru_cache(maxsize=None)
def resize_taps(h: int, w: int, out_size: int, device) -> Taps:
    """The 2-tap tables of ``resize_weights(h, w, out_size)``, cached per
    (h, w, out_size, device) so that no step pays a host-to-device copy."""
    (ih, wh), (iw, ww) = bilinear_taps(h, out_size), bilinear_taps(w, out_size)
    return Taps(torch.tensor(np.concatenate([ih, iw]), device=device),
                torch.tensor(np.concatenate([wh, ww]), device=device))


@functools.lru_cache(maxsize=None)
def _band_plan(h: int, w: int, c: int, out_size: int) -> Tuple[int, int]:
    """(output rows per block, the most input rows a band reads) for the
    kernel: the largest band up to _BAND whose shared memory fits _SMEM."""
    ih = bilinear_taps(h, out_size)[0]
    band = min(_BAND, out_size)
    while True:
        span = max(int(ih[1, min(s + band, out_size) - 1] - ih[0, s]) + 1
                   for s in range(0, out_size, band))
        if 16 * (out_size + band) + span * w * c <= _SMEM or band == 1:
            return band, span
        band //= 2


def resize_normalize_gather_plain(pool: torch.Tensor, clip_ix: torch.Tensor,
                                  frame_ix: torch.Tensor, rh: torch.Tensor,
                                  rw: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel (fp32 einsums).

    pool (N, T_max, H, W, C) uint8, clip_ix (B,), frame_ix (B, T) ->
    (B, T, S, S, C) float32 in [-1, 1]."""
    sel = pool[clip_ix.long()[:, None], frame_ix.long()]      # (B,T,H,W,C)
    x = sel.permute(0, 1, 4, 2, 3).float()                    # (B,T,C,H,W)
    y = torch.einsum("sh,btchw->btcsw", rh, x)
    z = torch.einsum("btcsw,wv->btcsv", y, rw)
    return (z * _SCALE + _OFFSET).permute(0, 1, 3, 4, 2).contiguous()


def _check(pool, clip_ix, frame_ix, rh, rw):
    if pool.dtype != torch.uint8 or pool.ndim != 5:
        raise ValueError(f"pool must be (N, T_max, H, W, C) uint8, got "
                         f"{tuple(pool.shape)} {pool.dtype}")
    _, _, h, w, _ = pool.shape
    b = clip_ix.shape[0]
    want = {"clip_ix": (clip_ix, torch.int32, (b,)),
            "frame_ix": (frame_ix, torch.int32, (b, frame_ix.shape[-1])),
            "rh": (rh, torch.float32, (rh.shape[0], h)),
            "rw": (rw, torch.float32, (w, rh.shape[0]))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, pool on "
                             f"{pool.device}")
    for name, t in (("pool", pool), ("clip_ix", clip_ix),
                    ("frame_ix", frame_ix), ("rh", rh), ("rw", rw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel():
    lib, _ = cuda_build.load("resize_norm")
    fn = lib.resize_norm_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def resize_normalize_gather_cuda(pool: torch.Tensor, clip_ix: torch.Tensor,
                                 frame_ix: torch.Tensor, rh: torch.Tensor,
                                 rw: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/resize_norm.cu`` on the current stream.

    `rh`, `rw` must be ``resize_weights(H, W, S)``; the kernel reads the
    same weights as the tap tables of ``resize_taps``."""
    _check(pool, clip_ix, frame_ix, rh, rw)
    if pool.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {pool.device}")
    n, t_max, h, w, c = pool.shape
    b, t = frame_ix.shape
    s = rh.shape[0]
    taps = resize_taps(h, w, s, pool.device)
    band, span = _band_plan(h, w, c, s)
    out = torch.empty((b, t, s, s, c), dtype=torch.float32,
                      device=pool.device)
    fn = _kernel()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = fn(pool.data_ptr(), clip_ix.data_ptr(), frame_ix.data_ptr(),
                 taps.idx.data_ptr(), taps.wts.data_ptr(), out.data_ptr(), b,
                 t, n, t_max, h, w, c, s, band, span, stream)
    if err != 0:
        raise RuntimeError(f"resize_norm kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["resize_norm"] += 1
    return out


def resize_normalize_gather(pool: torch.Tensor, clip_ix: torch.Tensor,
                            frame_ix: torch.Tensor, rh: torch.Tensor,
                            rw: torch.Tensor) -> torch.Tensor:
    """(B, T, S, S, C) float32 in [-1, 1] from the windows
    ``pool[clip_ix[b], frame_ix[b, t]]``: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if pool.device.type == "cuda":
        return resize_normalize_gather_cuda(pool, clip_ix, frame_ix, rh, rw)
    if pool.device.type != "cpu":
        raise ValueError(f"unsupported device {pool.device}")
    _check(pool, clip_ix, frame_ix, rh, rw)
    return resize_normalize_gather_plain(pool, clip_ix, frame_ix, rh, rw)


def subsample_and_preprocess(raw_u8: torch.Tensor, frame_idx: torch.Tensor,
                             out_size: int) -> torch.Tensor:
    """raw (B, T_raw, H, W, C) uint8, frame_idx (B, T) -> (B, T, S, S, C)
    float32 in [-1, 1]."""
    b, _, h, w, _ = raw_u8.shape
    rh, rw = resize_weights(h, w, out_size, raw_u8.device)
    clip_ix = torch.arange(b, dtype=torch.int32, device=raw_u8.device)
    return resize_normalize_gather(
        raw_u8.contiguous(), clip_ix,
        frame_idx.to(device=raw_u8.device, dtype=torch.int32).contiguous(),
        rh, rw)


def resize_normalize(video_u8: torch.Tensor, out_size: int) -> torch.Tensor:
    """(B, T, H, W, C) uint8 -> (B, T, S, S, C) float32 in [-1, 1]."""
    b, t = video_u8.shape[:2]
    idx = torch.arange(t, dtype=torch.int32,
                       device=video_u8.device).expand(b, t)
    return subsample_and_preprocess(video_u8, idx, out_size)
