"""I3D (Inflated 3D Inception-v1, Carreira & Zisserman 2017), the canonical
FVD feature extractor.

Counterpart of the JAX package's ``eval/i3d.py``, reading the same weight
file, a flat .npz of float32 arrays in the JAX layout:

    <unit>/w      conv kernel, DHWIO (kd, kh, kw, cin, cout)
    <unit>/beta   BatchNorm shift (cout,)   [TF I3D BN: centre, no scale]
    <unit>/mean   BN moving mean (cout,)
    <unit>/var    BN moving variance (cout,)
    Logits/Conv3d_0c_1x1/w   (1, 1, 1, 1024, 400)
    Logits/Conv3d_0c_1x1/b   (400,)

with the public kinetics-i3d unit names (Conv3d_1a_7x7, Conv3d_2b_1x1,
Conv3d_2c_3x3, Mixed_3b/Branch_0/Conv3d_0a_1x1, ...). ``load_npz``
validates it against ``expected_shapes``; ``to_torch`` converts the conv
kernels to OIDHW once, when the weights are loaded.

What differs from the obvious torch calls:
  * conv padding is XLA SAME, asymmetric where the size does not divide:
    Conv3d_1a_7x7 (stride 2) on 224 px and 16 frames pads (2, 3) in each
    dim (``layers.conv3d``);
  * SAME max-pools pad with -inf to the XLA SAME pads, then pool with no
    padding (``F.max_pool3d``'s own padding is symmetric);
  * BN is inference-only and centre-only, eps 1e-3;
  * the head averages VALID (2, 7, 7) windows at stride 1, each window
    clamped to the map, then takes the mean over window positions: time
    weights (1, 2, ..., 2, 1) for T' > 2, not a uniform mean.

FVD protocol: clips in [-1, 1], resized to 224x224 (bilinear, half-pixel
centres, ``ops/preproc.bilinear_matrix``), >= 9 frames; features are the
400-d pre-softmax logits or the 1024-d pooled embedding
(``features="pool"``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mocogan_tpu_torch.ops import layers, preproc
from mocogan_tpu_torch.utils import prng
from mocogan_tpu_torch.utils.platform import resolve_device

# Inception-v1 module channel table: (b0, b1_reduce, b1, b2_reduce, b2, b3).
_MIXED: Dict[str, Tuple[int, int, int, int, int, int]] = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}

NUM_CLASSES = 400
EMBED_DIM = 1024
_BN_EPS = 1e-3
_LOGITS = "Logits/Conv3d_0c_1x1"

Params = Dict[str, torch.Tensor]


def _mixed_out(spec) -> int:
    return spec[0] + spec[2] + spec[4] + spec[5]


def conv_units() -> List[Tuple[str, Tuple[int, int, int], int, int]]:
    """All BN conv units as (name, kernel, cin, cout), in forward order."""
    units: List[Tuple[str, Tuple[int, int, int], int, int]] = [
        ("Conv3d_1a_7x7", (7, 7, 7), 3, 64),
        ("Conv3d_2b_1x1", (1, 1, 1), 64, 64),
        ("Conv3d_2c_3x3", (3, 3, 3), 64, 192),
    ]
    cin = 192
    for name, s in _MIXED.items():
        b0, b1r, b1, b2r, b2, b3 = s
        units += [
            (f"{name}/Branch_0/Conv3d_0a_1x1", (1, 1, 1), cin, b0),
            (f"{name}/Branch_1/Conv3d_0a_1x1", (1, 1, 1), cin, b1r),
            (f"{name}/Branch_1/Conv3d_0b_3x3", (3, 3, 3), b1r, b1),
            (f"{name}/Branch_2/Conv3d_0a_1x1", (1, 1, 1), cin, b2r),
            (f"{name}/Branch_2/Conv3d_0b_3x3", (3, 3, 3), b2r, b2),
            (f"{name}/Branch_3/Conv3d_0b_1x1", (1, 1, 1), cin, b3),
        ]
        cin = _mixed_out(s)
    return units


def expected_shapes() -> Dict[str, Tuple[int, ...]]:
    """The npz contract, key -> shape (JAX layout)."""
    out: Dict[str, Tuple[int, ...]] = {}
    for name, k, cin, cout in conv_units():
        out[f"{name}/w"] = (*k, cin, cout)
        for p in ("beta", "mean", "var"):
            out[f"{name}/{p}"] = (cout,)
    out[f"{_LOGITS}/w"] = (1, 1, 1, EMBED_DIM, NUM_CLASSES)
    out[f"{_LOGITS}/b"] = (NUM_CLASSES,)
    return out


def init_random(seed: int = 0) -> Dict[str, np.ndarray]:
    """He-normal random weights in the npz contract's layout (write them
    with ``np.savez`` to get a contract file). Key i of the sorted keys
    draws from ``prng.generator(seed, 0, "init", i)``; BN is the identity
    (mean 0, var 1, beta 0), biases are 0."""
    params: Dict[str, np.ndarray] = {}
    for i, (name, shape) in enumerate(sorted(expected_shapes().items())):
        if name.endswith("/w"):
            fan_in = math.prod(shape[:-1])
            params[name] = layers.normal(
                shape, prng.generator(seed, 0, "init", i),
                math.sqrt(2.0 / fan_in)).numpy()
        elif name.endswith("/var"):
            params[name] = np.ones(shape, np.float32)
        else:
            params[name] = np.zeros(shape, np.float32)
    return params


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Load a weight file and validate it against the contract."""
    with np.load(path) as f:
        raw = dict(f)
    want = expected_shapes()
    missing = [k for k in want if k not in raw]
    bad = [(k, tuple(raw[k].shape), want[k]) for k in want
           if k in raw and tuple(raw[k].shape) != want[k]]
    if missing or bad:
        msg = []
        if missing:
            msg.append(f"missing {len(missing)} keys, e.g. {missing[:4]}")
        if bad:
            msg.append("shape mismatches: "
                       + "; ".join(f"{k}: got {g}, want {w}"
                                   for k, g, w in bad[:4]))
        raise ValueError(f"I3D weight file {path} invalid: "
                         + " | ".join(msg))
    return {k: np.asarray(raw[k], np.float32) for k in want}


def to_torch(params: Dict[str, np.ndarray], device) -> Params:
    """Contract-layout weights -> tensors on `device`: conv kernels OIDHW,
    the logits matrix (1024, 400)."""
    out: Params = {}
    for k, a in params.items():
        if k == f"{_LOGITS}/w":
            a = a[0, 0, 0]
        elif k.endswith("/w"):
            a = a.transpose(4, 3, 0, 1, 2)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


# ---------------------------------------------------------------------------
# forward (channels-first: x is (B, C, T, H, W))
# ---------------------------------------------------------------------------

def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1, 1)


def _unit(params: Params, name: str, x: torch.Tensor,
          stride: Tuple[int, int, int] = (1, 1, 1)) -> torch.Tensor:
    """Conv3d (SAME, no bias) + BN (inference, centre only) + ReLU."""
    y = layers.conv3d(x, params[f"{name}/w"], None, stride)
    inv = torch.rsqrt(params[f"{name}/var"] + _BN_EPS)
    y = (y - _bcast(params[f"{name}/mean"])) * _bcast(inv) \
        + _bcast(params[f"{name}/beta"])
    return F.relu(y)


def _maxpool(x: torch.Tensor, k: Tuple[int, int, int],
             s: Tuple[int, int, int]) -> torch.Tensor:
    """Max pool with XLA SAME padding by -inf."""
    pads = [layers.same_pads(x.shape[2 + i], k[i], s[i]) for i in range(3)]
    if any(lo or hi for lo, hi in pads):
        x = F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)],
                  value=float("-inf"))
    return F.max_pool3d(x, k, s)


def _mixed(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b0 = _unit(params, f"{name}/Branch_0/Conv3d_0a_1x1", x)
    b1 = _unit(params, f"{name}/Branch_1/Conv3d_0a_1x1", x)
    b1 = _unit(params, f"{name}/Branch_1/Conv3d_0b_3x3", b1)
    b2 = _unit(params, f"{name}/Branch_2/Conv3d_0a_1x1", x)
    b2 = _unit(params, f"{name}/Branch_2/Conv3d_0b_3x3", b2)
    b3 = _maxpool(x, (3, 3, 3), (1, 1, 1))
    b3 = _unit(params, f"{name}/Branch_3/Conv3d_0b_1x1", b3)
    return torch.cat([b0, b1, b2, b3], dim=1)


def apply(params: Params, videos: torch.Tensor,
          features: str = "logits") -> torch.Tensor:
    """videos (B, T, H, W, C) in [-1, 1] -> (B, 400) logits or (B, 1024)
    pooled embedding; `params` as ``to_torch`` gives them."""
    if features not in ("logits", "pool"):
        raise ValueError(f"features must be 'logits' or 'pool', "
                         f"got {features!r}")
    x = videos.float().permute(0, 4, 1, 2, 3)
    x = _unit(params, "Conv3d_1a_7x7", x, stride=(2, 2, 2))
    x = _maxpool(x, (1, 3, 3), (1, 2, 2))
    x = _unit(params, "Conv3d_2b_1x1", x)
    x = _unit(params, "Conv3d_2c_3x3", x)
    x = _maxpool(x, (1, 3, 3), (1, 2, 2))
    x = _mixed(params, "Mixed_3b", x)
    x = _mixed(params, "Mixed_3c", x)
    x = _maxpool(x, (3, 3, 3), (2, 2, 2))
    for n in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
        x = _mixed(params, n, x)
    x = _maxpool(x, (2, 2, 2), (2, 2, 2))
    x = _mixed(params, "Mixed_5b", x)
    x = _mixed(params, "Mixed_5c", x)
    # the kinetics-i3d head: average VALID (2, 7, 7) windows at stride 1
    # (clamped to the map), then the mean over window positions; the logits
    # conv is linear, so it applies after the mean
    k = tuple(min(a, b) for a, b in zip((2, 7, 7), x.shape[2:]))
    pooled = F.avg_pool3d(x, k, stride=1).mean(dim=(2, 3, 4))
    if features == "pool":
        return pooled
    return pooled @ params[f"{_LOGITS}/w"] + params[f"{_LOGITS}/b"]


def resize_videos(videos: torch.Tensor, size: int = 224) -> torch.Tensor:
    """The FVD protocol's resize (bilinear, half-pixel centres) of float
    clips (B, T, H, W, C), as the two products of the ingest's weights."""
    _, _, h, w, _ = videos.shape
    if (h, w) == (size, size):
        return videos
    rh, rw = preproc.resize_weights(h, w, size, videos.device)
    x = torch.einsum("sh,bthwc->btswc", rh, videos.float())
    return torch.einsum("btswc,wv->btsvc", x, rw)


class I3DExtractor:
    """Callable extractor for ``eval/fvd.py``: clips (B, T, H, W, C) in
    [-1, 1] -> feature tensors on `device` (default ``cuda``). Weights from
    an npz in the contract layout, or random from `seed` for relative-only
    comparisons."""

    def __init__(self, weights_path: str | None = None, *,
                 features: str = "logits", resize_to: int | None = 224,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self._npz = (load_npz(weights_path) if weights_path
                     else init_random(seed))
        self.params = to_torch(self._npz, self.device)
        self.features = features
        self.resize_to = resize_to

    def jax_params(self) -> Dict[str, np.ndarray]:
        """The weights in the contract's layout."""
        return self._npz

    @torch.no_grad()
    def __call__(self, videos: torch.Tensor) -> torch.Tensor:
        if self.resize_to:
            videos = resize_videos(videos, self.resize_to)
        return apply(self.params, videos, features=self.features)
