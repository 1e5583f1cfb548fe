"""FVD (Fréchet Video Distance): the Fréchet math and the feature
extractors.

FVD is the Fréchet distance between Gaussian fits of video features from a
3D conv net, canonically I3D pretrained on Kinetics. The metric (Gaussian
statistics, the exact Fréchet form) is numpy on the host; the extractors
are torch modules on the device:

  * ``I3DFeatures(weights_path)``: I3D from a weight file in the npz
    contract of ``eval/i3d.py`` (the JAX package's contract, so one file
    serves both packages); raises without one.
  * ``RandomProjectionFeatures``: a fixed-seed random 3D conv net. Random
    conv features are a proxy for relative comparisons (the same extractor
    on both sides); their values are not comparable to published FVD.

Every panel record carries ``extractor_fingerprint``: ``EVAL_VERSION``
plus a hash of the extractor's weights, taken in the JAX package's layout
and leaf order (DHWIO conv kernels, (in, out) dense matrices, keys sorted:
conv0/b, conv0/w, ..., conv3/w, proj/b, proj/w). So an extractor that holds
the JAX extractor's weights (``bridge.fvd_extractor_from_jax``) has exactly
the JAX fingerprint, and its fvd_proxy reads on the JAX scale. The port's
default extractor draws its own weights, from
``utils/prng.generator(seed, 0, "init", layer)``, because threefry's draws
cannot be reproduced in torch: its fingerprint differs from the JAX
package's, and ``compare_runs`` refuses to read fvd_proxy across the two
packages unless the weights were carried across.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mocogan_tpu_torch import bridge
from mocogan_tpu_torch.ops import layers
from mocogan_tpu_torch.utils import prng
from mocogan_tpu_torch.utils.platform import resolve_device

# The JAX package's version of the panel's numerical semantics (extractor
# architecture, feature batching, panel formulas); bumped on any change, so
# that fingerprints tell eval-code drift from training drift.
EVAL_VERSION = 3

_K = (3, 4, 4)   # the random-projection net's conv kernel (T, H, W)


def _leaves(tree) -> Iterator[np.ndarray]:
    """The leaves of a nested dict in ``jax.tree.leaves`` order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


def extractor_fingerprint(extractor) -> str:
    """``v{EVAL_VERSION}-{sha256(version || dim || weights)[:12]}``, with
    the weights as ``extractor.jax_params()`` gives them (the JAX layout)."""
    h = hashlib.sha256()
    h.update(str(EVAL_VERSION).encode())
    h.update(str(getattr(extractor, "dim", "?")).encode())
    params = extractor.jax_params() if hasattr(extractor, "jax_params") \
        else {}
    for leaf in _leaves(params):
        h.update(np.ascontiguousarray(leaf, np.float32).tobytes())
    return f"v{EVAL_VERSION}-{h.hexdigest()[:12]}"


def gaussian_statistics(features: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D))."""
    mu = features.mean(axis=0)
    cov = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(cov)


def _trace_sqrt_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """Tr(sqrt(S1 S2)) through symmetric eigendecompositions only:
    sqrt(S1) S2 sqrt(S1) is symmetric PSD with the eigenvalues of S1 S2, so
    the trace of the square root is the sum of the square roots of its
    (clipped) eigenvalues."""
    vals1, vecs1 = np.linalg.eigh(sigma1)
    sq1 = (vecs1 * np.sqrt(np.clip(vals1, 0.0, None))) @ vecs1.T
    prod = sq1 @ sigma2 @ sq1
    vals = np.linalg.eigvalsh((prod + prod.T) / 2.0)
    return float(np.sqrt(np.clip(vals, 0.0, None)).sum())


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    tsp = _trace_sqrt_product(sigma1, sigma2)
    if not np.isfinite(tsp):
        offset = np.eye(sigma1.shape[0]) * eps
        tsp = _trace_sqrt_product(sigma1 + offset, sigma2 + offset)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tsp)


class RandomProjectionFeatures(nn.Module):
    """Fixed-seed random 3D conv feature net: 4 conv3d stages (kernel
    (3, 4, 4), strides (1, 2, 2) then (2, 2, 2), XLA SAME padding, leaky
    ReLU 0.2), a global mean over (T, H, W) and a dense projection to `dim`
    features. He-normal weights, zero biases, frozen.

    ``dim`` 64 keeps the dim x dim covariance estimable from the trainer's
    default 256 eval clips (about 4x dim); values are not comparable
    across dims."""

    def __init__(self, dim: int = 64, width: int = 32, seed: int = 0):
        super().__init__()
        self.dim, self.width, self.seed = dim, width, seed
        cin, cout = 3, width
        for i in range(4):
            gen = prng.generator(seed, 0, "init", sub=i)
            fan_in = math.prod(_K) * cin
            setattr(self, f"conv{i}", layers.Conv3d(
                _K, cin, cout, gen, std=math.sqrt(2.0 / fan_in)))
            cin, cout = cout, cout * 2
        self.proj = layers.Dense(cin, dim, prng.generator(seed, 0, "init",
                                                          sub=4),
                                 std=math.sqrt(1.0 / cin))
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.proj.w.device

    def jax_params(self):
        """The weights as the JAX package's params tree (numpy)."""
        return bridge.params_tree(self)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos (B, T, H, W, C) in [-1, 1] -> features (B, dim)."""
        h = videos.float().permute(0, 4, 1, 2, 3)            # (B, C, T, H, W)
        for i in range(4):
            st = (1, 2, 2) if i == 0 else (2, 2, 2)
            h = layers.leaky_relu(getattr(self, f"conv{i}")(h, st))
        return self.proj(h.mean(dim=(2, 3, 4)))


def I3DFeatures(weights_path: str, *, features: str = "logits",
                resize_to: int = 224, device=None):
    """I3D features from a Kinetics weight file in the npz contract of
    ``eval/i3d.py``. A weights file is required: random-weight features
    labelled as absolute I3D-FVD would mislead. For relative tracking use
    RandomProjectionFeatures or ``i3d.I3DExtractor(None)`` explicitly."""
    if not weights_path:
        raise ValueError(
            "I3DFeatures requires a weights npz path; absolute FVD from "
            "random weights would be meaningless. Use "
            "RandomProjectionFeatures() (or i3d.I3DExtractor(None)) for "
            "relative-only comparisons.")
    from mocogan_tpu_torch.eval.i3d import I3DExtractor

    return I3DExtractor(weights_path, features=features,
                        resize_to=resize_to, device=device)


@torch.no_grad()
def batched_features(videos, extractor: Callable[[torch.Tensor],
                                                 torch.Tensor],
                     batch_size: int = 32) -> np.ndarray:
    """Extractor features of N clips (numpy or a tensor), `batch_size`
    clips a call on the extractor's device -> (N, dim) numpy."""
    out = []
    for i in range(0, len(videos), batch_size):
        chunk = torch.as_tensor(videos[i:i + batch_size]).to(
            extractor.device)
        out.append(extractor(chunk).cpu().numpy())
    return np.concatenate(out)


def fvd(videos_a, videos_b, extractor: Optional[Callable] = None,
        batch_size: int = 32, device=None) -> float:
    """FVD between two sets of clips (N, T, H, W, C) in [-1, 1]. Without an
    extractor, the default RandomProjectionFeatures runs on `device`
    (default ``cuda``)."""
    if extractor is None:
        extractor = RandomProjectionFeatures().to(resolve_device(device))
    mu_a, s_a = gaussian_statistics(
        batched_features(videos_a, extractor, batch_size))
    mu_b, s_b = gaussian_statistics(
        batched_features(videos_b, extractor, batch_size))
    return frechet_distance(mu_a, s_a, mu_b, s_b)
