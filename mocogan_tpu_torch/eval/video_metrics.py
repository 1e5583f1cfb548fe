"""Classical per-frame video metrics: PSNR, SSIM, Average Content Distance
and a pairwise-SSIM diversity probe.

Counterpart of the JAX package's ``eval/video_metrics.py``. Inputs keep its
layout, (..., H, W, C) in [-1, 1] (numpy arrays or tensors on any device),
and are mapped to [0, 1] where the metric definitions assume it. SSIM
follows Wang et al. 2004: an 11x11 Gaussian window (sigma 1.5), K1 0.01,
K2 0.03, as depthwise VALID convolutions (``F.conv2d`` with ``groups=C``).
Identical inputs give a PSNR of +inf.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _to_unit(x) -> torch.Tensor:
    """[-1, 1] video range -> [0, 1] metric range, clipped, float32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)


def psnr(a, b, axis=(-3, -2, -1)) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over `axis` (default: per frame)."""
    mse = torch.mean((_to_unit(a) - _to_unit(b)) ** 2, dim=axis)
    return 10.0 * (0.0 - torch.log10(mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - (size - 1) / 2) / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a, b, *, window: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM per image: (..., H, W, C) x2 -> (...,). H, W >= window.
    Leading dims are flattened into one batch for the convolutions."""
    a, b = _to_unit(a), _to_unit(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    lead = a.shape[:-3]
    a4 = a.reshape(-1, *a.shape[-3:]).permute(0, 3, 1, 2)    # NCHW
    b4 = b.reshape(-1, *b.shape[-3:]).permute(0, 3, 1, 2)
    c = a4.shape[1]
    kern = torch.tensor(_gaussian_kernel(window, sigma), device=a4.device)
    kern = kern.expand(c, 1, window, window)

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = filt(a4), filt(b4)
    var_a = filt(a4 * a4) - mu_a * mu_a
    var_b = filt(b4 * b4) - mu_b * mu_b
    cov = filt(a4 * b4) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(-3, -2, -1)).reshape(lead)


def clip_psnr(a, b) -> torch.Tensor:
    """(B, T, H, W, C) x2 -> (B,) mean per-frame PSNR per clip."""
    return torch.mean(psnr(a, b), dim=-1)


def clip_ssim(a, b) -> torch.Tensor:
    """(B, T, H, W, C) x2 -> (B,) mean per-frame SSIM per clip."""
    return torch.mean(ssim(a, b), dim=-1)


def frame_content_features(videos) -> torch.Tensor:
    """Per-frame content descriptor, the spatial mean per channel:
    (..., T, H, W, C) in [-1, 1] -> (..., T, C) in [0, 1]."""
    return torch.mean(_to_unit(videos), dim=(-3, -2))


def acd_from_features(feats) -> torch.Tensor:
    """Average Content Distance of (B, T, D) per-frame features: per clip
    the mean L2 distance over ordered frame pairs i != j, averaged over
    clips. 0 means the content stays constant through time."""
    feats = torch.as_tensor(feats, dtype=torch.float32)
    if feats.ndim != 3:
        raise ValueError(f"expected (B, T, D) features, got "
                         f"{tuple(feats.shape)}")
    t = feats.shape[1]
    if t < 2:
        raise ValueError(f"need >= 2 frames for ACD, got {t}")
    d = torch.linalg.norm(feats[:, :, None, :] - feats[:, None, :, :],
                          dim=-1)                          # (B, T, T)
    return torch.mean(torch.sum(d, dim=(-2, -1)) / (t * (t - 1)))


def acd(videos, feature_fn=None) -> float:
    """Average Content Distance of (B, T, H, W, C) clips in [-1, 1] (the
    MoCoGAN paper's metric; lower = more consistent content).
    `feature_fn` maps clips to (B, T, D) features; the default is the
    mean-colour descriptor ``frame_content_features``."""
    feats = (feature_fn or frame_content_features)(videos)
    return float(acd_from_features(feats))


def pair_indices(n: int, max_pairs: int = 64, seed: int = 0) -> np.ndarray:
    """Deterministic distinct clip pairs (P, 2) for the diversity probe:
    the same numpy draws as the JAX package, so a seed gives the same
    pairs."""
    if n < 2:
        raise ValueError(f"need >= 2 clips, got {n}")
    rng = np.random.default_rng(seed)
    n_pairs = min(max_pairs, n * (n - 1) // 2)
    seen = set()
    while len(seen) < n_pairs:
        i, j = rng.integers(0, n, size=2)
        if i != j:
            seen.add((min(i, j), max(i, j)))
    return np.array(sorted(seen))


def pairwise_ssim_diversity(videos, max_pairs: int = 64,
                            seed: int = 0) -> float:
    """Mode-collapse probe: mean SSIM over distinct clip pairs of
    (N, T, H, W, C) clips, N >= 2. Near 1.0 means near-identical clips."""
    videos = torch.as_tensor(videos)
    idx = torch.from_numpy(pair_indices(videos.shape[0], max_pairs,
                                        seed)).to(videos.device)
    return float(torch.mean(clip_ssim(videos[idx[:, 0]], videos[idx[:, 1]])))
