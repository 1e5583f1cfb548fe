"""The trainer's periodic quality panel.

Counterpart of the JAX package's fused panel program. Everything runs on
the device under ``torch.no_grad()``: generation (``generate_chunked_device``
with its chunk schedule), extractor features of the generated and the real
clips, ACD of both, the pairwise SSIM of generated clips and the eval-mode
D_V logits. One host copy then brings back the features and the scalars,
and the Fréchet and spread statistics run in numpy on the host.

G and D_V run with BN in eval mode (running statistics, no update), so a
panel leaves the training state bit-identical. The categorical model's
clips take labels drawn per generation chunk, as ``generate_chunked``
draws them; generated clips are fp32 under any compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mocogan_tpu_torch.configs import ExperimentConfig
from mocogan_tpu_torch.eval import fvd as fvd_mod
from mocogan_tpu_torch.eval import video_metrics
from mocogan_tpu_torch.models import discriminators, generator
from mocogan_tpu_torch.utils.platform import resolve_device

_GEN_CHUNK = 64   # generate_chunked_device's default chunk
_FEAT_CHUNK = 32  # batched_features' default batch_size
_SSIM_CLIPS = 32  # pairwise SSIM over vids[:min(n, 32)]
_SSIM_PAIRS = 32
_DV_CLIPS = 64    # mean D_V logit over min(n, 64) clips


def _to_host(raw: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """All of `raw` in one device-to-host copy."""
    flat = torch.cat([v.float().reshape(-1) for v in raw.values()])
    flat = flat.cpu().numpy()
    out, i = {}, 0
    for k, v in raw.items():
        out[k] = flat[i:i + v.numel()].reshape(v.shape)
        i += v.numel()
    return out


def summarize(raw: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The panel's scalars from its raw outputs (host numpy): fvd_proxy,
    gen_spread_ratio, acd_gen, acd_real, gen_pairwise_ssim (n >= 2) and
    dv_margin (with a video discriminator)."""
    mu_g, s_g = fvd_mod.gaussian_statistics(raw["feats_gen"])
    mu_r, s_r = fvd_mod.gaussian_statistics(raw["feats_real"])
    out = {"fvd_proxy": fvd_mod.frechet_distance(mu_g, s_g, mu_r, s_r)}
    spread_g = float(np.mean(np.linalg.norm(
        raw["feats_gen"] - mu_g, axis=1)))
    spread_r = float(np.mean(np.linalg.norm(
        raw["feats_real"] - mu_r, axis=1)))
    out["gen_spread_ratio"] = spread_g / max(spread_r, 1e-12)
    out["acd_gen"] = float(raw["acd_gen"])
    out["acd_real"] = float(raw["acd_real"])
    if "pair_ssim" in raw:
        out["gen_pairwise_ssim"] = float(raw["pair_ssim"])
    if "dv_gen" in raw:
        out["dv_margin"] = float(raw["dv_real"]) - float(raw["dv_gen"])
    return out


class PanelRunner:
    """The panel for one experiment on `device` (default ``cuda``).

    ``__call__(gen, dv, real_pool, seed, n)`` -> the dict the trainer logs
    (`real_pool`: (N, T, H, W, C) clips in [-1, 1], a tensor on any device
    or numpy; the trainer's pools already live on the device):
    fvd_proxy, gen_spread_ratio, acd_gen, acd_real, gen_pairwise_ssim and,
    when the config has a video discriminator, dv_margin. `extractor`
    defaults to ``RandomProjectionFeatures()`` on `device`."""

    def __init__(self, cfg: ExperimentConfig, extractor=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.extractor = (extractor if extractor is not None else
                          fvd_mod.RandomProjectionFeatures().to(self.device))
        self.fingerprint = fvd_mod.extractor_fingerprint(self.extractor)

    def _features(self, v: torch.Tensor) -> torch.Tensor:
        """Extractor features in chunks of _FEAT_CHUNK clips, the last one
        zero-padded to full size (features are per clip) and sliced."""
        m = v.shape[0]
        pad = (-m) % _FEAT_CHUNK
        if pad:
            v = torch.cat([v, v.new_zeros((pad, *v.shape[1:]))])
        f = torch.cat([self.extractor(c) for c in v.split(_FEAT_CHUNK)])
        return f[:m]

    @torch.no_grad()
    def metrics(self, vids: torch.Tensor, real: torch.Tensor,
                dv: Optional[discriminators.VideoDiscriminator] = None
                ) -> Dict[str, torch.Tensor]:
        """The panel's raw outputs on the device from n generated clips
        `vids` and n real clips `real` (N, T, H, W, C): features of both
        sides, ACD of both, the pairwise SSIM and, given `dv`, the mean
        eval-mode D_V logit of each side."""
        n = vids.shape[0]
        out = {
            "feats_gen": self._features(vids),
            "feats_real": self._features(real),
            "acd_gen": video_metrics.acd_from_features(
                video_metrics.frame_content_features(vids)),
            "acd_real": video_metrics.acd_from_features(
                video_metrics.frame_content_features(real)),
        }
        if n >= 2:
            idx = torch.from_numpy(video_metrics.pair_indices(
                min(n, _SSIM_CLIPS), _SSIM_PAIRS)).to(vids.device)
            out["pair_ssim"] = torch.mean(video_metrics.clip_ssim(
                vids[idx[:, 0]], vids[idx[:, 1]]))
        if dv is not None:
            m = min(n, _DV_CLIPS)
            out["dv_gen"] = discriminators.video_apply(
                dv, vids[:m], train=False)[0].mean()
            out["dv_real"] = discriminators.video_apply(
                dv, real[:m], train=False)[0].mean()
        return out

    @torch.no_grad()
    def __call__(self, gen: generator.Generator,
                 dv: Optional[discriminators.VideoDiscriminator],
                 real_pool, seed: int, n: Optional[int] = None
                 ) -> Dict[str, float]:
        n = min(n or self.cfg.train.eval_clips, len(real_pool))
        if n <= 0:
            raise ValueError(f"panel needs clips; real pool {len(real_pool)}")
        vids = generator.generate_chunked_device(gen, n, seed=seed,
                                                 chunk=_GEN_CHUNK)
        use_dv = self.cfg.model.use_video_discriminator
        real = torch.as_tensor(real_pool[:n], dtype=torch.float32)
        raw = self.metrics(vids, real.to(self.device),
                           dv if use_dv else None)
        return summarize(_to_host(raw))
