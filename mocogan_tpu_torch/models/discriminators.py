"""Image discriminator D_I and video discriminator D_V (DCGAN-style stacks).

  D_I: 4x Conv2D(4x4, stride 2) + BN + LeakyReLU on single frames ->
       scalar logit; no BN on the first layer.
  D_V: 4x Conv3D(4x4x4) on (T, H, W) clips, temporal stride 1 on the first
       layer then 2 -> scalar logit.

The heads flatten channels-last, as the JAX package does, so the dense
weights keep its layout. The categorical model's D_V has a second head,
``fc_cls`` (class logits), on the same flatten. Every layer runs in the
config's compute dtype; the logits of both heads come out fp32 (their
dense layers have a bias).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mocogan_tpu_torch.configs import ModelConfig
from mocogan_tpu_torch.ops import layers
from mocogan_tpu_torch.parallel.mesh import Mesh

_N_DOWN = 4


def _disc_widths(ndf: int):
    return [ndf, ndf * 2, ndf * 4, ndf * 8]


def _video_strides(i: int) -> Tuple[int, int, int]:
    return (1, 2, 2) if i == 0 else (2, 2, 2)


def _video_flat_dim(cfg: ModelConfig) -> int:
    t, s = cfg.video_length, cfg.image_size
    for i in range(_N_DOWN):
        st = _video_strides(i)
        t = -(-t // st[0])
        s = -(-s // st[1])
    return t * s * s * _disc_widths(cfg.disc_features)[-1]


class _Discriminator(nn.Module):
    def __init__(self, cfg: ModelConfig, conv, k, flat: int,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = layers.compute_dtype(cfg.compute_dtype)
        cin = cfg.channels
        for i, cout in enumerate(_disc_widths(cfg.disc_features)):
            # bias only on the un-normalized first layer
            setattr(self, f"conv{i}", conv(k, cin, cout, gen, bias=(i == 0)))
            if i > 0:
                setattr(self, f"bn{i}", layers.BatchNorm(cout))
            cin = cout
        self.fc = layers.Dense(flat, 1, gen)

    def _trunk(self, h, strides, train, update, mesh):
        for i in range(_N_DOWN):
            h = getattr(self, f"conv{i}")(h, strides[i], self.dtype)
            if i > 0:
                h = getattr(self, f"bn{i}")(h, train, update, mesh)
            h = layers.leaky_relu(h)
        # channels-last flatten
        return h.permute(0, *range(2, h.ndim), 1).reshape(h.shape[0], -1)


class ImageDiscriminator(_Discriminator):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        s_out = cfg.image_size // (2 ** _N_DOWN)
        super().__init__(cfg, layers.Conv2d, 4,
                         s_out * s_out * _disc_widths(cfg.disc_features)[-1],
                         gen)

    def forward(self, x: torch.Tensor, train: bool, update: bool = True,
                mesh: Optional[Mesh] = None):
        """x (N, C, H, W) -> logits (N, 1). `mesh`: BN statistics over its
        ranks (``layers.batchnorm``)."""
        h = self._trunk(x, [2] * _N_DOWN, train, update, mesh)
        return self.fc(h, self.dtype)


class VideoDiscriminator(_Discriminator):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        flat = _video_flat_dim(cfg)
        super().__init__(cfg, layers.Conv3d, (4, 4, 4), flat, gen)
        if cfg.conditional:
            self.fc_cls = layers.Dense(flat, cfg.n_classes, gen)

    def forward(self, x: torch.Tensor, train: bool, update: bool = True,
                mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x (B, C, T, H, W) -> (logits (B, 1), class logits (B, K) or
        None). `mesh`: as ``ImageDiscriminator.forward``."""
        strides = [_video_strides(i) for i in range(_N_DOWN)]
        h = self._trunk(x, strides, train, update, mesh)
        cls = (self.fc_cls(h, self.dtype) if hasattr(self, "fc_cls")
               else None)
        return self.fc(h, self.dtype), cls


def image_init(cfg: ModelConfig, gen: torch.Generator) -> ImageDiscriminator:
    return ImageDiscriminator(cfg, gen)


def video_init(cfg: ModelConfig, gen: torch.Generator) -> VideoDiscriminator:
    return VideoDiscriminator(cfg, gen)


def image_apply(di: ImageDiscriminator, x: torch.Tensor, *, train: bool,
                update: bool = True) -> torch.Tensor:
    """x (N, H, W, C) frames -> logits (N, 1)."""
    return di(x.permute(0, 3, 1, 2), train, update)


def video_apply(dv: VideoDiscriminator, x: torch.Tensor, *, train: bool,
                update: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, T, H, W, C) clips -> (logits (B, 1), class logits (B, K) or
    None)."""
    return dv(x.permute(0, 4, 1, 2, 3), train, update)
