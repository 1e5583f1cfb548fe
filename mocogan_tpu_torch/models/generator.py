"""Image generator G_I and the public video-sampling API.

Per-frame decoder: [z_C, (one-hot class,) z_M(t)] -> dense -> reshape
(s0, s0, 8 ngf) -> four stride-2 transposed convs, BN + ReLU after every
stage but the last, tanh at the end. All B*T frames are decoded as one
batch, so BN normalizes over the frame batch, as the reference's per-frame
generator does.

Variants, as in the JAX package: the categorical model puts the one-hot of
each clip's label between z_C and z_M(t); under bf16 compute the tanh runs
in fp32 and train mode hands the frames on in bf16 (eval mode keeps fp32);
``model.remat`` recomputes the decoder in the backward pass
(``torch.utils.checkpoint``, train mode only). The GRU has no compute
dtype: it stays fp32 under bf16, as in JAX.

Public functions keep the JAX package's layouts: videos (B, T, H, W, C),
frames (N, H, W, C), motion noise eps (T, B, d_eps). The module itself
works channels-first.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mocogan_tpu_torch.configs import ModelConfig
from mocogan_tpu_torch.models import motion
from mocogan_tpu_torch.ops import layers
from mocogan_tpu_torch.parallel.mesh import Mesh
from mocogan_tpu_torch.utils import prng
from mocogan_tpu_torch.utils.platform import upload

_N_UP = 4  # stride-2 upsampling stages: seed -> x16 spatial


class Generator(nn.Module):
    """G_I plus the GRU motion sampler R_M."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = layers.compute_dtype(cfg.compute_dtype)
        ngf = cfg.gen_features
        self.s0 = layers.out_size_up(cfg.image_size, _N_UP)
        widths = [ngf * 8, ngf * 4, ngf * 2, ngf]
        self.gru = motion.init(cfg, gen)
        # no bias where BN follows: BN removes it
        self.fc = layers.Dense(cfg.dim_z, self.s0 * self.s0 * widths[0], gen,
                               bias=False)
        self.bn_fc = layers.BatchNorm(widths[0])
        cin = widths[0]
        for i in range(_N_UP):
            last = i + 1 == _N_UP
            cout = cfg.channels if last else widths[i + 1]
            setattr(self, f"deconv{i}",
                    layers.Deconv2d(4, cin, cout, gen, bias=last))
            if not last:
                setattr(self, f"bn{i}", layers.BatchNorm(cout))
            cin = cout

    def _bns(self) -> List[layers.BatchNorm]:
        return [self.bn_fc] + [getattr(self, f"bn{i}")
                               for i in range(_N_UP - 1)]

    def _decode(self, z: torch.Tensor, train: bool, update: bool,
                stats: Optional[list] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        """The decoder. With `stats`, train mode appends each BN's batch
        (mean, var) there instead of advancing its running stats."""
        bns = iter(self._bns())

        def bn_relu(h):
            bn = next(bns)
            y, mean, var = bn.normalize(h, train, mesh)
            if stats is not None:
                stats.extend((mean, var))
            elif train and update:
                bn.advance(mean, var)
            return F.relu(y)

        dt = self.dtype
        h = self.fc(z, dt).view(z.shape[0], self.s0, self.s0, -1)
        h = bn_relu(h.permute(0, 3, 1, 2).contiguous())  # channels-last flat
        for i in range(_N_UP):
            h = getattr(self, f"deconv{i}")(h, stride=2, dtype=dt)
            if i + 1 < _N_UP:
                h = bn_relu(h)
        out = torch.tanh(h.float())
        # train mode hands the frames to the Ds, which cast to the compute
        # dtype anyway; inference keeps fp32
        return out.to(dt) if train else out

    def _decode_remat(self, z: torch.Tensor, mesh: Optional[Mesh]):
        stats: list = []
        return (self._decode(z, True, False, stats, mesh), *stats)

    def decode(self, z: torch.Tensor, train: bool, update: bool = True,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
        """z (N, dim_z) -> frames (N, C, H, W) in [-1, 1]. Under
        ``model.remat`` train mode keeps no activations of the decoder for
        the backward pass, which runs it again; the recompute must not
        advance the running stats a second time, so the batch stats of the
        first run come out of the checkpoint and advance them here. With a
        data-parallel `mesh` the recompute repeats the BN all-reduces, in
        the same order on every rank."""
        if not (train and self.cfg.remat):
            return self._decode(z, train, update, mesh=mesh)
        out, *stats = checkpoint(self._decode_remat, z, mesh,
                                 use_reentrant=False)
        if update:
            for bn, mean, var in zip(self._bns(), stats[0::2], stats[1::2]):
                bn.advance(mean, var)
        return out

    def sample(self, z_c: torch.Tensor, h0: torch.Tensor, eps: torch.Tensor,
               train: bool, update: bool = True,
               labels: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
        """Fake clips (B, T, C, H, W) from z_c (B, d_c), h0 (B, d_m), eps
        (T, B, d_eps) and, for the categorical model, labels (B,). `mesh`:
        BN statistics over its ranks (``layers.batchnorm``)."""
        b, t = z_c.shape[0], eps.shape[0]
        z_m = motion.sample_motion(self.gru, h0, eps)              # (B,T,dM)
        parts = [z_c[:, None, :].expand(b, t, -1)]
        if self.cfg.conditional:
            if labels is None:
                raise ValueError("the categorical generator needs labels")
            onehot = F.one_hot(labels.long(), self.cfg.n_classes).float()
            parts.append(onehot[:, None, :].expand(b, t, -1))
        parts.append(z_m)
        z = torch.cat(parts, dim=-1)
        frames = self.decode(z.reshape(b * t, -1), train, update, mesh)
        return frames.view(b, t, *frames.shape[1:])


def init(cfg: ModelConfig, gen: torch.Generator) -> Generator:
    return Generator(cfg, gen)


def decode_frames(g: Generator, z: torch.Tensor, *, train: bool,
                  update: bool = True) -> torch.Tensor:
    """z (N, dim_z) -> frames (N, H, W, C) in [-1, 1], in the compute
    dtype in train mode and fp32 in eval mode."""
    return g.decode(z, train, update).permute(0, 2, 3, 1)


def draw_latents(cfg: ModelConfig, batch: int, seed: int, step: int,
                 device, video_length: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
    """The fake path's noise for (seed, step): z_c (B, d_c), h0 (B, d_m),
    eps (T, B, d_eps) and, for the categorical model, labels (B,) uniform
    over the classes, each from its own role's CPU generator, then copied
    to `device`; T is `video_length` or the config's."""
    t = video_length or cfg.video_length
    dev = torch.device(device)

    def normal(shape, role):
        return upload(torch.randn(shape,
                                  generator=prng.generator(seed, step, role)),
                      dev)

    d = {"z_c": normal((batch, cfg.dim_content), "content"),
         "h0": normal((batch, cfg.dim_motion), "motion_init"),
         "eps": normal((t, batch, cfg.dim_eps), "motion_noise")}
    if cfg.conditional:
        d["labels"] = upload(torch.randint(
            0, cfg.n_classes, (batch,),
            generator=prng.generator(seed, step, "label")), dev)
    return d


def sample_videos(g: Generator, z_c: torch.Tensor, h0: torch.Tensor,
                  eps: torch.Tensor, *, train: bool, update: bool = True,
                  labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MoCoGAN fake path -> videos (B, T, H, W, C) in [-1, 1]."""
    return g.sample(z_c, h0, eps, train, update,
                    labels).permute(0, 1, 3, 4, 2)


@torch.no_grad()
def generate(g: Generator, n: int, *, seed: int = 0,
             latents: Optional[Dict[str, torch.Tensor]] = None,
             video_length: Optional[int] = None,
             labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Public inference API: n clips (N, T, H, W, C) in [-1, 1], fp32, BN
    in eval mode (running stats), on the device the generator lives on.
    The noise is drawn on the host, so (weights, seed) give the same clips
    on the card and on the CPU up to fp32 rounding; ``latents`` (as from
    ``draw_latents``) overrides the draws, and `labels` (n,) the class
    draws of the categorical model. T is `video_length` or the config's.
    Two calls give the same bits: every deconv pass takes a route that
    repeats (``ops/layers.py``)."""
    if latents is None:
        dev = next(g.parameters()).device
        latents = draw_latents(g.cfg, n, seed, 0, dev, video_length)
    if labels is not None:
        labels = torch.as_tensor(labels)
        if labels.shape != (n,):
            raise ValueError(f"labels must have shape ({n},), got "
                             f"{tuple(labels.shape)}")
        if not g.cfg.conditional:
            raise ValueError("labels given to an unconditional generator")
        if n and not 0 <= int(labels.min()) <= int(labels.max()) \
                < g.cfg.n_classes:
            raise ValueError(f"labels must lie in [0, {g.cfg.n_classes})")
        latents = {**latents, "labels": labels.to(latents["z_c"].device)}
    return sample_videos(g, latents["z_c"], latents["h0"], latents["eps"],
                         train=False, labels=latents.get("labels"))


def _chunks(g: Generator, n: int, seed: int, chunk: int,
            latents: Optional[Sequence[Dict[str, torch.Tensor]]]
            ) -> Iterator[torch.Tensor]:
    """``generate`` in chunks of at most `chunk` clips: chunk i draws
    ``draw_latents(cfg, m_i, seed, step=i)`` (the JAX package's
    ``fold_in(key, i)``), or takes ``latents[i]``."""
    if n <= 0:
        raise ValueError(f"generate_chunked needs n >= 1, got {n}")
    dev = next(g.parameters()).device
    done = i = 0
    while done < n:
        m = min(chunk, n - done)
        lat = (latents[i] if latents is not None
               else draw_latents(g.cfg, m, seed, i, dev))
        yield generate(g, m, latents=lat)
        done += m
        i += 1


def generate_chunked_device(g: Generator, n: int, *, seed: int = 0,
                            chunk: int = 64,
                            latents: Optional[Sequence[Dict[
                                str, torch.Tensor]]] = None
                            ) -> torch.Tensor:
    """n clips (N, T, H, W, C) generated `chunk` at a time, left on the
    generator's device: activations are bounded by one chunk, the result
    holds all n clips. `latents`, one dict per chunk as from
    ``draw_latents``, overrides the draws."""
    out = list(_chunks(g, n, seed, chunk, latents))
    return out[0] if len(out) == 1 else torch.cat(out)


def generate_chunked(g: Generator, n: int, *, seed: int = 0, chunk: int = 64,
                     latents: Optional[Sequence[Dict[str, torch.Tensor]]]
                     = None) -> np.ndarray:
    """``generate_chunked_device`` with each chunk copied to the host as
    soon as it is done, so the device holds about one chunk -> one host
    (N, T, H, W, C) float32 array of the same clips."""
    return np.concatenate([v.cpu().numpy()
                           for v in _chunks(g, n, seed, chunk, latents)])


def to_uint8(videos: torch.Tensor) -> torch.Tensor:
    """Denormalize [-1, 1] -> uint8, matching the reference's
    (x+1)/2*255."""
    x = torch.clamp((videos + 1.0) * 0.5 * 255.0, 0, 255)
    return torch.round(x).to(torch.uint8)
