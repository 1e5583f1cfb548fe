"""Layers: plain tensor functions plus the ``nn.Module``s that hold weights.

Counterpart of the JAX package's ``ops/layers.py``. Internally everything is
channels-first (NCHW / NCDHW) with torch weight layouts; each module knows
how its weights map to and from the JAX layouts (``from_jax``/``to_jax``),
which is what ``bridge.py`` uses. What differs from the obvious torch call:

  * Padding is XLA's SAME: ``total = max((ceil(n/s)-1)*s + k - n, 0)``,
    ``lo = total // 2``, ``hi = total - lo``. D_V's first conv (k=4,
    temporal stride 1) pads time (1, 2), which no symmetric torch padding
    gives.
  * ``lax.conv_transpose`` does not flip its kernel; ``conv_transpose2d``
    does. The torch weight is the JAX one flipped in space.
  * BatchNorm is written by hand: biased variance ``E[x^2] - mean^2`` in
    fp32, eps 2e-5, affine ``x*inv + shift``, running stats
    ``0.9*old + 0.1*batch``. ``nn.BatchNorm`` keeps the unbiased variance
    and uses eps 1e-5.
  * Compute dtype (``dtype``, fp32 or bf16): the input and the weight are
    cast where the JAX package's ``_cast`` casts them; params stay fp32.
    JAX adds a bias *after* the conv or product, so under bf16 a layer
    with a bias gives fp32 (bf16 + fp32 promotes in both frameworks) and a
    layer without one gives bf16. BN takes its statistics in fp32 and
    applies its affine in the input's dtype.

Initializers follow the DCGAN convention: normal(stddev=0.02) weights, zero
biases, drawn on the CPU from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mocogan_tpu_torch.parallel.mesh import Mesh, all_reduce_mean

_W_STD = 0.02
BN_MOMENTUM = 0.9
BN_EPS = 2e-5


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA SAME padding (lo, hi) for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``model.compute_dtype``."""
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}")
    return _DTYPES[name]


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def _add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y (N, C, ...) + b (C,), the JAX package's bias after the conv."""
    return y + b.view((1, -1) + (1,) * (y.ndim - 2))


def _conv_same(fn, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor], stride: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x, w = _cast(x, dtype), _cast(w, dtype)
    # fp32 lets the conv add the bias; otherwise it is added after, in fp32
    b_in, b_after = (b, None) if dtype == torch.float32 else (None, b)
    pads = [same_pads(x.shape[2 + i], w.shape[2 + i], s)
            for i, s in enumerate(stride)]
    if all(lo == hi for lo, hi in pads):
        y = fn(x, w, b_in, stride=tuple(stride),
               padding=tuple(lo for lo, _ in pads))
    else:
        # F.pad lists pads from the last dim backwards
        flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
        y = fn(F.pad(x, flat), w, b_in, stride=tuple(stride))
    return y if b_after is None else _add_bias(y, b_after)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (N, din) @ w (din, dout) [+ b]; w keeps the JAX layout."""
    y = _cast(x, dtype) @ _cast(w, dtype)
    return y + b if b is not None else y


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 2, dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """x (N, C, H, W), w (O, I, k, k), SAME padding."""
    return _conv_same(F.conv2d, x, w, b, (stride, stride), dtype)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: Tuple[int, int, int], dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """x (N, C, D, H, W), w (O, I, kd, kh, kw), SAME padding."""
    return _conv_same(F.conv3d, x, w, b, stride, dtype)


def deconv2d(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None, stride: int = 2,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SAME transposed conv, output = input * stride. w (I, O, k, k) is the
    JAX kernel flipped in space (see ``Deconv2d.from_jax``)."""
    k = w.shape[-1]
    if (k - stride) % 2 or k < stride:
        raise ValueError(f"deconv2d needs even k - stride >= 0, got k={k}, "
                         f"stride={stride}")
    if dtype == torch.float32:
        return F.conv_transpose2d(x, w, b, stride=stride,
                                  padding=(k - stride) // 2)
    y = F.conv_transpose2d(_cast(x, dtype), _cast(w, dtype), None,
                           stride=stride, padding=(k - stride) // 2)
    return y if b is None else _add_bias(y, b)


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              running_mean: torch.Tensor, running_var: torch.Tensor, *,
              train: bool, eps: float = BN_EPS, mesh: Optional[Mesh] = None):
    """Normalize over all axes but dim 1 (channels).

    Statistics are fp32; the affine runs in x's dtype, so a bf16 x gives a
    bf16 y. Returns (y, batch_mean, batch_var); the batch stats are None in
    eval mode, which normalizes with the running stats. With a data-parallel
    `mesh`, train mode averages the mean and E[x^2] over the ranks (one
    differentiable all-reduce) before taking the variance, so each rank
    normalizes with the global batch's statistics."""
    if train:
        red = [0] + list(range(2, x.ndim))
        xf = x.float()
        mean = xf.mean(red)
        msq = (xf * xf).mean(red)
        if mesh is not None and mesh.collective:
            mean, msq = all_reduce_mean(torch.stack([mean, msq]),
                                        mesh).unbind(0)
        var = msq - mean * mean
    else:
        mean, var = running_mean, running_var
    inv = torch.rsqrt(var + eps) * scale
    shift = bias - mean * inv
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x * _cast(inv, x.dtype).view(shape)
         + _cast(shift, x.dtype).view(shape))
    return (y, mean, var) if train else (y, None, None)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def out_size_up(size: int, n_layers: int) -> int:
    """Spatial seed size for a stack of n stride-2 upsampling layers."""
    s, r = divmod(size, 2 ** n_layers)
    if r:
        raise ValueError(f"image_size {size} not divisible by 2^{n_layers}")
    return s


# ---------------------------------------------------------------------------
# Modules holding weights
# ---------------------------------------------------------------------------

def normal(shape, gen: torch.Generator, std: float = _W_STD) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


class _Layer(nn.Module):
    """A layer whose weight ``w`` has a JAX layout that differs from its
    torch layout; every other tensor has the same layout in both."""

    def _w_from_jax(self, a: np.ndarray) -> np.ndarray:
        return a

    def _w_to_jax(self, a: np.ndarray) -> np.ndarray:
        return a

    def from_jax(self, name: str, a: np.ndarray) -> np.ndarray:
        return self._w_from_jax(a) if name == "w" else a

    def to_jax(self, name: str, a: np.ndarray) -> np.ndarray:
        return self._w_to_jax(a) if name == "w" else a


def _bias(n: int, bias: bool) -> Optional[nn.Parameter]:
    return nn.Parameter(torch.zeros(n)) if bias else None


class Dense(_Layer):
    def __init__(self, din: int, dout: int, gen: torch.Generator, *,
                 bias: bool = True, std: float = _W_STD):
        super().__init__()
        self.w = nn.Parameter(normal((din, dout), gen, std))
        self.b = _bias(dout, bias)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        return dense(x, self.w, self.b, dtype)


class Conv2d(_Layer):
    def __init__(self, k: int, cin: int, cout: int, gen: torch.Generator, *,
                 bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(
            torch.from_numpy(self._w_from_jax(
                normal((k, k, cin, cout), gen).numpy())).contiguous())
        self.b = _bias(cout, bias)

    def _w_from_jax(self, a):   # HWIO -> OIHW
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))

    def _w_to_jax(self, a):
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))

    def forward(self, x, stride: int = 2,
                dtype: torch.dtype = torch.float32):
        return conv2d(x, self.w, self.b, stride, dtype)


class Deconv2d(_Layer):
    def __init__(self, k: int, cin: int, cout: int, gen: torch.Generator, *,
                 bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(
            torch.from_numpy(self._w_from_jax(
                normal((k, k, cin, cout), gen).numpy())).contiguous())
        self.b = _bias(cout, bias)

    def _w_from_jax(self, a):   # HWIO, unflipped -> (I, O, k, k), flipped
        return np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))

    def _w_to_jax(self, a):
        return np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1])

    def forward(self, x, stride: int = 2,
                dtype: torch.dtype = torch.float32):
        return deconv2d(x, self.w, self.b, stride, dtype)


class Conv3d(_Layer):
    def __init__(self, k: Tuple[int, int, int], cin: int, cout: int,
                 gen: torch.Generator, *, bias: bool = True,
                 std: float = _W_STD):
        super().__init__()
        self.w = nn.Parameter(
            torch.from_numpy(self._w_from_jax(
                normal((*k, cin, cout), gen, std).numpy())).contiguous())
        self.b = _bias(cout, bias)

    def _w_from_jax(self, a):   # DHWIO -> OIDHW
        return np.ascontiguousarray(a.transpose(4, 3, 0, 1, 2))

    def _w_to_jax(self, a):
        return np.ascontiguousarray(a.transpose(2, 3, 4, 1, 0))

    def forward(self, x, stride: Tuple[int, int, int],
                dtype: torch.dtype = torch.float32):
        return conv3d(x, self.w, self.b, stride, dtype)


class BatchNorm(_Layer):
    """Hand-written BN; running stats are buffers ``mean`` and ``var``.

    ``forward(x, train, update, mesh)``: in train mode the batch stats (over
    the ranks of `mesh`) normalize and, when ``update`` is set, advance the
    running stats in place (``advance``)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def normalize(self, x, train: bool, mesh: Optional[Mesh] = None):
        """(y, batch mean, batch var), the stats None in eval mode; the
        running stats are left as they are. `mesh`: see ``batchnorm``."""
        return batchnorm(x, self.scale, self.bias, self.mean, self.var,
                         train=train, mesh=mesh)

    @torch.no_grad()
    def advance(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = 0.9 * running + 0.1 * batch, in place."""
        m = BN_MOMENTUM
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)

    def forward(self, x, train: bool, update: bool = True,
                mesh: Optional[Mesh] = None):
        y, mean, var = self.normalize(x, train, mesh)
        if train and update:
            self.advance(mean, var)
        return y
