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
  * Every conv pass repeats bit for bit on the card, with no global flag
    (``_Conv``): the forward runs cuDNN's forward algorithms, the data
    gradient (and a transposed conv's forward) ``_dgrad``'s route, the
    weight gradient cuDNN's deterministic algorithm scoped to that call.
    The bias is added after the conv in every dtype.
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

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mocogan_tpu_torch.parallel.mesh import Mesh, all_reduce_mean
from mocogan_tpu_torch.utils.platform import cudnn_deterministic

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


def _flat_pads(pads: Sequence[Tuple[int, int]]) -> list:
    """(lo, hi) per spatial dim -> ``F.pad``'s list, last dim first."""
    return [p for lo, hi in reversed(pads) for p in (lo, hi)]


def _padded(x: torch.Tensor, pads: Sequence[Tuple[int, int]]):
    """(x, padding) for ``torch.convolution``: symmetric pads go to the
    conv, asymmetric ones are applied to x first."""
    if all(lo == hi for lo, hi in pads):
        return x, [lo for lo, _ in pads]
    return F.pad(x, _flat_pads(pads)), [0] * len(pads)


def _conv_fwd(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
              pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """y = conv(pad(x), w, stride), cuDNN's default forward algorithm:
    forward algorithms use no atomics, so it repeats bit for bit."""
    x, padding = _padded(x, pads)
    nd = len(stride)
    return torch.convolution(x, w, None, list(stride), padding, [1] * nd,
                             False, [0] * nd, 1)


def _crop(t: torch.Tensor, pads: Sequence[Tuple[int, int]],
          size: Sequence[int]) -> torch.Tensor:
    """t[..., lo:lo + n] over the spatial dims: pad(x)'s gradient -> x's."""
    return t[(slice(None), slice(None),
              *[slice(lo, lo + n) for (lo, _), n in zip(pads, size)])]


def _backward_cudnn(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    stride: Sequence[int], padding: Sequence[int],
                    data: bool) -> torch.Tensor:
    """cuDNN's data (`data`) or weight gradient of y = conv(x, w, stride,
    padding) from its deterministic algorithms, picked by its heuristics
    (no benchmarking, so every process picks the same one). For the data
    gradient only x's shape is read."""
    nd = len(stride)
    with cudnn_deterministic():
        g = torch.ops.aten.convolution_backward(
            dy, x, w, None, list(stride), list(padding), [1] * nd, False,
            [0] * nd, 1, [data, not data, False])
    return g[0] if data else g[1]


def _wgrad(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
           stride: Sequence[int], pads: Sequence[Tuple[int, int]]
           ) -> torch.Tensor:
    """The weight gradient of y = conv(pad(x), w, stride)."""
    x, padding = _padded(x, pads)
    return _backward_cudnn(dy, x, w, stride, padding, data=False)


def _dgrad_subpixel(dy: torch.Tensor, w: torch.Tensor,
                    stride: Sequence[int], pads: Sequence[Tuple[int, int]],
                    size: Sequence[int]) -> torch.Tensor:
    """The data gradient of y = conv(pad(x), w, stride) for x of spatial
    `size`, as ONE stride-1 forward convolution and an interleave.

    Along a dim of stride s, kernel k and low pad lo, input position i
    (j = i + lo = q*s + r) receives dy[q - u] * w[r + s*u] for u < U =
    ceil(k/s): each phase r is a U-tap correlation of dy. The s phases of
    every dim become output channels of one conv with kernel U (the taps
    of w, zero-padded to U*s, regrouped and flipped), whose outputs are
    interleaved back and cropped to [lo, lo + n). Same FLOPs as the data
    gradient, plus one row of outputs per phase and dim where lo is not a
    multiple of s."""
    nd = len(stride)
    o, ci = w.shape[:2]
    ks = w.shape[2:]
    us = [-(-k // s) for k, s in zip(ks, stride)]
    wp = F.pad(w, [p for k, s, u in zip(reversed(ks), reversed(stride),
                                        reversed(us)) for p in (0, u * s - k)])
    wp = wp.reshape(o, ci, *[d for u, s in zip(us, stride) for d in (u, s)])
    wp = wp.flip([2 + 2 * d for d in range(nd)])
    wp = wp.permute(1, *[3 + 2 * d for d in range(nd)], 0,
                    *[2 + 2 * d for d in range(nd)])
    wp = wp.reshape(ci * math.prod(stride), o, *us)
    qs = [-(-(lo + n) // s) for (lo, _), n, s in zip(pads, size, stride)]
    z = _conv_fwd(dy, wp, [1] * nd,
                  [(u - 1, q - m) for u, q, m in zip(us, qs, dy.shape[2:])])
    z = z.view(dy.shape[0], ci, *stride, *qs)
    z = z.permute(0, 1, *[a for d in range(nd) for a in (2 + nd + d, 2 + d)])
    z = z.reshape(dy.shape[0], ci, *[q * s for q, s in zip(qs, stride)])
    return _crop(z, pads, size)


def _dgrad_cudnn(dy: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                 pads: Sequence[Tuple[int, int]], size: Sequence[int]
                 ) -> torch.Tensor:
    """The data gradient of y = conv(pad(x), w, stride) for x of spatial
    `size`, from cuDNN's deterministic backward-data algorithms; with
    asymmetric pads, of pad(x), cropped."""
    sym = all(lo == hi for lo, hi in pads)
    full = size if sym else [n + lo + hi for n, (lo, hi) in zip(size, pads)]
    x = dy.new_empty(1).expand(dy.shape[0], w.shape[1], *full)
    g = _backward_cudnn(dy, x, w, stride,
                        [lo if sym else 0 for lo, _ in pads], data=True)
    return g if sym else _crop(g, pads, size)


_FEW_CHANNELS = 4   # data gradients onto the frames (RGB) and alike


def _dgrad(dy: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
           pads: Sequence[Tuple[int, int]], size: Sequence[int]
           ) -> torch.Tensor:
    """The data gradient of y = conv(pad(x), w, stride) for x of spatial
    `size`; also the forward of a transposed conv. Where cuDNN computes it
    on tensor cores (bf16, or fp32 with cuDNN's TF32 allowed), its
    deterministic algorithms are as fast as its default ones, and take it.
    On CUDA cores (fp32 without TF32) they are 13-34x slower than the
    default in 3-D, so the sub-pixel forward conv takes it; so it does
    onto few channels (the frames' RGB: D_V's and D_I's first convs, G's
    last transposed conv), where it is 1.2-29x faster than the
    deterministic algorithm for D_V and G in every precision
    (``utils/conv_audit.py`` measured both on an H100)."""
    tensor_cores = dy.dtype == torch.bfloat16 or (
        dy.dtype == torch.float32 and torch.backends.cudnn.allow_tf32)
    if tensor_cores and w.shape[1] > _FEW_CHANNELS:
        return _dgrad_cudnn(dy, w, stride, pads, size)
    return _dgrad_subpixel(dy, w, stride, pads, size)


class _Conv(torch.autograd.Function):
    """A SAME conv, or (given its output `size`) the transposed conv that
    is a conv's data gradient, with every pass on a route that repeats bit
    for bit from the same inputs:

      * a conv's forward and a transposed conv's data gradient: cuDNN's
        forward algorithm (``_conv_fwd``);
      * a conv's data gradient and a transposed conv's forward:
        ``_dgrad``;
      * either weight gradient: cuDNN's deterministic backward-filter
        algorithm (``_wgrad``); a transposed conv's is the conv's, with
        its output gradient as the conv's input.

    cuDNN reads its flags when each kernel is launched, which is why the
    routes live in the backward itself. `pads` are the conv's (lo, hi) per
    spatial dim on its input, which is the transposed conv's output."""

    @staticmethod
    def forward(ctx, x, w, stride, pads, size):
        ctx.save_for_backward(x, w)
        ctx.geom = (stride, pads, size)
        if size is None:
            return _conv_fwd(x, w, stride, pads)
        return _dgrad(x, w, stride, pads, size)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pads, size = ctx.geom
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (_dgrad(g, w, stride, pads, x.shape[2:]) if size is None
                  else _conv_fwd(g, w, stride, pads))
        if ctx.needs_input_grad[1]:
            dw = (_wgrad(x, g, w, stride, pads) if size is None
                  else _wgrad(g, x, w, stride, pads))
        return dx, dw, None, None, None


def _conv_same(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               stride: Sequence[int], dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    x, w = _cast(x, dtype), _cast(w, dtype)
    pads = tuple(same_pads(x.shape[2 + i], w.shape[2 + i], s)
                 for i, s in enumerate(stride))
    y = _Conv.apply(x, w, tuple(stride), pads, None)
    return y if b is None else _add_bias(y, b)


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
    return _conv_same(x, w, b, (stride, stride), dtype)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: Tuple[int, int, int], dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """x (N, C, D, H, W), w (O, I, kd, kh, kw), SAME padding."""
    return _conv_same(x, w, b, stride, dtype)


def deconv2d(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None, stride: int = 2,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SAME transposed conv, output = input * stride. w (I, O, k, k) is the
    JAX kernel flipped in space (see ``Deconv2d.from_jax``): the weight of
    the stride-s conv whose data gradient this is, padded (k - s) / 2."""
    k = w.shape[-1]
    if (k - stride) % 2 or k < stride:
        raise ValueError(f"deconv2d needs even k - stride >= 0, got k={k}, "
                         f"stride={stride}")
    p = (k - stride) // 2
    y = _Conv.apply(_cast(x, dtype), _cast(w, dtype), (stride, stride),
                    ((p, p), (p, p)), tuple(n * stride for n in x.shape[2:]))
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
