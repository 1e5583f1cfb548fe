"""The port's conv routes (``ops/layers.py``) against the JAX package's layers.

Every pass of a conv or transposed conv runs on a route that repeats bit
for bit on the card: the forward on cuDNN's forward algorithm, the data
gradient (and a transposed conv's forward) on the sub-pixel forward conv
or cuDNN's deterministic backward-data algorithm (``layers._dgrad`` picks
by precision and channels), the weight gradient on batched GEMMs of
im2col columns or cuDNN's deterministic backward-filter algorithm
(``layers._wgrad`` picks by precision, both TF32 switches and the input's
channels). On the CPU the same code runs without cuDNN, so each route is
held here to ``jax.vjp`` of the JAX layer in fp32 (the route is forced):
the forward output and the gradients of input, weight and bias, each
within 1e-5 x max|JAX| (fp32 sums of up to 512 products taken in another
order). ``torch.autograd.gradcheck`` in float64 holds the backward to the
forward's own finite differences.

Cases: D_V's first conv (stride (1, 2, 2), time padded (1, 2)) and its
later ones (2, 2, 2), D_I's stride-2 conv, G's first transposed conv
(4 -> 8) and a later one with a bias, at even and odd sizes; the GEMM
weight gradient on the RGB-input layers among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocogan_tpu.ops import layers as jl
from mocogan_tpu_torch.ops import layers as tl

torch.set_num_threads(1)

REL_TOL = 1e-5      # of max|JAX| per output

# (layer, input spatial size, cin, cout, stride)
CASES = {
    "dv_first_even": ("conv3d", (8, 8, 8), 3, 4, (1, 2, 2)),
    "dv_first_odd": ("conv3d", (7, 9, 9), 3, 4, (1, 2, 2)),
    "dv_later_even": ("conv3d", (8, 8, 8), 4, 5, (2, 2, 2)),
    "dv_later_odd": ("conv3d", (5, 7, 7), 4, 5, (2, 2, 2)),
    "di_even": ("conv2d", (16, 16), 3, 6, (2, 2)),
    "di_odd": ("conv2d", (9, 9), 6, 5, (2, 2)),
    "g_first": ("deconv2d", (4, 4), 16, 8, (2, 2)),
    "g_odd": ("deconv2d", (3, 3), 8, 6, (2, 2)),
    "g_last": ("deconv2d", (8, 8), 6, 3, (2, 2)),
}

ROUTES = {"subpixel": tl._dgrad_subpixel, "cudnn": tl._dgrad_cudnn}


def _jax(kind, p, x, stride):
    if kind == "conv3d":
        return jl.conv3d(p, x, stride=stride)
    return getattr(jl, kind)(p, x, stride=stride[0])


def _torch(kind, layer, x, stride):
    return layer(x, stride if kind == "conv3d" else stride[0])


def _layer(kind, k, cin, cout, w, b):
    cls = {"conv3d": tl.Conv3d, "conv2d": tl.Conv2d,
           "deconv2d": tl.Deconv2d}[kind]
    layer = cls((k,) * 3 if kind == "conv3d" else k, cin, cout,
                torch.Generator())
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(layer.from_jax("w", w)))
        layer.b.copy_(torch.from_numpy(b))
    return layer


def _first(x):      # channels-last -> channels-first
    return np.moveaxis(x, -1, 1)


def _check_against_jax(case):
    """The layer's forward and its input, weight and bias gradients
    against ``jax.vjp`` of the JAX layer, on seeded inputs."""
    kind, size, cin, cout, stride = CASES[case]
    k = 4
    r = np.random.default_rng(sorted(CASES).index(case))
    x = r.standard_normal((2, *size, cin), np.float32)
    w = (r.standard_normal((*(k,) * len(size), cin, cout), np.float32)
         * 0.2)
    b = r.standard_normal((cout,), np.float32)
    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    y, vjp = jax.vjp(lambda p_, x_: _jax(kind, p_, x_, stride), p,
                     jnp.asarray(x))
    g = r.standard_normal(y.shape, np.float32)
    gp, gx = vjp(jnp.asarray(g))
    want = {"y": _first(np.asarray(y)), "x": _first(np.asarray(gx)),
            "w": np.asarray(gp["w"]), "b": np.asarray(gp["b"])}

    layer = _layer(kind, k, cin, cout, w, b)
    xt = torch.from_numpy(_first(x).copy()).requires_grad_()
    yt = _torch(kind, layer, xt, stride)
    gx_t, gw_t, gb_t = torch.autograd.grad(
        yt, [xt, layer.w, layer.b], torch.from_numpy(_first(g).copy()))
    got = {"y": yt.detach().numpy(), "x": gx_t.numpy(),
           "w": layer.to_jax("w", gw_t.numpy()), "b": gb_t.numpy()}
    for name, v in want.items():
        assert got[name].shape == v.shape, name
        err = np.abs(got[name] - v).max() / np.abs(v).max()
        assert err <= REL_TOL, (name, err)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_matches_jax_vjp(case, route, monkeypatch):
    monkeypatch.setattr(tl, "_dgrad", ROUTES[route])
    _check_against_jax(case)


def _spy(monkeypatch, fns):
    """Wrap each of `fns` (layers' functions) to record its name when it
    runs; returns the list of names."""
    picked = []
    for f in fns:
        monkeypatch.setattr(tl, f.__name__,
                            lambda *a, _f=f: picked.append(_f.__name__)
                            or _f(*a))
    return picked


def _tf32(monkeypatch, cudnn, matmul):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)


@pytest.mark.parametrize("case", ["dv_first_even", "dv_first_odd",
                                  "di_even", "g_last"])
def test_wgrad_gemm_matches_jax_vjp(case, monkeypatch):
    """With both TF32 switches off, the layers whose conv input has 3
    channels take their fp32 weight gradient from the GEMM route."""
    _tf32(monkeypatch, False, False)
    picked = _spy(monkeypatch, [tl._wgrad_gemm, tl._wgrad_cudnn])
    _check_against_jax(case)
    assert picked == ["_wgrad_gemm"]


# (layer, input spatial size, stride): tiny float64 gradchecks
GRADCHECK = {
    "conv3d_time_pad_1_2": ("conv3d", (4, 4, 4), (1, 2, 2)),
    "conv3d_odd": ("conv3d", (3, 5, 5), (2, 2, 2)),
    "conv2d_odd": ("conv2d", (5, 5), (2, 2)),
    "deconv2d": ("deconv2d", (3, 3), (2, 2)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", sorted(GRADCHECK))
def test_route_gradcheck_float64(case, route, monkeypatch):
    kind, size, stride = GRADCHECK[case]
    monkeypatch.setattr(tl, "_dgrad", ROUTES[route])
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, *size, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    wshape = (2, 3, 4, 4) if kind == "deconv2d" else (3, 2, *(4,) * len(size))
    w = torch.randn(wshape, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(3, generator=gen, dtype=torch.float64, requires_grad=True)
    if kind == "conv3d":
        fn = lambda x_, w_, b_: tl.conv3d(x_, w_, b_, stride, torch.float64)
    else:
        fn = lambda x_, w_, b_: getattr(tl, kind)(x_, w_, b_, stride[0],
                                                  torch.float64)
    assert torch.autograd.gradcheck(fn, (x, w, b))


@pytest.mark.parametrize("case", sorted(GRADCHECK))
def test_wgrad_gemm_gradcheck_float64(case, monkeypatch):
    """The GEMM weight gradient (forced: float64 is not its precision)
    against the forward's finite differences."""
    kind, size, stride = GRADCHECK[case]
    monkeypatch.setattr(tl, "_wgrad", tl._wgrad_gemm)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 2, *size, generator=gen, dtype=torch.float64)
    wshape = (2, 3, 4, 4) if kind == "deconv2d" else (3, 2, *(4,) * len(size))
    w = torch.randn(wshape, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    if kind == "conv3d":
        fn = lambda w_: tl.conv3d(x, w_, None, stride, torch.float64)
    else:
        fn = lambda w_: getattr(tl, kind)(x, w_, None, stride[0],
                                          torch.float64)
    assert torch.autograd.gradcheck(fn, (w,))


@pytest.mark.parametrize("cin", [3, 8])
@pytest.mark.parametrize("matmul_tf32", [False, True])
@pytest.mark.parametrize("cudnn_tf32", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_wgrad_route_by_precision_and_channels(dtype, cudnn_tf32,
                                               matmul_tf32, cin,
                                               monkeypatch):
    """The GEMM weight gradient for fp32 onto at most 4 input channels
    with neither TF32 switch on, cuDNN's deterministic one otherwise;
    either gives the float64 conv's weight gradient."""
    _tf32(monkeypatch, cudnn_tf32, matmul_tf32)
    picked = _spy(monkeypatch, [tl._wgrad_gemm, tl._wgrad_cudnn])
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, cin, 6, 6, generator=gen, dtype=torch.float64)
    w = torch.randn(5, cin, 4, 4, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 5, 3, 3, generator=gen, dtype=torch.float64)
    wt = w.to(dtype).requires_grad_()
    (got,) = torch.autograd.grad(tl.conv2d(x, wt, None, 2, dtype), wt,
                                 g.to(dtype))
    ref = torch.nn.grad.conv2d_weight(x.to(dtype).double(), w.shape,
                                      g.to(dtype).double(), stride=2,
                                      padding=1)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((got.double() - ref).abs().max()) <= tol * float(
        ref.abs().max())
    gemm = dtype == torch.float32 and cin <= 4 and not (cudnn_tf32
                                                        or matmul_tf32)
    assert picked == ["_wgrad_gemm" if gemm else "_wgrad_cudnn"]


@pytest.mark.parametrize("dtype,tf32,cout,want", [
    (torch.float32, False, 8, "_dgrad_subpixel"),
    (torch.float32, True, 8, "_dgrad_cudnn"),
    (torch.float32, True, 3, "_dgrad_subpixel"),
    (torch.bfloat16, False, 8, "_dgrad_cudnn"),
    (torch.bfloat16, False, 3, "_dgrad_subpixel"),
    (torch.float64, True, 8, "_dgrad_subpixel")])
def test_dgrad_route_by_precision_and_channels(dtype, tf32, cout, want,
                                               monkeypatch):
    """cuDNN's deterministic data gradient where it runs on tensor cores
    (bf16, fp32 with TF32 allowed) onto more than 4 channels, the sub-pixel
    conv otherwise; either gives the plain transposed conv's values."""
    picked = _spy(monkeypatch, ROUTES.values())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    x = torch.randn(2, 6, 3, 3, dtype=torch.float64)
    w = torch.randn(6, cout, 4, 4, dtype=torch.float64)
    got = tl.deconv2d(x, w, None, 2, dtype)
    ref = torch.nn.functional.conv_transpose2d(
        x.to(dtype).double(), w.to(dtype).double(), stride=2, padding=1)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((got.double() - ref).abs().max()) <= tol * float(
        ref.abs().max())
    assert picked == [want]
