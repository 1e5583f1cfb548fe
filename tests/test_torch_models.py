"""The port's GRU, generator and discriminators against the JAX package's,
at the tiny test geometry (32x32x8 frames, widths 8, batch 8).

Weights come from ``mocogan_tpu.train.state.create`` and reach the port
through ``bridge.py``; the noise is drawn with ``jax.random`` exactly as
the JAX functions draw it and handed to the port. Tolerances: the GRU is a
few small fp32 products (1e-6); the networks stack four conv + BN layers,
and BN divides by batch standard deviations, which magnifies the ulp-level
differences of reordered sums: 1e-4 absolute on O(1) outputs, 1e-5 on the
running stats.
"""

import jax
import numpy as np
import pytest
import torch

from mocogan_tpu.models import discriminators as jdisc
from mocogan_tpu.models import generator as jgen
from mocogan_tpu.models import motion as jmotion
from mocogan_tpu.train import state as jstate_mod
from mocogan_tpu.utils import prng as jprng
from mocogan_tpu_torch import bridge, get_config
from mocogan_tpu_torch.models import discriminators as tdisc
from mocogan_tpu_torch.models import generator as tgen
from mocogan_tpu_torch.models import motion as tmotion

torch.set_num_threads(1)

TINY = {"model.image_size": 32, "model.video_length": 8,
        "model.gen_features": 8, "model.disc_features": 8,
        "train.batch_size": 8, "train.steps_per_call": 1,
        "data.device_cache": False}
ATOL = 1e-4


@pytest.fixture(scope="module")
def jstate(tiny_cfg):
    s = jstate_mod.create(tiny_cfg)
    return jax.tree.map(np.array, s.params), jax.tree.map(np.array, s.bn)


def _latents(key, cfg, n):
    """z_c, h0, eps as generator.sample_videos draws them from `key`."""
    m = cfg.model
    t = m.video_length
    normal = jax.random.normal
    return {"z_c": normal(jprng.role_key(key, "content"), (n, m.dim_content)),
            "h0": normal(jprng.role_key(key, "motion_init"),
                         (n, m.dim_motion)),
            "eps": normal(jprng.role_key(key, "motion_noise"),
                          (t, n, m.dim_eps))}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def _bn_close(got_tree, want_tree):
    assert set(got_tree) == set(want_tree)
    for name in want_tree:
        for s in ("mean", "var"):
            _close(got_tree[name][s], want_tree[name][s], atol=1e-5)


def _gen(params, bn):
    g = tgen.init(get_config("mug", **TINY).model, torch.Generator())
    return bridge.load_net(g, params["gen"], bn["gen"])


def test_gru_roll_matches_sample_motion(jstate, tiny_cfg):
    params, _ = jstate
    key = jax.random.key(3)
    want = jmotion.sample_motion(params["gen"]["gru"], key, 8,
                                 tiny_cfg.model)
    lat = _t(_latents(key, tiny_cfg, 8))
    gru = tmotion.init(get_config("mug", **TINY).model, torch.Generator())
    bridge.load_net(torch.nn.ModuleDict({"gru": gru}),
                    {"gru": params["gen"]["gru"]})
    got = tmotion.sample_motion(gru, lat["h0"], lat["eps"])
    assert got.shape == (8, 8, tiny_cfg.model.dim_motion)
    _close(got.detach(), want, atol=1e-6)


def test_gru_is_not_nn_gru_convention():
    """c = tanh(W_c e + U_c (r*h)): the reset gate acts before U_c."""
    gru = tmotion.GRU(3, 4, torch.Generator().manual_seed(0))
    h = torch.randn(2, 4)
    e = torch.randn(2, 3)
    with torch.no_grad():
        d = 4
        gx = e @ gru.w + gru.b
        r = torch.sigmoid(gx[:, :d] + h @ gru.u[:, :d])
        u = torch.sigmoid(gx[:, d:2 * d] + h @ gru.u[:, d:2 * d])
        c = torch.tanh(gx[:, 2 * d:] + (r * h) @ gru.u[:, 2 * d:])
        torch.testing.assert_close(tmotion.gru_cell(gru, h, e),
                                   (1 - u) * h + u * c)


def test_sample_videos_train_mode_with_bn_state(jstate, tiny_cfg):
    params, bn = jstate
    key = jax.random.key(4)
    want, want_bn, _ = jgen.sample_videos(params["gen"], bn["gen"], key, 8,
                                          tiny_cfg.model, train=True)
    g = _gen(params, bn)
    lat = _t(_latents(key, tiny_cfg, 8))
    got = tgen.sample_videos(g, lat["z_c"], lat["h0"], lat["eps"],
                             train=True)
    assert got.shape == (8, 8, 32, 32, 3)
    _close(got.detach(), want)
    _bn_close(bridge.bn_tree(g), jax.tree.map(np.asarray, want_bn))


def test_decode_frames_train_mode(jstate, tiny_cfg):
    params, bn = jstate
    z = np.random.default_rng(0).standard_normal(
        (6, tiny_cfg.model.dim_z)).astype(np.float32)
    want, want_bn = jgen.decode_frames(params["gen"], bn["gen"], z,
                                       tiny_cfg.model, train=True)
    g = _gen(params, bn)
    got = tgen.decode_frames(g, torch.from_numpy(z), train=True)
    _close(got.detach(), want)
    _bn_close(bridge.bn_tree(g), jax.tree.map(np.asarray, want_bn))


def test_generate_eval_mode(jstate, tiny_cfg):
    """generate() uses running stats; non-trivial stats come from one
    train-mode pass first (on both sides)."""
    params, bn = jstate
    _, bn1, _ = jgen.sample_videos(params["gen"], bn["gen"],
                                   jax.random.key(5), 8, tiny_cfg.model,
                                   train=True)
    bn1 = jax.tree.map(np.asarray, bn1)
    key = jax.random.key(6)
    want = jgen.generate(params["gen"], bn1, key, 4, tiny_cfg.model)
    g = _gen(params, {"gen": bn1})
    got = tgen.generate(g, 4, latents=_t(_latents(key, tiny_cfg, 4)))
    assert got.shape == (4, 8, 32, 32, 3)
    _close(got, want)
    assert float(got.abs().max()) <= 1.0
    u8 = tgen.to_uint8(got)
    assert u8.dtype == torch.uint8
    np.testing.assert_array_less(
        np.abs(u8.numpy().astype(int)
               - np.asarray(jgen.to_uint8(want)).astype(int)), 2)


def test_generate_is_deterministic_from_seed(jstate):
    params, bn = jstate
    g = _gen(params, bn)
    a = tgen.generate(g, 2, seed=7)
    b = tgen.generate(g, 2, seed=7)
    assert torch.equal(a, b)
    assert not torch.equal(a, tgen.generate(g, 2, seed=8))


@pytest.mark.parametrize("train", [True, False])
def test_image_discriminator(jstate, tiny_cfg, train):
    params, bn = jstate
    x = np.random.default_rng(1).uniform(-1, 1, (8, 32, 32, 3)).astype(
        np.float32)
    want, want_bn = jdisc.image_apply(params["di"], bn["di"], x,
                                      tiny_cfg.model, train=train)
    di = bridge.load_net(
        tdisc.image_init(get_config("mug", **TINY).model, torch.Generator()),
        params["di"], bn["di"])
    got = tdisc.image_apply(di, torch.from_numpy(x), train=train)
    assert got.shape == (8, 1)
    _close(got.detach(), want)
    if train:
        _bn_close(bridge.bn_tree(di), jax.tree.map(np.asarray, want_bn))


@pytest.mark.parametrize("train", [True, False])
def test_video_discriminator(jstate, tiny_cfg, train):
    params, bn = jstate
    x = np.random.default_rng(2).uniform(-1, 1, (4, 8, 32, 32, 3)).astype(
        np.float32)
    want, _, want_bn = jdisc.video_apply(params["dv"], bn["dv"], x,
                                         tiny_cfg.model, train=train)
    dv = bridge.load_net(
        tdisc.video_init(get_config("mug", **TINY).model, torch.Generator()),
        params["dv"], bn["dv"])
    got, cls = tdisc.video_apply(dv, torch.from_numpy(x), train=train)
    assert got.shape == (4, 1) and cls is None
    _close(got.detach(), want)
    if train:
        _bn_close(bridge.bn_tree(dv), jax.tree.map(np.asarray, want_bn))


def test_bridge_round_trip_is_exact(jstate):
    params, bn = jstate
    for name, init in (("gen", tgen.init), ("di", tdisc.image_init),
                       ("dv", tdisc.video_init)):
        net = bridge.load_net(init(get_config("mug", **TINY).model,
                                   torch.Generator()), params[name],
                              bn[name])
        got = bridge.params_tree(net)
        jax.tree.map(np.testing.assert_array_equal, got, params[name])
        jax.tree.map(np.testing.assert_array_equal, bridge.bn_tree(net),
                     bn[name])
