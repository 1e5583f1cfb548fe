"""The model variants of the port against the JAX package: bf16 compute,
the categorical MoCoGAN (labels in G, D_V's class head, the aux losses in
one step, the bridged state), and remat.

Tolerances:
  * bf16 layers: each output's dtype equals JAX's (bf16 after a layer
    without a bias, fp32 after one with a bias, BN in its input's dtype);
    values within BF16_TOL of the output's largest magnitude. Both
    frameworks accumulate in fp32 and round once, so the outputs agree but
    for the odd rounding tie; one bf16 ulp is 2^-8 of the value.
  * categorical generator and class head, fp32: 1e-5 absolute on the
    clips, 1e-4 on logits (the tolerance of ``test_torch_models``);
  * one categorical step: the tolerances of ``test_torch_step``;
  * remat: gradients and BN running stats equal the plain step's within
    1e-6 (the same arithmetic run twice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocogan_tpu.data import synthetic as jsynth
from mocogan_tpu.models import discriminators as jdisc
from mocogan_tpu.models import generator as jgen
from mocogan_tpu.ops import layers as jlayers
from mocogan_tpu.train import state as jstate_mod
from mocogan_tpu.train import step as jstep
from mocogan_tpu.utils import prng as jprng
from mocogan_tpu_torch import bridge, get_config
from mocogan_tpu_torch.data import synthetic
from mocogan_tpu_torch.models import discriminators as tdisc
from mocogan_tpu_torch.models import generator as tgen
from mocogan_tpu_torch.models import motion
from mocogan_tpu_torch.ops import layers as tlayers
from mocogan_tpu_torch.ops import preproc, sampling
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.train import step as tstep
from mocogan_tpu_torch.train.loop import Trainer
from mocogan_tpu_torch.utils import prng
from test_torch_checkpoint import _jax_trees
from test_torch_models import _latents, _t
from test_torch_step import LR, TINY, _jax_draws

torch.set_num_threads(1)

BF16_TOL = 2 ** -7
CAT = {**TINY, "model.n_classes": 4}


def _cat_cfg(**kw):
    return get_config("categorical", **{**CAT, **kw})


def _jax_cat_draws(key, cfg, batch):
    """``_jax_draws`` plus the fakes' labels, as jstep._loss_fn draws
    them from the step key."""
    d = _jax_draws(key, cfg, batch)
    d["labels"] = torch.from_numpy(np.array(jax.random.randint(
        jprng.role_key(key, "label"), (batch,), 0, cfg.model.n_classes)))
    return d


# ---- bf16 layers ---------------------------------------------------------------

def _layer(kind, bias, rng):
    """(JAX params, JAX apply(x, dtype), port module, port apply(x, dtype),
    input NHWC-style numpy, channels-last -> channels-first permutation)."""
    key = jax.random.key(int(rng.integers(1 << 30)))
    if kind == "dense":
        p = jlayers.dense_init(key, 24, 10, bias=bias)
        m = tlayers.Dense(24, 10, torch.Generator(), bias=bias)
        return (p, lambda x, d: jlayers.dense(p, x, dtype=d), m,
                lambda x, d: m(x, d), rng.standard_normal((6, 24)), None)
    if kind == "conv2d":
        p = jlayers.conv2d_init(key, 4, 3, 8, bias=bias)
        m = tlayers.Conv2d(4, 3, 8, torch.Generator(), bias=bias)
        return (p, lambda x, d: jlayers.conv2d(p, x, stride=2, dtype=d), m,
                lambda x, d: m(x, 2, d), rng.uniform(-1, 1, (4, 16, 16, 3)),
                (0, 3, 1, 2))
    if kind == "deconv2d":
        p = jlayers.deconv2d_init(key, 4, 8, 3, bias=bias)
        m = tlayers.Deconv2d(4, 8, 3, torch.Generator(), bias=bias)
        return (p, lambda x, d: jlayers.deconv2d(p, x, stride=2, dtype=d), m,
                lambda x, d: m(x, 2, d), rng.standard_normal((4, 4, 4, 8)),
                (0, 3, 1, 2))
    # D_V's first conv: temporal stride 1, XLA pads time (1, 2)
    p = jlayers.conv3d_init(key, (4, 4, 4), 3, 8, bias=bias)
    m = tlayers.Conv3d((4, 4, 4), 3, 8, torch.Generator(), bias=bias)
    return (p, lambda x, d: jlayers.conv3d(p, x, stride=(1, 2, 2), dtype=d),
            m, lambda x, d: m(x, (1, 2, 2), d),
            rng.uniform(-1, 1, (2, 6, 16, 16, 3)), (0, 4, 1, 2, 3))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("kind", ["dense", "conv2d", "deconv2d", "conv3d"])
def test_bf16_layer_matches_jax(kind, bias):
    rng = np.random.default_rng(
        2 * ["dense", "conv2d", "deconv2d", "conv3d"].index(kind) + bias)
    p, japply, mod, tapply, x, perm = _layer(kind, bias, rng)
    bridge.load_net(torch.nn.ModuleDict({"l": mod}), {"l": p})
    x = x.astype(np.float32)
    want = japply(jnp.asarray(x), jnp.bfloat16)
    xt = torch.from_numpy(x)
    if perm is not None:
        xt = xt.permute(*perm)
    with torch.no_grad():
        got = tapply(xt, torch.bfloat16)
        got32 = tapply(xt, torch.float32)
    # JAX adds the bias after the product: bf16 + fp32 -> fp32
    assert str(want.dtype) == ("float32" if bias else "bfloat16")
    assert got.dtype == (torch.float32 if bias else torch.bfloat16)
    if perm is not None:
        inv = np.argsort(perm)
        got, got32 = got.permute(*inv), got32.permute(*inv)
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * scale)
    # and bf16 is not fp32: the cast is real
    assert not np.allclose(got.float().numpy(), got32.numpy(), rtol=0,
                           atol=1e-6 * scale)


@pytest.mark.parametrize("train", [True, False])
def test_bf16_batchnorm_matches_jax(train):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 6, 5, 5)) * 2 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bias": rng.standard_normal(5).astype(np.float32)}
    state = {"mean": rng.standard_normal(5).astype(np.float32),
             "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, new = jlayers.batchnorm(params, state, xb, train=train)
    bn = tlayers.BatchNorm(5)
    bridge.load_net(torch.nn.ModuleDict({"bn": bn}), {"bn": params},
                    {"bn": state})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        got = bn(xt, train)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=BF16_TOL * np.abs(want).max())
    # the statistics are fp32 (of the bf16 input), the buffers stay fp32
    assert bn.mean.dtype == bn.var.dtype == torch.float32
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), new[k],
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def bf16_nets(tiny_cfg):
    """(port state at bf16, JAX params, JAX bn, JAX bf16 model config) of
    one weight set."""
    import dataclasses

    cfg = get_config("mug", **{**TINY, "model.compute_dtype": "bfloat16"})
    s = tstate.create(cfg, device="cpu")
    params = {n: bridge.params_tree(net) for n, net in s.nets.items()}
    bn = {n: bridge.bn_tree(net) for n, net in s.nets.items()}
    return s, params, bn, dataclasses.replace(tiny_cfg.model,
                                              compute_dtype="bfloat16")


def _dtype_hooks(net):
    """Record every layer's output dtype, by layer name (a BN's from its
    ``normalize``, which the generator calls directly)."""
    seen = {}
    for name, mod in net.named_children():
        if isinstance(mod, tlayers.BatchNorm):
            def normalize(x, train, *mesh, n=name, f=mod.normalize):
                out = f(x, train, *mesh)
                seen[n] = out[0].dtype
                return out
            mod.normalize = normalize
        elif isinstance(mod, tlayers._Layer) and name != "gru":
            mod.register_forward_hook(
                lambda m, i, o, n=name: seen.__setitem__(n, o.dtype))
    return seen


def test_bf16_stage_dtypes_follow_the_bias(bf16_nets):
    """bf16 after bias-free layers, fp32 after a bias, BN keeps its input's
    dtype; G hands bf16 frames on in train mode and fp32 in eval mode; the
    GRU stays fp32; params stay fp32."""
    s = bf16_nets[0]
    g, di, dv = s.nets["gen"], s.nets["di"], s.nets["dv"]
    seen = {n: _dtype_hooks(net) for n, net in s.nets.items()}
    lat = tgen.draw_latents(g.cfg, 2, 0, 0, "cpu")
    with torch.no_grad():
        train = g.sample(lat["z_c"], lat["h0"], lat["eps"], train=True,
                         update=False)
        ev = g.sample(lat["z_c"], lat["h0"], lat["eps"], train=False)
        di(train[:, 0], train=True, update=False)
        logits, cls = dv(train.transpose(1, 2), train=True, update=False)
    bf, f32 = torch.bfloat16, torch.float32
    assert train.dtype == bf and ev.dtype == f32 and cls is None
    assert seen["gen"] == {"fc": bf, "bn_fc": bf, "deconv0": bf, "bn0": bf,
                           "deconv1": bf, "bn1": bf, "deconv2": bf, "bn2": bf,
                           "deconv3": f32}
    for net in ("di", "dv"):
        assert seen[net] == {"conv0": f32, "conv1": bf, "bn1": bf,
                             "conv2": bf, "bn2": bf, "conv3": bf, "bn3": bf,
                             "fc": f32}
    assert logits.dtype == f32
    with torch.no_grad():
        z_m = motion.sample_motion(g.gru, lat["h0"], lat["eps"])
    assert z_m.dtype == f32
    assert all(p.dtype == f32 for net in s.nets.values()
               for p in net.parameters())


def test_bf16_nets_match_jax(bf16_nets):
    """G in train and eval mode, D_I and D_V at bf16, against JAX at
    bf16 on the same weights, draws and clips."""
    s, params, bn, m = bf16_nets
    key = jax.random.key(4)
    x = np.random.default_rng(2).uniform(-1, 1, (4, 8, 32, 32, 3)).astype(
        np.float32)

    @jax.jit
    def jax_nets(params, bn, key, x):
        tr, _, _ = jgen.sample_videos(params["gen"], bn["gen"], key, 4, m,
                                      train=True)
        ev = jgen.generate(params["gen"], bn["gen"], key, 4, m)
        di, _ = jdisc.image_apply(params["di"], bn["di"], x[:, 0], m,
                                  train=True)
        dv, _, _ = jdisc.video_apply(params["dv"], bn["dv"], x, m,
                                     train=True)
        return tr, ev, di, dv

    want_tr, want_ev, want_di, want_dv = jax_nets(params, bn, key, x)
    lat = _t(_latents(key, get_config("mug", **TINY), 4))
    g = s.nets["gen"]
    with torch.no_grad():
        got_tr = tgen.sample_videos(g, lat["z_c"], lat["h0"], lat["eps"],
                                    train=True, update=False)
    got_ev = tgen.generate(g, 4, latents=lat)
    assert str(want_tr.dtype) == "bfloat16" and got_tr.dtype == torch.bfloat16
    assert str(want_ev.dtype) == "float32" and got_ev.dtype == torch.float32
    for got, want in ((got_tr, want_tr), (got_ev, want_ev)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=4 * BF16_TOL)
    with torch.no_grad():
        got_di = tdisc.image_apply(s.nets["di"], torch.from_numpy(x[:, 0]),
                                   train=True, update=False)
        got_dv, _ = tdisc.video_apply(s.nets["dv"], torch.from_numpy(x),
                                      train=True, update=False)
    for got, want in ((got_di, want_di), (got_dv, want_dv)):
        assert got.dtype == torch.float32 and str(want.dtype) == "float32"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=4 * BF16_TOL * np.abs(want).max())


# ---- the categorical model -----------------------------------------------------

@pytest.fixture(scope="module")
def cat_ref(tiny_cat_cfg):
    """A JAX categorical state, one JAX train step on it (the one compile of
    this file) with the step's draws, and the port's state bridged from
    the same start."""
    cfg = tiny_cat_cfg
    s0 = jstate_mod.create(cfg)
    trees0 = _jax_trees(s0)
    vids, labels = jsynth.make_batch(0, 8, t=8, size=32, n_classes=4)
    key = jprng.step_key(s0.root_key, s0.step)
    draws = _jax_cat_draws(key, cfg, 8)
    s1, metrics = jstep.jitted_train_step(cfg)(s0, jnp.asarray(vids),
                                               jnp.asarray(labels))
    return {"trees0": trees0, "trees1": _jax_trees(s1), "real": vids,
            "labels": labels, "draws": draws,
            "metrics": jax.tree.map(np.array, metrics)}


def test_conditional_generator_matches_jax(cat_ref, tiny_cat_cfg):
    """The clips of given labels, in train mode (with the BN update) and in
    eval mode, and the labels drawn by JAX when none are given."""
    trees = cat_ref["trees0"]
    m = tiny_cat_cfg.model
    g = bridge.load_net(tgen.init(_cat_cfg().model, torch.Generator()),
                        trees["params"]["gen"], trees["bn"]["gen"])
    key = jax.random.key(9)
    labels = np.array([3, 0, 1, 3, 2], np.int32)

    @jax.jit
    def jax_gen(params, bn, key, labels):
        tr, new_bn, _ = jgen.sample_videos(params, bn, key, 5, m, train=True,
                                           labels=labels)
        return tr, new_bn, jgen.generate(params, new_bn, key, 5, m)

    want, want_bn, want_ev = jax_gen(trees["params"]["gen"],
                                     trees["bn"]["gen"], key,
                                     jnp.asarray(labels))
    lat = _t(_latents(key, get_config("categorical", **CAT), 5))
    got = tgen.sample_videos(g, lat["z_c"], lat["h0"], lat["eps"],
                             train=True, labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for name, st in want_bn.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(getattr(g, name), k).numpy(),
                                       np.asarray(st[k]), atol=1e-5)
    # eval mode: labels drawn by JAX's "label" role, handed over
    drawn = np.array(jax.random.randint(jprng.role_key(key, "label"), (5,),
                                        0, m.n_classes))
    got_ev = tgen.generate(g, 5, latents={**lat, "labels":
                                          torch.from_numpy(drawn)})
    np.testing.assert_allclose(got_ev.numpy(), np.asarray(want_ev), rtol=0,
                               atol=1e-5)
    # the labels change the clips, and explicit labels override the draw
    other = tgen.generate(g, 5, latents=lat, labels=(torch.from_numpy(drawn)
                                                     + 1) % m.n_classes)
    assert not torch.allclose(other, got_ev)
    with pytest.raises(ValueError, match="labels"):
        g.sample(lat["z_c"], lat["h0"], lat["eps"], train=False)


def test_generate_draws_labels_from_the_label_role():
    g = tgen.init(_cat_cfg().model, torch.Generator())
    lat = tgen.draw_latents(g.cfg, 6, 5, 2, "cpu")
    assert lat["labels"].shape == (6,)
    want = torch.randint(0, 4, (6,), generator=prng.generator(5, 2, "label"))
    assert torch.equal(lat["labels"], want)
    # generate_chunked draws per chunk: chunk i from (seed, step i)
    chunks = tgen.generate_chunked(g, 5, seed=5, chunk=3)
    again = np.concatenate([
        tgen.generate(g, m, latents=tgen.draw_latents(g.cfg, m, 5, i,
                                                      "cpu")).numpy()
        for i, m in enumerate((3, 2))])
    np.testing.assert_array_equal(chunks, again)


@pytest.mark.parametrize("train", [True, False])
def test_class_head_matches_jax(cat_ref, tiny_cat_cfg, train):
    trees = cat_ref["trees0"]
    x = np.random.default_rng(3).uniform(-1, 1, (4, 8, 32, 32, 3)).astype(
        np.float32)
    want, want_cls, _ = jdisc.video_apply(
        trees["params"]["dv"], trees["bn"]["dv"], x, tiny_cat_cfg.model,
        train=train)
    dv = bridge.load_net(tdisc.video_init(_cat_cfg().model,
                                          torch.Generator()),
                         trees["params"]["dv"], trees["bn"]["dv"])
    got, cls = tdisc.video_apply(dv, torch.from_numpy(x), train=train)
    assert cls.shape == (4, 4) and got.shape == (4, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(want_cls),
                               atol=1e-4)


def test_categorical_step_matches_jax(cat_ref):
    """All seven metrics (the six losses and loss_gen_di), the updated
    params of every net (fc_cls included) and the BN stats."""
    r = cat_ref
    s = bridge.load_state(tstate.create(_cat_cfg(), device="cpu"),
                          r["trees0"])
    metrics = tstep.train_step(s, torch.from_numpy(r["real"]), r["draws"],
                               torch.from_numpy(r["labels"]))
    assert set(metrics) == set(r["metrics"]) == {
        "loss_di", "loss_dv", "loss_aux_d", "loss_gen_di", "loss_gen_dv",
        "loss_aux_g", "loss_gen"}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), r["metrics"][k], rtol=1e-5,
                                   err_msg=k)
    got, want = bridge.state_trees(s), r["trees1"]
    assert "fc_cls" in got["params"]["dv"]
    for name in s.nets:
        for layer, leaves in want["params"][name].items():
            for p, w in leaves.items():
                g = want["opt"][name]["mu"][layer][p] / 0.5
                clear = np.abs(g) > 1e-3 * np.abs(g).max()
                diff = np.abs(got["params"][name][layer][p] - w)
                assert diff[clear].max(initial=0) <= 1e-6, \
                    f"{name}.{layer}.{p}"
                assert diff.max() <= 2 * LR, f"{name}.{layer}.{p}"
        for layer, st in want["bn"][name].items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(got["bn"][name][layer][k], st[k],
                                           atol=1e-5)


def test_categorical_state_crosses_the_bridge_exactly(cat_ref):
    """A stepped JAX categorical state (Adam moments non-zero) into the
    port and back, bit-equal, fc_cls and its moments included."""
    trees = cat_ref["trees1"]
    assert np.abs(trees["opt"]["dv"]["mu"]["fc_cls"]["w"]).max() > 0
    back = bridge.state_trees(bridge.load_state(
        tstate.create(_cat_cfg(), device="cpu"), trees))
    assert jax.tree.structure(back) == jax.tree.structure(trees)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(trees)):
        np.testing.assert_array_equal(a, b)


def test_categorical_needs_labels():
    s = tstate.create(_cat_cfg(), device="cpu")
    with pytest.raises(ValueError, match="labels"):
        tstep.train_step(s, torch.zeros(8, 8, 32, 32, 3))
    pool = torch.zeros(2, 8, 40, 40, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="labels"):
        tstep.cached_multi_train_step(s, pool, torch.tensor([8, 8]), 1)
    assert s.step == 0


def test_device_cached_categorical_step_cpu(tmp_path):
    """Pool labels reach the step: one device-cached step equals
    train_step on the plain ingest of the same windows with labels[sel];
    other labels give other losses."""
    from mocogan_tpu_torch.data import clips

    store = synthetic.write_store(str(tmp_path / "s"), clips=6, frames=10,
                                  size=40, classes=4)
    pool_np, lengths_np, labels_np = clips.load_pool(store)
    assert len(set(labels_np.tolist())) > 1
    pool, lengths = torch.from_numpy(pool_np), torch.from_numpy(lengths_np)
    labels = torch.from_numpy(labels_np)
    cfg = _cat_cfg()
    d = tstep.draw_step(cfg, cfg.train.seed, 0, lengths, "cpu")
    s = tstate.create(cfg, device="cpu")
    launches = preproc.LAUNCHES["resize_norm"]
    got = tstep.cached_multi_train_step(s, pool, lengths, 1, draws=[d],
                                        labels=labels)
    assert preproc.LAUNCHES["resize_norm"] == launches
    assert {"loss_aux_d", "loss_aux_g"} <= set(got)
    assert all(np.isfinite(float(v)) for v in got.values())
    frames = sampling.window_indices(lengths, d["sel"], d["starts"], 8)
    real = preproc.subsample_and_preprocess(pool[d["sel"]], frames, 32)
    s2 = tstate.create(cfg, device="cpu")
    want = tstep.train_step(s2, real, d, labels[d["sel"]])
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    s3 = tstate.create(cfg, device="cpu")
    other = tstep.cached_multi_train_step(s3, pool, lengths, 1, draws=[d],
                                          labels=(labels + 1) % 4)
    assert float(other["loss_aux_d"]) != float(got["loss_aux_d"])


def test_trainer_trains_categorical_on_both_paths(tmp_path):
    """The categorical config through the Trainer, device-cached and
    host-fed, with the panel: finite aux losses in the log."""
    from mocogan_tpu_torch.train.loop import make_data_iterator

    store = synthetic.write_store(str(tmp_path / "s"), clips=6, frames=10,
                                  size=40, classes=4)
    for cached in (True, False):
        cfg = _cat_cfg(**{"data.data_dir": store,
                          "data.device_cache": cached,
                          "train.steps_per_call": 2, "train.log_every": 2,
                          "train.eval_every": 2, "train.eval_clips": 4})
        t = Trainer(cfg, out_dir=str(tmp_path / f"run{cached}"),
                    device="cpu")
        if cached:
            t.run_device_cached(total_steps=2)
        else:
            t.run(make_data_iterator(cfg), total_steps=2)
        recs = t.logger.history
        losses = [r for r in recs if "loss_aux_d" in r]
        assert t.state.step == 2 and len(losses) == 1
        assert all(np.isfinite(losses[0][k])
                   for k in ("loss_aux_d", "loss_aux_g", "loss_gen"))
        assert any("dv_margin" in r for r in recs)


# ---- remat ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step(dtype):
    """Gradients (simultaneous order) and G's BN running stats after one
    step equal those of the step without remat; the stats advance once."""
    real = torch.from_numpy(jsynth.make_batch(0, 8, t=8, size=32)[0])
    out = []
    for remat in (False, True):
        cfg = get_config("mug", **{**TINY, "model.remat": remat,
                                   "model.compute_dtype": dtype})
        s = tstate.create(cfg, device="cpu")
        noise = tstep.draw_noise(cfg, 0, 0, 8, "cpu")
        grads, metrics = tstep.compute_grads(s, real, noise)
        out.append((grads, metrics, bridge.bn_tree(s.nets["gen"])))
    (g0, m0, bn0), (g1, m1, bn1) = out
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6)
    for net in g0:
        for pn in g0[net]:
            np.testing.assert_allclose(g1[net][pn].numpy(),
                                       g0[net][pn].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{net}.{pn}")
    init = bridge.bn_tree(tstate.create(get_config("mug", **TINY),
                                        device="cpu").nets["gen"])
    for layer in bn0:
        for k in ("mean", "var"):
            np.testing.assert_allclose(bn1[layer][k], bn0[layer][k],
                                       rtol=0, atol=1e-6)
            # once: 0.9 * init + 0.1 * batch differs from init
            assert not np.allclose(bn1[layer][k], init[layer][k])
