"""One train step of the port's update-order and precision variants
against the JAX package's, from the same state, batch and draws (one JAX
train-step compile per variant, in module fixtures).

  * sequential order: metrics 1e-5 relative; params 1e-6 where the step's
    gradient is clear of noise and 2 * lr elsewhere (the tolerances of
    ``test_torch_step``); BN stats 1e-5. The D updates are bit-equal to the
    port's simultaneous step's (JAX's identity of ``_sequential_train_step``:
    same start-of-step params, same fakes), and G's update differs from
    it.
  * bf16 compute: metrics within BF16_RTOL relative. The two frameworks'
    bf16 convs round the odd tie apart, and batch-BN at every stage
    magnifies a 2^-8 step. At this init the gradients themselves are bf16
    noise: JAX's bf16 gradients differ from its fp32 ones by a large part
    of each leaf's largest value, and the port's bf16 D gradients are held
    within that spread of JAX's bf16 ones, leaf by leaf. So the update is
    held by its sign: Adam's first step is lr * sign(g), and at most
    BF16_FLIPS of each net's elements may step the other way (one flipped
    step, 2 * lr). Params, BN stats and Adam moments stay fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocogan_tpu.data import synthetic as jsynth
from mocogan_tpu.train import state as jstate_mod
from mocogan_tpu.train import step as jstep
from mocogan_tpu.utils import prng as jprng
from mocogan_tpu_torch import bridge, get_config
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.train import step as tstep
from test_torch_checkpoint import _jax_trees
from test_torch_step import LR, TINY, _jax_draws

torch.set_num_threads(1)

BF16_RTOL = 1e-2
BF16_FLIPS = 0.1


def _jax_step(cfg, **over):
    """Two JAX states' trees (before, after one jitted step of `cfg` with
    the "model." / "train." overrides), the batch, the step's draws and
    the metrics."""
    model = {k[6:]: v for k, v in over.items() if k.startswith("model.")}
    train = {k[6:]: v for k, v in over.items() if k.startswith("train.")}
    jcfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, **train))
    s0 = jstate_mod.create(jcfg)
    trees0 = _jax_trees(s0)
    vids, _ = jsynth.make_batch(0, 8, t=8, size=32)
    draws = _jax_draws(jprng.step_key(s0.root_key, s0.step), jcfg, 8)
    s1, metrics = jstep.jitted_train_step(jcfg)(s0, jnp.asarray(vids), None)
    return {"trees0": trees0, "trees1": _jax_trees(s1), "real": vids,
            "draws": draws, "metrics": jax.tree.map(np.array, metrics)}


def _port_step(ref, **over):
    s = bridge.load_state(
        tstate.create(get_config("mug", **{**TINY, **over}), device="cpu"),
        ref["trees0"])
    metrics = tstep.train_step(s, torch.from_numpy(ref["real"]),
                               ref["draws"])
    return s, {k: float(v) for k, v in metrics.items()}


def _params_close(got, want, before):
    """Params of `got` (trees) against JAX's after one step, the gradient
    taken from JAX's first Adam moment (mu = (1 - beta1) g from zero)."""
    for name in want["params"]:
        for layer, leaves in want["params"][name].items():
            for p, w in leaves.items():
                g = (want["opt"][name]["mu"][layer][p]
                     - 0.5 * before["opt"][name]["mu"][layer][p]) / 0.5
                clear = np.abs(g) > 1e-3 * np.abs(g).max()
                diff = np.abs(got["params"][name][layer][p] - w)
                assert diff[clear].max(initial=0) <= 1e-6, \
                    f"{name}.{layer}.{p}"
                assert diff.max() <= 2 * LR, f"{name}.{layer}.{p}"


# ---- sequential update order -------------------------------------------------

@pytest.fixture(scope="module")
def seq_ref(tiny_cfg):
    return _jax_step(tiny_cfg, **{"train.update_order": "sequential"})


def test_sequential_step_matches_jax(seq_ref):
    r = seq_ref
    s, metrics = _port_step(r, **{"train.update_order": "sequential"})
    assert s.step == 1
    assert set(metrics) == set(r["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(v, r["metrics"][k], rtol=1e-5,
                                   err_msg=k)
    got, want = bridge.state_trees(s), r["trees1"]
    _params_close(got, want, r["trees0"])
    for name in s.nets:
        for layer, st in want["bn"][name].items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(got["bn"][name][layer][k], st[k],
                                           atol=1e-5)


def test_sequential_d_update_equals_the_simultaneous_one(seq_ref):
    """The D updates (params, moments, BN stats) and the D losses of the two
    orders are bit-equal; G's update and G's losses are not, because G's
    loss sees the updated Ds."""
    seq, m_seq = _port_step(seq_ref, **{"train.update_order": "sequential"})
    sim, m_sim = _port_step(seq_ref)
    a, b = bridge.state_trees(seq), bridge.state_trees(sim)
    for net in ("di", "dv"):
        for x, y in zip(jax.tree.leaves(a["params"][net]),
                        jax.tree.leaves(b["params"][net])):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(jax.tree.leaves(a["opt"][net]),
                        jax.tree.leaves(b["opt"][net])):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(jax.tree.leaves(a["bn"][net]),
                        jax.tree.leaves(b["bn"][net])):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(jax.tree.leaves(a["bn"]["gen"]),
                    jax.tree.leaves(b["bn"]["gen"])):
        np.testing.assert_array_equal(x, y)        # G's BN advanced once
    for k in ("loss_di", "loss_dv"):
        assert m_seq[k] == m_sim[k]
    assert m_seq["loss_gen"] != m_sim["loss_gen"]
    gen_a = np.concatenate([x.ravel() for x in
                            jax.tree.leaves(a["params"]["gen"])])
    gen_b = np.concatenate([x.ravel() for x in
                            jax.tree.leaves(b["params"]["gen"])])
    assert not np.array_equal(gen_a, gen_b)


def test_sequential_every_k_skip(seq_ref):
    """d_update_every=2 at step 1 in the sequential order: D params and
    moments untouched, G still updates (against the un-updated Ds)."""
    r = seq_ref
    s = bridge.load_state(tstate.create(get_config("mug", **{
        **TINY, "train.update_order": "sequential",
        "train.d_update_every": 2}), device="cpu"), r["trees0"])
    real = torch.from_numpy(r["real"])
    tstep.train_step(s, real, r["draws"])
    before = {n: [p.detach().clone() for p in s.nets[n].parameters()]
              for n in s.nets}
    tstep.train_step(s, real, r["draws"])
    for n in ("di", "dv"):
        assert all(torch.equal(a, p)
                   for a, p in zip(before[n], s.nets[n].parameters()))
    assert not all(torch.equal(a, p) for a, p in
                   zip(before["gen"], s.nets["gen"].parameters()))


def test_sequential_debug_nans_raises_before_the_d_update():
    s = tstate.create(get_config("mug", **{
        **TINY, "train.update_order": "sequential"}), device="cpu")
    s.debug_nans = True
    before = [p.clone() for net in s.nets.values() for p in net.parameters()]
    with pytest.raises(FloatingPointError, match="loss_di"):
        tstep.train_step(s, torch.full((8, 8, 32, 32, 3), float("nan")))
    assert s.step == 0
    assert all(torch.equal(a, p) for a, p in zip(
        before, [p for net in s.nets.values() for p in net.parameters()]))


def test_unknown_update_order_raises():
    s = tstate.create(get_config("mug", **{
        **TINY, "train.update_order": "nope"}), device="cpu")
    with pytest.raises(ValueError, match="update_order"):
        tstep.train_step(s, torch.zeros(8, 8, 32, 32, 3))


# ---- bf16 compute ----------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_ref(tiny_cfg):
    return _jax_step(tiny_cfg, **{"model.compute_dtype": "bfloat16"})


def test_bf16_step_matches_jax(bf16_ref):
    r = bf16_ref
    s, metrics = _port_step(r, **{"model.compute_dtype": "bfloat16"})
    assert set(metrics) == set(r["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(v, r["metrics"][k], rtol=BF16_RTOL,
                                   err_msg=k)
    f32 = torch.float32
    for name, net in s.nets.items():
        assert all(p.dtype == f32 for p in net.parameters())
        assert all(b.dtype == f32 for b in net.buffers())
        for st in s.opt[name].state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == f32
    got, want = bridge.state_trees(s), r["trees1"]
    for name in s.nets:
        diffs = np.concatenate([
            np.abs(got["params"][name][layer][p] - w).ravel()
            for layer, leaves in want["params"][name].items()
            for p, w in leaves.items()])
        # a flipped step of a weight near 1 is 2 * lr plus fp32 rounding
        assert diffs.max() <= 2 * LR + 1e-6, name
        assert np.mean(diffs > 1e-6) <= BF16_FLIPS, name


def test_bf16_gradients_within_jaxs_own_bf16_spread(bf16_ref, seq_ref):
    """Per D leaf, the port's bf16 gradient is no further from JAX's bf16
    one than JAX's bf16 gradients are from its fp32 ones (largest leaf
    spread). Both references start from the same init; the sequential
    step's D gradients are the simultaneous step's (the identity above),
    and Adam's first moment holds them: mu = (1 - beta1) g."""
    s = bridge.load_state(tstate.create(get_config("mug", **{
        **TINY, "model.compute_dtype": "bfloat16"}), device="cpu"),
        bf16_ref["trees0"])
    grads, _ = tstep.compute_grads(s, torch.from_numpy(bf16_ref["real"]),
                                   bf16_ref["draws"])

    def rel(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    port, jax_spread = {}, []
    for name in ("di", "dv"):
        got = bridge.params_tree(s.nets[name], grads[name])
        for layer, leaves in got.items():
            for p, g in leaves.items():
                g16 = bf16_ref["trees1"]["opt"][name]["mu"][layer][p] / 0.5
                g32 = seq_ref["trees1"]["opt"][name]["mu"][layer][p] / 0.5
                port[f"{name}.{layer}.{p}"] = rel(g, g16)
                jax_spread.append(rel(g16, g32))
    assert min(jax_spread) > 1e-3          # bf16 is not fp32 in JAX either
    bad = {k: v for k, v in port.items() if v > max(jax_spread)}
    assert not bad, (bad, max(jax_spread))


def test_bf16_differs_from_fp32(bf16_ref):
    """The bf16 step is not the fp32 step run again."""
    _, m16 = _port_step(bf16_ref, **{"model.compute_dtype": "bfloat16"})
    _, m32 = _port_step(bf16_ref)
    assert m16["loss_gen"] != m32["loss_gen"]
    np.testing.assert_allclose(m16["loss_gen"], m32["loss_gen"], rtol=0.05)


def test_bf16_sequential_remat_step_is_finite(bf16_ref):
    """The scaled config's settings (bf16, remat) with the sequential
    order, at the tiny geometry: a finite step."""
    s, metrics = _port_step(bf16_ref, **{
        "model.compute_dtype": "bfloat16", "model.remat": True,
        "train.update_order": "sequential"})
    assert s.step == 1 and all(np.isfinite(v) for v in metrics.values())
