"""The port's train step and device-cached path against the JAX package's.

One ``train_step`` from the same state, batch and draws: every metric, the
per-net gradients, the Adam-updated params (back through ``bridge.py``)
and the new BN state. The draws are made with ``jax.random`` exactly as
``mocogan_tpu.train.step`` makes them and handed to the port.

Tolerances, fp32 on both sides:
  * metrics 1e-5 relative;
  * gradients 1e-4 of each leaf's largest magnitude: the whole G -> D ->
    loss chain with batch-BN at every stage sits between input and
    gradient, and reordered fp32 sums differ by ulps at every stage;
  * updated params 1e-6 absolute where the gradient is well above that
    noise. Adam's first step moves each weight by about lr * sign(g), so a
    gradient element inside the noise may take either sign; those elements
    are held to the step size 2 * lr instead;
  * BN running stats 1e-5 absolute.
"""

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
from mocogan_tpu_torch.data import synthetic
from mocogan_tpu_torch.ops import preproc, sampling
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.train import step as tstep

torch.set_num_threads(1)

TINY = {"model.image_size": 32, "model.video_length": 8,
        "model.gen_features": 8, "model.disc_features": 8,
        "train.batch_size": 8, "train.steps_per_call": 1,
        "data.device_cache": False}
LR = 2e-4


def _tcfg(**kw):
    return get_config("mug", **{**TINY, **kw})


def _jax_draws(key, cfg, batch):
    """The noise jstep._loss_fn draws from the step key."""
    m = cfg.model
    t = m.video_length
    normal = jax.random.normal
    k_real = jprng.role_key(key, "frame_sample")
    d = {"z_c": normal(jprng.role_key(key, "content"),
                       (batch, m.dim_content)),
         "h0": normal(jprng.role_key(key, "motion_init"),
                      (batch, m.dim_motion)),
         "eps": normal(jprng.role_key(key, "motion_noise"),
                       (t, batch, m.dim_eps)),
         "i_real": jax.random.randint(k_real, (batch,), 0, t),
         "i_fake": jax.random.randint(jax.random.fold_in(k_real, 1),
                                      (batch,), 0, t)}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _port_state(params, bn, cfg):
    s = tstate.create(cfg, device="cpu")
    for name, net in s.nets.items():
        bridge.load_net(net, params[name], bn[name])
    return s


@pytest.fixture(scope="module")
def reference(tiny_cfg):
    """JAX state, batch, step-0 draws, grads, metrics and stepped state."""
    s = jstate_mod.create(tiny_cfg)
    vids, _ = jsynth.make_batch(0, 8, t=8, size=32)
    real = jnp.asarray(vids)
    key = jprng.step_key(s.root_key, s.step)
    grads, (bn2, metrics) = jax.jit(
        lambda p, b, r, k: jax.grad(jstep._loss_fn, has_aux=True)(
            p, b, r, None, k, tiny_cfg))(s.params, s.bn, real, key)
    # train_step's own update of each net, applied to the same gradients
    # (one compiled program instead of two keeps this test quick)
    params2 = {name: jstep._update_net(name, s.params[name], s.opt[name],
                                       grads[name], tiny_cfg, s.step)[0]
               for name in s.params}
    tree = lambda t: jax.tree.map(np.array, t)  # noqa: E731
    return {"params": tree(s.params), "bn": tree(s.bn), "real": vids,
            "draws": _jax_draws(key, tiny_cfg, 8), "grads": tree(grads),
            "metrics": tree(metrics), "params2": tree(params2),
            "bn2": tree(bn2)}


def test_grads_and_metrics_match_jax(reference):
    r = reference
    s = _port_state(r["params"], r["bn"], _tcfg())
    grads, metrics = tstep.compute_grads(s, torch.from_numpy(r["real"]),
                                         r["draws"])
    assert set(metrics) == set(r["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), r["metrics"][k], rtol=1e-5)
    for name, net in s.nets.items():
        got = bridge.params_tree(net, grads[name])
        want = r["grads"][name]
        for layer in want:
            for p in want[layer]:
                w = want[layer][p]
                np.testing.assert_allclose(
                    got[layer][p], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                    err_msg=f"{name}.{layer}.{p}")


def test_train_step_matches_jax(reference):
    r = reference
    s = _port_state(r["params"], r["bn"], _tcfg())
    tstep.train_step(s, torch.from_numpy(r["real"]), r["draws"])
    assert s.step == 1
    for name, net in s.nets.items():
        got = bridge.params_tree(net)
        for layer, leaves in r["params2"][name].items():
            for p, want in leaves.items():
                g = r["grads"][name][layer][p]
                clear = np.abs(g) > 1e-3 * np.abs(g).max()
                diff = np.abs(got[layer][p] - want)
                assert diff[clear].max(initial=0) <= 1e-6, \
                    f"{name}.{layer}.{p}"
                assert diff.max() <= 2 * LR, f"{name}.{layer}.{p}"
        got_bn = bridge.bn_tree(net)
        for layer, st in r["bn2"][name].items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(got_bn[layer][k], st[k],
                                           atol=1e-5)


def test_every_k_skip_leaves_params_and_moments(reference):
    """d_update_every=2 at step 1: D params and Adam moments untouched."""
    r = reference
    s = _port_state(r["params"], r["bn"], _tcfg(**{"train.d_update_every": 2}))
    real = torch.from_numpy(r["real"])
    tstep.train_step(s, real, r["draws"])          # step 0: all update
    before = {n: [p.detach().clone() for p in s.nets[n].parameters()]
              for n in s.nets}
    moments = {n: [v["exp_avg"].clone() for v in s.opt[n].state.values()]
               for n in s.nets}
    tstep.train_step(s, real, r["draws"])          # step 1: D skipped
    for n in ("di", "dv"):
        for a, p in zip(before[n], s.nets[n].parameters()):
            assert torch.equal(a, p)
        for a, v in zip(moments[n], s.opt[n].state.values()):
            assert torch.equal(a, v["exp_avg"])
    assert not all(torch.equal(a, p) for a, p in
                   zip(before["gen"], s.nets["gen"].parameters()))


def _pool():
    pool = np.stack([synthetic.render_clip(0, i, 12, 48)[0]
                     for i in range(6)])
    lengths = torch.tensor([12, 12, 5, 12, 9, 12], dtype=torch.int32)
    return torch.from_numpy(pool), lengths


def test_cached_multi_train_step_cpu():
    """Finite, reproducible from the seed, no kernel launch on the CPU;
    explicit draws equal to the step's own draws give the same run."""
    pool, lengths = _pool()
    cfg = _tcfg()
    explicit = [tstep.draw_step(cfg, cfg.train.seed, i, lengths, "cpu")
                for i in range(2)]
    runs = []
    for draws in (None, None, explicit):
        s = tstate.create(cfg, device="cpu")
        launches = preproc.LAUNCHES["resize_norm"]
        m = tstep.cached_multi_train_step(s, pool, lengths, 2, draws=draws)
        assert preproc.LAUNCHES["resize_norm"] == launches
        assert s.step == 2
        assert set(m) == {"loss_di", "loss_dv", "loss_gen", "loss_gen_di",
                          "loss_gen_dv"}
        assert all(np.isfinite(float(v)) for v in m.values())
        runs.append({k: float(v) for k, v in m.items()})
    assert runs[0] == runs[1] == runs[2]


def test_batch_plan_is_pure_and_epoch_shuffle_covers_epochs():
    lengths = torch.tensor([12, 3, 20, 16, 9, 30, 16])
    for shuffle in (False, True):
        a = sampling.batch_plan(5, 11, 4, lengths, 8, shuffle)
        b = sampling.batch_plan(5, 11, 4, lengths, 8, shuffle)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        sel, starts = a
        assert (starts < (lengths[sel] - 8 + 1).clamp_min(1)).all()
    # batch 3 over 7 clips: batches straddle epoch boundaries
    seen = torch.cat([sampling.batch_plan(5, k, 3, lengths, 8, True)[0]
                      for k in range(14)])               # 42 = 6 epochs
    for e in range(6):
        assert sorted(seen[7 * e:7 * e + 7].tolist()) == list(range(7))
    assert not torch.equal(seen[:7], seen[7:14])


def test_trainer_cli_cpu(tmp_path):
    from mocogan_tpu_torch.train.__main__ import main

    store = synthetic.write_store(str(tmp_path / "store"), clips=4,
                                  frames=10, size=40)
    out = tmp_path / "run"
    main(["--config", "mug", "--data-dir", store, "--out-dir", str(out),
          "--total-steps", "3", "--device", "cpu", "--set",
          *[f"{k}={v}" for k, v in TINY.items()],
          "train.steps_per_call=2", "train.log_every=2"])
    import json

    recs = [json.loads(line) for line in open(out / "log.jsonl")]
    assert [r["step"] for r in recs] == [2, 4]      # 3 rounds up to k=2
    assert all(np.isfinite(r["loss_gen"]) and r["steps_per_sec"] > 0
               for r in recs)


def test_state_dataclass_overrides_lr():
    s = tstate.create(_tcfg(**{"train.d_learning_rate": 1e-3}), device="cpu")
    assert s.opt["di"].param_groups[0]["lr"] == 1e-3
    assert s.opt["gen"].param_groups[0]["lr"] == LR
