"""Training state across packages and across restarts.

  * Bridge: a JAX state after two steps (non-zero Adam moments, count 2),
    saved and restored through the JAX package's CheckpointManager, is
    bridged into the port, which takes step 2 with JAX's draws for that
    step; the result equals JAX's step 2 to the tolerances of
    ``test_torch_step.test_train_step_matches_jax`` (metrics 1e-5 relative,
    params 1e-6 where the step's gradient is clear of noise and 2 * lr
    elsewhere, BN stats 1e-5). The trees cross both ways exactly.
  * Checkpoint: a save/restore round trip is exact; retention; the
    stream-identity warning.
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
from mocogan_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
from mocogan_tpu_torch import bridge, get_config
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.train import step as tstep
from mocogan_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_step import LR, TINY, _jax_draws

torch.set_num_threads(1)


def _tcfg(**kw):
    return get_config("mug", **{**TINY, **kw})


def _np(tree):
    return jax.tree.map(np.array, tree)


def _jax_trees(s):
    """A JAX TrainState as the trees ``bridge.load_state`` takes."""
    return {"step": int(s.step), "params": _np(s.params), "bn": _np(s.bn),
            "opt": {n: {"count": int(o[0].count), "mu": _np(o[0].mu),
                        "nu": _np(o[0].nu)} for n, o in s.opt.items()}}


@pytest.fixture(scope="module")
def jax_run(tiny_cfg, tmp_path_factory):
    """JAX: two steps, a save and restore, then step 2."""
    vids, _ = jsynth.make_batch(0, 8, t=8, size=32)
    real = jnp.asarray(vids)
    fn = jstep.jitted_train_step(tiny_cfg)
    s = jstate_mod.create(tiny_cfg)
    for _ in range(2):
        s, _ = fn(s, real, None)
    mngr = JaxCkpt(str(tmp_path_factory.mktemp("jax_ckpt")))
    mngr.save(s, wait=True)
    restored = mngr.restore(jstate_mod.create(tiny_cfg))
    mngr.close()
    trees = _jax_trees(restored)
    key = jprng.step_key(restored.root_key, restored.step)
    draws = _jax_draws(key, tiny_cfg, 8)
    s3, m3 = fn(restored, real, None)
    return {"trees": trees, "real": vids, "draws": draws,
            "after": _jax_trees(s3), "metrics": _np(m3)}


def test_bridged_adam_state_continues_a_jax_run(jax_run):
    r = jax_run
    assert r["trees"]["step"] == 2
    assert all(o["count"] == 2 for o in r["trees"]["opt"].values())
    assert np.abs(r["trees"]["opt"]["gen"]["mu"]["fc"]["w"]).max() > 0
    s = bridge.load_state(tstate.create(_tcfg(), device="cpu"), r["trees"])
    assert s.step == 2
    metrics = tstep.train_step(s, torch.from_numpy(r["real"]), r["draws"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), r["metrics"][k], rtol=1e-5)
    got, want = bridge.state_trees(s), r["after"]
    assert got["step"] == want["step"] == 3
    for name in s.nets:
        assert got["opt"][name]["count"] == want["opt"][name]["count"] == 3
        before = r["trees"]["params"][name]
        for layer, leaves in want["params"][name].items():
            for p, w in leaves.items():
                # (1 - beta1) times the step's own gradient, from mu
                g = want["opt"][name]["mu"][layer][p] \
                    - 0.5 * r["trees"]["opt"][name]["mu"][layer][p]
                clear = np.abs(g) > 1e-3 * np.abs(g).max()
                diff = np.abs(got["params"][name][layer][p] - w)
                assert diff[clear].max(initial=0) <= 1e-6, \
                    f"{name}.{layer}.{p}"
                assert diff.max() <= 2 * LR, f"{name}.{layer}.{p}"
                assert not np.array_equal(w, before[layer][p])
        for layer, st in want["bn"][name].items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(got["bn"][name][layer][k], st[k],
                                           atol=1e-5)


def test_trees_cross_both_ways_exactly(jax_run):
    trees = jax_run["trees"]
    back = bridge.state_trees(bridge.load_state(
        tstate.create(_tcfg(), device="cpu"), trees))
    assert jax.tree.structure(back) == jax.tree.structure(trees)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(trees)):
        np.testing.assert_array_equal(a, b)


def _stepped_state(steps=2, seed=None):
    s = tstate.create(_tcfg(), seed=seed, device="cpu")
    real = torch.from_numpy(jsynth.make_batch(1, 8, t=8, size=32)[0])
    for _ in range(steps):
        tstep.train_step(s, real)
    return s


def _assert_states_equal(a, b):
    assert (a.step, a.seed) == (b.step, b.seed)
    for n in a.nets:
        for (ka, va), (kb, vb) in zip(a.nets[n].state_dict().items(),
                                      b.nets[n].state_dict().items()):
            assert ka == kb and torch.equal(va, vb), f"{n}.{ka}"
        pa, pb = list(a.nets[n].parameters()), list(b.nets[n].parameters())
        for x, y in zip(pa, pb):
            sa, sb = a.opt[n].state[x], b.opt[n].state[y]
            assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
            for key in sa:
                assert torch.equal(sa[key], sb[key]), f"{n} {key}"


def test_checkpoint_round_trip_is_exact(tmp_path):
    s = _stepped_state(seed=7)
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.save(s) == 2 and mngr.latest_step() == 2
    assert mngr.last_save["bytes"] > 0
    r = mngr.restore(tstate.create(_tcfg(), device="cpu"))
    _assert_states_equal(s, r)
    # training continues identically from the restored state
    real = torch.from_numpy(jsynth.make_batch(2, 8, t=8, size=32)[0])
    m1, m2 = tstep.train_step(s, real), tstep.train_step(r, real)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    _assert_states_equal(s, r)


def test_checkpoint_keeps_the_newest(tmp_path):
    s = tstate.create(_tcfg(), device="cpu")
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        s.step = step
        mngr.save(s)
    assert mngr.all_steps() == [2, 3]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore(s)


def test_flipped_epoch_shuffle_warns(tmp_path, capsys):
    s = tstate.create(_tcfg(), device="cpu")
    CheckpointManager(str(tmp_path), stream_meta={"epoch_shuffle": True}
                      ).save(s)
    CheckpointManager(str(tmp_path), stream_meta={"epoch_shuffle": True}
                      ).restore(s)
    assert "WARNING" not in capsys.readouterr().out
    CheckpointManager(str(tmp_path), stream_meta={"epoch_shuffle": False}
                      ).restore(s)
    out = capsys.readouterr().out
    assert "WARNING" in out and "DIFFERENT clip-window stream" in out
