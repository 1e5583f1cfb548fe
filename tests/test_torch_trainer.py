"""The port's trainer, its two ingest paths, resume, and the CLIs, on the
CPU at the tiny geometry.

  * Exact resume: 4 steps straight and 2 steps + checkpoint + a fresh
    Trainer + 2 steps give bit-equal params, BN buffers and Adam moments,
    on the device-cached and the host-fed path.
  * The paths agree: host-fed and device-cached runs of one store and seed
    read the same windows and draw the same noise, so their metrics and
    params are equal.
  * Cadence of logs, samples, checkpoints and hooks; the resume no-op
    guard; what raises before the first step.
  * Noise is drawn from CPU generators whatever the target device.
"""

import json
import os

import numpy as np
import pytest
import torch

from mocogan_tpu_torch import get_config
from mocogan_tpu_torch.data import clips, synthetic
from mocogan_tpu_torch.ops import preproc
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.train import step as tstep
from mocogan_tpu_torch.train.loop import Trainer, make_data_iterator
from mocogan_tpu_torch.utils import prng
from test_torch_step import TINY

torch.set_num_threads(1)

SMALL = {**TINY, "train.steps_per_call": 2, "train.log_every": 2,
         "data.epoch_shuffle": True}
SET = [f"{k}={v}" for k, v in TINY.items()]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return synthetic.write_store(str(tmp_path_factory.mktemp("store")),
                                 clips=6, frames=10, size=40)


def _cfg(store, **kw):
    return get_config("mug", **{**SMALL, "data.data_dir": store, **kw})


def _train(cfg, out, total, mode):
    t = Trainer(cfg, out_dir=out, device="cpu")
    if mode == "host-fed":
        t.run(clips.clip_batch_iterator(cfg, use_native=True,
                                        start_batch=t.state.step), total)
    else:
        t.run_device_cached(total)
    return t


@pytest.fixture(scope="module")
def runs(store, tmp_path_factory):
    """{(mode, "straight" | "resumed"): trainer after step 4}; the kernel
    launch counter over all of them."""
    cfg = _cfg(store)
    launches = preproc.LAUNCHES["resize_norm"]
    out = {}
    for mode in ("device-cached", "host-fed"):
        d = tmp_path_factory.mktemp(mode)
        out[mode, "straight"] = _train(cfg, str(d / "a"), 4, mode)
        first = _train(cfg, str(d / "b"), 2, mode)
        assert first.state.step == 2 and first.ckpt.latest_step() == 2
        out[mode, "resumed"] = _train(cfg, str(d / "b"), 4, mode)
    out["launches"] = preproc.LAUNCHES["resize_norm"] - launches
    return out


def _state_tensors(state):
    out = {}
    for n, net in state.nets.items():
        out.update({f"{n}.{k}": v for k, v in net.state_dict().items()})
        for pn, p in net.named_parameters():
            for k, v in state.opt[n].state[p].items():
                out[f"{n}.{pn}.{k}"] = v
    return out


@pytest.mark.parametrize("mode", ["device-cached", "host-fed"])
def test_resume_is_bit_exact(runs, mode):
    a, b = runs[mode, "straight"].state, runs[mode, "resumed"].state
    assert a.step == b.step == 4
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb) and len(ta) > 50
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    la = runs[mode, "straight"].logger.history
    lb = runs[mode, "resumed"].logger.history     # reloaded + new records
    assert [r["step"] for r in la] == [r["step"] for r in lb] == [2, 4]
    assert [r["loss_gen"] for r in la] == [r["loss_gen"] for r in lb]


def test_host_fed_and_device_cached_agree(runs):
    a, b = runs["device-cached", "straight"], runs["host-fed", "straight"]
    keys = ("loss_di", "loss_dv", "loss_gen", "loss_gen_di", "loss_gen_dv")
    for ra, rb in zip(a.logger.history, b.logger.history):
        assert {k: ra[k] for k in keys} == {k: rb[k] for k in keys}
    ta, tb = _state_tensors(a.state), _state_tensors(b.state)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_no_kernel_launch_on_the_cpu(runs):
    assert runs["launches"] == 0


def test_cadence_rounding_and_the_no_op_guard(tmp_path, capsys):
    cfg = get_config("mug", **{
        **TINY, "data.dataset": "synthetic", "train.steps_per_call": 2,
        "train.log_every": 2, "train.sample_every": 4,
        "train.checkpoint_every": 4, "train.keep_checkpoints": 5})
    t = Trainer(cfg, out_dir=str(tmp_path), device="cpu")
    hooked = []
    t.add_hook(2, lambda tr, step: hooked.append((tr.state.step, step)))
    t.run(make_data_iterator(cfg), total_steps=5)     # rounds up to 6
    assert "rounding total up to 6" in capsys.readouterr().out
    assert t.state.step == 6 and hooked == [(2, 2), (4, 4), (6, 6)]
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "step_00000004.gif", "step_00000006.gif"]
    assert t.ckpt.all_steps() == [4, 6]
    assert os.path.exists(tmp_path / "loss_curves.png")
    recs = [json.loads(x) for x in open(tmp_path / "log.jsonl")]
    assert [r["step"] for r in recs] == [2, 4, 6]
    for r in recs:
        assert r["steps_per_sec"] == round(r["steps_per_sec"], 3)
        assert r["clips_per_sec"] == round(r["clips_per_sec"], 2)
    again = Trainer(cfg, out_dir=str(tmp_path), device="cpu")
    assert again.state.step == 6
    assert again.run(make_data_iterator(cfg, 6), total_steps=6) == {}
    assert "nothing to do" in capsys.readouterr().out


@pytest.mark.parametrize("kw, err", [
    ({"train.eval_every": 4}, None),
    ({"train.eval_every": 4, "train.eval_clips": 0}, ValueError)])
def test_what_raises_before_the_first_step(tmp_path, kw, err):
    """eval_clips < 1 raises before any step; eval_every alone now trains
    and logs a panel (it raised NotImplementedError before eval was
    ported)."""
    cfg = get_config("mug", **{**TINY, "data.dataset": "synthetic", **kw})
    t = Trainer(cfg, out_dir=str(tmp_path), device="cpu")
    if err is None:
        t.run(make_data_iterator(cfg), total_steps=4)
        panel = [r for r in t.logger.history if "fvd_proxy" in r]
        assert t.state.step == 4 and [r["step"] for r in panel] == [4]
        assert {"eval_fingerprint", "eval_seconds", "dv_margin"} \
            <= set(panel[0])
        return
    with pytest.raises(err):
        t.run(make_data_iterator(cfg), total_steps=2)
    with pytest.raises(err):
        t.run_device_cached(total_steps=2)
    assert t.state.step == 0


@pytest.mark.parametrize("kw, jax_args", [
    ({"train.num_devices": 2}, {"num_devices": 2}),
    ({"train.n_slices": 2}, {"n_slices": 2})])
def test_more_than_one_device_raises(tmp_path, kw, jax_args):
    """In a one-process world, two devices or two slices raise the
    ValueError that the JAX package's make_mesh raises on one device."""
    import jax

    from mocogan_tpu.parallel import mesh as jmesh

    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(devices=jax.devices()[:1], **jax_args)
    cfg = get_config("mug", **{**TINY, **kw})
    with pytest.raises(ValueError) as got:
        Trainer(cfg, out_dir=str(tmp_path), device="cpu")
    assert str(got.value) == str(want.value)


def test_raw_stack_is_the_pool_of_each_step():
    """multi_train_step on a uint8 stack with window indices equals the
    same steps on the float batches the plain ingest makes of them."""
    cfg = get_config("mug", **TINY)
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 8, 11, 40, 40, 3),
                                        dtype=np.uint8))
    idx = torch.from_numpy(rng.integers(0, 11, (2, 8, 8), dtype=np.int32))
    f32 = torch.stack([preproc.subsample_and_preprocess(raw[j], idx[j], 32)
                       for j in range(2)])
    runs = []
    for args in ((raw, idx), (f32,)):
        s = tstate.create(cfg, device="cpu")
        m = tstep.multi_train_step(s, *args)
        runs.append(({k: float(v) for k, v in m.items()},
                     [p.clone() for p in s.nets["gen"].parameters()]))
        assert s.step == 2
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    with pytest.raises(ValueError, match="frame_idx"):
        tstep.multi_train_step(tstate.create(cfg, device="cpu"), raw)


def test_debug_nans_raises_before_the_update():
    s = tstate.create(get_config("mug", **TINY), device="cpu")
    s.debug_nans = True
    before = [p.clone() for p in s.nets["gen"].parameters()]
    real = torch.full((8, 8, 32, 32, 3), float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite"):
        tstep.train_step(s, real)
    assert s.step == 0
    assert all(torch.equal(a, p)
               for a, p in zip(before, s.nets["gen"].parameters()))


def test_noise_is_drawn_on_the_host(monkeypatch):
    """Every generator is a CPU generator, whatever device the draw is
    for; the draws then land on the target device."""
    made = []
    real = prng.generator

    def spy(*a, **kw):
        g = real(*a, **kw)
        assert g.device.type == "cpu"
        made.append(a[2])
        return g

    monkeypatch.setattr(prng, "generator", spy)
    cfg = get_config("mug", **TINY)
    on_meta = tstep.draw_noise(cfg, 0, 5, 4, "meta")
    on_cpu = tstep.draw_noise(cfg, 0, 5, 4, "cpu")
    assert sorted(set(made)) == ["content", "frame_sample", "motion_init",
                                 "motion_noise"]
    for k, v in on_cpu.items():
        assert on_meta[k].device.type == "meta"
        assert on_meta[k].shape == v.shape and on_meta[k].dtype == v.dtype
    again = tstep.draw_noise(cfg, 0, 5, 4, "cpu")
    assert all(torch.equal(on_cpu[k], again[k]) for k in on_cpu)


# ---- the CLIs -----------------------------------------------------------------

def test_train_cli_routes_the_two_paths(store, tmp_path, monkeypatch):
    from mocogan_tpu_torch.train.__main__ import main

    called = []
    monkeypatch.setattr(Trainer, "run",
                        lambda self, it, total=None: called.append("host"))
    monkeypatch.setattr(Trainer, "run_device_cached",
                        lambda self, total=None: called.append("cached"))
    main(["--config", "toy", "--out-dir", str(tmp_path / "a"), "--device",
          "cpu", "--set", *SET, "data.device_cache=true"])
    main(["--config", "mug", "--data-dir", store, "--out-dir",
          str(tmp_path / "b"), "--device", "cpu", "--set", *SET,
          "data.device_cache=true"])
    main(["--config", "mug", "--data-dir", store, "--out-dir",
          str(tmp_path / "c"), "--device", "cpu", "--set", *SET])
    assert called == ["host", "cached", "host"]
    with pytest.raises(SystemExit):          # a store needs --data-dir
        main(["--config", "mug", "--device", "cpu"])


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """A host-fed toy run of 2 steps through the CLI."""
    from mocogan_tpu_torch.train.__main__ import main

    out = str(tmp_path_factory.mktemp("toy"))
    main(["--config", "toy", "--out-dir", out, "--total-steps", "2",
          "--device", "cpu", "--set", *SET])
    return out


def test_train_cli_resumes_unless_told_not_to(toy_run, capsys):
    from mocogan_tpu_torch.train.__main__ import main

    args = ["--config", "toy", "--out-dir", toy_run, "--total-steps", "2",
            "--device", "cpu", "--set", *SET]
    main(args)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "nothing to do" in out
    main(args + ["--no-resume"])
    out = capsys.readouterr().out
    assert "resumed from step" not in out and "[step 2/2]" in out


def test_generate_cli(toy_run, tmp_path, monkeypatch):
    from mocogan_tpu_torch.sample import main

    args = ["--config", "toy", "--run-dir", toy_run, "--device", "cpu",
            "--n", "3", "--seed", "3", "--set", *SET]
    a, vids = main(args + ["--out", str(tmp_path / "a.gif")])
    b, _ = main(args + ["--out", str(tmp_path / "b.gif")])
    assert a.endswith("a.gif")
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tuple(vids.shape) == (3, 8, 32, 32, 3)
    assert vids.abs().max() <= 1.0
    c, _ = main(args + ["--out", str(tmp_path / "c.gif"), "--seed", "4"])
    assert open(a, "rb").read() != open(c, "rb").read()
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    npy, vids2 = main(args + ["--out", str(tmp_path / "d.gif"),
                              "--video-length", "5"])
    assert npy.endswith("d.npy") and np.load(npy).shape == (5, 64, 64, 3)
    with pytest.raises(ValueError, match="unconditional"):
        main(args + ["--labels", "1", "1", "1"])
    # the categorical CLI writes a grid of the clips of the given classes
    from mocogan_tpu_torch.utils.checkpoint import CheckpointManager

    cat = ["--config", "categorical", "--device", "cpu", "--n", "2",
           "--seed", "3", "--set", *SET]
    run = str(tmp_path / "cat")
    mngr = CheckpointManager(os.path.join(run, "checkpoints"))
    s = tstate.create(get_config("categorical", **TINY), device="cpu")
    mngr.save(s, wait=True)
    mngr.close()
    grid, vids = main(cat + ["--run-dir", run, "--labels", "0", "5"])
    assert grid.endswith(".npy") and np.load(grid).shape == (8, 32, 64, 3)
    assert tuple(vids.shape) == (2, 8, 32, 32, 3)
    _, other = main(cat + ["--run-dir", run, "--labels", "5", "0"])
    assert not torch.equal(vids, other)
    with pytest.raises(ValueError, match="labels"):
        main(cat + ["--run-dir", run, "--labels", "6", "0"])
