"""The port's data parallelism (``mocogan_tpu_torch/parallel``) on the CPU.

  (a) ``make_mesh``/``local_batch_slice`` against the JAX package's on the
      8 virtual CPU devices, over a grid of (num_devices, n_slices, world,
      processes per node): the same rows for every rank, and a ValueError
      with JAX's message where JAX raises.
  (b) A 2-rank gloo world (two processes of ``test_torch_parallel_child.py``)
      at a global batch of 4, 2 per rank, against the port's one-process
      step on the global batch: both update orders, the categorical model,
      remat, the device-cached path (the rank's plan rows into the plain
      ingest) and the host-fed path (``HostFeed`` slicing a uint8 stack).
  (c) The same world on the bridged JAX state and JAX's draws against the
      JAX package's 2-device sharded step.
  (e) The train CLI spawning two gloo ranks: rank 0 alone writes, the
      logged losses are the one-process run's, and a resumed 2-rank run is
      bit-exact against an uninterrupted one.

Tolerances, fp32: metrics rtol 2e-4 / atol 2e-5 (reductions split over the
ranks are summed in another order; JAX's own sharded test uses the same);
gradients 1e-3 of each leaf's largest magnitude (cancellation-heavy BN
gradients keep ~1e-5 absolute residue, as in ``tests/test_parallel.py``);
BN running stats 1e-5 absolute. Parameters must be bit-equal across the
ranks: every rank applies the same all-reduced gradient.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mocogan_tpu.parallel import mesh as jmesh
from mocogan_tpu_torch import bridge
from mocogan_tpu_torch.data import synthetic
from mocogan_tpu_torch.parallel import mesh as pmesh
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.utils.checkpoint import digests
from test_torch_parallel_child import SCENARIOS, TINY, config, run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "test_torch_parallel_child.py")
B = TINY["train.batch_size"]
METRIC_TOL = dict(rtol=2e-4, atol=2e-5)


# ---- (a) the mesh against JAX's ------------------------------------------

class _Dev:
    """A stub JAX device: id and the node it sits on as slice_index."""

    def __init__(self, i, node=None):
        self.id, self.slice_index = i, node


def _jax_mesh(num_devices, n_slices, world, per_node):
    devs = [_Dev(i, None if not per_node else i // per_node)
            for i in range(world)]
    try:
        jmesh.make_mesh(num_devices, devices=devs, n_slices=n_slices)
    except ValueError as e:
        return str(e)
    return None


GRID = [(nd, ns, w, pn)
        for w in (1, 2, 4, 8) for nd in (None, 1, 2, 4, 8)
        for ns in (1, 2, 4) for pn in (0, 2, 4)
        if not (pn and pn > w)]


@pytest.mark.parametrize("num_devices, n_slices, world, per_node", GRID,
                         ids=lambda v: str(v))
def test_mesh_raises_where_jax_raises(monkeypatch, num_devices, n_slices,
                                      world, per_node):
    """A world of `world` processes, `per_node` on each node (0: not
    said). JAX on `world` devices, their slice_index the node (None when
    not said) raises the same ValueError. Asking for fewer devices than the
    world is the one case that differs: JAX takes a subset of its devices
    (and checks the slices on it), the port raises, since each of its
    processes is one device."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: world)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: world - 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(per_node) if per_node else "")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    want = _jax_mesh(num_devices, n_slices, world, per_node)
    try:
        m = pmesh.make_mesh(num_devices, n_slices, "cpu")
        got = None
    except ValueError as e:
        got = str(e)
    if num_devices is not None and num_devices < world:
        assert got.startswith(f"requested {num_devices} devices, but the "
                              f"world has {world}")
        return
    assert got == want
    if got is None:
        assert (m.world_size, m.rank, m.n_slices) == (world, world - 1,
                                                      n_slices)


@pytest.mark.parametrize("world, n_slices", [(2, 1), (4, 1), (8, 2)])
def test_local_batch_slice_is_jaxs_shard(monkeypatch, world, n_slices):
    """Rank r's rows are JAX's: those of process r in ``local_batch_slice``
    and those of the r-th device of the flat (slice-major) mesh; (K, B)
    stacks slice on axis 1; B % world raises JAX's error."""
    a = np.arange(16 * 3).reshape(16, 3)
    stack = np.arange(2 * 16).reshape(2, 16)
    jm = jmesh.make_mesh(world, n_slices=n_slices)
    shards = [s.data for s in sorted(
        jmesh.shard_batch(jm, a).addressable_shards,
        key=lambda s: list(jm.devices.flat).index(s.device))]
    for r in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: r)
        mesh = pmesh.Mesh(world, r, r, n_slices, torch.device("cpu"), True)
        got = pmesh.local_batch_slice(mesh, torch.from_numpy(a))
        np.testing.assert_array_equal(got.numpy(),
                                      jmesh.local_batch_slice(jm, a))
        np.testing.assert_array_equal(got.numpy(), np.asarray(shards[r]))
        got_s, none = pmesh.local_batch_slice(mesh, stack, None, axis=1)
        assert none is None
        np.testing.assert_array_equal(
            got_s, jmesh.local_batch_slice(jm, stack, None, axis=1)[0])
        with pytest.raises(ValueError) as want:
            jmesh.local_batch_slice(jm, np.arange(15))
        with pytest.raises(ValueError, match=str(want.value)):
            pmesh.local_batch_slice(mesh, np.arange(15))
    one = pmesh.Mesh(1, 0, 0, 1, torch.device("cpu"), False)
    assert pmesh.local_batch_slice(one, a) is a


def test_local_batch_size_and_no_collective_without_a_group():
    cfg = config("simultaneous")
    assert pmesh.local_batch_size(cfg, pmesh.Mesh(
        2, 1, 1, 1, torch.device("cpu"), True)) == B // 2
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        pmesh.local_batch_size(cfg, pmesh.Mesh(3, 0, 0, 1,
                                               torch.device("cpu"), True))
    mesh = pmesh.make_mesh(None, 1, "cpu")
    assert (mesh.world_size, mesh.rank, mesh.collective) == (1, 0, False)
    x = torch.ones(3, requires_grad=True)
    assert pmesh.all_reduce_mean(x, mesh, "bn") is x
    assert pmesh.all_reduce_grads([x], None, "grad_gen")[0] is x
    pmesh.barrier(mesh)            # no group: nothing to wait for
    with pytest.raises(RuntimeError, match="no CUDA device cuda:0"):
        pmesh.rank_device(torch.device("cuda"), torch.cuda.device_count())


# ---- (b), (c): a 2-rank world against one process and against JAX --------

def _inputs():
    rng = np.random.default_rng(0)
    m = config("simultaneous").model
    t, s = m.video_length, m.image_size
    pool = np.stack([synthetic.render_clip(0, i, 12, 48)[0]
                     for i in range(6)])
    return {
        "real": torch.from_numpy(np.asarray(
            synthetic.make_batch(0, B, t=t, size=s)[0], np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 4, B)),
        "pool": torch.from_numpy(pool),
        "lengths": torch.tensor([12, 12, 5, 12, 9, 12]),
        "batches": [{"raw": rng.integers(0, 256, (B, 10, 40, 40, 3),
                                         dtype=np.uint8),
                     "frame_idx": rng.integers(0, 10, (B, t),
                                               dtype=np.int32)}
                    for _ in range(2)],
    }


def _jax_inputs(inputs):
    """The JAX package's state and step-0 key on the tiny config; its
    state bridged into the port's nets and its draws, for the ranks."""
    from mocogan_tpu import get_config as jget_config
    from mocogan_tpu.train import state as jstate
    from mocogan_tpu.utils import prng as jprng
    from test_torch_step import _jax_draws

    jcfg = jget_config("mug", **TINY)
    s = jstate.create(jcfg)
    key = jprng.step_key(s.root_key, s.step)
    port = tstate.create(config("jax"), device="cpu")
    params, bn = _tree(s.params), _tree(s.bn)
    for name, net in port.nets.items():
        bridge.load_net(net, params[name], bn[name])
    inputs["jax_state"] = {n: net.state_dict()
                           for n, net in port.nets.items()}
    inputs["jax_draws"] = _jax_draws(key, jcfg, B)
    return jcfg, s, key


def _tree(t):
    return jax.tree.map(np.array, t)


def _jax_reference(jcfg, s, key, vids):
    """The JAX package's sharded step on a 2-device mesh on the global
    batch: metrics, new BN stats, and the gradients (the psummed jax.grad
    of the same loss)."""
    from mocogan_tpu.train import step as jstep

    mesh = jmesh.make_mesh(2)
    real = jmesh.shard_batch(mesh, vids)
    sh = jmesh.shard_state(mesh, s)
    grads = jax.jit(lambda p, b, r, k: jax.grad(
        jstep._loss_fn, has_aux=True)(p, b, r, None, k, jcfg)[0])(
        sh.params, sh.bn, real, key)
    # the step donates its state (s's arrays too): it comes last
    s2, metrics = jmesh.make_sharded_train_step(jcfg, mesh)(sh, real, None)
    return {"metrics": _tree(metrics), "grads": _tree(grads),
            "bn": _tree(s2.bn)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results, the one-process references, and JAX's; the
    JAX compiles and the references run while the ranks do."""
    tmp = tmp_path_factory.mktemp("world")
    inputs = _inputs()
    jax_args = _jax_inputs(inputs)
    inputs["scenarios"] = list(SCENARIOS)
    torch.save(inputs, tmp / "in.pt")
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(r), "2", str(tmp / "store"),
         str(tmp / "in.pt"), str(tmp / f"out{r}.pt")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        jax_ref = _jax_reference(*jax_args, inputs["real"].numpy())
        ref = {name: run(name, inputs) for name in SCENARIOS}
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err[-4000:]}"
    finally:
        for p in procs:
            p.kill()
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(2)]
    return {"ranks": ranks, "ref": ref, "jax": jax_ref}


def _assert_grads_close(got, want, what):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(np.asarray(got[k]) / scale, w / scale,
                                   rtol=0, atol=1e-3, err_msg=f"{what}.{k}")


def _bn(flat):
    return {k: v for k, v in flat.items()
            if k.endswith((".mean", ".var"))}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_two_ranks_match_one_process(world, name):
    """Every rank's metrics (global means), step-0 gradients and BN stats
    after the first call equal the one-process step's on the global
    batch; the later steps' metrics too."""
    ref = world["ref"][name]
    for res in (r[name] for r in world["ranks"]):
        assert len(res["metrics"]) == len(ref["metrics"])
        for got, want in zip(res["metrics"], ref["metrics"]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], **METRIC_TOL,
                                           err_msg=f"{name} {k}")
        assert set(res["grads"]) == set(ref["grads"]) == {"gen", "di", "dv"}
        for net, g in ref["grads"].items():
            _assert_grads_close(res["grads"][net],
                                {k: v.numpy() for k, v in g.items()},
                                f"{name} {net}")
        for k, v in _bn(ref["first"]).items():
            np.testing.assert_allclose(res["first"][k], v, rtol=0,
                                       atol=1e-5, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_params_stay_bit_equal_across_ranks(world, name):
    a, b = (r[name]["last"] for r in world["ranks"])
    assert set(a) == set(b) and len(a) > 20
    for k in a:
        assert torch.equal(a[k], b[k]), f"{name} {k}"


def test_replication_check_raises_on_every_rank(world):
    assert [r["mismatch_raised"] for r in world["ranks"]] == [True, True]


@pytest.mark.parametrize("part", ["metrics", "grads", "bn"])
def test_two_ranks_match_jaxs_sharded_step(world, part):
    """The 2-rank step from the bridged JAX state with JAX's draws against
    ``make_sharded_train_step`` on a 2-device mesh (and the psummed
    gradients of its loss)."""
    want = world["jax"]
    port = tstate.create(config("jax"), device="cpu")
    for res in (r["jax"] for r in world["ranks"]):
        if part == "metrics":
            assert set(res["metrics"][0]) == set(want["metrics"])
            for k, v in want["metrics"].items():
                np.testing.assert_allclose(res["metrics"][0][k], v,
                                           **METRIC_TOL, err_msg=k)
        for name, net in port.nets.items():
            if part == "grads":
                got = bridge.params_tree(net, res["grads"][name])
                for layer, leaves in want["grads"][name].items():
                    _assert_grads_close(got[layer], leaves,
                                        f"{name}.{layer}")
            elif part == "bn":
                net.load_state_dict({k[len(name) + 1:]: v
                                     for k, v in res["first"].items()
                                     if k.startswith(name + ".")})
                got = bridge.bn_tree(net)
                for layer, st in want["bn"][name].items():
                    for k in ("mean", "var"):
                        np.testing.assert_allclose(
                            got[layer][k], st[k], rtol=0, atol=1e-5,
                            err_msg=f"{name}.{layer}.{k}")


# ---- (e) the train CLI over two spawned ranks ------------------------------

CLI_SET = [f"{k}={v}" for k, v in TINY.items()] + [
    "train.steps_per_call=2", "train.log_every=2",
    "train.checkpoint_every=2", "train.sample_every=4",
    "train.keep_checkpoints=5", "data.epoch_shuffle=true",
    "train.eval_every=4", "train.eval_clips=8"]


def _cli(store, out, total, world, env=None):
    """Start training `total` steps host-fed with the train CLI in its own
    process; `world` > 1 spawns that many gloo ranks; `env` is added to
    the process's environment."""
    args = [sys.executable, "-m", "mocogan_tpu_torch.train", "--config",
            "mug", "--data-dir", store, "--out-dir", str(out),
            "--total-steps", str(total), "--device", "cpu",
            "--num-devices", str(world), "--set", *CLI_SET]
    return subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1",
                                 **(env or {})})


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait(procs):
    """The stdout of each run; all of them must succeed."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"{out}\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """2 ranks straight to step 4, twice; 2 ranks to 2, then resumed to 4;
    one process to 4; a one-rank world in torchrun's environment to 4.
    The runs that do not wait on each other run together."""
    tmp = tmp_path_factory.mktemp("cli")
    store = synthetic.write_store(str(tmp / "store"), clips=6, frames=10,
                                  size=40)
    dirs = {k: tmp / k for k in ("two", "two_b", "resumed", "one",
                                 "torchrun")}
    torchrun = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(_free_port())}
    straight, _, _, _, _ = _wait([_cli(store, dirs["two"], 4, 2),
                                  _cli(store, dirs["two_b"], 4, 2),
                                  _cli(store, dirs["resumed"], 2, 2),
                                  _cli(store, dirs["one"], 4, 1),
                                  _cli(store, dirs["torchrun"], 4, 1,
                                       torchrun)])
    resumed, = _wait([_cli(store, dirs["resumed"], 4, 2)])
    return {"straight": straight, "resumed": resumed, "dirs": dirs}


def _log(d):
    return [json.loads(x) for x in open(d / "log.jsonl")]


def _losses(d):
    return [r for r in _log(d) if "loss_gen" in r]


def test_cli_two_ranks_log_the_one_process_losses(cli_runs):
    two, one = (_losses(cli_runs["dirs"][k]) for k in ("two", "one"))
    assert [r["step"] for r in two] == [r["step"] for r in one] == [2, 4]
    for a, b in zip(two, one):
        for k in ("loss_di", "loss_dv", "loss_gen", "loss_gen_di",
                  "loss_gen_dv"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, err_msg=k)
    assert "2 device(s)" in cli_runs["straight"]


def test_cli_two_ranks_panel_sees_the_one_process_pool(cli_runs):
    """Rank 0's panel runs on the global batches' clips, as one process
    does: the real clips' ACD (a function of the pool alone) is the one
    process's, and every panel value is finite."""
    two, one = ([r for r in _log(cli_runs["dirs"][k]) if "acd_real" in r]
                for k in ("two", "one"))
    assert [r["step"] for r in two] == [r["step"] for r in one] == [4]
    np.testing.assert_allclose(two[0]["acd_real"], one[0]["acd_real"],
                               rtol=1e-6)
    assert two[0]["eval_fingerprint"] == one[0]["eval_fingerprint"]
    assert all(np.isfinite(v) for v in two[0].values()
               if isinstance(v, float))


def test_cli_one_rank_world_is_the_plain_run(cli_runs):
    """Under torchrun's environment the CLI joins a one-rank world and
    issues its collectives (identities on one rank): the same losses as
    the run without a process group, bit for bit."""
    a, b = (_losses(cli_runs["dirs"][k]) for k in ("torchrun", "one"))
    assert [r["step"] for r in a] == [2, 4]
    for ra, rb in zip(a, b):
        assert {k: v for k, v in ra.items() if k.startswith("loss")} == \
            {k: v for k, v in rb.items() if k.startswith("loss")}


def test_cli_only_rank0_writes(cli_runs):
    d = cli_runs["dirs"]["two"]
    assert len(_losses(d)) == 2                   # one record per window
    assert len(_log(d)) == 3                      # and one panel
    assert sorted(os.listdir(d / "samples")) == ["step_00000004.gif"]
    assert sorted(os.listdir(d / "checkpoints")) == [
        "2", "4", "stream_version.json"]
    assert cli_runs["straight"].count("[step 4/4]") == 1
    assert cli_runs["straight"].count("[checkpoint] step 4") == 1


def test_cli_two_rank_resume_is_bit_exact(cli_runs):
    assert "resumed from step 2" in cli_runs["resumed"]
    a, b = (torch.load(cli_runs["dirs"][k] / "checkpoints" / "4" /
                       "state.pt", weights_only=True)
            for k in ("two", "resumed"))
    assert a["step"] == b["step"] == 4
    flat = {}
    for tag, blob in (("a", a), ("b", b)):
        flat[tag] = {f"{n}.{k}": v for n, sd in blob["nets"].items()
                     for k, v in sd.items()}
        flat[tag].update({f"{n}.opt.{i}.{k}": v
                          for n, o in blob["opt"].items()
                          for i, st in o["state"].items()
                          for k, v in st.items()})
    assert set(flat["a"]) == set(flat["b"]) and len(flat["a"]) > 50
    for k in flat["a"]:
        assert torch.equal(flat["a"][k], flat["b"][k]), k
    assert [r["loss_gen"] for r in _losses(cli_runs["dirs"]["two"])] == \
        [r["loss_gen"] for r in _losses(cli_runs["dirs"]["resumed"])]


def test_cli_two_rank_runs_repeat_bit_for_bit(cli_runs):
    """Two straight 2-rank runs from one seed: the sha256 of every entry of
    their step-4 checkpoints equal (``chip_smoke.py`` phase 13 holds the
    same on the card)."""
    a, b = (digests(str(cli_runs["dirs"][k] / "checkpoints" / "4" /
                        "state.pt")) for k in ("two", "two_b"))
    assert len(a) > 50 and a == b
    la, lb = ([{k: v for k, v in r.items() if k.startswith("loss")}
               for r in _losses(cli_runs["dirs"][k])]
              for k in ("two", "two_b"))
    assert len(la) == 2 and la == lb
