"""The data-parallel layer's accounting: ``parallel.mesh.TRAFFIC`` and
``python -m mocogan_tpu_torch.scaling_dossier`` on the CPU at
``conftest.py::tiny_cfg``'s geometry.

The dossier runs one step of ``mug`` and of ``scaled`` in a two-rank gloo
world and in a one-rank world. Its counts must follow from the code:
  * each net's gradient bucket, once a step, 4 B x that net's
    ``param_count`` (which equals the JAX package's);
  * BatchNorm's statistics (mean and E[x^2], fp32, 2 x 4 B a channel) once
    per BN pass: G's BNs once (twice under remat, whose backward runs the
    decoder again), each D BN three times (D phase real and fake, G phase
    fake); their gradient once per pass that the two gradients reach
    (G's BNs once, each D BN three times);
  * the metrics once, 4 B each;
  * the replication check apart from the step.
The JAX package's HLO at the same geometry all-reduces D_I's and D_V's
gradients but not G's: its step draws the noise replicated, so every
device runs the whole generator.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocogan_tpu_torch import get_config, scaling_dossier
from mocogan_tpu_torch.ops import layers
from mocogan_tpu_torch.parallel import mesh as pmesh
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.train import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model.image_size": 32, "model.video_length": 8,
        "model.gen_features": 8, "model.disc_features": 8,
        "train.batch_size": 8}
NETS = ("gen", "di", "dv")


@pytest.fixture(scope="module")
def dossier(tmp_path_factory):
    """The CLI's dossier.json, with the weak-scaling sweep run in this
    process over gloo on the CPU while the CLI runs."""
    out = tmp_path_factory.mktemp("dossier")
    p = subprocess.Popen(
        [sys.executable, "-m", "mocogan_tpu_torch.scaling_dossier",
         "--device", "cpu", "--out", str(out), "--set",
         *[f"{k}={v}" for k, v in TINY.items()]], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        weak = scaling_dossier.weak_scaling("cpu", 2, "gloo", TINY, steps=1)
        stdout, stderr = p.communicate(timeout=240)
    finally:
        p.kill()
    assert p.returncode == 0, f"{stdout}\n{stderr[-4000:]}"
    with open(out / "dossier.json") as f:
        d = json.load(f)
    d["_stdout"], d["_weak_cpu"] = stdout, weak
    return d


def _tiny(name):
    return get_config(name, **TINY)


def _bn_channels(net):
    return [m.scale.numel() for m in net.modules()
            if isinstance(m, layers.BatchNorm)]


@pytest.mark.parametrize("name", ["mug", "scaled"])
def test_gradient_buckets_are_4_bytes_a_parameter_by_net(dossier, name):
    """Each net's bucket, once a step, is 4 B x its param_count (the JAX
    package's count: ``test_torch_benchmarking.py`` and
    ``test_jax_hlo_all_reduces_no_generator_gradient``)."""
    tr = dossier[f"traffic_{name}"]
    want = tstate.param_count(tstate.create(_tiny(name), device="cpu"))
    assert tr["param_count_by_net"] == want
    for net in NETS:
        assert tr["by_kind"][f"grad_{net}"] == {"calls": 1,
                                                "bytes": 4 * want[net]}
        assert tr["grad_bucket_bytes"][net] == 4 * want[net]
    assert tr["grad_bucket_bytes_total"] == 4 * tr["param_count"] \
        == 4 * sum(want.values())


@pytest.mark.parametrize("name", ["mug", "scaled"])
def test_calls_and_bytes_a_step_follow_the_code(dossier, name):
    cfg = _tiny(name)
    nets = tstate.create(cfg, device="cpu").nets
    ch = {n: _bn_channels(nets[n]) for n in NETS}
    remat = int(cfg.model.remat)
    assert remat == (name == "scaled")
    g, d = ch["gen"], ch["di"] + ch["dv"]
    want = {
        "bn": {"calls": (1 + remat) * len(g) + 3 * len(d),
               "bytes": 8 * ((1 + remat) * sum(g) + 3 * sum(d))},
        "bn_backward": {"calls": len(g) + 3 * len(d),
                        "bytes": 8 * (sum(g) + 3 * sum(d))},
        "metrics": {"calls": 1, "bytes": 4 * 5},
        **{f"grad_{n}": {"calls": 1,
                         "bytes": 4 * sum(p.numel()
                                          for p in nets[n].parameters())}
           for n in NETS}}
    tr = dossier[f"traffic_{name}"]
    assert tr["by_kind"] == want
    assert tr["calls_per_step"] == sum(v["calls"] for v in want.values()) \
        == 48 + 4 * remat
    assert tr["collective_bytes_total"] \
        == tr["collective_bytes_per_step"]["all-reduce"] \
        == sum(v["bytes"] for v in want.values())
    # the state's checksums (one int64 per tensor) broadcast, then one
    # int64 all-reduced: at create, not in the step
    n_tensors = len(tstate.state_tensors(tstate.create(cfg, device="cpu")))
    assert tr["outside_step"] == {"replication": {
        "calls": 2, "bytes": 8 * n_tensors + 8}}


@pytest.mark.parametrize("name", ["mug", "scaled"])
def test_analytic_ring_bytes(dossier, name):
    tr = dossier[f"traffic_{name}"]
    p = tr["param_count"]
    assert tr["n_devices"] == 2
    assert tr["analytic_ring_allreduce_bytes"] == int(2 * 1 / 2 * 4 * p) \
        == tr["grad_bucket_bytes_total"]
    assert tr["analytic_ring_allreduce_bytes_by_n"] == {
        "2": 4 * p, "8": int(2 * 7 / 8 * 4 * p)}
    assert "jax" not in tr          # no reconciliation at a cut geometry


def test_all_reduce_ms_in_both_worlds_and_weak_scaling(dossier):
    """Both worlds timed (host clock on the CPU), labelled with backend,
    world and device; the one-rank world issues the same collectives
    (``_summary`` raises otherwise); weak scaling is null on the CPU, and
    its sweep itself runs over gloo here."""
    assert dossier["device"] == "cpu" and dossier["clock"] == "host"
    for name in scaling_dossier.CONFIGS:
        ms = dossier[f"traffic_{name}"]["allreduce_ms"]
        assert set(ms) == {"gloo, 2 ranks on cpu", "gloo, 1 rank on cpu"}
        for v in ms.values():
            assert set(v["bucket_ms"]) == set(NETS)
            assert all(x > 0 for x in v["bucket_ms"].values())
            assert set(v["step_collectives_ms"]) == set(
                dossier[f"traffic_{name}"]["by_kind"])
            assert 0 < v["step_collectives_ms_total"] < v["step_ms"]
        assert len(ms["gloo, 2 ranks on cpu"]["bucket_ms_by_rank"]) == 2
    assert dossier["weak_scaling"] is None
    assert "cpu" in dossier["weak_scaling_reason"]
    weak = dossier["_weak_cpu"]
    assert sorted(weak) == ["1", "2"]
    assert [weak[n]["global_batch"] for n in ("1", "2")] == [8, 16]
    assert all(w["step_ms"] > 0 for w in weak.values())
    line = json.loads(dossier["_stdout"].splitlines()[0])
    assert line["mug"]["grad_bucket_bytes_total"] == \
        dossier["traffic_mug"]["grad_bucket_bytes_total"]


def test_no_process_group_counts_nothing():
    pmesh.TRAFFIC.clear()
    cfg = _tiny("mug")
    mesh = pmesh.make_mesh(None, 1, "cpu")
    assert not mesh.collective
    st = tstate.create(cfg, device="cpu", mesh=mesh)
    real = scaling_dossier._clips(cfg, 8, torch.device("cpu"), 0)
    with pmesh.timed_collectives() as ms:
        tstep.train_step(st, real, mesh=mesh)
        pmesh.barrier(mesh)
    assert pmesh.TRAFFIC == {} and ms == {}


def test_timed_collectives_refuse_to_nest():
    with pmesh.timed_collectives():
        with pytest.raises(RuntimeError, match="nest"):
            with pmesh.timed_collectives():
                pass
        assert pmesh._TIMED == []       # the outer block still collects
    assert pmesh._TIMED is None


def test_jax_hlo_all_reduces_no_generator_gradient():
    """The JAX package's sharded step over 2 devices at this geometry,
    parsed as its scaling script parses it: all-reduce bytes within a
    small remainder of D_I's plus D_V's gradients, nothing like G's.
    The port all-reduces G's bucket as well (the dossier's
    ``port_grad_minus_recorded``)."""
    from mocogan_tpu import get_config as jget_config
    from mocogan_tpu.parallel import mesh as jmesh
    from mocogan_tpu.train import state as jstate
    from mocogan_tpu.train.step import train_step

    spec = importlib.util.spec_from_file_location(
        "jax_scaling_dossier", os.path.join(REPO, "scripts",
                                            "scaling_dossier.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    cfg = jget_config("mug", **TINY)
    mesh = jmesh.make_mesh(2)
    s = jstate.create(cfg)
    grad = {n: 4 * sum(int(x.size) for x in jax.tree.leaves(v))
            for n, v in s.params.items()}
    # the port's param_count is the JAX package's, net by net
    assert {n: g // 4 for n, g in grad.items()} == tstate.param_count(
        tstate.create(_tiny("mug"), device="cpu"))
    m = cfg.model
    real = jax.ShapeDtypeStruct(
        (8, m.video_length, m.image_size, m.image_size, m.channels),
        jnp.float32, sharding=jmesh.batch_sharding(mesh))
    rep = jmesh.replicated(mesh)
    hlo = jax.jit(lambda st, r: train_step(st, r, None, cfg),
                  in_shardings=(rep, jmesh.batch_sharding(mesh)),
                  out_shardings=(rep, rep)).lower(
        jmesh.shard_state(mesh, s), real).compile().as_text()
    got = script.collective_bytes(hlo)["all-reduce"]
    rest = got - grad["di"] - grad["dv"]
    assert abs(rest) < 0.01 * grad["gen"], (got, grad)
    port = sum(grad.values())
    np.testing.assert_allclose(port - got, grad["gen"], rtol=0.01)
