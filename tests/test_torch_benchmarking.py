"""The port's timers (``utils/benchmarking.py``), ``param_count`` and
top-level API against the JAX package's, on the CPU at tiny widths: the
stats contract, that each timer drives its program the stated number of
times, that the scan's pool is JAX's, and that the parameter counts are
JAX's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import mocogan_tpu
import mocogan_tpu_torch
from mocogan_tpu import get_config as jax_get_config
from mocogan_tpu.train import state as jstate
from mocogan_tpu.utils import benchmarking as jbench
from mocogan_tpu_torch import configs, get_config
from mocogan_tpu_torch.models import generator
from mocogan_tpu_torch.ops import preproc
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.train import step as tstep
from mocogan_tpu_torch.utils import benchmarking

TINY = {"model.image_size": 32, "model.video_length": 8,
        "model.gen_features": 8, "model.disc_features": 8,
        "train.batch_size": 8, "train.steps_per_call": 1,
        "data.device_cache": False}
RAW = 40    # the pool's stored size, as tests/test_benchmarking.py sets it


def _tcfg(name="mug", **kw):
    if name == "categorical":
        kw = {"model.n_classes": 4, **kw}
    return get_config(name, **{**TINY, **kw})


@pytest.mark.parametrize("rates", [[3.0, 1.0, 2.0], [1.2345, 6.789],
                                   [7.0], [2.5, 9.125, 0.333, 4.0]])
def test_stats_equal_jax(rates):
    assert benchmarking._stats(rates) == jbench._stats(rates)


def _count(monkeypatch):
    """Count train_step calls and plain-ingest calls from here on."""
    n = {"steps": 0, "ingest": 0}
    step, plain = tstep.train_step, preproc.resize_normalize_gather_plain

    def counted_step(*a, **kw):
        n["steps"] += 1
        return step(*a, **kw)

    def counted_plain(*a, **kw):
        n["ingest"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(tstep, "train_step", counted_step)
    monkeypatch.setattr(preproc, "resize_normalize_gather_plain",
                        counted_plain)
    return n


def _contract(s, windows):
    assert set(s) == {"best", "median", "windows"}
    assert len(s["windows"]) == windows
    assert all(np.isfinite(r) for r in s["windows"])
    assert s["best"] >= s["median"] > 0


def test_time_single_step_contract(monkeypatch):
    n = _count(monkeypatch)
    s = benchmarking.time_single_step(_tcfg(), steps=2, warmup=1, windows=2,
                                      device="cpu")
    _contract(s, 2)
    assert n == {"steps": 1 + 2 * 2, "ingest": 0}


@pytest.mark.parametrize("name", ["mug", "categorical"])
def test_time_cached_scan_contract(name, monkeypatch):
    """k * (1 + reps * windows) steps, one ingest call each."""
    n = _count(monkeypatch)
    s = benchmarking.time_cached_scan(
        _tcfg(name, **{"data.raw_size": RAW}), k=2, reps=1, n_clips=4,
        windows=2, device="cpu")
    _contract(s, 2)
    assert n == {"steps": 2 * (1 + 1 * 2), "ingest": 2 * (1 + 1 * 2)}


def test_time_generate_contract(monkeypatch):
    seeds = []
    gen = generator.generate

    def counted(g, n, *, seed, **kw):
        seeds.append(seed)
        return gen(g, n, seed=seed, **kw)

    monkeypatch.setattr(generator, "generate", counted)
    s = benchmarking.time_generate(_tcfg(), n_clips=2, reps=2, windows=2,
                                   device="cpu")
    _contract(s, 2)
    assert seeds == [0, 1, 2, 3, 4]     # JAX's keys: 0, then w * reps + i + 1


class _Stop(Exception):
    pass


def _jax_pool(cfg, monkeypatch, n_clips):
    """What the JAX timer puts on the device: its pool, lengths and (for
    the conditional model) labels, captured from ``jax.device_put``; the
    timer stops where it would build its state."""
    put = []
    device_put = jax.device_put

    def record(x, *a, **kw):
        put.append(np.asarray(x))
        return device_put(x, *a, **kw)

    def stop(*a, **kw):
        raise _Stop

    monkeypatch.setattr(jax, "device_put", record)
    monkeypatch.setattr(jstate, "create", stop)
    with pytest.raises(_Stop):
        jbench.time_cached_scan(cfg, k=2, reps=1, n_clips=n_clips, windows=1)
    monkeypatch.undo()
    return put


@pytest.mark.parametrize("name", ["mug", "categorical"])
def test_cached_scan_pool_is_jax(name, tiny_cfg, tiny_cat_cfg, monkeypatch):
    jcfg = tiny_cfg if name == "mug" else tiny_cat_cfg
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, raw_size=RAW))
    want = _jax_pool(jcfg, monkeypatch, 5)
    got = {}

    def capture(state, pool, lengths, k, rh, rw, labels=None):
        got.update(pool=pool, lengths=lengths, k=k, rh=rh, rw=rw,
                   labels=labels)
        return {"loss": torch.zeros(())}

    monkeypatch.setattr(tstep, "cached_multi_train_step", capture)
    benchmarking.time_cached_scan(_tcfg(name, **{"data.raw_size": RAW}), k=3,
                                  reps=1, n_clips=5, windows=1, device="cpu")
    assert got["pool"].dtype == torch.uint8
    np.testing.assert_array_equal(got["pool"].numpy(), want[0])
    np.testing.assert_array_equal(got["lengths"].numpy(), want[1])
    if name == "categorical":
        np.testing.assert_array_equal(got["labels"].numpy(), want[2])
    else:
        assert got["labels"] is None and len(want) == 2
    assert got["k"] == 3
    rh, rw = preproc.resize_weights(RAW, RAW, 32, torch.device("cpu"))
    assert torch.equal(got["rh"], rh) and torch.equal(got["rw"], rw)


@pytest.mark.parametrize("name", ["tiny", "tiny_categorical", "mug"])
def test_param_count_equals_jax(name, tiny_cfg, tiny_cat_cfg):
    """Trainable parameters only: the GRU's one fused bias and the BN
    scales and offsets count, the BN running statistics do not."""
    jcfg, tcfg = {"tiny": (tiny_cfg, _tcfg()),
                  "tiny_categorical": (tiny_cat_cfg, _tcfg("categorical")),
                  "mug": (jax_get_config("mug"), get_config("mug"))}[name]
    want = {k: int(v) for k, v in
            jstate.param_count(jstate.create(jcfg)).items()}
    assert tstate.param_count(tstate.create(tcfg, device="cpu")) == want


def test_top_level_api():
    import mocogan_tpu_torch.sample  # noqa: F401  (the CLI keeps its name)

    assert mocogan_tpu_torch.generate is generator.generate
    assert sorted(mocogan_tpu_torch.__all__) == sorted(mocogan_tpu.__all__)
    assert mocogan_tpu_torch.__version__ == mocogan_tpu.__version__
    assert mocogan_tpu_torch.ExperimentConfig is configs.ExperimentConfig
    for name in mocogan_tpu_torch.__all__:
        assert getattr(mocogan_tpu_torch, name) is not None
