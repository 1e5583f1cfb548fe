"""The port's eval CLIs on the CPU: ``eval_fvd`` against a clip store and
against a second run, ``eval.parity`` (determinism and the record/compare
cycle), and ``eval.compare_runs`` against the JAX package's on the same
two port logs."""

import json

import numpy as np
import pytest
import torch

from mocogan_tpu.eval import compare_runs as jcompare
from mocogan_tpu_torch import get_config
from mocogan_tpu_torch.data import synthetic
from mocogan_tpu_torch.eval import compare_runs as tcompare
from mocogan_tpu_torch.eval import parity
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.utils.checkpoint import CheckpointManager
from mocogan_tpu_torch.utils.metrics import MetricLogger
from test_torch_step import TINY

torch.set_num_threads(1)

SET = [f"{k}={v}" for k, v in TINY.items()]


def _run_dir(root, cfg, seed):
    """A run dir holding one checkpoint of a fresh state (step 0)."""
    s = tstate.create(cfg, seed=seed, device="cpu")
    CheckpointManager(str(root / "checkpoints")).save(s)
    return str(root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = get_config("mug", **TINY)
    root = tmp_path_factory.mktemp("runs")
    store = synthetic.write_store(str(root / "store"), clips=4, frames=10,
                                  size=40)
    return (_run_dir(root / "a", cfg, 0), _run_dir(root / "b", cfg, 1),
            store)


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("against", ["store", "run"])
def test_eval_fvd_cli(runs, capsys, against):
    from mocogan_tpu_torch.eval_fvd import main

    a, b, store = runs
    other = (["--data-dir", store] if against == "store"
             else ["--run-dir-b", b])
    rec = main(["--config", "mug", "--run-dir", a, *other, "--n", "6",
                "--device", "cpu", "--set", *SET])
    assert _last_json(capsys.readouterr().out) == rec
    assert set(rec) == {"fvd_proxy", "n", "comparison", "extractor"}
    assert rec["n"] == 6 and rec["extractor"] == "random_projection_seed0"
    assert rec["comparison"] == ("run@0 vs real data" if against == "store"
                                 else "run@0 vs run_b@0")
    # two untrained generators give near-identical (near-constant) clips
    assert np.isfinite(rec["fvd_proxy"])
    assert rec["fvd_proxy"] > (0 if against == "store" else -1e-3)
    assert rec == main(["--config", "mug", "--run-dir", a, *other, "--n", "6",
                        "--device", "cpu", "--set", *SET])
    with pytest.raises(SystemExit):
        main(["--config", "mug", "--run-dir", a, "--device", "cpu",
              "--set", *SET])


def test_parity_cli_records_and_compares(runs, tmp_path, capsys):
    a, _, _ = runs
    rec = str(tmp_path / "digest.json")
    args = ["--config", "toy", "--n", "2", "--device", "cpu",
            "--record", rec]
    first = parity.main(args)
    assert first["deterministic"] and first["chunked_matches_generate"]
    assert first["backend"] == "cpu" and len(first["digest"]) == 64
    assert "recorded digest" in capsys.readouterr().out
    second = parity.main(args)
    assert second["record_matches"] and second["digest"] == first["digest"]
    assert "MATCHES" in capsys.readouterr().out
    other = parity.main(["--config", "toy", "--n", "2", "--seed", "1",
                         "--device", "cpu"])
    assert other["digest"] != first["digest"]
    with open(rec, "w") as f:        # a same-backend mismatch fails
        json.dump({**first, "digest": "0" * 64}, f)
    with pytest.raises(SystemExit, match="mismatch"):
        parity.main(args)
    # the generator of a Chainer-layout npz: its own digest (the reference
    # path, ``eval/import_chainer.py``)
    from mocogan_tpu_torch.eval import import_chainer

    src = tstate.create(get_config("toy"), seed=2, device="cpu")
    npz = import_chainer.export_state(src, str(tmp_path / "ref"))["gen"]
    ref = parity.main(["--config", "toy", "--n", "2", "--device", "cpu",
                       "--reference-npz", npz])
    assert ref["deterministic"] and ref["digest"] == parity.check_determinism(
        src.nets["gen"], n=2)["digest"] != first["digest"]


def test_parity_digest_of_a_run_dir(tmp_path):
    cfg = get_config("toy")
    run = _run_dir(tmp_path, cfg, 3)
    rep = parity.main(["--config", "toy", "--run-dir", run, "--n", "2",
                       "--device", "cpu"])
    s = tstate.create(cfg, seed=3, device="cpu")
    assert rep["digest"] == parity.check_determinism(
        s.nets["gen"], n=2)["digest"]
    assert rep["digest"] != parity.main(["--config", "toy", "--n", "2",
                                         "--device", "cpu"])["digest"]


def test_video_digest_is_bit_identity():
    v = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
    d = parity.video_digest(v)
    assert d == parity.video_digest(torch.from_numpy(v))
    w = v.copy()
    w[0, 0] = np.nextafter(w[0, 0], np.float32(np.inf))
    assert parity.video_digest(w) != d


def test_cudnn_context_restores_the_flags():
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    with parity.cudnn_deterministic():
        assert cudnn.deterministic and not cudnn.benchmark
    assert (cudnn.deterministic, cudnn.benchmark) == old


def _write_log(path, seed, fingerprint):
    """A port log: loss records every 10 steps, a panel every 50."""
    rng = np.random.default_rng(seed)
    log = MetricLogger(str(path))
    for step in range(10, 310, 10):
        log.log(step, {"loss_gen": 1.0 + 0.1 * rng.normal(),
                       "loss_di": 1.3 + 0.05 * rng.normal()},
                steps_per_sec=14.0)
        if step % 50 == 0:
            log.log(step, {"fvd_proxy": 20.0 - step / 30 + rng.normal(),
                           "fvd_proxy_dim": 64.0},
                    eval_fingerprint=fingerprint, eval_seconds=0.5)
    return log.path


@pytest.mark.parametrize("fp_b", ["v3-aaaaaaaaaaaa", "v3-bbbbbbbbbbbb"])
def test_compare_runs_matches_jax(tmp_path, fp_b):
    a = _write_log(tmp_path / "a", 0, "v3-aaaaaaaaaaaa")
    b = _write_log(tmp_path / "b", 1, fp_b)
    la, lb = tcompare.load_log(a), tcompare.load_log(b)
    got = tcompare.compare(la, lb)
    want = jcompare.compare(jcompare.load_log(a), jcompare.load_log(b))
    curves_got, curves_want = got.pop("_curves"), want.pop("_curves")
    assert got == want
    for k in curves_want:
        for name, arr in curves_want[k].items():
            np.testing.assert_array_equal(curves_got[k][name], arr)
    assert set(got["keys"]) == {"fvd_proxy", "loss_di", "loss_gen"}
    status = got["eval_fingerprints"]["fvd_comparability"]
    assert status == ("comparable" if fp_b.endswith("a") else
                      "eval_mismatch")
    printed = tcompare.main([a, b, "--out", str(tmp_path / "cmp")])
    assert printed["max_nabc"] == got["max_nabc"]
    assert (tmp_path / "cmp" / "compare.json").exists()
