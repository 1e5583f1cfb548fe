"""The port's benchmark harness (``python -m mocogan_tpu_torch.bench``) and
its matrix (``mocogan_tpu_torch.measure_perf``) on the CPU, as
``tests/test_bench_harness.py`` holds the JAX package's: a hung stage is
killed at its timeout and the line is still printed, a hung preflight
reads as an unresponsive card, a card that dies mid-run stops the run at
the re-probe, and a healthy run prints a headline. The exit code is 1
whenever a stage timed out or failed. No rate is asserted."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from mocogan_tpu_torch import measure_perf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model.image_size": 32, "model.video_length": 8,
        "model.gen_features": 8, "model.disc_features": 8,
        "train.batch_size": 8, "data.raw_size": 32}
OVERRIDES = json.dumps(TINY)
ORACLE_KEY = "mug_b16_ov" + hashlib.sha1(OVERRIDES.encode()).hexdigest()[:8]
NO_STAGES = {f"BENCH_{f}": "0" for f in ("BF16", "SCAN", "BATCHES",
                                         "GENERATE", "SCALED", "PARITY")}


def _bench(tmp_path, oracle=0.002, **env):
    """Run the bench on the CPU at the tiny geometry; returns (exit code,
    the last line parsed, stderr)."""
    cache = tmp_path / "cpu_cache.json"
    cache.write_text(json.dumps({ORACLE_KEY: oracle} if oracle else {}))
    full = {**os.environ, **NO_STAGES, "BENCH_CPU_CACHE": str(cache),
            "BENCH_OVERRIDES": OVERRIDES, "BENCH_STEPS": "2",
            "BENCH_WARMUP": "1", "BENCH_BUDGET_SEC": "300",
            "OMP_NUM_THREADS": "2", **env}
    out = subprocess.run([sys.executable, "-m", "mocogan_tpu_torch.bench",
                          "--device", "cpu"], capture_output=True, text=True,
                         env=full, cwd=ROOT, timeout=360)
    lines = out.stdout.splitlines()
    assert lines, f"no line; stderr: {out.stderr[-2000:]}"
    return out.returncode, json.loads(lines[-1]), out.stderr


def test_hung_train_stage_is_killed_and_the_line_printed(tmp_path):
    rc, line, err = _bench(tmp_path, BENCH_FAKE_HANG="train",
                           BENCH_STAGE_TIMEOUTS=json.dumps({"train": 3}))
    assert rc == 1, err[-2000:]
    assert line["metric"] == "train_steps_per_sec_64x64x16f"
    assert line["value"] is None and line["vs_baseline"] is None
    extra = line["extra"]
    assert extra["gpu_unresponsive"] is False
    stages = extra["stages"]
    assert stages["train"] == {"timeout": True, "timeout_sec": 3.0}
    assert stages["train_tf32_default"]["timeout"] is True
    # two timeouts in a row: the re-probe answers, so the run goes on
    assert stages["preflight_recheck1"]["ok"] is True
    assert stages["kernel_verify"]["ok"] is True
    assert "gpu_died_mid_run" not in extra
    assert extra["failed_stages"] == ["train", "train_tf32_default"]
    assert extra["cpu_oracle_steps_per_sec"] == 0.002


def test_hung_preflight_reads_as_an_unresponsive_card(tmp_path):
    rc, line, err = _bench(tmp_path, BENCH_FAKE_HANG="preflight",
                           BENCH_STAGE_TIMEOUTS=json.dumps({"preflight": 3}))
    assert rc == 1, err[-2000:]
    assert line["value"] is None
    extra = line["extra"]
    assert extra["gpu_unresponsive"] is True
    assert extra["stages"]["preflight"]["timeout"] is True
    assert set(extra["stages"]) == {"cpu_oracle", "preflight"}
    assert extra["kernel_check"] == "skipped:gpu_unresponsive"
    assert extra["cpu_oracle_steps_per_sec"] == 0.002


def test_card_dying_mid_run_stops_at_the_reprobe(tmp_path):
    """The preflight answers once, then its child exits 3: after the two
    hung train stages the re-probe fails and every later stage is skipped,
    instead of each spending its timeout."""
    rc, line, err = _bench(
        tmp_path, BENCH_FAKE_HANG="train",
        BENCH_FAKE_FAIL_AFTER=f"preflight:1:{tmp_path / 'pf_count'}",
        BENCH_STAGE_TIMEOUTS=json.dumps({"train": 3}),
        BENCH_BF16="1", BENCH_GENERATE="1")
    assert rc == 1, err[-2000:]
    extra = line["extra"]
    assert extra["gpu_died_mid_run"] is True
    stages = extra["stages"]
    assert stages["train"]["timeout"] and stages["train_tf32_default"][
        "timeout"]
    assert stages["preflight_recheck1"]["rc"] == 3
    for key in ("kernel_verify", "train_bf16", "generate"):
        assert stages[key] == {"skipped": "gpu_dead"}
    assert extra["kernel_check"] == "skipped:gpu_dead"


def test_healthy_cpu_run_prints_a_headline(tmp_path):
    rc, line, err = _bench(tmp_path, oracle=None)
    assert rc == 0, err[-2000:]
    assert line["value"] is not None and line["value"] > 0
    assert line["vs_baseline"] > 0
    extra = line["extra"]
    assert extra["failed_stages"] == [] and extra["gpu_unresponsive"] is False
    assert all(d.get("ok") for d in extra["stages"].values())
    # the kernel runs only on the card; on the CPU its check says so
    assert extra["kernel_check"].startswith("skipped:")
    assert "cpu" in extra["kernel_check"]
    res = extra["results"]
    assert res["preflight"]["device"] == "cpu"
    assert extra["device"]["name"] is None
    assert extra["tf32"]["train"] == {"mode": "off", "matmul": False,
                                      "cudnn": False}
    assert extra["tf32"]["train_tf32_default"]["mode"] == "default"
    for key in ("train", "train_tf32_default", "kernel_verify"):
        assert res[key]["kernel_launches"] == 0
        assert res[key]["max_memory_allocated"] is None
    assert len(res["train"]["windows"]) == 3
    # the oracle measured the tiny geometry under its own key
    oracle = res["cpu_oracle"]
    assert oracle["cached"] is False and oracle["key"] == ORACLE_KEY
    cache = json.loads((tmp_path / "cpu_cache.json").read_text())
    assert set(cache) == {ORACLE_KEY}


def test_parity_stage_on_the_cpu(tmp_path, monkeypatch):
    """The parity stage's digest is that of generate() at the recipe, and
    its dump (what the card's run reads back from its CPU rerun) holds the
    same clips."""
    import numpy as np
    import torch

    from mocogan_tpu_torch import bench
    from mocogan_tpu_torch.eval.parity import video_digest
    from mocogan_tpu_torch.models import generator
    from mocogan_tpu_torch.train import state

    monkeypatch.setenv("BENCH_OVERRIDES", OVERRIDES)
    dump = tmp_path / "cpu.npy"
    out = bench.stage_parity({"dump": str(dump)}, torch.device("cpu"))
    g = state.create(bench._cfg(), device="cpu").nets["gen"]
    want = generator.generate(g, 2, seed=0).numpy()
    assert out["deterministic"] is True
    assert out["digest"] == video_digest(want)
    np.testing.assert_array_equal(np.load(dump), want)
    assert "max_abs_err_vs_cpu" not in out


def test_malformed_overrides_raise(monkeypatch):
    """A BENCH_OVERRIDES that is not a JSON object fails its stage rather
    than reading as full width."""
    from mocogan_tpu_torch import bench

    for bad in ('{"model.image_size": 32', '[32]'):
        monkeypatch.setenv("BENCH_OVERRIDES", bad)
        with pytest.raises(ValueError):
            bench._cfg()
    monkeypatch.setenv("BENCH_OVERRIDES", OVERRIDES)
    assert bench._cfg().model.image_size == 32


def test_measure_perf_matrix_on_the_cpu(capsys):
    res = measure_perf.main([
        "--device", "cpu", "--steps", "1", "--warmup", "1", "--scan-k", "2",
        "--reps", "1", "--batches", "4", "--dtypes", "float32", "bfloat16",
        "--set", *(f"{k}={v}" for k, v in TINY.items())])
    assert sorted(res) == ["bfloat16_b4", "float32_b4"]
    for cell in res.values():
        assert set(cell) == {"single_steps_per_sec", "scan_steps_per_sec",
                             "scan_clips_per_sec", "card", "tf32"}
        for timer in ("single_steps_per_sec", "scan_steps_per_sec"):
            assert set(cell[timer]) == {"best", "median", "windows"}
        assert len(cell["single_steps_per_sec"]["windows"]) == 3
        assert cell["card"] == {"device": "cpu", "name": None,
                                "power_limit": None}
        assert cell["tf32"] == {"mode": "off", "matmul": False,
                                "cudnn": False}
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == res
