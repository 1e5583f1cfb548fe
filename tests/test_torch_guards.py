"""The port stands alone: no file of ``mocogan_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or any module of the JAX package, and the
entry points refuse to run on a missing GPU unless asked for the CPU."""

import ast
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mocogan_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mocogan_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_guard_tells_the_port_from_the_jax_package():
    assert _forbidden("mocogan_tpu") and _forbidden("mocogan_tpu.ops")
    assert _forbidden("jax.numpy")
    assert not _forbidden("mocogan_tpu_torch")
    assert not _forbidden("mocogan_tpu_torch.ops.preproc")
    files = _port_files()
    for sub in ("mesh.py", "launch.py"):
        assert os.path.join(PORT, "parallel", sub) in files
    for sub in (("eval", "import_chainer.py"), ("eval", "i3d_convert.py"),
                ("data", "preprocess.py"), ("parity_day.py",)):
        assert os.path.join(PORT, *sub) in files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_refuse_a_missing_gpu(monkeypatch, tmp_path, capsys):
    from mocogan_tpu_torch import (bench, eval_fvd, get_config, measure_perf,
                                   parity_day, sample, scaling_dossier)
    from mocogan_tpu_torch.eval import fvd, i3d, import_chainer, parity
    from mocogan_tpu_torch.eval.panel import PanelRunner
    from mocogan_tpu_torch.parallel import mesh
    from mocogan_tpu_torch.train import state
    from mocogan_tpu_torch.train.__main__ import main as train_main
    from mocogan_tpu_torch.train.loop import Trainer
    from mocogan_tpu_torch.utils import benchmarking, profiling, timer_turns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("toy")
    scaled = get_config("scaled", **{"train.num_devices": 1})
    for call in (lambda: state.create(cfg),
                 lambda: state.create(scaled),
                 lambda: state.create(get_config("categorical")),
                 lambda: profiling.main(["--config", "scaled", "--set",
                                         "train.num_devices=1"]),
                 lambda: state.create(cfg, device="cuda"),
                 lambda: Trainer(cfg, out_dir=str(tmp_path)),
                 lambda: Trainer(cfg, out_dir=str(tmp_path), resume=True),
                 lambda: train_main(["--out-dir", str(tmp_path),
                                     "--num-devices", "2"]),
                 lambda: mesh.make_mesh(),
                 lambda: mesh.make_mesh(device="cuda:1"),
                 lambda: sample.main(["--run-dir", str(tmp_path)]),
                 lambda: eval_fvd.main(["--run-dir", str(tmp_path)]),
                 lambda: parity.main([]),
                 lambda: parity.main(["--reference-npz", "gen.npz"]),
                 lambda: import_chainer.main(["--gen-npz", "gen.npz",
                                              "--digest"]),
                 lambda: import_chainer.import_experiment(cfg),
                 lambda: parity_day.main(["--reference-npz", "gen.npz",
                                          "--out", str(tmp_path / "pd")]),
                 lambda: PanelRunner(cfg),
                 lambda: i3d.I3DExtractor(None),
                 lambda: fvd.fvd(None, None),
                 lambda: benchmarking.time_single_step(cfg),
                 lambda: benchmarking.time_cached_scan(cfg),
                 lambda: benchmarking.time_generate(cfg, 4),
                 lambda: scaling_dossier.main(["--out",
                                               str(tmp_path / "dossier")]),
                 lambda: timer_turns.main([ROOT]),
                 lambda: measure_perf.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the benchmark's parent touches no card: its preflight child finds
    # none, and the line says so with exit code 1
    cache = tmp_path / "cpu_cache.json"
    cache.write_text(json.dumps({"mug_b16": 0.002}))
    for k, v in {"BENCH_CPU_CACHE": str(cache), "CUDA_VISIBLE_DEVICES": "",
                 **{f"BENCH_{f}": "0" for f in (
                     "BF16", "SCAN", "BATCHES", "GENERATE", "SCALED",
                     "PARITY")}}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_OVERRIDES", raising=False)
    assert bench.main(["--device", "cuda"]) == 1
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["value"] is None and line["extra"]["gpu_unresponsive"]
    assert "no CUDA device" in line["extra"]["stages"]["preflight"]["error"]
    assert set(line["extra"]["stages"]) == {"cpu_oracle", "preflight"}
