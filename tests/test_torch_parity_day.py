"""The port's ``parity_day`` on the CPU, over the synthetic fixtures of the
JAX package's own runner test (``tests/test_pipeline_and_cli.py``): a
reference generator npz in Chainer layout, a run dir, a small uint8 clip
store, I3D weights in the npz contract and two loss logs, at n 4.

Every stage's artifact is written; the import report equals the JAX
importer's; the digest repeats; ``compare.json`` equals the JAX
comparator's numbers on the same two logs; a reference exported from the
run's own state scores an FVD against the run of ~0. The --i3d-ckpt
stage is tested with the converter (``tests/test_torch_i3d_convert.py``).
"""

import json

import jax
import numpy as np
import pytest
import torch

from mocogan_tpu.eval import compare_runs as jcompare
from mocogan_tpu.eval import import_chainer as jimp
from mocogan_tpu.train import state as jstate_mod
from mocogan_tpu_torch import get_config, parity_day
from mocogan_tpu_torch.eval import i3d as ti3d
from mocogan_tpu_torch.eval import import_chainer as timp
from mocogan_tpu_torch.eval import parity
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

OVERRIDES = ["model.image_size=32", "model.video_length=8",
             "model.gen_features=8", "model.disc_features=8",
             "train.batch_size=8"]
ARTIFACTS = ("import_report.json", "reference_generate_digest.json",
             "fvd.json", "compare.json", "overlay.png", "summary.json")


def _cfg():
    return get_config("mug", **{k: int(v) for k, v in
                                (o.split("=") for o in OVERRIDES)})


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory, tiny_cfg):
    """The reference npz (JAX export of a JAX state, seed 5), a run dir
    holding the port's step-0 state, a 3-clip store, I3D weights and the
    two logs (the reference's losses shifted by 0.01)."""
    root = tmp_path_factory.mktemp("pd")
    js = jstate_mod.create(tiny_cfg, seed=5)
    gen_npz = str(root / "ref_gen.npz")
    jimp.export_net_npz(gen_npz, "gen", jax.tree.map(np.array,
                                                     js.params["gen"]),
                        jax.tree.map(np.array, js.bn["gen"]),
                        tiny_cfg.model)
    run_dir = root / "run"
    state = tstate.create(_cfg(), device="cpu")
    CheckpointManager(str(run_dir / "checkpoints")).save(state)
    data_dir = root / "clips"
    data_dir.mkdir()
    for i in range(3):
        np.save(data_dir / f"c{i}.npy", np.random.default_rng(i).integers(
            0, 256, (12, 32, 32, 3), dtype=np.uint8))
    i3d_npz = str(root / "i3d.npz")
    np.savez(i3d_npz, **ti3d.init_random(0))
    logs = {}
    for name, off in (("ours", 0.0), ("ref", 0.01)):
        logs[name] = str(root / f"{name}.jsonl")
        with open(logs[name], "w") as f:
            for s in range(0, 200, 20):
                f.write(json.dumps({"step": s,
                                    "loss_gen": 1.0 + off + s * 1e-3}) + "\n")
    return {"root": root, "gen_npz": gen_npz, "run_dir": str(run_dir),
            "state": state, "data_dir": str(data_dir), "i3d": i3d_npz,
            "logs": logs, "jcfg": tiny_cfg}


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_parity_day_runs_every_stage(fixtures, tmp_path):
    f = fixtures
    out = tmp_path / "pd"
    summary = parity_day.main([
        "--config", "mug", "--reference-npz", f["gen_npz"],
        "--i3d-weights", f["i3d"], "--data-dir", f["data_dir"],
        "--run-dir", f["run_dir"], "--our-log", f["logs"]["ours"],
        "--reference-log", f["logs"]["ref"], "--n", "4",
        "--out", str(out), "--device", "cpu", "--set", *OVERRIDES])
    for name in ARTIFACTS:
        assert (out / name).exists(), name
    assert _json(out / "summary.json") == json.loads(json.dumps(summary))
    st = summary["stages"]
    assert set(st) == {"import", "digest", "fvd", "compare"}
    assert set(summary["seconds"]) == set(st)
    assert all(v >= 0 for v in summary["seconds"].values())

    _, jreports = jimp.import_experiment(f["jcfg"], gen_npz=f["gen_npz"])
    assert _json(out / "import_report.json") == json.loads(
        json.dumps(jreports, default=str))
    assert st["import"]["matched"] == {"gen": 34}

    assert st["digest"]["deterministic"] and \
        st["digest"]["chunked_matches_generate"]
    ref_state, _ = timp.import_experiment(_cfg(), gen_npz=f["gen_npz"],
                                          device="cpu")
    assert st["digest"]["digest"] == parity.check_determinism(
        ref_state.nets["gen"], n=2, seed=0)["digest"]
    assert _json(out / "reference_generate_digest.json") == st["digest"]

    scores = st["fvd"]["scores"]
    assert set(scores) == {"reference_vs_real", "ours_vs_real",
                           "ours_vs_reference"}
    assert all(np.isfinite(v) for v in scores.values())
    assert "ABSOLUTE" in st["fvd"]["extractor"]
    assert _json(out / "fvd.json") == st["fvd"]

    want = jcompare.compare(jcompare.load_log(f["logs"]["ours"]),
                            jcompare.load_log(f["logs"]["ref"]))
    want = {k: v for k, v in want.items() if not k.startswith("_")}
    assert _json(out / "compare.json") == json.loads(json.dumps(want))
    assert st["compare"]["max_nabc"] == want["max_nabc"]


def test_parity_day_against_the_runs_own_export(fixtures, tmp_path):
    """A snapshot exported from the run's own state: the same digest on
    every call, and ours-vs-reference ~0 beside ours-vs-real (the
    random-projection proxy without I3D weights)."""
    f = fixtures
    paths = timp.export_state(f["state"], str(tmp_path / "exp"))
    entries = {}
    for net, gname in (("gen", "gen"), ("di", "image_dis"),
                       ("dv", "video_dis")):
        for k, v in np.load(paths[net]).items():
            entries[f"updater/model:{gname}/{k}"] = v
    snap = str(tmp_path / "snapshot_iter_0.npz")
    np.savez(snap, **entries)
    args = ["--config", "mug", "--snapshot-npz", snap, "--n", "4",
            "--device", "cpu", "--set", *OVERRIDES]
    first = parity_day.main([*args, "--out", str(tmp_path / "a")])
    assert first["stages"]["import"]["matched"] == {"gen": 34, "di": 19,
                                                    "dv": 19}
    # a reference alone has nothing to be scored against (as in JAX)
    assert first["stages"]["fvd"]["scores"] == {}
    second = parity_day.main([*args, "--out", str(tmp_path / "b"),
                              "--run-dir", f["run_dir"],
                              "--data-dir", f["data_dir"]])
    assert second["stages"]["digest"]["digest"] == \
        first["stages"]["digest"]["digest"] == parity.check_determinism(
            f["state"].nets["gen"], n=2, seed=0)["digest"]
    fvd = second["stages"]["fvd"]
    assert fvd["extractor"].startswith("random_projection_seed0 (RELATIVE")
    scores = fvd["scores"]
    assert scores["ours_vs_real"] > 0
    assert abs(scores["ours_vs_reference"]) <= 1e-3 * scores["ours_vs_real"]
