"""Training repeats bit for bit from its seed, checked as ``chip_smoke.py``
phase 16 checks it on the card.

Two train-CLI processes (``--device cpu``, tiny_cfg's geometry through
``--set``, device-cached, one seed) run side by side; phase 16's comparison
(``chip_smoke._same_runs``) must find their loss records, the sha256 of
every entry of their last checkpoints (params, BN stats, Adam moments)
and compare_runs' nabc all equal. A loss record or one checkpoint tensor
moved by one ulp must make it raise. The conv routes run here without
cuDNN; the card-side check of the same contract is
``test_torch_kernels.py::test_mug_step_gradients_repeat`` and phase 16.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from mocogan_tpu_torch.data import synthetic

STEPS = 4
TINY = ["model.image_size=32", "model.video_length=8",
        "model.gen_features=8", "model.disc_features=8",
        "train.batch_size=8", "train.steps_per_call=2", "data.raw_size=48",
        "train.log_every=2", "train.checkpoint_every=2",
        "train.sample_every=0"]


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("det")
    store = synthetic.write_store(str(tmp / "store"), clips=12, frames=10,
                                  size=48)
    args = ["--config", "mug", "--data-dir", store, "--seed", "3",
            "--total-steps", str(STEPS), "--device", "cpu", "--set", *TINY]
    dirs = [str(tmp / f"run{i}") for i in range(2)]
    procs = [chip_smoke._start_cli(args, d, env={"OMP_NUM_THREADS": "2"})
             for d in dirs]
    for p, d in zip(procs, dirs):
        chip_smoke._finish_cli(p, args, d)
    return dirs


def test_two_cli_runs_repeat_bit_for_bit(two_runs):
    got = chip_smoke._same_runs(*two_runs, STEPS)
    assert got["records"] == STEPS // 2
    assert got["checkpoint_entries"] > 50
    assert set(got["nabc"]) >= {"loss_di", "loss_dv", "loss_gen"}
    assert all(v == 0.0 for v in got["nabc"].values())


def _copy(src, dst):
    os.makedirs(dst)
    for name in ("log.jsonl",):
        with open(os.path.join(src, name)) as f, \
                open(os.path.join(dst, name), "w") as g:
            g.write(f.read())
    ck = os.path.join(dst, "checkpoints", str(STEPS))
    os.makedirs(ck)
    blob = torch.load(os.path.join(src, "checkpoints", str(STEPS),
                                   "state.pt"), weights_only=True)
    return blob, os.path.join(ck, "state.pt")


def test_one_ulp_apart_is_caught(two_runs, tmp_path):
    a, b = two_runs
    # a checkpoint tensor one ulp away
    blob, path = _copy(b, str(tmp_path / "w"))
    w = blob["nets"]["dv"]["conv3.w"]
    w.view(-1)[0] = torch.nextafter(w.view(-1)[0], torch.tensor(np.inf))
    torch.save(blob, path)
    with pytest.raises(AssertionError, match="checkpoints"):
        chip_smoke._same_runs(a, str(tmp_path / "w"), STEPS)
    # a loss record one ulp away
    blob, path = _copy(b, str(tmp_path / "log"))
    torch.save(blob, path)
    log = os.path.join(tmp_path, "log", "log.jsonl")
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    rec = next(r for r in recs if "loss_gen" in r)
    rec["loss_gen"] = float(np.nextafter(rec["loss_gen"], np.inf))
    with open(log, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    with pytest.raises(AssertionError, match="loss records"):
        chip_smoke._same_runs(a, str(tmp_path / "log"), STEPS)
