"""Sample export and the metric log of the port, against the JAX package's
where it has them."""

import json
import sys

import numpy as np
import pytest

from mocogan_tpu.utils import video as jvideo
from mocogan_tpu_torch.utils import video
from mocogan_tpu_torch.utils.metrics import MetricLogger


def _clips(n=5, t=3, size=6, c=3):
    return np.random.default_rng(0).integers(0, 256, (n, t, size, size, c),
                                             dtype=np.uint8)


@pytest.mark.parametrize("n, cols", [(5, None), (5, 2), (4, None), (1, 3)])
def test_tile_videos_equals_jax(n, cols):
    v = _clips(n)
    np.testing.assert_array_equal(video.tile_videos(v, cols),
                                  jvideo.tile_videos(v, cols))


def test_grid_gif_branch(tmp_path):
    from PIL import Image

    path = video.save_video_grid(_clips(), str(tmp_path / "s" / "g.gif"))
    assert path.endswith("g.gif")
    with Image.open(path) as im:
        assert im.n_frames == 3 and im.size == (18, 12)


def test_grid_npy_branch_without_pil(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "PIL", None)   # import PIL fails
    v = _clips()
    path = video.save_video_grid(v, str(tmp_path / "g.gif"))
    assert path == str(tmp_path / "g.npy")
    np.testing.assert_array_equal(np.load(path), video.tile_videos(v))
    assert "PIL is not installed" in capsys.readouterr().out
    paths = video.save_individual_gifs(v[:2], str(tmp_path / "one"))
    assert [p.endswith(".npy") for p in paths] == [True, True]


def test_logger_reloads_on_resume_and_skips_a_corrupt_tail(tmp_path):
    a = MetricLogger(str(tmp_path))
    a.log(2, {"loss_gen": 1.5}, steps_per_sec=3.0)
    a.log(4, {"loss_gen": 1.25})
    with open(a.path, "a") as f:
        f.write('{"step": 6, "loss_g')          # a crash mid-write
    recs = [json.loads(line) for line in open(a.path).read().splitlines()[:2]]
    b = MetricLogger(str(tmp_path))
    assert b.history == recs
    rec = b.log(6, {"loss_gen": 1.0})
    assert rec["time"] >= recs[-1]["time"]
    assert [r["step"] for r in b.history] == [2, 4, 6]


def test_logger_plot(tmp_path, monkeypatch):
    log = MetricLogger(str(tmp_path))
    assert log.plot() is None                        # no records yet
    log.log(1, {"loss_di": 0.5, "loss_gen": 1.0})
    log.log(2, {"loss_di": 0.4, "loss_gen": 1.1})
    assert log.plot().endswith("loss_curves.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert log.plot() is None
