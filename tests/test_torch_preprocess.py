"""The port's offline preprocessing against the JAX package's, on the same
MJPG AVIs (cv2-encoded fixtures, two class directories) and a frame
directory: the stores must be byte-equal (same file tree, same uint8
arrays), the face-crop fallback and the temporal subsample must agree, and
the store must load in the port's ``ClipDataset`` and native clip store.
The port's real-clip pool for FVD on that store (the plain version of the
ingest kernel on the CPU) matches the JAX package's within 1e-5, the
ingest tests' tolerance (``tests/test_torch_preproc.py``).
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import eval_fvd as jeval_fvd  # noqa: E402
from mocogan_tpu import get_config as jget_config  # noqa: E402
from mocogan_tpu.data import preprocess as jpre  # noqa: E402
from mocogan_tpu_torch import eval_fvd as teval_fvd  # noqa: E402
from mocogan_tpu_torch import get_config  # noqa: E402
from mocogan_tpu_torch.data import clips, native  # noqa: E402
from mocogan_tpu_torch.data import preprocess as tpre  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5


def _write_avi(path, t=12, size=80, seed=0):
    """A moving solid square (smooth content: noise is pathological for
    the lossy MJPG codec)."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((t, size, size, 3), np.uint8)
    color = rng.integers(64, 256, size=3)
    for ti in range(t):
        x = 4 + 3 * ti
        frames[ti, 10:40, x:x + 20] = color
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (size, size))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """raw/walk/v{0,1}.avi, raw/run/v{0,1}.avi and raw/run/seq/*.png (a
    frame-directory clip inside a class)."""
    root = tmp_path_factory.mktemp("raw")
    for ci, cls in enumerate(("walk", "run")):
        (root / cls).mkdir()
        for i in range(2):
            _write_avi(root / cls / f"v{i}.avi", t=12 + 2 * i,
                       size=80 + 8 * ci, seed=2 * ci + i)
    seq = root / "run" / "seq"
    seq.mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        img = np.full((60, 72, 3), 40 + 10 * i, np.uint8)
        img[20:40, 5 * i:5 * i + 16] = rng.integers(0, 256, 3)
        cv2.imwrite(str(seq / f"{i:03d}.png"), img)
    return root


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("kwargs", [
    {"raw_size": 48},
    {"raw_size": 40, "frame_step": 2, "do_face_crop": True},
    {"raw_size": 32, "class_from_dirname": False}])
def test_store_is_byte_equal_to_jax(src, tmp_path, kwargs):
    n_j = jpre.preprocess_tree(str(src), str(tmp_path / "jax"), **kwargs)
    n_t = tpre.preprocess_tree(str(src), str(tmp_path / "port"), **kwargs)
    assert n_t == n_j == 5
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    if kwargs.get("class_from_dirname", True):
        assert sorted(want) == ["run/seq.npy", "run/v0.npy", "run/v1.npy",
                                "walk/v0.npy", "walk/v1.npy"]


def test_decode_and_steps_match_jax(src):
    avi = str(src / "walk" / "v1.avi")
    frames = tpre.decode_video(avi)
    np.testing.assert_array_equal(frames, jpre.decode_video(avi))
    assert frames.shape == (14, 80, 80, 3)
    seq = str(src / "run" / "seq")
    np.testing.assert_array_equal(tpre.decode_frame_dir(seq),
                                  jpre.decode_frame_dir(seq))
    for step in (1, 2, 3):
        np.testing.assert_array_equal(tpre.temporal_subsample(frames, step),
                                      jpre.temporal_subsample(frames, step))
    assert tpre.temporal_subsample(frames, 0).shape[0] == 14
    np.testing.assert_array_equal(tpre.resize_frames(frames, 33),
                                  jpre.resize_frames(frames, 33))
    with pytest.raises(ValueError, match="no image frames"):
        tpre.decode_frame_dir(str(src / "walk"))


@pytest.mark.parametrize("shape", [(3, 60, 100, 3), (2, 90, 50, 3)])
def test_face_crop_fallback_matches_jax(shape):
    """No face present -> the centre square crop, as in JAX."""
    frames = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    got = tpre.face_crop(frames)
    side = min(shape[1:3])
    assert got.shape == (shape[0], side, side, 3)
    np.testing.assert_array_equal(got, jpre.face_crop(frames))


def test_store_loads_in_the_port(src, tmp_path):
    out = tmp_path / "clips"
    assert tpre.main(["--src", str(src), "--out", str(out), "--raw-size",
                      "40"]) == 5
    ds = clips.ClipDataset(str(out), video_length=8)
    assert len(ds) == 5 and ds.n_classes == 2
    pool, lengths, labels = clips.load_pool(str(out))
    assert pool.shape == (5, 14, 40, 40, 3) and pool.dtype == np.uint8
    assert sorted(lengths.tolist()) == [10, 12, 12, 14, 14]
    assert sorted(labels.tolist()) == [0, 0, 0, 1, 1]
    if not native.native_available():
        pytest.skip("the native clip store did not build here")
    store = native.NativeClipStore(ds.files, ds.labels)
    try:
        got = store.fill_batch(np.arange(5), np.zeros(5), 8)
    finally:
        store.close()
    for i, f in enumerate(ds.files):
        np.testing.assert_array_equal(got[i], np.load(f)[:8])


def test_real_pool_matches_jax(src, tmp_path):
    """eval_fvd's real-clip pool on the preprocessed store: the port (the
    ingest kernel's plain version on the CPU) against the JAX package."""
    out = tmp_path / "clips"
    tpre.preprocess_tree(str(src), str(out), raw_size=48)
    over = {"model.image_size": 32, "model.video_length": 8}
    want = jeval_fvd._real_from_store(jget_config("mug", **over), str(out),
                                      6, 1)
    got = teval_fvd._real_from_store(get_config("mug", **over), str(out), 6,
                                     1, "cpu")
    assert got.shape == want.shape == (6, 8, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
