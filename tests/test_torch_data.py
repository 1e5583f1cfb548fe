"""The port's host-side data feed against the JAX package's.

Batch assembly (numpy and the native C++ store), the synthetic batch
stream and ``ClipDataset`` are held to the JAX package byte for byte; the
port's iterator is held to the device-cached path's window gather, and
``ThreadedPrefetcher`` to the JAX one's contract.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mocogan_tpu.data import clips as jclips
from mocogan_tpu.data import native as jnative
from mocogan_tpu.data import synthetic as jsynth
from mocogan_tpu.ops import sampling as jsampling
from mocogan_tpu_torch import get_config
from mocogan_tpu_torch.data import clips, native, synthetic
from mocogan_tpu_torch.data.pipeline import HostFeed, ThreadedPrefetcher
from mocogan_tpu_torch.ops import sampling

LENGTHS = (10, 7, 3, 12, 6, 5)      # two clips shorter than T = 6
T = 6


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(0)
    for i, n in enumerate(LENGTHS):
        np.save(root / f"c{i}.npy",
                rng.integers(0, 256, (n, 8, 10, 3), dtype=np.uint8))
    return str(root)


def _cfg(store, **kw):
    return get_config("mug", **{
        "model.video_length": T, "train.batch_size": 4, "train.seed": 11,
        "data.data_dir": store, "data.device_cache": False, **kw})


def _jax_cfg(tiny_cfg, store, epoch_shuffle=False):
    return dataclasses.replace(
        tiny_cfg,
        model=dataclasses.replace(tiny_cfg.model, video_length=T),
        train=dataclasses.replace(tiny_cfg.train, batch_size=4, seed=11),
        data=dataclasses.replace(tiny_cfg.data, data_dir=store,
                                 epoch_shuffle=epoch_shuffle))


# (sel, starts): short clips 2 and 5 wrap, from 0 and from inside the clip
PLANS = [(np.array([2, 0, 5, 3]), np.array([0, 4, 3, 6])),
         (np.array([5, 5, 2, 1]), np.array([4, 0, 2, 1]))]


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_assembly_is_byte_equal_to_jax(store, tiny_cfg, monkeypatch, plan):
    """numpy assembly and native store, port and JAX, for one (sel,
    starts): four byte-equal batches."""
    sel, starts = PLANS[plan]
    ds = clips.ClipDataset(store, T)
    lengths = np.array(LENGTHS)
    # JAX's numpy assembly is inline in its iterator: hand it the plan
    monkeypatch.setattr(jsampling, "host_batch_plan",
                        lambda *a, **k: (sel, starts))
    want = next(jclips.clip_batch_iterator(_jax_cfg(tiny_cfg, store),
                                           use_native=False))["raw"]
    assert jnative.native_available() and native.native_available()
    got = {
        "jax native": jnative.NativeClipStore(ds.files, ds.labels)
        .fill_batch(sel.astype(np.int32), starts.astype(np.int64), T),
        "port numpy": clips.assemble_numpy(ds.files, lengths, sel, starts,
                                           T),
        "port native": native.NativeClipStore(ds.files, ds.labels)
        .fill_batch(sel, starts, T)}
    for name, a in got.items():
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, want, err_msg=name)
    # the short clip 2 (3 frames) read from start 0 wraps: 0 1 2 0 1 2
    i = list(sel).index(2)
    full = np.load(ds.files[2])
    np.testing.assert_array_equal(
        want[i], full[(starts[i] + np.arange(T)) % 3])


@pytest.mark.parametrize("epoch_shuffle", [False, True])
def test_iterator_matches_the_device_cached_gather(store, epoch_shuffle):
    """Native and numpy streams are byte-equal, and batch k holds the
    windows that the device-cached path gathers from the padded pool at
    step k."""
    cfg = _cfg(store, **{"data.epoch_shuffle": epoch_shuffle})
    a = clips.clip_batch_iterator(cfg, use_native=True)
    b = clips.clip_batch_iterator(cfg, use_native=False)
    pool, lengths, _ = clips.load_pool(store)
    pool, lengths = torch.from_numpy(pool), torch.from_numpy(lengths)
    for step in range(4):
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["raw"], y["raw"])
        sel, starts = sampling.batch_plan(11, step, 4, lengths, T,
                                          epoch_shuffle)
        np.testing.assert_array_equal(
            x["raw"], sampling.gather_windows(pool, lengths, sel, starts,
                                              T).numpy())
        assert x["frame_idx"].tolist() == [list(range(T))] * 4


def test_iterator_epoch_coverage_and_restart(tmp_path):
    n, b = 6, 4
    for i in range(n):          # clip i is all value i
        np.save(tmp_path / f"c{i}.npy", np.full((10, 8, 8, 3), i, np.uint8))
    cfg = get_config("mug", **{
        "model.video_length": 4, "train.batch_size": b,
        "data.data_dir": str(tmp_path), "data.epoch_shuffle": True})
    it = clips.clip_batch_iterator(cfg, use_native=False)
    ids = [v for _ in range(6) for v in next(it)["raw"][:, 0, 0, 0, 0]]
    for e in range(4):                                 # 24 draws, 4 epochs
        assert sorted(ids[e * n:(e + 1) * n]) == list(range(n))
    assert ids[:n] != ids[n:2 * n] or ids[n:2 * n] != ids[2 * n:3 * n]
    it2 = clips.clip_batch_iterator(cfg, use_native=True, start_batch=3)
    it3 = clips.clip_batch_iterator(cfg, use_native=True)
    for _ in range(3):
        next(it3)
    np.testing.assert_array_equal(next(it2)["raw"], next(it3)["raw"])


def test_native_contract(store, tmp_path, monkeypatch):
    """use_native=True raises where the store cannot be used; None falls
    back to numpy with a warning; a non-uint8 clip is refused by both."""
    np.save(tmp_path / "f.npy", np.zeros((8, 4, 4, 3), np.float32))
    ds = clips.ClipDataset(str(tmp_path), T)
    with pytest.raises(ValueError, match="uint8"):
        native.NativeClipStore(ds.files, ds.labels)
    cfg = _cfg(str(tmp_path))
    with pytest.raises(ValueError, match="uint8"):
        next(clips.clip_batch_iterator(cfg, use_native=True))
    monkeypatch.setattr(native, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="unavailable"):
        next(clips.clip_batch_iterator(_cfg(store), use_native=True))
    a = next(clips.clip_batch_iterator(_cfg(store)))["raw"]
    b = next(clips.clip_batch_iterator(_cfg(store), use_native=False))["raw"]
    np.testing.assert_array_equal(a, b)


def test_native_library_lands_in_the_build_dir():
    from mocogan_tpu_torch.utils import cuda_build

    _, rec = cuda_build.load_host("clipstore")
    assert os.path.dirname(rec["path"]) == cuda_build.BUILD_DIR
    assert os.path.basename(rec["path"]).startswith("libclipstore-")


@pytest.mark.parametrize("start", [0, 5])
def test_synthetic_batch_iterator_equals_jax(start):
    a = synthetic.batch_iterator(3, 2, t=4, size=16, start_batch=start)
    b = jsynth.batch_iterator(3, 2, t=4, size=16, start_batch=start)
    for _ in range(2):
        (va, la), (vb, lb) = next(a), next(b)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(la, lb)


def _class_tree(root, stray=None):
    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(root / f"class{c}")
        for i in range(3):
            np.save(root / f"class{c}" / f"clip{i}.npy",
                    rng.integers(0, 256, (12 - 5 * i, 8, 8, 3),
                                 dtype=np.uint8))
    if stray == "dir":
        os.makedirs(root / "logs")
        (root / "logs" / "notes.txt").write_text("x")
    elif stray == "clip":
        np.save(root / "stray.npy", np.zeros((4, 8, 8, 3), np.uint8))


@pytest.mark.parametrize("layout", ["classes", "classes+stray dir", "flat",
                                    "mixed", "empty"])
def test_clip_dataset_layouts_match_jax(tmp_path, layout):
    if layout.startswith("classes"):
        _class_tree(tmp_path, "dir" if "stray" in layout else None)
    elif layout == "flat":
        for i in range(3):
            np.save(tmp_path / f"c{i}.npy",
                    np.full((3 + 4 * i, 8, 8, 3), i, np.uint8))
    elif layout == "mixed":
        _class_tree(tmp_path, "clip")
    if layout in ("mixed", "empty"):
        err = ValueError if layout == "mixed" else FileNotFoundError
        for mod in (clips, jclips):
            with pytest.raises(err):
                mod.ClipDataset(str(tmp_path), 8)
        return
    got = clips.ClipDataset(str(tmp_path), 8)
    want = jclips.ClipDataset(str(tmp_path), 8)
    assert (got.files, got.labels, got.class_names, got.n_classes) == (
        want.files, want.labels, want.class_names, want.n_classes)
    for i in range(len(got)):
        a = got.get_example(i, np.random.default_rng(i))
        b = want.get_example(i, np.random.default_rng(i))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


def test_prefetcher_preserves_order():
    it = ThreadedPrefetcher(iter(range(20)), depth=3)
    assert list(it) == list(range(20))
    assert it.wait_s >= 0.0


def test_prefetcher_propagates_exceptions():
    def gen():
        yield 1
        raise ValueError("boom")

    it = ThreadedPrefetcher(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_close_terminates_worker(depth):
    it = ThreadedPrefetcher(iter(range(1_000_000)), depth=depth)
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=2.0)
    assert not it._thread.is_alive()


def test_host_feed_stacks_batches_in_order(store):
    """k batches per stack, in the iterator's order, each stack its own
    tensor; a stream that runs out ends the feed."""
    cfg = _cfg(store)
    want = clips.clip_batch_iterator(cfg, use_native=False)
    feed = HostFeed(clips.clip_batch_iterator(cfg, use_native=False), 2,
                    torch.device("cpu"), depth=2)
    try:
        stacks = [feed.next() for _ in range(3)]
    finally:
        feed.close()
    for batches, frame_idx, labels in stacks:
        assert batches.shape == (2, 4, T, 8, 10, 3)
        assert batches.dtype == torch.uint8 and frame_idx.dtype == torch.int32
        assert labels.shape == (2, 4) and labels.dtype == torch.int32
        np.testing.assert_array_equal(
            batches.numpy(), np.stack([next(want)["raw"] for _ in range(2)]))
        assert frame_idx.tolist() == [[list(range(T))] * 4] * 2
    f32 = HostFeed(synthetic.batch_iterator(0, 2, t=3, size=8), 1,
                   torch.device("cpu"), depth=1)
    batches, frame_idx, labels = f32.next()
    f32.close()
    assert batches.shape == (1, 2, 3, 8, 8, 3) and frame_idx is None
    assert labels.shape == (1, 2)
    short = HostFeed(iter([(np.zeros((1, 2, 4, 4, 3), np.float32), None)] * 3),
                     2, torch.device("cpu"), depth=1)
    assert short.next()[2] is None              # batches without labels
    with pytest.raises(StopIteration):
        short.next()
    short.close()
