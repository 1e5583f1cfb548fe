"""The port's fused ingest against the JAX package's.

The plain version (the CPU path, and the oracle the CUDA kernel is held to
on the card) is checked against the numpy oracle, against the real Pallas
kernel body run in interpret mode, and, in its fused gather form, against
``gather_windows`` + ``resize_normalize`` on a pool with a clip shorter
than the window so the wrap is exercised. The kernel's 2-tap tables are
held to the dense weights exactly, and the kernel's arithmetic, written
here from those tables, to the plain version. Tolerance 1e-5 absolute:
outputs lie in [-1, 1] and are sums of non-negative fp32 terms taken in
another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocogan_tpu.ops import preproc as jpre
from mocogan_tpu.ops import sampling as jsam
from mocogan_tpu_torch.ops import preproc as tpre
from mocogan_tpu_torch.ops import sampling as tsam

torch.set_num_threads(1)

ATOL = 1e-5


def _raw(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("src,dst", [(96, 64), (128, 64), (64, 64),
                                     (50, 96), (40, 32)])
def test_bilinear_matrix_matches_jax(src, dst):
    np.testing.assert_array_equal(tpre.bilinear_matrix(src, dst),
                                  jpre.bilinear_matrix(src, dst))


@pytest.mark.parametrize("shape,size", [((2, 3, 96, 96, 3), 64),
                                        ((1, 2, 40, 56, 3), 32),
                                        ((1, 2, 64, 64, 3), 64)])
def test_plain_matches_oracle(shape, size):
    raw = _raw(shape, seed=1)
    got = tpre.resize_normalize(torch.from_numpy(raw), size).numpy()
    np.testing.assert_allclose(got, jpre.resize_normalize_reference(raw, size),
                               atol=ATOL)


def test_plain_matches_pallas_interpret():
    """The real Pallas kernel body, through the Pallas interpreter."""
    raw = _raw((1, 2, 40, 56, 3), seed=2)
    want = np.asarray(jpre.resize_normalize(jnp.asarray(raw), 32,
                                            use_pallas="interpret"))
    got = tpre.resize_normalize(torch.from_numpy(raw), 32).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _pool(h=48, w=40, c=3):
    """4 clips padded to 10 frames; clip 1 has 3 frames (< t = 6)."""
    lengths = np.array([10, 3, 10, 7], np.int32)
    pool = _raw((4, 10, h, w, c), seed=3)
    for i, n in enumerate(lengths):
        pool[i, n:] = 0
    return pool, lengths


def test_gather_windows_matches_jax_and_wraps():
    pool, lengths = _pool()
    sel = np.array([1, 0, 3, 1, 2], np.int32)
    starts = np.array([2, 4, 1, 0, 3], np.int32)
    want = np.asarray(jsam.gather_windows(jnp.asarray(pool),
                                          jnp.asarray(lengths),
                                          jnp.asarray(sel),
                                          jnp.asarray(starts), 6))
    got = tsam.gather_windows(torch.from_numpy(pool),
                              torch.from_numpy(lengths),
                              torch.from_numpy(sel).long(),
                              torch.from_numpy(starts).long(), 6).numpy()
    np.testing.assert_array_equal(got, want)
    # clip 1 (3 frames) wraps: no zero-padding frame is ever read
    ix = tsam.window_indices(torch.from_numpy(lengths),
                             torch.from_numpy(sel).long(),
                             torch.from_numpy(starts).long(), 6)
    assert ix[0].tolist() == [2, 0, 1, 2, 0, 1]
    assert int((ix < torch.from_numpy(lengths)[sel][:, None]).all())


def test_fused_gather_matches_gather_then_resize():
    pool, lengths = _pool()
    sel = np.array([1, 0, 3, 1, 2], np.int32)
    starts = np.array([2, 4, 1, 0, 3], np.int32)
    windows = jsam.gather_windows(jnp.asarray(pool), jnp.asarray(lengths),
                                  jnp.asarray(sel), jnp.asarray(starts), 6)
    want = np.asarray(jpre.resize_normalize(windows, 32,
                                            use_pallas="interpret"))
    tl = torch.from_numpy(lengths)
    ix = tsam.window_indices(tl, torch.from_numpy(sel).long(),
                             torch.from_numpy(starts).long(), 6)
    rh, rw = tpre.resize_weights(48, 40, 32, "cpu")
    got = tpre.resize_normalize_gather(
        torch.from_numpy(pool), torch.from_numpy(sel), ix.int(), rh,
        rw).numpy()
    assert got.shape == (5, 6, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_subsample_and_preprocess_matches_jax():
    raw = _raw((2, 8, 48, 48, 3), seed=4)
    idx = np.stack([np.arange(0, 8, 2), np.arange(1, 8, 2)]).astype(np.int32)
    want = np.asarray(jpre.subsample_and_preprocess(
        jnp.asarray(raw), jnp.asarray(idx), 32, use_pallas=False))
    got = tpre.subsample_and_preprocess(torch.from_numpy(raw),
                                        torch.from_numpy(idx), 32).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    pool, _ = _pool()
    rh, rw = tpre.resize_weights(48, 40, 32, "cpu")
    before = tpre.LAUNCHES["resize_norm"]
    with pytest.raises(ValueError, match="clip_ix"):
        tpre.resize_normalize_gather(torch.from_numpy(pool),
                                     torch.zeros(2, dtype=torch.int64),
                                     torch.zeros(2, 6, dtype=torch.int32),
                                     rh, rw)
    with pytest.raises(ValueError, match="rw"):
        tpre.resize_normalize_gather(torch.from_numpy(pool),
                                     torch.zeros(2, dtype=torch.int32),
                                     torch.zeros(2, 6, dtype=torch.int32),
                                     rh, rw.T.contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        tpre.resize_normalize_gather_cuda(
            torch.from_numpy(pool), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, 6, dtype=torch.int32), rh, rw)
    assert tpre.LAUNCHES["resize_norm"] == before



@pytest.mark.parametrize("src,dst", [(96, 64), (128, 96), (64, 64), (40, 32),
                                     (56, 32), (32, 64), (37, 53)])
def test_bilinear_taps_rebuild_the_matrix_exactly(src, dst):
    idx, wts = tpre.bilinear_taps(src, dst)
    assert ((idx[1] - idx[0] == 0) | (idx[1] - idx[0] == 1)).all()
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), idx[0]] = wts[0]
    m[np.arange(dst), idx[1]] += wts[1]
    np.testing.assert_array_equal(m, tpre.bilinear_matrix(src, dst))
    np.testing.assert_array_equal(m, jpre.bilinear_matrix(src, dst))


@pytest.mark.parametrize("h,w,c,s", [(48, 40, 3, 32), (37, 53, 1, 32),
                                     (37, 53, 3, 32), (32, 32, 3, 64),
                                     (48, 40, 3, 33)])
def test_two_tap_evaluation_matches_plain(h, w, c, s):
    """The kernel's arithmetic (vertical taps, then horizontal, then the
    affine) from the tables it is given, against the dense plain version."""
    pool, lengths = _pool(h, w, c)
    sel = torch.tensor([1, 0, 3, 1, 2])
    ix = tsam.window_indices(torch.from_numpy(lengths), sel,
                             torch.tensor([2, 4, 1, 0, 3]), 6)
    taps = tpre.resize_taps(h, w, s, "cpu")
    ih0, ih1, iw0, iw1 = taps.idx.long()
    wh0, wh1, ww0, ww1 = taps.wts
    x = torch.from_numpy(pool)[sel[:, None], ix].float()     # (B,T,H,W,C)
    y = torch.addcmul(wh0[:, None, None] * x[:, :, ih0], wh1[:, None, None],
                      x[:, :, ih1])                           # (B,T,S,W,C)
    z = torch.addcmul(ww0[:, None] * y[:, :, :, iw0], ww1[:, None],
                      y[:, :, :, iw1])                        # (B,T,S,S,C)
    got = (z * (2.0 / 255.0) - 1.0).numpy()
    rh, rw = tpre.resize_weights(h, w, s, "cpu")
    want = tpre.resize_normalize_gather_plain(
        torch.from_numpy(pool), sel.int(), ix.int(), rh, rw).numpy()
    assert got.shape == (5, 6, s, s, c)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("h,w,c,s", [(96, 96, 3, 64), (128, 128, 3, 96),
                                     (37, 53, 1, 32), (32, 32, 3, 64),
                                     (48, 40, 3, 33), (2048, 2048, 3, 64)])
def test_band_plan_stages_every_row_a_band_reads(h, w, c, s):
    """Each block stages input rows [ih0[s0], ih1[s_last]] of its band into
    shared memory sized for `span` rows; the plan halves the band until
    that fits 48 KB (the 2048 px frame needs band 1)."""
    band, span = tpre._band_plan(h, w, c, s)
    ih = tpre.bilinear_taps(h, s)[0]
    assert 16 * (s + band) + span * w * c <= 48 * 1024 or band == 1
    for s0 in range(0, s, band):
        rows = slice(s0, min(s0 + band, s))
        lo, hi = ih[0, s0], ih[1, rows.stop - 1]
        assert hi - lo + 1 <= span
        assert (ih[:, rows] >= lo).all() and (ih[:, rows] <= hi).all()


def test_resize_tables_are_cached_per_shape_and_device():
    cpu = torch.device("cpu")
    assert tpre.resize_taps(96, 96, 64, cpu) is tpre.resize_taps(96, 96, 64,
                                                                 cpu)
    assert tpre.resize_weights(96, 96, 64, cpu) is tpre.resize_weights(
        96, 96, 64, cpu)
    assert tpre.resize_taps(96, 96, 64, cpu) is not tpre.resize_taps(
        96, 96, 32, cpu)
