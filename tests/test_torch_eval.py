"""The port's eval modules against the JAX package's, on the same numpy
inputs: video metrics, the Fréchet math, the random-projection extractor
and its fingerprint, ``fvd()``, and I3D with its npz contract.

Tolerances, fp32 on both sides:
  * video metrics 1e-5 absolute (values in [0, 1] or dB of O(10));
  * the Fréchet math is the same numpy code: bit-equal;
  * extractor features 1e-4 absolute (four conv3d stages, O(1) outputs);
  * ``fvd()`` 1e-3 relative (eigenvalues of a noisy covariance);
  * I3D 1e-3 relative to the output's largest magnitude (57 conv + BN
    units, He-normal weights; reordered fp32 sums differ by ulps at each);
  * ``resize_videos`` 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocogan_tpu.eval import fvd as jfvd
from mocogan_tpu.eval import i3d as ji3d
from mocogan_tpu.eval import video_metrics as jvm
from mocogan_tpu_torch import bridge
from mocogan_tpu_torch.eval import fvd as tfvd
from mocogan_tpu_torch.eval import i3d as ti3d
from mocogan_tpu_torch.eval import video_metrics as tvm

torch.set_num_threads(1)

ATOL = 1e-5


def _clips(seed, shape=(4, 6, 16, 16, 3)):
    return np.random.default_rng(seed).uniform(
        -1, 1, size=shape).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- video metrics ---------------------------------------------------------

_A = _clips(0)
_B = np.clip(_A + _clips(1) * 0.2, -1, 1)

METRICS = {
    "psnr": (lambda m, a, b: m.psnr(a, b)),
    "psnr_identity": (lambda m, a, b: m.psnr(a, a)),
    "ssim": (lambda m, a, b: m.ssim(a, b)),
    "ssim_frames": (lambda m, a, b: m.ssim(a[0], b[0])),
    "clip_psnr": (lambda m, a, b: m.clip_psnr(a, b)),
    "clip_ssim": (lambda m, a, b: m.clip_ssim(a, b)),
    "frame_content_features": (lambda m, a, b:
                               m.frame_content_features(a)),
    "acd": (lambda m, a, b: m.acd(a)),
    "acd_from_features": (lambda m, a, b: m.acd_from_features(
        np.random.default_rng(5).normal(size=(3, 7, 4)).astype(np.float32))),
    "pairwise_ssim_diversity": (lambda m, a, b: m.pairwise_ssim_diversity(
        np.concatenate([a, b]), max_pairs=6, seed=2)),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_video_metric_matches_jax(name):
    fn = METRICS[name]
    want = _np(fn(jvm, jnp.asarray(_A), jnp.asarray(_B)))
    got = _np(fn(tvm, _A, _B))
    assert np.shape(got) == np.shape(want)
    if name == "psnr_identity":
        assert np.isposinf(got).all() and np.isposinf(want).all()
        return
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n, max_pairs, seed", [(2, 64, 0), (5, 3, 1),
                                                (32, 32, 0), (40, 64, 7)])
def test_pair_indices_match_jax(n, max_pairs, seed):
    np.testing.assert_array_equal(tvm.pair_indices(n, max_pairs, seed),
                                  jvm.pair_indices(n, max_pairs, seed))


def test_metric_input_checks():
    with pytest.raises(ValueError, match="shape mismatch"):
        tvm.ssim(_A, _A[:2])
    with pytest.raises(ValueError, match=">= 2 frames"):
        tvm.acd_from_features(np.zeros((2, 1, 3), np.float32))
    with pytest.raises(ValueError, match=">= 2 clips"):
        tvm.pair_indices(1)


# ---- Fréchet math, extractor, fingerprint, fvd() ----------------------------

def test_frechet_math_is_bit_equal():
    rng = np.random.default_rng(3)
    fa = rng.normal(size=(40, 8))
    fb = rng.normal(loc=0.3, size=(40, 8)) * 1.5
    for a, b in zip(jfvd.gaussian_statistics(fa),
                    tfvd.gaussian_statistics(fa)):
        np.testing.assert_array_equal(a, b)
    sa, sb = tfvd.gaussian_statistics(fa), tfvd.gaussian_statistics(fb)
    assert tfvd.frechet_distance(*sa, *sb) == jfvd.frechet_distance(*sa, *sb)
    assert tfvd._trace_sqrt_product(sa[1], sb[1]) == \
        jfvd._trace_sqrt_product(sa[1], sb[1])
    # rank-deficient covariances (fewer samples than dims), as a small
    # eval pool gives them
    sc, sd = tfvd.gaussian_statistics(fa[:5]), tfvd.gaussian_statistics(fb[:5])
    assert tfvd.frechet_distance(*sc, *sd) == jfvd.frechet_distance(*sc, *sd)


@pytest.fixture(scope="module")
def extractors():
    je = jfvd.RandomProjectionFeatures()
    return je, bridge.fvd_extractor_from_jax(
        jax.tree.map(np.asarray, je.params))


def test_bridged_extractor_features_match_jax(extractors):
    je, te = extractors
    v = _clips(4, (5, 8, 32, 32, 3))     # T 8: time pads (0, 1) at stride 2
    want = je(jnp.asarray(v))
    got = te(torch.from_numpy(v)).numpy()
    assert got.shape == want.shape == (5, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fingerprint_bridged_equals_jax_and_default_differs(extractors):
    je, te = extractors
    fp = jfvd.extractor_fingerprint(je)
    assert tfvd.extractor_fingerprint(te) == fp
    own = tfvd.RandomProjectionFeatures()
    assert tfvd.extractor_fingerprint(own) != fp
    assert tfvd.extractor_fingerprint(own) == tfvd.extractor_fingerprint(
        tfvd.RandomProjectionFeatures())
    assert tfvd.extractor_fingerprint(own).startswith(
        f"v{jfvd.EVAL_VERSION}-")
    assert tfvd.EVAL_VERSION == jfvd.EVAL_VERSION


def test_fvd_matches_jax(extractors):
    je, te = extractors
    a = _clips(6, (20, 8, 32, 32, 3))
    b = np.clip(_clips(7, (20, 8, 32, 32, 3)) * 0.7 + 0.2, -1, 1)
    want = jfvd.fvd(a, b, extractor=je, batch_size=8)
    got = tfvd.fvd(a, b, extractor=te, batch_size=8)
    assert abs(got - want) <= 1e-3 * abs(want)
    assert abs(tfvd.fvd(a, a.copy(), extractor=te)) < 1e-3


def test_i3dfeatures_requires_weights_path():
    for path in (None, ""):
        with pytest.raises(ValueError, match="requires a weights npz"):
            tfvd.I3DFeatures(path, device="cpu")


# ---- I3D ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def i3d_npz(tmp_path_factory):
    """JAX init_random weights written as a contract npz, and the JAX
    apply jitted once per input shape (features "pool" and "logits")."""
    params = ji3d.init_random(jax.random.key(1))
    path = str(tmp_path_factory.mktemp("i3d") / "w.npz")
    np.savez(path, **params)
    run = jax.jit(lambda p, x: (ji3d.apply(p, x, features="pool"),
                                ji3d.apply(p, x, features="logits")))
    return path, params, run


def test_i3d_expected_shapes_match_jax():
    assert ti3d.expected_shapes() == ji3d.expected_shapes()
    assert ti3d.conv_units() == ji3d.conv_units()
    own = ti3d.init_random(0)
    assert {k: v.shape for k, v in own.items()} == ji3d.expected_shapes()


def test_i3d_load_npz_validates(i3d_npz, tmp_path):
    path, params, _ = i3d_npz
    loaded = ti3d.load_npz(path)
    assert set(loaded) == set(ji3d.expected_shapes())
    bad = dict(params)
    bad["Conv3d_1a_7x7/w"] = bad["Conv3d_1a_7x7/w"][..., :32]
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="shape mismatches"):
        ti3d.load_npz(str(tmp_path / "bad.npz"))
    del bad["Mixed_5c/Branch_3/Conv3d_0b_1x1/beta"]
    np.savez(str(tmp_path / "missing.npz"), **bad)
    with pytest.raises(ValueError, match="missing"):
        ti3d.load_npz(str(tmp_path / "missing.npz"))


# 9 frames: the smallest protocol clip; 32 frames reach the head at T' = 4,
# where the (2, 7, 7) windows weight time (1, 2, 2, 1)
@pytest.mark.parametrize("t", [9, 32])
def test_i3d_features_match_jax(i3d_npz, t):
    path, params, run = i3d_npz
    v = _clips(8 + t, (1, t, 32, 32, 3))
    want = [np.asarray(x) for x in run(jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(v))]
    for features, w in zip(("pool", "logits"), want):
        ex = ti3d.I3DExtractor(path, features=features, resize_to=None,
                               device="cpu")
        got = ex(torch.from_numpy(v)).numpy()
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= 1e-3 * np.abs(w).max(), features


def test_i3d_resize_matches_jax():
    v = _clips(9, (1, 2, 36, 36, 3))
    for size in (48, 24):
        want = np.asarray(ji3d.resize_videos(jnp.asarray(v), size))
        got = ti3d.resize_videos(torch.from_numpy(v), size).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    same = ti3d.resize_videos(torch.from_numpy(v), 36)
    np.testing.assert_array_equal(same.numpy(), v)


def test_i3d_fingerprint_reads_the_contract(i3d_npz):
    """Both packages hash the same npz to the same fingerprint."""
    path, _, _ = i3d_npz
    j = ji3d.I3DExtractor.__new__(ji3d.I3DExtractor)    # weights only
    j.params = ji3d.load_npz(path)
    t = ti3d.I3DExtractor(path, device="cpu")
    assert tfvd.extractor_fingerprint(t) == jfvd.extractor_fingerprint(j)
