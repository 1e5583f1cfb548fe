"""The port's CUDA kernels against their plain PyTorch versions, and the
conv routes that must repeat bit for bit, on the card.

These tests need a CUDA card and skip without one. They import neither JAX
nor the JAX package, so on a machine without JAX they run with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
Tolerance 1e-5 absolute for the kernel: outputs lie in [-1, 1] and are
sums of non-negative fp32 terms taken in another order.
"""

import numpy as np
import pytest
import torch

from mocogan_tpu_torch.ops import layers, preproc, sampling

ATOL = 1e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(h=48, w=40, c=3):
    """4 clips padded to 10 frames; clip 1 has 3 frames (< t = 6)."""
    lengths = torch.tensor([10, 3, 10, 7])
    pool = np.random.default_rng(3).integers(0, 256, (4, 10, h, w, c),
                                             dtype=np.uint8)
    return torch.from_numpy(pool), lengths


# mug (96 -> 64), scaled (128 -> 96), identity, a 37 x 53 frame that is no
# multiple of 16 bytes (C 1 and 3), upscaling, and S 33 (S * S * C not a
# multiple of 4, so bands start off 16-byte boundaries)
@pytest.mark.gpu
@pytest.mark.parametrize("h,w,s,c", [(48, 40, 32, 3), (96, 96, 64, 3),
                                     (64, 64, 64, 3), (128, 128, 64, 3),
                                     (128, 128, 96, 3), (37, 53, 32, 1),
                                     (37, 53, 32, 3), (32, 32, 64, 3),
                                     (48, 40, 33, 3)])
def test_resize_norm_kernel_matches_plain(cuda, h, w, s, c):
    pool, lengths = _pool(h, w, c)
    sel = torch.tensor([1, 0, 3, 1, 2])
    ix = sampling.window_indices(lengths, sel, torch.tensor([2, 4, 1, 0, 3]),
                                 6)
    rh, rw = preproc.resize_weights(h, w, s, cuda)
    args = (pool.to(cuda), sel.to(cuda, torch.int32),
            ix.to(cuda, torch.int32), rh, rw)
    before = preproc.LAUNCHES["resize_norm"]
    got = preproc.resize_normalize_gather(*args)
    want = preproc.resize_normalize_gather_plain(*args)
    torch.cuda.synchronize()
    assert preproc.LAUNCHES["resize_norm"] == before + 1
    assert got.shape == (5, 6, s, s, c)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.gpu
def test_resize_norm_kernel_marks_bad_indices_nan(cuda):
    pool, _ = _pool()
    rh, rw = preproc.resize_weights(48, 40, 32, cuda)
    sel = torch.tensor([0, 9], dtype=torch.int32, device=cuda)   # 9: no clip
    ix = torch.zeros(2, 6, dtype=torch.int32, device=cuda)
    out = preproc.resize_normalize_gather(pool.to(cuda), sel, ix, rh, rw)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()


@pytest.mark.gpu
def test_resize_norm_kernel_on_an_uploaded_stack(cuda):
    """The host-fed layout: a (K, B, T, H, W, C) stack viewed as a pool of
    K*B clips, step j reading clips j*B .. j*B + B - 1."""
    k, b, t = 3, 4, 5
    stack = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (k, b, t, 48, 40, 3), dtype=np.uint8)).to(cuda)
    pool = stack.view(k * b, t, 48, 40, 3)
    rh, rw = preproc.resize_weights(48, 40, 32, cuda)
    ix = torch.arange(t, dtype=torch.int32, device=cuda).expand(b, t)
    for j in range(k):
        clip_ix = torch.arange(j * b, (j + 1) * b, dtype=torch.int32,
                               device=cuda)
        got = preproc.resize_normalize_gather(pool, clip_ix,
                                              ix.contiguous(), rh, rw)
        want = preproc.resize_normalize_gather_plain(pool, clip_ix,
                                                     ix.contiguous(), rh, rw)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= ATOL


@pytest.mark.gpu
def test_resize_norm_kernel_on_the_eval_pool(cuda):
    """The device-cached eval pool's layout: one launch over B = 256
    windows drawn with replacement from a 96 px store, short clips
    wrapped."""
    from mocogan_tpu_torch.train.loop import eval_windows

    lengths = np.array([32, 9, 20, 32, 5, 16])
    pool = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (6, 32, 96, 96, 3), dtype=np.uint8)).to(cuda)
    sel, frames = eval_windows(lengths, 256, 16)
    rh, rw = preproc.resize_weights(96, 96, 64, cuda)
    args = (pool, torch.from_numpy(sel).to(cuda, torch.int32),
            torch.from_numpy(frames).to(cuda, torch.int32), rh, rw)
    before = preproc.LAUNCHES["resize_norm"]
    got = preproc.resize_normalize_gather(*args)
    want = preproc.resize_normalize_gather_plain(*args)
    torch.cuda.synchronize()
    assert preproc.LAUNCHES["resize_norm"] == before + 1
    assert got.shape == (256, 16, 64, 64, 3)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.gpu
def test_host_fed_steps_launch_the_kernel(cuda):
    """multi_train_step on an uploaded uint8 stack: one launch a step."""
    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.train import state, step

    cfg = get_config("mug", **{
        "model.image_size": 32, "model.video_length": 8,
        "model.gen_features": 8, "model.disc_features": 8,
        "train.batch_size": 4})
    s = state.create(cfg, device=cuda)
    raw = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (3, 4, 8, 48, 48, 3), dtype=np.uint8)).to(cuda)
    before = preproc.LAUNCHES["resize_norm"]
    m = step.multi_train_step(s, raw)
    assert preproc.LAUNCHES["resize_norm"] == before + 3 and s.step == 3
    assert all(torch.isfinite(v) for v in m.values())


@pytest.mark.gpu
@pytest.mark.parametrize("tf32", [False, True])
def test_mug_step_gradients_repeat(cuda, tf32):
    """The mug step's gradients of G, D_I and D_V, taken twice from one state
    on one batch, are bit-equal, with cuDNN's TF32 off and on (the train
    CLI leaves it on): every conv pass takes a route that repeats."""
    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.data import synthetic
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.train import step as train_step

    cfg = get_config("mug")
    m = cfg.model
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        st = train_state.create(cfg, device=cuda)
        vids, _ = synthetic.make_batch(0, cfg.train.batch_size,
                                       t=m.video_length, size=m.image_size)
        real = torch.from_numpy(vids).to(cuda)
        noise = train_step.draw_noise(cfg, st.seed, 0, real.shape[0], cuda)
        (g1, m1), (g2, m2) = [train_step.compute_grads(st, real, noise)
                              for _ in range(2)]
    finally:
        torch.backends.cudnn.allow_tf32 = old
    assert set(g1) == {"gen", "di", "dv"}
    for net, grads in g1.items():
        for name, g in grads.items():
            assert torch.equal(g, g2[net][name]), f"{net}.{name}"
    assert all(torch.equal(v, m2[k]) for k, v in m1.items())


@pytest.mark.gpu
def test_wgrad_gemm_at_dv_conv0(cuda, monkeypatch):
    """D_V conv0's fp32 weight gradient at the mug shape (x (16, 3, 16, 64,
    64), k 4, stride (1, 2, 2), time pads (1, 2)): the layer takes the GEMM
    route with TF32 off; it agrees with cuDNN's deterministic algorithm
    within 1e-5 of the largest entry (fp32 sums of 262144 products in
    another order), two calls are bit-equal, and its peak allocation
    exceeds cuDNN's route's by no more than the chunk budget."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(16, 3, 16, 64, 64, generator=gen).to(cuda)
    w = (torch.randn(64, 3, 4, 4, 4, generator=gen) * 0.02).to(cuda)
    dy = torch.randn(16, 64, 16, 32, 32, generator=gen).to(cuda)
    stride = (1, 2, 2)
    pads = tuple(layers.same_pads(n, k, s) for n, k, s in
                 zip(x.shape[2:], w.shape[2:], stride))
    assert pads == ((1, 2), (1, 1), (1, 1))

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(x, dy, w, stride, pads)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    want, grow_cudnn = peak(layers._wgrad_cudnn)
    got, grow = peak(layers._wgrad)
    assert torch.equal(got, layers._wgrad_gemm(x, dy, w, stride, pads))
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err
    assert grow - grow_cudnn <= layers._WGRAD_CHUNK_BYTES, (grow, grow_cudnn)
