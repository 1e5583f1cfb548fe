#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mocogan_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card, from nvidia-smi, with the torch and CUDA versions;
  2. build the CUDA ingest kernel (csrc/resize_norm.cu) from the checkout;
  3. hold the kernel against its plain PyTorch version at the mug training
     layout (B 16, T 16, 96 -> 64 px, C 3), and time kernel, plain version
     and the library yardstick (F.interpolate) with CUDA events, each
     rotating over the same 8 batch plans so that none sits in L2; then
     the same on the device-cached eval pool's layout (one launch over 256
     windows drawn with replacement from the store), F.interpolate
     included;
  4. render a 96 px synthetic uint8 clip store and train the full-width mug
     model (fp32, batch 16, 16 steps per call) through the device-cached
     trainer, with the quality panel (256 eval clips) after the last log
     window; the kernel's launches must equal the steps taken plus the eval
     pool's launch. Then time the panel warm;
  5. the host-fed path on the same store: hold the kernel against its plain
     version on one uploaded stack of 16 batches (the stack is the pool),
     then train the mug model host-fed (native clip store, pinned uploads)
     for 3 calls with a checkpoint, a sample grid and the panel every 32
     steps (the kernel's launches must equal the steps taken plus the eval
     pools'), resume a fresh trainer from the step-48 checkpoint to step 64
     (its panel at 64), and sample a grid from the checkpoint with the
     generate CLI;
  6. eval on the card against the CPU: the panel's raw outputs on 8 clips of
     the trained state, and I3D features (pool and logits) of one
     224x224x16 clip on random weights; I3D's time per clip on the card;
  7. the eval CLIs on the resumed run: eval_fvd against the store (256
     clips, random-projection proxy), eval_fvd with a random-weight I3D npz
     written in the contract layout (32 clips at 224 px), and the parity
     CLI twice with a digest record;
  8. generate() 16 clips, and hold generate(seed=3) on the card against the
     same call on the CPU (the noise is drawn on the host);
  9. the categorical model (config 4, 6 classes) on a 6-class store:
     device-cached, 2 calls of 16 steps with the panel at the end; host-fed,
     1 call with a checkpoint; the generate CLI with --labels from that
     checkpoint; generate(seed, labels) on the card against the CPU;
 10. mug with train.update_order=sequential, device-cached, 2 calls;
 11. mug at the bf16 production recipe (batch 32, label_smoothing 0.1),
     device-cached, 2 calls; params, BN stats and Adam moments stay fp32;
     D_I and D_V logits of fixed clips on the card against the same bf16
     forward on the CPU;
 12. the scaled config (config 5: 96x96x32f, batch 64, bf16, remat) at
     train.num_devices=1 on a 128 px store: the kernel at its layout (B 64,
     T 32, 128 -> 96 px) against its plain version and timed like the mug
     layout; 2 calls of k = 32 with remat, then 1 call without;
 13. data parallel: the kernel at the per-rank mug layout (B 8 of 16) and
     the per-rank scaled layout (B 32 of 64, T 32, 128 -> 96 px) against
     its plain version and timed; then, side by side on card 0, eight
     worlds of two gloo ranks each running the train CLI's own main (each
     rank joins the group, then calls it with --device cuda:0
     --num-devices 2): mug fp32 device-cached A and B, C to step 32 then
     resumed to 48 in a fresh world (started with the others; its ranks
     wait for the first world's end before they call main), a host-fed
     pair (seed 5, 48 steps, log and checkpoints every 16, TF32 as the
     CLI leaves it) and a scaled pair (train.num_devices=2: 32 a rank,
     bf16, remat, one call of the recipe's k 32: one log record, so no
     nabc), each pair (and C against A) compared by _same_runs, each rank's
     launches = its world's steps; meanwhile two ranks of the mug step
     (8 rows each of the global batch of 16) against one process on the
     global batch: step 0's metrics, gradients and BN stats and one
     device-cached call's mean metrics, launches = steps on each rank,
     parameters bit-equal across the ranks. No global deterministic flag
     anywhere. Then, alone on the card, the scaling dossier
     (mocogan_tpu_torch/scaling_dossier.py): the collectives of one mug
     and one scaled step counted by kind, the gradient buckets equal to
     4 B x param_count, each net's bucket all-reduce timed alone and one
     step's collectives summed, in the two-rank gloo world and a one-rank
     NCCL world; with two or more cards, two NCCL ranks on two cards
     through the train CLI, twice side by side, compared by _same_runs
     (steps/s and clips/s);
 14. reference parity, on the mug run of phase 5 and the categorical
     run of phase 9: export each to Chainer layout (the mug state also as
     a Trainer snapshot with an optimizer entry, /N counters and pre-BN
     biases), import it on the card and hold every parameter and BN
     buffer bit-equal to the source (the deconv weights equal to the
     npz's dc{i}/W), and generate(seed=3), D_I and D_V logits (and the
     class head) bit-equal; the parity CLI's
     --reference-npz and --run-dir digests and the import CLI's equal;
     the TF-less converter raising ImportError; a Sonnet-shaped I3D
     variable set through convert_variables, its logits card vs CPU;
     parity_day at n 256 (import, digest, I3D-FVD against the store
     through one kernel launch, comparator), ours vs reference ~0;
     preprocessing two AVIs where OpenCV is installed;
 15. the timers of utils/benchmarking.py at full width, TF32 off, each in
     a fresh process through the benchmark's watchdog
     (mocogan_tpu_torch.bench.run_stage), after this process frees its
     cached card memory: mug fp32 time_single_step (50 steps, warm-up 6,
     3 windows), time_cached_scan (k 16, reps 4, 3 windows) and
     time_generate at 16 and 64 clips; the bf16 recipe's time_cached_scan
     (k 16, reps 4, 3 windows); scaled's (train.num_devices=1, k 32, reps
     1, 2 windows, 32 clips). Each rate finite and positive, best >=
     median, one rate a window; each scan launches the kernel
     k * (1 + reps * windows) times, the other timers never; mug fp32's
     scan median within 0.5-2x of phase 4's trainer. Then the bench's
     kernel_verify stage (the kernel against its plain version at the mug
     and scaled layouts, one launch each, not counted on the path) and
     its parity stage (generate() at mug's seed-0 init, n 2: two calls
     bit-equal, card vs a CPU process within 1e-4). A stage that is not
     ok raises;
 16. determinism: the train CLI (mug fp32, seed 5, 48 steps, TF32 as the
     CLI leaves it) in two fresh processes device-cached and two host-fed,
     one trained to step 32 then resumed to 48 in a third process, and two
     one-rank NCCL worlds in torchrun's environment, side by side on the
     card: each pair's loss records in log.jsonl and the sha256 of every
     entry of their step-48 checkpoints (params, BN stats, Adam moments)
     equal, compare_runs' nabc 0.0 for every loss key, each NCCL run also
     equal to the plain device-cached one, each process's kernel launches
     = its steps; then, in this process with TF32 off, two calls from equal
     states of the sequential order, the categorical model, the bf16
     recipe (k 16 each) and scaled (k 32, remat): metrics and every state
     tensor bit-equal; the kernel's launches in these calls = 2 x k each;
 17. print the kernels line, then the result line.
Every training phase prints the card's name and power limit, steps/s and
the peak of torch.cuda.max_memory_allocated; each variant's kernel
launches must equal its steps plus its eval-pool launches.
fp32 runs in full fp32: TF32 is switched off for matmuls and cuDNN, except
in the train CLI runs of phases 13 and 16 and the dossier's ranks. Every
conv pass takes a route that repeats bit for bit (ops/layers.py), so two
generate() calls are bit-equal and training repeats from its seed without
cudnn.deterministic, on one rank and on two.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-5       # values in [-1, 1]; reordered fp32 sums
GENERATE_TOL = 1e-4     # 4 BN-normalized deconv stages, card vs CPU fp32
PANEL_TOL = 1e-4        # panel raw outputs, card vs CPU fp32, same clips
I3D_TOL = 1e-3          # of the largest magnitude: 57 conv + BN units
# data parallel vs one process on the global batch, fp32: reductions split
# over the ranks sum in another order (tests/test_torch_parallel.py)
DP_METRIC_TOL = {"rtol": 2e-4, "atol": 2e-5}
DP_GRAD_TOL = 1e-3      # of each gradient's largest magnitude, or
DP_FLOOR_FACTOR = 2     # times the one process's own reordering floor
DP_BN_TOL = 1e-5        # BN running stats, absolute
DP_TIMEOUT_S = 300      # the spawned gloo ranks, start to end
DP_CLI_TIMEOUT_S = 600  # phase 13's train-CLI worlds, start to end
TIMER_BUDGET_S = 600    # phase 15's bench stages, all together
# bf16 D logits, card (cuDNN) vs CPU, of the largest |logit|: both round
# each conv's output to bf16, and a tie rounded apart is a 2^-8 step that
# four BN stages pass on
BF16_LOGIT_TOL = 5e-2
TRAIN_CALLS = 5         # trainer calls of k = 16 steps; the first warms up
HOST_FED_CALLS = 3      # host-fed calls of k = 16 steps before the resume
DET_STEPS = 48          # each train-CLI run of phase 16 (3 calls of 16)
DET_SEED = 5
EVAL_CLIPS = 256        # the panel's clip budget (train.eval_clips)
PANEL_KEYS = ("fvd_proxy", "gen_spread_ratio", "acd_gen", "acd_real",
              "gen_pairwise_ssim", "dv_margin", "fvd_proxy_dim")


# nvidia-smi name -> (bytes/s, fp32 FLOP/s without tensor cores), from the
# data sheets; a card not listed gets no bound.
RATES = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
    "NVIDIA H100 NVL": (3.9e12, 60e12),
    "NVIDIA H200": (4.8e12, 67e12),
}


def _time_ms(fn, n: int, warmup: int = 3):
    """(device ms per call, host ms per call) of n calls fn(0..n-1).

    The calls are queued behind a spin kernel, so the card runs them back
    to back and the events time the device, not the host's launch rate."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    while True:
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        ev[2].record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):   # the queue never drained
            return ev[1].elapsed_time(ev[2]) / n, host_ms / n
        if cycles > 1 << 33:
            raise RuntimeError(f"{n} calls took {host_ms:.0f} ms of host "
                               f"time: the host waits on the card")
        cycles *= 4


def _check_kernel(pool, clip_ix, frame_ix, rh, rw, what) -> float:
    """Max abs error of the kernel against its plain version; raises past
    KERNEL_TOL."""
    import torch

    from mocogan_tpu_torch.ops import preproc

    got = preproc.resize_normalize_gather_cuda(pool, clip_ix, frame_ix, rh, rw)
    want = preproc.resize_normalize_gather_plain(pool, clip_ix, frame_ix, rh,
                                                 rw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[kernel] resize_norm vs plain at the {what} shape "
          f"{tuple(got.shape)}: max_abs_err {err:.3e} (tol {KERNEL_TOL})")
    if not (err <= KERNEL_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"kernel disagrees with plain ({what}): {err}")
    return err


LOSS_KEYS = ("loss_di", "loss_dv", "loss_gen", "loss_gen_di", "loss_gen_dv")


def _check_losses(recs, keys=LOSS_KEYS) -> None:
    recs = [r for r in recs if "loss_gen" in r]
    if not recs or not all(math.isfinite(r[kk]) for r in recs
                           for kk in keys):
        raise AssertionError(f"missing or non-finite losses: {recs}")


def _check_panels(recs, steps, what) -> list:
    """The panel records of a log at `steps`: finite values, the
    fingerprint and the stall; returns them."""
    panels = [r for r in recs if "eval_fingerprint" in r]
    if [r["step"] for r in panels] != steps:
        raise AssertionError(f"{what}: panels at "
                             f"{[r['step'] for r in panels]}, want {steps}")
    for r in panels:
        if not (all(math.isfinite(r[kk]) for kk in PANEL_KEYS)
                and r["eval_fingerprint"].startswith("v3-")
                and r["eval_seconds"] >= 0):
            raise AssertionError(f"{what}: bad panel record {r}")
        print(f"[eval] {what} panel at step {r['step']}: eval_seconds "
              f"{r['eval_seconds']}; " + json.dumps(
                  {kk: r[kk] for kk in PANEL_KEYS + ("eval_fingerprint",)}))
    return panels


def _max_err(a, b) -> float:
    return float((a.detach().cpu() - b.detach().cpu()).abs().max())


def _bound(moved, flops, rates):
    """(bound ms, "bytes" or "operations") from data-sheet rates, or
    (None, None) for a card without them."""
    if rates is None:
        return None, None
    bound_s = {"bytes": moved / rates[0], "operations": flops / rates[1]}
    by = max(bound_s, key=bound_s.get)
    return 1e3 * bound_s[by], by


def _layout(pool, plans, rh, rw, s, rates, what) -> dict:
    """The kernel on one training layout: held against its plain version on
    plan 0, then kernel, plain version and F.interpolate (on the same
    frames pre-gathered as f32 planes) timed rotating over all `plans`.
    The bound of one launch counts the distinct frames plan 0 reads, the
    tap tables and indices once, and the fp32 planes it writes."""
    import torch
    import torch.nn.functional as F

    from mocogan_tpu_torch.ops import preproc

    h, w, c = pool.shape[2:]
    n = len(plans)
    err = _check_kernel(pool, *plans[0], rh, rw, what)

    def kern(i):
        preproc.resize_normalize_gather_cuda(pool, *plans[i % n], rh, rw)

    def plain(i):
        preproc.resize_normalize_gather_plain(pool, *plans[i % n], rh, rw)

    x_lib = [pool[sel.long()[:, None], ix.long()].permute(
        0, 1, 4, 2, 3).reshape(-1, c, h, w).float() for sel, ix in plans]

    def lib(i):
        return F.interpolate(x_lib[i % n], size=(s, s), mode="bilinear",
                             align_corners=False, antialias=False)

    b, t = plans[0][1].shape
    lib_out = (lib(0) * (2.0 / 255.0) - 1.0).view(
        b, t, c, s, s).permute(0, 1, 3, 4, 2)
    lib_err = float((lib_out - preproc.resize_normalize_gather_plain(
        pool, *plans[0], rh, rw)).abs().max())
    del lib_out
    out = {"max_abs_err": err}
    out["ms"], host_ms = _time_ms(kern, 50)
    out["plain_ms"], _ = _time_ms(plain, 20)
    out["library_ms"], _ = _time_ms(lib, 50)
    library_one_ms, _ = _time_ms(lambda _: lib(0), 50)
    del x_lib
    sel, ix = plans[0]
    frames_read = len({(i, f) for i, row in zip(sel.tolist(), ix.tolist())
                       for f in row})
    n_planes = b * t * c
    moved = (frames_read * h * w * c + 4 * (rh.numel() + rw.numel())
             + 4 * (b + b * t) + 4 * n_planes * s * s)
    # bilinear needs 2 taps per output of each pass (a multiply and an add
    # each), then the affine
    flops = n_planes * (4 * s * w + 4 * s * s + 2 * s * s)
    out["bound_ms"], out["bound_by"] = _bound(moved, flops, rates)
    print(f"[kernel] {what}: device ms {out['ms']:.5f} (host "
          f"{host_ms:.5f} ms per wrapper call), plain {out['plain_ms']:.5f},"
          f" F.interpolate {out['library_ms']:.5f} over the {n} plans, "
          f"{library_one_ms:.5f} on plan 0 alone (input pre-gathered in "
          f"f32; its max err vs plain {lib_err:.2e})")
    if out["bound_ms"] is None:
        print(f"[kernel] {what}: no data-sheet rates for this card: no "
              f"bound")
    else:
        print(f"[kernel] {what}: bound {out['bound_ms']:.6f} ms by "
              f"{out['bound_by']} ({out['bound_ms'] / out['ms']:.3f} of it "
              f"reached): {moved / 1e6:.2f} MB ({frames_read} distinct "
              f"frames read) at {rates[0] / 1e12} TB/s, {flops / 1e9:.4f} "
              f"GFLOP (2-tap) at {rates[1] / 1e12} TFLOP/s fp32")
    return out


def _plans(lengths, n, b, t, dev):
    """n batch plans of the training stream (seed 0, epoch shuffle) as
    (clip indices (B,), frame indices (B, T)) int32 on `dev`."""
    import torch

    from mocogan_tpu_torch.ops import sampling

    out = []
    for step in range(n):
        sel, starts = sampling.batch_plan(0, step, b, lengths, t, True)
        ix = sampling.window_indices(lengths, sel, starts, t)
        out.append((sel.to(dev, torch.int32), ix.to(dev, torch.int32)))
    return out


def _train_variant(what, cfg, out_dir, dev, calls, smi, host_fed=False):
    """Train `cfg` for `calls` calls of k steps (device-cached, or host-fed
    from the native store), with log_every = k; check the kernel's launches
    (= steps + eval-pool launches) and the losses; print steps/s after the
    first call and the peak memory. Returns (trainer, summary)."""
    import gc

    import torch

    from mocogan_tpu_torch.data import clips
    from mocogan_tpu_torch.ops import preproc
    from mocogan_tpu_torch.train.loop import Trainer

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    k = cfg.train.steps_per_call
    trainer = Trainer(cfg, out_dir=out_dir, device=dev)
    preproc.LAUNCHES["resize_norm"] = 0
    t0 = time.perf_counter()
    if host_fed:
        trainer.run(clips.clip_batch_iterator(cfg, use_native=True),
                    total_steps=calls * k)
    else:
        trainer.run_device_cached(total_steps=calls * k)
    secs = time.perf_counter() - t0
    launches = preproc.LAUNCHES["resize_norm"]
    steps, ev = trainer.state.step, trainer.eval_pool_launches
    if steps != calls * k or launches != steps + ev:
        raise AssertionError(f"{what}: {steps} steps, {launches} kernel "
                             f"launches, {ev} for the eval pool")
    keys = LOSS_KEYS + (("loss_aux_d", "loss_aux_g")
                        if cfg.model.conditional else ())
    recs = trainer.logger.history
    _check_losses(recs, keys)
    windows = [r for r in recs if "steps_per_sec" in r]
    warm = windows[1:] or windows
    sps = len(warm) * k / sum(k / r["steps_per_sec"] for r in warm)
    peak = torch.cuda.max_memory_allocated()
    m, t = cfg.model, cfg.train
    print(f"[{what}] {smi}: {m.image_size}x{m.image_size}x"
          f"{m.video_length}f {m.compute_dtype}, remat {m.remat}, "
          f"{t.update_order}, batch {t.batch_size}: {steps} steps "
          f"({calls} calls of k {k}) in {secs:.2f} s; "
          f"{sps:.3f} steps/s ({'after the first call' if calls > 1 else 'one call, warm-up included'}); "
          f"peak memory {peak / 1e9:.2f} GB "
          f"({resident / 1e9:.2f} GB resident before the phase); kernel "
          f"launches {launches} = {steps} steps + {ev} eval pool; last "
          f"losses " + json.dumps({kk: round(windows[-1][kk], 5)
                                   for kk in keys}))
    return trainer, {"steps_per_s": sps, "peak_gb": peak / 1e9,
                     "launches": launches - ev, "eval_pool": ev}


def _step0(cfg, mesh, dev, pool, lengths, rh, rw, reverse=False):
    """Step 0 from a fresh state by ``compute_grads`` on the rank's rows
    of the step's plan (mesh None: the global batch; `reverse`: its rows
    in reverse order, the same step summed in another order): gradients,
    metrics and the BN buffers after it, on the host."""
    import torch

    from mocogan_tpu_torch.ops import preproc, sampling
    from mocogan_tpu_torch.train import state as tstate
    from mocogan_tpu_torch.train import step as tstep

    st = tstate.create(cfg, device=dev, mesh=mesh)
    d = tstep.shard_draws(tstep.draw_step(cfg, st.seed, 0, lengths, dev),
                          mesh)
    if reverse:
        d = {kk: v.flip(1 if kk == "eps" else 0) for kk, v in d.items()}
    ix = sampling.window_indices(lengths, d["sel"], d["starts"],
                                 cfg.model.video_length)
    real = preproc.resize_normalize_gather(
        pool, d["sel"].to(dev, torch.int32), ix.to(dev, torch.int32), rh, rw)
    grads, m0 = tstep.compute_grads(st, real, d, mesh=mesh)
    return ({f"{n}.{pn}": g.cpu() for n, gs in grads.items()
             for pn, g in gs.items()},
            {kk: float(v) for kk, v in m0.items()},
            {f"{n}.{kk}": v.cpu() for n, net in st.nets.items()
             for kk, v in net.named_buffers()})


def _steps(cfg, mesh, dev, pool, lengths, rh, rw, reverse=False) -> list:
    """k device-cached steps from a fresh state, one
    ``cached_multi_train_step`` call each so that every step's metrics
    come back (`reverse`: each step's global batch in reverse row order);
    returns (per-step metric dicts, the state)."""
    from mocogan_tpu_torch.train import state as tstate
    from mocogan_tpu_torch.train import step as tstep

    st = tstate.create(cfg, device=dev, mesh=mesh)
    out = []
    for i in range(cfg.train.steps_per_call):
        draws = None
        if reverse:
            d = tstep.draw_step(cfg, st.seed, i, lengths, dev)
            draws = [{kk: v.flip(1 if kk == "eps" else 0)
                      for kk, v in d.items()}]
        m = tstep.cached_multi_train_step(st, pool, lengths, 1, rh, rw,
                                          draws=draws, mesh=mesh)
        out.append({kk: float(v) for kk, v in m.items()})   # host read
    return out, st


def _dp_call(cfg, mesh, dev, pool, lengths, rh, rw) -> dict:
    """One rank's part of the data-parallel check (mesh None: one process
    on the global batch): ``_step0``, then ``_steps``, timed. CPU tensors
    and floats."""
    import torch

    from mocogan_tpu_torch.ops import preproc

    out = dict(zip(("grads", "metrics0", "bn0"),
                   _step0(cfg, mesh, dev, pool, lengths, rh, rw)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    preproc.LAUNCHES["resize_norm"] = 0
    t0 = time.perf_counter()
    out["metrics"], st = _steps(cfg, mesh, dev, pool, lengths, rh, rw)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = preproc.LAUNCHES["resize_norm"]
    out["steps"] = st.step
    out["params"] = {f"{n}.{kk}": v.cpu() for n, net in st.nets.items()
                     for kk, v in net.state_dict().items()}
    return out


def _dp_rank(rank: int, world: int, store: str, overrides: dict,
             out_dir: str, device: str) -> None:
    """A rank of the gloo world on `device` (``torch.multiprocessing``
    target): ``_dp_call`` of the mug config with `overrides` on its rows,
    saved to <out_dir>/rank<r>.pt."""
    sys.path.insert(0, ROOT)
    import torch

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.data import clips
    from mocogan_tpu_torch.ops import preproc
    from mocogan_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)       # many worlds share the host's cores
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dev = torch.device(device)
    pmesh.initialize_distributed(dev, backend="gloo", init_method=store)
    try:
        mesh = pmesh.make_mesh(world, 1, dev)
        cfg = get_config("mug", **overrides)
        pool_np, lengths_np, _ = clips.load_pool(cfg.data.data_dir)
        pool = torch.from_numpy(pool_np).to(dev)
        rh, rw = preproc.resize_weights(pool.shape[2], pool.shape[3],
                                        cfg.model.image_size, dev)
        out = _dp_call(cfg, mesh, dev, pool, torch.from_numpy(lengths_np),
                       rh, rw)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _cli_rank(rank: int, world: int, store: str, argv: list, out_dir: str,
              tag: str, device: str, after: list) -> None:
    """A rank of a gloo world on `device` running the train CLI
    (``torch.multiprocessing`` target): join the group, wait until every
    file of `after` exists, then call the CLI's own ``main(argv)``, which
    finds the world joined and neither spawns nor joins one. Its output
    goes to <out_dir>/rank<r>_<tag>.out, its ingest-kernel launches to
    <out_dir>/rank<r>_<tag>.json."""
    sys.path.insert(0, ROOT)
    with open(os.path.join(out_dir, f"rank{rank}_{tag}.out"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    import torch

    from mocogan_tpu_torch.ops import preproc
    from mocogan_tpu_torch.parallel import mesh as pmesh
    from mocogan_tpu_torch.train import __main__ as train_cli

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)       # many worlds share the host's cores
    pmesh.initialize_distributed(torch.device(device), backend="gloo",
                                 init_method=store)
    try:
        torch.zeros(1, device=device)      # start the context meanwhile
        while not all(os.path.exists(f) for f in after):
            time.sleep(0.2)
        train_cli.main(argv)
    finally:
        torch.distributed.destroy_process_group()
    path = os.path.join(out_dir, f"rank{rank}_{tag}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"launches": preproc.LAUNCHES["resize_norm"]}, f)
    os.replace(path + ".tmp", path)
    sys.stdout.flush()


def _start_world(argv, out_dir, tag, started, world=2, device="cuda:0",
                 after=()):
    """Start a gloo world of `world` train-CLI ranks on `device`
    (``_cli_rank``, waiting for the files `after`) writing to `out_dir`;
    its ``ProcessContext``, also appended to `started`."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    store = "file://" + os.path.join(out_dir, f"store_{tag}")
    args = [*argv, "--device", device, "--num-devices", str(world),
            "--out-dir", out_dir]
    started.append(mp.start_processes(
        _cli_rank, args=(world, store, args, out_dir, tag, device,
                         list(after)),
        nprocs=world, join=False, start_method="spawn"))
    return started[-1]


def _kill(contexts) -> None:
    """Kill every process of `contexts` that still runs."""
    for ctx in contexts:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join()


def _world_launches(out_dir, tag, world=2) -> list:
    """Each rank's ingest-kernel launches in a world of ``_start_world``."""
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}_{tag}.json")) as f:
            out.append(json.load(f)["launches"])
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# the train CLI's main in a process of its own, then the process's
# ingest-kernel launches to the file named by its first argument
_COUNTED_CLI = (
    "import json, sys\n"
    "from mocogan_tpu_torch.ops import preproc\n"
    "from mocogan_tpu_torch.train.__main__ import main\n"
    "main(sys.argv[2:])\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    json.dump(preproc.LAUNCHES, f)\n")


def _start_cli(args, out_dir, env=None):
    """Start the train CLI in a process of its own, its output to a file in
    `out_dir` and its ingest-kernel launches to launches.json there (the
    process's own; a CLI that spawns its ranks launches none itself)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cli.out"), "w") as out:
        return subprocess.Popen(
            [sys.executable, "-c", _COUNTED_CLI,
             os.path.join(out_dir, "launches.json"), *args,
             "--out-dir", out_dir], cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT, env={**os.environ, **(env or {})})


def _finish_cli(p, args, out_dir, steps=None):
    """Wait for a train CLI process (killed after 300 s); its log records
    and the ingest-kernel launches it made. With `steps`, the process must
    have launched the kernel once for each of the steps it took."""
    try:
        rc = p.wait(timeout=300)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        rc = "timeout"
    if rc:
        with open(os.path.join(out_dir, "cli.out")) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"train CLI {args}: rc {rc}\n{tail}")
    with open(os.path.join(out_dir, "launches.json")) as f:
        launches = json.load(f)["resize_norm"]
    if steps is not None and launches != steps:
        raise AssertionError(f"train CLI {args}: {launches} kernel "
                             f"launches for {steps} steps")
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f], launches


def _loss_records(run_dir) -> list:
    """[(step, {loss key: value})] of a run's log.jsonl."""
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], {kk: v for kk, v in r.items()
                         if kk.startswith("loss")})
            for r in recs if any(kk.startswith("loss") for kk in r)]


def _same_runs(run_a, run_b, step: int, nabc: bool = True) -> dict:
    """Raise unless two run dirs repeat each other bit for bit: equal loss
    records in log.jsonl, equal sha256 of every tensor (and every other
    entry) of their step-`step` checkpoints, and (with `nabc`; it needs
    two log records) the port's compare_runs reading nabc 0.0 for every
    loss key. Returns what was compared."""
    from mocogan_tpu_torch.eval import compare_runs
    from mocogan_tpu_torch.utils import checkpoint

    recs = [_loss_records(r) for r in (run_a, run_b)]
    if not recs[0] or recs[0] != recs[1]:
        raise AssertionError(f"loss records of {run_a} and {run_b} differ")
    dig = [checkpoint.digests(os.path.join(r, "checkpoints", str(step),
                                           "state.pt"))
           for r in (run_a, run_b)]
    bad = sorted(kk for kk in dig[0].keys() | dig[1].keys()
                 if dig[0].get(kk) != dig[1].get(kk))
    if bad:
        raise AssertionError(f"step-{step} checkpoints of {run_a} and "
                             f"{run_b} differ in {len(bad)} entries: "
                             f"{bad[:6]}")
    if not nabc:
        return {"records": len(recs[0]), "checkpoint_entries": len(dig[0]),
                "nabc": None}
    rep = compare_runs.compare(*[compare_runs.load_log(
        os.path.join(r, "log.jsonl")) for r in (run_a, run_b)])
    nabc = {kk: v.get("nabc") for kk, v in rep["keys"].items()}
    if not nabc or any(v != 0.0 for v in nabc.values()):
        raise AssertionError(f"compare_runs {run_a} vs {run_b}: nabc "
                             f"{nabc}")
    return {"records": len(recs[0]), "checkpoint_entries": len(dig[0]),
            "nabc": nabc}


def _close(got: dict, want: dict, what: str) -> float:
    """Max relative error of got's metrics against want's; raises past
    DP_METRIC_TOL."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: metrics {sorted(got)} vs "
                             f"{sorted(want)}")
    worst = 0.0
    for kk, v in want.items():
        if not abs(got[kk] - v) <= DP_METRIC_TOL["atol"] \
                + DP_METRIC_TOL["rtol"] * abs(v):
            raise AssertionError(f"{what}: {kk} {got[kk]} vs {v}")
        worst = max(worst, abs(got[kk] - v) / max(abs(v), 1e-12))
    return worst


def _dp_worlds(store, sc_dir, tmp, started) -> dict:
    """Start phase 13's train-CLI worlds side by side, two gloo ranks each
    on card 0: mug fp32 device-cached A and B, C to step 32 and C resumed
    to DET_STEPS in a fresh world (its ranks wait for the first world's
    end), the host-fed pair, and the `scaled` pair (train.num_devices=2,
    one call of the recipe's k). Returns {world: (out dir, tag, steps,
    context)}."""
    from mocogan_tpu_torch import get_config

    k = get_config("mug").train.steps_per_call
    k_sc = get_config("scaled").train.steps_per_call

    def mug(steps, *extra):
        return ["--config", "mug", "--data-dir", store, "--seed",
                str(DET_SEED), "--total-steps", str(steps), "--set",
                f"train.log_every={k}", f"train.checkpoint_every={k}",
                *extra]

    scaled = ["--config", "scaled", "--data-dir", sc_dir, "--seed",
              str(DET_SEED), "--total-steps", str(k_sc), "--set",
              f"train.log_every={k_sc}", f"train.checkpoint_every={k_sc}"]
    c = os.path.join(tmp, "dp_resumed")
    # world: (argv, out dir, tag, steps, files its ranks wait for)
    jobs = {"cached_a": (mug(DET_STEPS), "cached_a", "1", DET_STEPS, ()),
            "cached_b": (mug(DET_STEPS), "cached_b", "1", DET_STEPS, ()),
            "resumed_1": (mug(DET_STEPS - k), "resumed", "1",
                          DET_STEPS - k, ()),
            "resumed_2": (mug(DET_STEPS), "resumed", "2", k,
                          [os.path.join(c, f"rank{r}_1.json")
                           for r in range(2)]),
            "host_fed_a": (mug(DET_STEPS, "data.device_cache=false"),
                           "host_fed_a", "1", DET_STEPS, ()),
            "host_fed_b": (mug(DET_STEPS, "data.device_cache=false"),
                           "host_fed_b", "1", DET_STEPS, ()),
            "scaled_a": (scaled, "scaled_a", "1", k_sc, ()),
            "scaled_b": (scaled, "scaled_b", "1", k_sc, ())}
    out = {}
    for name, (argv, run, tag, steps, after) in jobs.items():
        d = os.path.join(tmp, f"dp_{run}")
        out[name] = (d, tag, steps,
                     _start_world(argv, d, tag, started, after=after))
    return out


def _finish_dp_worlds(worlds, t0) -> dict:
    """Wait for the worlds of ``_dp_worlds`` under the DP_CLI_TIMEOUT_S
    watchdog (from t0); check each rank's ingest launches against its
    world's steps, then compare the pairs with ``_same_runs``. Returns the
    comparisons, the launches, the seconds and each world's end (s from
    t0)."""
    open_ = dict(worlds)
    launches, ends = {}, {}
    while open_:
        for name, (d, tag, steps, ctx) in list(open_.items()):
            try:
                done = ctx.join(timeout=0.5)    # raises if a rank failed
            except Exception as e:
                raise AssertionError(
                    f"data-parallel world {name} failed: {e}\n"
                    + _tail(os.path.join(d, f"rank0_{tag}.out"))) from e
            if not done:
                continue
            del open_[name]
            got = _world_launches(d, tag)
            if got != [steps, steps]:
                raise AssertionError(f"world {name}: kernel launches {got} "
                                     f"a rank for {steps} steps")
            launches[name] = got
            ends[name] = round(time.perf_counter() - t0, 1)
        if time.perf_counter() - t0 > DP_CLI_TIMEOUT_S:
            raise TimeoutError(f"the train-CLI worlds ran past "
                               f"{DP_CLI_TIMEOUT_S} s: {sorted(open_)}")
    secs = time.perf_counter() - t0
    d = {name: w[0] for name, w in worlds.items()}
    k_sc = worlds["scaled_a"][2]
    same = {"device_cached": _same_runs(d["cached_a"], d["cached_b"],
                                        DET_STEPS),
            "resumed_vs_straight": _same_runs(d["resumed_2"], d["cached_a"],
                                              DET_STEPS),
            "host_fed": _same_runs(d["host_fed_a"], d["host_fed_b"],
                                   DET_STEPS),
            # one call logs one record: compare_runs reads no curve
            "scaled": _same_runs(d["scaled_a"], d["scaled_b"], k_sc,
                                 nabc=False)}
    return {"same": same, "launches": launches, "seconds": secs,
            "ends": ends}


def _tail(path, n=6000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError as e:
        return f"({e})"


def _data_parallel(overrides, pool, lengths, rh, rw, plans, rates, smi,
                   tmp, sc_dir):
    """Phase 13 on the mug config with `overrides` (and `scaled` on the
    store `sc_dir`); returns the per-rank layouts' numbers, the ingest
    launches of every rank and the figures measured."""
    import torch

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch import scaling_dossier
    from mocogan_tpu_torch.data import clips
    from mocogan_tpu_torch.ops import preproc

    t_phase = time.perf_counter()
    cfg = get_config("mug", **overrides)
    m, b, k = cfg.model, cfg.train.batch_size, cfg.train.steps_per_call
    dev = pool.device
    h, s = pool.shape[2], m.image_size
    # rank 0's rows of each plan: the layout each rank's launch sees
    half = [(sel[:b // 2].contiguous(), ix[:b // 2].contiguous())
            for sel, ix in plans]
    lay = _layout(pool, half, rh, rw, s, rates,
                  f"per-rank mug layout (B {b // 2} of {b}, T "
                  f"{m.video_length}, {h} -> {s} px)")
    sc = get_config("scaled")
    pool_sc_np, lengths_sc_np, _ = clips.load_pool(sc_dir)
    pool_sc = torch.from_numpy(pool_sc_np).to(dev)
    del pool_sc_np
    b_sc, s_sc = sc.train.batch_size, sc.model.image_size
    half_sc = [(sel[:b_sc // 2].contiguous(), ix[:b_sc // 2].contiguous())
               for sel, ix in _plans(torch.from_numpy(lengths_sc_np), 8,
                                     b_sc, sc.model.video_length, dev)]
    lay_sc = _layout(pool_sc, half_sc,
                     *preproc.resize_weights(pool_sc.shape[2],
                                             pool_sc.shape[3], s_sc, dev),
                     s_sc, rates,
                     f"per-rank scaled layout (B {b_sc // 2} of {b_sc}, T "
                     f"{sc.model.video_length}, {pool_sc.shape[2]} -> "
                     f"{s_sc} px)")
    del pool_sc, half_sc

    # the train CLI in gloo worlds of two ranks on card 0, side by side,
    # while this process holds the two ranks against one process
    t_worlds = time.perf_counter()
    started = []
    try:
        worlds = _dp_worlds(cfg.data.data_dir, sc_dir, tmp, started)
        out = _dp_check(cfg, overrides, pool, lengths, rh, rw, smi, tmp)
        cli = _finish_dp_worlds(worlds, t_worlds)
    finally:
        _kill(started)
    for what, r in cli["same"].items():
        print(f"[data-parallel] {smi}: train CLI, 2 gloo ranks on card 0, "
              f"{what} (seed {DET_SEED}, TF32 as the CLI leaves it, no "
              f"global deterministic flag): {r['records']} loss records "
              f"and {r['checkpoint_entries']} checkpoint entries bit-equal;"
              f" compare_runs nabc " + (json.dumps(r["nabc"])
                                        if r["nabc"] is not None else
                                        "not read (one log record)"))
    print(f"[data-parallel] {smi}: the {len(cli['launches'])} train-CLI "
          f"worlds' ingest launches a rank " + json.dumps(cli["launches"])
          + " = each "
          f"world's steps; the worlds took {cli['seconds']:.1f} s, each "
          f"ending at (s) " + json.dumps(cli["ends"]))
    out["launches"] += sum(sum(v) for v in cli["launches"].values())
    out.update(layout=lay, scaled_layout=lay_sc, cli_worlds=cli["same"],
               cli_worlds_seconds=cli["seconds"])

    # the data-parallel layer's accounting, alone on the card
    t0 = time.perf_counter()
    dossier = scaling_dossier.build(dev)
    dossier_s = time.perf_counter() - t0
    for name in scaling_dossier.CONFIGS:
        tr = dossier[f"traffic_{name}"]
        want = 4 * tr["param_count"]
        print(f"[dossier] {smi}: {name}: gradient buckets "
              f"{tr['grad_bucket_bytes_total']} B a step a rank "
              + json.dumps(tr["grad_bucket_bytes"]) + f" (4 B x param_count"
              f" {tr['param_count']} = {want}); all collectives "
              f"{tr['collective_bytes_total']} B in {tr['calls_per_step']} "
              f"calls " + json.dumps(tr["by_kind"]) + "; ring analytic "
              + json.dumps(tr["analytic_ring_allreduce_bytes_by_n"])
              + "; JAX recorded " + json.dumps(tr.get("jax")))
        for label, v in tr["allreduce_ms"].items():
            print(f"[dossier] {smi}: {name}, {label}: bucket ms alone "
                  + json.dumps(v["bucket_ms"]) + "; one step's "
                  f"collectives {v['step_collectives_ms_total']:.3f} ms "
                  + json.dumps(v["step_collectives_ms"])
                  + f" of a {v['step_ms']:.1f} ms step")
        if tr["grad_bucket_bytes_total"] != want:
            raise AssertionError(f"{name}: gradient buckets "
                                 f"{tr['grad_bucket_bytes_total']} B, want "
                                 f"4 x param_count = {want}")
    print(f"[dossier] {smi}: weak scaling "
          f"{json.dumps(dossier['weak_scaling'])} "
          f"({dossier['weak_scaling_reason']}); took {dossier_s:.1f} s, "
          f"the worlds (s; the second from the first's end) "
          + json.dumps(dossier["world_seconds"]))
    out["dossier"] = {name: {kk: dossier[f"traffic_{name}"][kk] for kk in (
        "param_count", "grad_bucket_bytes_total", "collective_bytes_total",
        "calls_per_step", "allreduce_ms")}
        for name in scaling_dossier.CONFIGS}
    out["dossier_seconds"] = dossier_s
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[data-parallel] {smi}: {n_cards} card visible: two NCCL "
              f"ranks on two cards not run, nor their second run and its "
              f"comparison")
    else:
        args = ["--config", "mug", "--data-dir", cfg.data.data_dir,
                "--seed", str(DET_SEED), "--num-devices", "2",
                "--total-steps", str(4 * k), "--set",
                f"train.log_every={k}", "train.sample_every=0"]
        dirs = [os.path.join(tmp, f"run_nccl2_{x}") for x in "ab"]
        procs = [_start_cli(args, d_) for d_ in dirs]
        try:
            recs = [_finish_cli(p, args, d_)[0]
                    for p, d_ in zip(procs, dirs)][0]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        _check_losses(recs)
        same = _same_runs(*dirs, 4 * k)
        warm = [r for r in recs if "steps_per_sec" in r][1:]
        sps = len(warm) * k / sum(k / r["steps_per_sec"] for r in warm)
        out["nccl2_steps_per_s"] = sps
        out["nccl2_same"] = same
        print(f"[data-parallel] {smi} (x {n_cards}): two NCCL ranks on two "
              f"cards through the train CLI, global batch {b}, two runs "
              f"side by side: {sps:.3f} steps/s, {sps * b:.1f} clips/s "
              f"after the first call; {same['records']} loss records and "
              f"{same['checkpoint_entries']} checkpoint entries bit-equal")
    print(f"[data-parallel] {smi}: phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def _dp_check(cfg, overrides, pool, lengths, rh, rw, smi, tmp) -> dict:
    """Two gloo ranks on card 0 (``_dp_rank``) against one process on the
    global batch, at the unchanged DP_* tolerances; returns the figures
    and the ranks' ingest launches (``launches``)."""
    import torch
    import torch.multiprocessing as mp

    b, k = cfg.train.batch_size, cfg.train.steps_per_call
    dev = pool.device
    world = 2
    t0 = time.perf_counter()
    ranks = mp.spawn(_dp_rank, args=(
        world, "file://" + os.path.join(tmp, "dp_store"), overrides, tmp,
        str(dev)), nprocs=world, join=False)
    try:
        while not ranks.join(timeout=5):       # raises if a rank failed
            if time.perf_counter() - t0 > DP_TIMEOUT_S:
                raise TimeoutError(f"the gloo ranks ran past "
                                   f"{DP_TIMEOUT_S} s")
    finally:
        _kill([ranks])
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    ref = _dp_call(cfg, None, dev, pool, lengths, rh, rw)
    for r, res in enumerate(ranks):
        if res["steps"] != k or res["launches"] != k:
            raise AssertionError(f"rank {r}: {res['steps']} steps, "
                                 f"{res['launches']} kernel launches")
    # step 0, from compute_grads and as the first step of the run
    err0 = max(_close(m0, ref["metrics0"], f"rank {r} step 0")
               for r, res in enumerate(ranks)
               for m0 in (res["metrics0"], res["metrics"][0]))
    # later steps: Adam's first update is lr * sign(g), so a gradient
    # element inside the fp32 noise of the two reduction orders may move
    # either way, and the trajectories part; they are not held to the
    # step-0 tolerance (tests/test_parallel.py says the same of JAX's).
    # The one process on its batches in reverse order parts from itself
    # the same way: the control printed beside the ranks' drift.
    control = _steps(cfg, None, dev, pool, lengths, rh, rw, reverse=True)[0]

    def drift_of(runs):
        return [max(abs(mm[i][kk] - v) / max(abs(v), 1e-12)
                    for mm in runs for kk, v in ref["metrics"][i].items())
                for i in range(k)]

    drift = drift_of([res["metrics"] for res in ranks])
    drift_control = drift_of([control])
    if not all(math.isfinite(v) for res in ranks for mm in res["metrics"]
               for v in mm.values()):
        raise AssertionError("non-finite metrics on a rank")
    # at full width the step-0 gradients of some leaves (G's, the Ds'
    # first convs) are ill-conditioned in fp32: one process summing its
    # own batch in reverse order moves them by more than DP_GRAD_TOL of
    # their max. That floor, measured here, bounds the ranks' error too.
    rev = _step0(cfg, None, dev, pool, lengths, rh, rw, reverse=True)[0]

    def grad_err(grads):
        return max(_max_err(grads[name], want)
                   / max(float(want.abs().max()), 1e-3)
                   for name, want in ref["grads"].items())

    floor = grad_err(rev)
    grad_tol = max(DP_GRAD_TOL, DP_FLOOR_FACTOR * floor)
    dp_err = max(grad_err(res["grads"]) for res in ranks)
    bn_err = max(_max_err(res["bn0"][kk], v) for res in ranks
                 for kk, v in ref["bn0"].items())
    if not (dp_err <= grad_tol and bn_err <= DP_BN_TOL):
        raise AssertionError(f"data parallel vs one process: gradients "
                             f"{dp_err:.2e} of the max (tol {grad_tol:.2e}),"
                             f" BN {bn_err:.2e}")
    unequal = [kk for kk, v in ranks[0]["params"].items()
               if not torch.equal(v, ranks[1]["params"][kk])]
    if unequal:
        raise AssertionError(f"params differ across ranks: {unequal[:5]}")
    sps_gloo = [k / res["seconds"] for res in ranks]
    print(f"[data-parallel] {smi}: 2 ranks on card 0 over gloo (global "
          f"batch {b}, {b // 2} a rank) vs one process on the global "
          f"batch: step 0 metrics max rel err {err0:.2e}, "
          f"gradients {dp_err:.2e} of each leaf's max (tol {grad_tol:.2e}:"
          f" the larger of {DP_GRAD_TOL} and {DP_FLOOR_FACTOR} x the "
          f"{floor:.2e} between the one process's batch in order and "
          f"reversed), BN stats {bn_err:.2e} (tol {DP_BN_TOL}); "
          f"metrics' max rel difference from the one process at steps 0.."
          f"{k - 1}: {', '.join(f'{x:.1e}' for x in drift)} (the one "
          f"process on its batches reversed, the control: "
          f"{', '.join(f'{x:.1e}' for x in drift_control)}); "
          f"params bit-equal across the ranks; kernel launches "
          f"{ranks[0]['launches']} + {ranks[1]['launches']} = 2 x {k} steps;"
          f" {k} steps, warm-up included, beside the train-CLI worlds: "
          f"{', '.join(f'{x:.3f}' for x in sps_gloo)} steps/s a rank "
          f"({k / ref['seconds']:.3f} for the one process); the spawned "
          f"ranks took {spawn_s:.1f} s")
    return {"launches": sum(res["launches"] for res in ranks),
            "gloo_steps_per_s": sps_gloo, "metrics_drift": drift,
            "metrics_drift_control": drift_control, "grad_err": dp_err,
            "grad_floor": floor}


def _restore(cfg, run_dir, dev):
    """A fresh state of `cfg` on `dev` holding run_dir's latest
    checkpoint."""
    from mocogan_tpu_torch.train import state as tstate
    from mocogan_tpu_torch.utils.checkpoint import CheckpointManager

    return CheckpointManager(os.path.join(run_dir, "checkpoints")).restore(
        tstate.create(cfg, device=dev))


def _chainer_snapshot(paths, path, step) -> dict:
    """A Chainer Trainer snapshot npz of the exported nets {net: npz}:
    ``updater/model:<group>/...`` per net, one optimizer entry, the
    iteration, a ``/N`` counter per BN layer and non-zero pre-BN biases
    (absorbed on import). Returns the keys the import must absorb, per
    net."""
    import numpy as np

    from mocogan_tpu_torch.eval import import_chainer

    rng = np.random.default_rng(step)
    groups = {"gen": "gen", "di": "image_dis", "dv": "video_dis"}
    entries = {"updater/iteration": np.asarray(step)}
    absorbed = {}
    for net, npz in paths.items():
        with np.load(npz) as f:
            tensors = dict(f)
        extra = {}
        for key in import_chainer._ABSORBED_BY_BN[net]:
            # W is (out, in) for a Linear, (O, I, ...) for a conv and
            # (I, O, ...) for a deconv
            w = tensors[key[:-2] + "/W"]
            n_out = w.shape[1] if key.startswith("dc") else w.shape[0]
            extra[key] = rng.normal(size=n_out).astype(np.float32)
        for key in tensors:
            if key.endswith("/avg_mean"):
                extra[key[:-len("avg_mean")] + "N"] = np.asarray(step)
        absorbed[net] = set(extra)
        for key, v in {**tensors, **extra}.items():
            entries[f"updater/model:{groups[net]}/{key}"] = v
    entries["updater/optimizer:gen/fc/W/m"] = np.zeros_like(
        entries["updater/model:gen/fc/W"])
    np.savez(path, **entries)
    return absorbed


def _sonnet_variables(prefix, seed):
    """({checkpoint variable: array} as the public kinetics-i3d TF
    checkpoint holds them, with an Adam slot and a Flow-tower variable the
    converter must leave, {contract key: array} they convert to)."""
    import numpy as np

    from mocogan_tpu_torch.eval import i3d, i3d_convert

    rng = np.random.default_rng(seed)
    truth = i3d.init_random(seed)                # He-normal kernels
    for key, v in truth.items():                 # BN away from identity
        leaf = key.rsplit("/", 1)[1]
        if leaf in ("beta", "mean"):
            truth[key] = (rng.normal(size=v.shape) * 0.05).astype(np.float32)
        elif leaf == "var":
            truth[key] = (np.abs(rng.normal(size=v.shape)) * 0.1
                          + 0.9).astype(np.float32)
    variables = {}
    for var, key, _ in i3d_convert.variable_map(prefix):
        leaf = key.rsplit("/", 1)[1]
        variables[var] = (truth[key].reshape(1, 1, 1, 1, -1)
                          if leaf in ("beta", "mean", "var") else truth[key])
    w = variables[f"{prefix}/Conv3d_1a_7x7/conv_3d/w"]
    variables[f"{prefix}/Conv3d_1a_7x7/conv_3d/w/Adam"] = np.zeros_like(w)
    variables["Flow/inception_i3d/Conv3d_1a_7x7/conv_3d/w"] = np.zeros(
        (7, 7, 7, 2, 64), np.float32)
    return variables, truth


def _write_avi(path, seed, t=20, size=120):
    """An MJPG AVI of a moving square."""
    import cv2
    import numpy as np

    color = np.random.default_rng(seed).integers(64, 256, size=3).tolist()
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (size, size))
    if not vw.isOpened():
        raise AssertionError(f"cv2 cannot write an MJPG AVI to {path}")
    for ti in range(t):
        f = np.zeros((size, size, 3), np.uint8)
        f[20:70, 4 + 4 * ti:40 + 4 * ti] = color
        vw.write(f)
    vw.release()


def _reference_parity(cfg, run_dir, cfg_cat, run_cat, tmp, dev, smi,
                      n=EVAL_CLIPS) -> dict:
    """Phase 14: export the mug run's state (the latest checkpoint of
    `run_dir`) and the categorical run's, import them back on `dev`
    (a Chainer Trainer snapshot; per-net files), hold the imported nets
    bit-equal to their sources, run the parity and import CLIs, convert a
    Sonnet-shaped I3D variable set, run parity_day at `n` clips, and
    preprocess two AVIs where OpenCV is installed. Returns the kernel's
    launches in parity_day and the stage seconds."""
    import contextlib
    import importlib.util
    import io

    import numpy as np
    import torch

    from mocogan_tpu_torch import parity_day
    from mocogan_tpu_torch.data import clips, preprocess
    from mocogan_tpu_torch.eval import i3d, i3d_convert, import_chainer
    from mocogan_tpu_torch.eval import parity
    from mocogan_tpu_torch.models import discriminators, generator
    from mocogan_tpu_torch.ops import preproc

    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    t_phase = time.perf_counter()
    # ---- export, and import on the card -------------------------------
    src = _restore(cfg, run_dir, dev)
    paths = import_chainer.export_state(src, os.path.join(tmp, "exp"))
    snap = os.path.join(tmp, f"snapshot_iter_{src.step}.npz")
    absorbed = _chainer_snapshot(paths, snap, src.step)
    t0 = time.perf_counter()
    imp, reports = import_chainer.import_experiment(cfg, snapshot_npz=snap,
                                                    device=dev)
    import_s = time.perf_counter() - t0
    if reports["snapshot"] != {"groups": {"gen": "gen", "di": "image_dis",
                                          "dv": "video_dis"},
                               "unmapped": []}:
        raise AssertionError(f"snapshot split: {reports['snapshot']}")
    for net, module in imp.nets.items():
        rep = reports[net]
        got = {a["key"] for a in rep["absorbed"]}
        if rep["missing"] or rep["shape_mismatch"] or rep["unused"] \
                or got != absorbed[net]:
            raise AssertionError(f"{net} import report: {rep}")
        want = src.nets[net].state_dict()
        for key, v in module.state_dict().items():
            if v.device != want[key].device or not torch.equal(v, want[key]):
                raise AssertionError(f"imported {net}.{key} differs from "
                                     f"the source")
    with np.load(paths["gen"]) as f:
        for i in range(4):
            w = getattr(imp.nets["gen"], f"deconv{i}").w.detach().cpu()
            if not np.array_equal(w.numpy(), f[f"dc{i}/W"]):
                raise AssertionError(f"deconv{i}.w is not the npz's dc{i}/W")
    n_params = sum(len(net.state_dict()) for net in imp.nets.values())
    print(f"[reference parity] {smi}: mug step {src.step} exported to "
          f"Chainer layout and imported from a Trainer snapshot on {dev} in "
          f"{import_s:.2f} s: {n_params} parameters and BN buffers "
          f"bit-equal to the source, deconv0..3.w equal to the npz's "
          f"dc0..3/W; absorbed " + json.dumps(
              {kk: len(v) for kk, v in absorbed.items()}) + " pre-BN biases "
          f"and /N counters, 0 missing, 0 unused")

    # ---- the imported nets compute what their sources compute ------------
    m = cfg.model
    x = (torch.rand((8, m.video_length, m.image_size, m.image_size,
                     m.channels), generator=torch.Generator().manual_seed(1))
         * 2 - 1).to(dev)

    def outputs(state, labels=None):
        nets = state.nets
        with torch.no_grad():
            out = {"generate": generator.generate(nets["gen"], 4, seed=3,
                                                  labels=labels),
                   "di": discriminators.image_apply(
                       nets["di"], x.flatten(0, 1), train=False)}
            out["dv"], cls = discriminators.video_apply(nets["dv"], x,
                                                        train=False)
        if cls is not None:
            out["dv_cls"] = cls
        return out

    def same(a, b, what):
        bad = [kk for kk in a if not torch.equal(a[kk], b[kk])]
        if bad:
            raise AssertionError(f"{what}: imported vs source differ in "
                                 f"{bad}")
        return sorted(a)

    checked = same(outputs(imp), outputs(src), "mug")
    src_cat = _restore(cfg_cat, run_cat, dev)
    paths_cat = import_chainer.export_state(src_cat,
                                            os.path.join(tmp, "exp_cat"))
    imp_cat, rep_cat = import_chainer.import_experiment(
        cfg_cat, gen_npz=paths_cat["gen"], di_npz=paths_cat["di"],
        dv_npz=paths_cat["dv"], device=dev)
    if any(r["missing"] or r["unused"] for r in rep_cat.values()):
        raise AssertionError(f"categorical import: {rep_cat}")
    lab = torch.tensor([0, 5, 2, 3])
    checked_cat = same(outputs(imp_cat, lab), outputs(src_cat, lab),
                       "categorical")
    print(f"[reference parity] {smi}: imported vs source bit-equal: mug {checked} (generate(seed=3) of 4 "
          f"clips, D_I on the 128 frames and D_V on 8 fixed clips); "
          f"categorical step {src_cat.step} {checked_cat} (labels "
          f"{lab.tolist()}, fc_cls)")
    del imp_cat, src_cat

    # ---- the CLIs ----------------------------------------------------------
    common = ["--config", "mug", "--n", "4", "--seed", "0", *dev_args]
    by_npz = parity.main([*common, "--reference-npz", paths["gen"]])
    by_run = parity.main([*common, "--run-dir", run_dir])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        by_imp = import_chainer.main([*common, "--snapshot-npz", snap,
                                      "--digest"])
    print(f"[import CLI] {printed.getvalue().strip().splitlines()[-1]}")
    if not (by_npz["deterministic"]
            and by_npz["digest"] == by_run["digest"] == by_imp["digest"]):
        raise AssertionError(f"digests: --reference-npz {by_npz}, --run-dir "
                             f"{by_run}, import CLI {by_imp['digest']}")
    print(f"[reference parity] {smi}: parity CLI --reference-npz gen.npz and "
          f"--run-dir <mug run> give one digest ({by_npz['digest'][:16]}, n "
          f"4, seed 0), as does the import CLI's --snapshot-npz --digest")

    # ---- I3D conversion without TensorFlow -------------------------------
    prefix = "RGB/inception_i3d"
    if importlib.util.find_spec("tensorflow") is None:
        try:
            i3d_convert.convert(os.path.join(tmp, "no_ckpt"))
        except ImportError as e:
            if "TensorFlow" not in str(e):
                raise
            print(f"[reference parity] no TensorFlow here: the checkpoint "
                  f"reader is a host tool (convert raised ImportError: "
                  f"{e})")
        else:
            raise AssertionError("convert ran without TensorFlow")
    else:
        print("[reference parity] TensorFlow is installed here: the "
              "converter's ImportError path does not apply")
    variables, truth = _sonnet_variables(prefix, seed=1)
    weights, rep_i3d = i3d_convert.convert_variables(variables)
    if rep_i3d["unused"] != sorted(set(variables) - {
            v for v, _, _ in i3d_convert.variable_map(prefix)}) or any(
                not np.array_equal(weights[kk], v) for kk, v in truth.items()):
        raise AssertionError(f"convert_variables: {rep_i3d['unused']}")
    i3d_npz = os.path.join(tmp, "i3d_converted.npz")
    i3d_convert.save_npz(weights, i3d_npz)          # re-validated on load
    clip = (torch.rand((1, 16, 224, 224, 3),
                       generator=torch.Generator().manual_seed(2)) * 2 - 1)
    ex = i3d.I3DExtractor(i3d_npz, features="logits", resize_to=None,
                          device=dev)
    card = ex(clip.to(dev)).cpu()
    with torch.no_grad():
        cpu = i3d.apply(i3d.to_torch(i3d.load_npz(i3d_npz), "cpu"), clip,
                        "logits")
    i3d_rel = _max_err(card, cpu) / float(cpu.abs().max())
    print(f"[reference parity] {smi}: a Sonnet-shaped I3D variable set "
          f"({len(variables)} variables, {len(rep_i3d['unused'])} unused: "
          f"{rep_i3d['unused']}) -> convert_variables -> npz -> load_npz; "
          f"its logits on one 224x224x16 clip, {dev} vs CPU: max err / max "
          f"|logit| {i3d_rel:.2e} (tol {I3D_TOL})")
    if not i3d_rel <= I3D_TOL:
        raise AssertionError(f"converted I3D {dev} vs CPU: {i3d_rel}")

    # ---- parity_day --------------------------------------------------------
    our_log = os.path.join(run_dir, "log.jsonl")
    ref_log = os.path.join(tmp, "reference_log.jsonl")
    with open(our_log) as f, open(ref_log, "w") as out:
        for line in f:
            r = json.loads(line)
            out.write(json.dumps({kk: v + 0.01 if kk.startswith("loss")
                                  else v for kk, v in r.items()}) + "\n")
    preproc.LAUNCHES["resize_norm"] = 0
    t0 = time.perf_counter()
    summary = parity_day.main([
        "--config", "mug", "--snapshot-npz", snap, "--i3d-weights", i3d_npz,
        "--data-dir", cfg.data.data_dir, "--run-dir", run_dir,
        "--our-log", our_log, "--reference-log", ref_log, "--n", str(n),
        "--out", os.path.join(tmp, "parity_day"), *dev_args])
    pd_s = time.perf_counter() - t0
    launches = preproc.LAUNCHES["resize_norm"]
    st = summary["stages"]
    scores = st.get("fvd", {}).get("scores", {})
    if set(st) != {"import", "digest", "fvd", "compare"} \
            or set(scores) != {"reference_vs_real", "ours_vs_real",
                               "ours_vs_reference"} \
            or not all(math.isfinite(v) for v in scores.values()) \
            or not abs(scores["ours_vs_reference"]) \
            <= 1e-3 * scores["ours_vs_real"] \
            or st["digest"] != parity.check_determinism(imp.nets["gen"],
                                                        n=2, seed=0):
        raise AssertionError(f"parity_day: {summary}")
    if launches != 1:
        raise AssertionError(f"parity_day: {launches} kernel launches for "
                             f"one real-clip pool")
    print(f"[reference parity] {smi}: parity_day at n {n} in {pd_s:.2f} s "
          f"(stage seconds " + json.dumps(
              {kk: round(v, 3) for kk, v in summary["seconds"].items()})
          + f"): I3D-FVD {json.dumps(scores)} (ours_vs_reference <= 1e-3 x "
          f"ours_vs_real: the reference is the run's own export), "
          f"comparator max_nabc {st['compare']['max_nabc']}; kernel "
          f"launches {launches} (one real-clip pool, B {n})")

    # ---- preprocessing, a host tool where OpenCV is missing ----------------
    if importlib.util.find_spec("cv2") is None:
        print("[reference parity] no OpenCV here: preprocessing "
              "(mocogan_tpu_torch.data.preprocess) is a host tool; its "
              "store is copied to the card's machine")
    else:
        raw = os.path.join(tmp, "raw_videos")
        for i, cls in enumerate(("walk", "run")):
            os.makedirs(os.path.join(raw, cls))
            _write_avi(os.path.join(raw, cls, "v0.avi"), i)
        store = os.path.join(tmp, "store_preprocessed")
        n_clips = preprocess.main(["--src", raw, "--out", store,
                                   "--raw-size", "96"])
        ds = clips.ClipDataset(store, m.video_length)
        if n_clips != 2 or len(ds) != 2 or ds.n_classes != 2:
            raise AssertionError(f"preprocess: {n_clips} clips, {len(ds)} "
                                 f"in the store")
        print(f"[reference parity] preprocess CLI: 2 MJPG AVIs in 2 class "
              f"dirs -> {n_clips} uint8 clips at 96 px, loaded by "
              f"ClipDataset ({ds.n_classes} classes)")
    print(f"[reference parity] {smi}: phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "seconds": summary["seconds"],
            "parity_day_s": pd_s, "fvd": scores, "i3d_rel_err": i3d_rel}


def _timers(sps: float, smi: str) -> dict:
    """Phase 15: the timers at full width, each in a fresh child process
    under the benchmark's watchdog (``mocogan_tpu_torch.bench.run_stage``),
    TF32 off; then the ingest kernel's check and generate() parity in
    their own stages. Returns the results and the timers' kernel launches
    (``launches``). Any stage that is not ok raises."""
    import torch

    from mocogan_tpu_torch import bench

    if os.environ.get("BENCH_OVERRIDES"):
        raise AssertionError("BENCH_OVERRIDES is set: the bench stages would "
                             "run at its geometry, not at full width")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    budget = bench.Budget(TIMER_BUDGET_S)
    diag: dict = {}
    bf16 = {"dtype": "bfloat16", "batch_size": 32,
            "overrides": {"train.label_smoothing": 0.1}}
    # name -> (stage, its arguments, {timer: (windows, kernel launches)});
    # a generate stage's timers are its sizes
    runs = {
        "mug_fp32_single_step": (
            "train", {"dtype": "float32", "steps": 50, "warmup": 6,
                      "windows": 3}, {"": (3, 0)}),
        "mug_fp32_cached_scan": (
            "scan", {"dtype": "float32", "k": 16, "reps": 4, "n_clips": 64,
                     "windows": 3}, {"": (3, 16 * (1 + 4 * 3))}),
        "mug_fp32_generate": (
            "generate", {"sizes": [16, 64], "reps": 10, "windows": 3},
            {"16": (3, 0), "64": (3, 0)}),
        "bf16_recipe_cached_scan": (
            "scan", {**bf16, "k": 16, "reps": 4, "n_clips": 64,
                     "windows": 3}, {"": (3, 16 * (1 + 4 * 3))}),
        "scaled_cached_scan": (
            "scaled", {"batch_size": 64, "k": 32, "reps": 1, "n_clips": 32,
                       "windows": 2}, {"": (2, 32 * (1 + 1 * 2))}),
        "kernel_verify": ("kernel_verify", {}, {}),
        "parity": ("parity", {}, {}),
    }
    out, launches = {}, 0
    for what, (stage, args, timers) in runs.items():
        r = bench.run_stage(stage, {**args, "tf32": "off"}, budget, diag,
                            what)
        if r is None:
            raise AssertionError(f"bench stage {what}: {diag[what]}")
        took, got = diag[what]["seconds"], r["kernel_launches"]
        work = r["seconds_in_stage"]
        peak = r["max_memory_allocated"] / 1e9
        if r["tf32"] != {"mode": "off", "matmul": False, "cudnn": False}:
            raise AssertionError(f"bench stage {what}: TF32 {r['tf32']}")
        for sub, (windows, want) in timers.items():
            t = r["clips_per_sec"][sub] if sub else r
            name = f"{what}_{sub}" if sub else what
            unit = "clips/s" if sub else "steps/s"
            print(f"[timers] {smi}: {name} {unit} median {t['median']:.3f}, "
                  f"best {t['best']:.3f}, windows {t['windows']}; kernel "
                  f"launches {got}; peak memory {peak:.2f} GB; {took:.1f} s "
                  f"in a fresh process, {work:.1f} s of it in the stage")
            if not (all(math.isfinite(x) and x > 0 for x in
                        (t["best"], t["median"], *t["windows"]))
                    and t["best"] >= t["median"]
                    and len(t["windows"]) == windows):
                raise AssertionError(f"timer {name}: {t}")
            if got != want:
                raise AssertionError(f"timer {name}: {got} kernel launches, "
                                     f"want {want}")
            out[name] = {"best": t["best"], "median": t["median"],
                         "windows": t["windows"], "seconds": took,
                         "stage_seconds": work, "peak_gb": peak}
        if timers:
            launches += got
        else:
            out[what] = {**r, "seconds": took}
    # the check launches the kernel once a layout to compare it with its
    # plain version: those launches are not the path's
    kv, par = out["kernel_verify"], out["parity"]
    print(f"[timers] {smi}: kernel_verify max_abs_err mug "
          f"{kv['max_abs_err_mug']:.3e}, scaled {kv['max_abs_err_scaled']:.3e}"
          f" (tol {KERNEL_TOL}), {kv['kernel_launches']} launches; parity "
          f"digest {par['digest'][:16]}, two calls bit-equal "
          f"{par['deterministic']}, card vs CPU max_abs_err "
          f"{par['max_abs_err_vs_cpu']:.3e} (tol {GENERATE_TOL}); "
          f"{kv['seconds']:.1f} s and {par['seconds']:.1f} s in fresh "
          f"processes, {kv['seconds_in_stage']:.1f} s and "
          f"{par['seconds_in_stage']:.1f} s of them in the stages (the "
          f"CPU rerun {par['cpu_rerun_seconds']:.1f} s)")
    if not (kv["verified"] and kv["max_abs_err"] <= KERNEL_TOL
            and kv["kernel_launches"] == 2):
        raise AssertionError(f"bench stage kernel_verify: {kv}")
    if not (par["deterministic"] and par["kernel_launches"] == 0
            and par["max_abs_err_vs_cpu"] <= GENERATE_TOL):
        raise AssertionError(f"bench stage parity: {par}")
    ratio = out["mug_fp32_cached_scan"]["median"] / sps
    secs = time.perf_counter() - t_phase
    print(f"[timers] mug fp32 scan median / phase 4's trainer {sps:.3f} "
          f"steps/s = {ratio:.3f} (must lie in 0.5-2); phase took "
          f"{secs:.1f} s")
    if not 0.5 <= ratio <= 2.0:
        raise AssertionError(f"mug fp32 scan median {ratio:.3f} x phase 4's "
                             f"steps/s")
    return {**out, "phase_seconds": secs, "launches": launches}


def _determinism(store, cat_dir, sc_dir, pool, lengths, smi, dev,
                 tmp) -> dict:
    """Phase 16: training repeats bit for bit from its seed. Two fresh
    train-CLI processes per mode (mug fp32, device-cached and host-fed,
    DET_STEPS steps, one seed, TF32 as the CLI leaves it), a run resumed
    from step 32, and two one-rank NCCL worlds in torchrun's environment
    with cached_a's args, side by side on the card, then compared by
    ``_same_runs`` (each NCCL run also against cached_a); two calls each,
    from equal states, of the sequential order, the categorical model, the
    bf16 recipe and `scaled` in this process. Returns the comparisons and
    the ingest launches of the in-process calls and the CLI processes
    (``launches``), each process's checked against its steps."""
    import torch

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.data import clips
    from mocogan_tpu_torch.ops import preproc
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.train import step as train_step

    t_phase = time.perf_counter()
    k = get_config("mug").train.steps_per_call

    def args(steps, *extra):
        return ["--config", "mug", "--data-dir", store, "--seed",
                str(DET_SEED), "--total-steps", str(steps),
                "--set", f"train.log_every={k}",
                f"train.checkpoint_every={k}", *extra]

    jobs = {"cached_a": args(DET_STEPS), "cached_b": args(DET_STEPS),
            "host_fed_a": args(DET_STEPS, "data.device_cache=false"),
            "host_fed_b": args(DET_STEPS, "data.device_cache=false"),
            "resumed": args(DET_STEPS - k),
            "nccl1_a": args(DET_STEPS), "nccl1_b": args(DET_STEPS)}
    dirs = {name: os.path.join(tmp, f"det_{name}") for name in jobs}
    # a one-rank NCCL world, as torchrun starts it: every collective is an
    # identity, so the run must be the plain process's bit for bit
    env = {name: {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                  "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                  "MASTER_PORT": str(_free_port())}
           for name in jobs if name.startswith("nccl1")}
    procs = {name: _start_cli(a, dirs[name], env.get(name))
             for name, a in jobs.items()}
    cli_launches = 0
    try:
        # the resumed run's second process starts when its first one ends
        cli_launches += _finish_cli(procs["resumed"], jobs["resumed"],
                                    dirs["resumed"], DET_STEPS - k)[1]
        procs["resumed"] = _start_cli(args(DET_STEPS), dirs["resumed"])
        for name, p in procs.items():
            if name != "resumed":
                cli_launches += _finish_cli(p, jobs[name], dirs[name],
                                            DET_STEPS)[1]
        cli_launches += _finish_cli(procs["resumed"], args(DET_STEPS),
                                    dirs["resumed"], k)[1]
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    cli = {"device_cached": _same_runs(dirs["cached_a"], dirs["cached_b"],
                                       DET_STEPS),
           "host_fed": _same_runs(dirs["host_fed_a"], dirs["host_fed_b"],
                                  DET_STEPS),
           "resumed_vs_straight": _same_runs(dirs["resumed"],
                                             dirs["cached_a"], DET_STEPS),
           "nccl_one_rank": _same_runs(dirs["nccl1_a"], dirs["nccl1_b"],
                                       DET_STEPS),
           "nccl_one_rank_vs_plain": _same_runs(dirs["nccl1_a"],
                                                dirs["cached_a"], DET_STEPS)}
    cli_s = time.perf_counter() - t_phase
    for what, r in cli.items():
        print(f"[determinism] {smi}: train CLI mug fp32 {what}, seed "
              f"{DET_SEED}, {DET_STEPS} steps: {r['records']} loss records "
              f"and {r['checkpoint_entries']} checkpoint entries bit-equal; "
              f"compare_runs nabc " + json.dumps(r["nabc"]))

    pool_cat, lengths_cat, labels_cat = clips.load_pool(cat_dir)
    pool_sc, lengths_sc, _ = clips.load_pool(sc_dir)
    variants = {
        "sequential": (get_config("mug", **{
            "train.update_order": "sequential"}), pool, lengths, None),
        "categorical": (get_config("categorical"),
                        torch.from_numpy(pool_cat).to(dev),
                        torch.from_numpy(lengths_cat),
                        torch.from_numpy(labels_cat)),
        "bf16": (get_config("mug", **{
            "train.batch_size": 32, "model.compute_dtype": "bfloat16",
            "train.label_smoothing": 0.1}), pool, lengths, None),
        "scaled": (get_config("scaled", **{"train.num_devices": 1}),
                   torch.from_numpy(pool_sc).to(dev),
                   torch.from_numpy(lengths_sc), None),
    }
    del pool_cat, pool_sc
    preproc.LAUNCHES["resize_norm"] = 0
    want, out = 0, {}
    for what, (cfg, pool_, lengths_, labels_) in variants.items():
        t0 = time.perf_counter()
        kv = cfg.train.steps_per_call
        rh, rw = preproc.resize_weights(pool_.shape[2], pool_.shape[3],
                                        cfg.model.image_size, dev)
        runs = []
        for _ in range(2):
            st = train_state.create(cfg, device=dev)
            m = train_step.cached_multi_train_step(st, pool_, lengths_, kv,
                                                   rh, rw, labels=labels_)
            runs.append((m, [t.clone() for t in
                             train_state.state_tensors(st)]))
            del st
        (m1, t1), (m2, t2) = runs
        if set(m1) != set(m2) or not all(torch.equal(m1[kk], m2[kk])
                                         for kk in m1):
            raise AssertionError(f"{what}: metrics of two calls differ: "
                                 f"{m1} vs {m2}")
        bad = [i for i, (a, b) in enumerate(zip(t1, t2))
               if not torch.equal(a, b)]
        if len(t1) != len(t2) or bad:
            raise AssertionError(f"{what}: {len(bad)} of {len(t1)} state "
                                 f"tensors differ between two calls")
        want += 2 * kv
        out[what] = {"k": kv, "state_tensors": len(t1),
                     "seconds": time.perf_counter() - t0}
        print(f"[determinism] {smi}: {what} ({cfg.model.compute_dtype}, "
              f"remat {cfg.model.remat}, {cfg.train.update_order}, batch "
              f"{cfg.train.batch_size}), two calls of k {kv} from equal "
              f"states, TF32 off: metrics and {len(t1)} state tensors "
              f"(params, BN stats, Adam moments) bit-equal; "
              f"{out[what]['seconds']:.1f} s")
        del runs, t1, t2
    del variants
    launches = preproc.LAUNCHES["resize_norm"]
    if launches != want:
        raise AssertionError(f"determinism: {launches} kernel launches, "
                             f"want {want}")
    secs = time.perf_counter() - t_phase
    print(f"[determinism] {smi}: ingest kernel launches {launches} in the "
          f"in-process calls and {cli_launches} in the {len(jobs) + 1} "
          f"train-CLI processes (one a step in each); train CLI runs "
          f"{cli_s:.1f} s; phase took {secs:.1f} s")
    return {"cli": cli, "variants": out,
            "launches": launches + cli_launches, "cli_seconds": cli_s,
            "seconds": secs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mocogan_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from mocogan_tpu_torch import eval_fvd as eval_fvd_cli
    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch import sample as sample_cli
    from mocogan_tpu_torch.data import clips, synthetic
    from mocogan_tpu_torch.eval import i3d, parity
    from mocogan_tpu_torch.eval.panel import PanelRunner
    from mocogan_tpu_torch.models import discriminators, generator
    from mocogan_tpu_torch.ops import preproc
    from mocogan_tpu_torch.train.loop import Trainer, eval_windows
    from mocogan_tpu_torch.utils import cuda_build

    # ---- 1. the card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build -------------------------------------------------------
    _, rec = cuda_build.load("resize_norm")
    print(f"[build] resize_norm.cu in {rec['seconds']:.2f} s -> "
          f"{os.path.relpath(rec['path'], ROOT)}")
    for line in rec["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        k = get_config("mug").train.steps_per_call
        # the panel runs once, at the last step, after the last log window
        cfg = get_config("mug", **{
            "data.data_dir": os.path.join(tmp, "store"),
            "train.log_every": k, "train.eval_every": TRAIN_CALLS * k,
            "train.eval_clips": EVAL_CLIPS})
        m, b = cfg.model, cfg.train.batch_size
        t0 = time.perf_counter()
        synthetic.write_store(cfg.data.data_dir, clips=96, frames=32,
                              size=cfg.data.raw_size)
        pool_np, lengths_np, _ = clips.load_pool(cfg.data.data_dir)
        print(f"[data] {pool_np.shape} uint8 store, {pool_np.nbytes / 1e6:.1f}"
              f" MB, rendered in {time.perf_counter() - t0:.1f} s")

        # ---- 3. kernel vs plain at the mug and eval-pool layouts ----------
        pool = torch.from_numpy(pool_np).to(dev)
        lengths = torch.from_numpy(lengths_np)
        h, w, c = pool.shape[2:]
        s = m.image_size
        rh, rw = preproc.resize_weights(h, w, s, dev)
        rates = RATES.get(smi.rsplit(",", 1)[0].strip())
        # 8 plans: ~57 MB of frames, more than L2
        plans = _plans(lengths, 8, b, m.video_length, dev)
        lay_mug = _layout(pool, plans, rh, rw, s, rates,
                          f"mug layout (B {b}, T {m.video_length}, "
                          f"{h} -> {s} px)")

        # the device-cached eval pool's layout: EVAL_CLIPS windows drawn
        # with replacement (the trainer's draws), one launch; also the
        # layout of eval_fvd's and parity_day's real-clip pools
        ev_sel, ev_frames = eval_windows(lengths_np, EVAL_CLIPS,
                                         m.video_length)
        ev_ix = (torch.from_numpy(ev_sel).to(dev, torch.int32),
                 torch.from_numpy(ev_frames).to(dev, torch.int32))
        lay_ev = _layout(pool, [ev_ix], rh, rw, s, rates,
                         f"eval-pool layout (B {EVAL_CLIPS}, T "
                         f"{m.video_length}, {h} -> {s} px)")

        # ---- 4. train the full-width mug model, device-cached --------------
        trainer = Trainer(cfg, out_dir=os.path.join(tmp, "run"), device=dev)
        preproc.LAUNCHES["resize_norm"] = 0
        t0 = time.perf_counter()
        trainer.run_device_cached(total_steps=TRAIN_CALLS * k)
        train_s = time.perf_counter() - t0
        launches_dc = preproc.LAUNCHES["resize_norm"]

        steps = trainer.state.step
        ev_dc = trainer.eval_pool_launches
        recs = trainer.logger.history
        if steps != TRAIN_CALLS * k or ev_dc != 1 \
                or launches_dc != steps + ev_dc:
            raise AssertionError(f"{steps} steps, {launches_dc} kernel "
                                 f"launches, {ev_dc} for the eval pool")
        _check_losses(recs)
        _check_panels(recs, [steps], "device-cached")
        warm = [r for r in recs if "steps_per_sec" in r][1:]
        sps = len(warm) * k / sum(k / r["steps_per_sec"] for r in warm)
        print(f"[train] {smi}: device-cached mug fp32 batch {b}, k {k}: "
              f"{steps} steps in {train_s:.2f} s; {sps:.3f} steps/s after "
              f"the first call; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        print(f"[train] last losses " + json.dumps(
            {kk: v for kk, v in warm[-1].items() if kk.startswith("loss")}))
        print(f"[train] kernel launches {launches_dc} = {steps} steps + "
              f"{ev_dc} eval pool")
        # the panel again, warm, on the same 256 windows
        ev_pool = preproc.resize_normalize_gather_cuda(pool, *ev_ix, rh, rw)
        panel_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.eval_metrics(ev_pool)      # ends in a host copy
            panel_s.append(time.perf_counter() - t0)
        print(f"[eval] panel at n {EVAL_CLIPS}, warm: "
              f"{', '.join(f'{x:.3f}' for x in panel_s)} s; at {sps:.3f} "
              f"steps/s a 1000-step interval takes {1000 / sps:.1f} s, so "
              f"one panel per 1000 steps stalls "
              f"{100 * min(panel_s) * sps / 1000:.3f} %")

        # ---- 5. the host-fed path -------------------------------------------
        cfg_hf = get_config("mug", **{
            "data.data_dir": cfg.data.data_dir, "data.device_cache": False,
            "train.log_every": k, "train.checkpoint_every": 2 * k,
            "train.sample_every": 2 * k, "train.eval_every": 2 * k,
            "train.eval_clips": EVAL_CLIPS})
        # the kernel on the host-fed layout: the stack of k uploaded
        # batches is the pool, and step j reads clips j*B .. j*B + B - 1
        it = clips.clip_batch_iterator(cfg_hf, use_native=True)
        stack = torch.from_numpy(
            np.stack([next(it)["raw"] for _ in range(k)])).to(dev)
        j = k - 1
        err_hf = _check_kernel(
            stack.view(k * b, *stack.shape[2:]),
            torch.arange(j * b, (j + 1) * b, dtype=torch.int32, device=dev),
            torch.arange(m.video_length, dtype=torch.int32,
                         device=dev).expand(b, -1).contiguous(),
            rh, rw, f"host-fed (stack {tuple(stack.shape)}, step {j})")
        del stack, it

        run_hf = os.path.join(tmp, "run_hf")
        trainer_hf = Trainer(cfg_hf, out_dir=run_hf, device=dev)
        preproc.LAUNCHES["resize_norm"] = 0
        t0 = time.perf_counter()
        trainer_hf.run(clips.clip_batch_iterator(cfg_hf, use_native=True),
                       total_steps=HOST_FED_CALLS * k)
        hf_s = time.perf_counter() - t0
        launches_hf = preproc.LAUNCHES["resize_norm"]
        steps_hf = trainer_hf.state.step
        ev_hf = trainer_hf.eval_pool_launches
        if steps_hf != HOST_FED_CALLS * k or ev_hf != 1 \
                or launches_hf != steps_hf + ev_hf:
            raise AssertionError(f"host-fed: {steps_hf} steps, {launches_hf}"
                                 f" kernel launches, {ev_hf} for the eval "
                                 f"pool")
        _check_losses(trainer_hf.logger.history)
        _check_panels(trainer_hf.logger.history, [2 * k], "host-fed")
        recs_hf = [r for r in trainer_hf.logger.history
                   if "steps_per_sec" in r]
        save = trainer_hf.ckpt.last_save
        print(f"[host-fed] {smi}: mug fp32 batch {b}, k {k}: {steps_hf} "
              f"steps in "
              f"{hf_s:.2f} s; call 2: {recs_hf[1]['steps_per_sec']:.3f} "
              f"steps/s, call 3 (its window holds the step-{2 * k} "
              f"checkpoint, sample grid and panel): "
              f"{recs_hf[2]['steps_per_sec']:.3f} steps/s; device-cached "
              f"{sps:.3f} steps/s after the first call")
        print(f"[host-fed] the consumer waited "
              f"{trainer_hf.prefetch_wait_s:.3f} s for the prefetch thread "
              f"in {hf_s:.2f} s; one checkpoint save (step {save['step']}): "
              f"{save['seconds']:.3f} s, {save['bytes'] / 1e6:.1f} MB")
        samples = sorted(os.listdir(os.path.join(run_hf, "samples")))
        if len(samples) != 2:
            raise AssertionError(f"sample grids: {samples}")

        # resume: a fresh trainer restores step 48 and trains one more call
        trainer_r = Trainer(cfg_hf, out_dir=run_hf, device=dev)
        if trainer_r.state.step != steps_hf:
            raise AssertionError(f"resumed at {trainer_r.state.step}, "
                                 f"saved {steps_hf}")
        preproc.LAUNCHES["resize_norm"] = 0
        trainer_r.run(clips.clip_batch_iterator(
            cfg_hf, use_native=True, start_batch=steps_hf),
            total_steps=steps_hf + k)
        launches_r = preproc.LAUNCHES["resize_norm"]
        ev_r = trainer_r.eval_pool_launches
        if trainer_r.state.step != steps_hf + k or ev_r != 1 \
                or launches_r != k + ev_r:
            raise AssertionError(f"resumed run: step {trainer_r.state.step},"
                                 f" {launches_r} kernel launches")
        _check_losses(trainer_r.logger.history)
        _check_panels([r for r in trainer_r.logger.history
                       if r["step"] > steps_hf], [steps_hf + k],
                      "host-fed resumed")
        print(f"[resume] restored step {steps_hf}, trained to "
              f"{trainer_r.state.step} ({launches_r} launches); last losses "
              + json.dumps({kk: v for kk, v in
                            [r for r in trainer_r.logger.history
                             if "loss_gen" in r][-1].items()
                            if kk.startswith("loss")}))

        # sample from the checkpoint with the generate CLI
        grid, vids_cli = sample_cli.main(
            ["--config", "mug", "--run-dir", run_hf, "--n", "16", "--seed",
             "5", "--out", os.path.join(run_hf, "grid.gif")])
        if not (os.path.getsize(grid) > 0
                and tuple(vids_cli.shape) == (16, m.video_length, s, s,
                                              m.channels)
                and torch.isfinite(vids_cli).all()
                and vids_cli.abs().max() <= 1.0):
            raise AssertionError(f"generate CLI: {grid}, "
                                 f"{tuple(vids_cli.shape)}")
        print(f"[generate-cli] step {trainer_r.state.step} -> "
              f"{os.path.relpath(grid, tmp)} ({os.path.getsize(grid)} "
              f"bytes); clips {tuple(vids_cli.shape)} in [-1, 1]")

        # ---- 6. eval on the card against the CPU -------------------------------
        g, dv = trainer.state.nets["gen"], trainer.state.nets["dv"]
        runner = trainer._panel_runner()
        vids8 = generator.generate_chunked_device(g, 8, seed=7)
        raw_card = runner.metrics(vids8, ev_pool[:8], dv)
        g_cpu = generator.init(m, torch.Generator()).eval()
        g_cpu.load_state_dict({kk: v.cpu() for kk, v in g.state_dict().items()})
        dv_cpu = discriminators.video_init(m, torch.Generator())
        dv_cpu.load_state_dict({kk: v.cpu()
                                for kk, v in dv.state_dict().items()})
        runner_cpu = PanelRunner(cfg, device="cpu")
        if runner_cpu.fingerprint != runner.fingerprint:
            raise AssertionError("the extractor differs on the CPU")
        raw_cpu = runner_cpu.metrics(vids8.cpu(), ev_pool[:8].cpu(), dv_cpu)
        panel_err = {kk: _max_err(raw_card[kk], raw_cpu[kk])
                     for kk in raw_card}
        print(f"[eval] panel raw outputs card vs CPU on 8 clips (max abs "
              f"err, tol {PANEL_TOL}): " + json.dumps(
                  {kk: f"{v:.2e}" for kk, v in panel_err.items()}))
        if not max(panel_err.values()) <= PANEL_TOL:
            raise AssertionError(f"panel card vs CPU: {panel_err}")

        ex = i3d.I3DExtractor(None, features="pool", resize_to=None,
                              device=dev)
        params_cpu = i3d.to_torch(ex.jax_params(), "cpu")
        clip = torch.rand((1, 16, 224, 224, 3),
                          generator=torch.Generator().manual_seed(0)) * 2 - 1
        i3d_card = {"pool": ex(clip.to(dev))}
        ex.features = "logits"
        i3d_card["logits"] = ex(clip.to(dev))
        with torch.no_grad():     # one CPU trunk; logits = pool @ W + b
            i3d_cpu = {"pool": i3d.apply(params_cpu, clip, "pool")}
        i3d_cpu["logits"] = (i3d_cpu["pool"]
                             @ params_cpu["Logits/Conv3d_0c_1x1/w"]
                             + params_cpu["Logits/Conv3d_0c_1x1/b"])
        i3d_rel = {kk: _max_err(i3d_card[kk], v) / float(v.abs().max())
                   for kk, v in i3d_cpu.items()}
        # a long device-bound call: events around 3 back-to-back calls
        clips32 = torch.rand((32, 16, 224, 224, 3), device=dev) * 2 - 1
        ex(clips32)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(3):
            ex(clips32)
        ev[1].record()
        torch.cuda.synchronize()
        i3d_ms = ev[0].elapsed_time(ev[1]) / 3
        del clips32
        print(f"[eval] I3D on one 224x224x16 clip, random weights, card vs "
              f"CPU (max err / max |value|, tol {I3D_TOL}): pool "
              f"{i3d_rel['pool']:.2e}, logits {i3d_rel['logits']:.2e}; "
              f"I3D logits at batch 32: {i3d_ms / 32:.3f} device ms per "
              f"clip")
        if not max(i3d_rel.values()) <= I3D_TOL:
            raise AssertionError(f"I3D card vs CPU: {i3d_rel}")

        # ---- 7. the eval CLIs on the resumed run ---------------------------
        preproc.LAUNCHES["resize_norm"] = 0
        t0 = time.perf_counter()
        rec_fvd = eval_fvd_cli.main(
            ["--config", "mug", "--run-dir", run_hf, "--data-dir",
             cfg.data.data_dir, "--n", str(EVAL_CLIPS)])
        fvd_s = time.perf_counter() - t0
        npz = os.path.join(tmp, "i3d_random.npz")
        np.savez(npz, **i3d.init_random(0))
        t0 = time.perf_counter()
        rec_i3d = eval_fvd_cli.main(
            ["--config", "mug", "--run-dir", run_hf, "--data-dir",
             cfg.data.data_dir, "--n", "32", "--i3d-weights", npz])
        i3d_fvd_s = time.perf_counter() - t0
        ev_cli = preproc.LAUNCHES["resize_norm"]
        if not (ev_cli == 2 and math.isfinite(rec_fvd["fvd_proxy"])
                and math.isfinite(rec_i3d["fvd"])
                and rec_fvd["n"] == EVAL_CLIPS):
            raise AssertionError(f"eval_fvd: {rec_fvd}, {rec_i3d}, "
                                 f"{ev_cli} kernel launches")
        print(f"[eval-fvd] step {trainer_r.state.step} vs the store: "
              f"random projection n {EVAL_CLIPS} in {fvd_s:.2f} s, I3D "
              f"(random npz, n 32 at 224 px) in {i3d_fvd_s:.2f} s; "
              f"{ev_cli} kernel launches (one real-clip pool each)")

        rec_path = os.path.join(tmp, "digest.json")
        reps = [parity.main(["--config", "mug", "--run-dir", run_hf,
                             "--record", rec_path]) for _ in range(2)]
        if not (all(r["deterministic"] and r["chunked_matches_generate"]
                    for r in reps) and reps[1]["record_matches"]):
            raise AssertionError(f"parity: {reps}")
        g_r = trainer_r.state.nets["gen"]
        twice = [generator.generate(g_r, 4, seed=0) for _ in range(2)]
        if not torch.equal(*twice):
            raise AssertionError("two generate() calls differ")
        print(f"[parity] deterministic: true twice, record matches "
              f"({reps[1]['digest'][:12]}); two generate() calls outside "
              f"the parity CLI bit-equal")

        # ---- 8. generate ---------------------------------------------------------
        vids = generator.generate(g, 16, seed=1)
        if tuple(vids.shape) != (16, m.video_length, s, s, m.channels):
            raise AssertionError(f"generate shape {tuple(vids.shape)}")
        if not (torch.isfinite(vids).all() and vids.abs().max() <= 1.0):
            raise AssertionError("generate output outside [-1, 1]")
        on_card = generator.generate(g, 2, seed=3).cpu()
        on_cpu = generator.generate(g_cpu, 2, seed=3)
        gen_err = float((on_card - on_cpu).abs().max())
        print(f"[generate] (16, {m.video_length}, {s}, {s}, {m.channels}) in "
              f"[-1, 1]; generate(seed=3) card vs CPU max_abs_err "
              f"{gen_err:.3e} (tol {GENERATE_TOL})")
        if not gen_err <= GENERATE_TOL:
            raise AssertionError(f"generate card vs CPU: {gen_err}")

        # ---- 9. the categorical model -------------------------------------
        cat_dir = synthetic.write_store(os.path.join(tmp, "store_cat"),
                                        clips=96, frames=32, size=96,
                                        classes=6)
        cat = {"data.data_dir": cat_dir, "train.log_every": k}
        cfg_cat = get_config("categorical", **cat, **{
            "train.eval_every": 2 * k, "train.eval_clips": EVAL_CLIPS})
        tr_cat, v_cat = _train_variant(
            "categorical device-cached", cfg_cat,
            os.path.join(tmp, "run_cat"), dev, 2, smi)
        _check_panels(tr_cat.logger.history, [2 * k], "categorical")
        run_cat_hf = os.path.join(tmp, "run_cat_hf")
        tr_cat_hf, v_cat_hf = _train_variant(
            "categorical host-fed", get_config("categorical", **cat, **{
                "data.device_cache": False, "train.checkpoint_every": k}),
            run_cat_hf, dev, 1, smi, host_fed=True)
        labels = list(range(cfg_cat.model.n_classes))
        grid, vids_cat = sample_cli.main(
            ["--config", "categorical", "--run-dir", run_cat_hf, "--n",
             str(len(labels)), "--seed", "5", "--labels",
             *map(str, labels), "--out", os.path.join(run_cat_hf, "g.gif")])
        if not (os.path.getsize(grid) > 0
                and tuple(vids_cat.shape) == (len(labels), m.video_length, s,
                                              s, m.channels)
                and torch.isfinite(vids_cat).all()
                and vids_cat.abs().max() <= 1.0):
            raise AssertionError(f"categorical generate CLI: {grid}, "
                                 f"{tuple(vids_cat.shape)}")
        g_cat = tr_cat.state.nets["gen"]
        g_cat_cpu = generator.init(cfg_cat.model, torch.Generator()).eval()
        g_cat_cpu.load_state_dict({kk: v.cpu()
                                   for kk, v in g_cat.state_dict().items()})
        lab = torch.tensor([0, 5, 2])
        cat_err = _max_err(generator.generate(g_cat, 3, seed=3, labels=lab),
                           generator.generate(g_cat_cpu, 3, seed=3,
                                              labels=lab))
        print(f"[categorical] generate CLI --labels {labels} -> "
              f"{os.path.relpath(grid, tmp)}; generate(seed=3, labels="
              f"{lab.tolist()}) card vs CPU max_abs_err {cat_err:.3e} (tol "
              f"{GENERATE_TOL})")
        if not cat_err <= GENERATE_TOL:
            raise AssertionError(f"categorical generate card vs CPU: "
                                 f"{cat_err}")
        del tr_cat, tr_cat_hf, g_cat

        # ---- 10. mug, sequential update order ------------------------------
        mug = {"data.data_dir": cfg.data.data_dir, "train.log_every": k}
        tr, v_seq = _train_variant(
            "mug sequential", get_config("mug", **mug, **{
                "train.update_order": "sequential"}),
            os.path.join(tmp, "run_seq"), dev, 2, smi)
        print(f"[mug sequential] {v_seq['steps_per_s']:.3f} steps/s against "
              f"the simultaneous order's {sps:.3f} (phase 4)")
        del tr

        # ---- 11. mug at the bf16 production recipe -------------------------
        cfg_bf = get_config("mug", **mug, **{
            "train.batch_size": 32, "model.compute_dtype": "bfloat16",
            "train.label_smoothing": 0.1})
        tr_bf, v_bf = _train_variant("mug bf16", cfg_bf,
                                     os.path.join(tmp, "run_bf16"), dev, 2,
                                     smi)
        f32 = torch.float32
        for net_name, net in tr_bf.state.nets.items():
            moments = [t for st in tr_bf.state.opt[net_name].state.values()
                       for kk, t in st.items() if kk != "step"]
            if not all(t.dtype == f32 for t in [*net.parameters(),
                                                 *net.buffers(), *moments]):
                raise AssertionError(f"bf16 run: {net_name} holds non-fp32 "
                                     f"params, stats or moments")
        # D logits of 4 fixed clips (mug plan 0), eval mode, card vs CPU
        clips4 = preproc.resize_normalize_gather_cuda(
            pool, *plans[0], rh, rw)[:4]
        logit_err = {}
        for net_name, x in (("di", clips4[:, 0]), ("dv", clips4)):
            apply = (discriminators.image_apply if net_name == "di"
                     else lambda d, v, **kw: discriminators.video_apply(
                         d, v, **kw)[0])
            init = (discriminators.image_init if net_name == "di"
                    else discriminators.video_init)
            net = tr_bf.state.nets[net_name]
            cpu = {}
            for dt in ("bfloat16", "float32"):
                d = init(dataclasses.replace(cfg_bf.model, compute_dtype=dt),
                         torch.Generator())
                d.load_state_dict({kk: v.cpu()
                                   for kk, v in net.state_dict().items()})
                with torch.no_grad():
                    cpu[dt] = apply(d, x.cpu(), train=False)
            with torch.no_grad():
                card = apply(net, x, train=False).cpu()
            scale = float(cpu["bfloat16"].abs().max())
            logit_err[net_name] = (_max_err(card, cpu["bfloat16"]) / scale,
                                   _max_err(cpu["float32"], cpu["bfloat16"])
                                   / scale)
        print(f"[mug bf16] D logits of 4 fixed clips, eval mode, max err / "
              f"max |logit| (tol {BF16_LOGIT_TOL}): card vs CPU at bf16 "
              + ", ".join(f"{kk} {a:.2e}" for kk, (a, _) in
                          logit_err.items())
              + "; for scale, CPU fp32 vs CPU bf16 "
              + ", ".join(f"{kk} {b_:.2e}" for kk, (_, b_) in
                          logit_err.items()))
        if not max(a for a, _ in logit_err.values()) <= BF16_LOGIT_TOL:
            raise AssertionError(f"bf16 D logits card vs CPU: {logit_err}")
        del tr_bf

        # ---- 12. the scaled config on one card -----------------------------
        sc = get_config("scaled", **{"train.num_devices": 1})
        sc_dir = synthetic.write_store(
            os.path.join(tmp, "store_scaled"), clips=96,
            frames=sc.model.video_length + 4, size=sc.data.raw_size)
        pool_sc_np, lengths_sc_np, _ = clips.load_pool(sc_dir)
        pool_sc = torch.from_numpy(pool_sc_np).to(dev)
        lengths_sc = torch.from_numpy(lengths_sc_np)
        s_sc = sc.model.image_size
        lay_sc = _layout(
            pool_sc, _plans(lengths_sc, 8, sc.train.batch_size,
                            sc.model.video_length, dev),
            *preproc.resize_weights(pool_sc.shape[2], pool_sc.shape[3],
                                    s_sc, dev), s_sc, rates,
            f"scaled layout (B {sc.train.batch_size}, T "
            f"{sc.model.video_length}, {pool_sc.shape[2]} -> {s_sc} px)")
        del pool_sc
        k_sc = sc.train.steps_per_call
        scaled = {"data.data_dir": sc_dir, "train.num_devices": 1,
                  "train.log_every": k_sc}
        tr, v_sc = _train_variant("scaled", get_config("scaled", **scaled),
                                  os.path.join(tmp, "run_scaled"), dev, 2,
                                  smi)
        del tr
        tr, v_sc_nr = _train_variant(
            "scaled, remat off", get_config("scaled", **scaled, **{
                "model.remat": False}),
            os.path.join(tmp, "run_scaled_nr"), dev, 1, smi)
        del tr
        print(f"[scaled] without remat: "
              f"{v_sc_nr['steps_per_s'] / v_sc['steps_per_s'] - 1:+.1%} "
              f"steps/s ({v_sc_nr['steps_per_s']:.3f} against "
              f"{v_sc['steps_per_s']:.3f} with remat) and "
              f"{v_sc_nr['peak_gb'] - v_sc['peak_gb']:+.2f} GB of peak "
              f"memory ({v_sc_nr['peak_gb']:.2f} against "
              f"{v_sc['peak_gb']:.2f} GB)")

        # ---- 13. data parallel -------------------------------------------
        dp = _data_parallel({"data.data_dir": cfg.data.data_dir}, pool,
                            lengths, rh, rw, plans, rates, smi, tmp, sc_dir)

        # ---- 14. reference parity ---------------------------------------
        ref = _reference_parity(cfg, run_hf, cfg_cat, run_cat_hf, tmp, dev,
                                smi)

        # ---- 15. the timers --------------------------------------------------
        timers = _timers(sps, smi)

        # ---- 16. determinism -------------------------------------------------
        det = _determinism(cfg.data.data_dir, cat_dir, sc_dir, pool, lengths,
                           smi, dev, tmp)

    # ---- 17. result --------------------------------------------------------
    variants = {"categorical_cached": v_cat, "categorical_host_fed": v_cat_hf,
                "sequential": v_seq, "bf16": v_bf, "scaled": v_sc,
                "scaled_no_remat": v_sc_nr}
    # the eval pools of the training runs and of the two eval_fvd calls
    by_path = {"device_cached": launches_dc - ev_dc,
               "host_fed": launches_hf - ev_hf,
               **{kk: v["launches"] for kk, v in variants.items()},
               "data_parallel": dp["launches"],
               "parity_day": ref["launches"],
               "timers": timers.pop("launches"),
               "determinism": det.pop("launches"),
               "eval_pool": ev_dc + ev_hf + ev_r + ev_cli + sum(
                   v["eval_pool"] for v in variants.values())}
    print(json.dumps({"kernels": [{
        "name": "resize_norm", "route": "cuda",
        "source": "mocogan_tpu_torch/csrc/resize_norm.cu",
        "replaces": "mocogan_tpu/ops/preproc.py:90",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(lay_mug["max_abs_err"], lay_sc["max_abs_err"],
                           dp["layout"]["max_abs_err"],
                           dp["scaled_layout"]["max_abs_err"], err_hf,
                           lay_ev["max_abs_err"]),
        "ms": lay_mug["ms"], "plain_ms": lay_mug["plain_ms"],
        "bound_ms": lay_mug["bound_ms"], "bound_by": lay_mug["bound_by"],
        "bound_frac": (None if lay_mug["bound_ms"] is None
                       else lay_mug["bound_ms"] / lay_mug["ms"]),
        "library_ms": lay_mug["library_ms"], "eval_pool_layout": lay_ev,
        "scaled_layout": lay_sc, "per_rank_layout": dp["layout"],
        "per_rank_scaled_layout": dp["scaled_layout"]}]}))
    print(json.dumps({"variants": variants, "data_parallel": {
        kk: v for kk, v in dp.items()
        if kk not in ("layout", "scaled_layout", "launches")},
        "reference_parity": {kk: v for kk, v in ref.items()
                             if kk != "launches"}, "timers": timers,
        "determinism": det}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
