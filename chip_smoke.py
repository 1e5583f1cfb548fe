#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mocogan_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card, from nvidia-smi, with the torch and CUDA versions;
  2. build the CUDA ingest kernel (csrc/resize_norm.cu) from the checkout;
  3. hold the kernel against its plain PyTorch version at the mug shape
     (B 16, T 16, 96 -> 64 px, C 3) and at the scaled shape (B 8, T 32,
     128 -> 96 px, C 3), and time kernel, plain version and the library
     yardstick (F.interpolate) with CUDA events, each rotating over the same
     8 batch plans so that none sits in L2;
  4. render a 96 px synthetic uint8 clip store and train the full-width mug
     model (fp32, batch 16, 16 steps per call) through the device-cached
     trainer; the kernel's launch count must equal the steps taken;
     It also holds the kernel against its plain version on the
     device-cached eval pool's layout (one launch over 256 windows drawn
     with replacement from the store) and times that launch;
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
  9. print the kernels line, then the result line.
fp32 runs in full fp32: TF32 is switched off for matmuls and cuDNN.
"""

from __future__ import annotations

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
TRAIN_CALLS = 5         # trainer calls of k = 16 steps; the first warms up
HOST_FED_CALLS = 3      # host-fed calls of k = 16 steps before the resume
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


def _check_losses(recs) -> None:
    keys = ("loss_di", "loss_dv", "loss_gen", "loss_gen_di", "loss_gen_dv")
    recs = [r for r in recs if "loss_gen" in r]
    if not all(math.isfinite(r[kk]) for r in recs for kk in keys):
        raise AssertionError(f"non-finite losses: {recs}")


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
    import torch.nn.functional as F

    import numpy as np

    from mocogan_tpu_torch import eval_fvd as eval_fvd_cli
    from mocogan_tpu_torch import generate as generate_cli
    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.data import clips, synthetic
    from mocogan_tpu_torch.eval import i3d, parity
    from mocogan_tpu_torch.eval.panel import PanelRunner
    from mocogan_tpu_torch.models import discriminators, generator
    from mocogan_tpu_torch.ops import preproc, sampling
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

        # ---- 3. kernel vs plain at the mug and scaled shapes --------------
        pool = torch.from_numpy(pool_np).to(dev)
        lengths = torch.from_numpy(lengths_np)
        h, w, c = pool.shape[2:]
        s = m.image_size
        rh, rw = preproc.resize_weights(h, w, s, dev)
        plans = []
        for step in range(8):   # 8 plans: ~57 MB of frames, more than L2
            sel, starts = sampling.batch_plan(0, step, b, lengths,
                                              m.video_length, True)
            ix = sampling.window_indices(lengths, sel, starts, m.video_length)
            plans.append((sel.to(dev, torch.int32), ix.to(dev, torch.int32)))
        err = _check_kernel(pool, *plans[0], rh, rw, "mug")
        # the scaled config's ingest: B 8, T 32, 128 -> 96 px, C 3, on a
        # random pool of 12 clips x 40 frames
        gen = torch.Generator().manual_seed(0)
        pool_sc = torch.randint(0, 256, (12, 40, 128, 128, 3), generator=gen,
                                dtype=torch.uint8).to(dev)
        err_sc = _check_kernel(
            pool_sc,
            torch.randint(0, 12, (8,), generator=gen,
                          dtype=torch.int32).to(dev),
            torch.randint(0, 40, (8, 32), generator=gen,
                          dtype=torch.int32).to(dev),
            *preproc.resize_weights(128, 128, 96, dev), "scaled")
        del pool_sc

        def kern(i):
            preproc.resize_normalize_gather_cuda(pool, *plans[i % 8], rh, rw)

        def plain(i):
            preproc.resize_normalize_gather_plain(pool, *plans[i % 8], rh, rw)

        # F.interpolate on the same 8 plans, each pre-gathered as f32 planes
        x_lib = [pool[sel.long()[:, None], ix.long()].permute(
            0, 1, 4, 2, 3).reshape(-1, c, h, w).float() for sel, ix in plans]

        def lib(i):
            return F.interpolate(x_lib[i % 8], size=(s, s), mode="bilinear",
                                 align_corners=False, antialias=False)

        lib_out = (lib(0) * (2.0 / 255.0) - 1.0).view(
            b, m.video_length, c, s, s).permute(0, 1, 3, 4, 2)
        lib_err = float((lib_out - preproc.resize_normalize_gather_plain(
            pool, *plans[0], rh, rw)).abs().max())
        kernel_ms, kernel_host_ms = _time_ms(kern, 50)
        plain_ms, _ = _time_ms(plain, 20)
        library_ms, _ = _time_ms(lib, 50)
        library_one_ms, _ = _time_ms(lambda _: lib(0), 50)
        del x_lib
        n_planes = b * m.video_length * c
        moved = (n_planes * h * w + 4 * (rh.numel() + rw.numel())
                 + 4 * (b + b * m.video_length) + 4 * n_planes * s * s)
        # bilinear needs 2 taps per output of each pass (a multiply and an
        # add each), then the affine
        flops = n_planes * (4 * s * w + 4 * s * s + 2 * s * s)
        print(f"[kernel] device ms {kernel_ms:.5f} (host {kernel_host_ms:.5f}"
              f" ms per wrapper call), plain {plain_ms:.5f}, F.interpolate "
              f"{library_ms:.5f} over the 8 plans, {library_one_ms:.5f} on "
              f"plan 0 alone (input pre-gathered in f32; its max err vs "
              f"plain {lib_err:.2e})")
        rates = RATES.get(smi.rsplit(",", 1)[0].strip())
        bound_ms = bound_by = None
        if rates is None:
            print(f"[kernel] no data-sheet rates for {smi!r}: no bound")
        else:
            bw, peak = rates
            bound_s = {"bytes": moved / bw, "operations": flops / peak}
            bound_by = max(bound_s, key=bound_s.get)
            bound_ms = 1e3 * bound_s[bound_by]
            print(f"[kernel] bound {bound_ms:.6f} ms by {bound_by} "
                  f"({bound_ms / kernel_ms:.3f} of it reached): "
                  f"{moved / 1e6:.2f} MB at {bw / 1e12} TB/s, "
                  f"{flops / 1e9:.4f} GFLOP (2-tap) at {peak / 1e12} "
                  f"TFLOP/s fp32")

        # the device-cached eval pool's layout: EVAL_CLIPS windows drawn
        # with replacement (the trainer's draws), one launch
        ev_sel, ev_frames = eval_windows(lengths_np, EVAL_CLIPS,
                                         m.video_length)
        ev_ix = (torch.from_numpy(ev_sel).to(dev, torch.int32),
                 torch.from_numpy(ev_frames).to(dev, torch.int32))
        err_ev = _check_kernel(pool, *ev_ix, rh, rw,
                               f"eval-pool (B {EVAL_CLIPS})")
        eval_ms, _ = _time_ms(lambda _: preproc.resize_normalize_gather_cuda(
            pool, *ev_ix, rh, rw), 20)
        eval_plain_ms, _ = _time_ms(
            lambda _: preproc.resize_normalize_gather_plain(
                pool, *ev_ix, rh, rw), 5)
        # bytes: the distinct frames these windows read, once each
        frames_read = len({(int(i), int(f)) for i, row in
                           zip(ev_sel, ev_frames) for f in row})
        n_ev = EVAL_CLIPS * m.video_length * c
        moved_ev = (frames_read * h * w * c + 4 * (rh.numel() + rw.numel())
                    + 4 * EVAL_CLIPS * (1 + m.video_length)
                    + 4 * n_ev * s * s)
        flops_ev = n_ev * (4 * s * w + 4 * s * s + 2 * s * s)
        eval_bound_ms = (None if rates is None else
                         1e3 * max(moved_ev / rates[0], flops_ev / rates[1]))
        print(f"[kernel] eval-pool launch ({EVAL_CLIPS} windows, "
              f"{frames_read} distinct frames): device ms {eval_ms:.5f}, "
              f"plain {eval_plain_ms:.5f}, bound {eval_bound_ms} ms "
              f"({moved_ev / 1e6:.2f} MB)")

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
        print(f"[train] device-cached mug fp32 batch {b}, k {k}: {steps} "
              f"steps in {train_s:.2f} s; {sps:.3f} steps/s after the first "
              f"call; peak memory "
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
        print(f"[host-fed] mug fp32 batch {b}, k {k}: {steps_hf} steps in "
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
        grid, vids_cli = generate_cli.main(
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
        free = [generator.generate(g_r, 4, seed=0) for _ in range(2)]
        print(f"[parity] deterministic: true twice, record matches "
              f"({reps[1]['digest'][:12]}); without cudnn.deterministic, "
              f"two generate() calls bit-equal: "
              f"{bool(torch.equal(*free))}")

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

    # ---- 9. result ---------------------------------------------------------
    # the eval pools of the training runs and of the two eval_fvd calls
    by_path = {"device_cached": launches_dc - ev_dc,
               "host_fed": launches_hf - ev_hf,
               "eval_pool": ev_dc + ev_hf + ev_r + ev_cli}
    print(json.dumps({"kernels": [{
        "name": "resize_norm", "route": "cuda",
        "source": "mocogan_tpu_torch/csrc/resize_norm.cu",
        "replaces": "mocogan_tpu/ops/preproc.py:90",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(err, err_sc, err_hf, err_ev), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_frac": None if bound_ms is None else bound_ms / kernel_ms,
        "library_ms": library_ms, "eval_pool_ms": eval_ms,
        "eval_pool_plain_ms": eval_plain_ms,
        "eval_pool_bound_ms": eval_bound_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
