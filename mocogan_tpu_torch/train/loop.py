"""The trainer: host-fed and device-cached training under one cadence.

  * host-fed (``run``): a host iterator yields batches, float32 clips or
    raw uint8 windows of the clip store; ``data.pipeline.HostFeed`` stacks
    k of them in pinned memory on its prefetch thread and uploads the next
    stack while the device runs the current call of k steps
    (``step.multi_train_step``);
  * device-cached (``run_device_cached``): the uint8 clip store is
    uploaded once and each call samples its k batches on the device
    (``step.cached_multi_train_step``).

Both feed raw clips through the ingest kernel, and both hand each call to
``_run_loop``, the one copy of the log / sample / eval / checkpoint / hook
cadence. Metrics stay on the device and are copied to the host once per log
window, then written to ``<out_dir>/log.jsonl``. Checkpoints go to
``<out_dir>/checkpoints/<step>/state.pt`` and sample grids to
``<out_dir>/samples/``. A new Trainer on the same out_dir resumes from the
latest checkpoint, and the data stream resumes at the restored step.

Every ``train.eval_every`` steps the quality panel (``eval/panel.py``) runs
on up to ``train.eval_clips`` real clips, which each mode makes with the
ingest kernel: device-cached, one launch over fixed windows of the resident
store (the JAX package's numpy draws, made once per run); host-fed, one
launch over the clips of the recent global batches.

Data parallelism (``train.num_devices`` > 1, one process per GPU under
``torchrun`` or the train CLI's own workers): every rank trains on its rows
of each global batch (``parallel/mesh.py``), and rank 0 alone writes the
log, the checkpoints and the sample grids and runs the panel, on the same
eval pool as one device would; a barrier follows each of these.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from mocogan_tpu_torch.configs import ExperimentConfig
from mocogan_tpu_torch.data import clips
from mocogan_tpu_torch.data.pipeline import HostFeed
from mocogan_tpu_torch.models import generator
from mocogan_tpu_torch.ops import preproc
from mocogan_tpu_torch.parallel import mesh as pmesh
from mocogan_tpu_torch.train import state as train_state
from mocogan_tpu_torch.train import step as train_step_mod
from mocogan_tpu_torch.utils import video as video_utils
from mocogan_tpu_torch.utils.checkpoint import CheckpointManager
from mocogan_tpu_torch.utils.metrics import MetricLogger
from mocogan_tpu_torch.utils.platform import resolve_device, upload

# the seed of the fixed sample grid and of the panel's generated clips is
# the training seed plus this
EVAL_SEED_OFFSET = 1_000_000


def eval_windows(lengths: np.ndarray, n: int, t: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The device-cached eval pool's windows, the JAX package's draws:
    (clip indices (n,), frame indices (n, t)) from ``default_rng(0)``,
    clips with replacement, one start per selected clip in order, frames
    wrapped at the clip's length."""
    rng = np.random.default_rng(0)
    sel = rng.integers(0, len(lengths), size=n)
    starts = np.array([int(rng.integers(0, max(lengths[i] - t + 1, 1)))
                       for i in sel], np.int64)
    frames = (starts[:, None] + np.arange(t)) \
        % np.maximum(lengths[sel], 1)[:, None]
    return sel, frames


def stack_eval_pool(stacks: Sequence[Tuple[Optional[torch.Tensor], ...]],
                    n: int, size: int) -> torch.Tensor:
    """The first n clips of uploaded host-fed stacks ((K, B, ...) batches,
    (K, B, T) frame indices or None, then anything else ``HostFeed.next``
    returns), in order: float clips as they are, uint8 clips through one
    launch of the ingest kernel."""
    parts = [b.flatten(0, 1) for b, *_ in stacks]
    clips_ = parts[0] if len(parts) == 1 else torch.cat(parts)
    m = min(n, clips_.shape[0])
    if clips_.dtype != torch.uint8:
        return clips_[:m]
    t = clips_.shape[1]
    idx = torch.cat([
        (ix if ix is not None else torch.arange(
            t, dtype=torch.int32, device=b.device).expand(*b.shape[:2], t)
         ).flatten(0, 1) for b, ix, *_ in stacks])
    rh, rw = preproc.resize_weights(clips_.shape[2], clips_.shape[3], size,
                                    clips_.device)
    return preproc.resize_normalize_gather(
        clips_.contiguous(),
        torch.arange(m, dtype=torch.int32, device=clips_.device),
        idx[:m].to(torch.int32).contiguous(), rh, rw)


class Trainer:
    """Drives training for one ExperimentConfig on `device` (default
    ``cuda``; ``device="cpu"`` runs the plain ingest on the CPU). With
    `resume`, the latest checkpoint in ``<out_dir>/checkpoints`` is
    restored.

    The data-parallel world comes from ``torch.distributed``: the process
    group the environment describes is joined here (``torchrun``), or the
    caller has joined one. ``train.num_devices`` None means its size, any
    other value must equal it (one process per device), and
    ``train.n_slices`` must fit it (``parallel.mesh.make_mesh``). Under
    ``cuda`` each rank takes ``cuda:<local rank>``; a device with an index
    (``cuda:0``) is taken as it is."""

    def __init__(self, cfg: ExperimentConfig, out_dir: Optional[str] = None,
                 resume: bool = True, device=None):
        self.cfg = cfg
        device = resolve_device(device)
        pmesh.initialize_distributed(device)
        self.mesh = pmesh.make_mesh(cfg.train.num_devices,
                                    cfg.train.n_slices, device)
        pmesh.local_batch_size(cfg, self.mesh)      # raises if B % n
        self.device = self.mesh.device
        self.out_dir = out_dir or os.path.join(cfg.out_dir, cfg.name)
        os.makedirs(self.out_dir, exist_ok=True)
        self.logger = MetricLogger(self.out_dir)
        # epoch_shuffle changes batch_plan's (seed, step) -> clip mapping, so
        # it is part of the stream identity a resume compares
        self.ckpt = CheckpointManager(
            os.path.join(self.out_dir, "checkpoints"),
            max_to_keep=cfg.train.keep_checkpoints,
            stream_meta={"epoch_shuffle": cfg.data.epoch_shuffle},
            mesh=self.mesh)
        self.state = train_state.create(cfg, device=self.device,
                                        mesh=self.mesh)
        if resume and self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.state)
            train_state.check_replicated(self.state, self.mesh)
            self._say(f"[trainer] resumed from step {self.state.step}")
        self._hooks: list = []
        self._panel = None       # eval.panel.PanelRunner, built on first use
        self._fvd_warned = False
        # seconds the last host-fed run waited for its prefetch thread
        self.prefetch_wait_s = 0.0
        # ingest-kernel launches made to build eval pools (all runs)
        self.eval_pool_launches = 0

    def add_hook(self, every: int,
                 fn: Callable[["Trainer", int], Any]) -> None:
        """Call fn(trainer, step) on the host every `every` steps (on every
        rank)."""
        self._hooks.append((int(every), fn))

    def _say(self, msg: str) -> None:
        if self.mesh.is_main:
            print(msg)

    def save_samples(self, step: int, n: int = 16) -> str:
        """A grid of n clips from the fixed seed train.seed + 1_000_000, at
        ``<out_dir>/samples/step_<step>.gif`` (``.npy`` without PIL)."""
        t0 = time.perf_counter()
        vids = generator.generate(self.state.nets["gen"], n,
                                  seed=self.cfg.train.seed + EVAL_SEED_OFFSET)
        u8 = generator.to_uint8(vids).cpu().numpy()
        t1 = time.perf_counter()
        path = video_utils.save_video_grid(u8, os.path.join(
            self.out_dir, "samples", f"step_{step:08d}.gif"))
        print(f"[samples] step {step}: generate {t1 - t0:.3f} s, write "
              f"{time.perf_counter() - t1:.3f} s -> {path}")
        return path

    def eval_fvd(self, real_pool) -> float:
        """fvd_proxy between freshly generated clips and `real_pool`."""
        return self.eval_metrics(real_pool)["fvd_proxy"]

    def eval_metrics(self, real_pool) -> Dict[str, float]:
        """The quality panel (``eval/panel.py``) of the current state on
        the first ``train.eval_clips`` clips of `real_pool` (N, T, H, W, C)
        in [-1, 1]: fvd_proxy, gen_spread_ratio, acd_gen / acd_real,
        gen_pairwise_ssim and dv_margin. The generated clips come from the
        seed train.seed + 1_000_000."""
        runner = self._panel_runner()
        n = min(self.cfg.train.eval_clips, len(real_pool))
        want = 4 * runner.extractor.dim
        if 0 < n < want and not self._fvd_warned:
            self._fvd_warned = True
            print(f"[trainer] WARNING: fvd_proxy from {n} clips < 4x the "
                  f"{runner.extractor.dim}-dim extractor ({want}); the "
                  f"covariance estimate will be noise-dominated")
        nets = self.state.nets
        return runner(nets["gen"], nets.get("dv"), real_pool,
                      self.cfg.train.seed + EVAL_SEED_OFFSET, n=n)

    def _panel_runner(self):
        if self._panel is None:
            from mocogan_tpu_torch.eval.panel import PanelRunner

            self._panel = PanelRunner(self.cfg, device=self.device)
        return self._panel

    @staticmethod
    def _crossed(every: int, s0: int, s1: int) -> bool:
        return bool(every) and (s1 // every) > (s0 // every)

    def _plan_total(self, total_steps: Optional[int],
                    k: int) -> Optional[Tuple[int, int]]:
        """(start, total rounded up to a multiple of k), or None when the
        restored step already covers the request. Raises on settings the
        port cannot run, before any step."""
        t = self.cfg.train
        if t.eval_every and t.eval_clips < 1:
            raise ValueError(
                f"train.eval_clips must be >= 1 when eval_every="
                f"{t.eval_every} is set (got {t.eval_clips})")
        total = total_steps or t.total_steps
        start = self.state.step
        if start >= total:
            self._say(f"[trainer] nothing to do: resumed step {start} >= "
                      f"total {total}")
            return None
        if (total - start) % k:
            total = start + -(-(total - start) // k) * k
            self._say(f"[trainer] rounding total up to {total} "
                      f"(steps_per_call={k})")
        return start, total

    def _run_loop(self, start: int, total: int, k: int,
                  dispatch: Callable[[int], Dict[str, torch.Tensor]],
                  eval_pool_fn: Callable[[], torch.Tensor]
                  ) -> Dict[str, float]:
        """The cadence loop of both modes: log, sample grid, eval panel,
        checkpoint, hooks, in that order. dispatch(step) advances the state
        by k steps and returns their mean metrics (0-dim device tensors),
        re-weighted by k here; eval_pool_fn() returns the panel's real
        clips (called on rank 0 only). Ends with a checkpoint, a sample
        grid (unless the cadence just wrote one) and the loss plot. Rank 0
        alone logs, samples, runs the panel and plots; the ranks meet at a
        barrier after each of these and at each checkpoint."""
        cfg = self.cfg
        acc: Optional[Dict[str, torch.Tensor]] = None   # on-device sums
        n_acc = 0                                       # in steps
        t_window = time.time()
        last: Dict[str, float] = {}
        sampled = None
        step = start
        while step < total:
            metrics = dispatch(step)
            prev, step = step, step + k
            w = {key: v * k for key, v in metrics.items()}
            acc = w if acc is None else {key: acc[key] + w[key] for key in w}
            n_acc += k

            if self._crossed(cfg.train.log_every, prev, step) \
                    or step >= total:
                fetched = torch.stack(list(acc.values())).tolist()
                dt = time.time() - t_window
                last = {key: v / n_acc for key, v in zip(acc, fetched)}
                sps = n_acc / dt
                if self.mesh.is_main:
                    self.logger.log(step, last, steps_per_sec=round(sps, 3),
                                    clips_per_sec=round(
                                        sps * cfg.train.batch_size, 2))
                self._say(f"[step {step}/{total}] "
                          + " ".join(f"{kk}={v:.4f}"
                                     for kk, v in last.items())
                          + f" | {sps:.2f} steps/s")
                acc, n_acc, t_window = None, 0, time.time()

            if self._crossed(cfg.train.sample_every, prev, step):
                if self.mesh.is_main:
                    self.save_samples(step)
                pmesh.barrier(self.mesh)
                sampled = step
            if self._crossed(cfg.train.eval_every, prev, step) \
                    and self.mesh.is_main:
                t_eval = time.time()
                before = preproc.LAUNCHES["resize_norm"]
                pool = eval_pool_fn()
                self.eval_pool_launches += \
                    preproc.LAUNCHES["resize_norm"] - before
                panel = self.eval_metrics(pool)
                # the extractor's dim and fingerprint make each record
                # self-describing; eval_seconds is the stall it cost
                panel["fvd_proxy_dim"] = float(self._panel.extractor.dim)
                self.logger.log(step, panel,
                                eval_fingerprint=self._panel.fingerprint,
                                eval_seconds=round(time.time() - t_eval, 2))
                print(f"[step {step}] "
                      + " ".join(f"{kk}={vv:.3f}"
                                 for kk, vv in panel.items())
                      + f" | eval {time.time() - t_eval:.1f}s")
            if self._crossed(cfg.train.eval_every, prev, step):
                pmesh.barrier(self.mesh)
            if self._crossed(cfg.train.checkpoint_every, prev, step):
                self.ckpt.save(self.state)
            for every, hook in self._hooks:
                if self._crossed(every, prev, step):
                    hook(self, step)

        self.ckpt.save(self.state, wait=True)
        if self.mesh.is_main:
            if sampled != total:
                self.save_samples(total)
            self.logger.plot()
        pmesh.barrier(self.mesh)
        return last

    def run(self, data_iterator: Iterator[Any],
            total_steps: Optional[int] = None) -> Dict[str, float]:
        """Host-fed training to `total_steps` (rounded up to a multiple of
        k = train.steps_per_call). The iterator yields (videos float32 in
        [-1, 1], labels) pairs or {"raw", "frame_idx", "labels"} dicts, as
        ``make_data_iterator`` does, starting at the state's step. Returns
        the last logged metrics."""
        cfg = self.cfg
        k = max(1, cfg.train.steps_per_call)
        plan = self._plan_total(total_steps, k)
        if plan is None:
            return {}
        start, total = plan
        feed = HostFeed(data_iterator, k, self.device,
                        depth=cfg.data.prefetch, mesh=self.mesh)

        def fetch():
            # the rank's rows, and the global stack for the eval pool: the
            # uploaded stack itself on one rank, the host copy otherwise
            batch = feed.next()
            return {"batch": batch, "global": feed.last_global or batch}

        current = fetch()
        # k = 1: the eval pool is the last ceil(eval_clips / B) global
        # stacks trained on (one batch of B clips would leave the Fréchet
        # covariance rank-deficient); k > 1: the stack of the next call
        recent: deque = deque(maxlen=max(1, -(-cfg.train.eval_clips
                                              // cfg.train.batch_size)))

        def dispatch(step):
            if k == 1 and cfg.train.eval_every and self.mesh.is_main:
                recent.append(current["global"])
            metrics = train_step_mod.multi_train_step(
                self.state, *current["batch"], mesh=self.mesh)
            # the next stack's upload overlaps this call (a copy stream)
            if step + k < total:
                current.update(fetch())
            return metrics

        def eval_pool_fn():
            stacks = list(recent) if k == 1 else [current["global"]]
            return stack_eval_pool(
                [tuple(None if t is None else t.to(self.device) for t in s)
                 for s in stacks],
                cfg.train.eval_clips, cfg.model.image_size)

        try:
            return self._run_loop(start, total, k, dispatch, eval_pool_fn)
        finally:
            feed.close()
            self.prefetch_wait_s = feed.wait_s

    def run_device_cached(self, total_steps: Optional[int] = None
                          ) -> Dict[str, float]:
        """Train to `total_steps` (rounded up to a multiple of k) with the
        whole clip store resident on the device. Returns the last logged
        metrics."""
        cfg = self.cfg
        k = max(1, cfg.train.steps_per_call)
        plan = self._plan_total(total_steps, k)
        if plan is None:
            return {}
        start, total = plan

        pool_np, lengths_np, labels_np = clips.load_pool(cfg.data.data_dir)
        labels = None
        if cfg.model.conditional:
            if len(labels_np) and labels_np.max() >= cfg.model.n_classes:
                raise ValueError(
                    f"dataset has {labels_np.max() + 1}+ classes but "
                    f"model.n_classes={cfg.model.n_classes}")
            labels = torch.from_numpy(labels_np)
        if pool_np.shape[1] < cfg.model.video_length:
            raise ValueError(
                f"device cache: longest stored clip has {pool_np.shape[1]} "
                f"frames < video_length={cfg.model.video_length}")
        if pool_np.shape[-1] != cfg.model.channels:
            raise ValueError(f"store has {pool_np.shape[-1]} channels, model "
                             f"{cfg.model.channels}")
        pool = torch.from_numpy(pool_np).to(self.device)
        lengths = torch.from_numpy(lengths_np)
        rh, rw = preproc.resize_weights(pool.shape[2], pool.shape[3],
                                        cfg.model.image_size, self.device)
        self._say(f"[trainer] device cache: {pool_np.nbytes / 1e6:.0f} MB, "
                  f"{len(lengths_np)} clips resident on {self.device}")

        def dispatch(step):
            return train_step_mod.cached_multi_train_step(
                self.state, pool, lengths, k, rh, rw, labels=labels,
                mesh=self.mesh)

        cache: Dict[str, torch.Tensor] = {}

        def eval_pool_fn():
            # eval_clips windows, not clips: clips drawn with replacement
            # and random starts, so a small store still gives the panel
            # its clip budget; one kernel launch, kept for the whole run
            if "pool" not in cache:
                sel, frames = eval_windows(lengths_np, cfg.train.eval_clips,
                                           cfg.model.video_length)
                cache["pool"] = preproc.resize_normalize_gather(
                    pool, upload(torch.from_numpy(sel).to(torch.int32),
                                 pool.device),
                    upload(torch.from_numpy(frames).to(torch.int32),
                           pool.device), rh, rw)
            return cache["pool"]

        return self._run_loop(start, total, k, dispatch, eval_pool_fn)


def make_data_iterator(cfg: ExperimentConfig, start_batch: int = 0
                       ) -> Iterator[Any]:
    """The host-side batch stream for cfg.data.dataset, from batch
    `start_batch` (the restored step, for an exactly resumed stream)."""
    m, t = cfg.model, cfg.train
    if cfg.data.dataset == "synthetic":
        from mocogan_tpu_torch.data import synthetic

        return synthetic.batch_iterator(
            t.seed, t.batch_size, t=m.video_length, size=m.image_size,
            channels=m.channels, n_classes=m.n_classes,
            start_batch=start_batch)
    return clips.clip_batch_iterator(cfg, start_batch=start_batch)
