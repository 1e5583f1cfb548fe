"""The MoCoGAN adversarial train step, in either update order.

Per step: one generator forward; D_I on S_1-sampled real vs detached fake
frames; D_V on real vs detached fake clips; then the G loss, fooling both
discriminators on the SAME fakes. D_I and D_V run real and fake as
separate BN batches, the running stats threaded real -> fake; the G-phase
D passes run in train mode and leave the stats alone. The update order
(``train.update_order``):
  * "simultaneous": every gradient comes from start-of-step parameters.
    D gradients come from L_DI + L_DV, which see only detached fakes; G
    gradients from L_G alone (a separate ``autograd.grad``), so L_G never
    reaches the D parameters while still flowing through D into G. Then
    one Adam update per net.
  * "sequential" (the JAX package's ``_sequential_train_step``): the same
    D gradients and D updates, then G's loss through the *updated* D_I and
    D_V, then G's update. JAX runs the generator twice with one key to get
    the same fakes; here its one forward keeps its graph, detached for the
    D phase and attached for the G phase. That is exact: G's params do not
    change between the phases, and train-mode BN uses batch statistics.
In both orders G's BN stats advance once and the Ds' in the D phase. An
Adam update is skipped (params and moments untouched) on steps the
every-k balance lever leaves out.

The categorical model adds ``aux_loss_weight`` times the class
cross-entropy of D_V's class head: on the real clips' labels and the fakes'
drawn labels to L_DV (metric ``loss_aux_d``), on the fakes' labels to L_G
(``loss_aux_g``). Under bf16 compute the real clips are cast once, here;
the losses are fp32.

``cached_multi_train_step`` is the device-cached path: for each of k steps
it plans clip windows on the host, gathers and resizes them from the
resident uint8 pool in one launch of the ingest kernel, and takes a step.
``multi_train_step`` is the host-fed path: k steps on a stack of k batches
uploaded by the trainer; a uint8 stack goes through the same kernel, with
the stack itself as the pool.

Every random draw is made on the host from CPU generators and copied to
the device, so a (seed, step) draws the same noise on the card as on the
CPU.

Data parallelism (``mesh``, from ``parallel.mesh.make_mesh``): each rank
runs these functions on its rows of the global batch. The draws are the
global batch's, sliced to the rank's rows (``shard_draws``); BN statistics,
gradients and metrics are averaged over the ranks, so each rank takes the
single-device step on the global batch and returns its metrics. Without a
process group no collective is issued.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from mocogan_tpu_torch.configs import ExperimentConfig
from mocogan_tpu_torch.models import generator
from mocogan_tpu_torch.ops import layers, losses, preproc, sampling
from mocogan_tpu_torch.parallel import mesh as pmesh
from mocogan_tpu_torch.parallel.mesh import Mesh
from mocogan_tpu_torch.train.state import TrainState
from mocogan_tpu_torch.utils import prng
from mocogan_tpu_torch.utils.platform import upload

Draws = Dict[str, torch.Tensor]
Grads = Dict[str, Dict[str, torch.Tensor]]


def draw_noise(cfg: ExperimentConfig, seed: int, step: int, batch: int,
               device) -> Draws:
    """The step's noise: z_c, h0, eps (T, B, d_eps), the fakes' labels
    (categorical model) and the S_1 frame indices i_real, i_fake (B,),
    each from its own (seed, step, role)."""
    dev = torch.device(device)
    t = cfg.model.video_length
    d = generator.draw_latents(cfg.model, batch, seed, step, dev)
    for name, sub in (("i_real", 0), ("i_fake", 1)):
        d[name] = upload(torch.randint(0, t, (batch,), generator=(
            prng.generator(seed, step, "frame_sample", sub=sub))), dev)
    return d


def draw_step(cfg: ExperimentConfig, seed: int, step: int,
              lengths: torch.Tensor, device) -> Draws:
    """Everything step `step` of the device-cached path draws: the noise of
    ``draw_noise`` plus the batch plan sel, starts (CPU)."""
    b = cfg.train.batch_size
    d = draw_noise(cfg, seed, step, b, device)
    d["sel"], d["starts"] = sampling.batch_plan(
        seed, step, b, lengths, cfg.model.video_length,
        cfg.data.epoch_shuffle)
    return d


_BATCH_AXIS = {"eps": 1}    # eps is (T, B, d_eps); every other draw (B, ...)


def shard_draws(draws: Draws, mesh: Optional[Mesh]) -> Draws:
    """The rank's rows of a step's global draws (as from ``draw_noise`` or
    ``draw_step``): axis 1 of eps, axis 0 of the rest."""
    if mesh is None or mesh.world_size == 1:
        return draws
    return {k: pmesh.local_batch_slice(mesh, v, axis=_BATCH_AXIS.get(k, 0))
            for k, v in draws.items()}


def _fake(state: TrainState, noise: Draws, mesh: Optional[Mesh]
          ) -> torch.Tensor:
    """Fake clips (B, T, C, H, W) with their graph; advances G's BN."""
    return state.nets["gen"].sample(noise["z_c"], noise["h0"], noise["eps"],
                                    train=True, labels=noise.get("labels"),
                                    mesh=mesh)


def _d_losses(state: TrainState, real_cf: torch.Tensor, fake: torch.Tensor,
              noise: Draws, labels: Optional[torch.Tensor],
              mesh: Optional[Mesh]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L_DI + L_DV on real (B, T, C, H, W) and the detached fakes; advances
    the D BN stats."""
    cfg = state.cfg
    smooth = cfg.train.label_smoothing
    di, dv = state.nets["di"], state.nets.get("dv")
    metrics: Dict[str, torch.Tensor] = {}
    fake = fake.detach()
    di_real = di(sampling.sample_frames(real_cf, noise["i_real"]), train=True,
                 mesh=mesh)
    di_fake = di(sampling.sample_frames(fake, noise["i_fake"]), train=True,
                 mesh=mesh)
    loss_d = metrics["loss_di"] = losses.d_loss(di_real, di_fake, smooth)
    if dv is not None:
        dv_real, cls_real = dv(real_cf.transpose(1, 2).contiguous(),
                               train=True, mesh=mesh)
        dv_fake, cls_fake = dv(fake.transpose(1, 2), train=True, mesh=mesh)
        loss_dv = losses.d_loss(dv_real, dv_fake, smooth)
        if cls_real is not None:
            aux = (losses.categorical_loss(cls_real, labels)
                   + losses.categorical_loss(cls_fake, noise["labels"]))
            loss_dv = loss_dv + cfg.train.aux_loss_weight * aux
            metrics["loss_aux_d"] = aux
        metrics["loss_dv"] = loss_dv
        loss_d = loss_d + loss_dv
    return loss_d, metrics


@contextlib.contextmanager
def _constants(nets: Iterable[torch.nn.Module]):
    """The nets' parameters out of the graph for the block, back after it.
    L_G's gradient is taken for G alone (JAX differentiates it for G's
    params only), and the conv layers' autograd Function cannot tell which
    inputs an ``autograd.grad`` asks for: a D parameter in the graph would
    make it compute that weight gradient for nothing."""
    params = [p for net in nets for p in net.parameters()
              if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _g_losses(state: TrainState, fake: torch.Tensor, noise: Draws,
              mesh: Optional[Mesh]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L_G through the Ds as they are now (their parameters constants), in
    train mode without a BN update."""
    cfg = state.cfg
    di, dv = state.nets["di"], state.nets.get("dv")
    metrics: Dict[str, torch.Tensor] = {}
    with _constants(state.nets[n] for n in _d_names(state)):
        loss_g = metrics["loss_gen_di"] = losses.g_loss(di(
            sampling.sample_frames(fake, noise["i_fake"]), train=True,
            update=False, mesh=mesh))
        if dv is not None:
            g_dv, cls = dv(fake.transpose(1, 2), train=True, update=False,
                           mesh=mesh)
            metrics["loss_gen_dv"] = losses.g_loss(g_dv)
            loss_g = loss_g + metrics["loss_gen_dv"]
            if cls is not None:
                aux = metrics["loss_aux_g"] = losses.categorical_loss(
                    cls, noise["labels"])
                loss_g = loss_g + cfg.train.aux_loss_weight * aux
    metrics["loss_gen"] = loss_g
    return loss_g, metrics


def _grads(state: TrainState, loss: torch.Tensor, names: Iterable[str],
           mesh: Optional[Mesh]) -> Grads:
    """{net: {param name: gradient}} of `loss`, each net's averaged over
    the ranks of `mesh` in one flat bucket."""
    named = [(n, pn, p) for n in names
             for pn, p in state.nets[n].named_parameters()]
    gs = torch.autograd.grad(loss, [p for _, _, p in named])
    out: Grads = {}
    for (n, pn, _), g in zip(named, gs):
        out.setdefault(n, {})[pn] = g
    return {n: dict(zip(g, pmesh.all_reduce_grads(list(g.values()), mesh)))
            for n, g in out.items()}


def _mean_metrics(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                  ) -> Dict[str, torch.Tensor]:
    """The metrics, detached and averaged over the ranks (one
    all-reduce)."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is None or not mesh.collective:
        return metrics
    return dict(zip(metrics, pmesh.all_reduce_mean(
        torch.stack(list(metrics.values())), mesh).unbind(0)))


def _d_names(state: TrainState) -> List[str]:
    return [n for n in ("di", "dv") if n in state.nets]


def _real(state: TrainState, real: torch.Tensor) -> torch.Tensor:
    """real (B, T, H, W, C) -> (B, T, C, H, W) in the compute dtype, cast
    once for both Ds."""
    dtype = layers.compute_dtype(state.cfg.model.compute_dtype)
    return real.to(dtype).permute(0, 1, 4, 2, 3)


def compute_grads(state: TrainState, real: torch.Tensor, noise: Draws,
                  labels: Optional[torch.Tensor] = None,
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[Grads, Dict[str, torch.Tensor]]:
    """The simultaneous order's per-net gradients {net: {param name:
    grad}} and the step's metrics; with a `mesh`, of the global batch
    (`real`, `noise` and `labels` hold the rank's rows)."""
    with record_function("losses"):
        real_cf = _real(state, real)
        fake = _fake(state, noise, mesh)
        loss_d, metrics = _d_losses(state, real_cf, fake, noise, labels,
                                    mesh)
        loss_g, m_g = _g_losses(state, fake, noise, mesh)
    with record_function("grads"):
        grads = _grads(state, loss_d, _d_names(state), mesh)
        grads.update(_grads(state, loss_g, ["gen"], mesh))
    return grads, _mean_metrics({**metrics, **m_g}, mesh)


def _check_finite(state: TrainState, metrics: Dict[str, torch.Tensor]):
    if state.debug_nans:
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise FloatingPointError(f"non-finite {bad} at step {state.step}")


def _update(state: TrainState, names: Iterable[str], grads: Grads) -> None:
    """One Adam update of each net in `names`, unless the every-k lever
    skips it this step."""
    t = state.cfg.train
    with record_function("adam"):
        for name in names:
            every = t.g_update_every if name == "gen" else t.d_update_every
            if state.step % every:
                continue
            for pn, p in state.nets[name].named_parameters():
                p.grad = grads[name][pn]
            state.opt[name].step()
            state.opt[name].zero_grad(set_to_none=True)


def _sequential(state: TrainState, real: torch.Tensor, noise: Draws,
                labels: Optional[torch.Tensor], mesh: Optional[Mesh]
                ) -> Dict[str, torch.Tensor]:
    """The sequential order's phases; returns the metrics."""
    with record_function("losses"):
        real_cf = _real(state, real)
        fake = _fake(state, noise, mesh)
        loss_d, metrics = _d_losses(state, real_cf, fake, noise, labels,
                                    mesh)
    with record_function("grads"):
        grads = _grads(state, loss_d, _d_names(state), mesh)
    metrics = _mean_metrics(metrics, mesh)
    _check_finite(state, metrics)
    _update(state, _d_names(state), grads)
    with record_function("losses"):
        loss_g, m_g = _g_losses(state, fake, noise, mesh)
    with record_function("grads"):
        grads = _grads(state, loss_g, ["gen"], mesh)
    m_g = _mean_metrics(m_g, mesh)
    _check_finite(state, m_g)
    _update(state, ["gen"], grads)
    return {**metrics, **m_g}


def _check_order(cfg: ExperimentConfig) -> None:
    order = cfg.train.update_order
    if order not in ("simultaneous", "sequential"):
        raise ValueError(f"train.update_order must be 'simultaneous' or "
                         f"'sequential', got {order!r}")


def train_step(state: TrainState, real: torch.Tensor,
               noise: Optional[Draws] = None,
               labels: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One adversarial iteration on real (B, T, H, W, C) float32 in [-1, 1]
    with, for the categorical model, their labels (B,) on the same device.
    Updates `state` in place and returns the metrics (0-dim tensors on the
    device). `noise` (as from ``draw_noise``) overrides the step's draws.
    With ``debug_nans`` a non-finite loss raises before the update of its
    phase (in the sequential order the D update precedes G's loss).

    With a data-parallel `mesh`, `real`, `labels` and `noise` are the
    rank's rows of the global batch (``shard_draws`` of the global draws;
    by default the step draws the global batch's noise and slices it), and
    the step is the single-device step on the global batch."""
    cfg = state.cfg
    _check_order(cfg)
    m = cfg.model
    want = (m.video_length, m.image_size, m.image_size, m.channels)
    if real.ndim != 5 or tuple(real.shape[1:]) != want:
        raise ValueError(f"real must be (B, {want}), got {tuple(real.shape)}")
    if m.conditional and labels is None:
        raise ValueError("the categorical model needs the real clips' labels")
    if noise is None:
        n = 1 if mesh is None else mesh.world_size
        noise = shard_draws(draw_noise(cfg, state.seed, state.step,
                                       real.shape[0] * n, state.device), mesh)
    if cfg.train.update_order == "sequential":
        metrics = _sequential(state, real, noise, labels, mesh)
    else:
        grads, metrics = compute_grads(state, real, noise, labels, mesh)
        _check_finite(state, metrics)
        _update(state, state.nets, grads)
    state.step += 1
    return metrics


def cached_multi_train_step(state: TrainState, pool: torch.Tensor,
                            lengths: torch.Tensor, k: int,
                            rh: Optional[torch.Tensor] = None,
                            rw: Optional[torch.Tensor] = None,
                            draws: Optional[Sequence[Draws]] = None,
                            labels: Optional[torch.Tensor] = None,
                            mesh: Optional[Mesh] = None
                            ) -> Dict[str, torch.Tensor]:
    """k steps with the whole clip store resident on the device.

    pool: (N, T_max, H_raw, W_raw, C) uint8 on the state's device;
    lengths: (N,) true frame counts (CPU); rh, rw: the resize weights
    (``preproc.resize_weights``), built here when not given. `draws`, one
    dict per step as from ``draw_step``, overrides the steps' draws.
    labels: (N,) class of each clip (CPU), which the categorical model
    needs. Returns the metrics averaged over the k steps.

    With a data-parallel `mesh` every rank holds the whole pool, plans the
    global batch and gathers and resizes only its rows of the plan, in one
    launch of the ingest kernel a step; `draws` are the global ones."""
    cfg = state.cfg
    if cfg.model.conditional and labels is None:
        raise ValueError("the categorical model needs the pool's labels")
    _check_order(cfg)
    t, s = cfg.model.video_length, cfg.model.image_size
    if rh is None or rw is None:
        rh, rw = preproc.resize_weights(pool.shape[2], pool.shape[3], s,
                                        pool.device)
    lengths = torch.as_tensor(lengths).cpu()
    ms: List[Dict[str, torch.Tensor]] = []
    for i in range(k):
        with record_function("plan"):
            d = shard_draws(draws[i] if draws is not None else
                            draw_step(cfg, state.seed, state.step, lengths,
                                      state.device), mesh)
            frame_ix = sampling.window_indices(lengths, d["sel"],
                                               d["starts"], t)
            clip_ix = upload(d["sel"].to(torch.int32), pool.device)
            frame_ix = upload(frame_ix.to(torch.int32), pool.device)
            lab = (None if labels is None else
                   upload(torch.as_tensor(labels).cpu()[d["sel"]],
                          state.device))
        with record_function("ingest"):
            real = preproc.resize_normalize_gather(pool, clip_ix, frame_ix,
                                                   rh, rw)
        ms.append(train_step(state, real, d, lab, mesh))
    return {key: torch.stack([m[key] for m in ms]).mean() for key in ms[0]}


def multi_train_step(state: TrainState, batches: torch.Tensor,
                     frame_idx: Optional[torch.Tensor] = None,
                     labels: Optional[torch.Tensor] = None,
                     draws: Optional[Sequence[Draws]] = None,
                     mesh: Optional[Mesh] = None
                     ) -> Dict[str, torch.Tensor]:
    """k = batches.shape[0] steps on a stack of host batches on the state's
    device.

    batches: (K, B, T, H, W, C) float32 clips in [-1, 1], which go straight
    to ``train_step``; or uint8 clips at the stored resolution, which go
    through the ingest kernel once per step with the whole stack as its
    pool (``stack.view(K*B, T_raw, H, W, C)``, clips j*B .. j*B + B - 1 at
    step j), so no step copies its batch. frame_idx: (K, B, T) int32 frame
    indices into T_raw, needed for uint8 stacks whose T_raw is not
    ``video_length``. labels: (K, B) classes of the clips on the state's
    device, which the categorical model needs. `draws`, one dict per step
    as from ``draw_noise``, overrides the steps' noise. Returns the metrics
    averaged over the k steps.

    With a data-parallel `mesh`, `batches`, `frame_idx` and `labels` hold
    the rank's rows of each global batch (``HostFeed`` slices them) and
    `draws` the global draws; each step is the single-device step on the
    global batch."""
    cfg = state.cfg
    _check_order(cfg)
    k, b, t_raw = batches.shape[:3]
    t, s = cfg.model.video_length, cfg.model.image_size
    raw = batches.dtype == torch.uint8
    if raw:
        if frame_idx is None:
            if t_raw != t:
                raise ValueError(
                    f"multi_train_step: raw uint8 batches with T_raw={t_raw}"
                    f" != video_length={t} need explicit frame_idx (the "
                    f"temporal window selection)")
            frame_idx = torch.arange(t, dtype=torch.int32,
                                     device=batches.device).expand(k, b, t)
        frame_idx = frame_idx.to(batches.device, torch.int32).contiguous()
        pool = batches.contiguous().view(k * b, *batches.shape[2:])
        rh, rw = preproc.resize_weights(pool.shape[2], pool.shape[3], s,
                                        pool.device)
        clip_ix = torch.arange(k * b, dtype=torch.int32,
                               device=pool.device).view(k, b)
    ms: List[Dict[str, torch.Tensor]] = []
    for j in range(k):
        with record_function("plan"):
            n = 1 if mesh is None else mesh.world_size
            d = shard_draws(draws[j] if draws is not None else
                            draw_noise(cfg, state.seed, state.step, b * n,
                                       state.device), mesh)
        if raw:
            with record_function("ingest"):
                real = preproc.resize_normalize_gather(pool, clip_ix[j],
                                                       frame_idx[j], rh, rw)
        else:
            real = batches[j]
        ms.append(train_step(state, real, d,
                             None if labels is None else labels[j], mesh))
    return {key: torch.stack([m[key] for m in ms]).mean() for key in ms[0]}
