"""Data parallelism over N GPUs with ``torch.distributed``: one process per
device, the batch split over the processes, the state replicated.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX compiles one
program over a device mesh and GSPMD inserts the all-reduces, so its
sharded step equals the single-device step on the global batch. The port
runs the same step in every process on that process's rows and issues the
collectives itself, so that the equality holds here too:

  * every rank draws the noise, the S_1 indices and the clip plan of the
    GLOBAL batch from (seed, step, role) and keeps rows
    [r * B/n, (r + 1) * B/n) (``local_batch_slice``);
  * BatchNorm in train mode averages its fp32 batch mean and E[x^2] over
    the ranks before ``var = E[x^2] - mean^2`` (``all_reduce_mean``, which
    is differentiable: its backward sums the upstream gradients over the
    ranks), so every BN pass normalizes with the global batch's statistics;
  * each net's gradients are summed over the ranks in one flat fp32 bucket
    and divided by n. The step takes gradients with ``torch.autograd.grad``,
    which ``DistributedDataParallel``'s reducer hooks never see, so the
    all-reduce is explicit;
  * the step's metrics are averaged over the ranks, so every rank returns
    the global batch's means, as JAX's replicated metrics are.
Every rank applies the same reduced gradient, so the parameters stay
bit-identical across ranks; ``check_replicated`` asserts it.

Every collective the step issues is counted by kind in ``TRAFFIC`` (calls
and the bytes of the tensor each call reduces), and timed inside
``timed_collectives``: the data-parallel layer's own accounting, which
``mocogan_tpu_torch.scaling_dossier`` reports.

Launch: under ``torchrun`` (``initialize_distributed`` reads RANK,
WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/PORT from its environment), or
``python -m mocogan_tpu_torch.train --num-devices N``, which spawns N
workers itself. Without a process group (one plain process) no collective
is issued at all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist


# Collectives issued in this process, by kind: {kind: {"calls", "bytes"}},
# the bytes of the tensor each call reduces or broadcasts. A run resets and
# reads it. The step's kinds: "bn" and "bn_backward" (BatchNorm's batch
# statistics and their gradient), "grad_<net>" (each net's gradient
# bucket), "metrics"; apart from the step: "replication"
# (``check_replicated``) and "barrier". Without a process group nothing is
# issued and nothing is counted.
TRAFFIC: Dict[str, Dict[str, int]] = {}
# while ``timed_collectives`` runs: (kind, start, end) of each call
_TIMED: Optional[list] = None


@contextlib.contextmanager
def _collective(kind: str, t: Optional[torch.Tensor] = None):
    """Count one collective of `kind` on `t` (None: moves no data) around
    the block that issues it; time it while ``timed_collectives`` runs."""
    c = TRAFFIC.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    if t is not None:
        c["bytes"] += t.numel() * t.element_size()
    if _TIMED is None:
        yield
        return
    if t is not None and t.is_cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        yield
        end.record()
    else:
        start = time.perf_counter()
        yield
        end = time.perf_counter()
    _TIMED.append((kind, start, end))


@contextlib.contextmanager
def timed_collectives():
    """Time every collective issued in the block. Yields a dict that holds,
    once the block ends, the summed ms of each kind: CUDA events around a
    call on a CUDA tensor (the card's time from reaching the call to its
    end), the host clock around the others. Blocks do not nest."""
    global _TIMED
    if _TIMED is not None:
        raise RuntimeError("timed_collectives blocks do not nest")
    calls: list = []
    out: Dict[str, float] = {}
    _TIMED = calls
    try:
        yield out
    finally:
        _TIMED = None
    if any(isinstance(s, torch.cuda.Event) for _, s, _ in calls):
        torch.cuda.synchronize()
    for kind, s, e in calls:
        ms = s.elapsed_time(e) if isinstance(s, torch.cuda.Event) \
            else 1e3 * (e - s)
        out[kind] = out.get(kind, 0.0) + ms


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world.

    collective: a process group is up, so the step issues its all-reduces
    (also in a world of one, e.g. a one-rank ``torchrun``); without one the
    mesh is the plain single-device step."""
    world_size: int
    rank: int
    local_rank: int
    n_slices: int
    device: torch.device
    collective: bool

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The device of a rank: `device` itself when it names one (``cpu``,
    ``cuda:0``), else (``cuda`` or None) ``cuda:<local_rank>``. A rank
    without its GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    have = torch.cuda.device_count()
    if dev.index >= have:
        raise RuntimeError(f"no CUDA device {dev} for local rank "
                           f"{local_rank}: {have} CUDA devices are visible")
    return dev


def initialize_distributed(device, backend: Optional[str] = None,
                           init_method: Optional[str] = None) -> bool:
    """Join the process group that the environment describes; a no-op
    (returns False) without one. True when a group is up.

    The rank and world come from RANK and WORLD_SIZE, as ``torchrun`` and
    the train CLI's own workers set them; the rendezvous is
    ``init_method`` or, by default, ``env://`` (MASTER_ADDR/MASTER_PORT).
    The backend is ``nccl`` for CUDA devices and ``gloo`` for the CPU
    unless `backend` says otherwise (gloo also runs all_reduce, broadcast
    and barrier on CUDA tensors, e.g. for two ranks sharing one card)."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, _env_int("LOCAL_RANK",
                                                        rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    return True


def make_mesh(num_devices: Optional[int] = None, n_slices: int = 1,
              device=None) -> Mesh:
    """The mesh of this process: one device per process over the whole
    world (the process group's, or a world of one without a group).

    num_devices None means the world size. More devices than the world
    holds raise as JAX's ``make_mesh`` does; fewer raise too, since every
    process of the world is one device of the mesh (JAX would take a
    subset of its local devices).

    n_slices > 1 is multi-node data parallelism, JAX's (dcn, data) mesh.
    The world must divide into n_slices; where the launcher says how many
    processes run on each node (LOCAL_WORLD_SIZE, set by ``torchrun``;
    ranks are numbered node by node), the nodes must be n_slices of equal
    size, the check JAX makes on the devices' slice_index. The batch is
    split slice-major over the flat world, which is the rank order, and the
    all-reduce is the flat one over all ranks: NCCL already reduces within
    a node over NVLink and across nodes over the network. `device`: as
    ``rank_device`` takes it."""
    if dist.is_available() and dist.is_initialized():
        world, rank, collective = dist.get_world_size(), dist.get_rank(), True
    else:
        world, rank, collective = 1, 0, False
    if num_devices is not None:
        if num_devices > world:
            raise ValueError(f"requested {num_devices} devices, have {world}")
        if num_devices < world:
            raise ValueError(
                f"requested {num_devices} devices, but the world has {world} "
                f"processes: each process is one device of the mesh")
    if n_slices > 1:
        if world % n_slices:
            raise ValueError(f"{world} devices not divisible into "
                             f"{n_slices} slices")
        per_node = _env_int("LOCAL_WORLD_SIZE", 0)
        if per_node:
            _check_nodes(world, per_node, n_slices)
    local_rank = _env_int("LOCAL_RANK", rank)
    return Mesh(world, rank, local_rank, n_slices,
                rank_device(device, local_rank), collective)


def _check_nodes(world: int, per_node: int, n_slices: int) -> None:
    """Ranks r // per_node share a node: there must be n_slices nodes, all
    of one size (JAX's ``_order_by_slice`` checks and messages, with the
    node index as the slice_index)."""
    counts: dict = {}
    for r in range(world):
        counts[r // per_node] = counts.get(r // per_node, 0) + 1
    if len(counts) != n_slices:
        raise ValueError(
            f"devices span {len(counts)} physical slices (slice_index values "
            f"{sorted(counts)}) but n_slices={n_slices}; a (dcn, data) mesh "
            f"must match the physical slice topology")
    if len(set(counts.values())) != 1:
        raise ValueError(
            f"unbalanced slices: {counts} — every slice must contribute "
            f"the same chip count")


def local_batch_slice(mesh: Mesh, *arrays: Any, axis: int = 0) -> Any:
    """This rank's rows [r * B/n, (r + 1) * B/n) of each array's global
    batch axis (numpy arrays or tensors; a tensor's slice is a view);
    None passes through; a world of one returns the arrays as they are.
    Raises when B does not divide by the world size."""
    n = mesh.world_size
    if n == 1:
        return arrays if len(arrays) > 1 else arrays[0]
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        b = a.shape[axis]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by "
                             f"{n} processes")
        lb = b // n
        lo = mesh.rank * lb
        out.append(a[(slice(None),) * axis + (slice(lo, lo + lb),)])
    return tuple(out) if len(out) > 1 else out[0]


def local_batch_size(cfg, mesh: Mesh) -> int:
    """This rank's share of ``train.batch_size``."""
    global_b = cfg.train.batch_size
    n = mesh.world_size
    if global_b % n:
        raise ValueError(f"global batch {global_b} not divisible by "
                         f"{n} devices")
    return global_b // n


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks; its backward is the SUM of the upstream
    gradients over the ranks (each rank's input reaches every rank's
    output). Counted as `kind` and "<kind>_backward"."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        y = x.contiguous().clone()
        with _collective(kind, y):
            dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        with _collective(ctx.kind + "_backward", g):
            dist.all_reduce(g)
        return g, None


def all_reduce_mean(x: torch.Tensor, mesh: Optional[Mesh],
                    kind: str) -> torch.Tensor:
    """The mean of `x` over the ranks, differentiable, counted in
    ``TRAFFIC`` as `kind`; `x` itself without a process group."""
    if mesh is None or not mesh.collective:
        return x
    return _AllReduceSum.apply(x, kind) / mesh.world_size


def all_reduce_grads(grads: List[torch.Tensor], mesh: Optional[Mesh],
                     kind: str) -> List[torch.Tensor]:
    """Each gradient averaged over the ranks, through one flat fp32 bucket
    (one all-reduce per call, counted as `kind`); returned as views of
    that bucket."""
    if mesh is None or not mesh.collective or not grads:
        return grads
    flat = all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]), mesh,
                           kind)
    return [part.view(g.shape) for part, g in zip(
        flat.split([g.numel() for g in grads]), grads)]


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is None or not mesh.collective:
        return
    with _collective("barrier"):
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An exact, order-free checksum of a tensor's values: the sum of its
    fp32 bit patterns (integers: of the values) in int64."""
    x = t.detach().reshape(-1)
    if x.dtype.is_floating_point:
        x = x.float().view(torch.int32)
    return x.to(torch.int64).sum()


def check_replicated(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh],
                     what: str = "state") -> None:
    """Raise on every rank unless every rank holds the same `tensors`, bit
    for bit: rank 0 broadcasts its checksums, each rank compares its own,
    and one all-reduce tells every rank whether any differed."""
    if mesh is None or not mesh.collective:
        return
    mine = torch.stack([_bits(t).to(mesh.device) for t in tensors])
    ref = mine.clone()
    with _collective("replication", ref):
        dist.broadcast(ref, src=0)
    bad = (mine != ref).any().to(torch.int64).view(1)
    with _collective("replication", bad):
        dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    if int(bad.item()):
        raise RuntimeError(f"the {what} differs across ranks: every rank "
                           f"must hold the same replicated {what}")
