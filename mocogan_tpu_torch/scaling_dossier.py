"""Data-parallel accounting of the port: the counterpart of the JAX
package's ``scripts/scaling_dossier.py``, with its keys where they apply.

  1. Traffic, for ``mug`` and ``scaled``: one train step in a two-rank
     gloo world (both ranks on card 0, or on the CPU with --device cpu),
     counted by ``parallel.mesh.TRAFFIC``: calls and bytes a step per rank
     by kind (each net's gradient bucket, the BN statistics and their
     gradient, the metrics), the replication check apart; ``param_count``
     by net and the analytic ring all-reduce, 2(n-1)/n x 4 B x n_params,
     at n = 2 and 8; beside them the JAX package's recorded figure,
     reconciled by net. Like the JAX script's HLO parse, the counter
     counts the bytes of the buffer each call reduces; the ring formula
     counts what each rank sends. The two agree at n = 2.
  2. All-reduce ms: each net's gradient bucket alone at its real size, and
     the summed collectives of one whole step
     (``parallel.mesh.timed_collectives``), in that gloo world and in a
     one-rank world (NCCL on the card, gloo on the CPU). CUDA events on
     the card, the host clock on the CPU; every figure is labelled with
     its backend, world and device. Gloo on one card stages each call
     through host memory: no estimate of NCCL across cards.
  3. Weak scaling: step ms at 8 clips a rank (mug) for n = 1 .. the cards
     visible, over NCCL; null, with the reason, below two cards.
The worlds run one after another, each alone on its devices; a later
world is spawned with the first and starts up while the earlier ones run
(``run_worlds``).

Usage:
  python -m mocogan_tpu_torch.scaling_dossier [--out DIR] [--device cpu]
      [--set K=V ...]

--set applies config overrides to every world (e.g. a small geometry on
the CPU); the JAX reconciliation is written only at the configs' own
widths. Writes DIR/dossier.json (default runs/scaling_dossier) and prints
one JSON line of the headline figures.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Tuple

CONFIGS = ("mug", "scaled")
ITERS = 10              # timed all-reduces of each bucket
WEAK_PER_RANK = 8       # clips a rank in the weak-scaling sweep (mug)
WEAK_STEPS = 8          # timed steps a world, after 2 warm-up steps
TIMEOUT_S = 600         # one world, start to end
# The JAX package's 8-device all-reduce bytes a step, parsed from its
# optimized HLO (docs/results/scaling/dossier.json, traffic_<config>).
JAX_RECORDED = {"mug": 55_239_184, "scaled": 55_509_520}


def ring_bytes(n_params: int, n: int) -> int:
    """Bytes each rank sends in a ring all-reduce of n_params fp32 values
    over n ranks (the JAX script's formula)."""
    return int(2 * (n - 1) / n * 4 * n_params)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_all_reduce(numel: int, dev) -> float:
    """ms per all-reduce of `numel` fp32 values on `dev`, over ITERS
    calls after two warm-up calls; CUDA events on the card, the host clock
    on the CPU."""
    import torch
    import torch.distributed as dist

    x = torch.zeros(numel, device=dev)
    for _ in range(2):
        dist.all_reduce(x)
    _sync(dev)
    dist.barrier()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(ITERS):
            dist.all_reduce(x)
        return 1e3 * (time.perf_counter() - t0) / ITERS
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(ITERS):
        dist.all_reduce(x)
    ev[1].record()
    torch.cuda.synchronize(dev)
    return ev[0].elapsed_time(ev[1]) / ITERS


def _clips(cfg, b: int, dev, seed: int):
    """b random clips (B, T, S, S, C) in [-1, 1] on `dev`: the traffic and
    the step's time do not depend on what they show."""
    import torch

    m = cfg.model
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, m.video_length, m.image_size, m.image_size,
                        m.channels), generator=g) * 2 - 1).to(dev)


def _traffic_rank(mesh, overrides: dict) -> dict:
    """Per config: the state (its replication check counted apart), one
    warm-up step, then one step counted and timed, then each net's bucket
    timed alone."""
    import torch

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.parallel import mesh as pmesh
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.train import step as train_step

    dev = mesh.device
    out = {}
    for name in CONFIGS:
        cfg = get_config(name, **{**overrides,
                                  "train.num_devices": mesh.world_size})
        pmesh.TRAFFIC.clear()
        state = train_state.create(cfg, device=dev, mesh=mesh)
        outside = {k: dict(v) for k, v in pmesh.TRAFFIC.items()}
        real = _clips(cfg, pmesh.local_batch_size(cfg, mesh), dev,
                      mesh.rank)
        train_step.train_step(state, real, mesh=mesh)      # warm-up
        _sync(dev)
        pmesh.TRAFFIC.clear()
        with pmesh.timed_collectives() as ms:
            t0 = time.perf_counter()
            train_step.train_step(state, real, mesh=mesh)
            _sync(dev)
            step_ms = 1e3 * (time.perf_counter() - t0)
        step = {k: dict(v) for k, v in pmesh.TRAFFIC.items()}
        params = train_state.param_count(state)
        del state, real
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[name] = {
            "step": step, "outside_step": outside, "param_count": params,
            "step_ms": step_ms, "step_collectives_ms": ms,
            "bucket_ms": {net: _time_all_reduce(n, dev)
                          for net, n in params.items()}}
    return out


def _weak_rank(mesh, overrides: dict, steps: int) -> dict:
    """ms a step of mug at WEAK_PER_RANK clips a rank over this world."""
    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.train import step as train_step

    n, dev = mesh.world_size, mesh.device
    cfg = get_config("mug", **{**overrides,
                               "train.batch_size": WEAK_PER_RANK * n,
                               "train.num_devices": n})
    state = train_state.create(cfg, device=dev, mesh=mesh)
    real = _clips(cfg, WEAK_PER_RANK, dev, mesh.rank)
    for _ in range(2):
        train_step.train_step(state, real, mesh=mesh)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        train_step.train_step(state, real, mesh=mesh)
    _sync(dev)
    return {"per_rank_batch": WEAK_PER_RANK,
            "global_batch": cfg.train.batch_size,
            "step_ms": 1e3 * (time.perf_counter() - t0) / steps}


_JOBS = {"traffic": _traffic_rank, "weak": _weak_rank}


def _rank(rank: int, world: int, init_method: str, backend: str,
          device: str, job: str, args: tuple, out_dir: str,
          after: List[str]) -> None:
    """One rank (``torch.multiprocessing`` target): join the world, wait
    until every file of `after` exists, run `job`, write its result to
    <out_dir>/rank<r>.json."""
    import torch

    from mocogan_tpu_torch.parallel import mesh as pmesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = torch.device(device)
    pmesh.initialize_distributed(dev, backend=backend,
                                 init_method=init_method)
    try:
        mesh = pmesh.make_mesh(world, 1, dev)
        while not all(os.path.exists(f) for f in after):
            time.sleep(0.2)
        out = _JOBS[job](mesh, *args)
    finally:
        torch.distributed.destroy_process_group()
    path = os.path.join(out_dir, f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def run_worlds(specs: List[tuple]) -> List[Tuple[List[dict], float]]:
    """Run worlds one after another, each spec (job, world, device,
    backend, args): `world` ranks on `device` (``cuda:0``: all on card 0;
    ``cuda``: rank r on card r; ``cpu``) over `backend`. All are spawned
    at once, so each world starts up while the ones before it run; its
    ranks run their job once the world before has ended. Per world, each
    rank's result and the seconds from the previous world's end (the
    spawn, for the first) to its own. A rank that fails, or worlds that
    run past TIMEOUT_S each, raise here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mocogan_dossier_") as tmp:
        started, after = [], []
        try:
            for i, (job, world, device, backend, args) in enumerate(specs):
                d = os.path.join(tmp, str(i))
                os.makedirs(d)
                started.append((d, world, mp.start_processes(
                    _rank, args=(world, "file://" + os.path.join(d, "store"),
                                 backend, device, job, args, d, after),
                    nprocs=world, join=False, start_method="spawn")))
                after = [os.path.join(d, f"rank{r}.json")
                         for r in range(world)]
            out = []
            t0 = t = time.perf_counter()
            for d, world, ctx in started:
                while not ctx.join(timeout=0.5):    # raises if a rank failed
                    if time.perf_counter() - t0 > TIMEOUT_S * len(specs):
                        raise TimeoutError(f"worlds {specs} ran past "
                                           f"{TIMEOUT_S} s each")
                ranks = []
                for r in range(world):
                    with open(os.path.join(d, f"rank{r}.json")) as f:
                        ranks.append(json.load(f))
                out.append((ranks, time.perf_counter() - t))
                t = time.perf_counter()
            return out
        finally:
            for _, _, ctx in started:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()


def weak_scaling(device: str, max_world: int, backend: str,
                 overrides: Optional[dict] = None,
                 steps: int = WEAK_STEPS) -> Dict[str, dict]:
    """{n: rank 0's step ms} for n = 1 .. max_world ranks (``cuda``: one
    card a rank)."""
    ns = range(1, max_world + 1)
    res = run_worlds([("weak", n, device, backend, (overrides or {}, steps))
                      for n in ns])
    return {str(n): ranks[0] for n, (ranks, _) in zip(ns, res)}


def _step_bytes(step: dict) -> int:
    return sum(v["bytes"] for v in step.values())


def _summary(name: str, two: List[dict], one: List[dict], labels: dict,
             full_width: bool) -> dict:
    """The dossier's entry of one config from the two worlds' ranks."""
    ranks = [r[name] for r in two]
    first = ranks[0]
    if any(r["step"] != first["step"] for r in ranks[1:]):
        raise AssertionError(f"{name}: the ranks issued different "
                             f"collectives: {[r['step'] for r in ranks]}")
    if one[0][name]["step"] != first["step"]:
        raise AssertionError(f"{name}: the one-rank world issued "
                             f"{one[0][name]['step']}, the two-rank world "
                             f"{first['step']}")
    params = first["param_count"]
    n_params = sum(params.values())
    step = first["step"]
    total = _step_bytes(step)
    grads = {net: step[f"grad_{net}"]["bytes"] for net in params}
    out = {
        "config": name, "n_devices": 2, "param_count": n_params,
        "param_count_by_net": params,
        "collective_bytes_per_step": {"all-reduce": total},
        "collective_bytes_total": total,
        "calls_per_step": sum(v["calls"] for v in step.values()),
        "by_kind": step, "outside_step": first["outside_step"],
        "grad_bucket_bytes": grads,
        "grad_bucket_bytes_total": sum(grads.values()),
        "analytic_ring_allreduce_bytes": ring_bytes(n_params, 2),
        "analytic_ring_allreduce_bytes_by_n": {
            str(n): ring_bytes(n_params, n) for n in (2, 8)},
        "allreduce_ms": {},
    }
    for world, res in (("two", two), ("one", one)):
        r = res[0][name]
        out["allreduce_ms"][labels[world]] = {
            "bucket_ms": r["bucket_ms"],
            "bucket_ms_by_rank": [x[name]["bucket_ms"] for x in res],
            "step_collectives_ms": r["step_collectives_ms"],
            "step_collectives_ms_total": sum(
                r["step_collectives_ms"].values()),
            "step_ms": r["step_ms"]}
    if full_width:
        jax = JAX_RECORDED[name]
        d = grads["di"] + grads["dv"]
        out["jax"] = {
            "recorded_all_reduce_bytes": jax, "n_devices": 8,
            "source": "docs/results/scaling/dossier.json",
            "di_plus_dv_grad_bytes": d,
            "recorded_minus_di_dv": jax - d,
            "gen_grad_bytes": grads["gen"],
            "port_grad_minus_recorded": out["grad_bucket_bytes_total"] - jax,
            "reading": (
                "the JAX step draws its noise replicated, so every device "
                "runs the whole generator and G's gradient needs no "
                "all-reduce; the port splits the noise over the ranks and "
                "all-reduces G's bucket. The rest of JAX's figure is "
                "smaller all-reduces (BN statistics of the real passes)")}
    return out


def card() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it
    (the first card)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (FileNotFoundError, subprocess.CalledProcessError):
        import torch

        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def build(device=None, overrides: Optional[dict] = None) -> dict:
    """The dossier: traffic and all-reduce ms in a two-rank gloo world and
    a one-rank world on `device` (default card 0; ``cpu``), weak scaling
    where two or more cards are visible."""
    import torch

    from mocogan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    overrides = dict(overrides or {})
    cuda = dev.type == "cuda"
    where = "cuda:0" if cuda else "cpu"
    one_backend = "nccl" if cuda else "gloo"
    what = card() if cuda else "cpu"
    labels = {"two": f"gloo, 2 ranks on {where}",
              "one": f"{one_backend}, 1 rank on {where}"}
    (two, two_s), (one, one_s) = run_worlds([
        ("traffic", 2, where, "gloo", (overrides,)),
        ("traffic", 1, where, one_backend, (overrides,))])
    out = {"device": what, "clock": "cuda events" if cuda else "host",
           "overrides": overrides,
           # the two-rank world from its spawn, the one-rank world (started
           # up meanwhile) from the two-rank world's end
           "world_seconds": {labels["two"]: two_s, labels["one"]: one_s}}
    for name in CONFIGS:
        out[f"traffic_{name}"] = _summary(name, two, one, labels,
                                          not overrides)
    n_cards = torch.cuda.device_count() if cuda else 0
    if n_cards >= 2:
        out["weak_scaling"] = weak_scaling("cuda", n_cards, "nccl",
                                           overrides)
        out["weak_scaling_reason"] = None
    else:
        out["weak_scaling"] = None
        out["weak_scaling_reason"] = (
            f"{n_cards} card visible: weak scaling needs two or more"
            if cuda else "device cpu: the sweep runs over cards")
    return out


def main(argv=None) -> dict:
    """Run the CLI; returns the dossier written to dossier.json."""
    from mocogan_tpu_torch.train.__main__ import parse_overrides

    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=os.path.join("runs", "scaling_dossier"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--set", nargs="*", metavar="K=V", dest="overrides",
                    help="config overrides for every world")
    args = ap.parse_args(argv)
    out = build(args.device, parse_overrides(args.overrides))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "dossier.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({"device": out["device"], **{
        name: {"grad_bucket_bytes_total":
               out[f"traffic_{name}"]["grad_bucket_bytes_total"],
               "collective_bytes_total":
               out[f"traffic_{name}"]["collective_bytes_total"],
               "calls_per_step": out[f"traffic_{name}"]["calls_per_step"]}
        for name in CONFIGS}}))
    print(f"[scaling_dossier] wrote {path}")
    return out


if __name__ == "__main__":
    main()
