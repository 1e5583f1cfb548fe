"""Training CLI of the port.

Device-cached when data.device_cache is on and the dataset is a clip store
(the `mug` config), host-fed otherwise (the `toy` config's synthetic
batches, or any store with data.device_cache=false). A run resumes from
the latest checkpoint in its out dir unless given --no-resume.

Data parallelism, one process per GPU, the global batch split over them:
under ``torchrun`` each process runs this CLI and joins the world its
environment describes; otherwise, when train.num_devices (--num-devices)
or, without it, the number of visible GPUs is above 1, the CLI spawns that
many workers itself (``--device cpu --num-devices 2`` runs two gloo
workers on the CPU). Rank 0 writes the log, checkpoints and samples.

Examples:
    python -m mocogan_tpu_torch.train --config toy --total-steps 2000
    python -m mocogan_tpu_torch.data.synthetic --out data/synth96
    python -m mocogan_tpu_torch.train --config mug --data-dir data/synth96 \\
        --total-steps 256
    python -m mocogan_tpu_torch.train --config mug --data-dir D \\
        --set data.device_cache=false train.log_every=16 --device cpu
    python -m mocogan_tpu_torch.train --config scaled --data-dir D \\
        --num-devices 8
    torchrun --nproc-per-node 8 -m mocogan_tpu_torch.train --config scaled \\
        --data-dir D
"""

from __future__ import annotations

import argparse
import ast
import os
import sys

_KEYWORDS = {"true": True, "false": False, "none": None,
             "True": True, "False": False, "None": None}


def parse_overrides(pairs):
    """["k=v", ...] -> {k: literal v}; true/false/none map to Python's."""
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        if v in _KEYWORDS:
            out[k] = _KEYWORDS[v]
            continue
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def main(argv=None, init_method=None):
    """Run the CLI. `init_method`: the rendezvous of a rank that
    ``parallel.launch.spawn`` started."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="toy",
                    help="toy | mug | weizmann | categorical | scaled")
    ap.add_argument("--data-dir", default=None,
                    help="uint8 clip store (see mocogan_tpu_torch.data."
                         "synthetic); not needed for the synthetic dataset")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--total-steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--num-devices", type=int, default=None,
                    help="GPUs (processes) to train on; default: under "
                         "torchrun its world, else every visible GPU")
    ap.add_argument("--no-resume", action="store_true",
                    help="start from step 0 even if the out dir holds "
                         "checkpoints")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection, and raise "
                         "FloatingPointError on the first non-finite loss")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the first "
                         "min(20, total) steps here, then go on unprofiled")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--set", nargs="*", metavar="K=V", dest="overrides",
                    help="dotted config overrides, e.g. train.log_every=16")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.overrides)
    for flag, key in (("data_dir", "data.data_dir"),
                      ("total_steps", "train.total_steps"),
                      ("batch_size", "train.batch_size"),
                      ("seed", "train.seed"),
                      ("num_devices", "train.num_devices")):
        if getattr(args, flag) is not None:
            overrides[key] = getattr(args, flag)

    import torch

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.parallel import launch
    from mocogan_tpu_torch.parallel import mesh as pmesh
    from mocogan_tpu_torch.utils.platform import resolve_device

    cfg = get_config(args.config, **overrides)
    if cfg.data.dataset != "synthetic" and not cfg.data.data_dir:
        ap.error(f"dataset {cfg.data.dataset!r} needs --data-dir")
    device = resolve_device(args.device)
    # one rank a device: train.num_devices, else every visible GPU
    world = cfg.train.num_devices or (
        torch.cuda.device_count()
        if device.type == "cuda" and device.index is None else 1)
    if world > 1 and "WORLD_SIZE" not in os.environ:
        if device.type == "cuda" and world > torch.cuda.device_count():
            raise ValueError(f"requested {world} devices, have "
                             f"{torch.cuda.device_count()}")
        return launch.spawn(world, "mocogan_tpu_torch.train.__main__", argv)
    joined = not torch.distributed.is_initialized() and \
        pmesh.initialize_distributed(device, init_method=init_method)
    try:
        _train(args, cfg, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, cfg, device) -> None:
    import torch

    from mocogan_tpu_torch.train.loop import Trainer, make_data_iterator

    trainer = Trainer(cfg, out_dir=args.out_dir, resume=not args.no_resume,
                      device=device)
    trainer._say(f"[train] config={cfg.name} model={cfg.model} "
                 f"train={cfg.train}; {trainer.mesh.world_size} device(s)")
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
        trainer.state.debug_nans = True

    def run(total_steps=None):
        # the synthetic dataset has no store to keep on the device
        if cfg.data.device_cache and cfg.data.dataset != "synthetic":
            return trainer.run_device_cached(total_steps)
        # the data stream resumes exactly at the restored step
        return trainer.run(make_data_iterator(cfg, trainer.state.step),
                           total_steps)

    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            run(total_steps=min(20, cfg.train.total_steps))
        os.makedirs(args.profile_dir, exist_ok=True)
        rank = trainer.mesh.rank
        path = os.path.join(args.profile_dir, "trace.json" if not rank
                            else f"trace_rank{rank}.json")
        prof.export_chrome_trace(path)
        print(f"[train] profile written to {path}; continuing unprofiled")
    run()


if __name__ == "__main__":
    main()
