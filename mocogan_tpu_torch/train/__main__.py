"""Training CLI of the port.

Device-cached when data.device_cache is on and the dataset is a clip store
(the `mug` config), host-fed otherwise (the `toy` config's synthetic
batches, or any store with data.device_cache=false). A run resumes from
the latest checkpoint in its out dir unless given --no-resume.

Examples:
    python -m mocogan_tpu_torch.train --config toy --total-steps 2000
    python -m mocogan_tpu_torch.data.synthetic --out data/synth96
    python -m mocogan_tpu_torch.train --config mug --data-dir data/synth96 \\
        --total-steps 256
    python -m mocogan_tpu_torch.train --config mug --data-dir D \\
        --set data.device_cache=false train.log_every=16 --device cpu
"""

from __future__ import annotations

import argparse
import ast
import os

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


def main(argv=None):
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
                    help="1 only: multi-GPU training is not ported yet")
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
    from mocogan_tpu_torch.train.loop import Trainer, make_data_iterator

    cfg = get_config(args.config, **overrides)
    if cfg.data.dataset != "synthetic" and not cfg.data.data_dir:
        ap.error(f"dataset {cfg.data.dataset!r} needs --data-dir")
    print(f"[train] config={cfg.name} model={cfg.model} train={cfg.train}")
    trainer = Trainer(cfg, out_dir=args.out_dir, resume=not args.no_resume,
                      device=args.device)
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
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"[train] profile written to {path}; continuing unprofiled")
    run()


if __name__ == "__main__":
    main()
