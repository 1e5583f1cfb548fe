"""The dtype x batch matrix of the mug train step, in this process.

    python -m mocogan_tpu_torch.measure_perf [--scan-k 16] [--device cpu]

For each (dtype, batch) cell:
  * single: ``time_single_step``, one train_step a call on a resident
    batch;
  * scan-k: ``time_cached_scan``, the device-cached path the trainer runs:
    k steps a call, each gathering and resizing its batch in one launch of
    the ingest kernel.

Both are the timers of ``utils/benchmarking.py`` that the benchmark's
stages call (``python -m mocogan_tpu_torch.bench``), so the two cannot
diverge. TF32 is off for matmuls and cuDNN (full fp32), and every cell
carries that setting with the card's name and power limit. Prints one
line per cell, then the JSON matrix.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    """Run the matrix; returns it as printed."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--scan-k", type=int, default=16)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu for the CPU tests")
    ap.add_argument("--set", nargs="*", metavar="K=V", dest="overrides",
                    help="config overrides for every cell")
    args = ap.parse_args(argv)

    from mocogan_tpu_torch import bench, get_config
    from mocogan_tpu_torch.train.__main__ import parse_overrides
    from mocogan_tpu_torch.utils import benchmarking
    from mocogan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    card = {k: v for k, v in bench.device_info(dev).items()
            if k in ("device", "name", "power_limit")}
    tf32 = bench.set_tf32("off")
    overrides = parse_overrides(args.overrides)
    results = {}
    for dtype in args.dtypes:
        for b in args.batches:
            cfg = get_config("mug", **{**overrides,
                                       "train.batch_size": b,
                                       "model.compute_dtype": dtype})
            single = benchmarking.time_single_step(cfg, args.steps,
                                                   args.warmup, device=dev)
            scan = benchmarking.time_cached_scan(cfg, k=args.scan_k,
                                                 reps=args.reps, device=dev)
            results[f"{dtype}_b{b}"] = {
                "single_steps_per_sec": single,
                "scan_steps_per_sec": scan,
                "scan_clips_per_sec": round(scan["best"] * b, 1),
                "card": card, "tf32": tf32}
            print(f"[{dtype} b={b}] single={single['best']:.2f} "
                  f"(med {single['median']:.2f}) "
                  f"scan{args.scan_k}={scan['best']:.2f} "
                  f"(med {scan['median']:.2f}) steps/s "
                  f"({scan['best'] * b:.0f} clips/s)", flush=True)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
