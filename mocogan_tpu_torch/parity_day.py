"""One-command reference-parity runner of the port: the counterpart of the
JAX package's ``scripts/parity_day.py``, with the same flags (plus
``--device``), stages and artifacts.

Given any subset of:

  --reference-npz / --snapshot-npz   a Chainer save_npz generator (or a
                                     whole Trainer snapshot, split per net)
  --i3d-ckpt / --i3d-weights         the public kinetics-i3d TF checkpoint
                                     (converted here; needs TensorFlow) or
                                     an already-converted npz
  --data-dir                         a preprocessed real clip store
  --run-dir                          one of the port's trained runs
  --our-log / --reference-log        log.jsonl files for the loss-curve
                                     comparator

this runs, in order, skipping the stages whose inputs are absent:

  1. import the reference checkpoint -> per-tensor match report
     (``import_report.json``)
  2. fp32 generate() digest of the imported generator, determinism
     asserted (``reference_generate_digest.json``)
  3. convert the I3D checkpoint, if --i3d-ckpt (``i3d_converted.npz``)
  4. FVD: reference-vs-real, ours-vs-real, ours-vs-reference — absolute
     I3D-FVD when weights are given, a labelled relative proxy otherwise
     (``fvd.json``). The real clips are one pool of windows of the store,
     resized by the ingest kernel on the card in one launch.
  5. the loss-curve comparator (``compare.json``, ``overlay.png`` where
     matplotlib is installed) when both logs are given

and writes ``summary.json`` with every stage's result and seconds under
--out. The port's random-projection proxy has the port's own weights: its
values compare with the port's, not with the JAX package's.

Example (once the reference files exist):
  python -m mocogan_tpu_torch.parity_day --config mug \\
      --snapshot-npz snapshot_iter_100000.npz \\
      --i3d-weights i3d.npz --data-dir data/mug --run-dir runs/mug \\
      --out parity_day
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)


def main(argv=None) -> dict:
    """Run the CLI; returns the summary written to summary.json."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="mug")
    ap.add_argument("--reference-npz", default=None,
                    help="Chainer save_npz of the reference generator")
    ap.add_argument("--snapshot-npz", default=None,
                    help="whole Chainer Trainer snapshot (split per net)")
    ap.add_argument("--rename", nargs="*", metavar="ACTUAL=CANONICAL",
                    help="npz key renames adapting the real naming")
    ap.add_argument("--no-strict", action="store_true")
    ap.add_argument("--i3d-ckpt", default=None,
                    help="kinetics-i3d TF checkpoint dir/prefix (converted "
                         "to npz under --out; needs TensorFlow)")
    ap.add_argument("--i3d-weights", default=None,
                    help="already-converted I3D npz (eval/i3d.py contract)")
    ap.add_argument("--data-dir", default=None,
                    help="preprocessed real clip store for FVD")
    ap.add_argument("--run-dir", default=None,
                    help="the port's trained run (checkpoints/) for "
                         "ours-vs-reference")
    ap.add_argument("--our-log", default=None)
    ap.add_argument("--reference-log", default=None,
                    help="reference losses as log.jsonl (step + loss_*)")
    ap.add_argument("--n", type=int, default=256,
                    help="clips per side for FVD")
    ap.add_argument("--digest-n", type=int, default=2,
                    help="clips in the parity digest")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="parity_day")
    ap.add_argument("--set", nargs="*", metavar="K=V", dest="overrides")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mocogan_tpu_torch import eval_fvd, get_config
    from mocogan_tpu_torch.eval import fvd as fvd_mod
    from mocogan_tpu_torch.eval import parity
    from mocogan_tpu_torch.models import generator
    from mocogan_tpu_torch.train.__main__ import parse_overrides
    from mocogan_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.config, **parse_overrides(args.overrides))
    os.makedirs(args.out, exist_ok=True)
    summary: dict = {"stages": {}, "seconds": {}}
    clock = [time.perf_counter()]

    def done(stage: str) -> None:
        now = time.perf_counter()
        summary["seconds"][stage] = now - clock[0]
        clock[0] = now

    # -- 1. import the reference checkpoint -------------------------------
    ref_state = None
    if args.reference_npz or args.snapshot_npz:
        from mocogan_tpu_torch.eval import import_chainer

        ref_state, reports = import_chainer.import_experiment(
            cfg, gen_npz=args.reference_npz, snapshot_npz=args.snapshot_npz,
            rename=import_chainer.parse_rename(args.rename),
            strict=not args.no_strict, device=device)
        path = os.path.join(args.out, "import_report.json")
        _write_json(path, reports)
        net_counts = {net: len(rep.get("matched", []))
                      for net, rep in reports.items() if net != "snapshot"}
        print(f"[parity_day] import: {net_counts} tensors matched "
              f"-> {path}")
        summary["stages"]["import"] = {"report": path,
                                       "matched": net_counts}
        done("import")

        # -- 2. fp32 digest of the imported generator ---------------------
        rep = parity.check_determinism(ref_state.nets["gen"],
                                       n=args.digest_n, seed=args.seed)
        dpath = os.path.join(args.out, "reference_generate_digest.json")
        _write_json(dpath, rep)
        if not rep["deterministic"]:
            raise SystemExit("FAIL: imported generator nondeterministic")
        print(f"[parity_day] reference generate() fp32 digest "
              f"{rep['digest'][:16]}... ({rep['backend']}) -> {dpath}")
        summary["stages"]["digest"] = rep
        done("digest")
    else:
        print("[parity_day] no reference checkpoint given — skipping "
              "import + digest")

    # -- 3. I3D weights ----------------------------------------------------
    i3d_npz = args.i3d_weights
    if args.i3d_ckpt and not i3d_npz:
        from mocogan_tpu_torch.eval.i3d_convert import convert_to_npz

        i3d_npz = os.path.join(args.out, "i3d_converted.npz")
        convert_to_npz(args.i3d_ckpt, i3d_npz)
        print(f"[parity_day] converted I3D checkpoint -> {i3d_npz}")
        summary["stages"]["i3d_convert"] = i3d_npz
        done("i3d_convert")

    # -- 4. FVD ------------------------------------------------------------
    sides = {}
    if ref_state is not None:
        sides["reference"] = lambda: generator.generate_chunked(
            ref_state.nets["gen"], args.n, seed=args.seed)
    if args.run_dir:
        sides["ours"] = lambda: eval_fvd._samples_from_run(
            cfg, args.run_dir, args.n, args.seed, device)[0]
    real = None
    if args.data_dir:
        real = eval_fvd._real_from_store(cfg, args.data_dir, args.n,
                                         args.seed + 1, device)
    if sides or real is not None:
        if i3d_npz:
            extractor = fvd_mod.I3DFeatures(i3d_npz, device=device)
            ex_name = "i3d_logits (ABSOLUTE FVD)"
        else:
            extractor = fvd_mod.RandomProjectionFeatures().to(device)
            ex_name = ("random_projection_seed0 (RELATIVE proxy — pass "
                       "--i3d-ckpt/--i3d-weights for absolute FVD)")
        mats = {k: v() for k, v in sides.items()}
        scores = {}
        for name, vids in mats.items():
            if real is not None:
                scores[f"{name}_vs_real"] = fvd_mod.fvd(
                    vids, real, extractor=extractor)
        if "reference" in mats and "ours" in mats:
            scores["ours_vs_reference"] = fvd_mod.fvd(
                mats["ours"], mats["reference"], extractor=extractor)
        fpath = os.path.join(args.out, "fvd.json")
        rec = {"extractor": ex_name, "n": args.n,
               "scores": {k: round(float(v), 4) for k, v in scores.items()},
               "eval_fingerprint": fvd_mod.extractor_fingerprint(extractor)}
        _write_json(fpath, rec)
        print(f"[parity_day] FVD [{ex_name}]: {rec['scores']} -> {fpath}")
        summary["stages"]["fvd"] = rec
        done("fvd")

    # -- 5. loss-curve comparator ------------------------------------------
    if args.our_log and args.reference_log:
        from mocogan_tpu_torch.eval import compare_runs as cr

        rep = cr.compare(cr.load_log(args.our_log),
                         cr.load_log(args.reference_log))
        png = cr.plot_overlay(rep, os.path.join(args.out, "overlay.png"),
                              labels=("ours", "reference"))
        printable = {k: v for k, v in rep.items() if not k.startswith("_")}
        cpath = os.path.join(args.out, "compare.json")
        _write_json(cpath, printable)
        print(f"[parity_day] comparator: max_nabc={rep['max_nabc']} "
              f"-> {cpath}" + (f" + {png}" if png else ""))
        summary["stages"]["compare"] = {"max_nabc": rep["max_nabc"],
                                        "report": cpath}
        done("compare")

    spath = os.path.join(args.out, "summary.json")
    _write_json(spath, summary)
    print(f"[parity_day] done -> {spath}")
    return summary


if __name__ == "__main__":
    main()
