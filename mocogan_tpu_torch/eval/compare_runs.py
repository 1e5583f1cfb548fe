"""Quantitative loss-curve comparison between two training runs.

The port's own copy of the JAX package's ``eval/compare_runs.py`` (numpy
only). It aligns two ``log.jsonl`` files onto a common step grid, smooths
them, and reports divergence statistics per loss and fvd key: the
instrument for A/B runs (update order, recipes, the two packages against
each other). fvd keys are compared only where both runs carry one and the
same ``eval_fingerprint``.

Statistics, per shared loss/fvd key:
  * ``nabc``  — normalized area between curves: mean |a-b| over the
    common grid divided by the pooled robust scale (mean of the two
    curves' IQRs, floored by 5%% of the pooled mean |value|), so "0.1"
    reads as "the curves differ by ~10%% of their own typical spread",
    comparable across keys of very different magnitude.
  * ``nabc_windows`` — the same statistic over W consecutive step
    windows, so late-training divergence isn't averaged away by an
    identical warm-up.
  * ``final_a`` / ``final_b`` — smoothed means over the last window
    (the "where did each run end up" summary).

Usage:
  python -m mocogan_tpu_torch.eval.compare_runs A/log.jsonl B/log.jsonl \
      --labels simultaneous sequential --out docs/results/order_ab_cmp

CLI output is one JSON report; --out also writes an overlay PNG
(raw curves faint, smoothed bold) and the report file.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_log(path: str) -> List[Dict]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    if not recs:
        raise ValueError(f"{path}: empty log")
    return recs


def series(log: Sequence[Dict], key: str) -> Tuple[np.ndarray, np.ndarray]:
    """(steps, values) for one key, step-sorted, NaN/missing dropped.
    Duplicate steps (e.g. a loss record and an fvd record at the same
    step) keep the last value."""
    by_step: Dict[int, float] = {}
    for r in log:
        v = r.get(key)
        if isinstance(v, (int, float)) and np.isfinite(v):
            by_step[int(r["step"])] = float(v)
    if not by_step:
        return np.empty(0), np.empty(0)
    steps = np.array(sorted(by_step), dtype=np.float64)
    return steps, np.array([by_step[int(s)] for s in steps])


def shared_keys(a: Sequence[Dict], b: Sequence[Dict]) -> List[str]:
    def keys(log):
        # *_dim keys are metric METADATA (e.g. fvd_proxy_dim, the
        # extractor dimension logged alongside every eval record), not
        # curves — comparing them would dilute mean_nabc with a constant
        # zero and add a flat panel to the overlay.
        return {k for r in log for k in r
                if k.startswith(("loss", "fvd"))
                and not k.endswith("_dim")
                and isinstance(r[k], (int, float))}
    return sorted(keys(a) & keys(b))


def eval_fingerprints(log: Sequence[Dict]) -> List[str]:
    """Distinct eval_fingerprint values in record order (every eval-panel
    record carries one: EVAL_VERSION + extractor-weight hash,
    eval/fvd.extractor_fingerprint). Logs without any return []."""
    seen: List[str] = []
    for r in log:
        fp = r.get("eval_fingerprint")
        if isinstance(fp, str) and fp not in seen:
            seen.append(fp)
    return seen


def align(sa: np.ndarray, va: np.ndarray, sb: np.ndarray, vb: np.ndarray,
          n: int = 400) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Interpolate both series onto a uniform grid over the OVERLAPPING
    step range (runs of different lengths/cadences compare only where
    both have data)."""
    lo = max(sa[0], sb[0])
    hi = min(sa[-1], sb[-1])
    if hi <= lo:
        raise ValueError(
            f"step ranges do not overlap: [{sa[0]}, {sa[-1]}] vs "
            f"[{sb[0]}, {sb[-1]}]")
    grid = np.linspace(lo, hi, n)
    return grid, np.interp(grid, sa, va), np.interp(grid, sb, vb)


def smooth(v: np.ndarray, frac: float = 0.05) -> np.ndarray:
    """Centered moving average; window = frac of the series (>= 1). Edges
    use the partial window (no phantom padding values)."""
    w = max(1, int(round(len(v) * frac)))
    if w <= 1:
        return v.copy()
    kernel = np.ones(w)
    num = np.convolve(v, kernel, mode="same")
    den = np.convolve(np.ones_like(v), kernel, mode="same")
    return num / den


def _robust_scale(a: np.ndarray, b: np.ndarray) -> float:
    """Pooled spread for normalization: mean of the two IQRs, floored at
    5% of the pooled mean magnitude so two flat-but-offset curves still
    get a sane denominator."""
    iqr_a = float(np.subtract(*np.percentile(a, [75, 25])))
    iqr_b = float(np.subtract(*np.percentile(b, [75, 25])))
    floor = 0.05 * float(np.mean(np.abs(np.concatenate([a, b])))) + 1e-12
    return max(0.5 * (iqr_a + iqr_b), floor)


def divergence(a: np.ndarray, b: np.ndarray, windows: int = 10) -> Dict:
    """nabc overall + per-window (same pooled scale across windows so the
    window values are comparable to each other and sum-consistent with
    the overall value)."""
    scale = _robust_scale(a, b)
    diff = np.abs(a - b)
    bounds = np.linspace(0, len(a), windows + 1).astype(int)
    per_window = [float(np.mean(diff[lo:hi]) / scale)
                  for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    return {"nabc": float(np.mean(diff) / scale),
            "nabc_windows": [round(x, 4) for x in per_window],
            "scale": scale}


def compare(log_a: Sequence[Dict], log_b: Sequence[Dict],
            keys: Optional[Sequence[str]] = None, *, grid_n: int = 400,
            smooth_frac: float = 0.05, windows: int = 10,
            scale_a: float = 1.0, scale_b: float = 1.0) -> Dict:
    """Full report dict for two loaded logs. Also returns the aligned,
    smoothed curves per key (under "_curves") for plotting.

    scale_a/scale_b multiply each run's step axis before alignment.
    Purpose: runs at DIFFERENT batch sizes consume different data per
    step, so the step axis compares unequal training budgets; passing
    each run's batch size as its scale aligns the curves on CLIPS SEEN
    (examples processed) — the fair x-axis for batch-size A/Bs."""
    keys = list(keys) if keys else shared_keys(log_a, log_b)
    if not keys:
        raise ValueError("no shared loss*/fvd* keys between the two logs")
    report: Dict = {"keys": {}, "_curves": {}}
    # Eval-version guard: fvd* values are only comparable under the SAME
    # eval fingerprint (extractor weights + EVAL_VERSION). When
    # fingerprints differ — or either run changed fingerprint mid-run —
    # each fvd key is annotated eval_mismatch and EXCLUDED from max/mean
    # nabc, so eval-code drift never reads as training divergence. Logs
    # without fingerprints ([]) are compared, flagged "unknown".
    fp_a, fp_b = eval_fingerprints(log_a), eval_fingerprints(log_b)
    fvd_status = "comparable"
    if fp_a or fp_b:
        if len(fp_a) > 1 or len(fp_b) > 1 or fp_a != fp_b:
            fvd_status = "eval_mismatch"
    elif any(k.startswith("fvd") for k in keys):
        fvd_status = "unknown"
    report["eval_fingerprints"] = {"a": fp_a, "b": fp_b,
                                   "fvd_comparability": fvd_status}
    if scale_a != 1.0 or scale_b != 1.0:
        report["x_axis"] = {"scale_a": scale_a, "scale_b": scale_b,
                           "meaning": "steps scaled per run (e.g. by "
                                      "batch size -> clips seen)"}
    for k in keys:
        sa, va = series(log_a, k)
        sb, vb = series(log_b, k)
        if len(sa) < 2 or len(sb) < 2:
            report["keys"][k] = {"skipped": "fewer than 2 points"}
            continue
        grid, a, b = align(sa * scale_a, va, sb * scale_b, vb, n=grid_n)
        a_s, b_s = smooth(a, smooth_frac), smooth(b, smooth_frac)
        d = divergence(a_s, b_s, windows=windows)
        tail = max(1, len(grid) // windows)
        d["final_a"] = float(np.mean(a_s[-tail:]))
        d["final_b"] = float(np.mean(b_s[-tail:]))
        d["step_range"] = [float(grid[0]), float(grid[-1])]
        if k.startswith("fvd") and fvd_status == "eval_mismatch":
            d["eval_mismatch"] = True
        report["keys"][k] = d
        report["_curves"][k] = {"grid": grid, "raw_a": a, "raw_b": b,
                                "smooth_a": a_s, "smooth_b": b_s}
    done = [v for v in report["keys"].values()
            if "nabc" in v and not v.get("eval_mismatch")]
    report["max_nabc"] = max((v["nabc"] for v in done), default=None)
    report["mean_nabc"] = (float(np.mean([v["nabc"] for v in done]))
                           if done else None)
    return report


def plot_overlay(report: Dict, path: str,
                 labels: Tuple[str, str] = ("A", "B")) -> Optional[str]:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    curves = report["_curves"]
    if not curves:
        return None
    n = len(curves)
    fig, axes = plt.subplots(n, 1, figsize=(9, 3 * n), squeeze=False)
    for ax, (k, c) in zip(axes[:, 0], sorted(curves.items())):
        ax.plot(c["grid"], c["raw_a"], color="C0", alpha=0.25, lw=0.8)
        ax.plot(c["grid"], c["raw_b"], color="C1", alpha=0.25, lw=0.8)
        ax.plot(c["grid"], c["smooth_a"], color="C0", lw=1.8,
                label=labels[0])
        ax.plot(c["grid"], c["smooth_b"], color="C1", lw=1.8,
                label=labels[1])
        st = report["keys"][k]
        note = ("  [EVAL-VERSION MISMATCH: not a training signal]"
                if st.get("eval_mismatch") else "")
        ax.set_title(f"{k}  —  nabc={st['nabc']:.3f}  "
                     f"(final: {st['final_a']:.3f} vs {st['final_b']:.3f})"
                     f"{note}", fontsize=10)
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    axes[-1, 0].set_xlabel("clips seen (scaled steps)"
                           if report.get("x_axis") else "step")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_a")
    ap.add_argument("log_b")
    ap.add_argument("--labels", nargs=2, default=("A", "B"))
    ap.add_argument("--keys", nargs="*", default=None,
                    help="loss keys (default: all shared loss*/fvd*)")
    ap.add_argument("--out", default=None,
                    help="directory for overlay PNG + report JSON")
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--smooth", type=float, default=0.05,
                    help="smoothing window as a fraction of the series")
    ap.add_argument("--grid", type=int, default=400)
    ap.add_argument("--scale-a", type=float, default=1.0,
                    help="multiply run A's step axis (pass its batch "
                         "size to align batch-size A/Bs on clips seen)")
    ap.add_argument("--scale-b", type=float, default=1.0)
    args = ap.parse_args(argv)

    report = compare(load_log(args.log_a), load_log(args.log_b),
                     keys=args.keys, grid_n=args.grid,
                     smooth_frac=args.smooth, windows=args.windows,
                     scale_a=args.scale_a, scale_b=args.scale_b)
    printable = {k: v for k, v in report.items() if not k.startswith("_")}
    printable["labels"] = {"a": args.labels[0], "b": args.labels[1]}
    printable["logs"] = {"a": args.log_a, "b": args.log_b}
    if args.out:
        png = plot_overlay(report, os.path.join(args.out, "overlay.png"),
                           labels=tuple(args.labels))
        if png:
            printable["overlay_png"] = png
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "compare.json"), "w") as f:
            json.dump(printable, f, indent=2)
    print(json.dumps(printable, indent=2))
    return printable


if __name__ == "__main__":
    main()
