"""JSONL metric log (one record per log window) and its loss-curve plot.

The logger takes host floats only: the trainer accumulates metrics on the
device and copies them to the host once per log window. On resume it
reloads the records already in the log, so ``plot`` spans the whole run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class MetricLogger:
    def __init__(self, out_dir: str, filename: str = "log.jsonl"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._history: List[Dict] = []
        self._t0 = time.time()
        # A resumed run reloads the earlier records; a line cut short by a
        # crash mid-write is skipped. `time` stays monotonic across restarts:
        # t0 is offset by the last recorded elapsed time.
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._history.append(json.loads(line))
                    except ValueError:
                        continue
            if self._history:
                self._t0 -= float(self._history[-1].get("time", 0.0))

    def log(self, step: int, metrics: Dict[str, float], **extra) -> Dict:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        rec.update(extra)
        self._history.append(rec)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    @property
    def history(self) -> List[Dict]:
        return list(self._history)

    def plot(self, filename: str = "loss_curves.png",
             keys: Optional[List[str]] = None) -> Optional[str]:
        """Loss-curve PNG in out_dir; None without matplotlib or records."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        if not self._history:
            return None
        keys = keys or sorted({
            k for h in self._history for k in h
            if k.startswith(("loss", "fvd"))
            and isinstance(h[k], (int, float))})
        fig, ax = plt.subplots(figsize=(8, 5))
        steps = [h["step"] for h in self._history]
        for k in keys:
            ax.plot(steps, [h.get(k, float("nan")) for h in self._history],
                    label=k)
        ax.set_xlabel("step")
        ax.set_ylabel("loss")
        ax.legend()
        ax.grid(True, alpha=0.3)
        path = os.path.join(self.out_dir, filename)
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path
