"""Checkpoints for exact resume.

One checkpoint is ``<dir>/<step>/state.pt``: ``torch.save`` of one dict
with each net's ``state_dict`` (params and BatchNorm running stats), each
optimizer's ``state_dict`` (Adam's step, exp_avg, exp_avg_sq), the seed and
the step. It is written to a temporary name and renamed into place, so a
crash mid-save never leaves a truncated checkpoint behind, and it is loaded
with ``weights_only=True`` onto the state's device. The newest
``max_to_keep`` checkpoints are kept.

A sidecar ``stream_version.json`` records what fixes the (seed, step) ->
clip-window stream besides the seed: the port's ``DATA_STREAM_VERSION`` and
``data.epoch_shuffle``. A restore under other values says that the data
order of the resumed run differs.

Under data parallelism (a manager given the ``mesh``) rank 0 writes and
prunes, every rank waits at a barrier after each save, and every rank
restores the same file.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import TYPE_CHECKING, Dict, List, Optional

import torch

from mocogan_tpu_torch.ops.sampling import DATA_STREAM_VERSION
from mocogan_tpu_torch.parallel import mesh as pmesh

if TYPE_CHECKING:  # train.state imports nothing of this module
    from mocogan_tpu_torch.train.state import TrainState

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 stream_meta: Optional[dict] = None,
                 mesh: Optional[pmesh.Mesh] = None):
        """stream_meta: facts besides the code version that fix the (seed,
        step) -> clip stream, e.g. data.epoch_shuffle; recorded in the
        sidecar and compared on restore. mesh: the data-parallel world
        whose rank 0 writes."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.stream_meta = {"data_stream_version": DATA_STREAM_VERSION,
                            **(stream_meta or {})}
        self.mesh = mesh
        # step, seconds, bytes and path of the last save (rank 0)
        self.last_save: Optional[dict] = None
        self._saved_step: Optional[int] = None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(self._path(int(d))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: "TrainState", *, wait: bool = False) -> int:
        """Write the checkpoint of ``state.step`` and prune to the
        ``max_to_keep`` newest (all, if 0). A step this manager has just
        saved is not written again; one left by another run is replaced.
        Saving is synchronous, so `wait` changes nothing; it keeps the JAX
        package's surface. Every rank of the mesh calls it; rank 0 writes,
        then all meet at a barrier."""
        step = int(state.step)
        if self._saved_step == step:
            return step
        self._saved_step = step
        if self.mesh is None or self.mesh.is_main:
            self._write(state, step)
        pmesh.barrier(self.mesh)
        return step

    def _write(self, state: "TrainState", step: int) -> None:
        path = self._path(step)
        t0 = time.perf_counter()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        blob = {"seed": state.seed, "step": step,
                "nets": {n: net.state_dict() for n, net in state.nets.items()},
                "opt": {n: o.state_dict() for n, o in state.opt.items()}}
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        sidecar = os.path.join(self.directory, "stream_version.json")
        if not os.path.exists(sidecar):
            with open(sidecar, "w") as f:
                json.dump(self.stream_meta, f)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        self.last_save = {"step": step, "seconds": time.perf_counter() - t0,
                          "bytes": os.path.getsize(path), "path": path}
        print(f"[checkpoint] step {step}: "
              f"{self.last_save['bytes'] / 1e6:.1f} MB in "
              f"{self.last_save['seconds']:.3f} s -> {path}")

    def restore(self, template: "TrainState",
                step: Optional[int] = None) -> "TrainState":
        """Load checkpoint `step` (default: the latest) into `template`, a
        freshly created state of the same config, in place; returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        sidecar = os.path.join(self.directory, "stream_version.json")
        saved_meta = None
        if os.path.exists(sidecar):
            try:
                with open(sidecar) as f:
                    saved_meta = json.load(f)
            except ValueError:
                pass
        if saved_meta != self.stream_meta:
            print(f"[checkpoint] WARNING: checkpoint was saved under "
                  f"data-stream identity {saved_meta} but this run uses "
                  f"{self.stream_meta}: resumed training continues on a "
                  f"DIFFERENT clip-window stream for the same seed "
                  f"(model/optimizer state restore exactly; only the "
                  f"data order diverges).")
        blob = torch.load(self._path(step), map_location=template.device,
                          weights_only=True)
        if set(blob["nets"]) != set(template.nets):
            raise KeyError(f"checkpoint holds nets {sorted(blob['nets'])}, "
                           f"the state {sorted(template.nets)}")
        for n, net in template.nets.items():
            net.load_state_dict(blob["nets"][n])
            template.opt[n].load_state_dict(blob["opt"][n])
        template.seed = int(blob["seed"])
        template.step = int(blob["step"])
        return template

    def close(self):
        """Nothing to wait for: saves are synchronous."""


def digests(path: str) -> Dict[str, str]:
    """{key path: sha256} of everything in checkpoint file `path`: every
    parameter, BN buffer and Adam moment by the bytes of its tensor, the
    rest (seed, step, hyperparameters) by its repr. Two runs that repeat
    bit for bit give equal dicts."""
    out: Dict[str, str] = {}

    def walk(key: str, v) -> None:
        if isinstance(v, dict):
            for kk, vv in v.items():
                walk(f"{key}/{kk}", vv)
        elif isinstance(v, (list, tuple)):
            for i, vv in enumerate(v):
                walk(f"{key}/{i}", vv)
        elif torch.is_tensor(v):
            raw = v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
            out[key] = hashlib.sha256(
                f"{v.dtype}{tuple(v.shape)}".encode()
                + raw.numpy().tobytes()).hexdigest()
        else:
            out[key] = hashlib.sha256(repr(v).encode()).hexdigest()

    walk("", torch.load(path, map_location="cpu", weights_only=True))
    return out
