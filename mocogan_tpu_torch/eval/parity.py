"""The fp32 ``generate()`` fidelity check: determinism and a content digest.

  * determinism: the same (weights, seed) give bit-identical clips across
    calls, and ``generate`` equals ``generate_chunked(chunk=n)`` bit for
    bit (the JAX package checks jit against eager here; the port has no
    jit);
  * a stable SHA256 digest of the generated fp32 tensor, which can be
    recorded in a run dir and re-checked later or on another backend (the
    card and the CPU differ by fp32 rounding, so the digest pins each).

cuDNN's default algorithm for the deconvs' forward pass (a data gradient)
is not deterministic on an H100: two ``generate()`` calls there differed
without the flag. ``generate()`` itself now runs with
``cudnn.deterministic`` on and ``cudnn.benchmark`` off
(``utils.platform.cudnn_deterministic``), and the check does too.

Run:  python -m mocogan_tpu_torch.eval.parity --config toy \\
          [--run-dir runs/toy] [--reference-npz gen.npz [--rename A=C ...]] \\
          [--n 4] [--seed 0] [--record P] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np
import torch

from mocogan_tpu_torch.utils.platform import cudnn_deterministic


def video_digest(videos) -> str:
    """SHA256 of the exact fp32 bytes (C order): bit-for-bit identity."""
    if isinstance(videos, torch.Tensor):
        videos = videos.detach().cpu().numpy()
    v = np.ascontiguousarray(np.asarray(videos, dtype=np.float32))
    return hashlib.sha256(v.tobytes()).hexdigest()


def check_determinism(g, *, n: int = 4, seed: int = 0) -> dict:
    """{"digest", "deterministic", "chunked_matches_generate", "backend",
    "n", "seed"} for generator `g`."""
    from mocogan_tpu_torch.models import generator

    with cudnn_deterministic():
        v1 = generator.generate(g, n, seed=seed).cpu().numpy()
        v2 = generator.generate(g, n, seed=seed).cpu().numpy()
        v3 = generator.generate_chunked(g, n, seed=seed, chunk=n)
    return {"digest": video_digest(v1),
            "deterministic": bool((v1 == v2).all()),
            "chunked_matches_generate": bool((v1 == v3).all()),
            "backend": next(g.parameters()).device.type,
            "n": n, "seed": seed}


def main(argv=None) -> dict:
    """Run the CLI; returns the report (raises SystemExit on a failure)."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="toy")
    ap.add_argument("--run-dir", default=None,
                    help="restore the state from this run's checkpoints/")
    ap.add_argument("--reference-npz", default=None,
                    help="import the generator from a Chainer save_npz "
                         "checkpoint (eval/import_chainer.py) and digest "
                         "its generate() output: the reference-parity path")
    ap.add_argument("--rename", nargs="*", metavar="ACTUAL=CANONICAL",
                    help="npz key renames for --reference-npz")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", default=None,
                    help="write, or compare with, the digest record here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.utils.checkpoint import CheckpointManager
    from mocogan_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.reference_npz:
        from mocogan_tpu_torch.eval import import_chainer

        state, reports = import_chainer.import_experiment(
            cfg, gen_npz=args.reference_npz,
            rename=import_chainer.parse_rename(args.rename), device=device)
        print(f"[parity] imported generator from {args.reference_npz}: "
              f"{len(reports['gen']['matched'])} tensors")
    else:
        state = train_state.create(cfg, device=device)
    if args.run_dir:
        CheckpointManager(os.path.join(args.run_dir,
                                       "checkpoints")).restore(state)

    rep = check_determinism(state.nets["gen"], n=args.n, seed=args.seed)
    print(json.dumps(rep, indent=2))
    if not rep["deterministic"]:
        raise SystemExit("FAIL: generate() not deterministic")

    if args.record:
        if os.path.exists(args.record):
            with open(args.record) as f:
                prev = json.load(f)
            rep["record_matches"] = prev["digest"] == rep["digest"]
            print(f"digest "
                  f"{'MATCHES' if rep['record_matches'] else 'DIFFERS FROM'}"
                  f" record ({prev['backend']} @ {args.record})")
            if not rep["record_matches"] \
                    and prev["backend"] == rep["backend"]:
                raise SystemExit("FAIL: same-backend digest mismatch")
        else:
            with open(args.record, "w") as f:
                json.dump(rep, f, indent=2)
            print(f"recorded digest to {args.record}")
    return rep


if __name__ == "__main__":
    main()
