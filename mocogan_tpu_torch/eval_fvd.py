"""FVD CLI of the port: Fréchet Video Distance between a trained
checkpoint's samples and a real clip store, or between two runs.

    python -m mocogan_tpu_torch.eval_fvd --config mug --run-dir runs/mug \\
        --data-dir data/mug
    python -m mocogan_tpu_torch.eval_fvd --config mug --run-dir runs/a \\
        --run-dir-b runs/b
    python -m mocogan_tpu_torch.eval_fvd --config mug --run-dir runs/mug \\
        --data-dir data/mug --i3d-weights i3d.npz     # absolute I3D-FVD

The default extractor is the port's fixed-seed random-projection net (a
relative metric; its weights are the port's own, so its values compare
with other port runs, not with the JAX package's). For absolute FVD pass
I3D weights in the npz contract of ``eval/i3d.py``. The real clips are
windows of the store drawn with numpy from ``--seed + 1`` and resized by
the ingest kernel on the card. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _samples_from_run(cfg, run_dir: str, n: int, seed: int, device):
    from mocogan_tpu_torch.models import generator
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.utils.checkpoint import CheckpointManager

    mngr = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    state = mngr.restore(train_state.create(cfg, device=device))
    return generator.generate_chunked(state.nets["gen"], n,
                                      seed=seed), state.step


def _real_from_store(cfg, data_dir: str, n: int, seed: int,
                     device) -> torch.Tensor:
    from mocogan_tpu_torch.data import clips
    from mocogan_tpu_torch.ops import preproc

    t = cfg.model.video_length
    ds = clips.ClipDataset(data_dir, t)
    rng = np.random.default_rng(seed)
    raws = []
    for i in rng.integers(0, len(ds), size=n):
        clip, idx, _ = ds.get_example(int(i), rng)
        raws.append(clip[idx])
    raw = torch.from_numpy(np.stack(raws)).to(device)
    idx = torch.arange(t, dtype=torch.int32).expand(n, t)
    return preproc.subsample_and_preprocess(raw, idx, cfg.model.image_size)


def main(argv=None) -> dict:
    """Run the CLI; returns the printed record."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="mug")
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--run-dir-b", default=None,
                    help="compare two runs instead of run-vs-data")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--i3d-weights", default=None,
                    help="npz in the eval/i3d.py contract: ABSOLUTE I3D-FVD "
                         "instead of the random-projection proxy")
    ap.add_argument("--features", default="logits",
                    choices=["logits", "pool"],
                    help="I3D feature head (TF-GAN FVD uses logits)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--set", nargs="*", metavar="K=V", dest="overrides")
    args = ap.parse_args(argv)

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.eval import fvd as fvd_mod
    from mocogan_tpu_torch.train.__main__ import parse_overrides
    from mocogan_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.config, **parse_overrides(args.overrides))

    gen_a, step_a = _samples_from_run(cfg, args.run_dir, args.n, args.seed,
                                      device)
    if args.run_dir_b:
        other, step_b = _samples_from_run(cfg, args.run_dir_b, args.n,
                                          args.seed + 1, device)
        desc = f"run@{step_a} vs run_b@{step_b}"
    elif args.data_dir:
        other = _real_from_store(cfg, args.data_dir, args.n, args.seed + 1,
                                 device)
        desc = f"run@{step_a} vs real data"
    else:
        raise SystemExit("need --data-dir or --run-dir-b")

    if args.i3d_weights:
        extractor = fvd_mod.I3DFeatures(args.i3d_weights,
                                        features=args.features,
                                        device=device)
        name, key = f"i3d_{args.features}", "fvd"
    else:
        extractor = fvd_mod.RandomProjectionFeatures().to(device)
        name, key = "random_projection_seed0", "fvd_proxy"
    score = fvd_mod.fvd(gen_a, other, extractor=extractor)
    rec = {key: round(score, 4), "n": args.n, "comparison": desc,
           "extractor": name}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
