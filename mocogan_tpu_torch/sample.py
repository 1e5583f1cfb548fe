"""Sample-generation CLI of the port: restore a training run's latest
checkpoint, sample N clips from a seed and write them as a GIF grid (a
``.npy`` of the grid where PIL is missing), optionally one GIF per clip and
an mp4.

    python -m mocogan_tpu_torch.sample --config toy --run-dir runs/toy \\
        --n 16 --seed 7
    python -m mocogan_tpu_torch.sample --config categorical \\
        --run-dir runs/categorical --n 4 --labels 0 1 2 3

The noise is drawn on the host, so a seed gives the same clips on the card
and on the CPU (``--device cpu``) up to fp32 rounding. The CLI is not
named ``generate``: the package's top-level ``generate`` is the sampling
function, and importing a submodule of that name would replace it.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import torch


def main(argv=None) -> Tuple[str, torch.Tensor]:
    """Run the CLI; returns (the grid's path, the clips (N, T, H, W, C) in
    [-1, 1] on the device)."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="toy")
    ap.add_argument("--run-dir", required=True,
                    help="training output dir containing checkpoints/")
    ap.add_argument("--out", default=None, help="output gif path")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--video-length", type=int, default=None)
    ap.add_argument("--labels", type=int, nargs="*", default=None,
                    help="class labels for the categorical config, one per "
                         "clip (default: drawn from the seed)")
    ap.add_argument("--mp4", action="store_true")
    ap.add_argument("--individual", action="store_true",
                    help="also write one GIF per clip")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--set", nargs="*", metavar="K=V", dest="overrides")
    args = ap.parse_args(argv)

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.models import generator
    from mocogan_tpu_torch.train import state as train_state
    from mocogan_tpu_torch.train.__main__ import parse_overrides
    from mocogan_tpu_torch.utils import video as video_utils
    from mocogan_tpu_torch.utils.checkpoint import CheckpointManager
    from mocogan_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.config, **parse_overrides(args.overrides))
    mngr = CheckpointManager(os.path.join(args.run_dir, "checkpoints"))
    state = mngr.restore(train_state.create(cfg, device=device))
    print(f"[generate] restored step {state.step}")

    labels = (None if args.labels is None else
              torch.tensor(args.labels, dtype=torch.int64))
    vids = generator.generate(state.nets["gen"], args.n, seed=args.seed,
                              video_length=args.video_length, labels=labels)
    u8 = generator.to_uint8(vids).cpu().numpy()
    out = args.out or os.path.join(
        args.run_dir, f"generated_step{state.step}_seed{args.seed}.gif")
    path = video_utils.save_video_grid(u8, out)
    print(f"[generate] wrote {path}")
    if args.individual:
        paths = video_utils.save_individual_gifs(
            u8, os.path.join(args.run_dir, f"clips_step{state.step}"),
            prefix=f"seed{args.seed}")
        print(f"[generate] wrote {len(paths)} individual clips")
    if args.mp4:
        mp4 = video_utils.save_mp4(video_utils.tile_videos(u8),
                                   os.path.splitext(out)[0] + ".mp4")
        print(f"[generate] mp4: {mp4 or 'no codec available'}")
    mngr.close()
    return path, vids


if __name__ == "__main__":
    main()
