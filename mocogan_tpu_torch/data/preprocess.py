"""Offline dataset preprocessing: decode raw videos (or directories of
frames), face-crop for MUG, resize, subsample in time, and save one uint8
``.npy`` clip per video. The port's counterpart of the JAX package's
``data/preprocess.py``; both write the same store, byte for byte.

Frames are stored as raw uint8 at `raw_size`, resized with OpenCV's
``INTER_LINEAR`` on uint8, and not normalized: at train time the ingest
kernel (``ops/preproc.py``) resizes them to the model's size and maps them
to [-1, 1] on the card. Face cropping (MUG) uses OpenCV's bundled Haar
cascade when available. OpenCV is imported only where it is used; where
it is not installed, this is a tool of a host that has it, and the store
it writes is copied to the training machine.

Usage:
    python -m mocogan_tpu_torch.data.preprocess --src /videos --out /clips \\
        --raw-size 96 [--face-crop] [--frame-step 1] [--no-class-dirs]

The store loads in ``data/clips.py::ClipDataset`` and the native clip
store (``data/native.py``); with class directories under `--src`, one
level of them is kept as the store's classes.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import numpy as np

VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".webm", ".mpg", ".mpeg")
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def decode_video(path: str) -> np.ndarray:
    """Decode all frames -> (T, H, W, 3) uint8 RGB."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def decode_frame_dir(path: str) -> np.ndarray:
    """A directory of numbered image files -> (T, H, W, 3) uint8 RGB
    (MUG-style)."""
    import cv2

    names = sorted(f for f in os.listdir(path)
                   if f.lower().endswith(IMAGE_EXTS))
    if not names:
        raise ValueError(f"no image frames in {path}")
    frames = []
    for n in names:
        img = cv2.imread(os.path.join(path, n), cv2.IMREAD_COLOR)
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return np.stack(frames)


def face_crop(frames: np.ndarray, margin: float = 0.4) -> np.ndarray:
    """MUG-style face crop: detect on the middle frame, crop all frames to
    a square box with `margin`. Falls back to a centre crop when no face is
    found."""
    import cv2

    t, h, w = frames.shape[:3]
    box: Optional[Tuple[int, int, int, int]] = None
    cascade_path = os.path.join(cv2.data.haarcascades,
                                "haarcascade_frontalface_default.xml")
    if os.path.exists(cascade_path):
        det = cv2.CascadeClassifier(cascade_path)
        gray = cv2.cvtColor(frames[t // 2], cv2.COLOR_RGB2GRAY)
        faces = det.detectMultiScale(gray, 1.1, 4)
        if len(faces):
            x, y, fw, fh = max(faces, key=lambda f: f[2] * f[3])
            cx, cy = x + fw / 2, y + fh / 2
            side = int(max(fw, fh) * (1 + margin))
            box = (int(cx - side / 2), int(cy - side / 2), side, side)
    if box is None:
        side = min(h, w)
        box = ((w - side) // 2, (h - side) // 2, side, side)
    x, y, side, _ = box
    x = max(0, min(x, w - side))
    y = max(0, min(y, h - side))
    side = min(side, h - y, w - x)
    return frames[:, y:y + side, x:x + side]


def resize_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, size, size, C) uint8, cv2 INTER_LINEAR."""
    import cv2

    return np.stack([
        cv2.resize(f, (size, size), interpolation=cv2.INTER_LINEAR)
        for f in frames
    ])


def temporal_subsample(frames: np.ndarray, step: int) -> np.ndarray:
    return frames[::max(1, step)]


def preprocess_clip(src: str, *, raw_size: int, do_face_crop: bool = False,
                    frame_step: int = 1) -> np.ndarray:
    """One video file or frame directory -> (T, raw_size, raw_size, 3)
    uint8."""
    frames = (decode_frame_dir(src) if os.path.isdir(src)
              else decode_video(src))
    frames = temporal_subsample(frames, frame_step)
    if do_face_crop:
        frames = face_crop(frames)
    return resize_frames(frames, raw_size)


def preprocess_tree(src_dir: str, out_dir: str, *, raw_size: int = 96,
                    do_face_crop: bool = False, frame_step: int = 1,
                    class_from_dirname: bool = True) -> int:
    """Walk `src_dir` for videos and frame directories; write one uint8
    .npy per clip, keeping one level of class directories. Returns the
    number of clips."""
    n = 0
    for root, _, files in os.walk(src_dir):
        sources = [os.path.join(root, f) for f in sorted(files)
                   if f.lower().endswith(VIDEO_EXTS)]
        # a directory whose files are all images is itself one clip
        if not sources and files and all(
                f.lower().endswith(IMAGE_EXTS) for f in files):
            sources = [root]
        for src in sources:
            rel = os.path.relpath(os.path.dirname(src) if src != root
                                  else os.path.dirname(root), src_dir)
            cls = (rel.split(os.sep)[0]
                   if class_from_dirname and rel not in (".", "") else "")
            name = os.path.splitext(os.path.basename(src))[0] + ".npy"
            dst_dir = os.path.join(out_dir, cls) if cls else out_dir
            os.makedirs(dst_dir, exist_ok=True)
            clip = preprocess_clip(src, raw_size=raw_size,
                                   do_face_crop=do_face_crop,
                                   frame_step=frame_step)
            np.save(os.path.join(dst_dir, name), clip)
            n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--raw-size", type=int, default=96)
    ap.add_argument("--face-crop", action="store_true",
                    help="MUG-style face crop")
    ap.add_argument("--frame-step", type=int, default=1)
    ap.add_argument("--no-class-dirs", action="store_true")
    args = ap.parse_args(argv)
    n = preprocess_tree(args.src, args.out, raw_size=args.raw_size,
                        do_face_crop=args.face_crop,
                        frame_step=args.frame_step,
                        class_from_dirname=not args.no_class_dirs)
    print(f"wrote {n} clips to {args.out}")
    return n


if __name__ == "__main__":
    main()
