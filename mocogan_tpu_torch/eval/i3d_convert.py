"""Convert the public kinetics-i3d TensorFlow checkpoint to the npz weight
contract of ``eval/i3d.py``: the port's counterpart of the JAX package's
``eval/i3d_convert.py``, writing the same file.

The pretrained I3D weights (Carreira & Zisserman 2017) are published as
TF-v1 ``Saver`` checkpoints in the ``deepmind/kinetics-i3d`` repository
(``data/checkpoints/rgb_imagenet``, ``rgb_scratch``, ...). Their variable
names follow the Sonnet module tree::

    RGB/inception_i3d/<unit>/conv_3d/w                  (kd,kh,kw,cin,cout)
    RGB/inception_i3d/<unit>/conv_3d/b                  (logits only)
    RGB/inception_i3d/<unit>/batch_norm/beta            (1,1,1,1,cout)
    RGB/inception_i3d/<unit>/batch_norm/moving_mean     (1,1,1,1,cout)
    RGB/inception_i3d/<unit>/batch_norm/moving_variance (1,1,1,1,cout)

where ``<unit>`` is the unit naming of ``eval/i3d.py`` (``Conv3d_1a_7x7``,
``Mixed_3b/Branch_0/Conv3d_0a_1x1``, ...). Sonnet's conv kernels are
already DHWIO, the contract's layout, so conversion is: strip the model
prefix, rename the parameter leaf, and squeeze the BN tensors' singleton
axes (``convert_variables``, which needs no TensorFlow). Reading the
checkpoint needs TensorFlow (``convert``); where it is not installed the
converter raises and the conversion runs on a host that has it:

    python -m mocogan_tpu_torch.eval.i3d_convert \\
        --ckpt /path/to/rgb_imagenet/model.ckpt --out i3d.npz
    python -m mocogan_tpu_torch.eval_fvd --i3d-weights i3d.npz ...

The CLI accepts the checkpoint prefix (``.../model.ckpt``), its ``.index``
file, or the directory holding it (the ``checkpoint`` state file is
consulted).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from mocogan_tpu_torch.eval import i3d

# Parameter-leaf renames: checkpoint suffix -> contract suffix.
_BN_LEAVES = {
    "batch_norm/beta": "beta",
    "batch_norm/moving_mean": "mean",
    "batch_norm/moving_variance": "var",
}

Report = Dict[str, List[str]]


def resolve_ckpt_prefix(path: str) -> str:
    """Accept a checkpoint prefix, an index file, or a directory."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if os.path.exists(state):
            # TF CheckpointState proto in text form:
            #   model_checkpoint_path: "model.ckpt"
            with open(state) as f:
                for line in f:
                    if line.startswith("model_checkpoint_path"):
                        name = line.split(":", 1)[1].strip().strip('"')
                        if not os.path.isabs(name):
                            name = os.path.join(path, name)
                        return name
        idx = [f[:-6] for f in os.listdir(path) if f.endswith(".index")]
        if len(idx) == 1:
            return os.path.join(path, idx[0])
        raise FileNotFoundError(
            f"{path}: no 'checkpoint' state file and "
            f"{len(idx)} .index files — pass the ckpt prefix explicitly")
    if path.endswith(".index"):
        return path[:-6]
    return path


def detect_prefix(var_names) -> str:
    """The model prefix ('RGB/inception_i3d' in the public files) of
    whatever variable tree the checkpoint carries."""
    anchor = "Conv3d_1a_7x7/conv_3d/w"
    hits = sorted({n[: -len(anchor)].rstrip("/") for n in var_names
                   if n.endswith(anchor)})
    if not hits:
        raise ValueError(
            "checkpoint contains no '<prefix>/Conv3d_1a_7x7/conv_3d/w' "
            "variable — not a kinetics-i3d checkpoint?")
    if len(hits) > 1:
        # e.g. a joint RGB+Flow checkpoint; prefer the RGB tower
        rgb = [h for h in hits if "RGB" in h]
        if len(rgb) == 1:
            return rgb[0]
        raise ValueError(f"ambiguous model prefixes {hits}; "
                         f"pass --prefix explicitly")
    return hits[0]


def variable_map(prefix: str) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """(checkpoint variable name, contract key, contract shape) for every
    tensor the npz contract requires."""
    pre = f"{prefix}/" if prefix else ""
    out: List[Tuple[str, str, Tuple[int, ...]]] = []
    want = i3d.expected_shapes()
    for name, _k, _cin, _cout in i3d.conv_units():
        out.append((f"{pre}{name}/conv_3d/w", f"{name}/w", want[f"{name}/w"]))
        for ck, ours in _BN_LEAVES.items():
            out.append((f"{pre}{name}/{ck}", f"{name}/{ours}",
                        want[f"{name}/{ours}"]))
    out.append((f"{pre}Logits/Conv3d_0c_1x1/conv_3d/w",
                "Logits/Conv3d_0c_1x1/w", want["Logits/Conv3d_0c_1x1/w"]))
    out.append((f"{pre}Logits/Conv3d_0c_1x1/conv_3d/b",
                "Logits/Conv3d_0c_1x1/b", want["Logits/Conv3d_0c_1x1/b"]))
    return out


def convert_variables(variables: Mapping[str, np.ndarray],
                      prefix: Optional[str] = None
                      ) -> Tuple[Dict[str, np.ndarray], Report]:
    """{checkpoint variable name: array} -> (contract npz dict, report).

    BN tensors are squeezed from Sonnet's (1,1,1,1,C) broadcast shape to
    the contract's (C,); conv kernels pass through (already DHWIO). Every
    produced tensor is shape-checked against the contract; the report lists
    the variables the contract does not consume (optimizer slots of
    scratch-trained checkpoints, the Flow tower of joint files, ...)."""
    if prefix is None:
        prefix = detect_prefix(variables)
    out: Dict[str, np.ndarray] = {}
    report: Report = {"converted": [], "missing": [], "unused": []}
    used = set()
    for var, key, want in variable_map(prefix):
        if var not in variables:
            report["missing"].append(var)
            continue
        arr = np.asarray(variables[var], np.float32)
        used.add(var)
        if arr.ndim > len(want):        # (1,1,1,1,C) BN -> (C,)
            arr = arr.reshape(arr.shape[-len(want):] if len(want) else ())
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{var}: checkpoint shape {arr.shape} does not "
                             f"match contract {key} shape {want}")
        out[key] = arr
        report["converted"].append(key)
    report["unused"] = sorted(set(variables) - used)
    if report["missing"]:
        raise ValueError(
            f"checkpoint is missing {len(report['missing'])} required "
            f"variables (prefix {prefix!r}), e.g. {report['missing'][:4]}")
    return out, report


def convert(ckpt_path: str, prefix: Optional[str] = None
            ) -> Tuple[Dict[str, np.ndarray], Report]:
    """Read a kinetics-i3d TF checkpoint -> (contract npz dict, report):
    ``convert_variables`` of the checkpoint's variables. Needs TensorFlow;
    raises ImportError where it is not installed."""
    try:
        import tensorflow as tf  # deferred: heavyweight, only needed here
    except ImportError as e:
        raise ImportError(
            "reading a kinetics-i3d checkpoint needs TensorFlow, which is "
            "not installed here: run the converter on a host where "
            "TensorFlow is installed, then pass the npz it writes "
            "(--i3d-weights)") from e
    reader = tf.train.load_checkpoint(resolve_ckpt_prefix(ckpt_path))
    return convert_variables(
        {name: reader.get_tensor(name)
         for name in reader.get_variable_to_shape_map()}, prefix)


def save_npz(weights: Mapping[str, np.ndarray], out_path: str) -> None:
    """Write contract weights and re-validate the file through the
    loader's contract check (a loud failure if it violates it)."""
    np.savez(out_path, **weights)
    i3d.load_npz(out_path)


def convert_to_npz(ckpt_path: str, out_path: str,
                   prefix: Optional[str] = None) -> Report:
    """``convert`` + save + re-validate through ``i3d.load_npz``."""
    weights, report = convert(ckpt_path, prefix=prefix)
    save_npz(weights, out_path)
    return report


def main(argv=None) -> Report:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="kinetics-i3d checkpoint prefix, .index file, or "
                         "directory (e.g. data/checkpoints/rgb_imagenet)")
    ap.add_argument("--out", required=True, help="output npz path")
    ap.add_argument("--prefix", default=None,
                    help="model variable prefix (auto-detected: "
                         "'RGB/inception_i3d' in the public files)")
    args = ap.parse_args(argv)
    report = convert_to_npz(args.ckpt, args.out, prefix=args.prefix)
    print(f"[i3d_convert] {len(report['converted'])} tensors -> {args.out}; "
          f"{len(report['unused'])} checkpoint variables unused"
          + (f" (e.g. {report['unused'][:3]})" if report["unused"] else ""))
    return report


if __name__ == "__main__":
    main()
