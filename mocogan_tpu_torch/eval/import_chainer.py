"""Chainer ``save_npz`` checkpoint importer: the port's counterpart of the
JAX package's ``eval/import_chainer.py``.

The reference serializes each ``chainer.Chain`` with
``chainer.serializers.save_npz``: one flat npz whose keys are
``<child path>/<param name>`` (e.g. ``dc1/W``, ``bn1/avg_mean``). This
module maps such files onto the port's nets, so the two parity claims
(bit-for-bit fp32 ``generate()``; FVD against reference checkpoints) run
as soon as a checkpoint file exists.

The child-link names below are the canonical Chainer-convention spelling
of the JAX package's spec tables; a ``rename`` map adapts any other naming
at import time, and the CLI prints a per-tensor match/mismatch report.

The mapping goes through the JAX package's tree layout (numpy, this
module's own copy of its spec), then into the torch modules through
``bridge.load_net``. The port's Dense, the GRU's fused ``w/u/b`` and the
channels-last head flattens already use that layout; only the conv
weights differ, and each layer's ``from_jax`` owns that conversion. So the
imported trees equal the JAX package's bit for bit, and the conv layouts
are converted in one place.

Layout conversions, Chainer -> JAX layout:

  Linear      W (out, in)            -> dense  w (in, out):       W.T
  Linear on a flattened conv map     -> rows reordered (c,h,w) -> (h,w,c)
  Linear producing a conv map        -> cols reordered likewise (gen fc)
  Convolution2D   W (O, I, kh, kw)   -> conv2d  w HWIO: transpose(2,3,1,0)
  ConvolutionND3  W (O, I, kd,kh,kw) -> conv3d  w DHWIO: transpose(2,3,4,1,0)
  Deconvolution2D W (I, O, kh, kw)   -> conv_transpose w HWIO:
        transpose(2,3,0,1) + spatial flip; ``layers.Deconv2d`` flips it
        back, so the torch weight IS the npz's ``dc{i}/W``
  BatchNormalization gamma/beta/avg_mean/avg_var -> scale/bias (+ bn state)
  L.GRU: six Linear links W_r,U_r,W_z,U_z,W,U -> fused blocks
        w = [W_r.T | W_z.T | W.T], u = [U_r.T | U_z.T | U.T],
        b = [W_r.b+U_r.b | W_z.b+U_z.b | W.b+U.b]

Biases that Chainer layers carry in front of BatchNorm (the generator fc
and inner deconvs, the discriminators' normalized convs) are dropped with
a note: BN subtracts the mean, so a constant pre-BN bias has no effect.

CLI:
    python -m mocogan_tpu_torch.eval.import_chainer \\
        --config mug --gen-npz gen.npz [--di-npz ...] [--dv-npz ...] \\
        [--snapshot-npz snapshot_iter_N.npz] [--rename actual=canonical ...] \\
        [--no-strict] [--digest --n 4 --seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from mocogan_tpu_torch.configs import ExperimentConfig, ModelConfig
from mocogan_tpu_torch.ops.layers import out_size_up


# ---------------------------------------------------------------------------
# layout converters (chainer array -> JAX layout) and their inverses
# ---------------------------------------------------------------------------

def _t(x):
    return np.ascontiguousarray(x)


def linear_w_from_chw(w: np.ndarray, c: int, h: int, s: int) -> np.ndarray:
    """Linear over a FLATTENED feature map: Chainer flattens (C,H,W), the
    JAX layout (H,W,C) — reorder the input rows."""
    out = w.shape[0]
    return _t(w.reshape(out, c, h, s).transpose(0, 2, 3, 1)
              .reshape(out, h * s * c).T)


def linear_w_from_chw_inv(w: np.ndarray, c: int, h: int, s: int) -> np.ndarray:
    out = w.shape[1]
    return _t(w.T.reshape(out, h, s, c).transpose(0, 3, 1, 2)
              .reshape(out, c * h * s))


def linear_w_from_cthw(w: np.ndarray, c: int, t: int, h: int,
                       s: int) -> np.ndarray:
    """Linear over a flattened (C,T,H,W) video feature map -> (T,H,W,C)."""
    out = w.shape[0]
    return _t(w.reshape(out, c, t, h, s).transpose(0, 2, 3, 4, 1)
              .reshape(out, t * h * s * c).T)


def linear_w_from_cthw_inv(w: np.ndarray, c: int, t: int, h: int,
                           s: int) -> np.ndarray:
    out = w.shape[1]
    return _t(w.T.reshape(out, t, h, s, c).transpose(0, 4, 1, 2, 3)
              .reshape(out, c * t * h * s))


def linear_w_to_chw(w: np.ndarray, c: int, h: int, s: int) -> np.ndarray:
    """Linear whose OUTPUT is reshaped to a feature map: Chainer reshapes
    rows to (C,H,W), the JAX layout to (H,W,C) — reorder the columns."""
    din = w.shape[1]
    return _t(w.reshape(c, h, s, din).transpose(1, 2, 0, 3)
              .reshape(h * s * c, din).T)


def linear_w_to_chw_inv(w: np.ndarray, c: int, h: int, s: int) -> np.ndarray:
    din = w.shape[0]
    return _t(w.T.reshape(h, s, c, din).transpose(2, 0, 1, 3)
              .reshape(c * h * s, din))


def conv2d_w(w: np.ndarray) -> np.ndarray:
    return _t(w.transpose(2, 3, 1, 0))            # OIHW -> HWIO


def conv2d_w_inv(w: np.ndarray) -> np.ndarray:
    return _t(w.transpose(3, 2, 0, 1))


def conv3d_w(w: np.ndarray) -> np.ndarray:
    return _t(w.transpose(2, 3, 4, 1, 0))         # OIDHW -> DHWIO


def conv3d_w_inv(w: np.ndarray) -> np.ndarray:
    return _t(w.transpose(4, 3, 0, 1, 2))


def deconv2d_w(w: np.ndarray) -> np.ndarray:
    # Chainer Deconvolution2D W is (I, O, kh, kw) and computes the conv
    # ADJOINT; the JAX layout is a direct fractionally-strided conv's ->
    # flip spatial. Deconv2d._w_from_jax undoes the flip and the transpose.
    return _t(w.transpose(2, 3, 0, 1)[::-1, ::-1])


def deconv2d_w_inv(w: np.ndarray) -> np.ndarray:
    return _t(w[::-1, ::-1].transpose(2, 3, 0, 1))


# ---------------------------------------------------------------------------
# spec construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Slot:
    """One target tensor of a JAX-layout tree assembled from >= 1 npz
    entries."""
    path: Tuple[str, ...]              # into {"params": ..., "bn": ...}
    sources: List[str]                 # canonical npz keys
    shapes: List[Tuple[int, ...]]      # expected npz shapes
    build: Callable[[List[np.ndarray]], np.ndarray]
    unbuild: Callable[[np.ndarray], List[np.ndarray]]


def _bn_slots(prefix: Tuple[str, ...], name: str, c: int) -> List[Slot]:
    out = []
    for ch_key, kind, ours in [("gamma", "params", "scale"),
                               ("beta", "params", "bias"),
                               ("avg_mean", "bn", "mean"),
                               ("avg_var", "bn", "var")]:
        out.append(Slot((kind,) + prefix + (ours,), [f"{name}/{ch_key}"],
                        [(c,)], lambda xs: _t(xs[0]), lambda x: [_t(x)]))
    return out


def _gru_slots(m: ModelConfig) -> List[Slot]:
    di, dh = m.dim_eps, m.dim_motion

    def fuse_w(xs):
        return _t(np.concatenate([x.T for x in xs], axis=1))

    def unfuse(x):
        return [_t(p.T) for p in np.split(x, 3, axis=1)]

    def fuse_b(xs):
        # each Chainer gate adds both Linears' biases; the U bias of the
        # candidate gate is outside the r * (U h) product, so the sum is
        # exact. float32 sums in the JAX package's order.
        return _t(np.concatenate([xs[0] + xs[1], xs[2] + xs[3],
                                  xs[4] + xs[5]]))

    def unfuse_b(x):
        # the split is not unique (Chainer carries one bias per Linear):
        # the whole fused bias goes on the W_* links, zeros on U_*; a round
        # trip is exact because x + 0 is
        out = []
        for p in np.split(x, 3):
            out.extend([_t(p), np.zeros_like(p)])
        return out

    return [
        Slot(("params", "gru", "w"),
             ["gru/W_r/W", "gru/W_z/W", "gru/W/W"],
             [(dh, di)] * 3, fuse_w, unfuse),
        Slot(("params", "gru", "u"),
             ["gru/U_r/W", "gru/U_z/W", "gru/U/W"],
             [(dh, dh)] * 3, fuse_w, unfuse),
        Slot(("params", "gru", "b"),
             ["gru/W_r/b", "gru/U_r/b", "gru/W_z/b", "gru/U_z/b",
              "gru/W/b", "gru/U/b"],
             [(dh,)] * 6, fuse_b, unfuse_b),
    ]


def generator_spec(m: ModelConfig) -> List[Slot]:
    """Canonical Chainer naming of the generator Chain: ``gru`` (L.GRU),
    ``fc`` (L.Linear), ``bn_fc``, ``dc0..dc3`` (L.Deconvolution2D),
    ``bn0..bn2`` (L.BatchNormalization)."""
    ngf = m.gen_features
    s0 = out_size_up(m.image_size, 4)
    widths = [ngf * 8, ngf * 4, ngf * 2, ngf]
    slots = _gru_slots(m)
    c0 = widths[0]
    slots.append(Slot(
        ("params", "fc", "w"), ["fc/W"], [(c0 * s0 * s0, m.dim_z)],
        lambda xs: linear_w_to_chw(xs[0], c0, s0, s0),
        lambda x: [linear_w_to_chw_inv(x, c0, s0, s0)]))
    slots += _bn_slots(("bn_fc",), "bn_fc", c0)
    cin = c0
    for i in range(4):
        last = i == 3
        cout = m.channels if last else widths[i + 1]
        slots.append(Slot(
            ("params", f"deconv{i}", "w"), [f"dc{i}/W"], [(cin, cout, 4, 4)],
            lambda xs: deconv2d_w(xs[0]), lambda x: [deconv2d_w_inv(x)]))
        if last:
            slots.append(Slot(("params", f"deconv{i}", "b"), [f"dc{i}/b"],
                              [(cout,)], lambda xs: _t(xs[0]),
                              lambda x: [_t(x)]))
        else:
            slots += _bn_slots((f"bn{i}",), f"bn{i}", cout)
        cin = cout
    return slots


def image_disc_spec(m: ModelConfig) -> List[Slot]:
    """D_I: ``c0..c3`` (L.Convolution2D), ``bn1..bn3``, ``fc``."""
    ndf = m.disc_features
    widths = [ndf, ndf * 2, ndf * 4, ndf * 8]
    s_out = m.image_size // 16
    slots: List[Slot] = []
    cin = m.channels
    for i, cout in enumerate(widths):
        slots.append(Slot(
            ("params", f"conv{i}", "w"), [f"c{i}/W"], [(cout, cin, 4, 4)],
            lambda xs: conv2d_w(xs[0]), lambda x: [conv2d_w_inv(x)]))
        if i == 0:
            slots.append(Slot(("params", "conv0", "b"), ["c0/b"], [(cout,)],
                              lambda xs: _t(xs[0]), lambda x: [_t(x)]))
        else:
            slots += _bn_slots((f"bn{i}",), f"bn{i}", cout)
        cin = cout
    c = widths[-1]
    slots.append(Slot(
        ("params", "fc", "w"), ["fc/W"], [(1, c * s_out * s_out)],
        lambda xs: linear_w_from_chw(xs[0], c, s_out, s_out),
        lambda x: [linear_w_from_chw_inv(x, c, s_out, s_out)]))
    slots.append(Slot(("params", "fc", "b"), ["fc/b"], [(1,)],
                      lambda xs: _t(xs[0]), lambda x: [_t(x)]))
    return slots


def video_disc_spec(m: ModelConfig) -> List[Slot]:
    """D_V: ``c0..c3`` (L.ConvolutionND ndim=3), ``bn1..bn3``, ``fc`` (+
    ``fc_cls`` in the conditional variant). The head's rows go from
    Chainer's (C, T, H, W) flatten to the channels-last (T, H, W, C) one,
    T and S the ceil-divided sizes after the strides (1,2,2), (2,2,2) x3."""
    ndf = m.disc_features
    widths = [ndf, ndf * 2, ndf * 4, ndf * 8]
    t, s = m.video_length, m.image_size
    slots: List[Slot] = []
    cin = m.channels
    for i, cout in enumerate(widths):
        st = (1, 2, 2) if i == 0 else (2, 2, 2)
        t, s = -(-t // st[0]), -(-s // st[1])
        slots.append(Slot(
            ("params", f"conv{i}", "w"), [f"c{i}/W"],
            [(cout, cin, 4, 4, 4)],
            lambda xs: conv3d_w(xs[0]), lambda x: [conv3d_w_inv(x)]))
        if i == 0:
            slots.append(Slot(("params", "conv0", "b"), ["c0/b"], [(cout,)],
                              lambda xs: _t(xs[0]), lambda x: [_t(x)]))
        else:
            slots += _bn_slots((f"bn{i}",), f"bn{i}", cout)
        cin = cout
    c = widths[-1]
    flat = c * t * s * s

    def head(name: str, n_out: int) -> List[Slot]:
        return [
            Slot(("params", name, "w"), [f"{name}/W"], [(n_out, flat)],
                 lambda xs: linear_w_from_cthw(xs[0], c, t, s, s),
                 lambda x: [linear_w_from_cthw_inv(x, c, t, s, s)]),
            Slot(("params", name, "b"), [f"{name}/b"], [(n_out,)],
                 lambda xs: _t(xs[0]), lambda x: [_t(x)]),
        ]

    slots += head("fc", 1)
    if m.conditional:
        slots += head("fc_cls", m.n_classes)
    return slots


NET_SPECS = {
    "gen": generator_spec,
    "di": image_disc_spec,
    "dv": video_disc_spec,
}

# Pre-BN biases Chainer layers may carry that the nets intentionally lack
# (BN mean-subtraction makes them exact no-ops).
_ABSORBED_BY_BN = {
    "gen": ["fc/b", "dc0/b", "dc1/b", "dc2/b"],
    "di": ["c1/b", "c2/b", "c3/b"],
    "dv": ["c1/b", "c2/b", "c3/b"],
}


# ---------------------------------------------------------------------------
# import / export
# ---------------------------------------------------------------------------

def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _get_path(tree: Dict[str, Any], path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def _load(src) -> Dict[str, np.ndarray]:
    """An npz path or a preloaded {key: array} mapping -> a dict."""
    if isinstance(src, str):
        with np.load(src) as f:
            return dict(f)
    return dict(src)


def split_trainer_snapshot(src) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                                         Dict[str, Any]]:
    """Split a whole Chainer Trainer ``snapshot_iter_N`` npz into per-net
    tensor dicts.

    Chainer's ``snapshot`` extension serializes the entire Trainer: model
    parameters land under ``updater/model:<name>/<child path>/<param>``
    beside optimizer state (``updater/optimizer:<name>/...``), iterator
    and extension state. This finds every ``model:<name>/`` group, strips
    the prefix, and maps group names onto the nets by convention: *gen*
    -> "gen", *video* discriminator spellings -> "dv", *image*
    discriminator spellings -> "di" (checked in that order — "video_dis"
    contains the substring "di"). Returns ({net: {canonical key: array}},
    report with per-net source group names and unmapped groups).
    """
    raw = _load(src)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in raw.items():
        mm = re.search(r"model:([^/]+)/(.+)", k.lstrip("/"))
        if mm:
            groups.setdefault(mm.group(1), {})[mm.group(2)] = v
    nets: Dict[str, Dict[str, np.ndarray]] = {}
    report: Dict[str, Any] = {"groups": {}, "unmapped": []}
    for name, tensors in groups.items():
        low = name.lower()
        # substrings for the unambiguous spellings; the short forms
        # ("dv"/"di"/"v"/"i") only as whole tokens — the substring "di"
        # would send any name containing "dis" (e.g. "v_dis") to D_I
        toks = set(re.split(r"[^a-z0-9]+", low)) - {""}
        if "gen" in low:
            net = "gen"
        elif (any(s in low for s in ("video", "vdis", "dis_v"))
              or toks & {"dv", "v"}):
            net = "dv"
        elif (any(s in low for s in ("image", "idis", "dis_i"))
              or toks & {"di", "i"}):
            net = "di"
        else:
            report["unmapped"].append(name)
            continue
        if net in nets:
            raise ValueError(
                f"trainer snapshot has two groups mapping to {net!r}: "
                f"{report['groups'][net]} and {name}; import the nets "
                f"individually with --rename")
        nets[net] = tensors
        report["groups"][net] = name
    if not nets:
        raise ValueError(
            "no 'model:<name>/' groups found — not a Chainer Trainer "
            "snapshot npz? (per-net save_npz files go through "
            "--gen-npz/--di-npz/--dv-npz instead)")
    return nets, report


def import_net_npz(npz_path, net: str, m: ModelConfig,
                   rename: Optional[Dict[str, str]] = None,
                   strict: bool = True
                   ) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Map one Chainer-convention npz (path or preloaded {key: array} dict)
    onto JAX-layout (params, bn_state, report) trees of numpy arrays.

    rename maps ACTUAL npz key -> canonical key. The report lists, per
    tensor: matched / shape-mismatch / missing / unused / absorbed.
    """
    raw = _load(npz_path)
    if rename:
        raw = {rename.get(k, k): v for k, v in raw.items()}
    # Chainer snapshots sometimes prefix keys with the chain root
    # ('updater/...' or a leading '/'); strip a leading '/'
    raw = {k.lstrip("/"): v for k, v in raw.items()}

    spec = NET_SPECS[net](m)
    params: Dict[str, Any] = {}
    bn: Dict[str, Any] = {}
    report: Dict[str, Any] = {"matched": [], "shape_mismatch": [],
                              "missing": [], "unused": [], "absorbed": []}
    used = set()
    for slot in spec:
        vals, ok = [], True
        for key, shape in zip(slot.sources, slot.shapes):
            if key not in raw:
                report["missing"].append(
                    {"key": key, "expected_shape": list(shape)})
                ok = False
                continue
            arr = np.asarray(raw[key], np.float32)
            used.add(key)
            if tuple(arr.shape) != tuple(shape):
                report["shape_mismatch"].append(
                    {"key": key, "expected_shape": list(shape),
                     "got_shape": list(arr.shape)})
                ok = False
                continue
            vals.append(arr)
        if not ok:
            continue
        tree = {"params": params, "bn": bn}[slot.path[0]]
        _set_path(tree, slot.path[1:], slot.build(vals))
        report["matched"].extend(slot.sources)
    for key in raw:
        if key in used:
            continue
        if key in _ABSORBED_BY_BN.get(net, []):
            report["absorbed"].append(
                {"key": key,
                 "reason": "pre-BatchNorm bias: zero effect (BN subtracts "
                           "the mean), dropped losslessly"})
        elif key.endswith("/N"):          # BN's update counter
            report["absorbed"].append(
                {"key": key, "reason": "BN iteration counter, not a "
                                       "parameter"})
        else:
            report["unused"].append(key)
    if strict and (report["missing"] or report["shape_mismatch"]):
        raise ValueError(
            f"{net}: import incomplete — "
            f"{len(report['missing'])} missing, "
            f"{len(report['shape_mismatch'])} shape mismatches; "
            f"run the CLI for the per-tensor report or pass --rename")
    return params, bn, report


def export_net_npz(npz_path: str, net: str, params: Dict[str, Any],
                   bn: Dict[str, Any], m: ModelConfig) -> None:
    """Inverse mapping: write JAX-layout trees (``bridge.params_tree`` /
    ``bridge.bn_tree`` of a torch net) as a Chainer-convention npz."""
    out: Dict[str, np.ndarray] = {}
    for slot in NET_SPECS[net](m):
        tree = {"params": params, "bn": bn}[slot.path[0]]
        value = np.asarray(_get_path(tree, slot.path[1:]), np.float32)
        for key, arr in zip(slot.sources, slot.unbuild(value)):
            out[key] = np.asarray(arr, np.float32)
    np.savez(npz_path, **out)


def export_state(state, out_dir: str) -> Dict[str, str]:
    """Export every net of a ``train.state.TrainState`` as
    ``<out_dir>/<net>.npz``; returns {net: path}."""
    from mocogan_tpu_torch import bridge

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, net in state.nets.items():
        paths[name] = os.path.join(out_dir, f"{name}.npz")
        export_net_npz(paths[name], name, bridge.params_tree(net),
                       bridge.bn_tree(net), state.cfg.model)
    return paths


def _deep_merge(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Overlay imported tensors onto an existing tree, keeping base entries
    the import did not provide (the strict=False contract: missing tensors
    KEEP their randomly-initialized values)."""
    out = dict(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def import_experiment(cfg: ExperimentConfig,
                      gen_npz=None, di_npz=None, dv_npz=None,
                      snapshot_npz=None,
                      rename: Optional[Dict[str, str]] = None,
                      strict: bool = True, device=None):
    """A fresh ``TrainState`` on `device` (default ``cuda``) with the given
    nets replaced by npz imports, merged over the random init (so with
    strict=False a missing tensor keeps its initial value). ``snapshot_npz``
    takes a whole Chainer Trainer snapshot in one call (split per net);
    per-net files override its groups. Adam's state stays empty: step 0.
    Returns (state, {net: report}, plus "snapshot" for a snapshot)."""
    from mocogan_tpu_torch import bridge
    from mocogan_tpu_torch.train import state as train_state

    sources: Dict[str, Any] = {}
    reports: Dict[str, Any] = {}
    if snapshot_npz is not None:
        nets, split_report = split_trainer_snapshot(snapshot_npz)
        reports["snapshot"] = split_report
        sources.update(nets)
    state = train_state.create(cfg, device=device)
    for net, path in (("gen", gen_npz), ("di", di_npz), ("dv", dv_npz)):
        if path is not None:
            sources[net] = path
    for net in ("gen", "di", "dv"):
        path = sources.get(net)
        if path is None:
            continue
        if net not in state.nets:
            raise ValueError(f"snapshot provides net {net!r} but the "
                             f"{cfg.name!r} config does not instantiate it")
        p, b, reports[net] = import_net_npz(path, net, cfg.model,
                                            rename=rename, strict=strict)
        module = state.nets[net]
        if p or b:
            bridge.load_net(
                module, _deep_merge(bridge.params_tree(module), p),
                _deep_merge(bridge.bn_tree(module), b))
    return state, reports


def parse_rename(pairs) -> Optional[Dict[str, str]]:
    """["actual=canonical", ...] (the CLIs' --rename) -> a rename map, or
    None for none."""
    return dict(kv.split("=", 1) for kv in pairs or []) or None


def main(argv=None) -> dict:
    """Run the CLI; returns {"reports", "digest"} (digest None without
    --digest)."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="mug")
    ap.add_argument("--gen-npz")
    ap.add_argument("--di-npz")
    ap.add_argument("--dv-npz")
    ap.add_argument("--snapshot-npz",
                    help="a whole Chainer Trainer snapshot_iter_N npz; "
                         "split into gen/di/dv (per-net flags above "
                         "override its groups)")
    ap.add_argument("--rename", nargs="*", metavar="ACTUAL=CANONICAL",
                    help="key renames adapting the real reference naming")
    ap.add_argument("--no-strict", action="store_true",
                    help="keep randomly-initialized values for missing "
                         "tensors instead of failing")
    ap.add_argument("--digest", action="store_true",
                    help="after importing the generator, print the fp32 "
                         "generate() digest (eval/parity.py contract)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    state, reports = import_experiment(
        cfg, gen_npz=args.gen_npz, di_npz=args.di_npz, dv_npz=args.dv_npz,
        snapshot_npz=args.snapshot_npz, rename=parse_rename(args.rename),
        strict=not args.no_strict, device=device)
    for net, rep in reports.items():
        print(f"== {net} ==")
        print(json.dumps({k: v for k, v in rep.items() if v}, indent=2))
        if net == "snapshot":
            print(f"[snapshot] groups {rep['groups']}; "
                  f"{len(rep['unmapped'])} unmapped")
            continue
        n_bad = len(rep["missing"]) + len(rep["shape_mismatch"])
        print(f"[{net}] {len(rep['matched'])} tensors matched, {n_bad} "
              f"problems, {len(rep['unused'])} unused npz keys")

    digest = None
    if args.digest and "gen" in reports:
        from mocogan_tpu_torch.eval.parity import video_digest
        from mocogan_tpu_torch.models import generator
        from mocogan_tpu_torch.utils.platform import cudnn_deterministic

        with cudnn_deterministic():
            vids = generator.generate(state.nets["gen"], args.n,
                                      seed=args.seed)
        digest = video_digest(vids)
        print(f"generate() digest (n={args.n}, seed={args.seed}): {digest}")
    return {"reports": reports, "digest": digest}


if __name__ == "__main__":
    main()
