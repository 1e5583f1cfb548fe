"""Which convolution passes of a train step repeat bit for bit, which cuDNN
kernels each one runs, and what each costs: the attribution behind the
layers' routes (``ops/layers.py``).

    python -m mocogan_tpu_torch.utils.conv_audit --config mug [--tf32]
        [--set K=V ...] [--out FILE] [--device cpu]

TF32 is off for matmuls and cuDNN unless ``--tf32``, which leaves cuDNN's
TF32 on as the train CLI does. Prints one JSON line; ``--out`` writes it.

One simultaneous step (``train/step.compute_grads``) of a seeded state on
a synthetic real batch runs with every conv and transposed conv wrapped to
record its input, weight and stride and, through tensor hooks, its output
and input gradients. A pass is ``fwd``, ``dgrad`` (the input's gradient)
or ``wgrad`` (the weight's). The line holds:

  * ``in_situ``: that step's gradients twice from the same state, through
    the layers' routes (``layer``) and through the plain torch calls the
    layers made before they had routes (``plain``: ``F.conv2d``/``conv3d``
    on XLA SAME pads, ``F.conv_transpose2d``): per net whether its
    gradients are bit-equal, and the (layer, pass) records that differ.
  * ``replay``: each (layer, pass), with its shapes and the calls a step
    makes, on the tensors its first call recorded, through every route
    that computes it: ``plain`` (cuDNN's default
    algorithm), ``cudnn_det`` (its deterministic one), ``subpixel`` (one
    stride-1 forward conv), ``phases`` (one forward conv per phase) and
    ``layer`` (what the layer runs): whether two calls are bit-equal, the
    kernels of one call (profiler), device ms per call (CUDA events) and
    ms per 16 steps (ms x calls a step x 16).
  * ``nonconv``: one ``train_step`` under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, a
    diagnostic the train path never sets: the warnings it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import tempfile
import warnings
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from mocogan_tpu_torch.ops import layers
from mocogan_tpu_torch.train import state as train_state
from mocogan_tpu_torch.train import step as train_step
from mocogan_tpu_torch.utils.platform import resolve_device

_REPS = 10          # timed calls a route


def _plain_conv(x, w, b, stride, dtype):
    """The layers' conv before routes: F.conv on XLA SAME pads, fp32 with
    the bias inside the conv."""
    fn = F.conv2d if x.ndim == 4 else F.conv3d
    x, w = layers._cast(x, dtype), layers._cast(w, dtype)
    b_in, b_after = (b, None) if dtype == torch.float32 else (None, b)
    pads = [layers.same_pads(x.shape[2 + i], w.shape[2 + i], s)
            for i, s in enumerate(stride)]
    x, padding = layers._padded(x, pads)
    y = fn(x, w, b_in, stride=tuple(stride), padding=tuple(padding))
    return y if b_after is None else layers._add_bias(y, b_after)


def _plain_deconv(x, w, b, stride, dtype):
    """The layers' transposed conv before routes."""
    p = (w.shape[-1] - stride) // 2
    if dtype == torch.float32:
        return F.conv_transpose2d(x, w, b, stride=stride, padding=p)
    y = F.conv_transpose2d(layers._cast(x, dtype), layers._cast(w, dtype),
                           None, stride=stride, padding=p)
    return y if b is None else layers._add_bias(y, b)


class _Recorder:
    """Wraps ``layers.conv2d``/``conv3d``/``deconv2d`` for the life of a
    ``with``: records each call and routes it through the layer (``plain``
    False) or the plain torch call."""

    def __init__(self, state, plain: bool):
        self.names = {id(p): f"{net}.{mod}" for net, m in state.nets.items()
                      for mod, sub in m.named_modules()
                      for pn, p in sub.named_parameters(recurse=False)
                      if pn == "w"}
        self.plain = plain
        self.calls: List[dict] = []
        self.targets: tuple = ()
        self._saved = None

    def _record(self, kind, x, w, stride, dtype, y):
        name = self.names.get(id(w))
        if name is None:             # not a net's layer (e.g. I3D)
            return y
        xc, wc = layers._cast(x, dtype), layers._cast(w, dtype)
        k = wc.shape[2:]
        if kind == "conv":
            pads = tuple(layers.same_pads(n, kk, s) for n, kk, s in
                         zip(xc.shape[2:], k, stride))
        else:
            pads = tuple(((kk - s) // 2,) * 2 for kk, s in zip(k, stride))
        rec = {"layer": name, "kind": kind, "x": xc.detach(),
               "w": wc.detach(), "stride": tuple(stride), "pads": pads,
               "dtype": dtype, "y": y.detach(), "dy": None, "dx": None,
               "needs_w": False}
        self.calls.append(rec)
        if y.requires_grad:
            def on_dy(g, rec=rec):
                rec["dy"] = g.detach().to(dtype)
                rec["needs_w"] = name.split(".")[0] in self.targets
            y.register_hook(on_dy)
        if x.requires_grad:
            def on_dx(g, rec=rec):
                rec["dx"] = g.detach()
            x.register_hook(on_dx)
        return y

    def __enter__(self):
        orig = layers.conv2d, layers.conv3d, layers.deconv2d, \
            train_step._grads
        self._saved = orig

        def conv2d(x, w, b=None, stride=2, dtype=torch.float32):
            y = (_plain_conv(x, w, b, (stride, stride), dtype) if self.plain
                 else orig[0](x, w, b, stride, dtype))
            return self._record("conv", x, w, (stride, stride), dtype, y)

        def conv3d(x, w, b, stride, dtype=torch.float32):
            y = (_plain_conv(x, w, b, stride, dtype) if self.plain
                 else orig[1](x, w, b, stride, dtype))
            return self._record("conv", x, w, stride, dtype, y)

        def deconv2d(x, w, b=None, stride=2, dtype=torch.float32):
            y = (_plain_deconv(x, w, b, stride, dtype) if self.plain
                 else orig[2](x, w, b, stride, dtype))
            return self._record("deconv", x, w, (stride, stride), dtype, y)

        def grads(state, loss, names, mesh):
            self.targets = tuple(names)
            return orig[3](state, loss, names, mesh)

        layers.conv2d, layers.conv3d, layers.deconv2d = conv2d, conv3d, \
            deconv2d
        train_step._grads = grads
        return self

    def __exit__(self, *exc):
        layers.conv2d, layers.conv3d, layers.deconv2d, \
            train_step._grads = self._saved


def _passes(rec) -> List[str]:
    out = ["fwd"]
    if rec["dx"] is not None:
        out.append("dgrad")
    if rec["needs_w"]:
        out.append("wgrad")
    return out


def _geometry(rec, p):
    """(op, big, small) of pass `p`: a conv's input is the big side of its
    geometry, a transposed conv's output is."""
    dy = rec["dy"]
    if rec["kind"] == "conv":
        op = {"fwd": "conv", "dgrad": "dgrad", "wgrad": "wgrad"}[p]
        return op, rec["x"], dy
    op = {"fwd": "dgrad", "dgrad": "conv", "wgrad": "wgrad"}[p]
    return op, (dy if p != "fwd" else None), rec["x"]


def _big_size(rec) -> tuple:
    if rec["kind"] == "conv":
        return tuple(rec["x"].shape[2:])
    return tuple(n * s for n, s in zip(rec["x"].shape[2:], rec["stride"]))


def _dgrad_phases(dy, w, stride, pads, size):
    """The data gradient as one stride-1 forward conv per phase, each
    writing only its own outputs."""
    out = dy.new_zeros(dy.shape[0], w.shape[1], *size)
    for rho in itertools.product(*[range(s) for s in stride]):
        kern, cut, pad, dst = w, [], [], []
        for d, (s, (lo, _), n, m) in enumerate(zip(stride, pads, size,
                                                   dy.shape[2:])):
            r, c = (rho[d] + lo) % s, (rho[d] + lo) // s
            a_n, u_n = -(-(n - rho[d]) // s), -(-(w.shape[2 + d] - r) // s)
            cut.append(slice(r, None, s))
            pad.append((u_n - 1 - c, a_n + c - m))
            dst.append(slice(rho[d], None, s))
            if a_n <= 0 or u_n <= 0:
                break
        else:
            kern = w[(slice(None), slice(None), *cut)].flip(
                list(range(2, w.ndim))).transpose(0, 1)
            z = layers._conv_fwd(dy, kern, [1] * len(stride), pad)
            out[(slice(None), slice(None), *dst)] = z
    return out


def _plain(fn):
    """fn with the layers' cuDNN calls on cuDNN's default algorithms, as
    the layers made them before they had routes."""
    def call():
        saved = layers.cudnn_deterministic
        layers.cudnn_deterministic = contextlib.nullcontext
        try:
            return fn()
        finally:
            layers.cudnn_deterministic = saved
    return call


def _routes(op: str, rec, big, small) -> Dict[str, callable]:
    w, st, pads = rec["w"], rec["stride"], rec["pads"]
    size = _big_size(rec)
    if op == "conv":
        return {"plain": lambda: layers._conv_fwd(big, w, st, pads)}
    if op == "wgrad":
        return {"plain": _plain(lambda: layers._wgrad(big, small, w, st,
                                                      pads)),
                "cudnn_det": lambda: layers._wgrad(big, small, w, st, pads),
                "layer": lambda: layers._wgrad(big, small, w, st, pads)}
    return {"plain": _plain(lambda: layers._dgrad_cudnn(small, w, st, pads,
                                                        size)),
            "cudnn_det": lambda: layers._dgrad_cudnn(small, w, st, pads,
                                                     size),
            "subpixel": lambda: layers._dgrad_subpixel(small, w, st, pads,
                                                       size),
            "phases": lambda: _dgrad_phases(small, w, st, pads, size),
            "layer": lambda: layers._dgrad(small, w, st, pads, size)}


def _kernels(fn) -> List[list]:
    """[name, device us, launches] of the kernels one call of fn runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out: Dict[str, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            k = out.setdefault(e["name"][:100], [0.0, 0])
            k[0] += float(e["dur"])
            k[1] += 1
    return [[n, round(t, 2), c] for n, (t, c) in out.items()]


def _device_ms(fn) -> float:
    for _ in range(2):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(_REPS):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / _REPS


def _batch(cfg, device):
    from mocogan_tpu_torch.data import synthetic

    m = cfg.model
    vids, labels = synthetic.make_batch(
        0, cfg.train.batch_size, t=m.video_length, size=m.image_size,
        channels=m.channels, n_classes=m.n_classes if m.conditional else 0)
    return (torch.from_numpy(vids).to(device),
            torch.from_numpy(labels).long().to(device)
            if m.conditional else None)


def _step_records(state, real, labels, noise, plain: bool):
    """(recorded calls, grads) of one simultaneous step."""
    with _Recorder(state, plain) as rec:
        grads, _ = train_step.compute_grads(state, real, noise, labels)
    return rec.calls, grads


def _same(a, b) -> bool:
    return a is None and b is None or (a is not None and b is not None
                                       and torch.equal(a, b))


def in_situ(state, real, labels, noise) -> dict:
    out = {}
    for mode in ("plain", "layer"):
        (c1, g1), (c2, g2) = [_step_records(state, real, labels, noise,
                                            mode == "plain")
                              for _ in range(2)]
        nets = {n: [pn for pn in g1[n] if not torch.equal(g1[n][pn],
                                                          g2[n][pn])]
                for n in g1}
        differ = set()
        for i, (a, b) in enumerate(zip(c1, c2)):
            for p, key in (("fwd", "y"), ("dgrad", "dx"),
                           ("out_grad", "dy")):
                if not _same(a[key], b[key]):
                    differ.add(f"{a['layer']} {p}")
        out[mode] = {"grads_equal": {n: not v for n, v in nets.items()},
                     "grads_differ": {n: v for n, v in nets.items() if v},
                     "records_differ": sorted(differ)}
        del c1, c2, g1, g2
    return out


def replay(calls, cuda: bool) -> list:
    groups: Dict[tuple, list] = {}
    for rec in calls:
        for p in _passes(rec):
            groups.setdefault((rec["layer"], p), []).append(rec)
    rows = []
    for (name, p), recs in groups.items():
        rec = recs[0]
        op, big, small = _geometry(rec, p)
        row = {"layer": name, "pass": p, "op": op, "dtype": str(
            rec["dtype"]).replace("torch.", ""), "calls_per_step": len(recs),
            "x": list(rec["x"].shape), "w": list(rec["w"].shape),
            "y": list(rec["y"].shape), "stride": list(rec["stride"]),
            "pads": [list(q) for q in rec["pads"]], "routes": {}}
        ref = None
        for route, fn in _routes(op, rec, big, small).items():
            a, b = fn(), fn()
            if ref is None:
                ref = a.float()
            r = {"repeats": bool(torch.equal(a, b)),
                 "max_rel_err_vs_plain": float(
                     (a.float() - ref).abs().max()
                     / ref.abs().max().clamp_min(1e-30))}
            if cuda:
                r["ms"] = _device_ms(fn)
                r["ms_per_16_steps"] = r["ms"] * len(recs) * 16
                r["kernels"] = _kernels(fn)
            row["routes"][route] = r
        rows.append(row)
    return rows


def nonconv(state, real, labels) -> List[str]:
    """The distinct warnings of one train_step under
    use_deterministic_algorithms(True, warn_only=True)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_step.train_step(state, real.clone(), labels=labels)
            if real.is_cuda:
                torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message)[:300] for w in caught})


def audit(cfg, device) -> dict:
    state = train_state.create(cfg, device=device)
    real, labels = _batch(cfg, device)
    noise = train_step.draw_noise(cfg, state.seed, 0, real.shape[0], device)
    calls, _ = _step_records(state, real, labels, noise, plain=False)
    out = {"config": cfg.name, "model": {
        "image_size": cfg.model.image_size,
        "video_length": cfg.model.video_length,
        "compute_dtype": cfg.model.compute_dtype,
        "remat": cfg.model.remat}, "batch": cfg.train.batch_size,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")}
    out["replay"] = replay(calls, device.type == "cuda")
    del calls
    out["in_situ"] = in_situ(state, real, labels, noise)
    out["nonconv"] = nonconv(state, real, labels)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", default="mug")
    ap.add_argument("--set", nargs="*", metavar="K=V", dest="overrides",
                    help="dotted config overrides, as the train CLI takes")
    ap.add_argument("--tf32", action="store_true",
                    help="leave cuDNN's TF32 on, as the train CLI does")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mocogan_tpu_torch import get_config
    from mocogan_tpu_torch.train.__main__ import parse_overrides

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = args.tf32
    cfg = get_config(args.config, **parse_overrides(args.overrides))
    out = {"overrides": args.overrides or [], **audit(cfg, device)}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
