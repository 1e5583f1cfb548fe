"""Convert between the JAX package's parameter trees and the port's modules.

The JAX side is handed over as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, state.params["gen"])``); the port never sees a
JAX object. A net's tree has one entry per child layer of its module, keyed
by the same name ("fc", "bn_fc", "deconv0", "conv1", ...); each layer
converts its own weight layout (``ops.layers._Layer.from_jax/to_jax``).
BatchNorm running stats travel in a separate ``bn`` tree of
{"mean", "var"} per BN layer, as in the JAX package.

The whole training state crosses too (``state_trees``/``load_state``): the
step counter, params, bn, and each net's Adam state. The JAX side's Adam
state is optax's ``ScaleByAdamState(count, mu, nu)``, handed over as
{"count": int, "mu": tree, "nu": tree}; mu and nu are params-shaped trees
and take the params' layout conversion. On the port's side they are torch
Adam's ``step``, ``exp_avg`` and ``exp_avg_sq``.

The eval's random-projection extractor crosses the same way
(``fvd_extractor_from_jax``). I3D needs no converter: both packages read
the same npz contract (``eval/i3d.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mocogan_tpu_torch.ops import layers

Tree = Dict[str, Any]


def _from_tree(net: nn.Module, tree: Mapping[str, Any]):
    """(layer name, layer, parameter name, parameter, torch-layout numpy
    array) for every parameter of `net` from a params-shaped JAX tree."""
    children = dict(net.named_children())
    if set(tree) != set(children):
        raise KeyError(f"params tree has {sorted(tree)}, module has "
                       f"{sorted(children)}")
    for name, layer in children.items():
        own = dict(layer.named_parameters(recurse=False))
        if set(tree[name]) != set(own):
            raise KeyError(f"{name}: tree has {sorted(tree[name])}, module "
                           f"has {sorted(own)}")
        for pname, p in own.items():
            a = layer.from_jax(pname, np.asarray(tree[name][pname],
                                                 np.float32))
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}.{pname}: shape {a.shape} != "
                                 f"{tuple(p.shape)}")
            yield name, layer, pname, p, a


@torch.no_grad()
def load_net(net: nn.Module, params: Mapping[str, Any],
             bn: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Copy a JAX params tree (and, if given, its bn tree) into `net`."""
    for _, _, _, p, a in _from_tree(net, params):
        p.copy_(torch.tensor(a))
    if bn is not None:
        for name, layer in net.named_children():
            if isinstance(layer, layers.BatchNorm):
                for stat in ("mean", "var"):
                    getattr(layer, stat).copy_(
                        torch.tensor(np.asarray(bn[name][stat], np.float32)))
    return net


def params_tree(net: nn.Module,
                tensors: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tree:
    """The JAX params tree of `net`. With `tensors` (full parameter name ->
    tensor of the parameter's shape, e.g. gradients), convert those
    instead of the parameters."""
    out: Tree = {}
    for name, layer in net.named_children():
        sub = {}
        for pname, p in layer.named_parameters(recurse=False):
            t = p if tensors is None else tensors[f"{name}.{pname}"]
            sub[pname] = layer.to_jax(pname, t.detach().cpu().numpy())
        out[name] = sub
    return out


def bn_tree(net: nn.Module) -> Tree:
    """The JAX bn tree (running stats) of `net`."""
    return {name: {"mean": layer.mean.detach().cpu().numpy(),
                   "var": layer.var.detach().cpu().numpy()}
            for name, layer in net.named_children()
            if isinstance(layer, layers.BatchNorm)}


def adam_tree(net: nn.Module, opt: torch.optim.Adam) -> Tree:
    """`net`'s Adam state as optax keeps it: {"count", "mu", "nu"}, with mu
    and nu as params-shaped JAX trees (zeros before the first update)."""
    named = dict(net.named_parameters())
    st = {n: opt.state.get(p, {}) for n, p in named.items()}
    counts = {int(s["step"]) for s in st.values() if s}
    if len(counts) > 1:
        raise ValueError(f"parameters of one net at different Adam steps: "
                         f"{sorted(counts)}")
    moments = {key: {n: st[n].get(key, torch.zeros_like(p))
                     for n, p in named.items()}
               for key in ("exp_avg", "exp_avg_sq")}
    return {"count": counts.pop() if counts else 0,
            "mu": params_tree(net, moments["exp_avg"]),
            "nu": params_tree(net, moments["exp_avg_sq"])}


@torch.no_grad()
def load_adam(net: nn.Module, opt: torch.optim.Adam,
              tree: Mapping[str, Any]) -> None:
    """Set `net`'s Adam state from {"count", "mu", "nu"} as ``adam_tree``
    gives it."""
    nu = {(name, pname): a for name, _, pname, _, a in
          _from_tree(net, tree["nu"])}
    for name, _, pname, p, a in _from_tree(net, tree["mu"]):
        opt.state[p] = {
            "step": torch.tensor(float(tree["count"]), dtype=torch.float32),
            "exp_avg": torch.tensor(a, device=p.device),
            "exp_avg_sq": torch.tensor(nu[name, pname], device=p.device)}


def state_trees(state) -> Tree:
    """A ``train.state.TrainState`` as the JAX package's trees (numpy):
    {"step", "params", "bn", "opt": {net: {"count", "mu", "nu"}}}."""
    return {"step": state.step,
            "params": {n: params_tree(net) for n, net in state.nets.items()},
            "bn": {n: bn_tree(net) for n, net in state.nets.items()},
            "opt": {n: adam_tree(net, state.opt[n])
                    for n, net in state.nets.items()}}


def fvd_extractor_from_jax(params: Mapping[str, Any]):
    """An ``eval.fvd.RandomProjectionFeatures`` holding the JAX extractor's
    weights (its ``params`` tree: DHWIO conv kernels, (in, out) dense), on
    the CPU. It then has the JAX extractor's fingerprint, so fvd_proxy
    values of the two packages compare."""
    from mocogan_tpu_torch.eval.fvd import RandomProjectionFeatures

    ext = RandomProjectionFeatures(
        dim=int(np.shape(params["proj"]["w"])[-1]),
        width=int(np.shape(params["conv0"]["w"])[-1]))
    return load_net(ext, params)


def load_state(state, trees: Mapping[str, Any]):
    """Load trees as ``state_trees`` gives them (from a JAX state: params,
    bn, optax Adam state and step) into `state`, in place; returns it."""
    for n, net in state.nets.items():
        load_net(net, trees["params"][n], trees["bn"][n])
        load_adam(net, state.opt[n], trees["opt"][n])
    state.step = int(trees["step"])
    return state
