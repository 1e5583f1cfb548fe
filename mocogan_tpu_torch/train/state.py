"""Training state: the three nets, their Adam optimizers, seed and step.

BatchNorm running stats live in the modules' buffers. Parameters are
initialized on the CPU from the (seed, 0, "init") generator and then moved
to the device, so a seed gives the same initial weights on any device.
Params, BN stats and Adam moments are fp32 whatever ``model.compute_dtype``
says; the nets cast to it where they compute. Under data parallelism every
rank builds the same state from the seed (``create`` checks that it did).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch
from torch import nn

from mocogan_tpu_torch.configs import ExperimentConfig
from mocogan_tpu_torch.models import discriminators, generator
from mocogan_tpu_torch.parallel import mesh as pmesh
from mocogan_tpu_torch.parallel.mesh import Mesh
from mocogan_tpu_torch.utils import prng
from mocogan_tpu_torch.utils.platform import resolve_device


def make_optimizer(cfg: ExperimentConfig, net: str,
                   params: Iterable[nn.Parameter]) -> torch.optim.Adam:
    """Adam(lr 2e-4, beta1 0.5, beta2 0.999, eps 1e-8) per net, with the
    optional d_/g_learning_rate overrides."""
    t = cfg.train
    lr = t.learning_rate
    own = t.g_learning_rate if net == "gen" else t.d_learning_rate
    if own is not None:
        lr = own
    return torch.optim.Adam(params, lr=lr, betas=(t.beta1, t.beta2),
                            eps=1e-8)


class TrainState:
    """nets: {"gen", "di", ["dv"]} modules; opt: one Adam per net; step:
    the number of steps taken; seed: the root of every random draw;
    debug_nans: ``train_step`` raises ``FloatingPointError`` on the first
    non-finite loss, before the update."""

    def __init__(self, cfg: ExperimentConfig, seed: int, device: torch.device,
                 nets: Dict[str, nn.Module]):
        self.cfg = cfg
        self.seed = int(seed)
        self.device = device
        self.step = 0
        self.debug_nans = False
        self.nets = {name: net.to(device) for name, net in nets.items()}
        self.opt = {name: make_optimizer(cfg, name, net.parameters())
                    for name, net in self.nets.items()}


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of the state, in a fixed order: seed and step, then per
    net its params, BN buffers and Adam state."""
    out = [torch.tensor([state.seed, state.step])]
    for name, net in state.nets.items():
        out += [*net.parameters(), *net.buffers()]
        out += [v for st in state.opt[name].state.values()
                for v in st.values() if torch.is_tensor(v)]
    return out


def check_replicated(state: TrainState, mesh: Optional[Mesh]) -> None:
    """Raise on every rank unless all ranks of `mesh` hold the same state
    bit for bit (nothing to check without a process group)."""
    pmesh.check_replicated(state_tensors(state), mesh, "train state")


def create(cfg: ExperimentConfig, seed: Optional[int] = None,
           device=None, mesh: Optional[Mesh] = None) -> TrainState:
    """Initialize all nets and optimizers on `device` (default ``cuda``;
    raises when no GPU is visible unless ``device="cpu"``). With a
    data-parallel `mesh`, check that every rank built the same state."""
    dev = resolve_device(device)
    m = cfg.model
    seed = cfg.train.seed if seed is None else seed
    gen = prng.generator(seed, 0, "init")
    nets: Dict[str, nn.Module] = {
        "gen": generator.init(m, gen),
        "di": discriminators.image_init(m, gen),
    }
    if m.use_video_discriminator:
        nets["dv"] = discriminators.video_init(m, gen)
    state = TrainState(cfg, seed, dev, nets)
    check_replicated(state, mesh)
    return state


def param_count(state: TrainState) -> Dict[str, int]:
    """Trainable parameters per net, as the JAX package counts its params
    tree: BN running statistics are buffers and do not count."""
    return {name: sum(p.numel() for p in net.parameters())
            for name, net in state.nets.items()}

