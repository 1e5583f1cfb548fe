"""PRNG discipline: every random draw is a pure function of (seed, step, role).

The JAX package folds (step, role) into one threefry root key. Torch has no
such key, so each draw here gets its own ``torch.Generator`` seeded from a
hash of (seed, step, role, sub). The bits differ from JAX's; what is kept
is the property: a draw never depends on call order or on earlier draws,
so a step's noise and data plan can be recomputed from (seed, step) alone.
Every generator is a CPU generator, whatever device the draw is meant for:
callers draw on the host and copy the result to the device
(``platform.upload``), so a seed gives the same draws on the card as on the
CPU.
"""

from __future__ import annotations

import hashlib
import struct

import torch

# The JAX package's role names; ids offset so they can never equal a step.
_ROLES = (
    "content",        # z_C draw
    "motion_init",    # GRU initial hidden state
    "motion_noise",   # per-step GRU input noise e_t
    "frame_sample",   # S_1 random frame index
    "label",          # categorical class draw
    "data",           # clip-selection plan
    "init",           # parameter initialization
    "epoch",          # per-epoch clip permutation (epoch_shuffle mode)
)
_ROLE_ID = {name: (1 << 30) + i for i, name in enumerate(_ROLES)}


def derive_seed(seed: int, step: int, role: str, sub: int = 0) -> int:
    """63-bit generator seed for (seed, step, role, sub)."""
    msg = struct.pack("<qqqq", int(seed), int(step), _ROLE_ID[role], int(sub))
    digest = hashlib.blake2b(msg, digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def generator(seed: int, step: int, role: str, sub: int = 0
              ) -> torch.Generator:
    """A fresh CPU generator for one (seed, step, role, sub) draw."""
    g = torch.Generator()
    g.manual_seed(derive_seed(seed, step, role, sub))
    return g
