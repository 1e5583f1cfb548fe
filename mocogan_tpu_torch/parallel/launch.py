"""Spawn the ranks of a one-node data-parallel world from one command.

``torchrun`` starts one process per GPU and describes the world in their
environment. ``spawn`` does the same from inside a CLI, for the JAX
package's single command over every local device: it starts `world`
processes with ``torch.multiprocessing`` (the spawn method), sets RANK,
WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE in each as ``torchrun`` would
on one node, and calls ``<module>.main(argv, init_method=...)`` there. The
ranks meet through a file store in a fresh temporary directory, so two
worlds started side by side never share a rendezvous.
"""

from __future__ import annotations

import importlib
import os
import tempfile
from typing import Sequence


def _worker(rank: int, world: int, module: str, argv: Sequence[str],
            init_method: str) -> None:
    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    # the ranks share the node's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    importlib.import_module(module).main(list(argv), init_method=init_method)


def spawn(world: int, module: str, argv: Sequence[str]) -> None:
    """Run ``module.main(argv, init_method=...)`` in `world` ranks and wait
    for all of them; the first rank that fails stops the others and its
    error is raised here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mocogan_world_") as tmp:
        mp.spawn(_worker, args=(world, module, list(argv),
                                "file://" + os.path.join(tmp, "store")),
                 nprocs=world, join=True)
