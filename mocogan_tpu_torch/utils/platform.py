"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a visible GPU raises:
    the port never falls back to the CPU on its own; pass ``device="cpu"``
    to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` (a CPU tensor) on `device`, copied without holding the host: on
    a GPU through pinned memory with ``non_blocking=True``. PyTorch's
    pinned-memory allocator keeps the staging block until the copy has
    run. On the CPU `t` itself is returned."""
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


@contextlib.contextmanager
def cudnn_deterministic():
    """``cudnn.deterministic = True`` and ``cudnn.benchmark = False`` for
    the block; the previous values after it."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old
