"""MoCoGAN in PyTorch for NVIDIA Hopper: the port of ``mocogan_tpu``.

The package mirrors the JAX package's module names. Plain tensor code is
PyTorch; the one hand-written kernel, the fused uint8 ingest, is CUDA C++
in ``csrc/`` and builds at first use. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.

Public surface, as the JAX package's: ``get_config``, ``list_configs``,
``ExperimentConfig`` and ``generate(g, n, *, seed, ...)``, the sampling
API of ``models.generator``.
"""

__version__ = "0.1.0"

from mocogan_tpu_torch.configs import ExperimentConfig, get_config, list_configs
from mocogan_tpu_torch.models.generator import generate

__all__ = ["ExperimentConfig", "get_config", "list_configs", "generate",
           "__version__"]
