"""Experiment configuration dataclasses (the port's own copy).

Same fields, defaults and named configs as the JAX package's configs, so a
config name means the same experiment in both packages. Latent dimensions
follow the MoCoGAN paper (arXiv:1707.04993): content code z_C is 50-dim,
motion code z_M(t) is the 10-dim hidden state of a one-layer GRU driven by
i.i.d. Gaussian noise e_t.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for all four networks."""

    dim_content: int = 50      # z_C — fixed per clip
    dim_motion: int = 10       # z_M(t) — GRU hidden size
    dim_eps: int = 10          # per-step GRU input noise e_t

    image_size: int = 64       # H == W
    channels: int = 3
    video_length: int = 16     # T

    gen_features: int = 64     # ngf: deepest layer has gen_features * 8 maps
    disc_features: int = 64    # ndf

    n_classes: int = 0         # 0 => unconditional

    use_video_discriminator: bool = True

    # Params are always fp32; compute may run in bfloat16.
    compute_dtype: str = "float32"   # "float32" | "bfloat16"

    # Recompute the frame decoder in the backward pass.
    remat: bool = False

    @property
    def dim_z(self) -> int:
        """Per-frame latent fed to the image generator: [z_C, onehot?, z_M]."""
        return self.dim_content + self.n_classes + self.dim_motion

    @property
    def conditional(self) -> bool:
        return self.n_classes > 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters: Adam(2e-4, beta1=0.5) for all three
    nets (MoCoGAN paper Sec. 4)."""

    batch_size: int = 16
    learning_rate: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    total_steps: int = 100_000
    seed: int = 0

    aux_loss_weight: float = 1.0

    # "simultaneous": all three losses from one forward with
    # start-of-iteration parameters. "sequential": D_I/D_V update first,
    # then G's loss against the post-update discriminators.
    update_order: str = "simultaneous"

    label_smoothing: float = 0.0    # one-sided real-label smoothing, both Ds
    d_update_every: int = 1         # apply D_I/D_V Adam updates every k steps
    g_update_every: int = 1         # apply G Adam updates every k steps
    d_learning_rate: Optional[float] = None
    g_learning_rate: Optional[float] = None

    # The JAX package's flattened-Adam layout switch, numerically identical
    # by design; carried so its configs carry over. The port's torch Adam
    # is unaffected by it.
    fused_adam: bool = False

    checkpoint_every: int = 2_000
    log_every: int = 100
    sample_every: int = 1_000
    keep_checkpoints: int = 3
    eval_every: int = 0
    eval_clips: int = 256

    # Data parallelism, one process per GPU (parallel/mesh.py): None means
    # the world's size (torchrun's, or every visible GPU for the train
    # CLI, which spawns that many workers); any other value must equal it.
    # The global batch_size is split evenly over the devices.
    num_devices: Optional[int] = None
    # Nodes of a multi-node world (the JAX package's DCN slices): the world
    # must divide into them and, under torchrun, match its nodes, each of
    # the same size. The batch is split slice-major, which is rank order.
    n_slices: int = 1

    # Adversarial steps per trainer call.
    steps_per_call: int = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The data feed. ``fused_preproc`` is kept so that the JAX package's
    configs carry over, and the port ignores it: on the card the ingest of
    raw clips always runs the kernel (``csrc/resize_norm.cu``), on both
    training paths, and the plain version runs only on the CPU."""

    dataset: str = "synthetic"           # synthetic | mug | weizmann | npy_dir
    data_dir: str = ""
    # Raw stored frame size before the fused on-device resize.
    raw_size: int = 64
    fused_preproc: bool = True
    # Keep the whole uint8 clip store resident in device memory and sample
    # batches there.
    device_cache: bool = False
    prefetch: int = 2
    # Every clip exactly once per epoch, order re-drawn per epoch from
    # (seed, epoch). False = i.i.d. per-batch draws.
    epoch_shuffle: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: ModelConfig
    train: TrainConfig
    data: DataConfig
    out_dir: str = "runs"


def _toy() -> ExperimentConfig:
    """Config 1 — unconditional toy run, D_I only."""
    return ExperimentConfig(
        name="toy",
        model=ModelConfig(
            image_size=64, channels=3, video_length=16,
            gen_features=32, disc_features=32,
            use_video_discriminator=False,
        ),
        train=TrainConfig(batch_size=8, total_steps=2_000),
        data=DataConfig(dataset="synthetic"),
    )


def _mug() -> ExperimentConfig:
    """Config 2 — MUG facial expressions, D_I + D_V, fp32 at batch 16."""
    return ExperimentConfig(
        name="mug",
        model=ModelConfig(image_size=64, channels=3, video_length=16),
        train=TrainConfig(batch_size=16, steps_per_call=16),
        data=DataConfig(dataset="mug", raw_size=96, device_cache=True,
                        epoch_shuffle=True),
    )


def _weizmann() -> ExperimentConfig:
    """Config 3 — Weizmann actions, full MoCoGAN S_1/S_T loss."""
    return ExperimentConfig(
        name="weizmann",
        model=ModelConfig(image_size=64, channels=3, video_length=16),
        train=TrainConfig(batch_size=16, steps_per_call=16),
        data=DataConfig(dataset="weizmann", raw_size=96, device_cache=True,
                        epoch_shuffle=True),
    )


def _categorical() -> ExperimentConfig:
    """Config 4 — categorical MoCoGAN with conditional D_V head."""
    return ExperimentConfig(
        name="categorical",
        model=ModelConfig(
            image_size=64, channels=3, video_length=16,
            n_classes=6,  # MUG has 6 expression classes
        ),
        train=TrainConfig(batch_size=16, steps_per_call=16),
        data=DataConfig(dataset="mug", raw_size=96, device_cache=True,
                        epoch_shuffle=True),
    )


def _scaled() -> ExperimentConfig:
    """Config 5 — 96x96x32f, 8-way data parallel, bf16 compute."""
    return ExperimentConfig(
        name="scaled",
        model=ModelConfig(
            image_size=96, channels=3, video_length=32,
            compute_dtype="bfloat16", remat=True,
        ),
        train=TrainConfig(batch_size=64, num_devices=8, steps_per_call=32),
        data=DataConfig(dataset="weizmann", raw_size=128, fused_preproc=True,
                        device_cache=True, epoch_shuffle=True),
    )


_CONFIGS = {
    "toy": _toy,
    "mug": _mug,
    "weizmann": _weizmann,
    "categorical": _categorical,
    "scaled": _scaled,
}


def list_configs() -> Tuple[str, ...]:
    return tuple(_CONFIGS)


def get_config(name: str, **overrides) -> ExperimentConfig:
    """Build a named config; ``overrides`` replace top-level fields or, with
    dotted keys (``model.video_length=32``), nested dataclass fields."""
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_CONFIGS)}")
    cfg = _CONFIGS[name]()
    nested: dict = {}
    flat: dict = {}
    for k, v in overrides.items():
        if "." in k:
            head, tail = k.split(".", 1)
            nested.setdefault(head, {})[tail] = v
        else:
            flat[k] = v
    for head, kv in nested.items():
        sub = getattr(cfg, head)
        cfg = dataclasses.replace(cfg, **{head: dataclasses.replace(sub, **kv)})
    if flat:
        cfg = dataclasses.replace(cfg, **flat)
    return cfg
