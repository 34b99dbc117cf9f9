"""Config trees, checkpointing, logging and device helpers (mirrors
`cfgan/core`)."""
from cfgan_torch.core.config import (
    ClassifierConfig,
    CounterGANConfig,
    DataConfig,
    ExperimentConfig,
    GANConfig,
)

# `cfgan.core.RngStream` derives JAX keys and has no counterpart here:
# `cfgan_torch.data.pipeline.stream_seed` plays its part, seeding a
# `torch.Generator` per stream (ROADMAP A17).
__all__ = [
    "ClassifierConfig",
    "CounterGANConfig",
    "DataConfig",
    "ExperimentConfig",
    "GANConfig",
]
