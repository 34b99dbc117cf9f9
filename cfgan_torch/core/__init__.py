"""Config trees, checkpointing, logging and device helpers (mirrors
`cfgan/core`)."""
from cfgan_torch.core.config import (
    ClassifierConfig,
    CounterGANConfig,
    DataConfig,
    ExperimentConfig,
    GANConfig,
)
from cfgan_torch.core.rng import RngStream

__all__ = [
    "ClassifierConfig",
    "CounterGANConfig",
    "DataConfig",
    "ExperimentConfig",
    "GANConfig",
    "RngStream",
]
