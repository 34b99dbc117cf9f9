"""The experiments' presets (mirrors `cfgan/experiments`).  The
experiments themselves run with `python -m`, so nothing here imports
them."""
from cfgan_torch.experiments.presets import PRESETS

__all__ = ["PRESETS"]
