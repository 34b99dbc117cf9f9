"""Train state, the classifier and CounteRGAN steps and the epoch loop
(mirrors `cfgan/train`)."""
from cfgan_torch.train.state import (
    GANState,
    NetState,
    adam_like_torch,
    global_grad_norm,
)
from cfgan_torch.train.classifier import train_classifier
from cfgan_torch.train.countergan import make_countergan_step
from cfgan_torch.train.loop import make_epoch_runner

__all__ = [
    "GANState",
    "NetState",
    "adam_like_torch",
    "global_grad_norm",
    "train_classifier",
    "make_countergan_step",
    "make_epoch_runner",
]
