"""The frozen MNIST classifier (mirrors
`cfgan/models/classifiers.py::CNNClassifier`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cfgan_torch.nn.layers import Conv, Dropout, Linear


class CNNClassifier(nn.Module):
    """Conv(1->32 s1) / Conv(32->64 s2) / Conv(64->128 s2) + ReLU +
    channel Dropout(.25), FC 128*7*7 -> 256 -> 10 with Dropout(.5).
    Input NHWC, one channel.  The flatten is in NHWC order, as in the JAX
    package, so the FC weight carries over without a permutation.
    Submodules are named as in the flax tree (`Conv_0`, ..., `Linear_1`).
    """

    def __init__(self, num_classes: int = 10,
                 image_hw: tuple[int, int] = (28, 28),
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.Conv_0 = Conv(1, 32, 3, 1, 1, generator=g)
        self.Conv_1 = Conv(32, 64, 3, 2, 1, generator=g)
        self.Conv_2 = Conv(64, 128, 3, 2, 1, generator=g)
        self.drop2d = Dropout(0.25, channelwise=True)
        h, w = image_hw
        for _ in range(2):  # two stride-2, pad-1 convs
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        self.Linear_0 = Linear(128 * h * w, 256, generator=g)
        self.drop = Dropout(0.5)
        self.Linear_1 = Linear(256, num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Conv_0(x))
        h = F.relu(self.Conv_1(h))
        h = F.relu(self.Conv_2(h))
        h = self.drop2d(h).reshape(h.shape[0], -1)
        h = self.drop(F.relu(self.Linear_0(h)))
        return self.Linear_1(h)
