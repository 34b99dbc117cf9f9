"""The frozen classifiers (mirrors `cfgan/models/classifiers.py`):
`MLPClassifier` (2-D moons), `CNNClassifier` (MNIST),
`LegacyCNNClassifier` (the legacy MNIST stack's) and `TabularClassifier`
(King County house)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cfgan_torch.nn.layers import (
    BatchNorm,
    Conv,
    Dropout,
    Linear,
    leaky_relu,
    max_pool2d,
)


class MLPClassifier(nn.Module):
    """input_dim -> h -> h -> num_classes with ReLU (2 -> h -> h -> 3 on
    moons, `moons/models/nn_classifier.py:3-15`).  Submodules are named as
    in the flax tree (`Linear_0`..`Linear_2`)."""

    def __init__(self, num_classes: int = 3, hidden_dim: int = 32,
                 input_dim: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Linear_0 = Linear(input_dim, hidden_dim, generator)
        self.Linear_1 = Linear(hidden_dim, hidden_dim, generator)
        self.Linear_2 = Linear(hidden_dim, num_classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Linear_0(x))
        return self.Linear_2(F.relu(self.Linear_1(h)))


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

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
        """In train mode the two dropouts take their keep masks from
        `keep` (channel mask, unit mask) where given, else from
        `generator` (see `Dropout`)."""
        k2d, k = keep if keep is not None else (None, None)
        h = F.relu(self.Conv_0(x))
        h = F.relu(self.Conv_1(h))
        h = F.relu(self.Conv_2(h))
        h = self.drop2d(h, generator, k2d).reshape(h.shape[0], -1)
        h = self.drop(F.relu(self.Linear_0(h)), generator, k)
        return self.Linear_1(h)


class LegacyCNNClassifier(nn.Module):
    """The legacy MaxPool CNN (`cfgan.models.classifiers.
    LegacyCNNClassifier`, `mnist/modules/classifier.py:4-30`): Conv(1->32,
    pad 1), ReLU, 2x2 max pool; Conv(32->64, pad 1), ReLU, 2x2 max pool;
    FC 64*7*7 -> 128, ReLU; FC 128 -> 10.  Input NHWC, the flatten in NHWC
    order as `CNNClassifier`'s.  No dropout: `forward` accepts the
    `generator` and `keep` that `train_classifier` passes and ignores
    them.  Submodules are named as in the flax tree (`Conv_0`, `Conv_1`,
    `Linear_0`, `Linear_1`)."""

    def __init__(self, num_classes: int = 10,
                 image_hw: tuple[int, int] = (28, 28),
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.Conv_0 = Conv(1, 32, 3, 1, 1, generator=g)
        self.Conv_1 = Conv(32, 64, 3, 1, 1, generator=g)
        h, w = image_hw
        for _ in range(2):  # two floor-sized 2x2 pools
            h, w = h // 2, w // 2
        self.Linear_0 = Linear(64 * h * w, 128, generator=g)
        self.Linear_1 = Linear(128, num_classes, generator=g)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep=None) -> torch.Tensor:
        h = max_pool2d(F.relu(self.Conv_0(x)))
        h = max_pool2d(F.relu(self.Conv_1(h)))
        h = F.relu(self.Linear_0(h.reshape(h.shape[0], -1)))
        return self.Linear_1(h)


class TabularClassifier(nn.Module):
    """17 -> 256 -> 256 -> 128 -> 64 -> 4: each hidden layer Linear ->
    LeakyReLU(0.1) -> BatchNorm -> Dropout(.3 / .2 / .1 / none), the torch
    order (`cfgan.models.classifiers.TabularClassifier`).  Submodules are
    named as in the flax tree (`Linear_0`.., `BatchNorm_0`..)."""

    WIDTHS = ((256, 0.3), (256, 0.2), (128, 0.1), (64, None))

    def __init__(self, num_classes: int = 4, input_dim: int = 17,
                 generator: torch.Generator | None = None):
        super().__init__()
        cin = input_dim
        for i, (width, drop) in enumerate(self.WIDTHS):
            self.add_module(f"Linear_{i}", Linear(cin, width, generator))
            self.add_module(f"BatchNorm_{i}", BatchNorm(width))
            if drop is not None:
                self.add_module(f"drop{i}", Dropout(drop))
            cin = width
        self.add_module(f"Linear_{len(self.WIDTHS)}",
                        Linear(cin, num_classes, generator))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep: tuple[torch.Tensor, ...] | None = None) -> torch.Tensor:
        """In train mode the three dropouts take their keep masks from
        `keep` where given, else from `generator` (see `Dropout`)."""
        for i, (_, drop) in enumerate(self.WIDTHS):
            x = getattr(self, f"BatchNorm_{i}")(
                leaky_relu(getattr(self, f"Linear_{i}")(x), 0.1))
            if drop is not None:
                x = getattr(self, f"drop{i}")(
                    x, generator, None if keep is None else keep[i])
        return getattr(self, f"Linear_{len(self.WIDTHS)}")(x)
