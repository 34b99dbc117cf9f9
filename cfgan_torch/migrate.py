"""Import the PyTorch reference's trained checkpoints into the port
(mirrors `cfgan/migrate.py`).

The reference (`flash4242/Promptable-Counterfactual-GAN`) saves its
trained models as `state_dict` files: `house_sales_kc_usa/
{generator_model,clf_model}.pt`, `mnist/results/generator.pt`,
`mnist/models/classifier.pt`, `moons/results/{generator,classifier}.pt`.
Each importer here reads one and returns the state dict of the port's
module of that family, built at the widths the file's shapes give, which
`module.load_state_dict(sd, strict=True)` takes.

The route is the JAX package's: numpy copies of its layout rules build
the flax variable tree (a Linear's (out, in) weight transposed to an
(in, out) kernel, a conv's OIHW weight to HWIO under the flax `Conv_0`
scope, BatchNorm weight / bias / running statistics to scale / bias /
mean / var, the first Linear after a torch NCHW flatten with its input
columns permuted to the NHWC flatten order), and
`cfgan_torch.convert.state_dict_from_flax` carries that tree into the
port's layout, as it carries the JAX package's own variables.  A conv
imported at the cuDNN route's OIHW `weight` loads into a layer routed to
the conv kernel too (`Conv` converts its layout on load).

Safety: `torch.load(weights_only=True)` only, so a checkpoint's tensors
are read and no pickled code runs.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from cfgan_torch.convert import state_dict_from_flax
from cfgan_torch.models.classifiers import (
    LegacyCNNClassifier,
    MLPClassifier,
    TabularClassifier,
)
from cfgan_torch.models.generators import (
    ImageResidualGenerator,
    MoonsResidualGenerator,
    TabularResidualGenerator,
)

__all__ = [
    "load_state_dict",
    "import_house_generator",
    "import_house_classifier",
    "import_moons_generator",
    "import_moons_classifier",
    "import_mnist_generator",
    "import_mnist_legacy_classifier",
    "validate_against",
]


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """`torch.load(weights_only=True)` of `path` on the CPU -> {key:
    float32 array}, tensors only."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(v.detach().numpy(), np.float32)
            for k, v in sd.items() if hasattr(v, "numpy")}


# ------------------------------------------------------------ converters
def _lin(sd, k):
    return {"kernel": sd[f"{k}.weight"].T.copy(), "bias": sd[f"{k}.bias"]}


def _conv(sd, k):
    # torch (O, I, kh, kw) -> flax (kh, kw, I, O), nested as flax's Conv
    # wrapper nests it, under "Conv_0"
    return {"Conv_0": {
        "kernel": np.transpose(sd[f"{k}.weight"], (2, 3, 1, 0)).copy(),
        "bias": sd[f"{k}.bias"],
    }}


def _bn_params(sd, k):
    return {"scale": sd[f"{k}.weight"], "bias": sd[f"{k}.bias"]}


def _bn_stats(sd, k):
    return {"mean": sd[f"{k}.running_mean"], "var": sd[f"{k}.running_var"]}


def _lin_after_nchw_flatten(sd, k, chw: tuple[int, int, int]):
    """The first Linear after a torch NCHW flatten: its input columns
    permuted to the NHWC flatten order."""
    c, h, w = chw
    wt = sd[f"{k}.weight"]  # (out, C*H*W) in (C,H,W) column order
    wt = wt.reshape(wt.shape[0], c, h, w).transpose(0, 2, 3, 1)
    wt = wt.reshape(wt.shape[0], h * w * c)
    return {"kernel": wt.T.copy(), "bias": sd[f"{k}.bias"]}


def _fixed_init() -> torch.Generator:
    """A module built only to take imported weights draws its throw-away
    initial weights here, not from torch's global generator."""
    return torch.Generator().manual_seed(0)


# ------------------------------------------------------------- house
def import_house_generator(path: str, n_blocks: int = 5,
                           cat_indices=(0, 1, 4, 5, 6, 7, 8)
                           ) -> dict[str, torch.Tensor]:
    """`house_sales_kc_usa/generator_model.pt` (the FiLM residual
    generator) -> the state dict of a `TabularResidualGenerator` of the
    file's widths, `n_blocks` FiLM blocks and a head for each of
    `cat_indices` (the house schema's categorical features)."""
    sd = load_state_dict(path)
    params = {"fc_in": _lin(sd, "fc_in"), "fc_cont": _lin(sd, "fc_cont")}
    stats = {}
    for i in range(n_blocks):
        t = f"blocks.{i}"
        params[f"block{i}"] = {
            "fc1": _lin(sd, f"{t}.fc1"),
            "fc2": _lin(sd, f"{t}.fc2"),
            "bn1": _bn_params(sd, f"{t}.bn1"),
            "bn2": _bn_params(sd, f"{t}.bn2"),
            "film": {"gamma": _lin(sd, f"{t}.film.gamma"),
                     "beta": _lin(sd, f"{t}.film.beta")},
        }
        stats[f"block{i}"] = {"bn1": _bn_stats(sd, f"{t}.bn1"),
                              "bn2": _bn_stats(sd, f"{t}.bn2")}
    for idx in cat_indices:
        params[f"fc_cat_{idx}"] = _lin(sd, f"fc_cat_logits.{idx}")
    n_in, hidden = params["fc_in"]["kernel"].shape
    cond_dim = params["block0"]["film"]["gamma"]["kernel"].shape[0]
    dim = n_in - cond_dim  # D + (C + D) inputs, C + D conditions
    module = TabularResidualGenerator(
        dim, hidden, cond_dim - dim,
        continuous_idx=[i for i in range(dim) if i not in cat_indices],
        categorical_info={i: (0.0,) * params[f"fc_cat_{i}"]["bias"].shape[0]
                          for i in cat_indices},
        n_blocks=n_blocks, generator=_fixed_init())
    return state_dict_from_flax(module, {"params": params,
                                         "batch_stats": stats})


def import_house_classifier(path: str) -> dict[str, torch.Tensor]:
    """`house_sales_kc_usa/clf_model.pt` (an `nn.Sequential` with Linears
    at net.{0,4,8,12,15} and BatchNorms at net.{2,6,10,14}) -> a
    `TabularClassifier` state dict."""
    sd = load_state_dict(path)
    lin_idx, bn_idx = (0, 4, 8, 12), (2, 6, 10, 14)
    params = {f"Linear_{i}": _lin(sd, f"net.{n}")
              for i, n in enumerate(lin_idx)}
    params["Linear_4"] = _lin(sd, "net.15")
    for i, n in enumerate(bn_idx):
        params[f"BatchNorm_{i}"] = _bn_params(sd, f"net.{n}")
    stats = {f"BatchNorm_{i}": _bn_stats(sd, f"net.{n}")
             for i, n in enumerate(bn_idx)}
    module = TabularClassifier(
        num_classes=params["Linear_4"]["bias"].shape[0],
        input_dim=params["Linear_0"]["kernel"].shape[0],
        generator=_fixed_init())
    return state_dict_from_flax(module, {"params": params,
                                         "batch_stats": stats})


# ------------------------------------------------------------- moons
def import_moons_generator(path: str) -> dict[str, torch.Tensor]:
    """`moons/results/generator.pt` (Linears at net.{0,3,6,9}, BatchNorms
    at net.{1,4,7}) -> a `MoonsResidualGenerator` state dict."""
    sd = load_state_dict(path)
    params = {f"Linear_{i}": _lin(sd, f"net.{n}")
              for i, n in enumerate((0, 3, 6, 9))}
    for i, n in enumerate((1, 4, 7)):
        params[f"BatchNorm_{i}"] = _bn_params(sd, f"net.{n}")
    stats = {f"BatchNorm_{i}": _bn_stats(sd, f"net.{n}")
             for i, n in enumerate((1, 4, 7))}
    n_in, hidden = params["Linear_0"]["kernel"].shape  # 2 D + C
    dim = params["Linear_3"]["bias"].shape[0]
    module = MoonsResidualGenerator(dim, hidden, n_in - 2 * dim,
                                    generator=_fixed_init())
    return state_dict_from_flax(module, {"params": params,
                                         "batch_stats": stats})


def import_moons_classifier(path: str) -> dict[str, torch.Tensor]:
    """`moons/results/classifier.pt` (Linears at net.{0,2,4}) -> an
    `MLPClassifier` state dict."""
    sd = load_state_dict(path)
    params = {f"Linear_{i}": _lin(sd, f"net.{n}")
              for i, n in enumerate((0, 2, 4))}
    n_in, hidden = params["Linear_0"]["kernel"].shape
    module = MLPClassifier(params["Linear_2"]["bias"].shape[0], hidden, n_in,
                           generator=_fixed_init())
    return state_dict_from_flax(module, {"params": params})


# ------------------------------------------------------------- mnist
def import_mnist_generator(path: str, n_resblocks: int = 6
                           ) -> dict[str, torch.Tensor]:
    """`mnist/results/generator.pt` (the residual generator) -> the state
    dict of a square `ImageResidualGenerator` of the file's class count
    and width with `n_resblocks` blocks, its convs in cuDNN's layout.
    conv_in's input channels (x, label plane, mask) are in the same order
    in both, so only the layouts change."""
    sd = load_state_dict(path)
    params = {
        "embed": {"embedding": sd["embed.weight"]},
        "conv_in": _conv(sd, "conv_in"),
        "conv_mid": _conv(sd, "conv_mid"),
        "conv_out": _conv(sd, "conv_out"),
    }
    stats = {}
    for i in range(n_resblocks):
        t = f"resblocks.{i}"
        params[f"res{i}"] = {
            "conv1": _conv(sd, f"{t}.conv1"),
            "conv2": _conv(sd, f"{t}.conv2"),
            "bn1": _bn_params(sd, f"{t}.bn1"),
            "bn2": _bn_params(sd, f"{t}.bn2"),
        }
        stats[f"res{i}"] = {"bn1": _bn_stats(sd, f"{t}.bn1"),
                            "bn2": _bn_stats(sd, f"{t}.bn2")}
    classes, plane = params["embed"]["embedding"].shape
    side = math.isqrt(plane)
    module = ImageResidualGenerator(
        image_hw=(side, side), num_classes=classes,
        base_ch=params["conv_in"]["Conv_0"]["kernel"].shape[-1],
        n_resblocks=n_resblocks, generator=_fixed_init())
    return state_dict_from_flax(module, {"params": params,
                                         "batch_stats": stats})


def import_mnist_legacy_classifier(path: str) -> dict[str, torch.Tensor]:
    """`mnist/models/classifier.pt` (the legacy MaxPool CNN: convs at
    net.{0,3}, Linears at net.{7,9}) -> a `LegacyCNNClassifier` state
    dict.  net.7 follows a torch NCHW flatten of a (64, 7, 7) activation;
    its columns are permuted to the port's NHWC flatten order."""
    sd = load_state_dict(path)
    params = {
        "Conv_0": _conv(sd, "net.0"),
        "Conv_1": _conv(sd, "net.3"),
        "Linear_0": _lin_after_nchw_flatten(sd, "net.7", (64, 7, 7)),
        "Linear_1": _lin(sd, "net.9"),
    }
    module = LegacyCNNClassifier(
        num_classes=params["Linear_1"]["bias"].shape[0],
        generator=_fixed_init())
    return state_dict_from_flax(module, {"params": params})


# ------------------------------------------------------------- validation
def validate_against(imported: dict, module: nn.Module,
                     name: str = "import") -> dict:
    """Check that `imported` has exactly the keys and shapes of
    `module.state_dict()`.  Raises ValueError listing every missing key,
    unexpected key and shape mismatch; returns `imported`."""
    want = module.state_dict()
    errs = []
    for k in sorted(set(imported) | set(want)):
        if k not in imported:
            errs.append(f"missing leaf {k!r}")
        elif k not in want:
            errs.append(f"unexpected leaf {k!r}")
        elif tuple(imported[k].shape) != tuple(want[k].shape):
            errs.append(f"shape mismatch at {k!r}: imported "
                        f"{tuple(imported[k].shape)} vs model "
                        f"{tuple(want[k].shape)}")
    if errs:
        raise ValueError(f"{name}: " + "; ".join(errs))
    return imported
