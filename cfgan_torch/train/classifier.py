"""Classifier pretraining, CounteRGAN stage 1 (mirrors
`cfgan/train/classifier.py`): Adam, or AdamW with `weight_decay` (the
house experiment's), and cross-entropy.  Two regimes:

- epochs (MNIST, house): shuffled minibatches, optional class weights, a
  ReduceLROnPlateau-style scale, early stopping, and the best
  validation-accuracy snapshot;
- full batch (`ClassifierConfig.steps`, the moons experiment's): that
  many steps on the whole training set, and the final state.

Each epoch's permutation and dropout draws come from generators seeded
statelessly from (seed, epoch).  The steps run eagerly; the small
classifier's epoch is not captured as a CUDA graph.
`plot_classifier_curves` draws the history.
"""
from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfgan_torch.core.config import ClassifierConfig
from cfgan_torch.core.device import resolve_device
from cfgan_torch.data.pipeline import epoch_perm, stream_seed
from cfgan_torch.eval.figure import Figure
from cfgan_torch.train.state import NetState

PLATEAU_EPOCHS = 10  # epochs without a better accuracy before lr x 0.1


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy; with class weights torch's weighted mean,
    sum(w_i l_i) / sum(w_i)."""
    losses = F.cross_entropy(logits, labels, reduction="none")
    if class_weights is not None:
        w = class_weights[labels]
        return (w * losses).sum() / w.sum()
    return losses.mean()


def make_classifier_step(ns: NetState,
                         class_weights: torch.Tensor | None = None
                         ) -> Callable:
    """`step(x, y, generator=None, keep=None, lr_scale=1.0) -> loss`: one
    train-mode update of `ns` in place.  Dropout masks come from `keep`
    (the classifier's `(channel mask, unit mask)`) or `generator`.
    `lr_scale` scales the learning rate, which for Adam and AdamW scales
    the update (the JAX package scales the update)."""
    base_lrs = [g["lr"] for g in ns.opt.param_groups]

    def step(x, y, generator=None, keep=None, lr_scale: float = 1.0):
        for group, lr in zip(ns.opt.param_groups, base_lrs):
            group["lr"] = lr * lr_scale
        ns.model.train()
        # a model without dropout (the moons MLP) takes x alone
        drop = () if generator is None and keep is None else (generator,
                                                              keep)
        loss = ce_loss(ns.model(x, *drop), y, class_weights)
        ns.opt.zero_grad(set_to_none=True)
        loss.backward()
        ns.opt.step()
        return loss.detach()

    return step


def make_eval_fn(model: nn.Module) -> tuple[Callable, Callable]:
    """(logits_fn, accuracy): eval-mode logits, and the accuracy over
    (x, y) in batches of 4096 on the model's device."""

    def logits_fn(x):
        model.eval()
        with torch.no_grad():
            return model(x)

    def accuracy(x, y, batch: int = 4096) -> float:
        dev = next(model.parameters()).device
        correct = 0
        for lo in range(0, len(y), batch):
            xb = torch.as_tensor(x[lo:lo + batch]).to(dev)
            yb = torch.as_tensor(y[lo:lo + batch]).to(dev)
            correct += int((logits_fn(xb).argmax(1) == yb).sum())
        return correct / len(y)

    return logits_fn, accuracy


def train_classifier(model: nn.Module, cfg: ClassifierConfig, train_set,
                     valid_set=None, *, seed: int = 42,
                     num_classes: int | None = None,
                     log: Callable[[str], None] = print,
                     device: str | torch.device | None = None):
    """Returns (best NetState, history).  `model` holds its initial
    weights; it is moved to `device` (None: the CUDA card) and trained in
    place, and the returned state holds a copy of the model at the best
    validation accuracy (the last epoch without a validation set).  With
    `cfg.steps` it takes that many full-batch steps and returns the final
    state, `history["loss"]` holding each step's loss."""
    dev = resolve_device(device)
    x_train = torch.as_tensor(train_set[0]).to(dev)
    y_train = torch.as_tensor(train_set[1]).to(dev, torch.long)
    model.to(dev)
    class_weights = None
    if cfg.class_weighted and num_classes:
        # sklearn compute_class_weight("balanced"): n / (k * bincount)
        counts = np.bincount(y_train.cpu().numpy(), minlength=num_classes)
        class_weights = torch.tensor(len(y_train) / (num_classes * counts),
                                     dtype=torch.float32, device=dev)
    ns = NetState.create(model, cfg.lr, cfg.weight_decay)
    step = make_classifier_step(ns, class_weights)
    _, accuracy = make_eval_fn(model)
    history = {"val_acc": [], "loss": []}
    if cfg.steps is not None:
        losses = [step(x_train, y_train) for _ in range(cfg.steps)]
        history["loss"] = torch.stack(losses).tolist() if losses else []
        model.eval()
        return ns, history
    n, bs = len(y_train), min(cfg.batch_size, len(y_train))
    has_valid = valid_set is not None and valid_set[0] is not None

    best_acc, best = -1.0, None
    lr_scale = 1.0
    plateau_wait = stop_wait = 0
    for epoch in range(cfg.epochs):
        perm = epoch_perm(torch.Generator(device=dev).manual_seed(
            stream_seed(seed, 2 * epoch)), n, bs)
        drop = torch.Generator(device=dev).manual_seed(
            stream_seed(seed, 2 * epoch + 1))
        losses = [step(x_train.index_select(0, idx),
                       y_train.index_select(0, idx), drop,
                       lr_scale=lr_scale) for idx in perm]
        mean_loss = float(torch.stack(losses).mean())
        history["loss"].append(mean_loss)
        if not has_valid:
            log(f"[Classifier] Epoch {epoch+1}/{cfg.epochs} | loss "
                f"{mean_loss:.4f}")
            best = None
            continue
        acc = accuracy(valid_set[0], valid_set[1])
        history["val_acc"].append(acc)
        log(f"[Classifier] Epoch {epoch+1}/{cfg.epochs} | loss "
            f"{mean_loss:.4f} | Val Acc: {acc:.4f}")
        if acc > best_acc:
            best_acc, best = acc, copy.deepcopy(model)
            plateau_wait = stop_wait = 0
        else:
            plateau_wait += 1
            stop_wait += 1
            if cfg.lr_plateau and plateau_wait >= PLATEAU_EPOCHS:
                lr_scale *= 0.1
                plateau_wait = 0
                log(f"[Classifier] plateau: lr scale -> {lr_scale:g}")
            if (cfg.early_stop_patience
                    and stop_wait >= cfg.early_stop_patience):
                log(f"[Classifier] early stop at epoch {epoch+1}")
                break
    if best is not None:
        model.load_state_dict(best.state_dict())
    model.eval()
    return ns, history


def plot_classifier_curves(history: dict, path: str) -> str:
    """The train loss and, where the history has them, the validation
    accuracies at `path` (`house trainer.py:157-176`)."""
    fig = Figure(figsize=(10, 4), dpi=120)
    loss_ax, acc_ax = fig.subplots(1, 2)[0]
    loss_ax.plot(history.get("loss", []))
    loss_ax.set_title("train loss")
    loss_ax.set_xlabel("epoch")
    if history.get("val_acc"):
        acc_ax.plot(history["val_acc"])
        acc_ax.set_title("validation accuracy")
        acc_ax.set_xlabel("epoch")
    return fig.save(path)
