"""Datasets by `DataConfig.name` (mirrors `cfgan/data/registry.py`)."""
from __future__ import annotations

from cfgan_torch.core.config import DataConfig


def load_dataset(cfg: DataConfig, limit: int | None = None) -> dict:
    """A dict whose keys depend on the dataset:

    moons:    train=(x, y) test=(x, y) stats num_classes
    moons2:   train=(x, y) num_classes
    mnist:    train valid test (NHWC in [-1, 1]; valid (None, None) when
              `cfg.valid_fraction` is 0) num_classes
    kc_house: train test stats bins schema num_classes

    `limit` keeps the first `limit` training rows (MNIST: as
    `load_mnist`'s `limit`, before the split)."""
    if cfg.name == "moons":
        from cfgan_torch.data.moons import load_moons3

        (xtr, ytr), (xte, yte), stats = load_moons3(
            seed=cfg.seed, test_fraction=cfg.test_fraction)
        if limit:
            xtr, ytr = xtr[:limit], ytr[:limit]
        return {"train": (xtr, ytr), "test": (xte, yte), "stats": stats,
                "num_classes": 3}
    if cfg.name == "moons2":
        from cfgan_torch.data.moons import load_moons2

        x, y = load_moons2(seed=cfg.seed)
        if limit:
            x, y = x[:limit], y[:limit]
        return {"train": (x, y), "num_classes": 2}
    if cfg.name == "mnist":
        from cfgan_torch.data.mnist import load_mnist

        train, valid, test = load_mnist(path=cfg.path, seed=cfg.seed,
                                        valid_fraction=cfg.valid_fraction,
                                        limit=limit)
        return {"train": train, "valid": valid, "test": test,
                "num_classes": 10}
    if cfg.name == "kc_house":
        from cfgan_torch.data.kc_house import load_kc_house

        train, test, stats, bins, schema = load_kc_house(
            path=cfg.path, seed=cfg.seed, test_fraction=cfg.test_fraction)
        if limit:
            train = (train[0][:limit], train[1][:limit])
        return {"train": train, "test": test, "stats": stats, "bins": bins,
                "schema": schema, "num_classes": 4}
    raise KeyError(f"unknown dataset {cfg.name!r}")
