"""The port's public eval entry points run on the CUDA card unless the
caller passes `device="cpu"`: called without `device` on a host with no
card, each raises `resolve_device`'s RuntimeError before it computes or
writes anything, and the same call with `device="cpu"` runs."""
import os

import numpy as np
import pytest
import torch

from cfgan_torch.data.kc_house import KC_SCHEMA
from cfgan_torch.eval import boundaries, classifier, images, mask_analysis
from cfgan_torch.models.tabular import derive_gumbel_noise, jax_key

HW = (14, 14)


def _cf(g_vars, x, t, mask, key=None):
    raw = 0.1 * torch.ones_like(x)
    return torch.clamp(x + raw * mask, -1, 1), raw, raw * mask


def _clf(x):
    return x.reshape(len(x), -1)[:, :3] * torch.tensor([1.0, -1.0, 0.5])


def _clf2(p):
    """Three classes of 2-D points."""
    return torch.stack([p[:, 0], p[:, 1], 1 - p.sum(1)], 1)


def _calls(out: str) -> dict:
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (6, *HW, 1)).astype(np.float32)
    y = np.arange(6) % 3
    pts = rng.uniform(0, 1, (9, 2)).astype(np.float32)
    rows = rng.uniform(0, 1, (8, KC_SCHEMA.input_dim)).astype(np.float32)
    return {
        "counterfactual_grid": lambda **d: images.counterfactual_grid(
            _cf, _clf, {}, x, y, 3, os.path.join(out, "g.png"), **d),
        "heatmap_panels": lambda **d: images.heatmap_panels(
            _cf, _clf, {}, x, y, (y + 1) % 3, np.ones_like(x),
            os.path.join(out, "h"), **d),
        "user_modification_example": lambda **d: (
            images.user_modification_example(
                _cf, _clf, {}, x[0], 1, [0, 3], 7,
                path=os.path.join(out, "u.png"), **d)),
        "decision_surface": lambda **d: boundaries.decision_surface(
            _clf2, res=8, **d),
        "plot_decision_boundaries_and_cfs": lambda **d: (
            boundaries.plot_decision_boundaries_and_cfs(
                _clf2, _cf, {}, pts, np.arange(9) % 3, 3,
                os.path.join(out, "b"), n_cf_samples=2, **d)),
        "plot_decision_boundaries_only": lambda **d: (
            boundaries.plot_decision_boundaries_only(
                _clf2, pts, np.arange(9) % 3, os.path.join(out, "o.png"),
                **d)),
        "predict_all": lambda **d: classifier.predict_all(_clf2, pts, **d),
        "evaluate_classifier": lambda **d: classifier.evaluate_classifier(
            _clf2, pts, np.arange(9) % 3, out_dir=os.path.join(out, "c"),
            **d),
        "analyze_mask_policies": lambda **d: (
            mask_analysis.analyze_mask_policies(
                _cf, lambda r: r[:, :4], {}, rows, np.arange(8) % 4,
                KC_SCHEMA, 4, jax_key(0), out_dir=os.path.join(out, "m"),
                **d)),
        "patch_budget_curve": lambda **d: mask_analysis.patch_budget_curve(
            _cf, _clf, {}, x, y, 3, 7, out_dir=os.path.join(out, "p"),
            **d),
        "derive_gumbel_noise": lambda **d: derive_gumbel_noise(
            jax_key(0), 4, {0: (1.0, 2.0), 3: (0.0, 1.0, 2.0)}, **d),
    }


FUNCTIONS = sorted(_calls("."))


@pytest.mark.parametrize("name", FUNCTIONS)
def test_without_device_raises_on_a_host_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _calls(str(tmp_path))[name]()
    assert not any(tmp_path.iterdir())  # nothing was drawn or written


@pytest.mark.parametrize("name", FUNCTIONS)
def test_with_device_cpu_runs(name, tmp_path):
    assert _calls(str(tmp_path))[name](device="cpu") is not None
