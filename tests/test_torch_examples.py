"""The port's bring-your-own-data examples, `examples/torch_custom_images.py`
and `examples/torch_custom_tabular.py`, on the CPU: their datasets bit for
bit against the JAX examples' (`examples/custom_images.py`,
`examples/custom_tabular.py`, which import JAX only inside `main`), and
each `main(device="cpu", ...)` run to its end at cut epochs with its own
checks (the images example: accuracy over 0.9, mean flip rate over 0.7,
no edit outside the allowed patches; the tabular one: only the allowed
features changed).  Both run whole at their shipped sizes in the card
smoke's `examples` phase.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("port,jax,make", [
    ("torch_custom_images", "custom_images", "make_shape_dataset"),
    ("torch_custom_tabular", "custom_tabular", "make_credit_dataset")])
def test_example_dataset_is_the_jax_examples(port, jax, make):
    got, want = (getattr(_load(name), make)() for name in (port, jax))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_images_example_runs_on_the_cpu(capsys):
    out = _load("torch_custom_images").main(device="cpu", clf_epochs=2,
                                            epochs=3)
    assert out["accuracy"] > 0.9 and out["mean_flip_rate"] > 0.7
    assert len(out["class_flip_rate"]) == 3
    assert out["max_edit_outside_mask"] == 0.0
    assert "custom-images example OK" in capsys.readouterr().out


def test_tabular_example_runs_on_the_cpu(capsys):
    module = _load("torch_custom_tabular")
    out = module.main(device="cpu", clf_epochs=5, epochs=4)
    assert set(out["changed"]) <= set(module.ALLOWED) and out["changed"]
    assert len(out["class_flip_rate"]) == 3
    assert 0.0 <= out["accuracy"] <= 1.0
    assert "mask respected" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_custom_images",
                                  "torch_custom_tabular"])
def test_examples_default_to_the_card(name, monkeypatch):
    """Without a device the examples run on the CUDA card, and raise where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main()
