"""The port's import surface and its last public helpers against the JAX
package, on the CPU: each subpackage binds the names its JAX counterpart's
`__init__` binds; `countergan_g_terms` (each term and the gradients),
`global_grad_norm` and `g_eval_variables` against JAX's; every `python -m`
entry point of the port starts with RuntimeWarnings as errors; and the
subpackages import no JAX.  No JAX step is compiled here."""
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.losses.countergan import countergan_g_terms as jax_g_terms
from cfgan.train.state import GANState as JaxGANState
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import g_eval_variables as jax_g_eval_variables
from cfgan.train.state import global_grad_norm as jax_global_grad_norm
from cfgan_torch.convert import flax_from_state_dict, train_state_to_flax
from cfgan_torch.core.config import CounterGANConfig, MaskConfig
from cfgan_torch.losses import CounterGANTerms, countergan_g_terms
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.train import global_grad_norm
from cfgan_torch.train.builders import build_mnist_countergan
from cfgan_torch.train.state import g_eval_variables

ROOT = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("core", "data", "eval", "experiments", "losses", "masks",
               "models", "nn", "ops", "parallel", "serve", "train")
# what the port leaves out on purpose: nothing
LEFT_OUT: dict[str, set[str]] = {}
TOL = 3e-5


def _jax_bound_names(mod) -> set[str]:
    """The names `mod`'s `__init__` exports: its `__all__`, else the public
    attributes it binds that are not modules."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and not isinstance(v, types.ModuleType)]
    return set(names)


def _home(pkg, name: str, obj) -> str:
    """The module that defines `obj`: its `__module__`, or for data such as
    a dict of presets the port module (other than `pkg`) that binds it."""
    home = getattr(obj, "__module__", None)
    if home is not None:
        return home
    return next(m for m, mod in sorted(sys.modules.items())
                if m.startswith("cfgan_torch.") and mod is not pkg
                and getattr(mod, name, None) is obj)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_binds_the_jax_names(sub):
    """`cfgan_torch.<sub>` binds every name `cfgan.<sub>` binds (less what
    the port leaves out on purpose), each defined in a module of the port,
    and keeps an `__all__` where JAX has one, every name of it bound."""
    jmod = importlib.import_module(f"cfgan.{sub}")
    pmod = importlib.import_module(f"cfgan_torch.{sub}")
    want = _jax_bound_names(jmod) - LEFT_OUT.get(sub, set())
    assert want
    missing = sorted(n for n in want if not hasattr(pmod, n))
    assert not missing, missing
    for name in sorted(want):
        home = _home(pmod, name, getattr(pmod, name))
        assert home.startswith("cfgan_torch."), (name, home)
    if hasattr(jmod, "__all__"):
        assert want <= set(pmod.__all__)
        for name in pmod.__all__:
            assert hasattr(pmod, name), name


def test_the_named_imports_work():
    from cfgan_torch import __version__
    from cfgan_torch.models import ImageResidualGenerator
    from cfgan_torch.train import make_epoch_runner
    from cfgan_torch.train.loop import make_epoch_runner as loop_runner

    import cfgan

    assert __version__ == cfgan.__version__
    assert ImageResidualGenerator.__module__ == "cfgan_torch.models.generators"
    assert make_epoch_runner is loop_runner


# ----------------------------------------------------- countergan_g_terms
LAMBDAS = {"default": {},
           "other": dict(lambda_adv=0.7, lambda_cls=1.5, lambda_reg_l1=2.5,
                         lambda_mask=3.0)}


def _terms_inputs(seed: int = 0):
    """(8, 28, 28, 1) residuals, 10 classes, a mask of 7-px patches (each
    of the 16 patches modifiable with probability 1/2)."""
    rng = np.random.RandomState(seed)
    raw = rng.normal(0, 0.5, (8, 28, 28, 1)).astype(np.float32)
    patches = (rng.uniform(size=(8, 4, 4)) < 0.5).astype(np.float32)
    mask = np.repeat(np.repeat(patches, 7, 1), 7, 2)[..., None]
    return {"adv": np.float32(rng.normal()),
            "logits": rng.normal(0, 2, (8, 10)).astype(np.float32),
            "target": rng.randint(0, 10, 8).astype(np.int32),
            "raw": raw, "mask": mask}


def _kwargs(reduction, l2, lambdas):
    return dict(reg_reduction=reduction, lambda_reg_l2=l2,
                **LAMBDAS[lambdas])


CASES = [(r, l2, lam) for r in ("per_sample_norm", "mean_abs")
         for l2 in (0.0, 0.5) for lam in LAMBDAS]


@pytest.mark.parametrize("reduction,l2,lambdas", CASES)
def test_countergan_g_terms_match_jax(reduction, l2, lambdas):
    """Each of the six fields against JAX's, relative and absolute 3e-5;
    `reg_l2` a 0-d zero where `lambda_reg_l2` is 0."""
    d = _terms_inputs()
    kw = _kwargs(reduction, l2, lambdas)
    want = jax_g_terms(jnp.asarray(d["adv"]), jnp.asarray(d["logits"]),
                       jnp.asarray(d["target"]),
                       jnp.asarray(d["raw"] * d["mask"]),
                       jnp.asarray(d["raw"]), jnp.asarray(d["mask"]), **kw)
    raw, mask = torch.from_numpy(d["raw"]), torch.from_numpy(d["mask"])
    got = countergan_g_terms(torch.tensor(d["adv"]),
                             torch.from_numpy(d["logits"]),
                             torch.from_numpy(d["target"]).long(),
                             raw * mask, raw, mask, **kw)
    assert isinstance(got, CounterGANTerms)
    for field in CounterGANTerms._fields:
        g = getattr(got, field)
        assert g.shape == () and g.dtype == torch.float32, field
        np.testing.assert_allclose(g.item(), float(getattr(want, field)),
                                   rtol=TOL, atol=TOL, err_msg=field)
    if not l2:
        assert got.reg_l2.item() == 0.0


@pytest.mark.parametrize("reduction,l2,lambdas", CASES)
def test_countergan_g_terms_gradient_matches_jax(reduction, l2, lambdas):
    """d total / d raw_residual (through both the masked and the raw
    residual) and d total / d logits against `jax.grad`, within 3e-5."""
    d = _terms_inputs(1)
    kw = _kwargs(reduction, l2, lambdas)
    mask_j = jnp.asarray(d["mask"])

    def total(raw, logits):
        return jax_g_terms(jnp.asarray(d["adv"]), logits,
                           jnp.asarray(d["target"]), raw * mask_j, raw,
                           mask_j, **kw).total

    want_raw, want_logits = jax.grad(total, argnums=(0, 1))(
        jnp.asarray(d["raw"]), jnp.asarray(d["logits"]))
    raw = torch.from_numpy(d["raw"]).requires_grad_()
    logits = torch.from_numpy(d["logits"]).requires_grad_()
    mask = torch.from_numpy(d["mask"])
    countergan_g_terms(torch.tensor(d["adv"]), logits,
                       torch.from_numpy(d["target"]).long(), raw * mask,
                       raw, mask, **kw).total.backward()
    np.testing.assert_allclose(raw.grad.numpy(), np.asarray(want_raw),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(want_logits),
                               rtol=0, atol=TOL)


# ------------------------------------------------------- global_grad_norm
def test_global_grad_norm_matches_jax():
    """A nested dict / list / tuple of float32 arrays (with a None leaf,
    an empty node in both) against JAX's, relative 3e-5; a 0-d float32."""
    rng = np.random.RandomState(2)
    tree = {"conv": {"kernel": rng.normal(size=(3, 3, 4, 8)),
                     "bias": rng.normal(size=(8,))},
            "blocks": [rng.normal(size=(5, 7)), (rng.normal(size=(2,)),
                                                 None)],
            "scale": rng.normal(size=())}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    want = float(jax_global_grad_norm(tree))
    got = global_grad_norm(jax.tree_util.tree_map(torch.from_numpy, tree))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=TOL, atol=0)


def test_global_grad_norm_of_a_nets_grads():
    """The norm of a network's `.grad`s is the norm of their
    concatenation, taken in float64 (torch's float32 `vector_norm` of
    1.7M elements is itself 2e-5 off on the CPU), within 1e-6; an empty
    tree gives 0."""
    net = CNNClassifier(generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn((4, 28, 28, 1), generator=torch.Generator().manual_seed(1))
    net(x).square().sum().backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    np.testing.assert_allclose(global_grad_norm(grads).item(),
                               torch.linalg.vector_norm(
                                   flat, dtype=torch.float64).item(),
                               rtol=1e-6, atol=0)
    assert global_grad_norm({"a": [], "b": None}).item() == 0.0


# ------------------------------------------------------- g_eval_variables
B = 16


def _bundle(ema_decay: float):
    """A width-8 MNIST bundle after one step (so the EMA is not the live
    parameters)."""
    cfg = CounterGANConfig(hidden_dim=8, num_res_blocks=1, ema_decay=ema_decay,
                           mask=MaskConfig(kind="patch", patch_size=7,
                                           num_modifiable_patches=10))
    clf = CNNClassifier(generator=torch.Generator().manual_seed(2))
    b = build_mnist_countergan(cfg, clf.state_dict(), seed=3, device="cpu")
    _step(b, 0)
    return b


def _step(b, i: int) -> None:
    rng = np.random.RandomState(10 + i)
    x = torch.from_numpy(rng.uniform(-1, 1, (B, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.randint(0, 10, B)).long()
    b.step_fn(b.state, x, y, torch.Generator().manual_seed(i))


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no_ema"])
def test_g_eval_variables_match_jax(ema):
    """The port's variables in the flax layout equal JAX's
    `g_eval_variables` of the same state (converted with
    `train_state_to_flax`); they are copies, which a further step leaves
    as they were."""
    b = _bundle(0.999 if ema else 0.0)
    tree = train_state_to_flax(b.state)
    jstate = JaxGANState(
        g=JaxNetState(params=tree["g"]["params"], stats=tree["g"]["stats"],
                      opt_state=None),
        d=JaxNetState(params=tree["d"]["params"], stats=tree["d"]["stats"],
                      opt_state=None),
        step=tree["step"], g_ema=tree["g_ema"])
    want = jax_g_eval_variables(jstate)
    g = b.state.g.model
    got = g_eval_variables(b.state)
    assert list(got) == list(g.state_dict())
    _tree_equal(flax_from_state_dict(g, got), dict(want))
    live = dict(g.named_parameters())
    if ema:
        assert any(not torch.equal(got[k], live[k]) for k in live)
    held = {k: v.clone() for k, v in got.items()}
    _step(b, 1)
    moved = {**g.state_dict(), **(b.state.g_ema or {})}
    for k, v in got.items():
        assert torch.equal(v, held[k]), k
        assert v.data_ptr() != moved[k].data_ptr(), k
    assert any(not torch.equal(held[k], moved[k]) for k in held)


def test_g_serving_variables_without_ema_are_g_eval_variables():
    from cfgan_torch.train.builders import g_serving_variables

    b = _bundle(0.0)
    got = g_serving_variables(b, b.state, None, None)
    want = g_eval_variables(b.state)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------- entry points and imports
ENTRY_POINTS = ("cfgan_torch", "cfgan_torch.experiments.mnist_countergan",
                "cfgan_torch.experiments.mnist_countergan2",
                "cfgan_torch.experiments.house_countergan",
                "cfgan_torch.experiments.moons_countergan",
                "cfgan_torch.experiments.generation",
                "cfgan_torch.serve.launch")
IMPORT_ALL = f"""
import importlib, json, sys
for sub in {SUBPACKAGES!r}:
    importlib.import_module("cfgan_torch." + sub)
import cfgan_torch.ops._build as build
print(json.dumps({{
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                             "cfgan", "gradio")),
    "built": build._library is not None}}))
"""


@pytest.fixture(scope="module")
def subprocesses():
    """Every entry point's `--help` and the import check, started together
    (each is a fresh interpreter importing torch)."""
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "1"}
    cmds = {m: [sys.executable, "-W", "error::RuntimeWarning", "-m", m,
                "--help"] for m in ENTRY_POINTS}
    cmds["import"] = [sys.executable, "-c", IMPORT_ALL]
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        out[k] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_runs_without_runtime_warnings(subprocesses, module):
    """`python -W error::RuntimeWarning -m <module> --help` exits 0: no
    package `__init__` imports the module before runpy runs it."""
    rc, stdout, stderr = subprocesses[module]
    assert rc == 0, stderr[-2000:]
    assert stdout.strip()
    assert "found in sys.modules" not in stderr


def test_subpackages_import_no_jax(subprocesses):
    """A fresh interpreter imports all twelve subpackages without JAX,
    flax, the JAX package or gradio, and builds no CUDA library."""
    rc, stdout, stderr = subprocesses["import"]
    assert rc == 0, stderr[-2000:]
    facts = json.loads(stdout.strip().splitlines()[-1])
    assert facts == {"foreign": [], "built": False}
