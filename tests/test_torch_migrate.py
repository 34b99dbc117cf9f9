"""`cfgan_torch.migrate` against `cfgan.migrate` on synthetic checkpoints
in the PyTorch reference's layout.

For each family a torch module of the reference's structure (its
`nn.Sequential` indices, `ModuleList` / `ModuleDict` names and NCHW
layers) is filled with values from a numpy seed (positive running
variances) and saved with `torch.save` under `tmp_path`; both packages'
importers read the file.  JAX's importer raises on a key name the
reference does not use, so the mirrors cannot drift into made-up names.
Held: `flax_from_state_dict` of the port's import equals JAX's import
leaf for leaf, bit for bit; the port's module takes it with
`load_state_dict(strict=True)`; the port's and JAX's models give the
same eval forward within 3e-5 on the same input (the MNIST generator
through the port's plain conv); and the legacy classifier's NCHW->NHWC
column permutation shows in the output: the port equals the reference
mirror's own NCHW forward, which a load without the permutation does
not.  `validate_against` names each missing key, extra key and shape
mismatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cfgan import migrate as jmigrate
from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.models import classifiers as jclf
from cfgan.models import generators as jgen
from cfgan_torch import migrate
from cfgan_torch.convert import flax_from_state_dict
from cfgan_torch.data.kc_house import KC_SCHEMA
from cfgan_torch.models import classifiers as pclf
from cfgan_torch.models import generators as pgen

ATOL = 3e-5
HIDDEN = 8  # the MLP generators' width
CH, BLOCKS = 16, 2  # the MNIST generator's
HOUSE_BLOCKS = 2


# ------------------------------------------- the reference's module layouts
class _RefFiLM(nn.Module):
    def __init__(self, cond, hidden):
        super().__init__()
        self.gamma, self.beta = nn.Linear(cond, hidden), nn.Linear(cond,
                                                                   hidden)


class _RefFiLMBlock(nn.Module):
    def __init__(self, hidden, cond):
        super().__init__()
        self.fc1, self.bn1 = nn.Linear(hidden, hidden), nn.BatchNorm1d(hidden)
        self.film = _RefFiLM(cond, hidden)
        self.fc2, self.bn2 = nn.Linear(hidden, hidden), nn.BatchNorm1d(hidden)


class _RefHouseG(nn.Module):
    """`house models/generator.py`'s parameter layout."""

    def __init__(self):
        super().__init__()
        d, c = KC_SCHEMA.input_dim, 4
        info = KC_SCHEMA.categorical_info
        self.fc_in = nn.Linear(2 * d + c, HIDDEN)
        self.blocks = nn.ModuleList(_RefFiLMBlock(HIDDEN, d + c)
                                    for _ in range(HOUSE_BLOCKS))
        self.fc_cont = nn.Linear(HIDDEN, len(KC_SCHEMA.continuous_idx))
        self.fc_cat_logits = nn.ModuleDict(
            {str(i): nn.Linear(HIDDEN, len(v)) for i, v in info.items()})


class _RefSequential(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)


def _ref_house_clf():
    """`house models/nn_classifier.py`: Linears at net.{0,4,8,12,15},
    BatchNorms at net.{2,6,10,14}."""
    layers, cin = [], KC_SCHEMA.input_dim
    for i, width in enumerate((256, 256, 128, 64)):
        layers += [nn.Linear(cin, width), nn.LeakyReLU(0.1),
                   nn.BatchNorm1d(width)]
        if i < 3:
            layers.append(nn.Dropout(0.1))
        cin = width
    return _RefSequential(*layers, nn.Linear(64, 4))


def _ref_moons_g():
    h = HIDDEN
    return _RefSequential(nn.Linear(7, h), nn.BatchNorm1d(h), nn.ReLU(),
                          nn.Linear(h, h), nn.BatchNorm1d(h), nn.ReLU(),
                          nn.Linear(h, h // 2), nn.BatchNorm1d(h // 2),
                          nn.ReLU(), nn.Linear(h // 2, 2))


def _ref_moons_clf():
    h = HIDDEN
    return _RefSequential(nn.Linear(2, h), nn.ReLU(), nn.Linear(h, h),
                          nn.ReLU(), nn.Linear(h, 3))


class _RefResBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(CH, CH, 3, padding=1), \
            nn.BatchNorm2d(CH)
        self.conv2, self.bn2 = nn.Conv2d(CH, CH, 3, padding=1), \
            nn.BatchNorm2d(CH)


class _RefMnistG(nn.Module):
    """`mnist/models/generator.py`'s parameter layout."""

    def __init__(self):
        super().__init__()
        self.embed = nn.Embedding(10, 784)
        self.conv_in = nn.Conv2d(3, CH, 3, padding=1)
        self.resblocks = nn.ModuleList(_RefResBlock() for _ in range(BLOCKS))
        self.conv_mid = nn.Conv2d(CH, CH, 3, padding=1)
        self.conv_out = nn.Conv2d(CH, 1, 3, padding=1)


def _ref_legacy_clf():
    """`mnist/modules/classifier.py`: convs at net.{0,3}, Linears at
    net.{7,9}, an NCHW flatten before net.7."""
    return _RefSequential(
        nn.Conv2d(1, 32, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2),
        nn.Conv2d(32, 64, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2),
        nn.Flatten(), nn.Linear(64 * 7 * 7, 128), nn.ReLU(),
        nn.Linear(128, 10))


def _save(ref: nn.Module, path, seed: int):
    """`ref`'s state dict with values from a numpy seed at a trained
    model's scales (weights N(0, 1/fan_in), BatchNorm scales and running
    variances in [0.5, 1.5], other vectors N(0, 0.01)) saved at `path`;
    returns the module loaded with them, in eval mode."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in ref.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
            continue
        if k.endswith("running_var") or (
                len(shape) == 1 and k.endswith("weight")):
            a = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    torch.save(sd, path)
    ref.load_state_dict(sd)
    return ref.eval()


# ------------------------------------------------------------- the cases
def _one_hot(t, n):
    return np.eye(n, dtype=np.float32)[t]


def _house_g():
    kw = dict(continuous_idx=KC_SCHEMA.continuous_idx,
              categorical_info=KC_SCHEMA.categorical_info,
              n_blocks=HOUSE_BLOCKS)
    jm = jgen.TabularResidualGenerator(
        input_dim=17, hidden_dim=HIDDEN, num_classes=4,
        continuous_idx=JAX_SCHEMA.continuous_idx,
        categorical_info=JAX_SCHEMA.categorical_info, n_blocks=HOUSE_BLOCKS)
    pm = pgen.TabularResidualGenerator(17, HIDDEN, 4, **kw)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (6, 17)).astype(np.float32)
    t = _one_hot(rng.integers(0, 4, 6), 4)
    m = (rng.uniform(size=(6, 17)) > 0.5).astype(np.float32)
    noise = {i: rng.gumbel(size=(6, len(v))).astype(np.float32)
             for i, v in KC_SCHEMA.categorical_info.items()}

    def jax_fwd(v):
        cont, logits, _ = jm.apply(v, x, t, m, train=False,
                                   gumbel_noise=noise)
        return [cont] + [logits[i] for i in sorted(logits)]

    def port_fwd():
        cont, logits, _ = pm(torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(m),
                             {i: torch.from_numpy(n) for i, n in
                              noise.items()})
        return [cont] + [logits[i] for i in sorted(logits)]

    return _RefHouseG(), {"n_blocks": HOUSE_BLOCKS}, pm, jax_fwd, port_fwd


def _mlp_case(jm, pm, x, *extra):
    def jax_fwd(v):
        out = jm.apply(v, x, *extra, train=False)
        return list(out) if isinstance(out, tuple) else [out]

    def port_fwd():
        out = pm(torch.from_numpy(x), *map(torch.from_numpy, extra))
        return list(out) if isinstance(out, tuple) else [out]
    return jax_fwd, port_fwd


def _house_clf():
    x = np.random.default_rng(1).uniform(0, 1, (6, 17)).astype(np.float32)
    pm = pclf.TabularClassifier()
    return (_ref_house_clf(), {}, pm,
            *_mlp_case(jclf.TabularClassifier(), pm, x))


def _moons_g():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (6, 2)).astype(np.float32)
    t = _one_hot(rng.integers(0, 3, 6), 3)
    m = np.float32([[1, 1], [1, 0], [0, 1], [0, 0], [1, 1], [1, 0]])
    pm = pgen.MoonsResidualGenerator(2, HIDDEN, 3)
    return (_ref_moons_g(), {}, pm,
            *_mlp_case(jgen.MoonsResidualGenerator(hidden_dim=HIDDEN), pm,
                       x, t, m))


def _moons_clf():
    x = np.random.default_rng(3).uniform(0, 1, (6, 2)).astype(np.float32)
    pm = pclf.MLPClassifier(3, HIDDEN, 2)
    return (_ref_moons_clf(), {}, pm,
            *_mlp_case(jclf.MLPClassifier(hidden_dim=HIDDEN), pm, x))


def _mnist_g():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (3, 28, 28, 1)).astype(np.float32)
    t = np.int32([3, 1, 4])
    m = (rng.uniform(size=(3, 28, 28, 1)) > 0.5).astype(np.float32)
    jm = jgen.ImageResidualGenerator(base_ch=CH, n_resblocks=BLOCKS)
    pm = pgen.ImageResidualGenerator(base_ch=CH, n_resblocks=BLOCKS)
    # the forward through the port's plain conv, which the kernel route
    # runs on the CPU
    plain = pgen.ImageResidualGenerator(base_ch=CH, n_resblocks=BLOCKS,
                                        conv_impl="matmul")

    def jax_fwd(v):
        return list(jm.apply(v, x, t, m, train=False))

    def port_fwd():
        plain.load_state_dict(pm.state_dict(), strict=True)
        return list(plain.eval()(torch.from_numpy(x),
                                 torch.from_numpy(t).long(),
                                 torch.from_numpy(m)))

    return _RefMnistG(), {"n_resblocks": BLOCKS}, pm, jax_fwd, port_fwd


def _legacy_clf():
    x = np.random.default_rng(5).uniform(-1, 1, (4, 28, 28, 1)).astype(
        np.float32)
    pm = pclf.LegacyCNNClassifier()
    jm = jclf.LegacyCNNClassifier()

    def jax_fwd(v):
        return [jm.apply(v, x)]

    def port_fwd():
        return [pm(torch.from_numpy(x))]

    return _ref_legacy_clf(), {}, pm, jax_fwd, port_fwd


CASES = {
    "import_house_generator": _house_g,
    "import_house_classifier": _house_clf,
    "import_moons_generator": _moons_g,
    "import_moons_classifier": _moons_clf,
    "import_mnist_generator": _mnist_g,
    "import_mnist_legacy_classifier": _legacy_clf,
}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


@pytest.mark.parametrize("name", CASES)
def test_import_matches_jax_leaf_for_leaf_and_forward(name, tmp_path):
    torch.manual_seed(0)
    ref, kw, module, jax_fwd, port_fwd = CASES[name]()
    path = tmp_path / f"{name}.pt"
    _save(ref, path, seed=len(name))
    sd = getattr(migrate, name)(str(path), **kw)
    want = getattr(jmigrate, name)(str(path), **kw)
    got = flax_from_state_dict(module, sd)
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for k, w in want_leaves.items():
        assert got_leaves[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got_leaves[k], w, err_msg=str(k))
    assert migrate.validate_against(sd, module, name) is sd
    module.load_state_dict(sd, strict=True)
    module.eval()
    with torch.no_grad():
        outs = port_fwd()
    wants = jax_fwd(jax.tree_util.tree_map(jnp.asarray, want))
    assert len(outs) == len(wants)
    for o, w in zip(outs, wants):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_legacy_flatten_permutation_shows_in_the_output(tmp_path):
    """The port's classifier on the import gives the reference's own NCHW
    forward; the same weights without the column permutation do not."""
    torch.manual_seed(0)
    ref = _save(_ref_legacy_clf(), tmp_path / "clf.pt", seed=9)
    module = pclf.LegacyCNNClassifier().eval()
    module.load_state_dict(
        migrate.import_mnist_legacy_classifier(str(tmp_path / "clf.pt")))
    x = np.random.default_rng(6).uniform(-1, 1, (4, 28, 28, 1)).astype(
        np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = module(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)
        module.Linear_0.weight.copy_(ref.net[7].weight)
        unpermuted = module(torch.from_numpy(x))
    assert (unpermuted - want).abs().max() > 100 * ATOL


def test_mnist_generator_import_serves_on_the_kernel_route(tmp_path):
    """A conv imported at cuDNN's OIHW layout loads into a generator whose
    convs are routed to the conv kernel (its plain version here), with
    the same output as the cuDNN route."""
    torch.manual_seed(0)
    _save(_RefMnistG(), tmp_path / "g.pt", seed=11)
    sd = migrate.import_mnist_generator(str(tmp_path / "g.pt"),
                                        n_resblocks=BLOCKS)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 28, 28, 1)).astype(
        np.float32))
    t = torch.tensor([2, 9])
    m = torch.ones_like(x)
    outs = {}
    for impl in (None, "pallas"):
        g = pgen.ImageResidualGenerator(base_ch=CH, n_resblocks=BLOCKS,
                                        conv_impl=impl)
        g.load_state_dict(dict(sd), strict=True)
        with torch.no_grad():
            outs[impl] = g.eval()(x, t, m)[0]
    np.testing.assert_allclose(outs["pallas"].numpy(), outs[None].numpy(),
                               atol=ATOL, rtol=0)


def test_importer_raises_on_a_missing_reference_key(tmp_path):
    torch.manual_seed(0)
    ref = _ref_moons_clf()
    _save(ref, tmp_path / "c.pt", seed=1)
    sd = torch.load(tmp_path / "c.pt", weights_only=True)
    del sd["net.2.bias"]
    torch.save(sd, tmp_path / "c.pt")
    with pytest.raises(KeyError, match="net.2.bias"):
        migrate.import_moons_classifier(str(tmp_path / "c.pt"))


def test_load_state_dict_reads_tensors_only(tmp_path):
    torch.save({"w": torch.ones(2, dtype=torch.float64),
                "n": torch.tensor(3), "note": "text"}, tmp_path / "s.pt")
    got = migrate.load_state_dict(str(tmp_path / "s.pt"))
    assert got.keys() == {"w", "n"}
    assert all(v.dtype == np.float32 for v in got.values())


def test_validate_against_lists_every_mismatch():
    module = pclf.MLPClassifier(3, 4, 2)
    sd = dict(module.state_dict())
    del sd["Linear_1.bias"]
    sd["Linear_0.weight"] = torch.zeros(2, 4)
    sd["extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError) as ei:
        migrate.validate_against(sd, module, "moons clf")
    msg = str(ei.value)
    assert msg.startswith("moons clf: ")
    assert "missing leaf 'Linear_1.bias'" in msg
    assert "unexpected leaf 'extra.weight'" in msg
    assert ("shape mismatch at 'Linear_0.weight': imported (2, 4) vs "
            "model (4, 2)") in msg


@pytest.mark.parametrize("kind", ["missing", "unexpected", "shape"])
def test_validate_against_each_message(kind):
    module = pclf.MLPClassifier(3, 4, 2)
    sd = dict(module.state_dict())
    if kind == "missing":
        del sd["Linear_2.weight"]
    elif kind == "unexpected":
        sd["Linear_3.bias"] = torch.zeros(3)
    else:
        sd["Linear_2.bias"] = torch.zeros(4)
    with pytest.raises(ValueError, match={"missing": "missing leaf",
                                          "unexpected": "unexpected leaf",
                                          "shape": "shape mismatch"}[kind]):
        migrate.validate_against(sd, module)
