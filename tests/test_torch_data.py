"""The port's MNIST loader (cfgan_torch.data) against the JAX package's
(cfgan.data.mnist), on the CPU.  Bar: bit for bit.

- `load_mnist` on the 120-image IDX fixture: images, labels and the
  stratified train/valid split (scikit-learn's `train_test_split` in the
  JAX package, redone in numpy in the port), for two seeds and two valid
  fractions;
- `synthesize` from the committed glyph table against the JAX package's
  `synthesize` given the same table, and its elastic field against the
  `np.einsum` that the JAX package computes it with;
- the committed glyph table against `_render_glyphs()` (matplotlib);
- `epoch_perm` and the stateless stream seeds.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from cfgan.data import mnist as jm
from cfgan_torch.data import mnist as pm
from cfgan_torch.data.pipeline import epoch_perm, stream_seed

FIXTURE = str(Path(__file__).resolve().parent / "fixtures" / "mnist_idx")


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_same(u, v)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [42, 7])
@pytest.mark.parametrize("valid_fraction", [0.1, 0.25])
def test_load_mnist_matches_jax_bit_for_bit(seed, valid_fraction):
    got = pm.load_mnist(path=FIXTURE, seed=seed,
                        valid_fraction=valid_fraction)
    want = jm.load_mnist(path=FIXTURE, seed=seed,
                         valid_fraction=valid_fraction)
    _assert_same(got, want)
    assert len(got[1][1]) == int(np.ceil(valid_fraction * 120))


@pytest.mark.parametrize("seed", [0, 3])
def test_stratified_split_matches_sklearn(seed):
    from sklearn.model_selection import train_test_split

    y = np.random.RandomState(seed).randint(0, 10, 997)
    want = train_test_split(np.arange(len(y)), test_size=0.1, stratify=y,
                            random_state=seed)
    got = pm.stratified_split(y, 0.1, seed)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_load_mnist_limit_and_no_valid_split():
    (xtr, ytr), (xva, yva), (xte, yte) = pm.load_mnist(
        path=FIXTURE, valid_fraction=0.0, limit=50)
    _assert_same(((xtr, ytr), (xva, yva), (xte, yte)),
                 jm.load_mnist(path=FIXTURE, valid_fraction=0.0, limit=50))
    assert xtr.shape == (50, 28, 28, 1) and xte.shape == (10, 28, 28, 1)
    assert xva is None and yva is None


@pytest.mark.parametrize("seed", [0, 11])
def test_synthesize_matches_jax_from_the_committed_glyphs(seed):
    glyphs = pm.load_glyphs()
    _assert_same(pm.synthesize(512, seed),
                 jm.synthesize(512, seed, glyphs=glyphs))


@pytest.mark.parametrize("coarse,out", [(5, 28), (4, 20), (3, 7)])
def test_elastic_field_is_the_einsum_bit_for_bit(coarse, out):
    """The corpus's displacement field, summed term by term, equals numpy's
    einsum of the JAX package's generator (same float32 products, same
    order), exact zeros and large values in the grid included."""
    rng = np.random.RandomState(coarse)
    grid = (rng.normal(0.0, 1.0, (300, coarse, coarse, 2))
            * rng.uniform(0.3, 2.0, (300, 1, 1, 1))).astype(np.float32)
    grid[::7] = 0.0
    grid[1::11, 0] *= np.float32(1e30)
    U = pm._upsample_matrix(coarse, out)
    want = np.einsum("ij,njkc,lk->nilc", U, grid, U)
    _assert_same(pm._elastic_field(U, grid), want)


def test_committed_glyphs_equal_the_rendered_table():
    pytest.importorskip("matplotlib")
    _assert_same(pm.load_glyphs(), jm._render_glyphs())


def test_synthetic_corpus_is_cached_and_reloads(tmp_path, monkeypatch):
    monkeypatch.setattr(pm, "TRAIN_N", 200)
    monkeypatch.setattr(pm, "TEST_N", 16)
    monkeypatch.delenv("CFGAN_DATA_DIR", raising=False)
    first = pm.load_mnist(seed=1, cache_dir=tmp_path)
    assert list(tmp_path.iterdir())[0].name == "synthetic_mnist_v2_0.npz"
    _assert_same(pm.load_mnist(seed=1, cache_dir=tmp_path), first)
    (xtr, _), _, _ = first
    assert xtr.shape == (180, 28, 28, 1)
    assert xtr.min() >= -1.0 and xtr.max() <= 1.0


def test_epoch_perm_and_stream_seeds():
    """A permutation of full batches, the same from the same seed; the
    streams of a seed differ from each other and from another seed's."""
    def perm(s):
        return epoch_perm(torch.Generator().manual_seed(s), 103, 10)

    p = perm(stream_seed(42, 0))
    assert p.shape == (10, 10)
    assert len(set(p.flatten().tolist())) == 100
    assert torch.equal(p, perm(stream_seed(42, 0)))
    seeds = {stream_seed(s, k) for s in (42, 43) for k in range(4)}
    assert len(seeds) == 8 and all(0 <= v < 2 ** 63 for v in seeds)
