"""`cfgan_torch.core.RngStream` against `cfgan.core.RngStream`'s contract,
on the CPU.  JAX's keys cannot be reproduced in torch, so the draws are
the port's own; what carries over is the names' hash (`_stable_hash`, bit
for bit) and the contract: `fixed` repeats, `next` never repeats within
or across names, `split(n)` gives n distinct streams, and two streams of
one seed agree."""
import numpy as np
import pytest
import torch

from cfgan.core.rng import RngStream as JaxRngStream
from cfgan.core.rng import _stable_hash as jax_stable_hash
from cfgan_torch.core import RngStream
from cfgan_torch.core.rng import _stable_hash

NAMES = ["", "a", "mask", "init", "split", "d_step", "g_step", "x" * 200,
         "ünïcødé", "日本語", "emoji 🎲", "tab\tnew\nline", "0", "00",
         "mask ", " mask"]


def _draw(gen: torch.Generator) -> np.ndarray:
    return torch.randint(0, 2 ** 62, (4,), generator=gen,
                         device=gen.device).cpu().numpy()


def test_stable_hash_is_jax_on_names():
    rng = np.random.RandomState(0)
    random_names = ["".join(map(chr, rng.randint(32, 0x3000, k)))
                    for k in rng.randint(0, 40, 200)]
    for name in NAMES + random_names:
        assert _stable_hash(name) == jax_stable_hash(name), name


def test_names_hash_to_what_jax_folds_in():
    """Both packages fold the same value into their root (below 2**31 but
    for the empty name, the FNV offset basis): JAX's `fixed(name)` is
    `fold_in(root, _stable_hash(name))`."""
    import jax

    jrng = JaxRngStream(42)
    for name in NAMES[:6]:
        want = jax.random.fold_in(jax.random.key(42), _stable_hash(name))
        assert np.array_equal(jax.random.key_data(jrng.fixed(name)),
                              jax.random.key_data(want))
        assert 0 <= _stable_hash(name) < 2 ** (32 if name == "" else 31)


def test_fixed_repeats():
    rng = RngStream(42, device="cpu")
    for name in NAMES:
        a, b = rng.fixed(name), rng.fixed(name)
        assert a is not b
        assert a.initial_seed() == b.initial_seed()
        assert np.array_equal(_draw(a), _draw(b))
    rng.next("mask")
    assert np.array_equal(_draw(rng.fixed("mask")),
                          _draw(RngStream(42, device="cpu").fixed("mask")))


def test_next_never_repeats_within_or_across_names():
    rng = RngStream(7, device="cpu")
    seeds, draws = set(), set()
    fixed = {rng.fixed(n).initial_seed() for n in NAMES}
    for _ in range(20):
        for name in NAMES:
            g = rng.next(name)
            seeds.add(g.initial_seed())
            draws.add(tuple(_draw(g)))
    assert len(seeds) == len(draws) == 20 * len(NAMES)
    assert not seeds & fixed


def test_split_gives_distinct_streams():
    rng = RngStream(3, device="cpu")
    first, second = rng.split(5), rng.split(5)
    assert len(first) == len(second) == 5
    seeds = {g.initial_seed() for g in first + second}
    assert len(seeds) == 10
    assert len({tuple(_draw(g)) for g in first + second}) == 10
    assert rng.split(0) == []


def test_two_streams_of_one_seed_agree():
    a, b = RngStream(42, device="cpu"), RngStream(42, device="cpu")
    for name in ["mask", "", "mask", "noise", ""]:
        assert np.array_equal(_draw(a.next(name)), _draw(b.next(name)))
    assert [g.initial_seed() for g in a.split(3)] == [
        g.initial_seed() for g in b.split(3)]
    other = RngStream(43, device="cpu")
    assert not np.array_equal(_draw(other.fixed("mask")),
                              _draw(a.fixed("mask")))


def test_a_generator_seeds_the_root():
    gen = torch.Generator().manual_seed(42)
    rng = RngStream(gen, device="cpu")
    assert rng.device == torch.device("cpu")
    assert np.array_equal(_draw(rng.fixed("init")),
                          _draw(RngStream(42, device="cpu").fixed("init")))


def test_a_generator_does_not_choose_the_device():
    """Only the generator's seed is taken: without a device the stream
    resolves to the card, as for an int seed, whatever the generator's
    own device."""
    if torch.cuda.is_available():
        assert RngStream(torch.Generator()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RngStream(torch.Generator().manual_seed(42))


def test_generators_live_on_the_stream_device():
    rng = RngStream(0, device="cpu")
    assert all(g.device == torch.device("cpu")
               for g in [rng.fixed("a"), rng.next("a"), *rng.split(2)])


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RngStream(0)
