"""glibc's rand() stream in the port (``core.encode.GlibcRand`` and the
native ``runtime_native.reference_random``) against the JAX package's
(``swtpu.core.encode.GlibcRand`` and ``swtpu.runtime_native``, built from
``csrc/`` by its own make), on the CPU.

Tolerance: exact equality of every output and code. Seed 0 is the one
departure: the port takes it as 1 in both forms, as glibc's ``srandom``
does and as the JAX package's native library does; the JAX Python class
does not (it stores 0 and yields only zeros), a fault the port does not
copy.
"""

import numpy as np
import pytest

from swtpu import runtime_native as jrn
from swtpu.core.encode import GlibcRand as JGlibcRand
from swtpu_torch import runtime_native as rn
from swtpu_torch.core.encode import GlibcRand

SEEDS = (1, 7, 12345)
LENGTHS = (0, 1, 64, 1000)
# glibc's rand() after srand(1) (and after no srand at all)
GLIBC_SEED1 = [1804289383, 846930886, 1681692777, 1714636915]
# glibc's answer for seed 0, the stream of seed 1 as ACGT codes
SEED0_CODES = [2, 1, 3, 2, 3, 2, 1, 0, 3, 3, 1, 2]


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's library, where its make built it; the comparisons
    with it skip otherwise, as tests/test_native.py does."""
    if not jrn.available():
        pytest.skip("the JAX package's native runtime is not built")
    return jrn


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_rand_matches_jax(seed, length):
    ours, theirs = GlibcRand(seed), JGlibcRand(seed)
    assert [ours.rand() for _ in range(length)] == \
        [theirs.rand() for _ in range(length)]


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_sequence_matches_jax(seed, length):
    got = GlibcRand(seed).reference_sequence(length)
    want = JGlibcRand(seed).reference_sequence(length)
    assert got.dtype == np.int8 and got.shape == (length,)
    np.testing.assert_array_equal(got, want)


def test_seed1_is_glibc():
    g = GlibcRand()
    assert [g.rand() for _ in range(4)] == GLIBC_SEED1
    g = GlibcRand(1)
    assert [g.rand() for _ in range(4)] == GLIBC_SEED1


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("seed", (0, *SEEDS))
def test_native_matches_python(seed, length):
    """The port's native stream equals its Python class, as
    tests/test_native.py holds the JAX pair."""
    got = rn.reference_random(length, seed=seed)
    assert got.dtype == np.int8 and got.shape == (length,)
    np.testing.assert_array_equal(got,
                                  GlibcRand(seed).reference_sequence(length))


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("seed", (0, *SEEDS))
def test_native_matches_jax_native(jax_native, seed, length):
    """The port's native stream equals the JAX package's native one."""
    np.testing.assert_array_equal(
        rn.reference_random(length, seed=seed),
        jax_native.reference_random(length, seed=seed))


def test_seed0_follows_glibc_where_the_jax_class_departs():
    """Seed 0 is glibc's seed 1 (``srandom`` maps 0 to 1), in the port's
    class and its native library alike. The JAX Python class departs: it
    stores r[0] = 0, so every word is 0, and its ``GlibcRand(0)`` answers
    differently from its own native ``reference_random(n, 0)``. The port
    does not copy that."""
    assert GlibcRand(0).reference_sequence(12).tolist() == SEED0_CODES
    assert rn.reference_random(12, seed=0).tolist() == SEED0_CODES
    np.testing.assert_array_equal(GlibcRand(0).reference_sequence(1000),
                                  GlibcRand(1).reference_sequence(1000))
    # the pinned departure of the JAX class
    assert JGlibcRand(0).reference_sequence(12).tolist() == [0] * 12


def test_seed0_is_the_jax_native_answer(jax_native):
    """The JAX package's native library maps seed 0 to 1 as glibc does;
    the port pins its answer."""
    assert jax_native.reference_random(12, seed=0).tolist() == SEED0_CODES


def test_reference_random_defaults_to_seed_1():
    np.testing.assert_array_equal(rn.reference_random(64),
                                  GlibcRand(1).reference_sequence(64))


def test_reference_random_refuses_a_negative_length():
    with pytest.raises(ValueError, match="length"):
        rn.reference_random(-1)


def test_reference_codes_cover_acgt():
    codes = rn.reference_random(4096, seed=12345)
    assert set(np.unique(codes).tolist()) == {0, 1, 2, 3}
