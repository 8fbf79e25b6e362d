"""The plain row reference (``tests/plain_rows.py``) against the port's
numpy oracle (``swtpu_torch.core.oracle.fill``) on the CPU: seeded random
pairs in linear and affine gaps at CUDAlign's scores and the upstream's,
equal sequences, pairs with no match, pairs whose max is reached in many
cells (the first row-major one must win), and prefix-max blocks small
enough that every row carries across many of them. Exact equality of the
score, the end cell and the last cell. The benchmark's copy of the
reference (``benchmarks/reference/rows.py``) is the same file."""

from pathlib import Path

import numpy as np
import pytest

import plain_rows
from swtpu_torch.core import oracle
from swtpu_torch.core.config import Scoring

ROOT = Path(__file__).resolve().parents[1]
SCORINGS = {
    "cudalign": Scoring(mode="affine", match=1, mismatch=-3, gap_open=-5,
                        gap_extend=-2),
    "upstream": Scoring(match=3, mismatch=-3, gap=-2),
    "upstream_affine": Scoring(mode="affine", match=3, mismatch=-3,
                               gap_open=-4, gap_extend=-1),
    "linear_cheap_gap": Scoring(match=2, mismatch=-1, gap=-1),
}


def want(a, b, scoring) -> tuple:
    r = oracle.fill(a, b, scoring)
    return (r.max_score, *r.max_ij, int(r.H[-1, -1]))


def pairs(kind: str, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    m, n = (int(x) for x in rng.integers(20, 120, 2))
    if kind == "random":
        return (rng.integers(0, 4, m).astype(np.int8),
                rng.integers(0, 4, n).astype(np.int8))
    if kind == "equal":
        a = rng.integers(0, 4, m).astype(np.int8)
        return a, a.copy()
    if kind == "mismatch":
        return np.zeros(m, np.int8), np.ones(n, np.int8)
    if kind == "ties":            # ACGT repeated: the max in many cells
        return (np.tile(np.arange(4, dtype=np.int8), m // 4),
                np.tile(np.arange(4, dtype=np.int8), n // 8))
    # a copy of a with letters deleted and substituted
    a = rng.integers(0, 4, m).astype(np.int8)
    b = a[np.sort(rng.choice(m, size=min(n, m - 1), replace=False))]
    sub = np.flatnonzero(rng.random(len(b)) < 0.1)
    b[sub] = (b[sub] + 1) % 4
    return a, b


KINDS = ("random", "equal", "mismatch", "ties", "mutated")


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_rows_equal_the_oracle(scoring, kind, seed):
    a, b = pairs(kind, seed)
    sc = SCORINGS[scoring]
    got = plain_rows.pair(a, b, sc)
    assert got == want(a, b, sc)
    if kind == "mismatch":
        assert got == (0, 0, 0, 0)
    if kind == "ties":
        assert got[0] > 0


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("block", [1, 3, 16])
def test_small_blocks_carry_the_prefix_max(scoring, block):
    a, b = pairs("mutated", 7)
    sc = SCORINGS[scoring]
    assert plain_rows.pair(a, b, sc, block=block) == want(a, b, sc)


def test_an_empty_side_answers_zeros():
    sc = SCORINGS["cudalign"]
    assert plain_rows.pair(np.zeros(0, np.int8), np.ones(5, np.int8),
                           sc) == (0, 0, 0, 0)
    assert plain_rows.pair(np.ones(5, np.int8), np.zeros(0, np.int8),
                           sc) == (0, 0, 0, 0)


def test_the_benchmark_copy_is_this_file():
    assert (ROOT / "benchmarks" / "reference" / "rows.py").read_text() \
        == (ROOT / "tests" / "plain_rows.py").read_text()
