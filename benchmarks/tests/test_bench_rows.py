"""The plain reference for one long pair (``reference/rows.py``) against
the plain reference of every other cell (``reference/sw.py``'s ``pairs``)
on seeded pairs, with and without the int16 cap of the control, and the
control found wrong where the scores pass 32767. On a card: a 4096-row
slice of the megabase cell's width, 1,072,950 columns, through the CUDA
graph's replays, equal to ``sw.pairs`` there."""

import numpy as np
import pytest

from benchmarks.reference import rows, sw
from benchmarks.reference.sw import CAPS

CUDALIGN = sw.Scoring(mode="affine", match=1, mismatch=-3, gap_open=-5,
                      gap_extend=-2)
SCORINGS = {"cudalign": CUDALIGN, "upstream": sw.Scoring(),
            "scaled": sw.Scoring(mode="affine", match=1000, mismatch=-3000,
                                 gap_open=-5000, gap_extend=-2000)}


def related(m: int, n: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, m).astype(np.int8)
    b = a[np.sort(rng.choice(m, size=n, replace=False))]
    sub = np.flatnonzero(rng.random(n) < 0.05)
    b[sub] = (b[sub] + 1) % 4
    return a, b


def reference(a, b, sc, cap=None, device="cpu") -> tuple:
    return tuple(int(x) for x in sw.pairs(a[None], b[None], sc, None, cap,
                                          device)[0])


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cap", [None, CAPS["int16"], CAPS["int8"]])
def test_rows_equal_sw_pairs(scoring, seed, cap):
    rng = np.random.default_rng(seed)
    a, b = related(300, 260, seed)
    sc = SCORINGS[scoring]
    assert rows.pair(a, b, sc, cap) == reference(a, b, sc, cap)
    x = rng.integers(0, 4, 97).astype(np.int8)
    y = rng.integers(0, 4, 140).astype(np.int8)
    assert rows.pair(x, y, sc, cap, block=8) == reference(x, y, sc, cap)


def test_the_int16_cap_fails_where_the_scores_pass_it():
    a, b = related(300, 260, 14)
    sc = SCORINGS["scaled"]
    full = rows.pair(a, b, sc)
    capped = rows.pair(a, b, sc, CAPS["int16"])
    assert full[0] > CAPS["int16"] and capped[0] == CAPS["int16"]
    assert full != capped
    # at CUDAlign's own scores the same pair stays far under int16
    assert rows.pair(a, b, CUDALIGN) == rows.pair(a, b, CUDALIGN,
                                                  CAPS["int16"])


@pytest.mark.gpu
def test_a_slice_at_the_megabase_width_on_the_card(card):
    a, b = related(1072950, 4096, 15)
    got = rows.pair(a, b, CUDALIGN, None, card)
    assert got == reference(a, b, CUDALIGN, None, card)
    assert got[0] > 0
    # the same rows with no graph, one by one
    assert rows.pair(a, b[:1500], CUDALIGN, None, card) == rows.pair(
        a, b[:1500], CUDALIGN, None, card, rows_a_replay=len(b))
