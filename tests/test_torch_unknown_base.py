"""An unknown base (code -1) inside the aligned region, on every traceback
route of the port, against the JAX package on the CPU.

The port renders a negative code as ``encode.decode`` renders it: 'N', or
'X' for an alphabet that carries one, on the full-P route
(``oracle.alignment_strings``) and on the windowed and Hirschberg routes
(``traceback._render``), whose code lists mark a gap with
``traceback.GAP``, a value no int8 code takes. The JAX package renders the
base by the route taken: the full-P route prints the alphabet's last
letter, the lean routes print '-' (their gap marker is -1 too), and its
``walk_from_end`` counts the base as a gap when it works out the start
cell. These tests pin that departure: every number and every other letter
equal to the JAX package's, the unknown base shown as itself. Tolerance:
exact equality."""

import numpy as np
import pytest

import swtpu
import swtpu.runtime_native as rn
from swtpu.engine import traceback as jtb
import swtpu_torch
from swtpu_torch import Scoring
from swtpu_torch.core.encode import DNA_ALPHABET, PROTEIN_ALPHABET
from swtpu_torch.dist.database import _cigar
from swtpu_torch.engine import traceback as tb

LINEAR = Scoring()
DNA_AFFINE = Scoring(mode="affine")
CASES = {
    # (port scoring, alphabet, letters, the unknown base's letter)
    "dna_linear": (LINEAR, DNA_ALPHABET, 4, "N"),
    "dna_affine": (DNA_AFFINE, DNA_ALPHABET, 4, "N"),
    "protein_alphabet": (LINEAR, PROTEIN_ALPHABET, 20, "X"),
}


def _jax(sc: Scoring):
    return swtpu.Scoring(mode=sc.mode, match=sc.match, mismatch=sc.mismatch,
                         gap=sc.gap, gap_open=sc.gap_open,
                         gap_extend=sc.gap_extend)


def _pair(letters: int, seed: int = 7) -> tuple:
    """a of 90 random letters; b = a[20:60] with an unknown base at its
    row 16 (0-based 15), well inside the aligned region."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, letters, 90).astype(np.int8)
    b = a[20:60].copy()
    b[15] = -1
    return a, b


def _start(end_i: int, end_j: int, ra: str, rb: str) -> tuple:
    """The start cell from the strings: every letter of a row or column,
    the unknown base included, is one step."""
    return (end_i - sum(c != "-" for c in rb) + 1,
            end_j - sum(c != "-" for c in ra) + 1)


def _unknown_as(got: str, want: str, unk: str, shown: str) -> None:
    """``got`` is ``want`` with the unknown base shown as ``unk`` where the
    JAX package shows ``shown``: once, at the same place (the protein
    alphabet's last letter is its 'X', so there the two agree)."""
    assert len(got) == len(want)
    if unk == shown:
        assert got == want
        return
    at = [x for x, (g, w) in enumerate(zip(got, want)) if g != w]
    assert [got[x] for x in at] == [unk] and [want[x] for x in at] == [shown]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", ["full", "windowed", "hirschberg"])
def test_unknown_base_renders_as_itself_on_every_route(case, route,
                                                       monkeypatch):
    sc, alphabet, letters, unk = CASES[case]
    a, b = _pair(letters)
    if route == "full":
        # the JAX package's own P walk, not its native host tier (which
        # renders the base as a gap, as its lean routes do)
        monkeypatch.setattr(rn, "available", lambda: False)
        got = swtpu_torch.align(a, b, sc, alphabet=alphabet, device="cpu")
        want = swtpu.align(a, b, _jax(sc), alphabet=alphabet)
        assert (got.max_score, got.max_i, got.max_j, got.last_cell) == (
            want.max_score, want.max_i, want.max_j, want.last_cell)
        got_s = (got.aligned_a, got.aligned_b)
        want_s = (want.aligned_a, want.aligned_b)
        shown = alphabet[-1]              # the JAX full-P route's letter
    else:
        # a small base case makes the Hirschberg recursion reach the base
        # inside the host's dense cases and its row passes
        monkeypatch.setattr(tb, "_BASE_CELLS", 64)
        monkeypatch.setattr(jtb, "_BASE_CELLS", 64)
        got = getattr(tb, route)(a, b, sc, alphabet=alphabet, device="cpu")
        want = getattr(jtb, route)(a, b, _jax(sc), alphabet=alphabet)
        assert got[0] == want[0] > 0 and got[1] == tuple(want[1])
        got_s, want_s = got[2:], want[2:]
        shown = "-"                       # the JAX lean routes' gap marker
    assert got_s[0] == want_s[0]          # a holds no unknown base
    _unknown_as(got_s[1], want_s[1], unk, shown)
    assert got_s[1][15] == unk and "-" not in got_s[1]


@pytest.mark.parametrize("case", list(CASES))
def test_routes_locate_the_same_cells(case, monkeypatch):
    """The full-P, windowed and Hirschberg routes and ``walk_from_end``
    give one start and one end cell; the JAX package's ``walk_from_end``
    counts the unknown base as a gap and starts a row late."""
    sc, alphabet, letters, _ = CASES[case]
    a, b = _pair(letters)
    full = swtpu_torch.align(a, b, sc, alphabet=alphabet, device="cpu")
    cells = {"full": (*_start(full.max_i, full.max_j, full.aligned_a,
                              full.aligned_b), full.max_i, full.max_j)}
    monkeypatch.setattr(tb, "_BASE_CELLS", 64)
    for route in ("windowed", "hirschberg"):
        _, loc, ra, rb = getattr(tb, route)(a, b, sc, alphabet=alphabet,
                                            device="cpu")
        cells[route] = (loc.start_i, loc.start_j, loc.end_i, loc.end_j)
        assert _start(loc.end_i, loc.end_j, ra, rb) == cells[route][:2]
    score, loc, ra, rb = tb.walk_from_end(a, b, sc, full.max_score,
                                          full.max_i, full.max_j,
                                          alphabet=alphabet, device="cpu")
    cells["walk_from_end"] = (loc.start_i, loc.start_j, loc.end_i,
                              loc.end_j)
    assert score == full.max_score and (ra, rb) == (full.aligned_a,
                                                    full.aligned_b)
    assert len(set(cells.values())) == 1, cells
    assert cells["full"] == (1, 21, 40, 60)
    _, jloc, _, _ = jtb.walk_from_end(a, b, _jax(sc), full.max_score,
                                      full.max_i, full.max_j,
                                      alphabet=alphabet)
    assert (jloc.start_i, jloc.start_j, jloc.end_i, jloc.end_j) == (
        2, 21, 40, 60)


@pytest.mark.parametrize("route", ["full", "windowed", "hirschberg"])
def test_cigar_counts_the_unknown_base_as_a_match(route, monkeypatch):
    a, b = _pair(4)
    if route == "full":
        r = swtpu_torch.align(a, b, device="cpu")
        ra, rb = r.aligned_a, r.aligned_b
    else:
        monkeypatch.setattr(tb, "_BASE_CELLS", 64)
        ra, rb = getattr(tb, route)(a, b, LINEAR, device="cpu")[2:]
    assert _cigar(rb, ra) == "40M"


def test_gap_marker_is_no_code():
    assert not -128 <= tb.GAP <= 127
    assert tb._render([0, tb.GAP, -1, -2, -3], [3, 2, tb.GAP, 1, 0]) == (
        "A-NNN", "TG-CA")
    assert tb._render([-1, 20], [tb.GAP, 0], PROTEIN_ALPHABET) == ("XX",
                                                                    "-A")
