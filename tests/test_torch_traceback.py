"""The port's lean traceback (``swtpu_torch.engine.traceback``) and its K5
block fill against the JAX package.

On the CPU the port's ``locate``, ``windowed``, ``hirschberg`` and
``walk_from_end`` are held against the same functions of
``swtpu.engine.traceback`` (its scan route there) in DNA linear, DNA affine
and BLOSUM62 protein scoring; ``stripe_block_plain`` against the Pallas
``stripe_block_fn`` in interpret mode. The DP is integer: every comparison
is exact. The ``gpu`` tests hold the block and walk kernels against their
plain versions on the card and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swtpu
import swtpu_torch
from swtpu.core.encode import PROTEIN_ALPHABET, random_pair
from swtpu.core.substitution import BLOSUM62 as JAX_BLOSUM62
from swtpu.engine import traceback as jtb
from swtpu.kernels.pallas_fill import stripe_block_fn
from swtpu_torch import Scoring
from swtpu_torch.convert import substitution_from_jax
from swtpu_torch.core.config import DIAGONAL, LEFT, UP
from swtpu_torch.engine import traceback as tb
from swtpu_torch.kernels import stripe_fill as sf

NEG = -(1 << 30)
DNA_AFFINE = Scoring(mode="affine")                          # 3/-3, -4/-1
PROTEIN_AFFINE = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
BLOSUM62 = substitution_from_jax(JAX_BLOSUM62)
ALPHA = {"dna_linear": "ACGT", "dna_affine": "ACGT",
         "protein": PROTEIN_ALPHABET}


def _jax_scoring(sc: Scoring) -> swtpu.Scoring:
    return swtpu.Scoring(match=sc.match, mismatch=sc.mismatch, gap=sc.gap,
                         gap_open=sc.gap_open, gap_extend=sc.gap_extend,
                         mode=sc.mode)


def _protein(m, n, seed, plant=None):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 20, m).astype(np.int8)
    b = rng.integers(0, 20, n).astype(np.int8)
    if plant:                       # a shared segment: a long alignment
        i0, j0, ln = plant
        b[i0:i0 + ln] = a[j0:j0 + ln]
        b = np.delete(b, [i0 + 5, i0 + 6, i0 + 20])   # gaps inside it
    return a, b


def _case(kind, m=120, n=100, seed=0):
    """(a, b, port scoring, JAX scoring, port table, JAX table)."""
    if kind == "protein":
        a, b = _protein(m, n, 300 + seed,
                        plant=(n // 4, m // 5, min(n // 2, m - m // 5)))
        return (a, b, PROTEIN_AFFINE, _jax_scoring(PROTEIN_AFFINE),
                BLOSUM62, JAX_BLOSUM62)
    a, b = random_pair(m, n, seed=310 + seed)
    sc = Scoring() if kind == "dna_linear" else DNA_AFFINE
    return a, b, sc, _jax_scoring(sc), None, None


KINDS = ["dna_linear", "dna_affine", "protein"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_locate_matches_jax(kind, seed):
    a, b, sc, js, S, jS = _case(kind, seed=seed)
    sf.reset_counts()
    got = tb.locate(a, b, sc, S, device="cpu")
    want = jtb.locate(a, b, js, sub=jS)
    assert got == tuple(want) and got.score > 0
    assert isinstance(got, tb.Located)
    # the forward pass and the anchored reverse pass, both plain on the CPU
    assert sf.plain_calls["stripe_score_plain"] == 1
    assert sf.plain_calls["stripe_block_plain"] == 1
    assert not any(sf.launches.values())


def test_locate_nothing_scores():
    a = np.zeros(30, np.int8)
    b = np.ones(20, np.int8)
    assert tb.locate(a, b, Scoring(), device="cpu") is None
    assert jtb.locate(a, b, swtpu.Scoring()) is None
    assert tb.windowed(a, b, Scoring(), device="cpu") is None
    assert tb.hirschberg(a, b, Scoring(), device="cpu") is None


@pytest.mark.parametrize("kind", KINDS)
def test_windowed_matches_jax(kind):
    a, b, sc, js, S, jS = _case(kind, seed=2)
    sf.reset_counts()
    got = tb.windowed(a, b, sc, sub=S, alphabet=ALPHA[kind], device="cpu")
    want = jtb.windowed(a, b, js, sub=jS, alphabet=ALPHA[kind])
    assert got[0] == want[0] and got[1] == tuple(want[1])
    assert got[2:] == want[2:]
    assert sf.plain_calls["stripe_fill_plain"] == 1
    assert sf.plain_calls["walk_p_plain"] == 1


@pytest.mark.parametrize("kind", KINDS)
def test_windowed_small_budget_takes_hirschberg(kind, monkeypatch):
    a, b, sc, js, S, jS = _case(kind, seed=3)
    monkeypatch.setattr(tb, "_BASE_CELLS", 64)
    monkeypatch.setattr(jtb, "_BASE_CELLS", 64)
    sf.reset_counts()
    got = tb.windowed(a, b, sc, max_window_cells=100, sub=S,
                      alphabet=ALPHA[kind], device="cpu")
    want = jtb.windowed(a, b, js, max_window_cells=100, sub=jS,
                        alphabet=ALPHA[kind])
    assert got[0] == want[0] and got[1] == tuple(want[1])
    assert got[2:] == want[2:]
    assert sf.plain_calls["stripe_fill_plain"] == 0    # no window refill
    assert sf.plain_calls["stripe_block_plain"] > 3    # the row passes


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("base", [64, 1 << 18], ids=["recursing", "base"])
def test_hirschberg_matches_jax(kind, base, monkeypatch):
    # _BASE_CELLS monkeypatched small forces the divide and conquer (the
    # Myers-Miller state split for affine gaps) down to tiny host cases
    a, b, sc, js, S, jS = _case(kind, m=90, n=110, seed=4)
    monkeypatch.setattr(tb, "_BASE_CELLS", base)
    monkeypatch.setattr(jtb, "_BASE_CELLS", base)
    got = tb.hirschberg(a, b, sc, sub=S, alphabet=ALPHA[kind], device="cpu")
    want = jtb.hirschberg(a, b, js, sub=jS, alphabet=ALPHA[kind])
    assert got[0] == want[0] and got[1] == tuple(want[1])
    assert got[2:] == want[2:]


@pytest.mark.parametrize("tbg", [0, -3], ids=["open_border", "g0"])
@pytest.mark.parametrize("kind", ["dna_affine", "protein"])
def test_nw_last_rows_match_jax(kind, tbg):
    a, b, sc, js, S, jS = _case(kind, m=50, n=37, seed=5)
    H, F = tb._nw_last_rows_affine(a, b, sc, tbg, S, device="cpu")
    jH, jF = jtb._nw_last_rows_affine(a, b, js, tbg, sub=jS)
    np.testing.assert_array_equal(H, jH)
    np.testing.assert_array_equal(F, jF)
    row = tb._nw_last_row(a, b, Scoring(), device="cpu")
    np.testing.assert_array_equal(row, jtb._nw_last_row(a, b,
                                                        swtpu.Scoring()))


@pytest.mark.parametrize("kind", KINDS)
def test_walk_from_end_matches_jax(kind):
    a, b, sc, js, S, jS = _case(kind, seed=6)
    loc = tb.locate(a, b, sc, S, device="cpu")
    got = tb.walk_from_end(a, b, sc, loc.score, loc.end_i, loc.end_j,
                           loc.last_cell, alphabet=ALPHA[kind], sub=S,
                           device="cpu")
    want = jtb.walk_from_end(a, b, js, loc.score, loc.end_i, loc.end_j,
                             loc.last_cell, alphabet=ALPHA[kind], sub=jS)
    assert got[0] == want[0] and got[1] == tuple(want[1])
    assert got[2:] == want[2:]
    assert (got[1].end_i, got[1].end_j) == (loc.end_i, loc.end_j)


def _bad_reverse(score):
    return lambda *args, **kw: (score, 1, 1)


@pytest.mark.parametrize("kind", KINDS)
def test_anchored_reverse_mismatch_matches_jax(kind, monkeypatch):
    a, b, sc, js, S, jS = _case(kind, seed=7)
    fwd = tb.locate(a, b, sc, S, device="cpu").score
    monkeypatch.setattr(tb, "_nw_argmax", _bad_reverse(fwd - 1))
    monkeypatch.setattr(jtb, "_nw_argmax", _bad_reverse(fwd - 1))
    with pytest.raises(swtpu_torch.AnchoredReverseMismatch) as got:
        tb.locate(a, b, sc, S, device="cpu")
    with pytest.raises(jtb.AnchoredReverseMismatch) as want:
        jtb.locate(a, b, js, sub=jS)
    for name in ("forward_score", "reverse_score", "end_i", "end_j",
                 "last_cell"):
        assert getattr(got.value, name) == getattr(want.value, name), name
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, RuntimeError)


@pytest.mark.parametrize("kind", KINDS)
def test_windowed_fallback_matches_jax(kind, monkeypatch):
    # a broken reverse pass: windowed recovers through walk_from_end when
    # [1..end] fits the budget, and re-raises the typed error otherwise
    a, b, sc, js, S, jS = _case(kind, seed=8)
    monkeypatch.setattr(tb, "_nw_argmax", _bad_reverse(-1))
    monkeypatch.setattr(jtb, "_nw_argmax", _bad_reverse(-1))
    got = tb.windowed(a, b, sc, sub=S, alphabet=ALPHA[kind], device="cpu")
    want = jtb.windowed(a, b, js, sub=jS, alphabet=ALPHA[kind])
    assert got[0] == want[0] and got[1] == tuple(want[1])
    assert got[2:] == want[2:]
    with pytest.raises(tb.AnchoredReverseMismatch):
        tb.windowed(a, b, sc, max_window_cells=4, sub=S, device="cpu")


def _one_column(kind, n, seed):
    """(a of one letter that b holds, b, port scoring, JAX scoring, port
    table, JAX table): every pass over a is one column wide."""
    a, b, sc, js, S, jS = _case(kind, m=120, n=n, seed=seed)
    return b[n // 3:n // 3 + 1].copy(), b, sc, js, S, jS


def _row_split(a, b, sc, S, pkg, **kw):
    """The recursion's global alignment of a against b: Hirschberg for
    linear gaps, Myers-Miller for affine."""
    if not sc.is_affine:
        return pkg._hirschberg(a, b, sc, S, **kw)
    g0 = sc.gap_open - sc.gap_extend
    return pkg._mm_affine(a, b, sc, g0, g0, S, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_width_one_passes_match_jax(kind, monkeypatch):
    # _BASE_CELLS small makes the recursion's row passes one column wide
    a, b, sc, js, S, jS = _one_column(kind, 90, seed=13)
    monkeypatch.setattr(tb, "_BASE_CELLS", 16)
    monkeypatch.setattr(jtb, "_BASE_CELLS", 16)
    got = tb.windowed(a, b, sc, sub=S, alphabet=ALPHA[kind], device="cpu")
    want = jtb.windowed(a, b, js, sub=jS, alphabet=ALPHA[kind])
    assert got[0] == want[0] > 0 and got[1] == tuple(want[1])
    assert got[2:] == want[2:]
    sf.reset_counts()
    got = _row_split(a, b, sc, S, tb, device="cpu")
    want = _row_split(a, b, js, jS, jtb)
    # the port's gap marker is tb.GAP, the JAX package's -1
    assert [[-1 if c == tb.GAP else int(c) for c in x] for x in got] == \
        [list(map(int, x)) for x in want]
    assert sf.plain_calls["stripe_block_plain"] > 3


# ------------------------------------------ the strings from the moves

def _loop_apply_moves(sub_a, sub_b, wn, wm, moves):
    """The per-move loop the renderer replaced: end-first moves -> code
    lists from the corner."""
    out_a, out_b = [], []
    i, j = wn, wm
    for move in moves:
        if move == DIAGONAL:
            out_a.append(sub_a[j - 1]); out_b.append(sub_b[i - 1])
            i -= 1; j -= 1
        elif move == UP:
            out_a.append(tb.GAP); out_b.append(sub_b[i - 1]); i -= 1
        else:
            out_a.append(sub_a[j - 1]); out_b.append(tb.GAP); j -= 1
    return out_a[::-1], out_b[::-1]


def _loop_render(codes_a, codes_b, alphabet):
    """The per-code generator the renderer replaced."""
    unk = "X" if "X" in alphabet else "N"

    def text(codes):
        return "".join("-" if c == tb.GAP else alphabet[c] if c >= 0
                       else unk for c in codes)

    return text(codes_a), text(codes_b)


def _moves(shape, seed):
    """End-first moves of one of the shapes the renderer must cover."""
    D, U, L = DIAGONAL, UP, LEFT
    rng = np.random.default_rng(seed)
    fixed = {"up_run": [D] * 3 + [U] * 400 + [D] * 5,
             "left_run": [D] * 2 + [L] * 500 + [D],
             "single_diagonal": [D], "single_up": [U], "single_left": [L],
             "zero": [],
             "no_diagonal": list(rng.choice([U, L], 300)),
             "gap_ends": [L] * 4 + list(rng.choice([D, U, L], 200)) + [U]}
    if shape in fixed:
        return np.array(fixed[shape], np.int8)
    return rng.choice([D, U, L], 2000, p=[0.6, 0.2, 0.2]).astype(np.int8)


def _sides(moves, alphabet, unknown, seed):
    """Window sides that the moves fit, with spare letters before the
    walk's start; negative codes among them when ``unknown``."""
    rng = np.random.default_rng(seed)
    wm = int(np.count_nonzero(moves != UP)) + 7
    wn = int(np.count_nonzero(moves != LEFT)) + 5
    low = -3 if unknown else 0
    sub_a = rng.integers(low, len(alphabet), wm).astype(np.int8)
    sub_b = rng.integers(low, len(alphabet), wn).astype(np.int8)
    return sub_a, sub_b, wn, wm


MOVE_SHAPES = ["random0", "random1", "up_run", "left_run", "single_diagonal",
               "single_up", "single_left", "no_diagonal", "zero",
               "gap_ends"]


@pytest.mark.parametrize("unknown", [False, True], ids=["known", "unknown"])
@pytest.mark.parametrize("alphabet", ["ACGT", PROTEIN_ALPHABET],
                         ids=["dna", "protein"])
@pytest.mark.parametrize("shape", MOVE_SHAPES)
def test_moves_render_as_the_loop_does(shape, alphabet, unknown):
    moves = _moves(shape, seed=MOVE_SHAPES.index(shape))
    sub_a, sub_b, wn, wm = _sides(moves, alphabet, unknown, seed=len(moves))
    want = _loop_apply_moves(sub_a, sub_b, wn, wm, moves.tolist())
    got = tb._apply_moves(sub_a, sub_b, wn, wm, moves)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, np.array(w, np.int16))
    ra, rb = tb._render(*got, alphabet)
    assert type(ra) is str and type(rb) is str
    assert (ra, rb) == _loop_render(*want, alphabet)
    assert len(ra) == len(rb) == len(moves)
    # the walk hands its moves over as a tensor's array or as a list
    assert all(np.array_equal(g, h) for g, h in zip(got, tb._apply_moves(
        sub_a, sub_b, wn, wm, moves.tolist())))


@pytest.mark.parametrize("form", ["list", "array"])
@pytest.mark.parametrize("alphabet", ["ACGT", PROTEIN_ALPHABET],
                         ids=["dna", "protein"])
def test_render_takes_the_recursions_lists(form, alphabet):
    # Hirschberg's and Myers-Miller's lists mix int8 scalars and GAP
    rng = np.random.default_rng(7)
    codes = rng.integers(-3, len(alphabet), (2, 300)).astype(np.int8)
    ca = [tb.GAP if k % 7 == 0 else codes[0, k] for k in range(300)]
    cb = [tb.GAP if k % 5 == 1 else codes[1, k] for k in range(300)]
    if form == "array":
        ca, cb = np.array(ca, np.int16), np.array(cb, np.int16)
    got = tb._render(ca, cb, alphabet)
    assert all(type(x) is str for x in got)
    assert got == _loop_render(ca, cb, alphabet)
    assert tb._render([], [], alphabet) == ("", "")


@pytest.mark.parametrize("shape", ["gap_ends", "up_run", "left_run",
                                   "single_up", "single_left"])
def test_walk_from_end_start_counts_letters(shape, monkeypatch):
    # alignments that begin and end in a gap: the start is the end less
    # the letters each side takes, as the per-element count gives it
    moves = _moves(shape, seed=3)
    a, b, wn, wm = _sides(moves, "ACGT", True, seed=11)
    want_a, want_b = _loop_apply_moves(a, b, wn, wm, moves.tolist())
    monkeypatch.setattr(tb, "_window_walk", lambda sa, sb, n, m, *r:
                        tb._apply_moves(sa, sb, n, m, moves))
    score, loc, ra, rb = tb.walk_from_end(a, b, Scoring(), 9, wn, wm, 4,
                                          device="cpu")
    assert (loc.start_i, loc.start_j) == (
        wn - sum(1 for c in want_b if c != tb.GAP) + 1,
        wm - sum(1 for c in want_a if c != tb.GAP) + 1)
    assert (score, loc.end_i, loc.end_j, loc.last_cell) == (9, wn, wm, 4)
    assert type(loc.start_i) is int and type(loc.start_j) is int
    assert (ra, rb) == _loop_render(want_a, want_b, "ACGT")


def _route(method, a, b, sc, S, alphabet):
    if method == "windowed":
        return tb.windowed(a, b, sc, sub=S, alphabet=alphabet, device="cpu")
    if method == "hirschberg":
        return tb.hirschberg(a, b, sc, sub=S, alphabet=alphabet,
                             device="cpu")
    loc = tb.locate(a, b, sc, S, device="cpu")
    return tb.walk_from_end(a, b, sc, loc.score, loc.end_i, loc.end_j,
                            loc.last_cell, alphabet=alphabet, sub=S,
                            device="cpu")


@pytest.mark.parametrize("method", ["windowed", "hirschberg",
                                    "walk_from_end"])
@pytest.mark.parametrize("kind", KINDS)
def test_columns_counted_once_a_rendering(kind, method, tmp_path):
    from swtpu_torch.instrument import profiling
    a, b, sc, js, S, jS = _case(kind, seed=4)
    profiling.clear()
    _route(method, a, b, sc, S, ALPHA[kind])
    assert profiling.recorded() == []
    try:
        with profiling.trace(str(tmp_path), device="cpu"):
            got = _route(method, a, b, sc, S, ALPHA[kind])
        cols = [r for r in profiling.recorded() if r.name == "tb.columns"]
    finally:
        profiling.clear()
    assert [r.value for r in cols] == [len(got[2])] and len(got[2]) > 0
    assert len(got[2]) == len(got[3])


# ------------------------------------------------- K5: the block fill

def _bounds(m, n, seed, anchored, affine):
    """Random finite boundaries (corner shared), or the anchored reverse
    pass's NEG boundaries with a zero origin."""
    rng = np.random.default_rng(seed)
    if anchored:
        top = np.full(m + 1, NEG, np.int32)
        left = np.full(n + 1, NEG, np.int32)
        top[0] = left[0] = 0
        tf, le = np.full(m + 1, NEG, np.int32), np.full(n + 1, NEG, np.int32)
    else:
        top = rng.integers(-40, 40, m + 1).astype(np.int32)
        left = rng.integers(-40, 40, n + 1).astype(np.int32)
        left[0] = top[0]
        tf = rng.integers(-50, 20, m + 1).astype(np.int32)
        le = rng.integers(-50, 20, n + 1).astype(np.int32)
    return top, left, (tf, le) if affine else (None, None)


# (kind, m, n, local, anchored, want_bottom): n > 128 spans several of
# the Pallas kernel's stripes; want_bottom there needs n % 128 == 0
BLOCK_CASES = [
    ("dna_linear", 70, 200, False, False, False),
    ("dna_linear", 60, 128, True, False, True),
    ("dna_linear", 90, 150, False, True, False),
    ("dna_affine", 70, 256, False, False, True),
    ("dna_affine", 80, 130, False, True, False),
    ("protein", 64, 128, False, False, True),
    ("protein", 75, 140, True, True, False),
]


@pytest.mark.parametrize("kind, m, n, local, anchored, want_bottom",
                         BLOCK_CASES)
def test_stripe_block_plain_matches_pallas(kind, m, n, local, anchored,
                                           want_bottom):
    a, b, sc, js, S, jS = _case(kind, m=m, n=n + 3, seed=m)
    b = b[:n]
    top, left, (tf, le) = _bounds(m, n, m + n, anchored, sc.is_affine)
    fn = stripe_block_fn(m, n, js, T=128, local=local,
                         want_bottom=want_bottom, substitution=jS)
    jargs = [jnp.asarray(x) for x in (a, b, top, left)]
    if sc.is_affine:
        jargs += [jnp.asarray(tf), jnp.asarray(le)]
    want = fn(*jargs)
    t = (lambda x: None if x is None else torch.from_numpy(x))
    sf.reset_counts()
    got = sf.stripe_block(t(a), t(b), sc, t(top), t(left), t(tf), t(le),
                          local=local, substitution=t(S),
                          want_bottom=want_bottom)
    assert sf.plain_calls["stripe_block_plain"] == 1
    assert got.best.tolist()[:3] == [int(v) for v in want[:3]]
    if anchored:
        # the Pallas kernel clamps NEG E/F boundaries to -2^24, so only
        # the (positive) max is comparable; the scan below checks the rest
        assert got.best.tolist()[0] > 0
        return
    assert int(got.best[3]) == int(want[3])
    np.testing.assert_array_equal(got.right_col.numpy(), want[5])
    if want_bottom:
        np.testing.assert_array_equal(got.bottom_row.numpy(), want[4])
    else:
        assert got.bottom_row is None
    if sc.is_affine:
        # [0] is each package's NEG sentinel (-2^30 here, -2^24 there)
        assert int(got.right_e[0]) == NEG
        np.testing.assert_array_equal(got.right_e[1:].numpy(),
                                      np.asarray(want[7])[1:])
        if want_bottom:
            np.testing.assert_array_equal(got.bottom_f[1:].numpy(),
                                          np.asarray(want[6])[1:])
    else:
        assert got.right_e is None and got.bottom_f is None


def test_stripe_block_validates_boundaries():
    a, b = (torch.from_numpy(x) for x in random_pair(20, 30, seed=9))
    top = torch.zeros(21, dtype=torch.int32)
    left = torch.zeros(31, dtype=torch.int32)
    for bad_top, bad_left in ((top[:20], left), (top, left.to(torch.int64)),
                              (top, left[:5])):
        with pytest.raises(ValueError, match="int32 of shape"):
            sf.stripe_block(a, b, Scoring(), bad_top, bad_left)
    with pytest.raises(ValueError, match="top_f"):
        sf.stripe_block(a, b, DNA_AFFINE, top, left,
                        top_f=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="stripe kernel"):
        sf.stripe_block(a, b, Scoring(gap=0), top, left)


def test_walk_p_plain_follows_the_state_bits():
    # a 3x4 P: (3,4) LEFT with E_EXT, (3,3) LEFT ends the run, (3,2) UP
    # with F_EXT, (2,2) UP ends it, (1,2) DIAGONAL, (0,1) stops at row 0
    P = torch.zeros((4, 5), dtype=torch.int8)
    P[3, 4] = 2 + 4
    P[3, 3] = 2
    P[3, 2] = 1 + 8
    P[2, 2] = 3          # state UP overrides the DIAGONAL code
    P[1, 2] = 3
    moves = sf.walk_p(P, 3, 4)
    assert moves.tolist() == [2, 2, 1, 1, 3]
    assert sf.walk_p(P, 0, 4).tolist() == []
    with pytest.raises(ValueError, match="outside"):
        sf.walk_p(P, 4, 4)
    with pytest.raises(ValueError, match="int8"):
        sf.walk_p(P.to(torch.int32), 3, 4)


# ---- the tile-staged walk (sw_walk_p_tiled), as a model of its schedule

WALK_TILE, WALK_CHUNKS = 64, 5      # csrc/walk_p.cu kTileRows/Diags, kChunks
WALK_EDGE = 16                      # kEdge
UNSTAGED = -99


def walk_tiled_model(buf: np.ndarray, base: int, pitch: int, wn: int,
                     wm: int, lag_seed: int = 0) -> list:
    """The tile-staged walk over the P whose row i starts at byte base + i
    * pitch of ``buf`` (an allocation whose first byte lies on 16 bytes),
    as csrc/walk_p.cu schedules it: tiles of WALK_TILE rows by WALK_TILE
    diagonals d = j - i (row i of tile (bi, bd) holds columns i + dlo ..
    i + dlo + WALK_TILE - 1, dlo = bd WALK_TILE - wn), sixteen slots by
    (bi % 4, bd % 4). For each walker's tile it sees, the loader stages the
    tile, the two above and, when the walker entered it within WALK_EDGE
    diagonals of a side, the two beside them on that side; a row from the
    16-byte chunk holding its first column, a chunk copied whole only
    inside the row's columns 0 .. wm, byte by byte at the row's ends, no
    byte elsewhere; it leaves a slot that holds the walker's tile. The
    loader lags at random (``lag_seed``): it sees the walker's tile before
    the walker reads it, sees one of the walker's tiles since its last pass
    while the walker reads, or sees none, and is made to see the walker's
    tile when the walker waits on it. Asserts the walker reads only a slot
    that holds its tile, staged bytes only, and that the loader never
    refills the slot the walker reads. Returns the moves, end-first."""
    rng = np.random.default_rng(lag_seed)
    slots = {}                    # slot -> (tile, bytes), once landed
    tds = (wn + wm) // WALK_TILE + 1

    def slot_of(ti, td):
        return (ti % 4) * 4 + td % 4

    def stage(ti, td):
        i0, dlo = ti * WALK_TILE, td * WALK_TILE - wn
        data = np.full((WALK_TILE, 16 * WALK_CHUNKS), UNSTAGED, np.int16)
        for r in range(min(wn, i0 + WALK_TILE - 1) - i0 + 1):
            i = i0 + r
            lo, hi = max(0, i + dlo), min(wm, i + dlo + WALK_TILE - 1)
            row = base + i * pitch
            g0 = (row + i + dlo) // 16 * 16
            for c in range(WALK_CHUNKS):
                g = g0 + 16 * c
                if lo > hi or g > row + hi or g + 15 < row + lo:
                    continue
                if g >= row and g + 15 <= row + wm:        # cp.async
                    data[r, 16 * c:16 * c + 16] = buf[g:g + 16]
                else:
                    for y in range(16):
                        if row <= g + y <= row + wm:
                            data[r, 16 * c + y] = buf[g + y]
        return data

    def load(seen, reading):
        """The loader's pass for the walker's tile ``seen`` (and the side
        it entered near); ``reading``: the walker's tile now."""
        (bi, bd), near = seen
        for x in range(3 + 2 * (near != 0)):
            ti, td = bi - (x if x < 3 else x - 3), bd + (0 if x < 3 else near)
            if ti < 0 or td < 0 or td >= tds:
                continue
            sl = slot_of(ti, td)
            held = slots.get(sl, (None,))[0]
            if held == (ti, td) or held == reading:
                continue
            slots[sl] = ((ti, td), stage(ti, td))

    i, j, state, moves = wn, wm, 0, []
    done = i <= 0 or j <= 0
    unseen = []                   # the walker's tiles since the loader's pass
    while not done:
        bi, bd = i // WALK_TILE, (j - i + wn) // WALK_TILE
        i0, dlo = bi * WALK_TILE, bd * WALK_TILE - wn
        rd = j - i - dlo
        near = -1 if rd < WALK_EDGE else 1 if rd >= WALK_TILE - WALK_EDGE \
            else 0
        unseen.append(((bi, bd), near))
        when = rng.integers(3)            # before, while reading, never
        if when == 0 or slots.get(slot_of(bi, bd), (None,))[0] != (bi, bd):
            load(unseen[-1], (bi, bd))
            unseen = []
        elif when == 1:
            k = int(rng.integers(len(unseen)))
            load(unseen[k], (bi, bd))
            unseen = unseen[k + 1:]
        tile, data = slots[slot_of(bi, bd)]
        assert tile == (bi, bd)
        ra = (base + i * pitch + i + dlo) % 16
        while i >= max(i0, 1) and j >= 1 and 0 <= rd < WALK_TILE:
            code = int(data[i - i0, ra + rd])
            assert code != UNSTAGED, (i, j)
            move = state or code & 3
            if move == 0:
                done = True
                break
            moves.append(move)
            if move == 2:                       # LEFT
                state = 2 if code & 4 else 0
                j -= 1
                rd -= 1
            else:                               # UP or DIAGONAL
                state = 1 if move == 1 and code & 8 else 0
                j -= move != 1
                rd += move == 1
                i -= 1
                ra = (ra - pitch - 1) % 16
        done = done or i == 0 or j == 0
    return moves


def _p_layouts(P: np.ndarray) -> list:
    """(label, bytes, base, pitch) of P (rows x cols int8) in three
    layouts: K4's padded rows (``sf.p_matrix``: 3 bytes in, a pitch of 16),
    contiguous, and an odd start with an odd pitch."""
    n1, m1 = P.shape
    out = []
    for label, base, pitch in (
            ("padded", 3, -(-m1 // sf.P_PITCH_ALIGN) * sf.P_PITCH_ALIGN),
            ("contiguous", 0, m1), ("odd", 5, m1 + 7)):
        buf = np.full(base + n1 * pitch + 16, 0x5A, np.int8)
        buf[base:base + n1 * pitch].reshape(n1, pitch)[:, :m1] = P
        out.append((label, buf, base, pitch))
    return out


def _gap_runs_p() -> tuple:
    """(P, corner): random codes, and from the corner a path of 20
    DIAGONAL moves, a 70-long UP run (F_EXT on all its cells but the last)
    across a tile's row border, 10 DIAGONAL, a 70-long LEFT run (E_EXT)
    across a tile's column border, then DIAGONAL to row 0."""
    rng = np.random.default_rng(21)
    P = rng.integers(1, 16, (260, 320)).astype(np.int8)
    i, j = 250, 300
    for kind, length in (("D", 20), ("U", 70), ("D", 10), ("L", 70),
                         ("D", 150)):
        for t in range(length):
            if kind == "D":
                P[i, j] = 3
                i, j = i - 1, j - 1
            elif kind == "U":       # the run's first code says UP; then the
                bit = 8 if t < length - 1 else 0      # state, while F_EXT
                P[i, j] = (1 if t == 0 else int(P[i, j]) & 7) | bit
                i -= 1
            else:
                bit = 4 if t < length - 1 else 0
                P[i, j] = (2 if t == 0 else int(P[i, j]) & 11) | bit
                j -= 1
    return P, (250, 300)


def _walk_ps() -> list:
    """(label, P, corners): codes drawn at random (any move, any state
    bit, a rare NONE: long walks across many tiles and their corners), the
    gap runs of ``_gap_runs_p``, and a DNA affine P of the port's fill."""
    rng = np.random.default_rng(20)
    codes = rng.integers(1, 16, (300, 333)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.002] = 0
    rand_corners = [(64, 64), (63, 63), (128, 127), (127, 128), (299, 332),
                    (65, 200), (200, 64), (1, 1)]
    runs, corner = _gap_runs_p()
    a, b = random_pair(260, 300, seed=22)
    fill = sf.stripe_fill_plain(torch.from_numpy(a), torch.from_numpy(b),
                                DNA_AFFINE)
    _, i, j, _ = fill.best.tolist()
    return [("random", codes, rand_corners),
            ("gap runs", runs, [corner, (192, 256), (191, 255)]),
            ("dna_affine", fill.P.numpy(), [(i, j), (300, 260), (128, 128),
                                            (192, 191)])]


@pytest.mark.parametrize("layout", ["padded", "contiguous", "odd"])
def test_walk_tiled_model_matches_plain(layout):
    for label, P, corners in _walk_ps():
        (_, buf, base, pitch), = [x for x in _p_layouts(P) if x[0] == layout]
        Pt = torch.from_numpy(P)
        for wn, wm in corners:
            want = sf.walk_p_plain(Pt, wn, wm).tolist()
            for lag in range(3):
                assert walk_tiled_model(buf, base, pitch, wn, wm,
                                        lag) == want, (label, wn, wm, lag)


def test_walk_tiled_model_crosses_gap_runs():
    """The UP and LEFT runs keep their state (F_EXT / E_EXT) across tile
    borders: the walk takes the path ``_gap_runs_p`` laid, in every
    layout."""
    P, corner = _gap_runs_p()
    want = "D" * 20 + "U" * 70 + "D" * 10 + "L" * 70 + "D" * 150
    assert "".join("-ULD"[m] for m in sf.walk_p_plain(
        torch.from_numpy(P), *corner).tolist()) == want
    for _, buf, base, pitch in _p_layouts(P):
        moves = walk_tiled_model(buf, base, pitch, *corner)
        assert "".join("-ULD"[m] for m in moves) == want


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (kind, m, n, local, anchored): T=32, so n spans many stripes; ragged n
CARD_BLOCK = [
    ("dna_linear", 300, 9 * 32 + 7, False, False),
    ("dna_linear", 250, 1500, True, False),
    ("dna_linear", 400, 2000, False, True),
    ("dna_affine", 300, 1000 + 5, False, False),
    ("dna_affine", 500, 1200, False, True),
    ("dna_affine", 2, 700, True, False),
    ("protein", 300, 900 + 9, False, False),
    ("protein", 350, 1100, False, True),
    ("protein_linear", 200, 600 + 1, False, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kind, m, n, local, anchored", CARD_BLOCK)
def test_block_kernels_match_plain_on_card(cuda, kind, m, n, local,
                                           anchored):
    a, b, sc, _, S, _ = _case("protein" if kind.startswith("protein")
                              else kind, m=m, n=n + 3, seed=n)
    if kind == "protein_linear":
        sc = Scoring(gap=-6)
    b = b[:n]
    top, left, (tf, le) = _bounds(m, n, m * n, anchored, sc.is_affine)
    t = (lambda x: None if x is None else torch.from_numpy(x).to(cuda))
    args = (t(a), t(b), sc, t(top), t(left), t(tf), t(le))
    plain = sf.stripe_block_plain(*args, local=local, substitution=t(S),
                                  want_bottom=True)
    sf.reset_counts()
    for T in (32, 256):
        got = sf.stripe_block(*args, local=local, substitution=t(S),
                              want_bottom=True, T=T)
        torch.cuda.synchronize()
        for x, y in zip(got, plain):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y), T
    assert sf.launches[sf.block_route_name(sc, S)] == 2
    assert sf.plain_calls["stripe_block_plain"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_walk_kernel_matches_plain_on_card(cuda, kind):
    a, b, sc, _, S, _ = _case(kind, m=700, n=650, seed=11)
    t = (lambda x: None if x is None else torch.from_numpy(x).to(cuda))
    out = sf.stripe_fill(t(a), t(b), sc, substitution=t(S), T=32)
    _, i, j, _ = out.best.tolist()
    n, m = len(b), len(a)
    for corner in ((i, j), (n, m), (0, 5)):
        assert torch.equal(sf.walk_p(out.P, *corner),
                           sf.walk_p_plain(out.P, *corner))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["padded", "contiguous", "odd"])
def test_walk_tiled_kernel_matches_plain_on_card(cuda, layout):
    """sw_walk_p_tiled (the route's walk) and sw_walk_p (the earlier one)
    against the plain walk on the P of ``_walk_ps`` in each layout of
    ``_p_layouts``: corners on tile edges, gap runs across tiles, random
    codes."""
    for label, P, corners in _walk_ps():
        (_, buf, base, pitch), = [x for x in _p_layouts(P)
                                  if x[0] == layout]
        n1, m1 = P.shape
        on_card = torch.from_numpy(buf).to(cuda)
        Pc = on_card[base:base + n1 * pitch].view(n1, pitch)[:, :m1]
        assert Pc.stride(0) == pitch
        for corner in corners:
            want = sf.walk_p_plain(Pc, *corner)
            sf.reset_counts()
            assert torch.equal(sf.walk_p(Pc, *corner), want), (label, corner)
            assert torch.equal(sf._launch_walk(Pc, *corner,
                                               sf.WALK_SCALAR_KERNEL), want)
            assert sf.launches[sf.WALK_KERNEL] == 1
            assert sf.launches[sf.WALK_SCALAR_KERNEL] == 1
        assert bool((on_card[:base] == 0x5A).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_lean_routes_on_card_match_cpu(cuda, kind, monkeypatch):
    a, b, sc, _, S, _ = _case(kind, m=600, n=500, seed=12)
    monkeypatch.setattr(tb, "_BASE_CELLS", 1 << 14)
    for fn in (tb.windowed, tb.hirschberg):
        want = fn(a, b, sc, sub=S, alphabet=ALPHA[kind], device="cpu")
        sf.reset_counts()
        got = fn(a, b, sc, sub=S, alphabet=ALPHA[kind], device=cuda)
        assert got == want
        assert not any(sf.plain_calls.values()), sf.plain_calls
        assert sf.launches[sf.block_route_name(sc, S)] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_width_one_launches_the_kernels_on_card(cuda, kind, monkeypatch):
    # one-column passes launch the kernels on the card, as wider ones do
    a, b, sc, js, S, _ = _one_column(kind, 700, seed=14)
    monkeypatch.setattr(tb, "_BASE_CELLS", 64)
    t = (lambda x: None if x is None else torch.from_numpy(x).to(cuda))
    want = tb.windowed(a, b, sc, sub=S, alphabet=ALPHA[kind], device="cpu")
    want_rows = _row_split(a, b, sc, S, tb, device="cpu")
    sf.reset_counts()
    assert tb.windowed(a, b, sc, sub=S, alphabet=ALPHA[kind],
                       device=cuda) == want
    assert _row_split(a, b, sc, S, tb, device=cuda) == want_rows
    assert not any(sf.plain_calls.values()), sf.plain_calls
    for name in (sf.score_kernel_name(sc, S), sf.fill_kernel_name(sc, S),
                 sf.block_route_name(sc, S), sf.WALK_KERNEL):
        assert sf.launches[name] > 0, name
    # and each wrapper at m = 1 against its plain version
    at, bt, St = t(a), t(b), t(S)
    top, left, (tf, le) = _bounds(1, len(b), 15, False, sc.is_affine)
    pairs = [
        (sf.stripe_score(at, bt, sc, T=32, substitution=St),
         sf.stripe_score_plain(at, bt, sc, St)),
        (sf.stripe_fill(at, bt, sc, T=32, substitution=St),
         sf.stripe_fill_plain(at, bt, sc, St)),
        (sf.stripe_block(at, bt, sc, t(top), t(left), t(tf), t(le),
                         local=False, substitution=St, want_bottom=True,
                         T=32),
         sf.stripe_block_plain(at, bt, sc, t(top), t(left), t(tf), t(le),
                               local=False, substitution=St,
                               want_bottom=True)),
    ]
    for got, plain in pairs:
        for x, y in zip(got, plain):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["windowed", "hirschberg"])
@pytest.mark.parametrize("jsc", [swtpu.Scoring(match=2, mismatch=0, gap=-1),
                                 swtpu.Scoring(gap=0)],
                         ids=["mismatch_0", "gap_0"])
def test_lean_route_answers_refused_scorings_on_card(cuda, method, jsc):
    """A scoring the kernels refuse takes the lean route's plain passes on
    the card, chosen before any launch, and answers as the JAX package."""
    a, b = random_pair(300, 240, seed=17)
    cfg = dict(full_p_max_cells=1000, traceback_method=method)
    want = swtpu.align(a, b, jsc, swtpu.EngineConfig(**cfg))
    sf.reset_counts()
    got = swtpu_torch.align(a, b, Scoring(match=jsc.match,
                                          mismatch=jsc.mismatch, gap=jsc.gap),
                            swtpu_torch.EngineConfig(**cfg), device="cuda")
    fields = ("max_score", "max_i", "max_j", "last_cell", "aligned_a",
              "aligned_b")
    assert [getattr(got, k) for k in fields] == [getattr(want, k)
                                                 for k in fields]
    assert sf.plain_calls["stripe_score_plain"] > 0
    assert not any(sf.launches.values())
