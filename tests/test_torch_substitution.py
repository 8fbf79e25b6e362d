"""Affine gaps and substitution tables: the port against the JAX package.

On the CPU the port's ``scan_fill`` is held against the JAX ``scan_fill``,
its stripe wrappers (which run their plain versions here) against the JAX
Pallas stripe kernel in interpret mode, and ``align``/``score`` against
``swtpu.align``/``swtpu.score``. The DP is integer: every comparison is
exact. The ``gpu`` tests hold the CUDA kernels against their plain versions
and against a numpy oracle on the card, and skip elsewhere."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swtpu
import swtpu_torch
from swtpu.core import oracle
from swtpu.core.encode import PROTEIN_ALPHABET, random_pair
from swtpu.core.substitution import BLOSUM62 as JAX_BLOSUM62
from swtpu.core.substitution import dna_matrix as jax_dna_matrix
from swtpu.core.substitution import embed_sentinels as jax_embed
from swtpu.kernels.pallas_fill import p_stripes_to_rowmajor, stripe_fill_raw
from swtpu.kernels.scan_fill import scan_fill as jax_scan_fill
from swtpu_torch import Scoring
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.core import substitution as port_sub
from swtpu_torch.kernels import stripe_fill as sf
from swtpu_torch.kernels.scan_fill import (NEG, diag_to_rowmajor,
                                           embed_table, scan_fill)

REPO = Path(__file__).resolve().parent.parent

DNA_AFFINE = Scoring(mode="affine")                          # 3/-3, -4/-1
PROTEIN_AFFINE = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
PROTEIN_LINEAR = Scoring(gap=-6)
# the port's table, carried from the JAX package's as numpy
BLOSUM62 = substitution_from_jax(JAX_BLOSUM62)


def _jax_scoring(sc: Scoring) -> swtpu.Scoring:
    return swtpu.Scoring(match=sc.match, mismatch=sc.mismatch, gap=sc.gap,
                         gap_open=sc.gap_open, gap_extend=sc.gap_extend,
                         mode=sc.mode)


def _protein(m, n, seed, letters=20, plant=None):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, letters, m).astype(np.int8)
    b = rng.integers(0, letters, n).astype(np.int8)
    if plant:                       # a shared segment: a long alignment
        i0, j0, ln = plant
        b[i0:i0 + ln] = a[j0:j0 + ln]
    return a, b


def _sentinels(m, n, seed):
    a, b = _protein(m, n, seed)
    a[[3, 10, 11]] = [-1, -2, -3]
    b[[0, 7, 20]] = [-3, -1, -2]
    return a, b


def _t(x, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# ---------------------------------------------------------------- scan_fill

# name -> (pair, scoring, table or None)
SCAN_CASES = {
    "dna_affine": (lambda: random_pair(70, 60, seed=41), DNA_AFFINE, None),
    "dna_affine_ties": (lambda: _protein(80, 65, 42, letters=2),
                        DNA_AFFINE, None),
    "blosum62_linear": (lambda: _protein(50, 70, 43), PROTEIN_LINEAR,
                        BLOSUM62),
    "blosum62_affine": (lambda: _protein(90, 75, 44, plant=(20, 30, 40)),
                        PROTEIN_AFFINE, BLOSUM62),
    "dna_matrix_linear": (lambda: random_pair(60, 45, seed=45), Scoring(),
                          port_sub.dna_matrix()),
    "dna_matrix_affine": (lambda: random_pair(45, 60, seed=46), DNA_AFFINE,
                          port_sub.dna_matrix()),
    "sentinels_affine": (lambda: _sentinels(40, 50, 47), PROTEIN_AFFINE,
                         BLOSUM62),
    "sentinels_linear": (lambda: _sentinels(45, 35, 48), PROTEIN_LINEAR,
                         BLOSUM62),
    "m_is_1_affine": (lambda: _protein(1, 30, 49), PROTEIN_AFFINE, BLOSUM62),
    "n_is_1_affine": (lambda: random_pair(30, 1, seed=50), DNA_AFFINE, None),
    "n_is_1_sub": (lambda: _protein(25, 1, 51), PROTEIN_LINEAR, BLOSUM62),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_fill_new_modes_match_jax(case):
    pair, sc, S = SCAN_CASES[case]
    a, b = pair()
    m, n = len(a), len(b)
    jx = jax_scan_fill(
        jnp.asarray(a), jnp.asarray(b), scoring=_jax_scoring(sc),
        return_p=True, return_h=True,
        sub_table=None if S is None else jnp.asarray(jax_embed(S)))
    pt = scan_fill(_t(a), _t(b), scoring=sc, return_p=True, return_h=True,
                   sub_table=None if S is None else embed_table(_t(S)))
    for name in ("max_score", "max_i", "max_j", "last_cell"):
        assert int(getattr(pt, name)) == int(getattr(jx, name)), name
    for name in ("right_col", "bottom_row", "h_diag"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jx, name)), name)
    P = diag_to_rowmajor(pt.p_diag, n, m).numpy()
    np.testing.assert_array_equal(P, diag_to_rowmajor(
        torch.from_numpy(np.array(jx.p_diag)), n, m).numpy())
    if sc.is_affine:
        assert (P & 12).any(), "no E_EXT/F_EXT state bit was exercised"
    if (a >= 0).all() and (b >= 0).all():
        ref = oracle.fill_loop(a, b, _jax_scoring(sc), sub=S)
        np.testing.assert_array_equal(P, ref.P)
        assert (int(pt.max_i), int(pt.max_j)) == ref.max_ij


@pytest.mark.parametrize("sc", [Scoring(), DNA_AFFINE],
                         ids=["linear", "affine"])
def test_dna_matrix_equals_the_compare_path(sc):
    a, b = random_pair(55, 70, seed=52)
    plain = scan_fill(_t(a), _t(b), scoring=sc, return_p=True)
    table = scan_fill(_t(a), _t(b), scoring=sc, return_p=True,
                      sub_table=embed_table(_t(port_sub.dna_matrix())))
    for x, y in zip(plain, table):
        if x is not None:
            assert torch.equal(x, y)


def test_port_tables_equal_the_jax_tables():
    np.testing.assert_array_equal(port_sub.BLOSUM62, JAX_BLOSUM62)
    np.testing.assert_array_equal(port_sub.dna_matrix(5, -4),
                                  jax_dna_matrix(5, -4))
    np.testing.assert_array_equal(port_sub.embed_sentinels(BLOSUM62),
                                  jax_embed(JAX_BLOSUM62))
    np.testing.assert_array_equal(embed_table(_t(BLOSUM62)).numpy(),
                                  jax_embed(JAX_BLOSUM62))
    assert port_sub.NEG_SUB == -(1 << 20)
    assert swtpu_torch.core.encode.PROTEIN_ALPHABET == PROTEIN_ALPHABET


@pytest.mark.parametrize("bad", [
    ("a", 21), ("a", -4), ("b", 100), ("b", -5)])
def test_codes_outside_the_table_are_refused(bad):
    which, code = bad
    a, b = _protein(40, 30, 53)
    (a if which == "a" else b)[5] = code
    table = embed_table(_t(BLOSUM62))
    with pytest.raises(ValueError, match=r"\[-3, 21\)"):
        scan_fill(_t(a), _t(b), scoring=PROTEIN_AFFINE, sub_table=table)
    for fn in (sf.stripe_score, sf.stripe_fill):
        with pytest.raises(ValueError, match=r"\[-3, 21\)"):
            fn(_t(a), _t(b), PROTEIN_AFFINE, substitution=_t(BLOSUM62))
    with pytest.raises(ValueError, match=r"\[-3, 21\)"):
        swtpu_torch.align(a, b, PROTEIN_AFFINE, substitution=BLOSUM62,
                          device="cpu")


# ------------------------------------------------------- stripe wrappers

# name -> (pair, scoring, table or None); T=128 in the Pallas kernel, so
# n > 128 spans several stripes
STRIPE_CASES = {
    "dna_affine_one_stripe": (lambda: random_pair(60, 100, seed=61),
                              DNA_AFFINE, None),
    "dna_affine_ragged": (lambda: random_pair(50, 300, seed=62),
                          DNA_AFFINE, None),
    "dna_affine_ties": (lambda: _protein(90, 260, 63, letters=2),
                        DNA_AFFINE, None),
    "dna_affine_m_is_2": (lambda: random_pair(2, 140, seed=64),
                          DNA_AFFINE, None),
    "blosum62_linear_ragged": (lambda: _protein(70, 290, 65),
                               PROTEIN_LINEAR, BLOSUM62),
    "blosum62_affine_planted": (lambda: _protein(120, 400, 66,
                                                 plant=(100, 20, 60)),
                                PROTEIN_AFFINE, BLOSUM62),
    "blosum62_affine_ties": (lambda: _protein(100, 270, 67, letters=2),
                             PROTEIN_AFFINE, BLOSUM62),
    "wide_table_linear": (lambda: _protein(64, 150, 68, plant=(20, 5, 50)),
                          Scoring(gap=-40), BLOSUM62 * 20),
}


@pytest.mark.parametrize("case", list(STRIPE_CASES))
def test_stripe_wrappers_new_modes_match_pallas(case):
    pair, sc, S = STRIPE_CASES[case]
    a, b = pair()
    m, n = len(a), len(b)
    jx = stripe_fill_raw(a, b, scoring=_jax_scoring(sc), T=128, C=128,
                         return_p=True, substitution=S)
    want = [int(jx.max_score), int(jx.max_i), int(jx.max_j),
            int(jx.last_cell)]
    sub = None if S is None else _t(S)
    sf.reset_counts()
    score = sf.stripe_score(_t(a), _t(b), sc, substitution=sub)
    fill = sf.stripe_fill(_t(a), _t(b), sc, substitution=sub)
    assert sf.plain_calls == {"stripe_score_plain": 1,
                              "stripe_fill_plain": 1,
                              "stripe_block_plain": 0, "walk_p_plain": 0}
    assert not any(sf.launches.values())
    assert score.best.tolist() == want
    assert fill.best.tolist() == want
    np.testing.assert_array_equal(score.right_col.numpy(), jx.right_col)
    np.testing.assert_array_equal(fill.right_col.numpy(), jx.right_col)
    np.testing.assert_array_equal(
        fill.P.numpy(), p_stripes_to_rowmajor(np.asarray(jx.p_stripes), n, m))


def test_kernel_names_follow_the_scoring():
    assert sf.kernel_name(Scoring(), None, False) == sf.SCORE_KERNEL
    assert sf.kernel_name(Scoring(), None, True) == sf.FILL_P_KERNEL
    assert sf.kernel_name(DNA_AFFINE, None, False) == sf.SCORE_AFFINE_KERNEL
    assert sf.kernel_name(DNA_AFFINE, None, True) == sf.FILL_P_AFFINE_KERNEL
    for sc in (PROTEIN_LINEAR, PROTEIN_AFFINE):
        assert sf.kernel_name(sc, BLOSUM62, False) == sf.SCORE_SUB_KERNEL
        assert sf.kernel_name(sc, BLOSUM62, True) == sf.FILL_P_SUB_KERNEL
    six = ["sw_stripe_score_linear", "sw_stripe_fill_p_linear",
           "sw_stripe_score_affine", "sw_stripe_fill_p_affine",
           "sw_stripe_score_sub", "sw_stripe_fill_p_sub"]
    # each counts its banded launches apart; then the block entries, the
    # two walks and the register-blocked K1-K5 and their band form
    assert sorted(sf.launches) == sorted(
        six + [k + "[band]" for k in six]
        + ["sw_stripe_block_linear", "sw_stripe_block_affine",
           "sw_stripe_block_sub", "sw_walk_p", "sw_walk_p_tiled",
           "sw_stripe_rb_linear", "sw_stripe_rb_affine", "sw_stripe_rb_sub"]
        + [f"sw_stripe_rb_{kind}_{mode}"
           for kind in ("fill_p", "block", "band", "fill_p_band")
           for mode in ("linear", "affine", "sub")])


def test_substitution_gates_take_only_negative_gaps():
    # the JAX package's _sub_gaps_ok: the mismatch does not matter
    assert sf.stripe_fill_supported(50, 50, True, Scoring(mismatch=0),
                                    BLOSUM62)
    assert not sf.stripe_fill_supported(50, 50, True, Scoring(mismatch=0))
    for sc in (Scoring(gap=0), Scoring(mode="affine", gap_extend=0)):
        assert not sf.stripe_fill_supported(50, 50, True, sc, BLOSUM62)
        with pytest.raises(ValueError, match="stripe kernel"):
            sf.stripe_score(*map(_t, _protein(50, 50, 69)), sc,
                            substitution=_t(BLOSUM62))
    assert not sf.stripe_fill_supported(1, 50, True, PROTEIN_AFFINE,
                                        BLOSUM62)


def test_substitution_tables_are_validated():
    a, b = map(_t, _protein(40, 30, 70))
    for bad in (_t(BLOSUM62).to(torch.int64), _t(BLOSUM62[:, :20]),
                _t(BLOSUM62[0])):
        with pytest.raises(ValueError, match="square int32"):
            sf.stripe_score(a, b, PROTEIN_AFFINE, substitution=bad)
    with pytest.raises(ValueError, match="overflow"):
        sf.stripe_score(a, b, PROTEIN_AFFINE,
                        substitution=torch.full((21, 21), 1 << 26,
                                                dtype=torch.int32))


def test_profile_bounds_the_stripe_rows():
    assert sf._stripe_rows(5000, 1024, 21) == 1024     # 86 KB of profile
    assert sf._stripe_rows(5000, 1024, 400) == 128
    with pytest.raises(ValueError, match="shared memory"):
        sf._stripe_rows(5000, 256, 4000)


# ------------------------------------------------------ align and score

def _fields(r):
    return (r.max_score, r.max_i, r.max_j, r.last_cell, r.max_pos,
            r.aligned_a, r.aligned_b, r.path)


ENGINE_CASES = {
    "blosum62_affine": (lambda: _protein(80, 200, 71, plant=(50, 10, 50)),
                        PROTEIN_AFFINE, True),
    "blosum62_linear": (lambda: _protein(90, 150, 72, plant=(30, 40, 35)),
                        PROTEIN_LINEAR, True),
    "dna_affine": (lambda: random_pair(120, 170, seed=73), DNA_AFFINE,
                   False),
}


@pytest.mark.parametrize("plan", [None, "scan", "stripe"])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_align_new_modes_match_jax(case, plan):
    pair, sc, protein = ENGINE_CASES[case]
    a, b = pair()
    js = _jax_scoring(sc)
    kw = dict(alphabet=PROTEIN_ALPHABET) if protein else {}
    want = swtpu.align(a, b, js, substitution=JAX_BLOSUM62 if protein
                       else None, **kw)
    got = swtpu_torch.align(a, b, scoring_from_jax(js), plan=plan,
                            substitution=BLOSUM62 if protein else None,
                            device="cpu", **kw)
    assert _fields(got) == _fields(want)
    assert got.max_score > 0 and len(got.path) > 0
    ref = oracle.fill_loop(a, b, js, sub=JAX_BLOSUM62 if protein else None)
    assert got.max_score == ref.max_score and got.max_pos == ref.max_pos


@pytest.mark.parametrize("plan", ["scan", "stripe"])
def test_align_score_only_new_modes_match_jax(plan):
    a, b = _protein(110, 140, 74, plant=(10, 60, 40))
    js = _jax_scoring(PROTEIN_AFFINE)
    want = swtpu.align(a, b, js, traceback=False, substitution=JAX_BLOSUM62,
                       alphabet=PROTEIN_ALPHABET)
    got = swtpu_torch.align(a, b, PROTEIN_AFFINE, traceback=False,
                            plan=plan, substitution=BLOSUM62,
                            alphabet=PROTEIN_ALPHABET, device="cpu")
    assert _fields(got) == _fields(want)
    assert got.aligned_a is None and got.path is None


def test_return_matrices_affine_substitution_match_jax():
    a, b = _protein(40, 50, 75, plant=(5, 5, 20))
    js = _jax_scoring(PROTEIN_AFFINE)
    want = swtpu.align(a, b, js, return_matrices=True,
                       substitution=JAX_BLOSUM62, alphabet=PROTEIN_ALPHABET)
    got = swtpu_torch.align(a, b, PROTEIN_AFFINE, return_matrices=True,
                            substitution=BLOSUM62, plan="stripe",
                            alphabet=PROTEIN_ALPHABET, device="cpu")
    assert _fields(got) == _fields(want)
    np.testing.assert_array_equal(got.H, want.H)
    np.testing.assert_array_equal(got.P, want.P)


def _skewed_table():
    """A non-symmetric 20x20 table: S[x, y] != S[y, x] for most pairs."""
    rng = np.random.default_rng(76)
    S = rng.integers(-4, 4, (20, 20)).astype(np.int32)
    np.fill_diagonal(S, 6)
    assert (S != S.T).any()
    return S


@pytest.mark.parametrize("sc", [PROTEIN_LINEAR, PROTEIN_AFFINE],
                         ids=["linear", "affine"])
@pytest.mark.parametrize("m, n", [(300, 40), (40, 300)])
def test_score_thin_pairs_transpose_the_table(sc, m, n):
    # m > 2n takes the transposed route in both packages
    S = _skewed_table()
    a, b = _protein(m, n, 77)
    js = _jax_scoring(sc)
    want = swtpu.score(a, b, js, substitution=S)
    assert want == oracle.fill(a, b, js, sub=S).max_score
    if m > n:   # without the transpose the swapped pair scores otherwise
        assert oracle.fill(b, a, js, sub=S).max_score != want
    for plan in (None, "stripe"):
        assert swtpu_torch.score(a, b, sc, plan=plan,
                                 substitution=substitution_from_jax(S),
                                 device="cpu") == want


def rescore(sa: str, sb: str, sc: Scoring, S=None,
            alphabet: str = PROTEIN_ALPHABET) -> int:
    """Re-score aligned strings. A gap run continues only while the gap
    stays in the same sequence: gap_open for its first column, gap_extend
    for each further one (linear: gap for each)."""
    total, run = 0, None
    for x, y in zip(sa, sb):
        side = "a" if x == "-" else "b" if y == "-" else None
        if side is None:
            total += (int(S[alphabet.index(x), alphabet.index(y)])
                      if S is not None else
                      sc.match if x == y else sc.mismatch)
        elif not sc.is_affine:
            total += sc.gap
        else:
            total += sc.gap_extend if run == side else sc.gap_open
        run = side
    return total


def test_rescore_tracks_gap_runs_per_side():
    sc = Scoring(mode="affine", gap_open=-10, gap_extend=-1)
    # a gap in a then a gap in b: two opens, not an open and an extension
    assert rescore("A-C", "AG-", sc, alphabet="ACGT") == 3 - 10 - 10
    assert rescore("A--C", "AGGC", sc, alphabet="ACGT") == 3 - 10 - 1 + 3
    assert rescore("A-", "AG", Scoring(), alphabet="ACGT") == 3 - 2


@pytest.mark.parametrize("seed", range(6))
def test_walked_affine_strings_rescore_to_the_max(seed):
    rng = np.random.default_rng(1000 + seed)
    m, n = (int(v) for v in rng.integers(30, 160, 2))
    protein = seed % 2 == 0
    if protein:
        a, b = _protein(m, n, seed, plant=(0, 0, min(m, n) // 2))
        sc, S, alpha = PROTEIN_AFFINE, BLOSUM62, PROTEIN_ALPHABET
        # scatter gaps into the planted segment so the walk opens gap runs
        b = np.delete(b, [3, 4, 12]) if n > 20 else b
    else:
        a, b = random_pair(m, n, seed=seed)
        sc, S, alpha = DNA_AFFINE, None, "ACGT"
    for plan in ("scan", "stripe"):
        r = swtpu_torch.align(a, b, sc, plan=plan, substitution=S,
                              alphabet=alpha, device="cpu")
        assert r.max_score > 0
        assert rescore(r.aligned_a, r.aligned_b, sc, S, alpha) == \
            r.max_score, (plan, r.aligned_a, r.aligned_b)


# ------------------------------------------------------ convert and CLI

def test_substitution_from_jax_round_trips_blosum62():
    got = substitution_from_jax(JAX_BLOSUM62)
    assert got.dtype == np.int32 and got.shape == (21, 21)
    np.testing.assert_array_equal(got, JAX_BLOSUM62)
    np.testing.assert_array_equal(
        substitution_from_jax(JAX_BLOSUM62.astype(np.int64)), JAX_BLOSUM62)
    np.testing.assert_array_equal(substitution_from_jax(jax_dna_matrix()),
                                  port_sub.dna_matrix())


@pytest.mark.parametrize("table, what", [
    (np.zeros((20, 21), np.int32), "square"),
    (np.zeros(21, np.int32), "square"),
    (np.zeros((4, 4), np.float32), "integer"),
    (np.full((4, 4), (1 << 20) + 1, np.int64), "within"),
    (np.full((4, 4), -(1 << 21), np.int64), "within"),
])
def test_substitution_from_jax_rejects_bad_tables(table, what):
    with pytest.raises(ValueError, match=what):
        substitution_from_jax(table)
    with pytest.raises(ValueError, match=what):
        swtpu_torch.align("ACGT", "ACGT", substitution=table, device="cpu")


def test_cli_blosum62_affine_on_cpu():
    args = ["60", "50", "--blosum62", "--affine", "--gap-open", "-11",
            "--gap-extend", "-1"]
    proc = subprocess.run(
        [sys.executable, "-m", "swtpu_torch", *args, "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rng = np.random.default_rng(0)
    a = rng.integers(0, 20, 60).astype(np.int8)
    b = rng.integers(0, 20, 50).astype(np.int8)
    want = swtpu.align(a, b, _jax_scoring(PROTEIN_AFFINE),
                       substitution=JAX_BLOSUM62, alphabet=PROTEIN_ALPHABET)
    assert (f"Max score {want.max_score} at (i={want.max_i}, "
            f"j={want.max_j})") in proc.stdout
    assert f"  a: {want.aligned_a}\n  b: {want.aligned_b}" in proc.stdout


def test_cli_blosum62_needs_sizes():
    proc = subprocess.run(
        [sys.executable, "-m", "swtpu_torch", "--blosum62", "--device",
         "cpu"], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 2 and "explicit sizes" in proc.stderr


# ------------------------------------------- a numpy oracle for the card

def column_oracle(a, b, sc: Scoring, S=None):
    """(H, P) of the local affine fill by vectorized numpy, one column at a
    time: E from the column to the left, F by a prefix max down the column,
    F(i) = open + ext*(i-1) + max over k < i of X(k) - ext*k, where
    X = max(0, DIAG, E). Exact when gap_open <= gap_extend. Fast enough for
    the card's long shapes, where ``oracle.fill_loop`` is not."""
    m, n = len(a), len(b)
    o, x = sc.gap_open, sc.gap_extend
    emb = port_sub.embed_sentinels(S) if S is not None else None
    H = np.zeros((n + 1, m + 1), np.int64)
    P = np.zeros((n + 1, m + 1), np.int8)
    E = np.full(n, NEG, np.int64)                     # E(1..n, j-1)
    ramp = x * np.arange(n + 1, dtype=np.int64)
    for j in range(1, m + 1):
        if emb is None:
            s = np.where(b == a[j - 1], sc.match, sc.mismatch)
        else:
            s = emb[a[j - 1] + 3, b.astype(np.int64) + 3]
        e = np.maximum(H[1:, j - 1] + o, E + x)
        diag = H[:-1, j - 1] + s
        X = np.concatenate([[0], np.maximum(np.maximum(diag, e), 0)])
        F = np.full(n + 1, NEG, np.int64)
        F[1:] = np.maximum.accumulate(X - ramp)[:-1] + o + ramp[:-1]
        h = np.maximum(X[1:], F[1:])
        code = np.where(diag > 0, 3, 0)
        code = np.where(F[1:] > np.maximum(diag, 0), 1, code)
        code = np.where(e > np.maximum(np.maximum(diag, 0), F[1:]), 2, code)
        code += 4 * (e == E + x) + 8 * (F[1:] == F[:-1] + x)
        H[1:, j], P[1:, j], E = h, code, e
    return H, P


@pytest.mark.parametrize("case", ["dna", "blosum62", "sentinels"])
def test_column_oracle_equals_fill_loop(case):
    if case == "dna":
        (a, b), sc, S = random_pair(40, 70, seed=78), DNA_AFFINE, None
    elif case == "blosum62":
        a, b = _protein(50, 60, 79, plant=(10, 10, 25))
        sc, S = PROTEIN_AFFINE, BLOSUM62
    else:
        (a, b), sc, S = _sentinels(30, 40, 80), PROTEIN_AFFINE, BLOSUM62
    H, P = column_oracle(a, b, sc, S)
    emb = None if S is None else port_sub.embed_sentinels(S)
    ref = oracle.fill_loop(a + 3 if emb is not None else a,
                           b + 3 if emb is not None else b,
                           _jax_scoring(sc), sub=emb)
    np.testing.assert_array_equal(H, ref.H)
    np.testing.assert_array_equal(P, ref.P)


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (kind, m, n, T): kind picks the scoring and the table
CARD_CASES = [
    ("dna_affine", 300, 9 * 256 + 7, 256), ("dna_affine", 500, 90, 32),
    ("dna_affine", 200, 1500, 1024), ("blosum62_affine", 300, 2000, 256),
    ("blosum62_affine", 400, 2600, 1024), ("blosum62_linear", 250, 700, 32),
    ("blosum62_linear", 300, 2100, 1024), ("two_letter_affine", 2, 700, 32),
]


def _card_pair(kind, m, n, dev):
    seed = m * 7 + n
    if kind == "dna_affine":
        a, b = random_pair(m, n, seed=seed)
        sc, S = DNA_AFFINE, None
    elif kind == "two_letter_affine":
        (a, b), sc, S = _protein(m, n, seed, letters=2), PROTEIN_AFFINE, \
            BLOSUM62
    else:
        a, b = _protein(m, n, seed, plant=(n // 3, m // 4, m // 2))
        a[[1, 7]], b[[2, 9]] = -1, -2             # sentinels in both
        sc = PROTEIN_AFFINE if kind.endswith("affine") else PROTEIN_LINEAR
        S = BLOSUM62
    return (_t(a, dev), _t(b, dev), sc,
            None if S is None else _t(S, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("kind, m, n, T", CARD_CASES)
def test_new_kernels_match_plain_on_card(cuda, kind, m, n, T):
    a, b, sc, S = _card_pair(kind, m, n, cuda)
    plain_s = sf.stripe_score_plain(a, b, sc, S)
    plain_f = sf.stripe_fill_plain(a, b, sc, S)
    sf.reset_counts()
    for _ in range(3):          # ordering races show as run-to-run changes
        # score-only runs the register-blocked K2/K3 (at most RB_MAX_THREADS
        # threads); the template's K2/K3 at T through the private launcher
        got_s = sf.stripe_score(a, b, sc, T=min(T, sf.RB_MAX_THREADS),
                                substitution=S)
        got_t = sf._launch(a, b, sc, T, S, False, None)
        # fill_p runs the register-blocked K4 (at most RB_MAX_THREADS
        # threads); the template's K4 at T through the private launcher
        got_f = sf.stripe_fill(a, b, sc, T=min(T, sf.RB_MAX_THREADS),
                               substitution=S)
        got_tf = sf._launch(a, b, sc, T, S, True, None)
        torch.cuda.synchronize()
        for got in (got_s, got_t):
            assert torch.equal(got.best, plain_s.best)
            assert torch.equal(got.right_col, plain_s.right_col)
        for got in (got_f, got_tf):
            assert torch.equal(got.best, plain_s.best)
            assert torch.equal(got.right_col, plain_s.right_col)
            assert torch.equal(got.P, plain_f.P)
    assert sf.launches[sf.score_kernel_name(sc, S)] == 3
    assert sf.launches[sf.kernel_name(sc, S, False)] == 3
    assert sf.launches[sf.fill_kernel_name(sc, S)] == 3
    assert sf.launches[sf.kernel_name(sc, S, True)] == 3
    assert not any(sf.plain_calls.values())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dna_affine", "blosum62_affine"])
def test_affine_more_stripes_than_resident_blocks(cuda, kind):
    # 4401 stripes of 32 rows: more blocks than an H100 holds at once, so
    # the F boundary row is handed across many stripes and late blocks
    m, n = 48, 32 * 4400 + 5
    if kind == "dna_affine":
        (a, b), sc, S = random_pair(m, n, seed=81), DNA_AFFINE, None
    else:
        (a, b), sc, S = _protein(m, n, 82), PROTEIN_AFFINE, BLOSUM62
    H, P = column_oracle(a, b, sc, S)
    flat = int(np.argmax(H))
    want = [int(H.flat[flat]), *divmod(flat, m + 1), int(H[n, m])]
    sub = None if S is None else _t(S, cuda)
    got_s = sf.stripe_score(_t(a, cuda), _t(b, cuda), sc, T=32,
                            substitution=sub)
    got_f = sf.stripe_fill(_t(a, cuda), _t(b, cuda), sc, T=32,
                           substitution=sub)
    assert got_s.best.tolist() == want
    assert got_f.best.tolist() == want
    np.testing.assert_array_equal(got_s.right_col.cpu().numpy(), H[:, m])
    np.testing.assert_array_equal(got_f.P.cpu().numpy(), P)
