"""The port's stripe sanitizer (K9's capture and its checks) against the
JAX package's on the CPU, exact equality; K9 against its plain capture on
a card.

The JAX sanitizer runs as tests/test_sanitize.py runs it, in interpret
mode, at the same sizes. CUDA kernels run only on a card: the ``gpu``
tests hold them against their plain versions there and skip elsewhere.
"""

import re

import numpy as np
import pytest
import torch

import swtpu.__main__ as jmain
from swtpu import Scoring as JScoring
from swtpu.core import oracle as joracle
from swtpu.core.encode import random_batch, random_pair
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.instrument import sanitize as jsan

import swtpu_torch
import swtpu_torch.__main__ as tmain
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.core import oracle as toracle
from swtpu_torch.instrument import sanitize as tsan
from swtpu_torch.kernels import debug_fill as df
from swtpu_torch.kernels import pairs_fill as pf

LINEAR = JScoring()
DNA_AFFINE = JScoring(mode="affine", gap_open=-4, gap_extend=-1)
PROT_AFFINE = JScoring(mode="affine", gap_open=-11, gap_extend=-1)


def _protein(m, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 20, m).astype(np.int8)
    b = rng.integers(0, 20, n).astype(np.int8)
    k = min(m - 10, n - 40, 50)
    b[40:40 + k] = a[10:10 + k]
    return a, b


def _pairs(protein, B, m, n, seed):
    """B pairs of one shape, DNA or 20-letter protein codes."""
    if not protein:
        return random_batch(B, m, n, seed=seed)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 20, (B, m)).astype(np.int8),
            rng.integers(0, 20, (B, n)).astype(np.int8))


def _x50():
    """tests/test_sanitize.py's table beyond int8: scores x 50."""
    rng = np.random.default_rng(8)
    S = (rng.integers(-5, 6, (6, 6)) * 50).astype(np.int32)
    np.fill_diagonal(S, 200)
    a = rng.integers(0, 6, 60).astype(np.int8)
    b = rng.integers(0, 6, 256).astype(np.int8)
    return a, b, S


def _tab(S):
    return None if S is None else substitution_from_jax(np.asarray(S))


# id -> (a, b, JAX scoring, table, JAX sanitizer kwargs, the port's T):
# tests/test_sanitize.py's clean passes; the JAX "champion" configuration
# (T=4096, R=32, CB=4) runs the port at its widest stripe, T=1024
CLEAN = {
    "multistripe": lambda: (*random_pair(150, 300, seed=0), LINEAR, None,
                            dict(T=128, R=1, CB=1), 128),
    "blocked": lambda: (*random_pair(100, 512, seed=1), LINEAR, None,
                        dict(T=256, R=2, CB=2), None),
    "affine": lambda: (*random_pair(80, 256, seed=2),
                       JScoring(mode="affine", gap_open=-5, gap_extend=-1),
                       None, dict(T=128, R=1), 128),
    "blosum62_linear": lambda: (*_protein(70, 300, 8), JScoring(gap=-4),
                                J_BLOSUM62, dict(T=256, R=2), None),
    "blosum62_affine": lambda: (*_protein(70, 300, 8), PROT_AFFINE,
                                J_BLOSUM62, dict(T=256, R=2), None),
    "table_x50": lambda: (*_x50()[:2], JScoring(gap=-60), _x50()[2],
                          dict(T=256, R=2), None),
    "champion": lambda: (*random_pair(90, 8192, seed=5), LINEAR, None,
                         dict(T=4096, R=32, CB=4), 1024),
}


def _cell_map(h: np.ndarray, m: int, n: int) -> tuple:
    """(i, j, in-matrix) of every slot (s, t, k) of a capture."""
    s, t, k = np.indices(h.shape)
    i, j = s * h.shape[2] + k + 1, t - k + 1
    return i, j, (j >= 1) & (j <= m) & (i <= n)


@pytest.mark.parametrize("case", list(CLEAN))
def test_clean_pass_matches_jax(case):
    a, b, jsc, jsub, jkw, T = CLEAN[case]()
    want = jsan.sanitize_stripe(a, b, scoring=jsc, substitution=jsub, **jkw)
    got = tsan.sanitize_stripe(a, b, scoring_from_jax(jsc), T=T,
                               substitution=_tab(jsub), device="cpu")
    assert got.valid_cells == want.valid_cells == len(a) * len(b)
    assert got.prestart_cells > 0 and got.garbage_cells > 0
    T_, R_, C_, stripes = got.config
    assert stripes == -(-len(b) // (T_ * R_))
    cap = df.stripe_capture_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  scoring_from_jax(jsc), T_,
                                  None if jsub is None
                                  else torch.from_numpy(_tab(jsub)))
    h = cap.h.numpy()
    i, j, valid = _cell_map(h, len(a), len(b))
    H = joracle.fill(a, b, jsc, sub=jsub).H
    assert (h[valid] == H[i[valid], j[valid]]).all()


@pytest.mark.parametrize("name", ["linear", "dna_affine", "blosum62"])
def test_plain_capture_maps_onto_the_jax_oracle(name):
    jsc, jsub = {"linear": (LINEAR, None), "dna_affine": (DNA_AFFINE, None),
                 "blosum62": (PROT_AFFINE, J_BLOSUM62)}[name]
    a, b = (_protein(60, 150, 3) if jsub is not None
            else random_pair(60, 150, seed=3))
    H = joracle.fill(a, b, jsc, sub=jsub).H
    cap = df.stripe_capture_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  scoring_from_jax(jsc), 64,
                                  None if jsub is None
                                  else torch.from_numpy(_tab(jsub)))
    h = cap.h.numpy()
    i, j, valid = _cell_map(h, len(a), len(b))
    assert valid.sum() == len(a) * len(b)
    assert (h[valid] == H[i[valid], j[valid]]).all()
    assert (h[~valid & (h != df.UNSCHEDULED)] == 0).all()
    # the last stripe (22 rows) leaves its steps past m + 22 - 1 unscheduled
    assert (h[2, len(a) + 21:] == df.UNSCHEDULED).all()
    assert (cap.seen[0] == -1).all() and (cap.seen[1:, 0] == -1).all()
    assert (cap.seen[1:, 1:] == len(a)).all()
    assert cap.scores.tolist() == [H.max()]
    # packed: each pair's rows, rebased, hold that pair's H
    aa, bb = _pairs(jsub is not None, 5, 30, 40, 4)
    cap = df.packed_capture_plain(torch.from_numpy(aa), torch.from_numpy(bb),
                                  scoring_from_jax(jsc), 64,
                                  None if jsub is None
                                  else torch.from_numpy(_tab(jsub)))
    h = cap.h.numpy()
    i, j, valid = _cell_map(h, 30, 5 * 40)
    Hs = np.stack([joracle.fill(x, y, jsc, sub=jsub).H
                   for x, y in zip(aa, bb)])
    g, r = (i - 1) // 40, (i - 1) % 40 + 1
    assert (h[valid] == Hs[g[valid], r[valid], j[valid]]).all()
    assert (h[~valid & (h != df.UNSCHEDULED)] == 0).all()
    assert cap.scores.tolist() == Hs.max(axis=(1, 2)).tolist()


def test_positive_mismatch_scoring_is_refused():
    a, b = random_pair(64, 64, seed=4)
    with pytest.raises(ValueError, match="negative"):
        jsan.sanitize_stripe(a, b, scoring=JScoring(mismatch=1))
    with pytest.raises(ValueError, match="negative"):
        tsan.sanitize_stripe(a, b, swtpu_torch.Scoring(mismatch=1),
                             device="cpu")


def test_skewed_hand_off_is_caught():
    """The test hook reads boundary column j - 1: wrong cells in every
    stripe below the first, caught as a violated invariant."""
    a, b = random_pair(150, 300, seed=3)            # 3 stripes at T=128
    tsan.sanitize_stripe(a, b, T=128, device="cpu")
    with pytest.raises(tsan.SanitizeError, match="!= oracle"):
        tsan.sanitize_stripe(a, b, T=128, device="cpu", skew=1)
    # K7's packed form at (128, 8, 4): each pair 2 stripes of its own
    aa, bb = random_batch(4, 40, 1100, seed=7)
    rep = tsan.sanitize_pairs_packed(aa, bb, device="cpu")
    assert rep.config == (128, 8, 4, 8)
    with pytest.raises(tsan.SanitizeError, match="!= oracle"):
        tsan.sanitize_pairs_packed(aa, bb, device="cpu", skew=1)


# tests/test_sanitize.py's packed cases: row padding, stripe-straddling
# pairs, affine and the BLOSUM62 profile
PACKED = {
    "linear": lambda: (*random_batch(9, 40, 5, seed=3), LINEAR, None),
    "affine": lambda: (*random_batch(4, 30, 17, seed=5), DNA_AFFINE, None),
    "blosum62": lambda: (*_pairs(True, 3, 24, 10, 9), PROT_AFFINE,
                         J_BLOSUM62),
}


@pytest.mark.parametrize("case", list(PACKED))
def test_packed_pairs_match_jax(case):
    aa, bb, jsc, jsub = PACKED[case]()
    want = jsan.sanitize_pairs_packed(aa, bb, jsc, T=256, R=2,
                                      substitution=jsub)
    got = tsan.sanitize_pairs_packed(aa, bb, scoring_from_jax(jsc),
                                     substitution=_tab(jsub), device="cpu")
    assert got.valid_cells == want.valid_cells == aa.size * bb.shape[1]


# hand corruptions of a clean capture of 150 x 300 at T=128 (3 stripes,
# the last of 44 rows), each caught by the named check
def _corrupt(cap, m, what):
    h, seen, scores = cap.h, cap.seen, cap.scores
    if what == "pre-start":
        h[1, 0, 5] = 7                  # step 0, thread 5: column -4
    elif what == "in-matrix":
        h[1, 10, 3] += 1                # cell (132, 8)
    elif what == "post-finish":
        h[0, m + 3, 0] = 1              # thread 0 at column m + 4
    elif what == "idle-row":
        h[2, 120, 100] = 3              # thread 100 of a 44-row stripe
    elif what == "hand-off":
        seen[1, 40] = 39                # read column 40 having seen 39
    elif what == "no-reader":
        seen[0, 5] = 5                  # stripe 0 reads no boundary
    elif what == "unscheduled":
        h[2, m + 45, 0] = 0             # past the last stripe's m + 43
    elif what == "kernel-max":
        scores[0] += 1


@pytest.mark.parametrize("what, match", [
    ("pre-start", "pre-start slot"), ("in-matrix", "!= oracle"),
    ("post-finish", "post-finish"), ("idle-row", "idle-row"),
    ("hand-off", "hand-off: stripe 1 read column 40"),
    ("no-reader", "reads no boundary"), ("unscheduled", "unscheduled"),
    ("kernel-max", "kernel max")])
def test_checks_catch_a_corrupted_capture(what, match):
    a, b = random_pair(150, 300, seed=0)
    ref = toracle.fill(a, b)
    cap = df.stripe_capture_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  T=128)
    assert tsan.check_capture(cap, [ref.H], [ref.max_score]).valid_cells \
        == 150 * 300
    _corrupt(cap, 150, what)
    with pytest.raises(tsan.SanitizeError, match=match):
        tsan.check_capture(cap, [ref.H], [ref.max_score])


def test_sentinel_codes_pass_with_a_table():
    """Codes -3..-1 score NEG_SUB in the kernels; the oracle reads them
    through the sentinel-embedded table, so a padded pair passes."""
    a, b = _protein(70, 300, 2)
    a[[0, 33]], b[[7, 120, 299]] = -1, -3
    b[200] = -2
    rep = tsan.sanitize_stripe(a, b, scoring_from_jax(PROT_AFFINE), T=64,
                               substitution=_tab(J_BLOSUM62), device="cpu")
    assert rep.valid_cells == 70 * 300


def test_capture_size_and_skew_are_checked():
    with pytest.raises(ValueError, match="debug shapes"):
        tsan.sanitize_stripe(np.zeros(1 << 20, np.int8),
                             np.zeros(1024, np.int8), T=1024, device="cpu")
    a, b = (torch.from_numpy(x) for x in random_pair(40, 70, seed=1))
    with pytest.raises(ValueError, match="skew"):
        df.stripe_capture(a, b, skew=-1)


def test_counters_and_names():
    sc, aff = swtpu_torch.Scoring(), swtpu_torch.Scoring(mode="affine")
    S = torch.zeros((4, 4), dtype=torch.int32)
    assert df.debug_kernel_name(sc, None, False) == "sw_sanitize_stripe_linear"
    assert df.debug_kernel_name(aff, S, False) == "sw_sanitize_stripe_sub"
    assert df.debug_kernel_name(aff, None, True) == "sw_sanitize_packed_affine"
    assert sorted(df.launches) == sorted(df.DEBUG_KERNELS.values())
    a, b = (torch.from_numpy(x) for x in random_pair(40, 70, seed=1))
    pf.reset_counts()
    df.stripe_capture(a, b)
    df.packed_capture(a[None], b[None])
    assert df.plain_calls == {"stripe_capture_plain": 1,
                              "packed_capture_plain": 1}
    assert not any(df.launches.values())
    pf.reset_counts()
    assert not any(df.plain_calls.values())


@pytest.mark.parametrize("name", ["open_above_extend", "dna_affine",
                                  "blosum62"])
def test_port_oracle_affine_sweep_equals_the_jax_loop(name):
    """The port's oracle sweeps anti-diagonals in affine mode where the JAX
    oracle loops cell by cell: H, P (state bits included), E, F and the
    first max agree, for either order of gap_open and gap_extend."""
    jsc, jsub = {"open_above_extend": (JScoring(mode="affine", gap_open=-1,
                                                gap_extend=-3), None),
                 "dna_affine": (DNA_AFFINE, None),
                 "blosum62": (PROT_AFFINE, J_BLOSUM62)}[name]
    for m, n, seed in ((1, 1, 0), (1, 9, 1), (9, 1, 2), (47, 61, 3)):
        a, b = (_protein(max(m, 60), max(n, 60), seed) if jsub is not None
                else random_pair(m, n, seed=seed))
        a, b = a[:m], b[:n]
        want = joracle.fill_loop(a, b, jsc, sub=jsub)
        got = toracle.fill(a, b, scoring_from_jax(jsc), sub=_tab(jsub))
        for f in ("H", "P", "E", "F"):
            assert (getattr(got, f) == getattr(want, f)).all(), (f, m, n)
        assert got.max_pos == want.max_pos


@pytest.mark.parametrize("args", [[], ["60", "50", "--blosum62", "--affine"]],
                         ids=["builtin", "blosum62_affine"])
def test_cli_sanitize_matches_jax(capsys, args):
    assert jmain.main(args + ["--sanitize"]) == 0
    jout = capsys.readouterr().out
    assert tmain.main(args + ["--sanitize", "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    pat = r"Sanitizer: OK — (\d+) cells bit-checked, \d+ pre-start, \d+ " \
          r"garbage slots verified"
    assert re.search(pat, tout).group(1) == re.search(pat, jout).group(1)
    line = re.compile(r"^Max score .*$", re.M)
    assert line.search(tout).group(0) == line.search(jout).group(0)


# ---- on a card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_case(name, dev):
    jsc, jsub = {"linear": (LINEAR, None), "dna_affine": (DNA_AFFINE, None),
                 "blosum62": (PROT_AFFINE, J_BLOSUM62)}[name]
    S = None if jsub is None else torch.from_numpy(_tab(jsub)).to(dev)
    return scoring_from_jax(jsc), S


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["linear", "dna_affine", "blosum62"])
@pytest.mark.parametrize("T", [32, 128])
def test_k9_matches_its_plain_capture_on_card(cuda, name, T):
    sc, S = _card_case(name, cuda)
    a, b = (_protein(300, 1290, 1) if S is not None
            else random_pair(300, 1290, seed=1))
    at, bt = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    p = df.stripe_capture_plain(at, bt, sc, T, S)
    for _ in range(3):          # ordering races show as run-to-run changes
        assert df.same_capture(df.stripe_capture(at, bt, sc, T, S), p) == 0
    aa, bb = _pairs(S is not None, 7, 150, 45, 2)
    at, bt = torch.from_numpy(aa).to(cuda), torch.from_numpy(bb).to(cuda)
    assert df.same_capture(df.packed_capture(at, bt, sc, T, S),
                           df.packed_capture_plain(at, bt, sc, T, S)) == 0


@pytest.mark.gpu
def test_skew_is_caught_on_card(cuda):
    a, b = random_pair(300, 1290, seed=1)
    at, bt = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    k = df.stripe_capture(at, bt, T=128, skew=1)
    p = df.stripe_capture_plain(at, bt, T=128, skew=1)
    assert df.same_capture(k, p, skewed=True) == 0
    with pytest.raises(tsan.SanitizeError):
        tsan.sanitize_stripe(a, b, T=128, skew=1)
    aa, bb = random_batch(4, 40, 1100, seed=7)     # pairs across stripes
    with pytest.raises(tsan.SanitizeError):
        tsan.sanitize_pairs_packed(aa, bb, skew=1)


@pytest.mark.gpu
def test_sanitize_launches_k9_on_card(cuda):
    a, b = random_pair(200, 700, seed=5)
    pf.reset_counts()
    rep = swtpu_torch.sanitize(a, b)
    assert rep.valid_cells == 200 * 700
    aa, bb = random_batch(6, 60, 90, seed=6)
    assert tsan.sanitize_pairs_packed(aa, bb).valid_cells == 6 * 60 * 90
    assert df.rb_launches["sw_sanitize_rb_linear"] == 1
    assert df.launches["sw_sanitize_stripe_linear"] == 0
    # sanitize_pairs_packed captures K7's packed form, not the template's
    assert df.packed_rb_launches["sw_sanitize_packed_rb_linear"] == 1
    assert df.launches["sw_sanitize_packed_linear"] == 0
    assert not any(df.plain_calls.values())
    assert not any(df.rb_plain_calls.values())
    assert not any(df.packed_rb_plain_calls.values())
