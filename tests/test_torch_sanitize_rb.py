"""The sanitizer's capture on the register-blocked stripe (K9 on the card)
against the JAX package, on the CPU.

The CUDA kernel (``swtpu_torch/csrc/stripe_rb_debug.cu``, the kDebugH form
of ``stripe_rb_kernel``) runs only on a card. Here ``rb_model(capture=)``
(tests/test_torch_stripe_rb.py), the Python model of the register-blocked
stripe's schedule, produces the R x C capture a step at a time: each
thread's tile of H, 0 outside the matrix (rows past n included), the
progress each boundary read saw, and, under the test hook ``skew``, the
shifted boundary row. It must equal the port's plain version
``stripe_rb_capture_plain`` slot for slot, and both map, through
``debug_fill.slot_cells``, onto the JAX package's oracle H cell by cell;
``sanitize_stripe``'s valid cells equal the JAX sanitizer's in every clean
case of tests/test_torch_sanitize.py. Tolerance: exact equality (integer
DP). The ``gpu`` tests hold the kernel against its plain version on a card
and skip elsewhere."""

import numpy as np
import pytest
import torch

from swtpu.core import oracle as joracle
from swtpu.core.config import Scoring as JScoring
from swtpu.core.encode import random_pair
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.instrument import sanitize as jsan
import swtpu_torch
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.instrument import sanitize as tsan
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import debug_fill as df
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf

from test_torch_sanitize import CLEAN
from test_torch_stripe_rb import _oracle_table, _sentinels, rb_model

BLOSUM62 = substitution_from_jax(np.asarray(J_BLOSUM62))
SCORINGS = {
    "linear": (JScoring(), None),
    "dna_affine": (JScoring(mode="affine", gap_open=-4, gap_extend=-1), None),
    "blosum62": (JScoring(mode="affine", gap_open=-11, gap_extend=-1),
                 J_BLOSUM62),
    "blosum62_linear": (JScoring(gap=-6), J_BLOSUM62),
}


def _pair(name, m, n, seed):
    """A pair of the scoring's alphabet, with a shared segment."""
    rng = np.random.default_rng(seed)
    A = 20 if name.startswith("blosum62") else 4
    a = rng.integers(0, A, m).astype(np.int8)
    b = rng.integers(0, A, n).astype(np.int8)
    k = min(m, n) // 2
    b[n // 4:n // 4 + k] = a[:k]
    return a, b


def _port(name):
    jsc, jsub = SCORINGS[name]
    return scoring_from_jax(jsc), (None if jsub is None
                                   else substitution_from_jax(jsub))


def _table(sub):
    return None if sub is None else torch.from_numpy(sub)


def _oracle_H(a, b, name):
    """The JAX oracle's H; sentinel codes through kNegSub rows and columns
    of the table."""
    jsc, jsub = SCORINGS[name]
    return joracle.fill(a, b, jsc, None if jsub is None
                        else _oracle_table(BLOSUM62)).H


def _maps_onto(cap, H):
    """Every slot of the capture against H through slot_cells: the cell's H
    inside the matrix, 0 outside it, UNSCHEDULED only past a stripe's
    steps; returns the number of in-matrix slots."""
    n, m = H.shape[0] - 1, H.shape[1] - 1
    h = cap.h.numpy()
    i, j = (np.broadcast_to(x.numpy(), h.shape)
            for x in df.slot_cells(*h.shape[:3], cap.R, cap.C))
    inside = (j >= 1) & (j <= m) & (i <= n)
    assert (h[inside] == H[i[inside], j[inside]]).all()
    assert ((h[~inside] == 0) | (h[~inside] == df.UNSCHEDULED)).all()
    assert (h[inside] != df.UNSCHEDULED).all()
    return int(inside.sum())


# (scoring, m, n, T, R, C): both capture tiles (RB_DEBUG_TILES), m not a
# multiple of C, n not a multiple of T*R, one and several stripes, two
# warps, n < 32, m = 1, sentinels
CAPTURES = {
    "linear_8x4_three_stripes": ("linear", 75, 600, 32, 8, 4),
    "linear_4x4_ragged": ("linear", 70, 300, 32, 4, 4),
    "linear_4x4_two_warps": ("linear", 45, 700, 64, 4, 4),
    "linear_8x4_n_below_32": ("linear", 50, 20, 32, 8, 4),
    "linear_8x4_m_is_1": ("linear", 1, 300, 32, 8, 4),
    "dna_affine_8x4": ("dna_affine", 70, 530, 32, 8, 4),
    "dna_affine_4x4_two_warps": ("dna_affine", 37, 600, 64, 4, 4),
    "blosum62_8x4": ("blosum62", 66, 520, 32, 8, 4),
    "blosum62_4x4_sentinels": ("blosum62", 60, 290, 32, 4, 4),
    "blosum62_linear_4x4": ("blosum62_linear", 50, 270, 32, 4, 4),
}


@pytest.mark.parametrize("case", list(CAPTURES))
def test_capture_model_matches_plain_and_the_jax_oracle(case):
    name, m, n, T, R, C = CAPTURES[case]
    a, b = _pair(name, m, n, sum(map(ord, case)))
    if "sentinels" in case:
        a, b = _sentinels((a, b), 7)
    sc, sub = _port(name)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    T, R, C = df.rb_capture_shape(bt, sc, _table(sub), T, R, C)
    model = {}
    best, _ = rb_model(a, b, sc, T, R, C, sub, capture=model)
    cap = df.stripe_rb_capture_plain(at, bt, sc, T, R, C, _table(sub))
    assert (cap.T, cap.R, cap.C) == (T, R, C)
    np.testing.assert_array_equal(cap.h.numpy(), model["h"])
    np.testing.assert_array_equal(cap.seen.numpy(), model["seen"])
    assert cap.scores.tolist() == [best[0]]
    H = _oracle_H(a, b, name)
    assert _maps_onto(cap, H) == m * n
    assert cap.scores.tolist() == [H.max()]
    tsan.check_capture(cap, [H], [H.max()])


@pytest.mark.parametrize("case", list(CLEAN))
def test_clean_cases_match_the_jax_sanitizer(case):
    """sanitize_stripe's valid cells equal the JAX sanitizer's; its config
    names score()'s tile, and the capture at that tile maps onto the JAX
    oracle's H."""
    a, b, jsc, jsub, jkw, T = CLEAN[case]()
    want = jsan.sanitize_stripe(a, b, scoring=jsc, substitution=jsub, **jkw)
    sc = scoring_from_jax(jsc)
    sub = None if jsub is None else substitution_from_jax(np.asarray(jsub))
    got = tsan.sanitize_stripe(a, b, sc, T=T, substitution=sub,
                               device="cpu")
    assert got.valid_cells == want.valid_cells == len(a) * len(b)
    T_, R, C, stripes = got.config
    assert (R, C) == sf.RB_DEFAULTS[sf._mode(sc, sub)][1:]
    assert stripes == -(-len(b) // (T_ * R))
    cap = df.stripe_rb_capture_plain(torch.from_numpy(a), torch.from_numpy(b),
                                     sc, T_, R, C, _table(sub))
    H = joracle.fill(a, b, jsc, sub=jsub).H
    assert _maps_onto(cap, H) == len(a) * len(b)


@pytest.mark.parametrize("name", ["linear", "dna_affine", "blosum62"])
def test_default_capture_is_what_score_runs(name):
    """With no T the capture runs score()'s (T, R, C) for the scoring and
    shape: 2100 rows, three stripes of 1024 at (128, 8, 4)."""
    sc, sub = _port(name)
    a, b = _pair(name, 40, 2100, 3)
    rep = tsan.sanitize_stripe(a, b, sc, substitution=sub, device="cpu")
    mode = sf._mode(sc, sub)
    T, R, C = sf.rb_shape(2100, mode=mode, A=0 if sub is None else 21)
    assert (T, R, C) == sf.RB_DEFAULTS[mode]
    assert rep.config == (T, R, C, 3)
    assert rep.valid_cells == 40 * 2100


# hand corruptions of a clean capture of 70 x 298 at (32, 4, 4): stripes of
# 128 rows, the last of 42 (11 threads, the last holding rows 297 .. 300,
# two past n; 28 steps), 18 tiles, the last holding columns 69 and 70 only;
# each caught by the named check
def _corrupt(cap, what):
    h, seen, scores = cap.h, cap.seen, cap.scores
    if what == "pre-start":
        h[1, 0, 5, 2, 1] = 7            # step 0, thread 5: its tile -5
    elif what == "tile-slot":
        h[1, 10, 3, 2, 1] += 1          # cell (128 + 15, 30)
    elif what == "past-m":
        h[0, 17 + 4, 4, 0, 2] = 1       # thread 4's last tile, column 71
    elif what == "past-n":
        h[2, 20, 10, 2, 0] = 3          # thread 10, row 299
    elif what == "idle-thread":
        h[2, 20, 20, 0, 0] = 3          # thread 20 of an 11-thread stripe
    elif what == "hand-off":
        seen[1, 40] = 39                # read column 40 having seen 39
    elif what == "no-reader":
        seen[0, 5] = 5                  # stripe 0 reads no boundary
    elif what == "unscheduled":
        h[2, 28, 0, 0, 0] = 0           # past the last stripe's 28 steps
    elif what == "kernel-max":
        scores[0] += 1


@pytest.mark.parametrize("what, match", [
    ("pre-start", "pre-start slot"), ("tile-slot", "!= oracle"),
    ("past-m", "post-finish"), ("past-n", "idle-row"),
    ("idle-thread", "idle-row"),
    ("hand-off", "hand-off: stripe 1 read column 40"),
    ("no-reader", "reads no boundary"), ("unscheduled", "unscheduled"),
    ("kernel-max", "kernel max")])
def test_checks_catch_a_corrupted_tile_capture(what, match):
    a, b = random_pair(70, 298, seed=0)
    H = joracle.fill(a, b).H
    cap = df.stripe_rb_capture_plain(torch.from_numpy(a), torch.from_numpy(b),
                                     T=32, R=4, C=4)
    assert cap.h.shape == (3, 18 + 31, 32, 4, 4)
    assert tsan.check_capture(cap, [H], [H.max()]).valid_cells == 70 * 298
    _corrupt(cap, what)
    with pytest.raises(tsan.SanitizeError, match=match):
        tsan.check_capture(cap, [H], [H.max()])


@pytest.mark.parametrize("name", ["linear", "dna_affine", "blosum62"])
def test_skewed_hand_off_is_caught(name):
    """The test hook reads boundary column j - 1: the model and the plain
    capture agree on the wrong cells, and the checks reject them."""
    sc, sub = _port(name)
    a, b = _pair(name, 70, 300, 5)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    model = {"skew": 1}
    rb_model(a, b, sc, 32, 4, 4, sub, capture=model)
    cap = df.stripe_rb_capture_plain(at, bt, sc, 32, 4, 4, _table(sub),
                                     skew=1)
    np.testing.assert_array_equal(cap.h.numpy(), model["h"])
    np.testing.assert_array_equal(cap.seen.numpy(), model["seen"])
    H = _oracle_H(a, b, name)
    with pytest.raises(tsan.SanitizeError, match="!= oracle"):
        tsan.check_capture(cap, [H], [H.max()])
    with pytest.raises(tsan.SanitizeError, match="!= oracle"):
        tsan.sanitize_stripe(a, b, sc, T=128, substitution=sub,
                             device="cpu", skew=1)


def test_capture_launches_the_rb_entry_at_score_s_tile(monkeypatch):
    """On a card (the launch recorded instead of run) the capture launches
    the form's sw_sanitize_rb_* entry with the arguments its ctypes
    signature declares, at the (T, R, C) stripe_score launches for the same
    input, and no template K9 entry."""
    seen = []
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call", lambda nm, dev, args, *rest:
                        seen.append((nm, args)))
    for name in ("linear", "dna_affine", "blosum62", "blosum62_linear"):
        sc, sub = _port(name)
        a, b = _pair(name, 50, 3000, 8)
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        seen.clear()
        sf.stripe_score(at, bt, sc, substitution=_table(sub))
        df.stripe_rb_capture(at, bt, sc, substitution=_table(sub))
        (score_name, score_args), (name_k9, args) = seen
        mode = sf._mode(sc, sub)
        assert name_k9 == df.RB_DEBUG_KERNELS[mode] == \
            df.rb_debug_kernel_name(sc, sub)
        assert len(args) + 1 == len(_cuda.ARGTYPES[name_k9])
        # the score entry's arguments, then h, seen, skew
        assert len(args) == len(score_args) + 3
        assert args[:len(score_args)][:4] == score_args[:4]
        k = 4 + len(sf._model(sc, _table(sub)))
        assert args[k:k + 3] == score_args[k:k + 3] == \
            list(sf.RB_DEFAULTS[mode])
        assert args[-1] == 0                                        # skew
    assert not any(df.launches.values())


def test_capture_shape_and_counters():
    sc = swtpu_torch.Scoring()
    b = torch.zeros(5000, dtype=torch.int8)
    assert df.rb_capture_shape(b, sc, None) == sf.RB_DEFAULTS["linear"]
    assert df.rb_capture_shape(b, sc, None, 512) == (512, 4, 4)
    for bad in (dict(R=8, C=2), dict(T=512, R=8), dict(R=16, C=4)):
        with pytest.raises(ValueError):
            df.rb_capture_shape(b, sc, None, **bad)
    assert set(df.rb_launches) == set(df.RB_DEBUG_KERNELS.values())
    a, b = (torch.from_numpy(x) for x in random_pair(40, 70, seed=1))
    pf.reset_counts()
    df.stripe_rb_capture(a, b)
    assert df.rb_plain_calls == {"stripe_rb_capture_plain": 1}
    assert not any(df.rb_launches.values())
    pf.reset_counts()
    assert not any(df.rb_plain_calls.values())
    with pytest.raises(ValueError, match="skew"):
        df.stripe_rb_capture(a, b, skew=-1)
    with pytest.raises(ValueError, match="debug shapes"):
        df.stripe_rb_capture(torch.zeros(1 << 20, dtype=torch.int8),
                             torch.zeros(4096, dtype=torch.int8))


# ---- the CUDA kernel on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CAPTURES))
def test_rb_capture_matches_plain_on_card(card, case):
    name, m, n, T, R, C = CAPTURES[case]
    a, b = _pair(name, m, n, sum(map(ord, case)))
    if "sentinels" in case:
        a, b = _sentinels((a, b), 7)
    sc, sub = _port(name)
    at, bt = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    St = None if sub is None else torch.from_numpy(sub).to(card)
    for shape in ((T, R, C), (None, None, None), (32, 4, 4)):
        p = df.stripe_rb_capture_plain(at, bt, sc, *shape, St)
        for _ in range(3):      # ordering races show as run-to-run changes
            k = df.stripe_rb_capture(at, bt, sc, *shape, St)
            torch.cuda.synchronize()
            assert df.same_capture(k, p) == 0, shape


@pytest.mark.gpu
def test_skew_is_caught_on_card(card):
    a, b = random_pair(300, 1290, seed=1)
    at, bt = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    k = df.stripe_rb_capture(at, bt, T=32, R=4, C=4, skew=1)
    p = df.stripe_rb_capture_plain(at, bt, T=32, R=4, C=4, skew=1)
    assert df.same_capture(k, p, skewed=True) == 0
    with pytest.raises(tsan.SanitizeError):
        tsan.sanitize_stripe(a, b, T=128, skew=1)


@pytest.mark.gpu
def test_sanitize_launches_the_rb_capture_on_card(card):
    a, b = random_pair(200, 2100, seed=5)
    pf.reset_counts()
    rep = swtpu_torch.sanitize(a, b)
    assert rep.valid_cells == 200 * 2100
    assert rep.config == (*sf.RB_DEFAULTS["linear"], 3)
    assert df.rb_launches == {**dict.fromkeys(df.rb_launches, 0),
                              "sw_sanitize_rb_linear": 1}
    assert not any(df.launches.values())
    assert not any(df.plain_calls.values())
    assert not any(df.rb_plain_calls.values())
