"""The packed K9: the sanitizer's capture on the packed form of the
register-blocked stripe that K7 runs, against the JAX package on the CPU.

The CUDA kernel (``swtpu_torch/csrc/stripe_rb_packed_debug.cu``) runs only
on a card. Here its plain version, ``debug_fill.packed_rb_capture_plain``
(one ``scan_fill`` per segment of a pair inside a stripe, gathered through
the geometry of ``pairs_fill.packed_rb_geometry``), is held to the JAX
package's numpy oracle cell by cell, through ``check_capture`` and through
the geometry's map directly; hand corruptions of a clean capture are
caught by the named check; the test hook ``skew`` (a broken hand-off) makes
``sanitize_pairs_packed`` raise; the port's sanitizer and the JAX
package's ``sanitize_pairs_packed`` (interpret mode, as its own tests run
it) both pass on the same inputs with the same per-pair maxes; and the
wrapper's launch is recorded instead of run and held to the entry's ctypes
signature and K7's own launch. Tolerance: exact equality (integer DP). The
``gpu`` tests hold the kernel against its plain version on a card and skip
elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.core import oracle as joracle
from swtpu.core.config import Scoring as JScoring
from swtpu.core.encode import random_batch
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.instrument import sanitize as jsan
from swtpu.kernels.pallas_fill import pairs_packed_score_fn
import swtpu_torch
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.instrument import sanitize as tsan
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import debug_fill as df
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf

SCORINGS = {
    "linear": (JScoring(), None),
    "dna_affine": (JScoring(mode="affine", gap_open=-4, gap_extend=-1), None),
    "blosum62": (JScoring(mode="affine", gap_open=-11, gap_extend=-1),
                 J_BLOSUM62),
    "blosum62_linear": (JScoring(gap=-6), J_BLOSUM62),
}


def _port(name):
    jsc, jsub = SCORINGS[name]
    return scoring_from_jax(jsc), (None if jsub is None
                                   else substitution_from_jax(jsub))


def _table(sub):
    return None if sub is None else torch.from_numpy(sub)


def _pairs(name, B, m, n, seed):
    """B pairs of the scoring's alphabet, a shared stretch planted."""
    rng = np.random.default_rng(seed)
    A = 20 if name.startswith("blosum62") else 4
    aa = rng.integers(0, A, (B, m)).astype(np.int8)
    bb = rng.integers(0, A, (B, n)).astype(np.int8)
    k = min(m, n) // 2
    bb[:, n - k:] = aa[:, :k]
    return aa, bb


# (B, m, n, T, R, C): whole pairs a stripe (several, with threads past the
# last pair), pairs across stripes (their hand-off), n = 1, m = 1, n not a
# multiple of R, the small tile
SHAPES = [(5, 30, 45, None, None, None), (9, 18, 20, 32, 4, 4),
          (3, 40, 300, 32, None, None), (2, 25, 700, 64, 4, 4),
          (4, 1, 70, None, None, None), (6, 20, 1, 32, None, None),
          (3, 50, 130, 64, 4, 4)]


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_capture_maps_onto_the_jax_oracle(name, shape):
    B, m, n, T, R, C = shape
    aa, bb = _pairs(name, B, m, n, B + m + n)
    sc, sub = _port(name)
    jsc, jsub = SCORINGS[name]
    cap = df.packed_rb_capture_plain(torch.from_numpy(aa),
                                     torch.from_numpy(bb), sc, T, R, C,
                                     _table(sub))
    geo = cap.geometry
    assert (cap.T, cap.R) == (geo.T, geo.R) and (geo.B, geo.n) == (B, n)
    steps = -(-m // cap.C) + geo.T - 1
    assert tuple(cap.h.shape) == (geo.stripes, steps, geo.T, cap.R, cap.C)
    # the capture through the geometry's map, against the JAX oracle
    Hs = np.stack([joracle.fill(x, y, jsc, sub=jsub).H
                   for x, y in zip(aa, bb)])
    g, i, j = (np.broadcast_to(x.numpy(), cap.h.shape)
               for x in geo.cells(steps, cap.C))
    h = cap.h.numpy()
    t = np.arange(steps)[None, :, None, None, None]
    sched = np.broadcast_to(t < geo.stripe_steps(m, cap.C).numpy()[
        :, None, None, None, None], h.shape)
    valid = sched & (g >= 0) & (i <= n) & (j >= 1) & (j <= m)
    assert valid.sum() == B * m * n
    assert (h[valid] == Hs[g[valid], i[valid], j[valid]]).all()
    assert (h[sched & ~valid] == 0).all()
    assert (h[~sched] == df.UNSCHEDULED).all()
    assert cap.scores.tolist() == Hs.max(axis=(1, 2)).tolist()
    # a stripe reads the boundary exactly where it continues a pair
    reads = geo.reads().numpy()
    seen = cap.seen.numpy()
    assert (seen[~reads] == -1).all() and (seen[reads, 0] == -1).all()
    assert (seen[reads, 1:] == m).all()
    rep = tsan.check_capture(cap, *tsan.reference(aa, bb, sc, sub))
    assert rep.valid_cells == B * m * n
    assert rep.config == (geo.T, cap.R, cap.C, geo.stripes)


@pytest.mark.parametrize("name", ["linear", "dna_affine", "blosum62"])
def test_skew_makes_the_packed_sanitizer_raise(name):
    """The test hook reads boundary column j - 1: wrong cells in every
    stripe that continues a pair, caught as a violated invariant; where no
    stripe continues a pair the hook reads nothing and nothing breaks."""
    sc, sub = _port(name)
    aa, bb = _pairs(name, 3, 40, 1100, 1)        # 1024 + 76 rows a pair
    rep = tsan.sanitize_pairs_packed(aa, bb, sc, substitution=sub,
                                     device="cpu")
    assert rep.config == (128, 8, 4, 6)
    with pytest.raises(tsan.SanitizeError, match="!= oracle"):
        tsan.sanitize_pairs_packed(aa, bb, sc, substitution=sub,
                                   device="cpu", skew=1)
    aa, bb = _pairs(name, 4, 40, 300, 2)         # 256 + 44 rows at T=32
    with pytest.raises(tsan.SanitizeError, match="!= oracle"):
        tsan.sanitize_pairs_packed(aa, bb, sc, T=32, substitution=sub,
                                   device="cpu", skew=2)
    rep = tsan.sanitize_pairs_packed(aa, bb, sc, substitution=sub,
                                     device="cpu", skew=1)
    assert rep.config == (128, 8, 4, 2)         # 3 pairs of 38 threads a stripe


# tests/test_sanitize.py's packed cases: row padding, pairs across the JAX
# kernel's stripes, affine and the BLOSUM62 profile
PACKED = {
    "linear": lambda: (*random_batch(9, 40, 5, seed=3), "linear"),
    "affine": lambda: (*random_batch(4, 30, 17, seed=5), "dna_affine"),
    "blosum62": lambda: (*_pairs("blosum62", 3, 24, 10, 9), "blosum62"),
}


@pytest.mark.parametrize("case", list(PACKED))
def test_clean_packed_matches_the_jax_sanitizer(case):
    aa, bb, name = PACKED[case]()
    jsc, jsub = SCORINGS[name]
    want = jsan.sanitize_pairs_packed(aa, bb, jsc, T=256, R=2,
                                      substitution=jsub)
    sc, sub = _port(name)
    got = tsan.sanitize_pairs_packed(aa, bb, sc, substitution=sub,
                                     device="cpu")
    assert got.valid_cells == want.valid_cells == aa.size * bb.shape[1]
    B, m = aa.shape
    fn = pairs_packed_score_fn(B, m, bb.shape[1], scoring=jsc, T=256, R=2,
                               interpret=True, substitution=jsub)
    jmax = np.asarray(fn(jnp.asarray(aa), jnp.asarray(bb))[0]).tolist()
    cap = df.packed_rb_capture_plain(torch.from_numpy(aa),
                                     torch.from_numpy(bb), sc,
                                     substitution=_table(sub))
    assert cap.scores.tolist() == jmax


# hand corruptions of a clean capture of 3 x 40 x 300 at T = 32 (2 stripes
# a pair, the second of 44 rows; the last thread of each pair's second
# stripe holds 4 pad rows) and of 5 x 30 x 45 (5 pairs of 6 threads in one
# stripe, threads 30 and 31 past the last pair), each caught by the named
# check
def _clean(shape):
    B, m, n, T = shape
    aa, bb = _pairs("linear", B, m, n, 11)
    sc = swtpu_torch.Scoring()
    cap = df.packed_rb_capture_plain(torch.from_numpy(aa),
                                     torch.from_numpy(bb), sc, T)
    return cap, tsan.reference(aa, bb, sc)


def _corrupt(cap, what):
    h, seen, scores = cap.h.clone(), cap.seen.clone(), cap.scores.clone()
    if what == "cell":
        h[0, 5, 3, 2, 1] += 1               # row 27, column 10
    elif what == "pad_row":
        h[1, 8, 5, 4, 0] = 7                # pair 0's row 300 + 1
    elif what == "idle_thread":
        h[0, 5, 31, 0, 0] = 7               # no pair's
    elif what == "prestart":
        h[0, 0, 6, 0, 0] = 5                # column < 1
    elif what == "unscheduled":
        h[1, -1, 0, 0, 0] = 0               # past the stripe's own steps
    elif what == "seen_early":
        seen[1, 12] = 11                    # read before its release
    elif what == "seen_nowhere":
        seen[0, 5] = 40                     # a stripe that starts a pair
    elif what == "max":
        scores[1] += 1
    return cap._replace(h=h, seen=seen, scores=scores)


@pytest.mark.parametrize("what, shape, match", [
    ("cell", (3, 40, 300, 32), "!= oracle"),
    ("pad_row", (3, 40, 300, 32), "idle-row slot"),
    ("idle_thread", (5, 30, 45, None), "idle-row slot"),
    ("prestart", (3, 40, 300, 32), "pre-start"),
    ("unscheduled", (3, 40, 300, 32), "unscheduled"),
    ("seen_early", (3, 40, 300, 32), "hand-off: stripe 1 read column 12"),
    ("seen_nowhere", (3, 40, 300, 32), "reads no boundary"),
    ("max", (3, 40, 300, 32), "kernel max"),
])
def test_checks_catch_a_corrupted_packed_capture(what, shape, match):
    cap, ref = _clean(shape)
    tsan.check_capture(cap, *ref)
    with pytest.raises(tsan.SanitizeError, match=match):
        tsan.check_capture(_corrupt(cap, what), *ref)


def test_checks_refuse_a_geometry_of_other_pairs():
    cap, (H, maxes) = _clean((3, 40, 300, 32))
    with pytest.raises(tsan.SanitizeError, match="geometry"):
        tsan.check_capture(cap, H[:2], maxes[:2])


# ---- the route and the launch, as pure Python ----

@pytest.mark.parametrize("name", list(SCORINGS))
def test_capture_launches_the_packed_rb_entry_at_k7_s_launch(name,
                                                             monkeypatch):
    """On a card (the launch recorded instead of run) the capture launches
    the form's sw_sanitize_packed_rb_* entry with the arguments its ctypes
    signature declares: K7's own arguments for the same input (its (T, R,
    C) and geometry), then h, seen, skew; no template K9 entry."""
    sc, sub = _port(name)
    aa, bb = _pairs(name, 3, 40, 1100, 8)
    at, bt = torch.from_numpy(aa), torch.from_numpy(bb)
    seen = []
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call", lambda nm, dev, args, counter=None,
                        counts=None: seen.append((nm, counts, args)))
    monkeypatch.setattr(pf, "_reduce_rows", lambda row_best: pf.BatchHits(
        row_best[:, 0, 0], None, None))
    pf.pairs_packed_score(at, bt, sc, substitution=_table(sub))
    cap = df.packed_rb_capture(at, bt, sc, substitution=_table(sub))
    (k7, _, k7_args), (nm, counts, args) = seen
    mode = sf._mode(sc, sub)
    assert nm == df.PACKED_RB_DEBUG_KERNELS[mode] == \
        df.packed_rb_debug_kernel_name(sc, sub)
    assert counts is df.packed_rb_launches
    assert len(args) + 1 == len(_cuda.ARGTYPES[nm])           # + the stream
    k = 5 + len(sf._model(sc, _table(sub)))
    assert args[:k][2:] == k7_args[:k][2:]
    assert args[k:k + 3] == k7_args[k:k + 3] == [128, 8, 4]
    assert len(args) == len(k7_args) + 3 and args[-1] == 0      # skew
    assert (cap.T, cap.R, cap.C) == (128, 8, 4)
    assert cap.geometry == pf.packed_rb_geometry(3, 1100, 128, 8)
    assert not any(df.launches.values())


def test_capture_shape_and_counters():
    sc = swtpu_torch.Scoring()
    b = torch.zeros((4, 5000), dtype=torch.int8)
    (T, R, C), geo = df.packed_rb_capture_geometry(b, sc, None)
    assert (T, R, C) == sf.RB_DEFAULTS["linear"] and geo.spp == 5
    assert df.packed_rb_capture_geometry(b, sc, None, 512)[0] == (512, 4, 4)
    # whole pairs a stripe: T rounded to their warps, as K7 rounds it
    (T, R, C), geo = df.packed_rb_capture_geometry(
        torch.zeros((3, 100), dtype=torch.int8), sc, None)
    assert T == 64 and geo.per == 4 and geo.stripes == 1
    for bad in (dict(R=8, C=2), dict(T=512, R=8), dict(R=16, C=4)):
        with pytest.raises(ValueError):
            df.packed_rb_capture_geometry(b, sc, None, **bad)
    assert set(df.packed_rb_launches) == set(
        df.PACKED_RB_DEBUG_KERNELS.values())
    aa, bb = (torch.from_numpy(x) for x in random_batch(3, 40, 70, seed=1))
    pf.reset_counts()
    df.packed_rb_capture(aa, bb)
    assert df.packed_rb_plain_calls == {"packed_rb_capture_plain": 1}
    assert not any(df.packed_rb_launches.values())
    assert not any(df.plain_calls.values())
    pf.reset_counts()
    assert not any(df.packed_rb_plain_calls.values())
    with pytest.raises(ValueError, match="skew"):
        df.packed_rb_capture(aa, bb, skew=-1)
    with pytest.raises(ValueError, match="debug shapes"):
        df.packed_rb_capture(torch.zeros((64, 1 << 16), dtype=torch.int8),
                             torch.zeros((64, 1 << 12), dtype=torch.int8))


# ---- the CUDA kernel on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_packed_rb_capture_matches_plain_on_card(card, name, shape):
    B, m, n, T, R, C = shape
    sc, sub = _port(name)
    aa, bb = _pairs(name, B, m, n, B + m + n)
    at, bt = torch.from_numpy(aa).to(card), torch.from_numpy(bb).to(card)
    S = None if sub is None else torch.from_numpy(sub).to(card)
    p = df.packed_rb_capture_plain(at, bt, sc, T, R, C, S)
    ref = tsan.reference(aa, bb, sc, sub)
    for _ in range(3):          # ordering races show as run-to-run changes
        k = df.packed_rb_capture(at, bt, sc, T, R, C, S)
        assert df.same_capture(k, p) == 0
        tsan.check_capture(k, *ref)


@pytest.mark.gpu
def test_packed_skew_is_caught_on_card(card):
    aa, bb = _pairs("linear", 3, 40, 1100, 1)
    at, bt = torch.from_numpy(aa).to(card), torch.from_numpy(bb).to(card)
    k = df.packed_rb_capture(at, bt, skew=1)
    p = df.packed_rb_capture_plain(at, bt, skew=1)
    assert df.same_capture(k, p, skewed=True) == 0
    with pytest.raises(tsan.SanitizeError):
        tsan.sanitize_pairs_packed(aa, bb, skew=1)


@pytest.mark.gpu
def test_sanitize_pairs_packed_launches_the_packed_rb_capture_on_card(card):
    aa, bb = _pairs("linear", 6, 60, 1100, 6)
    pf.reset_counts()
    rep = tsan.sanitize_pairs_packed(aa, bb)
    assert rep.valid_cells == 6 * 60 * 1100
    assert df.packed_rb_launches["sw_sanitize_packed_rb_linear"] == 1
    assert df.launches["sw_sanitize_packed_linear"] == 0
    assert pf.launches["sw_packed_rb_linear"] == 1      # the K7 cross-check
    assert pf.launches["sw_packed_score_linear"] == 0
    assert not any(df.packed_rb_plain_calls.values())
    assert not any(pf.plain_calls.values())
