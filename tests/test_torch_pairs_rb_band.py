"""The band form of the register-blocked batch stripe (K8[band] on the card)
against the JAX package, on the CPU.

The CUDA kernel (``swtpu_torch/csrc/stripe_rb_pairs_band.cu``, the kPairs
and kBand forms of ``stripe_rb_kernel`` together) runs only on a card.
Here ``rb_model(pairs=True, band=)`` (tests/test_torch_stripe_rb.py), the
Python model of the register-blocked stripe's schedule, walks each pair's
stripes in ticket order, pair-major, with the pair's own counters and
boundary rows, each stripe visiting only its band window (``rb_window``),
the row above read only where the stripe above stored it, each stripe
releasing m at its end, and reduces the (B, S, 4) stripe firsts as
``pairs_fill._reduce_stripes`` does. Its answer must equal the port's
plain version ``pairs_score_plain(band=)`` and the JAX package's
``batch_score(band=)`` (its vmapped scan, the only banded batch scorer it
has), in linear, DNA affine, BLOSUM62 affine and BLOSUM62 linear scoring,
at bands -1, 0, 1, 33 and beyond m + n, with m < n and m > n, n not a
multiple of T*R, m not a multiple of C, pairs with no positive cell,
sentinel codes and ties. Tolerance: exact equality (integer DP). The
``gpu`` tests hold the kernel against its plain version on a card and skip
elsewhere."""

import numpy as np
import pytest
import torch

from swtpu.core.config import Scoring as JScoring
from swtpu.dist import batch as jbatch
import swtpu_torch
from swtpu_torch.convert import scoring_from_jax
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf

from test_torch_pairs_rb import (SCORINGS, _batch, _dark, _port,
                                 _sentinels, _triple)
from test_torch_stripe_rb import rb_model

# BLOSUM62 with linear gaps, beside the three scorings of the K8 tests
JSCORINGS = {**SCORINGS, "blosum62_linear": (JScoring(gap=-6),
                                             SCORINGS["blosum62"][1])}


def _ties(name, B, m, n, seed):
    """A motif planted twice in every pair's b against one copy in a: the
    pair's max is reached at two end cells."""
    aa, bb = _batch(name, B, m, n, seed, overlap=False)
    aa[:, 10:18] = aa[:, 40:48]
    bb[:, 5:13] = aa[:, 10:18]
    bb[:, 60:68] = aa[:, 10:18]
    return aa, bb


def _alphabet(name):
    return "blosum62" if name.startswith("blosum62") else name


# (batch maker, scoring, T, R, C): m < n with n not a multiple of T*R, m > n
# (the band leaves the matrix on the right), m not a multiple of C, one
# column a step, R = 16, n < 32, pairs with no positive cell, sentinels,
# ties, each form's tiles
CASES = {
    "linear_m_lt_n_ragged": (lambda: _batch("linear", 4, 70, 300, 1),
                             "linear", 32, 4, 4),
    "linear_m_gt_n": (lambda: _batch("linear", 3, 300, 90, 2), "linear", 32,
                      8, 4),
    "linear_m_75_C8": (lambda: _batch("linear", 3, 75, 270, 3), "linear",
                       32, 8, 8),
    "linear_one_column_a_step": (lambda: _batch("linear", 2, 45, 200, 4),
                                 "linear", 32, 8, 1),
    "linear_R16_two_warps": (lambda: _batch("linear", 2, 40, 1100, 5),
                             "linear", 64, 16, 4),
    "linear_n_below_32": (lambda: _batch("linear", 5, 40, 20, 6), "linear",
                          32, 8, 2),
    "linear_no_positive_cell": (lambda: _dark("linear", 4, 50, 140, 7),
                                "linear", 32, 4, 4),
    "linear_ties": (lambda: _ties("linear", 3, 80, 150, 8), "linear", 32, 4,
                    4),
    "dna_affine_m_lt_n_ragged": (lambda: _batch("dna_affine", 3, 90, 290, 9),
                                 "dna_affine", 32, 4, 4),
    "dna_affine_m_gt_n_two_warps": (
        lambda: _batch("dna_affine", 2, 260, 70, 10), "dna_affine", 64, 8, 2),
    "dna_affine_sentinels": (lambda: _sentinels("dna_affine", 3, 70, 200,
                                                11), "dna_affine", 32, 8, 4),
    "dna_affine_ties": (lambda: _ties("dna_affine", 2, 80, 150, 12),
                        "dna_affine", 32, 4, 4),
    "blosum62_ragged": (lambda: _batch("blosum62", 3, 75, 300, 13),
                        "blosum62", 32, 8, 4),
    "blosum62_sentinels": (lambda: _sentinels("blosum62", 3, 60, 280, 14),
                           "blosum62", 32, 4, 4),
    "blosum62_m_gt_n": (lambda: _batch("blosum62", 2, 200, 100, 15),
                        "blosum62", 32, 8, 2),
    "blosum62_linear_ragged": (lambda: _batch("blosum62", 3, 60, 270, 16),
                               "blosum62_linear", 32, 4, 4),
}
# -1 keeps no cell; "beyond" is m + n + 5, which keeps every cell
BANDS = (-1, 0, 1, 33, "beyond")


def _scoring(name):
    sc, sub = _port(_alphabet(name))
    if name == "blosum62_linear":
        sc = scoring_from_jax(JSCORINGS[name][0])
    return sc, sub


def _band(band, m, n):
    return m + n + 5 if band == "beyond" else band


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("case", list(CASES))
def test_pairs_band_model_matches_plain_and_jax(case, band):
    make, name, T, R, C = CASES[case]
    aa, bb = make()
    (B, m), n = aa.shape, bb.shape[1]
    band = _band(band, m, n)
    sc, sub = _scoring(name)
    got = rb_model(aa, bb, sc, T, R, C, sub, pairs=True, band=band)
    plain = pf.pairs_score_plain(torch.from_numpy(aa), torch.from_numpy(bb),
                                 sc, None if sub is None
                                 else torch.from_numpy(sub), band)
    assert got == _triple(plain)
    jsc, jsub = JSCORINGS[name]
    want = jbatch.batch_score(aa, bb, jsc, band=band, plan="scan",
                              substitution=jsub)
    assert got == _triple(want)
    if band < 0:                      # no cell kept
        assert got == [[0] * B] * 3
    elif "no_positive" in case:
        assert got[0][1::2] == [0] * (B // 2)
    if band >= m + n:                 # the band keeps every cell
        unbanded = pf.pairs_score_plain(
            torch.from_numpy(aa), torch.from_numpy(bb), sc,
            None if sub is None else torch.from_numpy(sub))
        assert got == _triple(unbanded)


# ---- the route and the launch, as pure Python ----

@pytest.mark.parametrize("name", ["linear", "dna_affine", "blosum62",
                                  "blosum62_linear"])
def test_pairs_score_band_launches_the_rb_band_entry(name, monkeypatch):
    """pairs_score(band=) on a card (the launch recorded instead of run):
    the band form's entry of the scoring, counted under its own name, with
    the arguments its ctypes signature declares, at rb_shape's
    'pairs_band' (T, R, C), the band clamped to -1 .. m + n last; the
    template's entry launches on no route."""
    sc, sub = _scoring(name)
    aa, bb = _batch(_alphabet(name), 3, 40, 900, 30)
    St = None if sub is None else torch.from_numpy(sub)
    seen = []
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call", lambda nm, dev, args, counter=None,
                        counts=None: seen.append((nm, counter, args)))
    monkeypatch.setattr(pf, "_reduce_stripes", lambda best: None)
    at, bt = torch.from_numpy(aa), torch.from_numpy(bb)
    for band in (8, -5, 10 ** 6, 0):
        pf.pairs_score(at, bt, sc, substitution=St, band=band)
    mode = sf._mode(sc, St)
    entry = pf.PAIRS_RB_BAND_KERNELS[mode]
    assert entry == pf.pairs_kernel_name(sc, St, True) == \
        f"sw_pairs_rb_band_{mode}"
    assert [x[0] for x in seen] == [entry] * 4
    assert {x[1] for x in seen} <= {None, entry}
    assert [x[2][-1] for x in seen] == [8, -1, 40 + 900, 0]      # the band
    args = seen[0][2]
    assert len(args) + 1 == len(_cuda.ARGTYPES[entry])       # + the stream
    shape = sf.rb_shape(900, mode=mode, A=21, kind="pairs_band")
    assert shape == sf.RB_DEFAULTS[mode]
    tail = 4 if mode == "linear" else 5     # sync, bnd, [bnd_f,] best, band
    assert tuple(args[-tail - 3:-tail]) == shape
    assert args[2:5] == [3, 40, 900]                              # B, m, n
    if mode != "linear":
        assert (args[-3] is not None) == sc.is_affine             # bnd_f
    # the template's banded K8, the earlier design, by its private launcher
    seen.clear()
    pf._launch_pairs(at, bt, sc, None, St, 8)
    assert seen[0][0] == pf.pairs_template_name(sc, St)
    assert seen[0][1] == pf.pairs_template_name(sc, St, True) == \
        pf.pairs_template_name(sc, St) + sf.BAND_SUFFIX


def test_rb_shape_of_the_pairs_band_form():
    for mode in ("linear", "affine", "sub"):
        T, R, C = sf.RB_DEFAULTS[mode]
        assert (R, C) in sf.RB_FORM_TILES[mode]
        assert sf.rb_shape(10 ** 5, mode=mode, A=21,
                           kind="pairs_band") == (T, R, C)
        assert sf.rb_shape(5, mode=mode, A=21, kind="pairs_band")[0] == 32
        for R_, C_ in sf.RB_FORM_TILES[mode]:
            assert sf.rb_shape(2000, 256, R_, C_, mode, 21,
                               "pairs_band")[1:] == (R_, C_)
    # the band form's launch bound: above 256 threads only the (4, 4) tile
    assert sf.rb_shape(10 ** 5, 512, kind="pairs_band") == (512, 4, 4)
    with pytest.raises(ValueError, match="tiles"):
        sf.rb_shape(10 ** 5, 512, 8, 4, kind="pairs_band")
    with pytest.raises(ValueError, match="tiles"):
        sf.rb_shape(1000, None, 16, 4, "affine", kind="pairs_band")


def test_band_counters_and_names():
    aff = swtpu_torch.Scoring(mode="affine")
    S = torch.zeros((4, 4), dtype=torch.int32)
    for mode, (sc, sub) in (("linear", (swtpu_torch.Scoring(), None)),
                            ("affine", (aff, None)), ("sub", (aff, S))):
        name = pf.pairs_kernel_name(sc, sub, True)
        assert name == f"sw_pairs_rb_band_{mode}" and name in pf.launches
        assert name in _cuda.ARGTYPES
        assert pf.pairs_template_name(sc, sub, True) in pf.launches
    assert "stripe_rb_pairs_band.cu" in {p.name for p in _cuda.SOURCES}
    aa, bb = (torch.from_numpy(x) for x in _batch("linear", 2, 20, 30, 3))
    pf.reset_counts()
    pf.pairs_score(aa, bb, band=4)
    assert pf.plain_calls == {"pairs_score_plain": 1}
    assert not any(pf.launches.values())


# ---- the CUDA kernel on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_pairs_band_kernel_matches_plain_on_card(card, case):
    make, name, T, R, C = CASES[case]
    aa, bb = make()
    (B, m), n = aa.shape, bb.shape[1]
    sc, sub = _scoring(name)
    at, bt = torch.from_numpy(aa).to(card), torch.from_numpy(bb).to(card)
    St = None if sub is None else torch.from_numpy(sub).to(card)
    mode = sf._mode(sc, St)
    for band in BANDS:
        band = _band(band, m, n)
        want = _triple(pf.pairs_score_plain(at, bt, sc, St, band))
        for shape in ((T, R, C), (None, None, None),
                      *((128, R_, C_) for R_, C_ in sf.RB_FORM_TILES[mode])):
            for _ in range(2):  # ordering races show as run-to-run changes
                got = pf._launch_pairs_rb(at, bt, sc, *shape, sub=St,
                                          band=band)
                torch.cuda.synchronize()
                assert _triple(got) == want, (band, shape)


@pytest.mark.gpu
def test_banded_batch_score_launches_the_rb_band_kernel_on_card(card):
    aa, bb = _batch("linear", 6, 60, 90, 40)
    want = _triple(swtpu_torch.batch_score(aa, bb, band=5, device="cpu"))
    pf.reset_counts()
    assert _triple(swtpu_torch.batch_score(aa, bb, band=5)) == want
    assert pf.launches["sw_pairs_rb_band_linear"] == 1
    assert pf.launches["sw_pairs_score_linear[band]"] == 0
    assert not any(pf.plain_calls.values())
