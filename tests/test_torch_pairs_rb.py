"""The batch form of the register-blocked stripe (K8 on the card) against
the JAX package, on the CPU.

The CUDA kernel (``swtpu_torch/csrc/stripe_rb_pairs.cu``, the kPairs form
of ``stripe_rb_kernel``) runs only on a card. Here ``rb_model(pairs=True)``
(tests/test_torch_stripe_rb.py), the Python model of the register-blocked
stripe's schedule, walks each pair's stripes in ticket order, pair-major,
with the pair's own counters and boundary rows, and reduces the (B, S, 4)
stripe firsts as ``pairs_fill._reduce_stripes`` does. Its answer must
equal the port's plain version ``pairs_score_plain``, the JAX package's
``pairs_score_fn`` (its Pallas kernel in interpret mode) and the numpy
oracle of each pair, in linear, DNA affine and BLOSUM62 affine scoring, at
several (T, R, C), with m not a multiple of C and n not a multiple of T*R,
pairs with no positive cell, sentinel codes and B = 1. Tolerance: exact
equality (integer DP). The ``gpu`` tests hold the kernel against its plain
version on a card and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.core import oracle as joracle
from swtpu.core.config import Scoring as JScoring
from swtpu.core.encode import random_batch
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.kernels.pallas_fill import pairs_score_fn
import swtpu_torch
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.dist import batch as tbatch
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf

from test_torch_stripe_rb import _oracle_table, rb_model

BLOSUM62 = substitution_from_jax(np.asarray(J_BLOSUM62))
SCORINGS = {
    "linear": (JScoring(), None),
    "dna_affine": (JScoring(mode="affine", gap_open=-4, gap_extend=-1), None),
    "blosum62": (JScoring(mode="affine", gap_open=-11, gap_extend=-1),
                 J_BLOSUM62),
}


def _batch(name, B, m, n, seed, overlap=True):
    """B pairs of the scoring's alphabet, a shared segment planted."""
    rng = np.random.default_rng(seed)
    A = 20 if name == "blosum62" else 4
    aa = rng.integers(0, A, (B, m)).astype(np.int8)
    bb = rng.integers(0, A, (B, n)).astype(np.int8)
    k = min(m, n) // 2
    if overlap and k:
        bb[:, 3:3 + k] = aa[:, :k]
    return aa, bb


def _dark(name, B, m, n, seed):
    """A batch whose odd pairs hold no positive cell (a and b of two
    disjoint letters): their answer is (0, 0, 0)."""
    aa, bb = _batch(name, B, m, n, seed)
    aa[1::2], bb[1::2] = 0, 1
    return aa, bb


def _sentinels(name, B, m, n, seed):
    """Sentinel codes -1, -2, -3 in every pair's a and b, and -1 against
    -1 at an aligned spot of the planted segment."""
    aa, bb = _batch(name, B, m, n, seed)
    rng = np.random.default_rng(seed)
    for g in range(B):
        aa[g, rng.choice(m, 3, replace=False)] = [-1, -2, -3]
        bb[g, rng.choice(n, 3, replace=False)] = [-3, -2, -1]
    k = min(m, n) // 4
    aa[:, k], bb[:, 3 + k] = -1, -1
    return aa, bb


def _port(name):
    jsc, jsub = SCORINGS[name]
    return scoring_from_jax(jsc), (None if jsub is None
                                   else substitution_from_jax(jsub))


def _triple(hits):
    return [(x.cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x)).astype(np.int64).tolist() for x in hits]


def _oracle(aa, bb, name) -> list:
    """Each pair's (max, i, j) by the JAX package's oracle; sentinel codes
    through kNegSub rows and columns of the table."""
    jsc, jsub = SCORINGS[name]
    sub = None if jsub is None else _oracle_table(BLOSUM62)
    out = [[], [], []]
    for x, y in zip(aa, bb):
        ref = joracle.fill(x, y, jsc, sub)
        i, j = ref.max_ij if ref.max_score > 0 else (0, 0)
        for lst, v in zip(out, (ref.max_score, i, j)):
            lst.append(int(v))
    return out


# (batch maker, scoring, T, R, C): n not a multiple of T*R (one pair cut
# into ragged stripes), m not a multiple of C or of a chunk, n < 32, m = 1,
# B = 1, pairs with no positive cell, sentinels, each form's tiles
CASES = {
    "linear_ragged_3_stripes": (lambda: _batch("linear", 5, 70, 300, 1),
                                "linear", 32, 4, 4),
    "linear_m_75_C8": (lambda: _batch("linear", 4, 75, 270, 2), "linear",
                       32, 8, 8),
    "linear_one_column_a_step": (lambda: _batch("linear", 3, 45, 330, 3),
                                 "linear", 32, 8, 1),
    "linear_n_below_32": (lambda: _batch("linear", 7, 40, 20, 4), "linear",
                          32, 8, 4),
    "linear_m_is_1": (lambda: _batch("linear", 3, 1, 70, 5), "linear", 32,
                      8, 2),
    "linear_B_is_1": (lambda: _batch("linear", 1, 60, 290, 6), "linear",
                      32, 4, 4),
    "linear_no_positive_cell": (lambda: _dark("linear", 6, 50, 140, 7),
                                "linear", 32, 4, 4),
    "linear_R16_two_warps": (lambda: _batch("linear", 3, 33, 1100, 8),
                             "linear", 64, 16, 4),
    "dna_affine_ragged": (lambda: _batch("dna_affine", 4, 90, 290, 9),
                          "dna_affine", 32, 4, 4),
    "dna_affine_two_warps": (lambda: _batch("dna_affine", 3, 33, 600, 10),
                             "dna_affine", 64, 8, 2),
    "dna_affine_no_positive_cell": (
        lambda: _dark("dna_affine", 4, 40, 130, 11), "dna_affine", 32, 8, 4),
    "dna_affine_sentinels": (lambda: _sentinels("dna_affine", 3, 70, 200,
                                                12), "dna_affine", 32, 4, 4),
    "blosum62_ragged": (lambda: _batch("blosum62", 4, 75, 300, 13),
                        "blosum62", 32, 8, 4),
    "blosum62_sentinels": (lambda: _sentinels("blosum62", 3, 60, 280, 14),
                           "blosum62", 32, 4, 4),
    "blosum62_B_is_1_m_is_1": (lambda: _batch("blosum62", 1, 1, 90, 15),
                               "blosum62", 32, 8, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pairs_model_matches_plain_and_oracle(case):
    make, name, T, R, C = CASES[case]
    aa, bb = make()
    sc, sub = _port(name)
    got = rb_model(aa, bb, sc, T, R, C, sub, pairs=True)
    plain = pf.pairs_score_plain(torch.from_numpy(aa), torch.from_numpy(bb),
                                 sc, None if sub is None
                                 else torch.from_numpy(sub))
    assert got == _triple(plain)
    assert got == _oracle(aa, bb, name)
    if "no_positive" in case:
        assert got[0][1::2] == [0] * (len(aa) // 2)


# the JAX pair grid in interpret mode (T, R, C of tests/test_dist_batch.py)
PALLAS = {
    "linear": (lambda: _batch("linear", 3, 40, 300, 21), 32, 8, 4),
    "dna_affine": (lambda: _batch("dna_affine", 3, 33, 130, 22), 32, 4, 4),
    "blosum62": (lambda: _batch("blosum62", 3, 60, 280, 23), 32, 8, 4),
}


@pytest.mark.parametrize("name", list(PALLAS))
def test_pairs_model_matches_the_pallas_grid(name):
    make, T, R, C = PALLAS[name]
    aa, bb = make()
    jsc, jsub = SCORINGS[name]
    B, m = aa.shape
    fn = pairs_score_fn(B, m, bb.shape[1], scoring=jsc, T=256, R=2, C=128,
                        interpret=True, substitution=jsub)
    want = _triple(fn(jnp.asarray(aa), jnp.asarray(bb)))
    sc, sub = _port(name)
    assert rb_model(aa, bb, sc, T, R, C, sub, pairs=True) == want


# ---- the route and the launch, as pure Python ----

@pytest.mark.parametrize("name", ["linear", "dna_affine", "blosum62",
                                  "blosum62_linear"])
def test_pairs_score_launches_the_rb_entry(name, monkeypatch):
    """pairs_score on a card (the launch recorded instead of run): unbanded
    the register-blocked entry of the form, with the arguments its ctypes
    signature declares, at rb_shape's 'pairs' (T, R, C); banded the
    template's entry, counted under its name plus [band]."""
    sc, sub = _port(name.replace("_linear", ""))
    if name == "blosum62_linear":
        sc = swtpu_torch.Scoring(gap=-6)
    aa, bb = _batch(name.replace("_linear", ""), 3, 40, 900, 30)
    St = None if sub is None else torch.from_numpy(sub)
    seen = []
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call", lambda nm, dev, args, counter=None,
                        counts=None: seen.append((nm, counter, args)))
    monkeypatch.setattr(pf, "_reduce_stripes", lambda best: None)
    at, bt = torch.from_numpy(aa), torch.from_numpy(bb)
    pf.pairs_score(at, bt, sc, substitution=St)
    pf.pairs_score(at, bt, sc, substitution=St, band=8)
    (name_rb, counter, args), (name_b, counter_b, _) = seen
    mode = sf._mode(sc, St)
    assert name_rb == pf.PAIRS_RB_KERNELS[mode] == pf.pairs_kernel_name(sc,
                                                                        St)
    assert counter in (None, name_rb)
    assert len(args) + 1 == len(_cuda.ARGTYPES[name_rb])     # + the stream
    shape = sf.rb_shape(900, mode=mode, A=21, kind="pairs")
    assert shape[1:] == sf.RB_DEFAULTS[mode][1:]
    tail = 3 if mode == "linear" else 4       # sync, bnd, [bnd_f,] best
    assert tuple(args[-tail - 3:-tail]) == shape
    assert args[2] == 3                                           # B
    if mode != "linear":
        assert (args[-2] is not None) == sc.is_affine             # bnd_f
    assert name_b == pf.pairs_template_name(sc, St)
    assert counter_b == pf.pairs_kernel_name(sc, St, True)


def test_rb_shape_of_the_pairs_form():
    for mode in ("linear", "affine", "sub"):
        T, R, C = sf.RB_DEFAULTS[mode]
        assert (R, C) in sf.RB_FORM_TILES[mode]
        assert sf.rb_shape(10 ** 5, mode=mode, A=21, kind="pairs") == (T, R,
                                                                        C)
        # clamped to a pair's rows, a warp at least
        assert sf.rb_shape(5, mode=mode, A=21, kind="pairs") == (32, R, C)
        for R_, C_ in sf.RB_FORM_TILES[mode]:
            assert sf.rb_shape(2000, 512, R_, C_, mode, 21, "pairs")[1:] \
                == (R_, C_)
    with pytest.raises(ValueError, match="tiles"):
        sf.rb_shape(1000, None, 16, 4, "affine", kind="pairs")
    with pytest.raises(ValueError, match="multiple of 32"):
        sf.rb_shape(1000, 544, kind="pairs")


def test_counters_and_names():
    sc, aff = swtpu_torch.Scoring(), swtpu_torch.Scoring(mode="affine")
    S = torch.zeros((4, 4), dtype=torch.int32)
    assert pf.pairs_kernel_name(sc, None) == "sw_pairs_rb_linear"
    assert pf.pairs_kernel_name(aff, S) == "sw_pairs_rb_sub"
    assert pf.pairs_kernel_name(aff, None, True) == \
        "sw_pairs_score_affine[band]"
    assert pf.pairs_template_name(aff, None) == "sw_pairs_score_affine"
    assert set(pf.PAIRS_RB_KERNELS.values()) <= set(pf.launches)
    for name in pf.PAIRS_RB_KERNELS.values():
        assert name in _cuda.ARGTYPES
    aa, bb = (torch.from_numpy(x) for x in random_batch(2, 20, 30, seed=3))
    pf.reset_counts()
    pf.pairs_score(aa, bb)
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
def test_pairs_rb_kernel_matches_plain_on_card(card, case):
    make, name, T, R, C = CASES[case]
    aa, bb = make()
    sc, sub = _port(name)
    at, bt = torch.from_numpy(aa).to(card), torch.from_numpy(bb).to(card)
    St = None if sub is None else torch.from_numpy(sub).to(card)
    want = _triple(pf.pairs_score_plain(at, bt, sc, St))
    mode = sf._mode(sc, St)
    for shape in ((T, R, C), (None, None, None),
                  *((256, R_, C_) for R_, C_ in sf.RB_FORM_TILES[mode])):
        for _ in range(3):      # ordering races show as run-to-run changes
            got = pf._launch_pairs_rb(at, bt, sc, *shape, sub=St)
            torch.cuda.synchronize()
            assert _triple(got) == want, shape


@pytest.mark.gpu
def test_batch_score_launches_the_rb_kernel_on_card(card):
    aa, bb = _batch("linear", 6, 60, 90, 40)
    want = _triple(tbatch.batch_score(aa, bb, device="cpu"))
    pf.reset_counts()
    for plan in ("auto", "stripe"):
        assert _triple(swtpu_torch.batch_score(aa, bb, plan=plan)) == want
    assert pf.launches["sw_pairs_rb_linear"] == 2
    assert pf.launches["sw_pairs_score_linear"] == 0
    assert not any(pf.plain_calls.values())
