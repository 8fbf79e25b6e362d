"""The packed form of the register-blocked stripe (K7 on the card) against
the JAX package, on the CPU.

The CUDA kernel (``swtpu_torch/csrc/stripe_rb_packed.cu``) runs only on a
card. Here its geometry, ``pairs_fill.packed_rb_geometry``, the one map of
where every row of every pair sits, is held to its contract (every stripe
starts at a pair's row 1, each real row maps to one (pair, row), the pad
rows, the int32 guard), the wrapper's launch is recorded instead of run and
held to the entry's ctypes signature and the geometry, and
``pairs_packed_score`` on the CPU (its plain version) is held to the JAX
package's ``pairs_packed_score_fn`` in interpret mode. Tolerance: exact
equality (integer DP). The ``gpu`` tests hold the kernel against its plain
version on a card and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swtpu_torch
from swtpu.core.config import Scoring as JScoring
from swtpu.core.encode import random_batch
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.kernels.pallas_fill import pairs_packed_score_fn
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.dist import batch as tbatch
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf

SCORINGS = {
    "linear": (JScoring(), None),
    "dna_affine": (JScoring(mode="affine", gap_open=-4, gap_extend=-1), None),
    "blosum62": (JScoring(mode="affine", gap_open=-11, gap_extend=-1),
                 J_BLOSUM62),
}


def _port(name):
    jsc, jsub = SCORINGS[name]
    return scoring_from_jax(jsc), (None if jsub is None
                                   else substitution_from_jax(jsub))


def _batch(name, B, m, n, seed, kind=""):
    """B pairs of the scoring's alphabet with a planted shared prefix;
    ``kind`` 'ties': one motif planted twice in every pair; 'sentinels':
    codes -1, -2, -3 in every pair's a and b, -1 against -1 inside the
    prefix."""
    rng = np.random.default_rng(seed)
    A = 20 if name == "blosum62" else 4
    aa = rng.integers(0, A, (B, m)).astype(np.int8)
    bb = rng.integers(0, A, (B, n)).astype(np.int8)
    k = min(m, n) // 2
    bb[:, :k] = aa[:, :k]
    if kind == "ties":
        aa[:, 10:18] = aa[:, 40:48]
        bb[:, 5:13] = aa[:, 10:18]
        bb[:, 60:68] = aa[:, 10:18]
    elif kind == "sentinels":
        for g in range(B):
            aa[g, rng.choice(m, min(3, m), replace=False)] = [-1, -2, -3][:m]
            bb[g, rng.choice(n, min(3, n), replace=False)] = [-3, -2, -1][:n]
        aa[:, k // 2] = bb[:, k // 2] = -1
    return aa, bb


def _triple(hits):
    return [(x.cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x)).astype(np.int64).tolist() for x in hits]


# ---- the geometry ----

# (B, n, T, R): whole pairs a stripe (several, one, more slots than pairs),
# pairs across stripes (the 64 x 1056 batch at the default: 1024 + 32
# rows), n = 1, n not a multiple of R, B = 1
GEOMETRIES = [(64, 1056, 128, 8), (64, 1000, 128, 8), (5, 45, 128, 8),
              (9, 20, 32, 4), (45, 5, 256, 8), (1, 1, 32, 8), (1, 300, 32, 4),
              (3, 1100, 128, 8), (7, 33, 64, 16), (16, 16384, 128, 8),
              (100, 130, 512, 8), (2, 2048, 256, 8)]


@pytest.mark.parametrize("B, n, T, R", GEOMETRIES)
def test_geometry_starts_every_stripe_at_a_pair(B, n, T, R):
    geo = pf.packed_rb_geometry(B, n, T, R)
    assert geo.T % 32 == 0 and 32 <= geo.T <= T
    assert geo.rlen == -(-n // R) * R and geo.rlen - n < R
    g, row0, kk = geo.threads()
    live = g >= 0
    if geo.rlen <= T * R:        # whole pairs a stripe, no boundary read
        assert geo.spp == 1 and geo.per >= 1
        assert geo.T == -(-min(T // geo.tpp, B) * geo.tpp // 32) * 32
        assert geo.stripes == -(-B // geo.per)
        assert not geo.reads().any()
    else:                        # each pair its own chain of stripes
        assert geo.per == 1 and geo.T == T
        assert geo.spp == -(-n // (T * R)) and geo.stripes == B * geo.spp
        assert geo.reads().tolist() == [s % geo.spp > 0
                                        for s in range(geo.stripes)]
    # thread 0 of every stripe holds a pair, from its row 1 or from the
    # first row of the pair's stripe; a pair's first thread of a stripe
    # (kk = 0) is where its rows start in it
    assert live[:, 0].all()
    starts = (row0[:, 0] == 0) | geo.reads()
    assert starts.all()
    assert ((row0[live] == 0) | (kk[live] > 0) | geo.reads()[
        torch.nonzero(live)[:, 0]]).all()
    assert (row0[live] % R == 0).all() and (kk[~live] == geo.T).all()
    # the skew restarts at each pair: consecutive threads of a pair
    same = (g[:, 1:] == g[:, :-1]) & live[:, 1:]
    assert (kk[:, 1:][same] == kk[:, :-1][same] + 1).all()
    assert (kk[:, 1:][~same & live[:, 1:]] == 0).all()


@pytest.mark.parametrize("B, n, T, R", GEOMETRIES)
def test_geometry_maps_real_rows_one_to_one(B, n, T, R):
    geo = pf.packed_rb_geometry(B, n, T, R)
    g, row0, _ = geo.threads()
    rows = row0[..., None] + torch.arange(R) + 1        # (stripes, T, R)
    gg = g[..., None].expand_as(rows)
    real = (gg >= 0) & (rows <= n)
    key = gg[real] * n + rows[real] - 1
    assert key.numel() == B * n and torch.equal(key.sort().values,
                                                torch.arange(B * n))
    # a pair's rows past n: its pad rows (whole pairs a stripe) or the rows
    # of its last stripe past n (a pair across stripes), computed and
    # discarded; the threads past a stripe's last pair hold none
    held = geo.rlen if geo.spp == 1 else geo.spp * geo.T * R
    pads = (gg >= 0) & (rows > n)
    assert int(pads.sum()) == B * (held - n)
    if geo.spp == 1:                     # the pitch's pad rows alone
        assert int(pads.sum()) == B * (geo.rlen - n)
    assert int((g < 0).sum()) * R == geo.stripes * geo.T * R - B * held
    # the steps each stripe runs: its pair's threads holding rows
    kt = [(min(geo.T * R, n - (s % geo.spp) * geo.T * R) + R - 1) // R
          for s in range(geo.stripes)]
    assert geo.stripe_steps(500, 4).tolist() == [125 + x - 1 for x in kt]


def test_geometry_guards_int32():
    with pytest.raises(ValueError, match="overflow"):
        pf.packed_rb_geometry(1 << 16, 1 << 15, 128, 8)
    pf.packed_rb_geometry(1 << 10, 1 << 15, 128, 8)
    for bad in ((0, 10, 32, 8), (2, 0, 32, 8), (2, 10, 48, 8),
                (2, 10, 16, 8)):
        with pytest.raises(ValueError, match="geometry"):
            pf.packed_rb_geometry(*bad)
    aa = torch.zeros((1 << 13, 2), dtype=torch.int8)
    bb = torch.zeros((1 << 13, 1 << 17), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="overflow"):
        pf._launch_packed_rb(aa.to("meta"), bb, swtpu_torch.Scoring(), None)


# ---- the plain version against the JAX packed pairs (interpret mode),
# at tests/test_torch_batch.py's packed shapes ----

PALLAS_CASES = {
    "packed_45x40x5": (lambda: random_batch(45, 40, 5, seed=13), "linear",
                       dict(T=256, R=2, C=128)),
    "packed_ties_8x64x96": (lambda: _batch("linear", 8, 64, 96, 17, "ties"),
                            "linear", dict(T=512, R=4, C=128)),
    "packed_protein_7x52x33": (lambda: _batch("blosum62", 7, 52, 33, 23),
                               "blosum62", dict(T=512, R=4, C=128)),
    "packed_affine_5x30x44": (lambda: random_batch(5, 30, 44, seed=29),
                              "dna_affine", dict(T=256, R=2, C=128)),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_packed_score_matches_the_jax_packed_pairs(case):
    make, name, params = PALLAS_CASES[case]
    aa, bb = make()
    jsc, jsub = SCORINGS[name]
    B, m = aa.shape
    fn = pairs_packed_score_fn(B, m, bb.shape[1], scoring=jsc,
                               interpret=True, substitution=jsub, **params)
    want = _triple(fn(jnp.asarray(aa), jnp.asarray(bb)))
    sc, sub = _port(name)
    pf.reset_counts()
    got = pf.pairs_packed_score(torch.from_numpy(aa), torch.from_numpy(bb),
                                sc, substitution=None if sub is None
                                else torch.from_numpy(sub))
    assert _triple(got) == want
    assert pf.plain_calls == {"pairs_score_plain": 1}
    assert not any(pf.launches.values())


# ---- the route and the launch, as pure Python ----

@pytest.mark.parametrize("name", ["linear", "dna_affine", "blosum62",
                                  "blosum62_linear"])
@pytest.mark.parametrize("B, n, T", [(3, 900, None), (5, 1100, 128),
                                     (40, 30, 256), (2, 7, None)])
def test_packed_score_launches_the_rb_entry(name, B, n, T, monkeypatch):
    """pairs_packed_score on a card (the launch recorded instead of run):
    the packed form's entry of the scoring, with the arguments its ctypes
    signature declares, at rb_shape's 'packed' (R, C) and the geometry's
    T; its scratch sized by the geometry; the template's K7 not
    launched."""
    sc, sub = _port(name.replace("_linear", ""))
    if name == "blosum62_linear":
        sc = swtpu_torch.Scoring(gap=-6)
    aa, bb = _batch(name.replace("_linear", ""), B, 40, n, 30)
    St = None if sub is None else torch.from_numpy(sub)
    seen = []
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call", lambda nm, dev, args, counter=None,
                        counts=None: seen.append((nm, counter, counts, args)))
    monkeypatch.setattr(pf, "_reduce_rows", lambda row_best: row_best)
    at, bt = torch.from_numpy(aa), torch.from_numpy(bb)
    row_best = pf.pairs_packed_score(at, bt, sc, T, St)
    (nm, counter, counts, args), = seen
    mode = sf._mode(sc, St)
    assert nm == pf.PACKED_RB_KERNELS[mode] == pf.packed_kernel_name(sc, St)
    assert nm != pf.packed_template_name(sc, St)
    assert counter in (None, nm) and counts is pf.launches
    assert len(args) + 1 == len(_cuda.ARGTYPES[nm])           # + the stream
    shape = sf.rb_shape(n, T, mode=mode, A=21, kind="packed")
    geo = pf.packed_rb_geometry(B, n, shape[0], shape[1])
    tail = 3 if mode == "linear" else 4   # sync, bnd, [bnd_f,] row_best
    assert tuple(args[-tail - 3:-tail]) == (geo.T, *shape[1:])
    assert args[2:5] == [B, 40, n]
    assert tuple(row_best.shape) == (B, n, 2)


def test_rb_shape_of_the_packed_form():
    for mode in ("linear", "affine", "sub"):
        T, R, C = sf.RB_DEFAULTS[mode]
        assert sf.rb_shape(10 ** 5, mode=mode, A=21, kind="packed") == (T, R,
                                                                         C)
        # not clamped to a pair's rows: the geometry rounds T
        assert sf.rb_shape(5, mode=mode, A=21, kind="packed")[0] == T
        assert sf.rb_shape(5, 512, mode=mode, kind="packed")[0] == 512
        for R_, C_ in sf.RB_FORM_TILES[mode]:
            assert sf.rb_shape(2000, 512, R_, C_, mode, 21, "packed")[1:] \
                == (R_, C_)
    with pytest.raises(ValueError, match="tiles"):
        sf.rb_shape(1000, None, 16, 4, "affine", kind="packed")


def test_counters_and_names():
    sc, aff = swtpu_torch.Scoring(), swtpu_torch.Scoring(mode="affine")
    S = torch.zeros((4, 4), dtype=torch.int32)
    assert pf.packed_kernel_name(sc, None) == "sw_packed_rb_linear"
    assert pf.packed_kernel_name(aff, None) == "sw_packed_rb_affine"
    assert pf.packed_kernel_name(sc, S) == "sw_packed_rb_sub"
    assert pf.packed_template_name(aff, S) == "sw_packed_score_sub"
    assert {*pf.PACKED_RB_KERNELS.values(), *pf.PACKED_KERNELS.values()} <= \
        set(pf.launches)
    for name in pf.PACKED_RB_KERNELS.values():
        assert _cuda.ARGTYPES[name] == _cuda.ARGTYPES[
            name.replace("packed", "pairs")]


# ---- the CUDA kernel on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (B, m, n, T, kind): n = 1, n not a multiple of R, B = 1, rlen > T * R
# (pairs across stripes), several pairs a stripe, sentinel codes, ties
CARD_CASES = [(5, 33, 1, None, ""), (7, 52, 33, None, ""),
              (1, 60, 90, 32, ""), (3, 70, 1100, None, ""),
              (2, 100, 2100, 64, ""), (45, 40, 5, 256, ""),
              (40, 30, 130, 512, ""), (4, 70, 300, 32, "sentinels"),
              (8, 64, 96, None, "ties")]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_packed_rb_kernel_matches_plain_on_card(card, name, case):
    B, m, n, T, kind = case
    sc, sub = _port(name)
    aa, bb = (torch.from_numpy(x).to(card)
              for x in _batch(name, B, m, n, B + m + n, kind))
    S = None if sub is None else torch.from_numpy(sub).to(card)
    want = _triple(pf.pairs_score_plain(aa, bb, sc, S))
    mode = sf._mode(sc, S)
    pf.reset_counts()
    for _ in range(3):          # ordering races show as run-to-run changes
        assert _triple(pf.pairs_packed_score(aa, bb, sc, T, S)) == want
    for R, C in sf.RB_FORM_TILES[mode]:
        assert _triple(pf.pairs_packed_score(aa, bb, sc, T, S, R, C)) == want
    assert pf.launches[pf.packed_kernel_name(sc, S)] == \
        3 + len(sf.RB_FORM_TILES[mode])
    assert pf.launches[pf.packed_template_name(sc, S)] == 0
    assert not any(pf.plain_calls.values())


@pytest.mark.gpu
def test_packed_plan_launches_the_rb_kernel_on_card(card):
    aa, bb = _batch("linear", 6, 60, 1100, 8)
    want = _triple(tbatch.batch_score(aa, bb, device="cpu"))
    pf.reset_counts()
    assert _triple(swtpu_torch.batch_score(aa, bb, plan="packed")) == want
    assert pf.launches["sw_packed_rb_linear"] == 1
    assert pf.launches["sw_packed_score_linear"] == 0
    assert not any(pf.plain_calls.values())
