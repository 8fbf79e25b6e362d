"""The port's kernel routes on the card against the JAX package on the CPU,
on the same inputs: ``score``, ``align`` with full P and lean, banded
``align``, ``batch_score`` and ``search``, in DNA linear, DNA affine and
BLOSUM62 protein scoring.

Elsewhere the card evidence is transitive (each kernel equal to its plain
version on the card, each plain version equal to the JAX package on the
CPU); these hold the kernels to the JAX package directly. The plans are
forced, or the sizes chosen, so that a kernel launches (the launch
counters say which), at small sizes such as 512 x 700. Compared: the max
score, its first row-major end cell, ``last_cell``, the predecessor codes
and the alignment strings; for batches and searches each pair's or read's
score and end. Tolerance: exact equality. They need a card (``gpu``) and
skip elsewhere.
"""

import numpy as np
import pytest
import torch

import swtpu
import swtpu_torch
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.engine import traceback as jtb
from swtpu_torch import EngineConfig, Scoring
from swtpu_torch.convert import substitution_from_jax
from swtpu_torch.core.encode import PROTEIN_ALPHABET
from swtpu_torch.dist.database import pad_queries
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf
from swtpu_torch.kernels import window_fill as wf

pytestmark = pytest.mark.gpu

BLOSUM62 = substitution_from_jax(J_BLOSUM62)
KINDS = {
    # name: (port scoring, port table, JAX table, letters, alphabet)
    "linear": (Scoring(), None, None, 4, "ACGT"),
    "dna_affine": (Scoring(mode="affine"), None, None, 4, "ACGT"),
    "protein": (Scoring(mode="affine", gap_open=-11, gap_extend=-1),
                BLOSUM62, J_BLOSUM62, 20, PROTEIN_ALPHABET),
}
SHAPES = [(512, 700), (700, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _jsc(sc: Scoring) -> swtpu.Scoring:
    return swtpu.Scoring(mode=sc.mode, match=sc.match, mismatch=sc.mismatch,
                         gap=sc.gap, gap_open=sc.gap_open,
                         gap_extend=sc.gap_extend)


def _pair(kind: str, m: int, n: int, seed: int) -> tuple:
    """A seeded pair with a planted shared segment, so the alignment is
    long and has gaps."""
    letters = KINDS[kind][3]
    rng = np.random.default_rng(seed)
    a = rng.integers(0, letters, m).astype(np.int8)
    b = rng.integers(0, letters, n).astype(np.int8)
    ln = min(m, n) // 3
    b[n // 4:n // 4 + ln] = a[m // 5:m // 5 + ln]
    b = np.delete(b, [n // 4 + 7, n // 4 + 8, n // 4 + 40])
    return a, b


def _kw(kind: str) -> tuple:
    sc, S, jS, _, alpha = KINDS[kind]
    return (dict(scoring=sc, substitution=S, alphabet=alpha),
            dict(scoring=_jsc(sc), substitution=jS, alphabet=alpha))


def _fields(r) -> tuple:
    return (r.max_score, r.max_i, r.max_j, r.last_cell, r.aligned_a,
            r.aligned_b)


@pytest.mark.parametrize("mn", SHAPES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_score_on_card_matches_jax(cuda, kind, mn):
    ours, theirs = _kw(kind)
    ours.pop("alphabet"), theirs.pop("alphabet")
    a, b = _pair(kind, *mn, seed=1)
    sf.reset_counts()
    got = swtpu_torch.score(a, b, plan="stripe", device=cuda, **ours)
    sc, S = KINDS[kind][:2]
    assert sf.launches[sf.score_kernel_name(sc, S)] == 1
    assert got == swtpu.score(a, b, **theirs)
    r = swtpu_torch.align(a, b, traceback=False, plan="stripe", device=cuda,
                          **ours)
    j = swtpu.align(a, b, traceback=False, **theirs)
    assert (r.max_score, r.max_i, r.max_j, r.last_cell) == (
        j.max_score, j.max_i, j.max_j, j.last_cell)


@pytest.mark.parametrize("mn", SHAPES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_full_p_align_on_card_matches_jax(cuda, kind, mn):
    ours, theirs = _kw(kind)
    a, b = _pair(kind, *mn, seed=2)
    sc, S = KINDS[kind][:2]
    sf.reset_counts()
    r = swtpu_torch.align(a, b, plan="stripe", device=cuda, **ours)
    assert r.plan == "stripe"
    assert sf.launches[sf.fill_kernel_name(sc, S)] == 1
    j = swtpu.align(a, b, return_matrices=True, **theirs)
    assert _fields(r) == _fields(j) and r.max_pos == j.max_pos
    assert r.path == j.path
    # the predecessor codes: K4's P against the JAX package's
    at, bt = (torch.from_numpy(x).to(cuda) for x in (a, b))
    sub = None if S is None else torch.from_numpy(S).to(cuda)
    P = sf.stripe_fill(at, bt, sc, substitution=sub).P.cpu().numpy()
    np.testing.assert_array_equal(P, np.asarray(j.P))


@pytest.mark.parametrize("kind", list(KINDS))
def test_lean_align_on_card_matches_jax(cuda, kind):
    ours, theirs = _kw(kind)
    a, b = _pair(kind, 512, 700, seed=3)
    sc, S = KINDS[kind][:2]
    sf.reset_counts()
    r = swtpu_torch.align(a, b, config=EngineConfig(
        traceback_method="windowed"), plan="stripe", device=cuda, **ours)
    # the locate's forward pass, its reverse pass, the refill, the walk
    assert sf.launches[sf.score_kernel_name(sc, S)] >= 1
    assert sf.launches[sf.block_route_name(sc, S)] >= 1
    assert sf.launches[sf.fill_kernel_name(sc, S)] >= 1
    assert sf.launches[sf.WALK_KERNEL] >= 1
    score, loc, ra, rb = jtb.windowed(a, b, theirs["scoring"],
                                      sub=theirs["substitution"],
                                      alphabet=theirs["alphabet"])
    assert (r.max_score, r.max_i, r.max_j, r.last_cell, r.aligned_a,
            r.aligned_b) == (score, loc.end_i, loc.end_j, loc.last_cell,
                             ra, rb)
    j = swtpu.align(a, b, **theirs)
    assert (r.max_score, r.max_i, r.max_j) == (j.max_score, j.max_i,
                                               j.max_j)


@pytest.mark.parametrize("band", [0, 8, 64])
@pytest.mark.parametrize("kind", list(KINDS))
def test_banded_align_on_card_matches_jax(cuda, kind, band):
    ours, theirs = _kw(kind)
    a, b = _pair(kind, 512, 700, seed=4)
    sc, S = KINDS[kind][:2]
    sf.reset_counts()
    r = swtpu_torch.align(a, b, config=EngineConfig(band=band),
                          plan="stripe", device=cuda, **ours)
    assert sf.launches[sf.fill_kernel_name(sc, S, banded=True)] == 1
    # the JAX stripe path ignores band=0 (``if band:``); its scan keeps
    # the diagonal, which the port follows
    j = swtpu.align(a, b, config=swtpu.EngineConfig(band=band),
                    plan="scan", return_matrices=True, **theirs)
    assert _fields(r) == _fields(j) and r.path == j.path


@pytest.mark.parametrize("kind", list(KINDS))
def test_batch_score_on_card_matches_jax(cuda, kind):
    ours, theirs = _kw(kind)
    ours.pop("alphabet"), theirs.pop("alphabet")
    pairs = [_pair(kind, 300, 280, seed=10 + i) for i in range(12)]
    n = min(len(b) for _, b in pairs)
    aa = np.stack([a for a, _ in pairs])
    bb = np.stack([b[:n] for _, b in pairs])
    sc, S = KINDS[kind][:2]
    pf.reset_counts()
    got = swtpu_torch.batch_score(aa, bb, plan="stripe", device=cuda, **ours)
    assert pf.launches[pf.pairs_kernel_name(sc, S)] == 1
    want = swtpu.batch_score(aa, bb, **theirs)
    for x, y in zip(got, want):
        assert x.cpu().tolist() == np.asarray(y).tolist()


@pytest.mark.parametrize("kind", list(KINDS))
def test_search_on_card_matches_jax(cuda, kind):
    ours, theirs = _kw(kind)
    ours.pop("alphabet"), theirs.pop("alphabet")
    letters = KINDS[kind][3]
    rng = np.random.default_rng(20)
    ref = rng.integers(0, letters, 6000).astype(np.int8)
    reads = []
    for i in range(24):
        s = int(rng.integers(0, len(ref) - 80))
        r = ref[s:s + 60 + i].copy()
        r[::9] = (r[::9] + 1) % letters
        reads.append(r)
    reads.append(rng.integers(0, letters, 70).astype(np.int8))
    q = pad_queries(reads, 96)
    sc, S = KINDS[kind][:2]
    pf.reset_counts()
    got = swtpu_torch.search(q, ref, window=2048, device=cuda, **ours)
    assert wf.launches[wf.window_route_name(96, sc, S)] >= 1
    want = swtpu.search(q, ref, window=2048, **theirs)
    for x, y in zip(got, want):
        assert x.cpu().tolist() == np.asarray(y).tolist()
