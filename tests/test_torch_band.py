"""Banded fills (K4b) in the port against the JAX package.

On the CPU the port's banded ``scan_fill`` is held against the JAX scan,
its banded stripe wrappers (plain versions here) against the Pallas stripe
kernel's band mode in interpret mode, and ``align``/``score`` with
``EngineConfig(band=)`` against ``swtpu.align``/``swtpu.score``. The DP is
integer: every comparison is exact. The ``gpu`` tests hold the banded
kernels against their plain versions on the card and skip elsewhere."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swtpu
import swtpu_torch
from swtpu.core.encode import PROTEIN_ALPHABET, random_pair
from swtpu.core.substitution import BLOSUM62 as JAX_BLOSUM62
from swtpu.core.substitution import embed_sentinels as jax_embed
from swtpu.kernels.pallas_fill import p_stripes_to_rowmajor, stripe_fill_raw
from swtpu.kernels.scan_fill import scan_fill as jax_scan_fill
from swtpu_torch import EngineConfig, Scoring
from swtpu_torch.convert import substitution_from_jax
from swtpu_torch.dispatch.plan import choose_exec
from swtpu_torch.kernels import stripe_fill as sf
from swtpu_torch.kernels.scan_fill import diag_to_rowmajor, embed_table, scan_fill

REPO = Path(__file__).resolve().parent.parent
DNA_AFFINE = Scoring(mode="affine")                          # 3/-3, -4/-1
PROTEIN_AFFINE = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
PROTEIN_LINEAR = Scoring(gap=-6)
BLOSUM62 = substitution_from_jax(JAX_BLOSUM62)


def _jax_scoring(sc: Scoring) -> swtpu.Scoring:
    return swtpu.Scoring(match=sc.match, mismatch=sc.mismatch, gap=sc.gap,
                         gap_open=sc.gap_open, gap_extend=sc.gap_extend,
                         mode=sc.mode)


def _t(x, device="cpu"):
    return None if x is None else torch.from_numpy(
        np.ascontiguousarray(x)).to(device)


def _pair(kind, m, n, seed):
    """(a, b, scoring, table or None): near-diagonal similarity, so the
    band cuts through the alignment."""
    rng = np.random.default_rng(seed)
    letters = 20 if kind.startswith("protein") else 4
    a = rng.integers(0, letters, m).astype(np.int8)
    b = a[:n].copy() if n <= m else np.concatenate(
        [a, rng.integers(0, letters, n - m).astype(np.int8)])
    flip = rng.random(n) < 0.3
    b[flip] = rng.integers(0, letters, int(flip.sum()))
    b = np.delete(b, [n // 3, n // 3 + 1, n // 2])        # shifts by 3
    sc = {"dna_linear": Scoring(), "dna_affine": DNA_AFFINE,
          "protein": PROTEIN_AFFINE, "protein_linear": PROTEIN_LINEAR}[kind]
    return a, b, sc, BLOSUM62 if kind.startswith("protein") else None


KINDS = ["dna_linear", "dna_affine", "protein"]


@pytest.mark.parametrize("band", [-1, 0, 1, 7, 500])
@pytest.mark.parametrize("kind", KINDS)
def test_scan_fill_band_matches_jax(kind, band):
    a, b, sc, S = _pair(kind, 45, 60, seed=400)
    m, n = len(a), len(b)
    jx = jax_scan_fill(jnp.asarray(a), jnp.asarray(b),
                       scoring=_jax_scoring(sc), return_p=True,
                       return_h=True, band=band,
                       sub_table=None if S is None else
                       jnp.asarray(jax_embed(S)))
    pt = scan_fill(_t(a), _t(b), scoring=sc, return_p=True, return_h=True,
                   band=band, sub_table=None if S is None else
                   embed_table(_t(S)))
    for name in ("max_score", "max_i", "max_j", "last_cell", "right_col",
                 "bottom_row", "h_diag", "p_diag", "bottom_f", "right_e"):
        got, want = getattr(pt, name), getattr(jx, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          name)
    P = diag_to_rowmajor(pt.p_diag, n, m).numpy()
    ii, jj = np.nonzero(P)
    assert (np.abs(ii - jj) <= band).all()


# (kind, band): T=128 in the Pallas kernel, so n > 128 spans its stripes
STRIPE_CASES = [("dna_linear", 1), ("dna_linear", 10), ("dna_linear", 400),
                ("dna_affine", 6), ("protein", 8), ("protein_linear", 5)]


@pytest.mark.parametrize("kind, band", STRIPE_CASES)
def test_banded_stripe_wrappers_match_pallas(kind, band):
    a, b, sc, S = _pair(kind, 150, 260, seed=401)
    m, n = len(a), len(b)
    jx = stripe_fill_raw(a, b, scoring=_jax_scoring(sc), T=128, C=128,
                         return_p=True, substitution=S, band=band)
    want = [int(jx.max_score), int(jx.max_i), int(jx.max_j),
            int(jx.last_cell)]
    sf.reset_counts()
    score = sf.stripe_score(_t(a), _t(b), sc, substitution=_t(S), band=band)
    fill = sf.stripe_fill(_t(a), _t(b), sc, substitution=_t(S), band=band)
    assert sf.plain_calls["stripe_score_plain"] == 1
    assert sf.plain_calls["stripe_fill_plain"] == 1
    assert score.best.tolist() == want and fill.best.tolist() == want
    np.testing.assert_array_equal(score.right_col.numpy(), jx.right_col)
    np.testing.assert_array_equal(fill.right_col.numpy(), jx.right_col)
    np.testing.assert_array_equal(
        fill.P.numpy(), p_stripes_to_rowmajor(np.asarray(jx.p_stripes), n, m))


def test_band_zero_keeps_the_diagonal():
    # the JAX scan reads band=0 as the main diagonal alone; the port's
    # wrappers do the same (the Pallas kernel reads 0 as no band)
    a = np.array([0, 1, 2, 3, 0, 1], np.int8)
    b = np.array([1, 1, 2, 3, 0, 2, 2], np.int8)
    fill = sf.stripe_fill(_t(a), _t(b), band=0)
    jx = jax_scan_fill(jnp.asarray(a), jnp.asarray(b), band=0)
    assert fill.best.tolist() == [int(jx.max_score), int(jx.max_i),
                                  int(jx.max_j), int(jx.last_cell)] \
        == [12, 5, 5, 0]
    ii, jj = np.nonzero(fill.P.numpy())
    assert (ii == jj).all() and len(ii) == 5


def _fields(r):
    return (r.max_score, r.max_i, r.max_j, r.last_cell, r.max_pos,
            r.aligned_a, r.aligned_b, r.path)


@pytest.mark.parametrize("plan", [None, "scan", "stripe"])
@pytest.mark.parametrize("band", [2, 15])
@pytest.mark.parametrize("kind", KINDS)
def test_align_band_matches_jax(kind, band, plan):
    a, b, sc, S = _pair(kind, 80, 90, seed=402)
    alpha = PROTEIN_ALPHABET if S is not None else "ACGT"
    want = swtpu.align(a, b, _jax_scoring(sc), swtpu.EngineConfig(band=band),
                       substitution=None if S is None else JAX_BLOSUM62,
                       alphabet=alpha)
    sf.reset_counts()
    got = swtpu_torch.align(a, b, sc, EngineConfig(band=band), plan=plan,
                            substitution=S, alphabet=alpha, device="cpu")
    assert _fields(got) == _fields(want)
    assert got.max_score > 0 and got.path
    # the band takes full P even above full_p_max_cells
    cfg = EngineConfig(band=band, full_p_max_cells=100)
    assert _fields(swtpu_torch.align(a, b, sc, cfg, substitution=S,
                                     alphabet=alpha, device="cpu")) == \
        _fields(want)
    if plan == "stripe":      # the second call takes the CPU's scan plan
        assert sf.plain_calls["stripe_fill_plain"] == 1


@pytest.mark.parametrize("m, n", [(70, 60), (200, 40)])
@pytest.mark.parametrize("kind", KINDS)
def test_score_band_matches_jax(kind, m, n):
    # (200, 40): m > 2n takes the transposed route in both packages
    a, b, sc, S = _pair(kind, m, n + 3, seed=403)
    jS = None if S is None else JAX_BLOSUM62
    want = swtpu.score(a, b, _jax_scoring(sc), swtpu.EngineConfig(band=9),
                       substitution=jS)
    for plan in (None, "stripe"):
        assert swtpu_torch.score(a, b, sc, EngineConfig(band=9), plan=plan,
                                 substitution=S, device="cpu") == want
    r = swtpu_torch.align(a, b, sc, EngineConfig(band=9, traceback=False),
                          substitution=S, device="cpu")
    w = swtpu.align(a, b, _jax_scoring(sc),
                    swtpu.EngineConfig(band=9, traceback=False),
                    substitution=jS)
    assert _fields(r) == _fields(w)


def test_band_takes_the_stripe_plan_on_cuda():
    cuda = torch.device("cuda")     # choose_exec reads the type only
    cfg = EngineConfig(band=5)
    assert choose_exec(100, 100, cfg, Scoring(), True, cuda).plan == "stripe"
    assert choose_exec(100, 100, cfg, Scoring(mismatch=0), True,
                       cuda).plan == "scan"
    assert choose_exec(100, 100, cfg, Scoring(), True,
                       torch.device("cpu")).plan == "scan"


def test_banded_kernel_names():
    for sc, S, mode in ((Scoring(), None, "linear"),
                        (DNA_AFFINE, None, "affine"),
                        (PROTEIN_AFFINE, BLOSUM62, "sub")):
        # one C entry serves both; the banded launches count apart
        assert sf.kernel_name(sc, S, False, True) == \
            f"sw_stripe_score_{mode}[band]"
        assert sf.kernel_name(sc, S, True, True) == \
            f"sw_stripe_fill_p_{mode}[band]"
        assert sf.block_kernel_name(sc, S) == f"sw_stripe_block_{mode}"
        # a band keeps the template's K4b; unbanded calls the
        # register-blocked K4 and every block fill its K5
        assert sf.fill_kernel_name(sc, S, True) == \
            f"sw_stripe_fill_p_{mode}[band]"
        assert sf.fill_kernel_name(sc, S) == f"sw_stripe_rb_fill_p_{mode}"
        assert sf.block_route_name(sc, S) == f"sw_stripe_rb_block_{mode}"
    assert len(sf.launches) == 25 and sf.WALK_KERNEL in sf.launches


def test_cli_band_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "swtpu_torch", "90", "70", "--band", "4",
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    a, b = random_pair(90, 70, seed=0)
    want = swtpu.align(a, b, config=swtpu.EngineConfig(band=4))
    assert (f"Max score {want.max_score} at (i={want.max_i}, "
            f"j={want.max_j})") in proc.stdout
    assert f"  a: {want.aligned_a}\n  b: {want.aligned_b}" in proc.stdout


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("band", [0, 1, 64, 5000])
@pytest.mark.parametrize("kind", KINDS + ["protein_linear"])
def test_banded_kernels_match_plain_on_card(cuda, kind, band):
    # T=32 with ragged n: many stripes, more than a band's width apart
    a, b, sc, S = _pair(kind, 400, 32 * 40 + 10, seed=404)
    args = (_t(a, cuda), _t(b, cuda), sc)
    plain = sf.stripe_fill_plain(*args, _t(S, cuda), band)
    sf.reset_counts()
    for _ in range(2):          # ordering races show as run-to-run changes
        got_s = sf.stripe_score(*args, T=32, substitution=_t(S, cuda),
                                band=band)
        got_f = sf.stripe_fill(*args, T=32, substitution=_t(S, cuda),
                               band=band)
        torch.cuda.synchronize()
        assert torch.equal(got_s.best, plain.best)
        assert torch.equal(got_s.right_col, plain.right_col)
        assert torch.equal(got_f.best, plain.best)
        assert torch.equal(got_f.P, plain.P)
    assert sf.launches[sf.kernel_name(sc, S, False, True)] == 2
    assert sf.launches[sf.kernel_name(sc, S, True, True)] == 2
    assert not any(sf.plain_calls.values())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_banded_align_on_card_matches_cpu(cuda, kind):
    a, b, sc, S = _pair(kind, 900, 1000, seed=405)
    kw = dict(substitution=S, config=EngineConfig(band=20),
              alphabet=PROTEIN_ALPHABET if S is not None else "ACGT")
    want = swtpu_torch.align(a, b, sc, device="cpu", **kw)
    sf.reset_counts()
    got = swtpu_torch.align(a, b, sc, device="cuda", **kw)
    assert _fields(got) == _fields(want)
    assert sf.launches[sf.kernel_name(sc, S, True, True)] == 1
