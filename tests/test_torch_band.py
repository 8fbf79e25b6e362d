"""Banded fills (K4b) in the port against the JAX package.

On the CPU the port's banded ``scan_fill`` is held against the JAX scan,
its banded stripe wrappers (plain versions here) against the Pallas stripe
kernel's band mode in interpret mode, and ``align``/``score`` with
``EngineConfig(band=)`` against ``swtpu.align``/``swtpu.score``. The band
form of the register-blocked stripe (``csrc/stripe_rb_band.cu``, each
stripe visiting only the columns its rows' band reaches) runs only on a
card; here the Python model of its schedule (``rb_model(band=)`` of
``test_torch_stripe_rb``) is held against the plain versions and the JAX
scan at the edges of its windows. The DP is integer: every comparison is
exact. The ``gpu`` tests hold the banded kernels against their plain
versions on the card and skip elsewhere."""

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
from test_torch_stripe_rb import KPUBLISH, rb_model, rb_window

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


# (kind, m, n, band, T, R, C) of the band form: |n - m| > band either way,
# a band wider than a stripe's rows and than the pair, band -1 and 0,
# windows ending inside, at and past a chunk of 32 columns (128-row
# stripes, band 31 / 32 / 33: stripe 1's window then starts on a chunk, so
# its first DIAG is the row above's), n not a multiple of T*R, two warps,
# every tile
BAND_FORM_CASES = {
    "m_below_n_far": ("dna_linear", 100, 330, 7, 32, 4, 4),
    "m_above_n_far": ("dna_affine", 330, 100, 7, 32, 8, 2),
    "band_wider_than_a_stripe": ("protein", 300, 290, 200, 32, 4, 4),
    "band_minus_one": ("dna_linear", 120, 150, -1, 32, 8, 4),
    "band_zero": ("protein_linear", 150, 160, 0, 32, 8, 4),
    "window_ends_inside_a_chunk": ("dna_linear", 300, 300, 31, 32, 4, 4),
    "window_ends_at_a_chunk": ("dna_affine", 300, 300, 32, 32, 4, 4),
    "window_ends_past_a_chunk": ("protein", 300, 300, 33, 32, 4, 4),
    "two_warps_ragged": ("dna_affine", 260, 700, 64, 64, 8, 2),
    "band_wider_than_the_pair": ("protein_linear", 90, 200, 5000, 32, 8, 4),
}


def _jax_band(a, b, sc, S, band):
    """The JAX scan's banded fill: ((4,) best, right column, row-major P)."""
    jx = jax_scan_fill(jnp.asarray(a), jnp.asarray(b),
                       scoring=_jax_scoring(sc), return_p=True, band=band,
                       sub_table=None if S is None else
                       jnp.asarray(jax_embed(S)))
    P = diag_to_rowmajor(torch.from_numpy(np.array(jx.p_diag)), len(b),
                         len(a)).numpy()
    return ([int(jx.max_score), int(jx.max_i), int(jx.max_j),
             int(jx.last_cell)], np.asarray(jx.right_col), P)


@pytest.mark.parametrize("case", list(BAND_FORM_CASES))
def test_band_form_model_matches_plain_and_jax(case):
    kind, m, n, band, T, R, C = BAND_FORM_CASES[case]
    a, b, sc, S = _pair(kind, m, n, seed=406)
    m, n = len(a), len(b)
    clamped = sf._clamp_band(band, m, n)          # as the wrapper passes it
    extra = {}
    got, right = rb_model(a, b, sc, T, R, C, S, capture_p=True, extra=extra,
                          band=clamped)
    assert rb_model(a, b, sc, T, R, C, S, band=clamped) == (got, right)
    plain = sf.stripe_fill_plain(_t(a), _t(b), sc, _t(S), band)
    assert got == plain.best.tolist()
    assert right == plain.right_col.tolist()
    np.testing.assert_array_equal(extra["P"], plain.P.numpy())
    want, want_right, want_P = _jax_band(a, b, sc, S, band)
    assert got == want
    np.testing.assert_array_equal(right, want_right)
    np.testing.assert_array_equal(extra["P"], want_P)


@pytest.mark.parametrize("band", [-1, 0, 5, 31, 32, 33, 200, 5000])
@pytest.mark.parametrize("m, n, T, R, C", [(300, 290, 32, 4, 4),
                                           (100, 700, 64, 8, 2),
                                           (700, 100, 32, 8, 4)])
def test_band_windows_cover_the_band_alone(m, n, T, R, C, band):
    """Each stripe's window (``rb_window``, csrc/stripe_rb.cuh
    ``band_window``) starts on a chunk, holds every column its rows' band
    reaches and ends in the tile holding the last; none when band < 0 or
    the band has left the matrix; the windows do not move left."""
    last = (0, 0, 0)
    for s in range(-(-n // (T * R))):
        col0, tiles, end = rb_window(s, T, R, C, m, n, band)
        r0, r1 = s * T * R + 1, min(n, (s + 1) * T * R)
        lo, hi = max(1, r0 - band), min(m, r1 + band)
        assert col0 % KPUBLISH == 0 and col0 % C == 0
        if band < 0 or lo > hi:
            assert tiles == 0 and end == col0
            continue
        assert col0 < lo <= col0 + KPUBLISH
        assert end == min(m, col0 + tiles * C) and end - C < hi <= end
        assert col0 >= last[0] and end >= last[2]
        last = (col0, tiles, end)


@pytest.mark.parametrize("m, n, band", [(40, 200, 5), (200, 40, 5),
                                        (150, 300, 140), (100, 120, -1),
                                        (64, 300, 0)])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_band_edges_match_jax(kind, m, n, band):
    """The plain banded versions against the JAX scan where the band form
    leaves whole stripes out: |n - m| > band, a band wider than one
    stripe's rows, band -1."""
    a, b, sc, S = _pair(kind, m, n, seed=407)
    plain = sf.stripe_fill_plain(_t(a), _t(b), sc, _t(S), band)
    score = sf.stripe_score_plain(_t(a), _t(b), sc, _t(S), band)
    want, want_right, want_P = _jax_band(a, b, sc, S, band)
    assert plain.best.tolist() == score.best.tolist() == want
    np.testing.assert_array_equal(plain.right_col.numpy(), want_right)
    np.testing.assert_array_equal(score.right_col.numpy(), want_right)
    np.testing.assert_array_equal(plain.P.numpy(), want_P)


def test_rb_shape_of_the_band_form():
    for kind, defaults in (("band", sf.RB_BAND_DEFAULTS),
                           ("fill_p_band", sf.RB_BAND_P_DEFAULTS)):
        assert set(defaults) == {"linear", "affine", "sub"}
        for mode, (T, R, C) in defaults.items():
            assert (R, C) in sf.RB_EXT_TILES and T <= sf.RB_EXT_MAX_THREADS
            assert sf.rb_shape(16384, mode=mode, A=21, kind=kind) == \
                (T, R, C)
            for R_, C_ in sf.RB_EXT_TILES:
                assert sf.rb_shape(40, None, R_, C_, mode, 21, kind) == \
                    (32, R_, C_)
                for T_ in (32, 64, 128, 256):
                    assert sf.rb_shape(16384, T_, R_, C_, mode, 21,
                                       kind) == (T_, R_, C_)
            # the launch bounds of csrc/stripe_rb_band.cu: above 256
            # threads only the R = 4 tile
            assert sf.rb_shape(16384, 512, mode=mode, A=21, kind=kind) == \
                (512, *sf.RB_WIDE_TILE)
            for bad in (dict(T=544), dict(T=16), dict(T=512, R=8, C=4),
                        dict(R=16, C=4), dict(R=8, C=8)):
                with pytest.raises(ValueError, match="multiple|tiles"):
                    sf.rb_shape(1000, mode=mode, A=21, kind=kind, **bad)


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
        # a band runs the register-blocked stripe's band form, score-only
        # and with P; unbanded calls its K1-K4 and every block fill its K5
        assert sf.score_kernel_name(sc, S, True) == f"sw_stripe_rb_band_{mode}"
        assert sf.fill_kernel_name(sc, S, True) == \
            f"sw_stripe_rb_fill_p_band_{mode}"
        assert sf.fill_kernel_name(sc, S) == f"sw_stripe_rb_fill_p_{mode}"
        assert sf.block_route_name(sc, S) == f"sw_stripe_rb_block_{mode}"
    # the walk: the tile-staged entry, and the one-thread one beside it
    assert sf.WALK_KERNEL == "sw_walk_p_tiled"
    assert sf.WALK_SCALAR_KERNEL == "sw_walk_p"
    assert len(sf.launches) == 32 and sf.WALK_KERNEL in sf.launches \
        and sf.WALK_SCALAR_KERNEL in sf.launches


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
    assert sf.launches[sf.score_kernel_name(sc, S, True)] == 2
    assert sf.launches[sf.fill_kernel_name(sc, S, True)] == 2
    assert sf.launches[sf.kernel_name(sc, S, False, True)] == 0
    assert sf.launches[sf.kernel_name(sc, S, True, True)] == 0
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
    assert sf.launches[sf.fill_kernel_name(sc, S, True)] == 1
    assert sf.launches[sf.WALK_KERNEL] == 0   # its P is walked on the host
    assert sf.launches[sf.kernel_name(sc, S, True, True)] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BAND_FORM_CASES))
def test_band_form_kernels_match_plain_on_card(cuda, case):
    """The band form's entries at the model's cases, each at its own (T,
    R, C), the default and every (T, R, C) of chip_smoke.py's sweep, P
    into a guarded buffer: no byte off P written."""
    from test_torch_stripe_rb_p import _guarded_p
    kind, m, n, band, T, R, C = BAND_FORM_CASES[case]
    a, b, sc, S = _pair(kind, m, n, seed=406)
    m, n = len(a), len(b)
    at, bt, St = _t(a, cuda), _t(b, cuda), _t(S, cuda)
    plain = sf.stripe_fill_plain(at, bt, sc, St, band)
    shapes = [(T, R, C), (None, None, None)] + [
        (T_, R_, C_) for T_ in (32, 64, 128) for R_, C_ in sf.RB_EXT_TILES]
    sf.reset_counts()
    for shape in shapes:
        got_s = sf._launch_rb(at, bt, sc, *shape, sub=St, band=band)
        P, buf, cells = _guarded_p(n, m, cuda)
        got_f = sf._launch_rb_p(at, bt, sc, *shape, sub=St, P=P, band=band)
        torch.cuda.synchronize()
        for got in (got_s, got_f):
            assert torch.equal(got.best, plain.best), shape
            assert torch.equal(got.right_col, plain.right_col), shape
        assert torch.equal(got_f.P, plain.P), shape
        assert bool((buf[~cells] == 0x5A).all()), shape
    assert sf.launches[sf.score_kernel_name(sc, St, True)] == len(shapes)
    assert sf.launches[sf.fill_kernel_name(sc, St, True)] == len(shapes)

