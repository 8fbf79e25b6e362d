"""The register-blocked stripe's P-capture (K4) and block (K5) forms
against the JAX package, on the CPU.

The CUDA kernels (``stripe_rb_kernel``'s kP and kBlock instantiations,
``swtpu_torch/csrc/stripe_rb.cuh``, entries in ``stripe_rb_p.cu`` and
``stripe_rb_block.cu``) run only on a card. Here the Python model of the
tile's schedule (``rb_model`` of ``test_torch_stripe_rb``) runs their
forms: K4 stores each cell's code under the template's tie order, a row's
codes of a whole tile at once and the tile holding column m a byte a
cell, rows past n and columns past m never, row 0 and column 0 NONE; K5 starts each row's LEFT chain
from the injected column 0, stripe 0 from the injected row 0, runs the
global recurrence without the zero floor, and exports E of column m and H
and F of row n. The model's answers must equal the port's plain versions
(``stripe_fill_plain``, ``stripe_block_plain``), the JAX package's Pallas
kernels in interpret mode (``stripe_fill_raw(return_p=True)`` through
``p_stripes_to_rowmajor``; ``stripe_block_fn``) and its numpy oracle's P.
Tolerance: exact equality (integer DP). The route tests record the
launches instead of running them; the ``gpu`` tests hold each new entry
against its plain version on a card and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.core import oracle
from swtpu.core.encode import random_pair
from swtpu.kernels.pallas_fill import (p_stripes_to_rowmajor,
                                       stripe_block_fn, stripe_fill_raw)
import swtpu_torch
from swtpu_torch.core.substitution import BLOSUM62
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import stripe_fill as sf
from test_torch_stripe_rb import (DNA_AFFINE, E_EXT, LINEAR, NEG, PROTEIN,
                                  PROTEIN_LINEAR, _gapped, _jax_scoring,
                                  _oracle_table, _protein, _sentinels,
                                  _two_letter, rb_model)

# (pair, scoring, table, T, R, C): n < 32, m = 1, n past one stripe and
# not a multiple of T*R, m not a multiple of C, two warps a block,
# sentinels in both (and N against N), ties, gaps across a warp's and a
# stripe's border, each tile
P_CASES = {
    "linear_n_below_32": (lambda: random_pair(40, 20, seed=51), LINEAR,
                          None, 32, 4, 4),
    "linear_m_is_1_packed": (lambda: random_pair(1, 70, seed=52), LINEAR,
                             None, 32, 8, 2),
    "linear_three_stripes_ragged": (lambda: random_pair(100, 300, seed=53),
                                    LINEAR, None, 32, 4, 4),
    "linear_m_not_a_tile_packed": (lambda: random_pair(75, 300, seed=54),
                                   LINEAR, None, 32, 8, 4),
    "linear_two_warps_C2_packed": (lambda: random_pair(97, 600, seed=55),
                                   LINEAR, None, 64, 8, 2),
    "linear_ties_packed": (lambda: _two_letter(90, 260, seed=56), LINEAR,
                           None, 32, 4, 4),
    "dna_affine_three_stripes_ragged": (
        lambda: random_pair(100, 300, seed=57), DNA_AFFINE, None, 32, 4, 4),
    "dna_affine_gaps_across_warps_and_stripes": (
        lambda: _gapped(4, 35), DNA_AFFINE, None, 64, 4, 4),
    "dna_affine_sentinels_n_vs_n": (
        lambda: _sentinels(random_pair(90, 260, seed=58), 58), DNA_AFFINE,
        None, 32, 8, 4),
    "dna_affine_ties": (lambda: _two_letter(90, 260, seed=59), DNA_AFFINE,
                        None, 32, 8, 2),
    "blosum62_affine_gaps_across_warps_and_stripes": (
        lambda: _gapped(20, 36), PROTEIN, BLOSUM62, 64, 4, 4),
    "blosum62_affine_sentinels_packed": (
        lambda: _sentinels(_protein(60, 280, 60), 60), PROTEIN, BLOSUM62, 32,
        4, 4),
    "blosum62_linear_sentinels_n_below_32": (
        lambda: _sentinels(_protein(50, 24, 61), 61), PROTEIN_LINEAR,
        BLOSUM62, 32, 8, 4),
    "blosum62_linear_three_stripes_packed": (
        lambda: _protein(97, 300, 62), PROTEIN_LINEAR, BLOSUM62, 32, 8, 2),
}


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", list(P_CASES))
def test_rb_p_model_matches_plain_jax_and_oracle(case):
    pair, sc, S, T, R, C = P_CASES[case]
    a, b = pair()
    m, n = len(a), len(b)
    extra = {}
    got, right = rb_model(a, b, sc, T, R, C, S, capture_p=True, extra=extra)
    plain = sf.stripe_fill_plain(_t(a), _t(b), sc, _t(S))
    assert got == plain.best.tolist()
    assert right == plain.right_col.tolist()
    np.testing.assert_array_equal(extra["P"], plain.P.numpy())
    ref = oracle.fill(a, b, _jax_scoring(sc),
                      None if S is None else _oracle_table(S))
    np.testing.assert_array_equal(extra["P"], ref.P)
    jx = stripe_fill_raw(a, b, _jax_scoring(sc), T=128, C=128, return_p=True,
                         substitution=S)
    assert got == [int(jx.max_score), int(jx.max_i), int(jx.max_j),
                   int(jx.last_cell)]
    jp = p_stripes_to_rowmajor(np.asarray(jx.p_stripes), n, m)
    # the Pallas kernel departs from its own oracle only by E_EXT bits on
    # the rows of a sentinel code in DNA affine (its E starts at -2^24,
    # not NEG; ROADMAP Queue 3): the model follows the oracle there
    off = jp != ref.P
    assert ((jp ^ ref.P)[off] == E_EXT).all()
    assert not off.any() or (sc.is_affine and S is None
                             and (b[np.nonzero(off)[0] - 1] < 0).all())
    np.testing.assert_array_equal(extra["P"][~off], jp[~off])
    assert got[0] > 0


def _bounds(m, n, seed, anchored):
    """(top, left, top_f, left_e): random finite boundaries sharing the
    corner, or the anchored reverse pass's NEG ones with a zero origin."""
    rng = np.random.default_rng(seed)
    if anchored:
        top, left = (np.full(k + 1, NEG, np.int32) for k in (m, n))
        top[0] = left[0] = 0
        return top, left, np.full(m + 1, NEG, np.int32), \
            np.full(n + 1, NEG, np.int32)
    top = rng.integers(-40, 40, m + 1).astype(np.int32)
    left = rng.integers(-40, 40, n + 1).astype(np.int32)
    left[0] = top[0]
    return (top, left, rng.integers(-50, 20, m + 1).astype(np.int32),
            rng.integers(-50, 20, n + 1).astype(np.int32))


def _block_pair(kind, m, n, seed):
    if kind.startswith("protein"):
        return _protein(m, n, seed)
    return random_pair(m, n, seed=seed)


# (kind, m, n, local, anchored, T, R, C): several stripes; n % R != 0 puts
# row n inside a thread's rows (the JAX kernel exports row n only when
# n % 128 == 0, so only those cases hold its bottom row)
BLOCK_CASES = {
    "dna_linear_global_injected": ("dna_linear", 70, 200, False, False, 32,
                                   4, 4),
    "dna_linear_local_injected_n_128": ("dna_linear", 60, 128, True, False,
                                        32, 8, 4),
    "dna_linear_global_anchored": ("dna_linear", 90, 150, False, True, 32, 4,
                                   4),
    "dna_linear_global_row_n_inside": ("dna_linear", 45, 131, False, False,
                                       32, 4, 4),
    "dna_affine_global_injected_n_256": ("dna_affine", 70, 256, False, False,
                                         32, 4, 4),
    "dna_affine_global_anchored_C2": ("dna_affine", 80, 130, False, True, 32,
                                      8, 2),
    "dna_affine_local_injected_row_n_inside": ("dna_affine", 50, 261, True,
                                               False, 32, 8, 2),
    "protein_global_injected_n_128": ("protein", 64, 128, False, False, 32,
                                      4, 4),
    "protein_local_anchored": ("protein", 75, 140, True, True, 32, 8, 4),
    "protein_linear_global_injected": ("protein_linear", 70, 131, False,
                                       False, 32, 4, 4),
}


def _block_scoring(kind):
    return {"dna_linear": (LINEAR, None), "dna_affine": (DNA_AFFINE, None),
            "protein": (PROTEIN, BLOSUM62),
            "protein_linear": (PROTEIN_LINEAR, BLOSUM62)}[kind]


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_rb_block_model_matches_plain_and_jax(case):
    kind, m, n, local, anchored, T, R, C = BLOCK_CASES[case]
    sc, S = _block_scoring(kind)
    a, b = _block_pair(kind, m, n, m * n)
    top, left, tf, le = _bounds(m, n, m + n, anchored)
    if not sc.is_affine:
        tf = le = None
    block = dict(top=top, left=left, top_f=tf, left_e=le, local=local,
                 want_bottom=True)
    extra = {}
    got, right = rb_model(a, b, sc, T, R, C, S, block=block, extra=extra)
    plain = sf.stripe_block_plain(_t(a), _t(b), sc, _t(top), _t(left),
                                  _t(tf), _t(le), local=local,
                                  substitution=_t(S), want_bottom=True)
    assert got == plain.best.tolist()
    assert right == plain.right_col.tolist()
    assert extra["bottom"] == plain.bottom_row.tolist()
    if sc.is_affine:
        assert extra["right_e"] == plain.right_e.tolist()
        assert extra["bottom_f"] == plain.bottom_f.tolist()
    else:
        assert plain.right_e is None and plain.bottom_f is None
    want_bottom = n % 128 == 0
    fn = stripe_block_fn(m, n, _jax_scoring(sc), T=128, local=local,
                         want_bottom=want_bottom, substitution=S)
    jargs = [jnp.asarray(x) for x in (a, b, top, left)]
    if sc.is_affine:
        jargs += [jnp.asarray(tf), jnp.asarray(le)]
    want = fn(*jargs)
    assert got[:3] == [int(v) for v in want[:3]]
    assert got[0] > 0
    if anchored:
        # the Pallas kernel clamps NEG E/F boundaries to -2^24, so only
        # the (positive) max is comparable; the plain scan holds the rest
        return
    assert got[3] == int(want[3])
    np.testing.assert_array_equal(right, want[5])
    if want_bottom:
        np.testing.assert_array_equal(extra["bottom"], want[4])
    if sc.is_affine:
        np.testing.assert_array_equal(extra["right_e"][1:],
                                      np.asarray(want[7])[1:])
        if want_bottom:
            np.testing.assert_array_equal(extra["bottom_f"][1:],
                                          np.asarray(want[6])[1:])


def test_rb_block_model_gaps_across_warps_and_stripes():
    """The anchored reverse pass of a pair whose best path's vertical gaps
    cross a warp's and a stripe's border (T = 64, R = 4): the model's F
    hand-off, against the plain scan, in DNA affine and BLOSUM62."""
    for (a, b), sc, S in ((_gapped(4, 35), DNA_AFFINE, None),
                          (_gapped(20, 36), PROTEIN, BLOSUM62)):
        ar, br = a[::-1].copy(), b[::-1].copy()
        m, n = len(ar), len(br)
        top, left, tf, le = _bounds(m, n, 0, True)
        extra = {}
        got, right = rb_model(ar, br, sc, 64, 4, 4, S, block=dict(
            top=top, left=left, top_f=tf, left_e=le, local=False,
            want_bottom=True), extra=extra)
        plain = sf.stripe_block_plain(_t(ar), _t(br), sc, _t(top), _t(left),
                                      _t(tf), _t(le), local=False,
                                      substitution=_t(S), want_bottom=True)
        assert got == plain.best.tolist() and got[0] > 0
        assert right == plain.right_col.tolist()
        assert extra["right_e"] == plain.right_e.tolist()
        assert extra["bottom"] == plain.bottom_row.tolist()
        assert extra["bottom_f"] == plain.bottom_f.tolist()


# ---- the routes, the shapes and P's layout, as pure Python ----

FORMS = {"linear": (LINEAR, None), "affine": (DNA_AFFINE, None),
         "sub_affine": (PROTEIN, BLOSUM62),
         "sub_linear": (PROTEIN_LINEAR, BLOSUM62)}


def _record(monkeypatch):
    """The route of a card, each launch recorded instead of run."""
    seen = []
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call",
                        lambda name, dev, args, *rest: seen.append(
                            (name, rest[0] if rest else name, args)))
    return seen


@pytest.mark.parametrize("form", list(FORMS))
def test_fill_launches_the_rb_p_entry(form, monkeypatch):
    """Unbanded stripe_fill on a card launches the form's register-blocked
    K4 entry with the arguments its ctypes signature declares, at
    rb_shape's (T, R, C), into P's storage with P's row pitch; a band its
    band form, with the band (clamped to m + n) after the pitch, into a P
    cleared first."""
    sc, S = FORMS[form]
    a, b = (_protein(70, 900, 70) if S is not None
            else random_pair(70, 900, seed=70))
    St = _t(S)
    seen = _record(monkeypatch)
    out = sf.stripe_fill(_t(a), _t(b), sc, substitution=St)
    banded = sf.stripe_fill(_t(a), _t(b), sc, substitution=St, band=8)
    wide = sf.stripe_fill(_t(a), _t(b), sc, substitution=St, band=10 ** 6)
    (name, _, args), (band_name, _, band_args), (_, _, wide_args) = seen
    mode = sf._mode(sc, St)
    assert name == sf.RB_P_KERNELS[mode] == sf.fill_kernel_name(sc, St)
    assert band_name == sf.fill_kernel_name(sc, St, True) \
        == sf.RB_BAND_P_KERNELS[mode]
    assert len(band_args) + 1 == len(_cuda.ARGTYPES[band_name])
    assert band_args[-3:] == [banded.P.data_ptr(), banded.P.stride(0), 8]
    assert wide_args[-1] == 70 + 900
    assert not banded.P.any()             # cleared: the launch was recorded
    tail = 7 if mode == "linear" else 8   # sync ... P, pitch, band
    assert tuple(band_args[-tail - 3:-tail]) == sf.rb_shape(
        900, mode=mode, A=21, kind="fill_p_band")
    assert len(args) + 1 == len(_cuda.ARGTYPES[name])        # + the stream
    assert out.P.shape == (901, 71)
    assert args[-2:] == [out.P.data_ptr(), out.P.stride(0)]
    tail = 6 if mode == "linear" else 7     # sync, bnd, [bnd_f,] best, ...
    assert tuple(args[-tail - 3:-tail]) == sf.rb_shape(900, mode=mode, A=21,
                                                       kind="fill_p")


@pytest.mark.parametrize("form", list(FORMS))
def test_block_launches_the_rb_block_entry(form, monkeypatch):
    """stripe_block on a card launches the form's register-blocked K5
    entry with the arguments its ctypes signature declares, at
    rb_shape's (T, R, C), and [0] of each export is the boundaries'."""
    sc, S = FORMS[form]
    a, b = (_protein(70, 900, 71) if S is not None
            else random_pair(70, 900, seed=71))
    top, left, tf, le = _bounds(70, 900, 5, False)
    if not sc.is_affine:
        tf = le = None
    seen = _record(monkeypatch)
    out = sf.stripe_block(_t(a), _t(b), sc, _t(top), _t(left), _t(tf),
                          _t(le), local=False, substitution=_t(S),
                          want_bottom=True)
    ((name, _, args),) = seen
    mode = sf._mode(sc, _t(S))
    assert name == sf.RB_BLOCK_KERNELS[mode] == sf.block_route_name(sc, S)
    assert name != sf.block_kernel_name(sc, S)      # the template's K5
    assert len(args) + 1 == len(_cuda.ARGTYPES[name])
    # a, b, m, n, the model, then T, R, C and local
    k = 4 + len(sf._model(sc, _t(S)))
    assert args[k:k + 4] == [*sf.rb_shape(900, mode=mode, A=21,
                                          kind="block"), 0]
    assert int(out.right_col[0]) == top[70]
    assert int(out.bottom_row[0]) == left[900]
    if sc.is_affine:
        assert int(out.right_e[0]) == NEG and int(out.bottom_f[0]) == NEG


def test_rb_shape_of_the_k4_and_k5_forms():
    # the cases' tiles are instantiated ones, which the card tests launch
    for case in P_CASES.values():
        assert (case[4], case[5]) in sf.RB_EXT_TILES
    for case in BLOCK_CASES.values():
        assert (case[6], case[7]) in sf.RB_EXT_TILES
    for kind, defaults in (("fill_p", sf.RB_P_DEFAULTS),
                           ("block", sf.RB_BLOCK_DEFAULTS)):
        for mode in ("linear", "affine", "sub"):
            T, R, C = defaults[mode]
            assert (R, C) in sf.RB_EXT_TILES
            assert sf.rb_shape(25632, mode=mode, A=21, kind=kind) == (T, R, C)
            for R, C in sf.RB_EXT_TILES:
                assert sf.rb_shape(40, None, R, C, mode, 21, kind) == \
                    (32, R, C)
            assert sf.rb_shape(10 ** 6, sf.RB_EXT_MAX_THREADS, mode=mode,
                               A=21, kind=kind)[0] == sf.RB_EXT_MAX_THREADS
            # above RB_EXT_MAX_THREADS, up to RB_MAX_THREADS as on K1-K3,
            # only the R = 4 tile, the default there
            for T in (288, sf.RB_MAX_THREADS):
                assert sf.rb_shape(10 ** 6, T, mode=mode, A=21,
                                   kind=kind) == (T, *sf.RB_WIDE_TILE)
                assert sf.rb_shape(10 ** 6, T, *sf.RB_WIDE_TILE, mode, 21,
                                   kind) == (T, *sf.RB_WIDE_TILE)
            # a larger T raises, as on K1-K3: it is not clamped
            for bad in (dict(T=544), dict(T=1024), dict(T=16),
                        dict(T=288, R=8, C=4), dict(T=512, R=8, C=2),
                        dict(R=16, C=4), dict(R=8, C=1), dict(R=8, C=8)):
                with pytest.raises(ValueError, match=f"{kind}|tiles"):
                    sf.rb_shape(1000, mode=mode, A=21, kind=kind, **bad)


def test_p_matrix_layouts():
    """K4's P: rows padded to P_PITCH_ALIGN whose column 1 is word-aligned
    in the allocation (the kernel's word stores)."""
    P = sf.p_matrix(300, 75, torch.device("cpu"))
    base = P.untyped_storage().data_ptr()
    assert P.shape == (301, 76) and P.dtype == torch.int8
    assert P.stride() == (80, 1) and P.stride(0) % sf.P_PITCH_ALIGN == 0
    assert (P.data_ptr() + 1 - base) % 4 == 0
    assert P.untyped_storage().nbytes() == 3 + 301 * 80
    for m in (1, 2, 15, 16, 17, 25631):
        Q = sf.p_matrix(3, m, torch.device("cpu"))
        assert Q.stride(0) >= m + 1 and Q.stride(0) % 16 == 0
        assert (Q.data_ptr() + 1 - Q.untyped_storage().data_ptr()) % 4 == 0


def test_rb_p_takes_only_a_word_aligned_p(monkeypatch):
    """K4 stores words at column 1 of each row: a P whose column 1 or row
    pitch is not 4-byte aligned is refused before any launch."""
    seen = _record(monkeypatch)
    a, b = (_t(x) for x in random_pair(75, 300, seed=75))
    for bad in (torch.empty((301, 76), dtype=torch.int8),
                torch.empty(4 + 301 * 80, dtype=torch.int8)[4:]
                .view(301, 80)[:, :76]):
        with pytest.raises(ValueError, match="aligned"):
            sf._launch_rb_p(a, b, LINEAR, None, P=bad)
    assert not seen


@pytest.mark.parametrize("stripe_rows", [None, 64, 256, 512, 1024])
def test_stripe_rows_counts_threads_on_the_rb_p_route(stripe_rows,
                                                      monkeypatch):
    """EngineConfig.stripe_rows reaches the register-blocked K4 of the
    full-P align() as its threads per block, with one limit,
    RB_MAX_THREADS, as on K1-K3: above RB_EXT_MAX_THREADS the launch takes
    the R = 4 tile; above RB_MAX_THREADS the route raises rather than
    clamp."""
    a, b = random_pair(60, 5000, seed=15)
    cfg = swtpu_torch.EngineConfig(stripe_rows=stripe_rows)
    seen = []

    def call(name, dev, args, *rest):
        seen.append((name, *args[7:10]))       # T, R, C as launched

    # the route of a card, the launch recorded instead of run; the reduced
    # best a zero score, so that align() walks nothing
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call", call)
    monkeypatch.setattr(sf, "_reduce",
                        lambda *args: torch.zeros(4, dtype=torch.int32))

    def run():
        return swtpu_torch.align(a, b, config=cfg, plan="stripe",
                                 device="cpu")

    if stripe_rows is not None and stripe_rows > sf.RB_MAX_THREADS:
        with pytest.raises(ValueError, match="register-blocked"):
            run()
        assert not seen
        return
    run()
    T, R, C = sf.RB_P_DEFAULTS["linear"]
    if stripe_rows is not None:
        T = stripe_rows
        if T > sf.RB_EXT_MAX_THREADS:
            R, C = sf.RB_WIDE_TILE
    assert seen == [(sf.RB_P_KERNELS["linear"], T, R, C)]


def test_cpu_fill_and_block_run_the_plain_versions():
    a, b = random_pair(50, 90, seed=72)
    sf.reset_counts()
    fill = sf.stripe_fill(_t(a), _t(b))
    top, left, _, _ = _bounds(50, 90, 6, True)
    block = sf.stripe_block(_t(a), _t(b), LINEAR, _t(top), _t(left),
                            local=False, want_bottom=True)
    extra = {}
    got, _ = rb_model(a, b, LINEAR, 32, 8, 4, capture_p=True, extra=extra)
    assert fill.best.tolist() == got
    np.testing.assert_array_equal(fill.P.numpy(), extra["P"])
    got, _ = rb_model(a, b, LINEAR, 32, 8, 4, block=dict(
        top=top, left=left, local=False, want_bottom=True), extra=extra)
    assert block.best.tolist() == got
    assert block.bottom_row.tolist() == extra["bottom"]
    assert sf.plain_calls["stripe_fill_plain"] == 1
    assert sf.plain_calls["stripe_block_plain"] == 1
    assert not any(sf.launches.values())


# ---- the CUDA kernels on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _guarded_p(n, m, dev):
    """(P, buffer, P's cells as a mask of the buffer): P in K4's layout
    (``sf.p_matrix``) inside a buffer of 0x5A bytes, 64 of them before and
    after it."""
    pitch = -(-(m + 1) // 16) * 16
    base = 64 + 3
    buf = torch.full((base + (n + 1) * pitch + 64,), 0x5A, dtype=torch.int8,
                     device=dev)
    P = buf[base:base + (n + 1) * pitch].view(n + 1, pitch)[:, :m + 1]
    cells = torch.zeros_like(buf, dtype=torch.bool)
    cells[base:base + (n + 1) * pitch].view(n + 1, pitch)[:, :m + 1] = True
    return P, buf, cells


# (T, R, C) beside each case's own: the default, every tile at 256
# threads, and 512 threads (the R = 4 tile)
CARD_SHAPES = ((None, None, None),
               *((256, R_, C_) for R_, C_ in sf.RB_EXT_TILES),
               (512, None, None))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(P_CASES))
def test_rb_p_kernel_matches_plain_on_card(card, case):
    pair, sc, S, T, R, C = P_CASES[case]
    a, b = pair()
    at, bt = _t(a).to(card), _t(b).to(card)
    St = None if S is None else _t(S).to(card)
    plain = sf.stripe_fill_plain(at, bt, sc, St)
    for shape in ((T, R, C), *CARD_SHAPES):
        P, buf, cells = _guarded_p(len(b), len(a), card)
        got = sf._launch_rb_p(at, bt, sc, *shape, sub=St, P=P)
        torch.cuda.synchronize()
        assert torch.equal(got.best, plain.best), shape
        assert torch.equal(got.right_col, plain.right_col), shape
        assert torch.equal(got.P, plain.P), shape
        assert bool((buf[~cells] == 0x5A).all()), shape


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_rb_block_kernel_matches_plain_on_card(card, case):
    kind, m, n, local, anchored, T, R, C = BLOCK_CASES[case]
    sc, S = _block_scoring(kind)
    a, b = _block_pair(kind, m, n, m * n)
    top, left, tf, le = _bounds(m, n, m + n, anchored)
    if not sc.is_affine:
        tf = le = None
    t = (lambda x: None if x is None else _t(x).to(card))
    args = (t(a), t(b), sc, t(top), t(left), t(tf), t(le))
    for want_bottom in (True, False):
        plain = sf.stripe_block_plain(*args, local=local, substitution=t(S),
                                      want_bottom=want_bottom)
        bounds = sf._check_block(*args)
        for shape in ((T, R, C), *CARD_SHAPES):
            got = sf._launch_rb_block(t(a), t(b), sc, shape[0], t(S),
                                      *bounds, local, want_bottom,
                                      R=shape[1], C=shape[2])
            torch.cuda.synchronize()
            for x, y in zip(got, plain):
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x, y), shape


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(FORMS))
def test_fill_and_block_route_to_the_rb_kernels_on_card(card, form):
    sc, S = FORMS[form]
    a, b = (_protein(300, 2000, 73) if S is not None
            else random_pair(300, 2000, seed=73))
    at, bt = _t(a).to(card), _t(b).to(card)
    St = None if S is None else _t(S).to(card)
    top, left, _, _ = (_t(x).to(card) for x in _bounds(300, 2000, 0, True))
    sf.reset_counts()
    fill = sf.stripe_fill(at, bt, sc, substitution=St)
    block = sf.stripe_block(at, bt, sc, top, left, local=False,
                            substitution=St, want_bottom=True)
    assert torch.equal(fill.P, sf.stripe_fill_plain(at, bt, sc, St).P)
    plain = sf.stripe_block_plain(at, bt, sc, top, left, local=False,
                                  substitution=St, want_bottom=True)
    assert torch.equal(block.bottom_row, plain.bottom_row)
    assert sf.launches[sf.fill_kernel_name(sc, St)] == 1
    assert sf.launches[sf.block_route_name(sc, St)] == 1
    assert sf.launches[sf.kernel_name(sc, St, True)] == 0
    assert sf.launches[sf.block_kernel_name(sc, St)] == 0
    assert sf.plain_calls["stripe_fill_plain"] == 1


@pytest.mark.gpu
def test_walk_reads_a_padded_p_on_card(card):
    """The walk kernel takes P's row pitch: K4's padded layout is walked
    in place, as a contiguous P is."""
    a, b = random_pair(700, 650, seed=74)
    at, bt = _t(a).to(card), _t(b).to(card)
    padded = sf._launch_rb_p(at, bt, LINEAR, None)
    assert padded.P.stride(0) % sf.P_PITCH_ALIGN == 0
    _, i, j, _ = padded.best.tolist()
    for P in (padded.P, padded.P.contiguous()):
        for corner in ((i, j), (650, 700), (0, 5)):
            assert torch.equal(sf.walk_p(P, *corner),
                               sf.walk_p_plain(P, *corner))
    r = swtpu_torch.align(a, b, device="cuda")
    assert (r.max_score, r.max_i, r.max_j) == tuple(padded.best.tolist()[:3])
