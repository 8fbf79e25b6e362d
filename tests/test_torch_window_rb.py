"""The shared-window batch form of the register-blocked stripe (K6 for reads
longer than 512 rows on the card) against the JAX package, on the CPU.

The CUDA kernel (``swtpu_torch/csrc/stripe_rb_window.cu``, the kPairs and
kShared forms of ``stripe_rb_kernel``) runs only on a card. Here
``rb_model(window, reads, pairs=True)`` (tests/test_torch_stripe_rb.py),
the Python model of the register-blocked stripe's schedule, walks each
read's stripes in ticket order, read-major, with the read's own counters
and boundary rows, every read's columns the one window, and reduces the
(B, S, 4) stripe firsts as ``pairs_fill._reduce_stripes`` does. The same
seeded numpy reads (513-1100 rows, shorter reads padded with -3 after
their end, as ``pad_queries`` pads them) and windows go through the
model, the port's plain version ``window_score_plain`` and the JAX
package's window scorer (``swtpu.dist.database._window_scorer``, its
batched scan, as its search runs it on the CPU), in linear, DNA affine,
BLOSUM62 affine and BLOSUM62 linear scoring, with ties, reads with no
positive cell and reads all of the sentinel but one. Tolerance: exact
equality (integer DP). The ``gpu`` tests hold the kernel against its plain
version on a card and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.core.config import Scoring as JScoring
from swtpu.dist import database as jdb
import swtpu_torch
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.dist import database as tdb
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf
from swtpu_torch.kernels import window_fill as wf

from test_torch_pairs_rb import SCORINGS
from test_torch_stripe_rb import rb_model
from test_torch_window_warp import _fields

JSCORINGS = {**SCORINGS, "blosum62_linear": (JScoring(gap=-6),
                                             SCORINGS["blosum62"][1])}


def _port(name):
    jsc, jsub = JSCORINGS[name]
    return scoring_from_jax(jsc), (None if jsub is None
                                   else substitution_from_jax(jsub))


def _reads(name, lengths, W, seed, kind=""):
    """(reads, window): reads of the given lengths padded with -3 to the
    longest, a planted segment of the window in read 0, sentinels (-1 in
    a read and the window, -2 at the window's end); ``kind`` 'ties': the
    window of one half of the alphabet, the reads of the other, a motif
    planted twice in the window and twice in every read, so each DNA
    read's max is the motif's, ending at four cells; 'dark': reads and
    window of two disjoint letters; 'one_read': every read -3 but read 1."""
    rng = np.random.default_rng(seed)
    A = 20 if name.startswith("blosum62") else 4
    lo, hi = ((0, A // 2), (A // 2, A)) if kind == "ties" else ((0, A),) * 2
    win = rng.integers(*lo, W).astype(np.int8)
    reads = np.full((len(lengths), max(lengths)), -3, np.int8)
    for g, n in enumerate(lengths):
        reads[g, :n] = rng.integers(*hi, n)
    if kind == "ties":
        motif = rng.integers(0, A, 24).astype(np.int8)
        win[30:54] = win[W - 60:W - 36] = motif
        for g, n in enumerate(lengths):
            reads[g, 100:124] = reads[g, n - 80:n - 56] = motif
        return reads, win
    if kind == "dark":
        win[:] = 1
        reads[reads >= 0] = 0
        return reads, win
    k = min(lengths[0] - 2, W - 4, 150)
    reads[0, 200:200 + k] = win[3:3 + k]
    reads[0, 200 + k // 2] = -1
    win[1], win[-1] = -1, -2
    if kind == "one_read":
        reads[[g for g in range(len(lengths)) if g != 1]] = -3
    return reads, win


# (scoring, read lengths, W, seed, kind, T, R, C): reads of 513-1100 rows
# (the warp-per-read scorer's R above 16), mixed lengths padded with -3,
# several stripes a read (n not a multiple of T*R), one stripe a read, m
# not a multiple of C or of a chunk, ties, no positive cell, every read -3
# but one, each form's tiles
CASES = {
    "linear_mixed_lengths": ("linear", (600, 513, 560), 300, 1, "", 32, 4,
                             4),
    "linear_1100_rows_C8": ("linear", (1100, 700), 150, 2, "", 64, 8, 8),
    "linear_one_stripe_a_read": ("linear", (520, 513), 300, 3, "", 128, 8,
                                 4),
    "linear_ties": ("linear", (540, 600, 513), 300, 4, "ties", 32, 4, 4),
    "linear_no_positive_cell": ("linear", (530, 600), 200, 5, "dark", 32, 8,
                                2),
    "linear_all_reads_sentinel_but_one": ("linear", (600, 520, 600), 300, 6,
                                          "one_read", 32, 4, 4),
    "dna_affine_mixed_lengths": ("dna_affine", (700, 513, 600), 250, 7, "",
                                 32, 4, 4),
    "dna_affine_ties": ("dna_affine", (520, 560), 300, 8, "ties", 64, 8, 2),
    "dna_affine_one_column_wide": ("dna_affine", (1000, 900), 75, 9, "",
                                   64, 8, 4),
    "blosum62_mixed_lengths": ("blosum62", (600, 513, 580), 300, 10, "", 32,
                               8, 4),
    "blosum62_ties": ("blosum62", (530, 600), 300, 11, "ties", 32, 4, 4),
    "blosum62_all_reads_sentinel_but_one": ("blosum62", (513, 640), 200, 12,
                                            "one_read", 32, 8, 2),
    "blosum62_linear_mixed_lengths": ("blosum62_linear", (600, 540), 250,
                                      13, "", 32, 4, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_window_rb_model_matches_plain_and_jax(case):
    name, lengths, W, seed, kind, T, R, C = CASES[case]
    reads, win = _reads(name, lengths, W, seed, kind)
    sc, sub = _port(name)
    got = rb_model(win, reads, sc, T, R, C, sub, pairs=True)
    plain = wf.window_score_plain(torch.from_numpy(reads),
                                  torch.from_numpy(win), sc,
                                  None if sub is None
                                  else torch.from_numpy(sub))
    assert got == _fields(plain)
    jsc, jsub = JSCORINGS[name]
    scan = jdb._window_scorer(jsc, jsub)(jnp.asarray(reads),
                                         jnp.asarray(win))
    assert got == _fields(scan)
    if kind == "dark":
        assert got == [[0] * len(lengths)] * 3
    if kind == "one_read":                # only read 1 holds a code
        assert got[0][1] > 0
        assert [x for g, x in enumerate(got[0]) if g != 1] == \
            [0] * (len(lengths) - 1)
    if kind == "ties" and sub is None:    # the first of four end cells
        assert got == [[24 * sc.match] * len(lengths), [124] * len(lengths),
                       [54] * len(lengths)]


def test_rb_model_shares_the_window_without_copies():
    """The shared-window form is the batch form with every pair's a the
    one window: the same answer as rb_model over the window copied B
    times."""
    reads, win = _reads("linear", (600, 513), 300, 20)
    sc, _ = _port("linear")
    copies = np.broadcast_to(win, (2, 300))
    assert rb_model(win, reads, sc, 32, 4, 4, pairs=True) == \
        rb_model(copies, reads, sc, 32, 4, 4, pairs=True)


# ---- the route, the scratch and the launch, as pure Python ----

@pytest.mark.parametrize("name", list(JSCORINGS))
def test_long_reads_launch_the_rb_window_entry(name, monkeypatch):
    """A WindowScorer of reads longer than 512 rows on a device other than
    the CPU (the meta device: the launch recorded instead of run) takes
    the register-blocked K6 entry of the scoring: its scratch allocated
    once (sync 1 + B*S, B*(S-1) boundary rows of W + 1 and their F twins
    when affine, best (B, S, 4)), the reads unpadded, the counters cleared
    before each window, the arguments its ctypes signature declares at
    rb_shape's 'window' (T, R, C)."""
    sc, sub = _port(name)
    meta = torch.device("meta")
    B, rlen, W = 5, 1000, 4096
    rt = torch.empty((B, rlen), dtype=torch.int8, device=meta)
    St = None if sub is None else torch.empty(sub.shape, dtype=torch.int32,
                                              device=meta)
    seen = []
    monkeypatch.setattr(sf, "_call", lambda nm, dev, args, counter=None,
                        counts=None: seen.append((nm, counter, args)))
    scorer = wf.WindowScorer(rt, W, sc, substitution=St)
    mode = sf._mode(sc, St)
    entry = wf.WINDOW_RB_KERNELS[mode]
    assert scorer.form == "rb" and scorer.name == entry
    assert entry == wf.window_route_name(rlen, sc, St) == \
        wf.window_rb_name(sc, St) == f"sw_window_rb_{mode}"
    rb = scorer._rb
    T, R, C = sf.rb_shape(rlen, mode=mode, A=21, kind="window")
    assert (rb.T, rb.R, rb.C) == (T, R, C)
    S = -(-rlen // (T * R))
    assert rb.reads.shape == (B, rlen)              # not padded
    assert rb.sync.shape == (1 + B * S,)
    assert rb.bnd.shape == (max(B * (S - 1), 1) * (W + 1),)
    assert (rb.bnd_f is not None) == sc.is_affine
    if sc.is_affine:
        assert rb.bnd_f.shape == rb.bnd.shape
    assert rb.best.shape == (B, S, 4)
    bnd = rb.bnd
    for _ in range(3):
        hits = scorer(torch.empty(W, dtype=torch.int8, device=meta))
        assert [x.shape for x in hits] == [(B,)] * 3
    assert rb.bnd is bnd                            # allocated once
    assert [x[0] for x in seen] == [entry] * 3
    assert {x[1] for x in seen} == {entry}
    args = seen[0][2]
    assert len(args) + 1 == len(_cuda.ARGTYPES[entry])       # + the stream
    assert args[2:5] == [B, W, rlen]
    tail = 3 if mode == "linear" else 4       # sync, bnd, [bnd_f,] best
    assert tuple(args[-tail - 3:-tail]) == (T, R, C)
    if mode != "linear":
        assert (args[-2] is not None) == sc.is_affine             # bnd_f


def test_short_reads_stay_on_the_warp_route(monkeypatch):
    sc, _ = _port("linear")
    meta = torch.device("meta")
    seen = []
    monkeypatch.setattr(sf, "_call", lambda nm, dev, args, counter=None,
                        counts=None: seen.append(nm))
    for rlen, form in ((150, "warp"), (512, "warp"), (513, "rb"),
                       (5000, "rb")):
        rt = torch.empty((4, rlen), dtype=torch.int8, device=meta)
        scorer = wf.WindowScorer(rt, 2048, sc)
        assert scorer.form == form
        scorer(torch.empty(2048, dtype=torch.int8, device=meta))
    assert seen == ["sw_window_warp_linear"] * 2 + ["sw_window_rb_linear"] * 2
    # the template, the earlier design, and a chosen tile only by the
    # private launchers
    rt = torch.empty((4, 5000), dtype=torch.int8, device=meta)
    assert wf._TemplateWindow(rt, 2048, sc, None).name == \
        "sw_window_score_linear"
    assert (wf._RbWindow(rt, 2048, sc, None, 32, 4, 4).R,
            wf.WindowScorer(rt, 2048, sc, T=32)._rb.R) == (4, 8)
    with pytest.raises(ValueError, match="tiles"):
        wf._RbWindow(rt, 2048, sc, None, 32, 3, 3)


def test_rb_window_refuses_shapes_that_overflow_int32():
    sc, _ = _port("linear")
    meta = torch.device("meta")
    for B, rlen in ((1 << 21, 1100), (2, (1 << 31) - 100)):
        rt = torch.empty((B, rlen), dtype=torch.int8, device=meta)
        with pytest.raises(ValueError, match=f"{B} reads of {rlen} rows"):
            wf.WindowScorer(rt, 4096, sc)


def test_rb_shape_of_the_window_form():
    for mode in ("linear", "affine", "sub"):
        T, R, C = sf.RB_DEFAULTS[mode]
        assert (R, C) in sf.RB_FORM_TILES[mode]
        assert sf.rb_shape(10 ** 5, mode=mode, A=21, kind="window") == \
            (T, R, C)
        for R_, C_ in sf.RB_FORM_TILES[mode]:
            assert sf.rb_shape(5000, 512, R_, C_, mode, 21,
                               "window")[1:] == (R_, C_)
    with pytest.raises(ValueError, match="tiles"):
        sf.rb_shape(1000, None, 16, 4, "sub", 21, "window")


def test_window_counters_reset_with_the_others():
    assert set(wf.WINDOW_RB_KERNELS.values()) < set(wf.launches)
    for name in wf.WINDOW_RB_KERNELS.values():
        assert name in _cuda.ARGTYPES
    assert "stripe_rb_window.cu" in {p.name for p in _cuda.SOURCES}
    wf.launches["sw_window_rb_affine"] = 4
    pf.reset_counts()
    assert not any(wf.launches.values())


def test_cpu_long_reads_run_the_plain_version():
    sc, _ = _port("linear")
    reads, win = _reads("linear", (600, 513), 300, 30)
    pf.reset_counts()
    got = wf.WindowScorer(torch.from_numpy(reads), 300, sc)(
        torch.from_numpy(win))
    assert _fields(got) == rb_model(win, reads, sc, 32, 4, 4, pairs=True)
    assert wf.plain_calls["window_score_plain"] == 1
    assert not any(wf.launches.values())


def test_long_read_search_matches_jax_on_the_cpu():
    """The public search of reads of 600 rows (a third shorter, padded
    with -3) against a reference of three windows, both strands and the
    top two, equals the JAX package's."""
    rng = np.random.default_rng(40)
    ref = rng.integers(0, 4, 2600).astype(np.int8)
    reads = [rng.integers(0, 4, 600).astype(np.int8) for _ in range(3)]
    reads[0] = ref[700:1300].copy()
    reads[2] = ref[1900:2450].copy()
    q = tdb.pad_queries(reads, 600)
    for kw in (dict(), dict(strand="both", n_best=2)):
        got = tdb.search(q, ref, window=1300, device="cpu", **kw)
        want = jdb.search(q, ref, window=1300, plan="scan", **kw)
        assert [np.asarray(x).tolist() for x in got] == \
            [np.asarray(x).tolist() for x in want]
    hits = tdb.search(q, ref, window=1300, device="cpu")
    assert hits.scores.tolist()[0] == 3 * 600
    assert hits.ref_pos.tolist()[0] == 1299


# ---- the CUDA kernel on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_window_rb_kernel_matches_plain_on_card(card, case):
    name, lengths, W, seed, kind, T, R, C = CASES[case]
    reads, win = _reads(name, lengths, W, seed, kind)
    sc, sub = _port(name)
    S = None if sub is None else torch.from_numpy(sub).to(card)
    rt, wt = torch.from_numpy(reads).to(card), torch.from_numpy(win).to(card)
    want = _fields(wf.window_score_plain(rt, wt, sc, S))
    mode = sf._mode(sc, S)
    for shape in ((T, (R, C)), (None, (None, None)),
                  *((128, tile) for tile in sf.RB_FORM_TILES[mode])):
        scorer = wf._RbWindow(rt, W, sc, S, shape[0], *shape[1])
        for _ in range(2):      # the counters cleared between windows
            assert _fields(scorer(wt)) == want, shape
    pf.reset_counts()
    assert _fields(wf.window_score(rt, wt, sc, substitution=S)) == want
    assert wf.launches[wf.window_rb_name(sc, S)] == 1
    assert wf.launches[wf.window_kernel_name(sc, S)] == 0


@pytest.mark.gpu
def test_long_read_search_launches_the_rb_window_kernel_on_card(card):
    rng = np.random.default_rng(41)
    ref = rng.integers(0, 4, 6000).astype(np.int8)
    reads = [rng.integers(0, 4, 700).astype(np.int8) for _ in range(4)]
    reads[1] = ref[2000:2700].copy()
    q = tdb.pad_queries(reads, 700)
    want = tdb.search(q, ref, window=2048, device="cpu")
    pf.reset_counts()
    got = swtpu_torch.search(q, ref, window=2048)
    assert _fields(got) == _fields(want)
    assert wf.launches["sw_window_rb_linear"] > 0
    assert wf.launches["sw_window_score_linear"] == 0
    assert wf.launches["sw_window_warp_linear"] == 0
    assert not any(wf.plain_calls.values())
