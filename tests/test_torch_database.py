"""The port's database search against the JAX package's, on the CPU.

The same numpy inputs go through ``swtpu.dist.database`` and
``swtpu_torch.dist.database`` (``device='cpu'``); scorings, tables and hit
tuples cross through ``swtpu_torch.convert``. On the JAX side the searches
run ``plan='scan'`` (its CPU default is the native host tier), and, at
two shapes, the Pallas batch kernel K6 in interpret mode. The port's K6
wrapper runs its plain version here. Tolerance: exact equality of every
field (integer DP); SAM text equal apart from the @PG line. The CUDA
kernel runs only on a card: the ``gpu`` tests hold it against its plain
version there and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swtpu_torch
from swtpu.core.config import Scoring as JScoring
from swtpu.core.encode import revcomp
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.dist import database as jdb
from swtpu.kernels.pallas_fill import batch_fill_raw, batch_score_fn
from swtpu_torch.convert import (hits_from_jax, scoring_from_jax,
                                 substitution_from_jax)
from swtpu_torch.dist import database as tdb
from swtpu_torch.kernels import window_fill as wf

SCORINGS = {
    "linear": (JScoring(), None),
    "dna_affine": (JScoring(mode="affine", gap_open=-4, gap_extend=-1), None),
    "blosum62": (JScoring(mode="affine", gap_open=-11, gap_extend=-1),
                 J_BLOSUM62),
}


def _port(jsc, jsub):
    return scoring_from_jax(jsc), (None if jsub is None
                                   else substitution_from_jax(jsub))


def _fields(hits) -> list:
    """Every field of a hit tuple as a list of ints, from torch or JAX."""
    return [(x.cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x)).astype(np.int64).tolist() for x in hits]


def _same(jax_hits, port_hits) -> None:
    assert type(jax_hits).__name__ == type(port_hits).__name__
    assert _fields(port_hits) == _fields(jax_hits)


# ---- K6's plain version against the JAX batch kernel and scan ----

def _window_case(name, B, rlen, W, seed, ties=False, sentinels=False):
    rng = np.random.default_rng(seed)
    A = 20 if name == "blosum62" else 4
    win = rng.integers(0, A, W).astype(np.int8)
    reads = rng.integers(0, A, (B, rlen)).astype(np.int8)
    k = min(rlen - 2, W - 4)
    if k > 0:
        reads[0, 1:1 + k] = win[3:3 + k]        # planted homology
    if ties and W >= 2 * rlen + 10:
        win[W - rlen - 2:W - 2] = win[3:3 + rlen]   # the read twice
        reads[-1] = win[3:3 + rlen]
    if sentinels:
        reads[0, rlen // 2] = -1                # an unknown base
        reads[-1, rlen - 5:] = -3               # a shorter read
        win[1] = -1
        win[-1] = -2
    return reads, win


WINDOW_CASES = {
    "no_T_cuts_rlen45": (3, 45, 200, 1, {}),
    "B1": (1, 24, 100, 2, {}),
    "W_below_T": (4, 20, 18, 3, {}),
    "sentinels": (3, 40, 160, 4, dict(sentinels=True)),
    "ties": (2, 24, 90, 5, dict(ties=True)),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
@pytest.mark.parametrize("name", list(SCORINGS))
def test_window_score_plain_matches_jax(name, case):
    B, rlen, W, seed, kw = WINDOW_CASES[case]
    reads, win = _window_case(name, B, rlen, W, seed, **kw)
    jsc, jsub = SCORINGS[name]
    sc, sub = _port(jsc, jsub)
    subt = None if sub is None else torch.from_numpy(sub)
    rt, wt = torch.from_numpy(reads), torch.from_numpy(win)
    got = _fields(wf.window_score_plain(rt, wt, sc, subt))
    assert _fields(wf.window_score(rt, wt, sc, substitution=subt)) == got
    scan = jdb._window_scorer(jsc, jsub)(jnp.asarray(reads),
                                         jnp.asarray(win))
    assert got == _fields(scan)
    # the Pallas batch kernel, interpret mode
    fn = batch_score_fn(B, rlen, W, scoring=jsc, interpret=True,
                        substitution=jsub)
    assert got == _fields(fn(jnp.asarray(reads), jnp.asarray(win)))
    if jsub is None:
        assert got == _fields(batch_fill_raw(reads, win, jsc,
                                             interpret=True))
    # K6's -3 row padding (window_rows) changes no read's answer
    rpad, _ = wf.window_rows(rlen, B)
    padded = np.full((B, rpad + 7), -3, np.int8)
    padded[:, :rlen] = reads
    assert _fields(wf.window_score_plain(torch.from_numpy(padded), wt, sc,
                                         subt)) == got


def test_window_rows_cut_the_chain():
    from swtpu_torch.kernels.pairs_fill import chain_cutting_rows
    assert wf.window_rows(152, 2048) == (152, 608)
    assert chain_cutting_rows(150) is None
    assert wf.window_rows(150, 4096) == (152, 608)
    assert wf.window_rows(45, 100) == (46, 736)     # 736 = 16 x 46
    assert wf.window_rows(24, 1) == (24, 32)       # no more rows than 24
    for rlen in range(1, 400, 7):
        rpad, T = wf.window_rows(rlen, 64)
        assert rlen <= rpad < rlen + 32
        assert rpad % T == 0 or T % rpad == 0


def test_window_kernel_names_and_counters():
    sc, sub = _port(*SCORINGS["blosum62"])
    assert wf.window_kernel_name(scoring_from_jax(JScoring()), None) == \
        "sw_window_score_linear"
    assert wf.window_kernel_name(sc, sub) == "sw_window_score_sub"
    from swtpu_torch.kernels import pairs_fill
    wf.plain_calls["window_score_plain"] = 3
    pairs_fill.reset_counts()
    assert not any(wf.plain_calls.values()) and not any(wf.launches.values())


# ---- the top-2 fold ----

@pytest.mark.parametrize("per_read", [False, True])
def test_upd2_matches_jax(per_read):
    rng = np.random.default_rng(11 + per_read)
    B = 64
    far = 2**31 - 1
    c_np = [rng.integers(0, 60, B), rng.integers(0, 400, B),
            rng.integers(0, 40, B), rng.integers(0, 60, B),
            rng.integers(0, 400, B), rng.integers(0, 40, B)]
    c_np[1] = np.where(rng.random(B) < 0.2, far, c_np[1])
    c_np[4] = np.where(rng.random(B) < 0.3, far, c_np[4])
    c_np[0] = np.where(c_np[1] == far, 0, c_np[0])
    carry = [x.astype(np.int32) for x in c_np]
    mind = (rng.integers(5, 40, B).astype(np.int32) if per_read
            else np.int32(24))
    jc = tuple(jnp.asarray(x) for x in carry)
    tc = tuple(torch.from_numpy(x) for x in carry)
    tm = torch.from_numpy(mind) if per_read else int(mind)
    for step in range(12):
        s = rng.integers(0, 60, B).astype(np.int32)
        pos = (rng.integers(-1, 400, B)).astype(np.int32)
        s = np.where(rng.random(B) < 0.2, 0, s).astype(np.int32)
        qi = rng.integers(0, 40, B).astype(np.int32)
        jc = jdb._upd2(jc, jnp.asarray(s), jnp.asarray(pos),
                       jnp.asarray(qi), min_dist=jnp.asarray(mind))
        tc = tdb._upd2(tc, torch.from_numpy(s), torch.from_numpy(pos),
                       torch.from_numpy(qi), min_dist=tm)
        assert _fields(tc) == _fields(jc), step
    other = [x.astype(np.int32)[::-1].copy() for x in carry]
    jm = jdb._merge2(jc, tuple(jnp.asarray(x) for x in other),
                     min_dist=jnp.asarray(mind))
    tmg = tdb._merge2(tc, tuple(torch.from_numpy(x) for x in other),
                      min_dist=tm)
    assert _fields(tmg) == _fields(jm)


# ---- search ----

def _plant_ref(seed, L=3000):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L).astype(np.int8)
    return rng, ref


def _mapping_batch(unknown=-1):
    """Reads planted forward and reverse-complemented, one twice with a
    SNP at its second locus, one with an N (``unknown``, or another base
    code in its place), one random."""
    rng, ref = _plant_ref(101)
    p1, p2 = 700, 2300
    read = ref[p1:p1 + 40].copy()
    mut = read.copy()
    mut[10] = (mut[10] + 1) % 4
    ref[p2:p2 + 40] = mut
    ref[p1:p1 + 40] = read
    nread = ref[1500:1540].copy()
    nread[7] = unknown
    reads = [read, revcomp(ref[1000:1036]), nread,
             rng.integers(0, 4, 40).astype(np.int8)]
    return jdb.pad_queries(reads, 40), ref


SEARCH_CASES = {
    "forward": dict(),
    "forward_top2": dict(n_best=2),
    "both": dict(strand="both"),
    "both_top2": dict(strand="both", n_best=2),
    "both_top2_res": dict(strand="both", n_best=2, sec_resolution=256),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_matches_jax(case):
    q, ref = _mapping_batch()
    kw = dict(window=512, **SEARCH_CASES[case])
    want = jdb.search(q, ref, plan="scan", **kw)
    for plan in ("auto", "stripe", "scan"):
        got = tdb.search(q, ref, plan=plan, device="cpu", **kw)
        _same(want, got)
    assert swtpu_torch.search is tdb.search


def _variable_length():
    rng, ref = _plant_ref(2, 1024)
    return jdb.pad_queries([ref[50:70].copy(), ref[500:532].copy()], 32), \
        ref, dict(window=256)


def _no_hit():
    return (jdb.pad_queries([np.zeros(16, np.int8)], 16),
            np.full(512, 3, np.int8), dict(window=128))


def _boundary_no_phantom():          # test_database.py:620
    rng, ref = _plant_ref(127, 512)
    return jdb.pad_queries([ref[110:142].copy()], 32), ref, \
        dict(window=128, n_best=2)


def _boundary_real_second():         # test_database.py:639
    rng, ref = _plant_ref(131, 2048)
    read = ref[110:142].copy()
    weak = read.copy()
    weak[4] = (weak[4] + 1) % 4
    ref[1500:1532] = weak
    ref[110:142] = read
    return jdb.pad_queries([read], 32), ref, dict(window=128, n_best=2)


def _mixed_dedup():                  # test_database.py:659
    rng, ref = _plant_ref(137, 512)
    short = ref[100:124].copy()
    ref[160:184] = short
    ref[100:124] = short
    long = ref[300:428].copy()
    return jdb.pad_queries([short, long], 128), ref, \
        dict(window=256, n_best=2, sec_resolution=256)


def _tie_forward():                  # test_database.py:685
    rng, ref = _plant_ref(137, 2048)
    read = ref[1500:1528].copy()
    ref[300:328] = revcomp(read)
    ref[1500:1528] = read
    return jdb.pad_queries([read], 28), ref, dict(window=256, strand="both",
                                                  n_best=2)


def _same_window():                  # test_database.py:903
    rng, ref = _plant_ref(5, 3000)
    ref[2000:2040] = ref[500:540]
    return jdb.pad_queries([ref[505:535].copy()], 30), ref, \
        dict(window=32768, n_best=2)


def _protein():
    rng = np.random.default_rng(31)
    ref = rng.integers(0, 20, 500).astype(np.int8)
    reads = [ref[100:124].copy(), rng.integers(0, 20, 24).astype(np.int8),
             ref[300:316].copy()]
    reads[0][3] = (reads[0][3] + 5) % 20
    return jdb.pad_queries(reads, 24), ref, dict(window=128)


def _dna_affine():
    q, ref = _mapping_batch()
    gapped = np.concatenate([ref[200:215], ref[218:240]])   # a deletion
    return jdb.pad_queries([*q[:2], gapped], 40), ref, dict(window=300)


SEARCH_SHAPES = {
    "variable_length": (_variable_length, "linear"),
    "no_hit": (_no_hit, "linear"),
    "boundary_no_phantom": (_boundary_no_phantom, "linear"),
    "boundary_real_second": (_boundary_real_second, "linear"),
    "mixed_length_dedup": (_mixed_dedup, "linear"),
    "both_top2_tie_forward": (_tie_forward, "linear"),
    "same_window_clamp": (_same_window, "linear"),
    "blosum62": (_protein, "blosum62"),
    "blosum62_top2": (lambda: (*_protein()[:2], dict(window=128, n_best=2)),
                      "blosum62"),
    "dna_affine": (_dna_affine, "dna_affine"),
    "dna_affine_both_top2": (
        lambda: (*_dna_affine()[:2], dict(window=300, strand="both",
                                          n_best=2)), "dna_affine"),
}


@pytest.mark.parametrize("case", list(SEARCH_SHAPES))
def test_search_shapes_match_jax(case):
    make, name = SEARCH_SHAPES[case]
    q, ref, kw = make()
    jsc, jsub = SCORINGS[name]
    sc, sub = _port(jsc, jsub)
    want = jdb.search(q, ref, scoring=jsc, substitution=jsub, plan="scan",
                      **kw)
    got = tdb.search(q, ref, scoring=sc, substitution=sub, device="cpu",
                     **kw)
    _same(want, got)


@pytest.mark.parametrize("name", ["linear", "blosum62"])
def test_search_matches_jax_stripe_searcher(name):
    """The JAX searcher with its Pallas K6 in interpret mode, as
    test_database.py holds it against its scan (two shards' first)."""
    jsc, jsub = SCORINGS[name]
    rng = np.random.default_rng(17 if jsub is None else 31)
    A = 4 if jsub is None else 20
    ref = rng.integers(0, A, 600).astype(np.int8)
    reads = [ref[37:61].copy(), ref[333:357].copy(),
             rng.integers(0, A, 24).astype(np.int8)]
    queries = jdb.pad_queries(reads, 24)
    shards, shard_len = jdb.shard_reference(ref, 2, 24)
    kw = dict(qlen=24, shard_len=shard_len, window=128)
    want = jdb.make_searcher(None, plan="stripe", interpret=True,
                             scoring=jsc, substitution=jsub, **kw)(
        jnp.asarray(queries), jnp.asarray(shards[:1]))
    sc, sub = _port(jsc, jsub)
    for plan in ("stripe", "scan"):
        got = tdb.make_searcher(scoring=sc, substitution=sub, plan=plan,
                                device="cpu", **kw)(queries, shards[:1])
        _same(want, got)


def test_search_refusals():
    q = jdb.pad_queries([np.zeros(8, np.int8)], 8)
    ref = np.zeros(64, np.int8)
    sc, sub = _port(*SCORINGS["blosum62"])
    with pytest.raises(ValueError, match="DNA-only"):
        tdb.search(q, ref, scoring=sc, substitution=sub, strand="both",
                   device="cpu")
    with pytest.raises(ValueError, match="strand must be"):
        tdb.search(q, ref, strand="minus", device="cpu")
    with pytest.raises(ValueError, match="must exceed"):
        tdb.search(jdb.pad_queries([ref[:32].copy()], 32), ref, window=32,
                   device="cpu")
    with pytest.raises(ValueError, match="n_best"):
        tdb.search(q, ref, n_best=3, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        tdb.search(q, ref, plan="host-simd", device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        tdb.search(q, ref, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown plan"):
        tdb.search(q, ref, plan="pipeline", device="cpu")
    # the kernel plan refuses what K6 does not take, as the wrappers do
    with pytest.raises(ValueError, match="stripe kernel"):
        tdb.search(q, ref, scoring=swtpu_torch.Scoring(mismatch=0),
                   plan="stripe", device="cpu")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


def test_search_without_a_card_raises(no_card):
    q = jdb.pad_queries([np.zeros(8, np.int8)], 8)
    ref = np.zeros(64, np.int8)
    for kw in (dict(), dict(device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdb.search(q, ref, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            swtpu_torch.map_reads(ref, [ref[:20].copy()], **kw)


# ---- the rest of database.py ----

def test_reference_helpers_match_jax():
    rng = np.random.default_rng(139)
    a = rng.integers(0, 4, 300).astype(np.int8)
    b = rng.integers(0, 4, 200).astype(np.int8)
    for kw in (dict(), dict(scoring=JScoring(mode="affine")),
               dict(scoring=SCORINGS["blosum62"][0],
                    substitution=J_BLOSUM62)):
        want = jdb.concat_references([a, b], 32, **kw)
        pkw = dict(kw)
        if "scoring" in kw:
            pkw["scoring"] = scoring_from_jax(kw["scoring"])
        got = tdb.concat_references([a, b], 32, **pkw)
        assert all(np.array_equal(x, y) for x, y in zip(want, got))
    cat, starts = tdb.concat_references([a, b], 32)
    for p in (0, 299, int(starts[1]) + 5, int(starts[1]) + 199):
        assert tdb.locate_record(starts, [a, b], p) == \
            jdb.locate_record(starts, [a, b], p)
    for p, msg in ((305, "spacer"), (-1, "before the first")):
        with pytest.raises(ValueError, match=msg):
            tdb.locate_record(starts, [a, b], p)
    q = jdb.pad_queries([a[:7], b[:12], np.array([0, -1, 2], np.int8)], 12)
    assert np.array_equal(tdb.pad_queries([a[:7], b[:12],
                                           np.array([0, -1, 2], np.int8)],
                                          12), q)
    assert np.array_equal(tdb.revcomp_padded(q), jdb.revcomp_padded(q))
    shards = jdb.shard_reference(a, 3, 24)
    got = tdb.shard_reference(a, 3, 24)
    assert np.array_equal(got[0], shards[0]) and got[1] == shards[1]
    for p, s in ((100, None), (100, 0), (100, 100), (100, 50), (0, None),
                 (37, 36), (90, 120)):
        assert tdb.mapq(p, s) == jdb.mapq(p, s)


def _records(recs) -> list:
    return [tuple(r) for r in recs]


def _align_hits_inputs(case):
    # an unknown base is tested on its own (test_align_hits_unknown_base)
    if case == "forward":
        q, ref = _mapping_batch(unknown=2)
        return q, ref, jdb.search(q, ref, window=512, plan="scan"), {}
    if case == "both":
        q, ref = _mapping_batch(unknown=2)
        return q, ref, jdb.search(q, ref, window=512, strand="both",
                                  plan="scan"), {}
    if case == "both_top2_secondary":
        q, ref = _mapping_batch(unknown=2)
        h = jdb.search(q, ref, window=512, strand="both", n_best=2,
                       plan="scan")
        return q, ref, h.secondary, {}
    if case == "protein":
        q, ref, _ = _protein()
        sc = SCORINGS["blosum62"][0]
        return q, ref, jdb.search(q, ref, window=128, scoring=sc,
                                  substitution=J_BLOSUM62, plan="scan"), \
            dict(scoring=sc, substitution=J_BLOSUM62)
    if case == "underreported":        # test_database.py:339
        rng, ref = _plant_ref(79, 1024)
        return [ref[300:340].copy()], ref, jdb.SearchHits(
            scores=np.array([100], np.int32),
            ref_pos=np.array([339], np.int32),
            read_end=np.array([40], np.int32)), {}
    if case == "truncated":            # test_database.py:362
        rng, ref = _plant_ref(83, 1024)
        full = ref[300:340].copy()
        h = jdb.search(jdb.pad_queries([full], 32), ref, window=256,
                       plan="scan")
        return [full], ref, h, {}
    raise KeyError(case)


@pytest.mark.parametrize("sel", [dict(), dict(top=2), dict(reads=[2, 0])],
                         ids=["all", "top2", "reads"])
@pytest.mark.parametrize("case", ["forward", "both", "both_top2_secondary",
                                  "protein", "underreported", "truncated"])
def test_align_hits_matches_jax(case, sel):
    q, ref, jh, kw = _align_hits_inputs(case)
    if "reads" in sel and len(q) < 3:
        sel = dict(reads=[0])
    want = jdb.align_hits(jh, q, ref, **sel, **kw)
    h = hits_from_jax(type(jh)(*(np.asarray(x) for x in jh)))
    pkw = {k: (scoring_from_jax(v) if k == "scoring"
               else substitution_from_jax(v)) for k, v in kw.items()}
    got = tdb.align_hits(h, q, ref, **sel, **pkw, device="cpu")
    assert want and _records(got) == _records(want)
    assert swtpu_torch.align_hits is tdb.align_hits


def test_align_hits_unknown_base(monkeypatch):
    """A read with an unknown base (-1): the JAX package's native host
    tier, which its align_hits takes on the CPU, renders the base as a gap
    ('-', its own gap marker) and so counts a deletion in the CIGAR; its
    scan plan renders it as the alignment of an aligned base. The port's
    align_hits follows the JAX scan plan (ROADMAP Queue 3)."""
    import swtpu.runtime_native as rn
    q, ref = _mapping_batch()
    jh = jdb.search(q, ref, window=512, plan="scan")
    h = hits_from_jax(type(jh)(*(np.asarray(x) for x in jh)))
    got = tdb.align_hits(h, q, ref, reads=[2], device="cpu")
    assert got[0].cigar == "40M" and got[0].score == 114
    if rn.available():
        host = jdb.align_hits(jh, q, ref, reads=[2])
        assert host[0].cigar == "7M1D32M"      # the base counted as a gap
    monkeypatch.setattr(rn, "available", lambda: False)   # the scan plan
    assert _records(got) == _records(jdb.align_hits(jh, q, ref, reads=[2]))


def test_hits_from_jax_names_and_dtypes():
    q, ref = _mapping_batch()
    for kw in (dict(), dict(n_best=2), dict(strand="both"),
               dict(strand="both", n_best=2)):
        jh = jdb.search(q, ref, window=512, plan="scan", **kw)
        h = hits_from_jax(type(jh)(*(np.array(x) for x in jh)))
        assert type(h) is getattr(tdb, type(jh).__name__)
        assert [x.dtype for x in h] == [torch.from_numpy(np.array(x)).dtype
                                        for x in jh]
        _same(jh, h)
    with pytest.raises(ValueError, match="hit tuple"):
        hits_from_jax((1, 2, 3))


def _h2(mod, *rows):
    return mod.StrandedHits2(*[np.asarray(c) for c in zip(*rows)])


PAIR_CASES = {                           # test_database.py:920-1130
    "selection": ([(100, 5000, 40, 1, 90, 1000, 40, 1),
                   (100, 1000, 40, 1, 0, -1, 0, 0)],
                  [(95, 1300, 40, -1, 0, -1, 0, 0),
                   (80, 3000, 40, 1, 70, 900, 40, 1)], dict(max_insert=1000)),
    "record_gate": ([(100, 390, 40, 1, 0, -1, 0, 0)],
                    [(95, 600, 40, -1, 0, -1, 0, 0)],
                    dict(max_insert=1000, record_starts=np.array([0, 500]))),
    "ungated": ([(100, 390, 40, 1, 0, -1, 0, 0)],
                [(95, 600, 40, -1, 0, -1, 0, 0)], dict(max_insert=1000)),
    "higher_proper": ([(80, 1000, 40, 1, 70, 5000, 40, 1)],
                      [(90, 5200, 40, -1, 50, 1300, 40, -1)],
                      dict(max_insert=1000)),
    "bound_341": ([(80, 1000, 40, 1, 0, -1, 0, 0)],
                  [(50, 1300, 40, -1, 0, -1, 0, 0)], dict(max_insert=341)),
    "bound_340": ([(80, 1000, 40, 1, 0, -1, 0, 0)],
                  [(50, 1300, 40, -1, 0, -1, 0, 0)], dict(max_insert=340)),
    "min_insert": ([(80, 1000, 40, 1, 0, -1, 0, 0)],
                   [(50, 1300, 40, -1, 0, -1, 0, 0)],
                   dict(min_insert=400, max_insert=1000)),
}


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_hits_matches_jax(case):
    r1, r2, kw = PAIR_CASES[case]
    want = jdb.pair_hits(_h2(jdb, *r1), _h2(jdb, *r2), **kw)
    got = tdb.pair_hits(_h2(tdb, *r1), _h2(tdb, *r2), **kw)
    for w, g in zip(want, got):
        assert _fields([w] if isinstance(w, np.ndarray) else w) == \
            _fields([g] if isinstance(g, np.ndarray) else g)
    assert swtpu_torch.pair_hits is tdb.pair_hits


def test_pair_hits_takes_searched_tensors():
    q, ref = _mapping_batch()
    jh = jdb.search(q, ref, window=512, strand="both", n_best=2,
                    plan="scan")
    th = tdb.search(q, ref, window=512, strand="both", n_best=2,
                    device="cpu")
    want = jdb.pair_hits(jh, jh, max_insert=3000)
    got = tdb.pair_hits(th, th, max_insert=3000)
    assert _fields(got.mate1) == _fields(want.mate1)
    assert got.proper.tolist() == want.proper.tolist()


def _sam_body(sam: str) -> list:
    return [ln for ln in sam.splitlines() if not ln.startswith("@PG")]


def test_to_sam_matches_jax():
    q, ref = _mapping_batch()
    jh = jdb.search(q, ref, window=512, strand="both", plan="scan")
    recs = jdb.align_hits(jh, q, ref)
    extra = [
        jdb.HitAlignment(0, 100, 10, 39, 0, 29, "A" * 30, "A" * 30, "30M"),
        jdb.HitAlignment(1, 100, 50, 79, 0, 29, "A" * 30, "A" * 30, "30M",
                         strand="-", xs=50),
        jdb.HitAlignment(1, 50, 200, 229, 2, 29, "A" * 28, "A" * 28, "28M",
                         is_secondary=True),
        jdb.HitAlignment(2, 0, -1, -1, 0, 0, "", "", "*", is_unmapped=True),
        jdb.HitAlignment(3, 0, 499, -1, 0, 0, "", "", "*", is_unmapped=True,
                         flag_extra=0x1 | 0x80, rnext="=", pnext=499,
                         rname="c2"),
        jdb.HitAlignment(0, 120, 10, 49, 0, 39, "A" * 40, "A" * 40, "40M",
                         xs=0, flag_extra=0x63, rnext="=", pnext=300,
                         tlen=-330),
    ]
    quals = ["I" * 40, "ABCDEFGHIJ" * 4, None, "#" * 40]
    prec = [tdb.HitAlignment(*r) for r in recs + extra]
    for kw in (dict(ref_len=len(ref)),
               dict(ref_name="chr1", ref_len=len(ref), quals=quals,
                    read_names=["a", "b", "c", "d"], so="coordinate"),
               dict(sq=[("c1", 1000), ("c2", 2000)], pg="map x y")):
        want = jdb.to_sam(recs + extra, q, **kw)
        got = tdb.to_sam(prec, q, **kw)
        assert _sam_body(got) == _sam_body(want)
    got = tdb.to_sam(prec, q, pg="map x y")
    pg = [ln for ln in got.splitlines() if ln.startswith("@PG")]
    assert pg == [f"@PG\tID:swtpu_torch\tPN:swtpu_torch\t"
                  f"VN:{swtpu_torch.__version__}\tCL:map x y"]
    prot = [np.arange(20, dtype=np.int8)]
    precs = [tdb.HitAlignment(0, 50, 5, 24, 0, 19, "", "", "20M")]
    from swtpu.core.encode import PROTEIN_ALPHABET
    assert _sam_body(tdb.to_sam(precs, prot, alphabet=PROTEIN_ALPHABET)) \
        == _sam_body(jdb.to_sam([jdb.HitAlignment(*precs[0])], prot,
                                alphabet=PROTEIN_ALPHABET))
    assert swtpu_torch.to_sam is tdb.to_sam


# ---- the CUDA kernel on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(WINDOW_CASES))
@pytest.mark.parametrize("name", list(SCORINGS))
def test_window_kernel_matches_plain_on_card(card, name, case):
    B, rlen, W, seed, kw = WINDOW_CASES[case]
    reads, win = _window_case(name, B, rlen, W, seed, **kw)
    sc, sub = _port(*SCORINGS[name])
    subt = None if sub is None else torch.from_numpy(sub).to(card)
    rt, wt = torch.from_numpy(reads).to(card), torch.from_numpy(win).to(card)
    want = _fields(wf.window_score_plain(rt, wt, sc, subt))
    before = dict(wf.launches)
    for T in (None, 32, 256):
        assert _fields(wf.window_score(rt, wt, sc, T, subt)) == want, T
        # the stripe template's K6 at this T, whatever the read length
        stripe = wf._TemplateWindow(rt, wt.numel(), sc, subt, T)
        assert _fields(stripe(wt)) == want, T
    # these reads take the warp-per-read route; each entry launched 3 times
    name_k = wf.window_route_name(rlen, sc, sub)
    name_s = wf.window_kernel_name(sc, sub)
    assert name_k == wf.warp_kernel_name(sc, sub)
    assert wf.launches[name_k] == before[name_k] + 3
    assert wf.launches[name_s] == before[name_s] + 3


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_kernel_matches_plain_on_card(card, case):
    q, ref = _mapping_batch()
    kw = dict(window=512, **SEARCH_CASES[case])
    got = tdb.search(q, ref, device=card, **kw)
    assert got.scores.device.type == "cuda"
    want = tdb.search(q, ref, plan="scan", device=card, **kw)
    _same(jdb.search(q, ref, plan="scan", **kw), got)
    assert _fields(got) == _fields(want)
