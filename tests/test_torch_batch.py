"""The port's batch path against the JAX package's, on the CPU.

The same numpy inputs go through ``swtpu.dist.batch`` and
``swtpu_torch.dist.batch`` (``device='cpu'``); scorings and tables cross
through ``swtpu_torch.convert``. The port's 'stripe' (K8) and 'packed' (K7)
plans run their plain version here and are held against the JAX Pallas
kernels in interpret mode, at the JAX tests' own shapes and parameters.
Tolerance: exact equality of scores, max_i and max_j (integer DP). The
CUDA kernels run only on a card: the ``gpu`` tests hold them against their
plain version there and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swtpu
import swtpu_torch
from swtpu.core import oracle
from swtpu.core.config import Scoring as JScoring
from swtpu.core.encode import PROTEIN_ALPHABET, random_batch
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.dist import batch as jbatch
from swtpu.kernels.pallas_fill import pairs_packed_score_fn, pairs_score_fn
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.dispatch.plan import runs_kernels
from swtpu_torch.dist import batch as tbatch
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import pack_rows as pk
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf

BLOSUM62 = substitution_from_jax(np.asarray(J_BLOSUM62))
SCORINGS = {
    "linear": (JScoring(), None),
    "dna_affine": (JScoring(mode="affine", gap_open=-4, gap_extend=-1), None),
    "blosum62": (JScoring(mode="affine", gap_open=-11, gap_extend=-1),
                 J_BLOSUM62),
}


def _protein_batch(B, m, n, seed, overlap=True):
    rng = np.random.default_rng(seed)
    aa = rng.integers(0, 20, (B, m)).astype(np.int8)
    bb = rng.integers(0, 20, (B, n)).astype(np.int8)
    k = min(m - 3, n - 5, min(m, n) // 2)
    if overlap and k > 0:       # planted homology, as the JAX tests do
        bb[:, 5:5 + k] = aa[:, 3:3 + k]
    return aa, bb


def _batch(name, B, m, n, seed):
    if name == "blosum62":
        return _protein_batch(B, m, n, seed)
    aa, bb = random_batch(B, m, n, seed=seed)
    k = min(m, n) // 2
    bb[:, :k] = aa[:, :k]
    return aa, bb


def _port(jsc, jsub):
    return scoring_from_jax(jsc), (None if jsub is None
                                   else substitution_from_jax(jsub))


def _triple(hits):
    """[scores, max_i, max_j] as lists, from torch or JAX results."""
    return [(x.cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x)).astype(np.int64).tolist() for x in hits]


# ---- the plain batched fill against the JAX vmapped scan ----

@pytest.mark.parametrize("band", [None, 0, 1, 8])
@pytest.mark.parametrize("name", list(SCORINGS))
def test_scan_plan_matches_jax_scan(name, band):
    jsc, jsub = SCORINGS[name]
    sc, sub = _port(jsc, jsub)
    for B, m, n, seed in ((5, 40, 30, 1), (3, 1, 9, 2), (3, 9, 1, 3),
                          (1, 17, 23, 4)):
        aa, bb = _batch(name, B, m, n, seed)
        want = jbatch.batch_score(aa, bb, jsc, band=band, plan="scan",
                                  substitution=jsub)
        for plan in ("scan", "auto"):
            got = tbatch.batch_score(aa, bb, sc, band=band, plan=plan,
                                     substitution=sub, device="cpu")
            assert _triple(got) == _triple(want), (B, m, n, plan)
        direct = pf.pairs_score_plain(
            torch.from_numpy(aa), torch.from_numpy(bb), sc,
            None if sub is None else torch.from_numpy(sub), band)
        assert _triple(direct) == _triple(want)


# ---- 'stripe' and 'packed' against the Pallas kernels in interpret mode
# (shapes, T, R and C of tests/test_dist_batch.py) ----

def _ties_batch():
    aa, bb = random_batch(8, 64, 96, seed=17)
    aa[:, 10:18] = aa[:, 40:48]
    bb[:, 5:13] = aa[:, 10:18]
    bb[:, 60:68] = aa[:, 10:18]
    return aa, bb


PALLAS_CASES = {
    "grid_6x40x300": (lambda: random_batch(6, 40, 300, seed=13), "linear",
                      pairs_score_fn, dict(T=256, R=2, C=128)),
    "grid_protein_4x60x280": (lambda: _protein_batch(4, 60, 280, seed=21),
                              "blosum62", pairs_score_fn,
                              dict(T=256, R=2, C=128)),
    "packed_45x40x5": (lambda: random_batch(45, 40, 5, seed=13), "linear",
                       pairs_packed_score_fn, dict(T=256, R=2, C=128)),
    "grid_ties_8x64x96": (_ties_batch, "linear", pairs_score_fn,
                          dict(T=256, R=2, C=128)),
    "packed_ties_8x64x96": (_ties_batch, "linear", pairs_packed_score_fn,
                            dict(T=512, R=4, C=128)),
    "packed_protein_7x52x33": (lambda: _protein_batch(7, 52, 33, seed=23),
                               "blosum62", pairs_packed_score_fn,
                               dict(T=512, R=4, C=128)),
    "packed_affine_5x30x44": (lambda: random_batch(5, 30, 44, seed=29),
                              "dna_affine", pairs_packed_score_fn,
                              dict(T=256, R=2, C=128)),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_kernel_plans_match_pallas(case):
    make, name, jfn, params = PALLAS_CASES[case]
    aa, bb = make()
    jsc, jsub = SCORINGS[name]
    B, m = aa.shape
    fn = jfn(B, m, bb.shape[1], scoring=jsc, interpret=True,
             substitution=jsub, **params)
    want = _triple(fn(jnp.asarray(aa), jnp.asarray(bb)))
    sc, sub = _port(jsc, jsub)
    for plan in ("stripe", "packed"):
        got = tbatch.batch_score(aa, bb, sc, plan=plan, substitution=sub,
                                 device="cpu")
        assert _triple(got) == want, plan
    for g in range(B):           # and the oracle the kernels are held to
        ref = oracle.fill(aa[g], bb[g], jsc, sub=jsub)
        assert want[0][g] == ref.max_score
        if ref.max_score > 0:
            assert (want[1][g], want[2][g]) == ref.max_ij


@pytest.mark.parametrize("plan", ["stripe", "packed"])
def test_score_many_padding_exact_on_kernel_plans(plan):
    rng = np.random.default_rng(9)
    lens = [(37, 50), (64, 33), (17, 64)]
    aa = np.full((len(lens), 64), -3, np.int8)
    bb = np.full((len(lens), 64), -2, np.int8)
    raw = []
    for r, (m, n) in enumerate(lens):
        a = rng.integers(0, 4, m).astype(np.int8)
        b = rng.integers(0, 4, n).astype(np.int8)
        b[: m // 2] = a[: m // 2]
        aa[r, :m], bb[r, :n] = a, b
        raw.append((a, b))
    want = jbatch.batch_score(aa, bb, plan="packed", interpret=True)
    got = tbatch.batch_score(aa, bb, plan=plan, device="cpu")
    assert _triple(got) == _triple(want)
    for r, (a, b) in enumerate(raw):
        ref = oracle.fill(a, b)
        assert (_triple(got)[0][r], _triple(got)[1][r],
                _triple(got)[2][r]) == (ref.max_score, *ref.max_ij)


# ---- the band contract ----

@pytest.mark.parametrize("plan", ["stripe", "packed"])
def test_band_is_refused_by_kernel_plans(plan):
    aa, bb = random_batch(4, 48, 40, seed=11)
    with pytest.raises(ValueError, match="band"):
        jbatch.batch_score(aa, bb, band=8, plan=plan)
    with pytest.raises(ValueError, match="band"):
        tbatch.batch_score(aa, bb, band=8, plan=plan, device="cpu")


def test_banded_auto_matches_jax_and_restricts():
    aa, bb = random_batch(4, 48, 40, seed=11)
    want = jbatch.batch_score(aa, bb, band=8)
    got = tbatch.batch_score(aa, bb, band=8, device="cpu")
    assert _triple(got) == _triple(want)
    a = np.tile(swtpu_torch.encode("AAAAAAAATTTT"), (2, 1))
    b = np.tile(swtpu_torch.encode("TTTTAAAAAAAA"), (2, 1))
    narrow = tbatch.batch_score(a, b, band=2, device="cpu")
    full = tbatch.batch_score(a, b, plan="scan", device="cpu")
    assert int(narrow.scores[0]) < int(full.scores[0])
    assert _triple(narrow) == _triple(jbatch.batch_score(a, b, band=2))


# ---- score_many ----

def _hetero():
    rng = np.random.default_rng(5)
    shapes = [(37, 211), (64, 64), (211, 37), (5, 300), (130, 129),
              (64, 64), (1, 1), (97, 3)]
    a_list = [rng.integers(0, 4, m).astype(np.int8) for m, _ in shapes]
    b_list = [rng.integers(0, 4, n).astype(np.int8) for _, n in shapes]
    b_list[0][20:50] = a_list[0][2:32]
    b_list[4][:60] = a_list[4][60:120]
    return a_list, b_list


def _protein_lists():
    rng = np.random.default_rng(5)
    ap = [rng.integers(0, 20, m).astype(np.int8) for m in (33, 120, 33)]
    bp = [rng.integers(0, 20, n).astype(np.int8) for n in (150, 45, 150)]
    bp[0][10:30] = ap[0][5:25]
    return ap, bp


def _empties():
    a_list, b_list = _hetero()
    return ([np.zeros(0, np.int8), a_list[0]],
            [b_list[0], np.zeros(0, np.int8)])


def _first3():
    a_list, b_list = _hetero()
    return a_list[:3], b_list[:3]


SCORE_MANY_CASES = {
    "linear": (_hetero, JScoring(), None),
    "match5": (_hetero, JScoring(match=5, mismatch=-3, gap=-4), None),
    "affine": (_hetero, JScoring(mode="affine", gap_open=-11,
                                 gap_extend=-1), None),
    "protein": (_protein_lists, JScoring(mode="affine", gap_open=-10,
                                         gap_extend=-1), J_BLOSUM62),
    "empty_operands": (_empties, JScoring(), None),
    "not_pad_exact": (_first3, JScoring(match=2, mismatch=0, gap=-1), None),
}


@pytest.mark.parametrize("case", list(SCORE_MANY_CASES))
def test_score_many_matches_jax(case):
    make, jsc, jsub = SCORE_MANY_CASES[case]
    a_list, b_list = make()
    want = swtpu.score_many(a_list, b_list, scoring=jsc, substitution=jsub)
    sc, sub = _port(jsc, jsub)
    got = swtpu_torch.score_many(a_list, b_list, scoring=sc,
                                 substitution=sub, device="cpu")
    assert _triple(got) == _triple(want)
    for k, (a, b) in enumerate(zip(a_list, b_list)):
        ref = oracle.fill(a, b, jsc, sub=jsub) if len(a) and len(b) else None
        if ref is None:
            assert [x[k] for x in _triple(got)] == [0, 0, 0]
        else:
            assert [x[k] for x in _triple(got)] == [ref.max_score,
                                                     *ref.max_ij]


def test_score_many_rejects_unequal_lists():
    a_list, b_list = _hetero()
    with pytest.raises(ValueError, match="sequences"):
        swtpu_torch.score_many(a_list, b_list[:2], device="cpu")


# ---- score_many's packing: one upload, the buckets built on the device ----

def test_bucket_lens_are_the_bucket_len_of_each_length():
    x = np.arange(1, (1 << 17) + 1)
    want = np.array([jbatch._bucket_len(int(v)) for v in x])
    assert np.array_equal(tbatch._bucket_lens(x), want)


def _host_packing(a_list, b_list):
    """score_many's buckets as the host built them: a Python step a pair
    to bucket it, ``np.full`` of each side, a row copy a pair."""
    buckets = {}
    for k in range(len(a_list)):
        m, n = len(a_list[k]), len(b_list[k])
        if m and n:
            buckets.setdefault((jbatch._bucket_len(m), jbatch._bucket_len(n)),
                               []).append(k)
    out = []
    for (mb, nb), idx in sorted(buckets.items()):
        aa = np.full((len(idx), mb), -3, np.int8)
        bb = np.full((len(idx), nb), -2, np.int8)
        for r, k in enumerate(idx):
            aa[r, :len(a_list[k])] = tbatch._host(a_list[k])
            bb[r, :len(b_list[k])] = tbatch._host(b_list[k])
        out.append((mb, nb, idx, aa, bb))
    return out


def _shared_query(n=40, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, 70).astype(np.int8)
    entries = [rng.integers(0, 20, int(x)).astype(np.int8)
               for x in rng.integers(1, 140, n)]
    entries[5][10:40] = q[20:50]
    return [q] * n, entries


def _tensor_lists():
    a_list, b_list = _hetero()
    return ([torch.from_numpy(x) for x in a_list],
            [torch.from_numpy(x) for x in b_list])


def _pow2_edges():
    rng = np.random.default_rng(8)
    lens = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129]
    a_list = [rng.integers(0, 4, m).astype(np.int8) for m in lens]
    b_list = [rng.integers(0, 4, n).astype(np.int8) for n in lens[::-1]]
    return a_list, b_list


def _with_empties():
    a_list, b_list = _hetero()
    ea, eb = _empties()
    return ea + a_list + ea, eb + b_list + eb


PACK_CASES = {"hetero": _hetero, "protein": _protein_lists,
              "empty_operands": _with_empties, "shared_query": _shared_query,
              "tensor_elements": _tensor_lists, "pow2_edges": _pow2_edges}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_plain_pack_equals_the_host_packing(case):
    a_list, b_list = PACK_CASES[case]()
    want = _host_packing(a_list, b_list)
    p = tbatch._upload(a_list, b_list, torch.device("cpu"))
    assert [(mb, nb) for mb, nb, *_ in want] == \
        [(mb, nb) for mb, nb, _, _ in p.buckets]
    for k, ((mb, nb, idx, aa, bb), (_, _, lo, hi)) in enumerate(
            zip(want, p.buckets)):
        assert p.order[lo:hi].tolist() == idx
        got_a, got_b = tbatch._pack(p, k)
        assert got_a.dtype == got_b.dtype == torch.int8
        assert np.array_equal(got_a.numpy(), aa)
        assert np.array_equal(got_b.numpy(), bb)


def test_upload_of_only_empty_operands_is_none():
    assert tbatch._upload(*_empties(), torch.device("cpu")) is None


def test_upload_shares_one_copy_of_a_shared_object():
    a_list, b_list = _shared_query(30)
    p = tbatch._upload(a_list, b_list, torch.device("cpu"))
    # the query once, then every entry
    assert p.flat.numel() == len(a_list[0]) + sum(map(len, b_list))
    assert {o for t in p.tables for o in t[0].tolist()} == {0}
    again = tbatch._upload([x.copy() for x in a_list], b_list,
                           torch.device("cpu"))
    assert again.flat.numel() == sum(map(len, a_list + b_list))


def _pack_inputs(rows, width, seed):
    """A flat buffer and ragged rows into it: lengths 0 to width, offsets
    anywhere (the buffer's last byte among them)."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(-128, 128, 3 * width + 37).astype(np.int8)
    lens = rng.integers(0, width + 1, rows)
    lens[:4] = [width, 0, min(width, 37), width - 5]   # a ragged last chunk
    off = rng.integers(0, len(flat) - lens + 1)
    off[2] = len(flat) - lens[2]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in
                 (flat, off.astype(np.int32), lens.astype(np.int32)))


def test_pack_rows_plain_gathers_each_row_then_its_fill():
    flat, off, lens = _pack_inputs(50, 48, 4)
    got = pk.pack_rows(flat, off, lens, 48, -2).numpy()
    fl = flat.numpy()
    for r, (o, n) in enumerate(zip(off.tolist(), lens.tolist())):
        assert np.array_equal(got[r, :n], fl[o:o + n])
        assert (got[r, n:] == -2).all()
    assert pk.pack_rows(flat[:0], off[:0], lens[:0], 16, -3).shape == (0, 16)


def test_pack_launch_arguments_are_the_entrys(monkeypatch):
    seen = []
    monkeypatch.setattr(sf, "_call", lambda nm, dev, args, counter=None,
                        counts=None: seen.append((nm, args, counts)))
    flat, off, lens = _pack_inputs(7, 32, 5)
    out = pk._launch_pack(flat, off, lens, 32, -3)
    (name, args, counts), = seen
    assert name == pk.PACK_KERNEL and counts is pk.launches
    assert len(args) + 1 == len(_cuda.ARGTYPES[name])         # + the stream
    assert args[:3] == [flat.data_ptr(), off.data_ptr(), lens.data_ptr()]
    assert args[3:6] == [7, 32, -3]
    assert args[-1] == out.data_ptr() and out.shape == (7, 32)
    with pytest.raises(ValueError, match="multiple of 16"):
        pk._launch_pack(flat, off, lens, 40, -3)


@pytest.mark.parametrize("bad, err", [
    (dict(flat=torch.zeros(4, dtype=torch.int32)), "flat"),
    (dict(off=torch.zeros(3, dtype=torch.int64)), "int32"),
    (dict(lens=torch.zeros(2, dtype=torch.int32)), "int32"),
    (dict(width=0), "width")])
def test_pack_rows_rejects_bad_inputs(bad, err):
    kw = dict(flat=torch.zeros(8, dtype=torch.int8),
              off=torch.zeros(3, dtype=torch.int32),
              lens=torch.ones(3, dtype=torch.int32), width=16, fill=-3)
    kw.update(bad)
    with pytest.raises(ValueError, match=err):
        pk.pack_rows(**kw)


def test_score_many_shared_query_matches_the_oracle():
    jsc, jsub = SCORINGS["blosum62"]
    sc, sub = _port(jsc, jsub)
    a_list, b_list = _shared_query(24)
    got = _triple(swtpu_torch.score_many(a_list, b_list, sc,
                                         substitution=sub, device="cpu"))
    for k, (a, b) in enumerate(zip(a_list, b_list)):
        ref = oracle.fill(a, b, jsc, sub=jsub)
        assert [x[k] for x in got] == [ref.max_score, *ref.max_ij]


def test_score_many_keeps_nothing_between_calls():
    a_list, b_list = _shared_query(12)
    first = _triple(swtpu_torch.score_many(a_list, b_list, device="cpu"))
    n = min(len(b_list[5]), len(a_list[0]))
    b_list[5][:n] = a_list[0][:n]          # in place, the same objects
    a_list[0][:3] = 2                      # the shared query too
    second = _triple(swtpu_torch.score_many(a_list, b_list, device="cpu"))
    assert second != first
    for k, (a, b) in enumerate(zip(a_list, b_list)):
        ref = oracle.fill(a, b)
        assert [x[k] for x in second] == [ref.max_score, *ref.max_ij]


# ---- batch_align / align_many ----

def _same_records(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert (g.max_score, g.max_i, g.max_j, g.last_cell) == \
            (w.max_score, w.max_i, w.max_j, w.last_cell)
        assert (g.aligned_a, g.aligned_b) == (w.aligned_a, w.aligned_b)


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("top", [None, 3])
def test_batch_align_matches_jax(name, top):
    jsc, jsub = SCORINGS[name]
    sc, sub = _port(jsc, jsub)
    aa, bb = _batch(name, 5, 48, 40, seed=33)
    bb[2] = aa[2, :40]           # a tie-free best pair
    alphabet = (swtpu_torch.core.encode.PROTEIN_ALPHABET
                if name == "blosum62" else None)
    want = swtpu.batch_align(aa, bb, scoring=jsc, substitution=jsub,
                             alphabet=alphabet, top=top)
    got = swtpu_torch.batch_align(aa, bb, sc, substitution=sub,
                                  alphabet=alphabet, top=top, device="cpu")
    assert len(got) == (5 if top is None else top)
    _same_records(got, want)
    scores = [r.max_score for _, r in got]
    assert scores == sorted(scores, reverse=True)


def test_batch_align_banded_matches_jax():
    aa, bb = random_batch(5, 48, 40, seed=33)
    want = swtpu.batch_align(aa, bb, band=6)
    got = swtpu_torch.batch_align(aa, bb, band=6, device="cpu")
    _same_records(got, want)


@pytest.mark.parametrize("top", [None, 1])
def test_align_many_matches_jax(top):
    rng = np.random.default_rng(3)
    a_list = [rng.integers(0, 4, m).astype(np.int8) for m in (80, 200, 40)]
    b_list = [rng.integers(0, 4, n).astype(np.int8) for n in (150, 60, 300)]
    b_list[1][5:45] = a_list[1][100:140]
    want = swtpu.align_many(a_list, b_list, top=top)
    got = swtpu_torch.align_many(a_list, b_list, top=top, device="cpu")
    assert got[0][0] == 1
    _same_records(got, want)


def test_align_many_protein_matches_jax():
    ap, bp = _protein_lists()
    jsc, jsub = SCORINGS["blosum62"]
    sc, sub = _port(jsc, jsub)
    alphabet = swtpu_torch.core.encode.PROTEIN_ALPHABET
    want = swtpu.align_many(ap, bp, scoring=jsc, substitution=jsub,
                            alphabet=alphabet)
    got = swtpu_torch.align_many(ap, bp, sc, substitution=sub,
                                 alphabet=alphabet, device="cpu")
    _same_records(got, want)


# ---- the wrappers, their reductions and counters ----

def test_cpu_tensors_run_the_plain_version():
    aa, bb = (torch.from_numpy(x) for x in random_batch(3, 20, 30, seed=5))
    pf.reset_counts()
    pf.pairs_score(aa, bb)
    pf.pairs_packed_score(aa, bb)
    assert pf.plain_calls == {"pairs_score_plain": 2}
    assert pf.launches == dict.fromkeys(pf.launches, 0)
    assert set(pf.launches) == {
        "sw_pairs_rb_linear", "sw_pairs_rb_affine", "sw_pairs_rb_sub",
        "sw_pairs_rb_band_linear", "sw_pairs_rb_band_affine",
        "sw_pairs_rb_band_sub", "sw_pairs_score_linear", "sw_pairs_score_affine",
        "sw_pairs_score_sub", "sw_pairs_score_linear[band]",
        "sw_pairs_score_affine[band]", "sw_pairs_score_sub[band]",
        "sw_packed_score_linear", "sw_packed_score_affine",
        "sw_packed_score_sub", "sw_packed_rb_linear", "sw_packed_rb_affine",
        "sw_packed_rb_sub"}
    sf.plain_calls["stripe_score_plain"] += 1
    pf.reset_counts()                # zeroes the single-pair counters too
    assert not any(pf.plain_calls.values())
    assert not any(sf.plain_calls.values())


@pytest.mark.parametrize("args, err", [
    ((np.zeros((2, 5), np.int32), np.zeros((2, 6), np.int8)), TypeError),
    ((np.zeros(5, np.int8), np.zeros(6, np.int8)), ValueError),
    ((np.zeros((2, 5), np.int8), np.zeros((3, 6), np.int8)), ValueError),
    ((np.zeros((0, 5), np.int8), np.zeros((0, 6), np.int8)), ValueError),
    ((np.zeros((2, 0), np.int8), np.zeros((2, 6), np.int8)), ValueError),
], ids=["dtype", "1d", "unequal_B", "B_is_0", "m_is_0"])
def test_wrappers_reject_bad_inputs(args, err):
    a, b = (torch.from_numpy(x) for x in args)
    for fn in (pf.pairs_score, pf.pairs_packed_score):
        with pytest.raises(err):
            fn(a, b)


def test_wrappers_reject_scorings_the_kernels_do_not_take():
    aa, bb = (torch.from_numpy(x) for x in random_batch(2, 20, 30, seed=6))
    for fn in (pf.pairs_score, pf.pairs_packed_score):
        with pytest.raises(ValueError, match="stripe kernel"):
            fn(aa, bb, swtpu_torch.Scoring(mismatch=0))
    sub = torch.from_numpy(BLOSUM62)
    with pytest.raises(ValueError, match="substitution codes"):
        pf.pairs_score(aa - 5, bb, swtpu_torch.Scoring(), substitution=sub)


def test_stripe_reduce_takes_each_pairs_first_stripe():
    best = torch.tensor([[[5, 3, 9, 0], [7, 200, 4, 0], [7, 300, 1, 0]],
                         [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
                         [[4, 10, 2, 0], [1, 40, 5, 0], [4, 70, 1, 0]]],
                        dtype=torch.int32)
    assert _triple(pf._reduce_stripes(best)) == [[7, 0, 4], [200, 0, 10],
                                                 [4, 0, 2]]


def test_row_reduce_takes_each_pairs_first_row():
    rows = torch.tensor([[[2, 5], [6, 9], [6, 1]],
                         [[0, 0], [0, 0], [0, 0]],
                         [[3, 3], [1, 1], [3, 1]]], dtype=torch.int32)
    assert _triple(pf._reduce_rows(rows)) == [[6, 0, 3], [2, 0, 1],
                                              [9, 0, 3]]


@pytest.mark.parametrize("n, B, A, want", [
    (1056, 64, 0, 352),       # 1056 = 3 x 352: a chain per pair
    (16384, 16, 0, 256),      # the default divides n
    (5, 45, 0, 256),          # one stripe holds all 225 rows
    (40, 100, 0, 320),        # 8 pairs a stripe
    (1056, 64, 21, 352),      # the profile's cap leaves room
    (977, 3, 0, 256),         # nothing fits: the default
])
def test_packed_stripe_rows_start_pairs_on_stripes(n, B, A, want):
    assert pf.packed_stripe_rows(n, B, None, A) == want
    assert pf.packed_stripe_rows(n, B, 64, A) == 64


@pytest.mark.parametrize("n, band, A, cut", [
    (1056, None, 0, True),      # T = 352: a chain per pair
    (16384, None, 0, True),
    (5, None, 0, True),         # T = 320: 64 pairs a stripe
    (96, None, 21, True),
    (1056, 8, 0, True),         # a band runs K8[band]
    (1000, None, 0, False),     # no T cuts K7's chain
    (300, None, 0, False),
    (1500, None, 20, False),
])
def test_auto_plan_runs_k7_only_where_its_chain_is_cut(n, band, A, cut):
    """K7 runs under 'auto' nowhere, even where a stripe height cuts its
    chain: the register-blocked K8 beat it there in every scoring on the
    card (auto_plan's docstring), and K8[band] is the only banded batch
    kernel."""
    assert tbatch.auto_plan(n, band, A) == "stripe"
    assert (pf.chain_cutting_rows(n, A) is not None) == cut


REFUSED = [
    (JScoring(match=2, mismatch=0, gap=-1), None),
    (JScoring(gap=0), None),
    (JScoring(mode="affine", gap_open=-4, gap_extend=0), None),
    (JScoring(gap=0), J_BLOSUM62),
]
REFUSED_IDS = ["mismatch_0", "gap_0", "extend_0", "table_gap_0"]


def _refused_batch(table):
    if table is None:
        return _batch("linear", 3, 20, 30, 9)
    rng = np.random.default_rng(9)
    return (rng.integers(0, 20, (3, 20)).astype(np.int8),
            rng.integers(0, 20, (3, 30)).astype(np.int8))


@pytest.mark.parametrize("jsc, jtable", REFUSED, ids=REFUSED_IDS)
def test_card_refuses_scorings_the_kernels_do_not_take(jsc, jtable):
    """A card runs the plain sweep, decided before any launch, for a
    scoring the kernels do not take, and answers as the JAX package."""
    scoring, table = _port(jsc, jtable)
    assert not runs_kernels(torch.device("cuda"), scoring, table)
    assert not runs_kernels(torch.device("cpu"), scoring, table)
    assert runs_kernels(torch.device("cuda"), swtpu_torch.Scoring())
    aa, bb = _refused_batch(jtable)
    want = _triple(jbatch.batch_score(aa, bb, jsc, substitution=jtable))
    assert _triple(swtpu_torch.batch_score(aa, bb, scoring,
                                           substitution=table,
                                           device="cpu")) == want
    assert _triple(swtpu_torch.score_many(list(aa), list(bb), scoring,
                                          substitution=table,
                                          device="cpu")) == want


def test_plan_contract():
    aa, bb = random_batch(2, 8, 8, seed=1)
    # the host SIMD tier is ported: it refuses a band, as the JAX
    # package's does
    for kw, match in ((dict(plan="host-simd", band=2), "host-simd"),
                      (dict(plan="bogus"), "unknown plan")):
        with pytest.raises(ValueError, match=match):
            tbatch.batch_score(aa, bb, device="cpu", **kw)
    # the mesh is ported: what is not a Mesh is refused, and 'pipeline'
    # without a mesh runs the single-device plans, as in the JAX package
    with pytest.raises(TypeError, match="mesh"):
        tbatch.batch_score(aa, bb, device="cpu", mesh=object())
    assert _triple(tbatch.batch_score(aa, bb, plan="pipeline",
                                      device="cpu")) == _triple(
        jbatch.batch_score(aa, bb, plan="pipeline"))
    # and a scoring its lazy-F loop cannot take (extension dearer than
    # opening), in score_many's buckets too
    with pytest.raises(ValueError, match="host-simd"):
        swtpu_torch.score_many(list(aa), list(bb), swtpu_torch.Scoring(
            mode="affine", gap_open=-1, gap_extend=-6), plan="host-simd",
            device="cpu")


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("B, m, n, T", [(6, 40, 300, 32), (45, 40, 5, 32),
                                        (45, 40, 5, 256), (8, 64, 96, None),
                                        (1, 1, 70, 64), (7, 52, 33, None)])
def test_kernels_match_plain_on_card(cuda, name, B, m, n, T):
    jsc, jsub = SCORINGS[name]
    sc, sub_np = _port(jsc, jsub)
    aa, bb = (torch.from_numpy(x).to(cuda) for x in _batch(name, B, m, n, 7))
    sub = None if sub_np is None else torch.from_numpy(sub_np).to(cuda)
    want = _triple(pf.pairs_score_plain(aa, bb, sc, sub))
    for _ in range(3):          # ordering races show as run-to-run changes
        assert _triple(pf.pairs_score(aa, bb, sc, T, sub)) == want
        assert _triple(pf.pairs_packed_score(aa, bb, sc, T, sub)) == want
    for band in (0, 1, 8, 64):
        assert _triple(pf.pairs_score(aa, bb, sc, T, sub, band)) == \
            _triple(pf.pairs_score_plain(aa, bb, sc, sub, band))


@pytest.mark.gpu
def test_public_batch_calls_launch_the_kernels_on_card(cuda):
    aa, bb = _batch("linear", 6, 60, 90, 8)
    want = _triple(tbatch.batch_score(aa, bb, device="cpu"))
    want_band = _triple(tbatch.batch_score(aa, bb, band=4, device="cpu"))
    pf.reset_counts()
    assert _triple(swtpu_torch.batch_score(aa, bb)) == want
    # 'auto' runs K8
    assert pf.launches["sw_pairs_rb_linear"] == 1
    assert pf.launches["sw_packed_rb_linear"] == 0
    for plan in ("stripe", "packed"):
        assert _triple(swtpu_torch.batch_score(aa, bb, plan=plan)) == want
    assert _triple(swtpu_torch.batch_score(aa, bb, band=4)) == want_band
    got = swtpu_torch.score_many(list(aa), list(bb))
    assert _triple(got) == want
    recs = swtpu_torch.batch_align(aa, bb, top=2)
    assert [r.max_score for _, r in recs] == sorted(want[0])[::-1][:2]
    assert pf.launches["sw_pairs_rb_linear"] >= 1
    assert pf.launches["sw_pairs_score_linear"] == 0
    assert pf.launches["sw_pairs_rb_band_linear"] == 1
    assert pf.launches["sw_pairs_score_linear[band]"] == 0
    # plan='packed' runs K7's packed form, the template's K7 on no route
    assert pf.launches["sw_packed_rb_linear"] == 1
    assert pf.launches["sw_packed_score_linear"] == 0
    assert not any(pf.plain_calls.values())
    assert not any(sf.plain_calls.values())


@pytest.mark.gpu
@pytest.mark.parametrize("jsc, jtable", REFUSED, ids=REFUSED_IDS)
def test_refused_scorings_raise_on_card(cuda, jsc, jtable):
    """Once they raised; now the batch routes answer on the card with the
    plain sweep for a scoring the kernels do not take, as the JAX package
    answers with its scan, and launch no kernel."""
    sc, table = _port(jsc, jtable)
    aa, bb = _refused_batch(jtable)
    want = _triple(jbatch.batch_score(aa, bb, jsc, substitution=jtable))
    pf.reset_counts()
    assert _triple(swtpu_torch.batch_score(aa, bb, sc,
                                           substitution=table)) == want
    assert _triple(swtpu_torch.score_many(list(aa), list(bb), sc,
                                          substitution=table)) == want
    kw = dict(substitution=table,
              alphabet=None if table is None else PROTEIN_ALPHABET)
    for recs in (swtpu_torch.batch_align(aa, bb, sc, **kw),
                 swtpu_torch.align_many(list(aa), list(bb), sc, **kw)):
        assert [(i, r.max_score) for i, r in recs] == sorted(
            ((i, s) for i, s in enumerate(want[0]) if s > 0),
            key=lambda x: (-x[1], x[0]))
    assert pf.plain_calls["pairs_score_plain"] > 0
    assert not any(pf.launches.values())
    assert not any(sf.launches.values())

@pytest.mark.gpu
@pytest.mark.parametrize("rows, width", [(8906, 8192), (40, 65536)])
def test_pack_kernel_matches_plain_on_card(cuda, rows, width):
    """Every offset's alignment, rows ending inside a chunk and at the
    buffer's last byte, on the database's widest bucket and a 65536-wide
    side."""
    host = _pack_inputs(rows, width, 11)
    flat, off, lens = (x.to(cuda) for x in host)
    pf.reset_counts()
    for fill in (-3, -2):
        got = pk.pack_rows(flat, off, lens, width, fill)
        assert torch.equal(got.cpu(), pk.pack_rows_plain(*host, width, fill))
    assert pk.launches == {pk.PACK_KERNEL: 2}


@pytest.mark.gpu
def test_score_many_shared_query_on_card_matches_cpu(cuda):
    jsc, jsub = SCORINGS["blosum62"]
    sc, sub = _port(jsc, jsub)
    a_list, b_list = _shared_query(300)
    want = _triple(swtpu_torch.score_many(a_list, b_list, sc,
                                          substitution=sub, device="cpu"))
    pf.reset_counts()
    got = swtpu_torch.score_many(a_list, b_list, sc, substitution=sub)
    assert _triple(got) == want
    p = tbatch._upload(a_list, b_list, torch.device("cpu"))
    assert pk.launches == {pk.PACK_KERNEL: 2 * len(p.buckets)}
    assert pf.launches["sw_pairs_rb_sub"] == len(p.buckets)
    assert not any(pk.plain_calls.values())
