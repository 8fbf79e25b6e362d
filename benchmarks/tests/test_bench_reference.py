"""The plain reference agrees with itself (a cell-by-cell loop of the
same recurrences) and with the program's own oracle on tiny cases, and
the alignment check accepts exactly what it should."""

import numpy as np
import pytest
import torch

from benchmarks.reference import alignment, sw

from small import load

LIN = sw.Scoring()
AFF = sw.Scoring(mode="affine", gap_open=-5, gap_extend=-2)
BLOSUM = np.asarray(load("benchmarks/configs/swissprot-blosum62.json")
                    ["substitution"], np.int32)
PROT = sw.Scoring(mode="affine", gap_open=-12, gap_extend=-1)


def loop(a, b, sc, table=None, cap=None):
    """Cell by cell, strict > for the first row-major max."""
    m, n = len(a), len(b)
    NEG = -(1 << 30)
    H = np.zeros((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = (table[a[j - 1], b[i - 1]] if table is not None
                 else sc.match if a[j - 1] == b[i - 1] else sc.mismatch)
            if sc.affine:
                E[i, j] = max(H[i, j - 1] + sc.gap_open,
                              E[i, j - 1] + sc.gap_extend)
                F[i, j] = max(H[i - 1, j] + sc.gap_open,
                              F[i - 1, j] + sc.gap_extend)
                h = max(0, H[i - 1, j - 1] + s, F[i, j], E[i, j])
            else:
                h = max(0, H[i - 1, j - 1] + s, H[i - 1, j] + sc.gap,
                        H[i, j - 1] + sc.gap)
            if cap is not None:
                h = min(h, cap)
            H[i, j] = h
            if h > best:
                best, bi, bj = h, i, j
    return best, bi, bj, int(H[n, m])


@pytest.mark.parametrize("sc,alpha,table", [(LIN, 4, None), (AFF, 4, None),
                                            (PROT, 20, BLOSUM)])
@pytest.mark.parametrize("cap", [None, 20])
def test_pairs_equal_the_loop(sc, alpha, table, cap):
    rng = np.random.default_rng(3)
    a = rng.integers(0, alpha, (3, 23))
    b = a.copy()
    b[1] = rng.integers(0, alpha, 23)
    b[2, 5:12] = rng.integers(0, alpha, 7)
    got = sw.pairs(a, b, sc, table, cap)
    for k in range(3):
        assert tuple(got[k]) == loop(a[k], b[k], sc, table, cap)


@pytest.mark.parametrize("sc,alpha,table", [(LIN, 4, None), (PROT, 20, BLOSUM)])
def test_database_equals_the_loop(sc, alpha, table):
    rng = np.random.default_rng(5)
    queries = [rng.integers(0, alpha, n) for n in (9, 17, 4)]
    entries = [rng.integers(0, alpha, n) for n in (1, 13, 30, 7)]
    entries.append(queries[1].copy())
    got = sw.database(queries, entries, sc, table, group=2)
    for q, rows in zip(queries, got):
        for e, row in zip(entries, rows):
            assert tuple(row) == loop(q, e, sc, table)[:3]


def test_prefix_max_equals_cummax():
    v = torch.randint(-50, 50, (3, 2 * sw._BLOCK + 7), dtype=torch.int32)
    assert torch.equal(sw.prefix_max(v), torch.cummax(v, 1).values)


def test_pairs_equal_the_program_oracle():
    from swtpu_torch import Scoring
    from swtpu_torch.core import oracle
    rng = np.random.default_rng(7)
    a = rng.integers(0, 4, (2, 40)).astype(np.int8)
    b = rng.integers(0, 4, (2, 35)).astype(np.int8)
    for sc, prog in ((LIN, Scoring()), (AFF, Scoring(mode="affine",
                                                     gap_open=-5,
                                                     gap_extend=-2))):
        got = sw.pairs(a, b, sc)
        for k in range(2):
            o = oracle.fill(a[k], b[k], prog)
            assert tuple(got[k][:3]) == (o.max_score, *o.max_ij)
            assert got[k][3] == o.H[-1, -1]


def test_search_equals_the_program_on_the_cpu():
    import swtpu_torch
    from swtpu_torch.dist.database import pad_queries
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 2000).astype(np.int8)
    reads = [ref[p:p + 25].copy() for p in (3, 700, 1500, 1975)]
    reads[1] = (3 - reads[1])[::-1].copy()
    reads.append(rng.integers(0, 4, 20).astype(np.int8))
    q = pad_queries(reads, 27)
    got = sw.search(q, ref, LIN, window=300)
    hits = swtpu_torch.search(q, ref, window=300, strand="both",
                              device="cpu")
    want = np.stack([x.numpy() for x in hits], 1)
    assert np.array_equal(got, want)


def test_alignment_check():
    a = np.array([0, 1, 2, 3, 0, 1], np.int8)      # ACGTAC
    b = np.array([1, 2, 0, 3, 0], np.int8)         # CGATA
    sc = LIN
    assert alignment.rescore(np.array([1, 2, -1, 3, 0]),
                             np.array([1, 2, 0, 3, 0]), sc) == 10
    assert alignment.check(a, b, "ACGT", sc, 10, 5, 5, "CG-TA", "CGATA")
    assert not alignment.check(a, b, "ACGT", sc, 11, 5, 5, "CG-TA", "CGATA")
    assert not alignment.check(a, b, "ACGT", sc, 10, 5, 6, "CG-TA", "CGATA")
    assert not alignment.check(a, b, "ACGT", sc, 10, 5, 5, "CG-TA", "CGAT")
    assert not alignment.check(a, b, "ACGT", sc, 10, 5, 5, None, None)
    assert alignment.check(a, b, "ACGT", sc, 0, 0, 0, None, None)
