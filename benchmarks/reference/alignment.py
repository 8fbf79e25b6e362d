"""Is an alignment's pair of strings an optimal local alignment that ends
at the answer's end cell? Plain NumPy, independent of the program.

The program's memory-lean traceback promises an optimal alignment with the
forward score, which on ties may differ from the full predecessor walk, so
the strings are held to what that promise fixes: equal lengths, no column
of two gaps, the letters of each string (gaps taken out) the run of its
sequence that ends at the end cell (b at row i, a at column j), and a
score under the scoring equal to the max score."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .sw import Scoring


def rescore(ra: np.ndarray, rb: np.ndarray, scoring: Scoring,
            table: Optional[np.ndarray] = None) -> int:
    """The score of an alignment given as two equal-length code arrays,
    -1 marking a gap: substitution scores of the aligned columns plus
    the gaps' costs (each run of gaps in one string a gap)."""
    both = (ra >= 0) & (rb >= 0)
    if table is not None:
        sub = np.asarray(table, np.int64)[ra[both], rb[both]]
    else:
        sub = np.where(ra[both] == rb[both], scoring.match,
                       scoring.mismatch)
    total = int(sub.sum())
    for g in (ra < 0, rb < 0):
        letters = int(g.sum())
        if not scoring.affine:
            total += scoring.gap * letters
            continue
        runs = int((g & ~np.concatenate([[False], g[:-1]])).sum())
        total += (scoring.gap_open * runs
                  + scoring.gap_extend * (letters - runs))
    return total


def check(a: np.ndarray, b: np.ndarray, alphabet: str, scoring: Scoring,
          score: int, i: int, j: int, aligned_a: Optional[str],
          aligned_b: Optional[str],
          table: Optional[np.ndarray] = None) -> bool:
    """True when (aligned_a, aligned_b) is an optimal local alignment of
    a (columns) and b (rows) ending at cell (i, j) with ``score``, the
    reference's max score; for a max of 0, when there are no strings."""
    if score <= 0:
        return not aligned_a and not aligned_b
    if aligned_a is None or aligned_b is None \
            or len(aligned_a) != len(aligned_b) or not aligned_a:
        return False
    lut = np.full(256, -2, np.int64)
    for k, c in enumerate(alphabet):
        lut[ord(c)] = k
    lut[ord("-")] = -1
    ra = lut[np.frombuffer(aligned_a.encode(), np.uint8)]
    rb = lut[np.frombuffer(aligned_b.encode(), np.uint8)]
    if (ra == -2).any() or (rb == -2).any() or ((ra < 0) & (rb < 0)).any():
        return False
    la, lb = ra[ra >= 0], rb[rb >= 0]
    if len(la) > j or len(lb) > i:
        return False
    if not (np.array_equal(la, a[j - len(la):j])
            and np.array_equal(lb, b[i - len(lb):i])):
        return False
    return rescore(ra, rb, scoring, table) == score
