"""Substitution-matrix scoring (protein alignment).

The reference scores DNA only, with a match/mismatch compare. A general
substitution matrix (BLOSUM/PAM) extends the same fill to proteins: the
per-cell score becomes a table lookup S[a_code, b_code], ``a`` the query
(columns) and ``b`` the target (rows).

Sentinel codes (-1 query pad, -2 target pad, -3 read pad) score ``NEG_SUB``
against anything, so a padded cell never takes part in an alignment; the
scan plan reads the matrix embedded into an (A+3, A+3) table indexed by
``code + 3``. Codes at or above A, or below -3, are refused with a
ValueError (``kernels.scan_fill.check_codes``) rather than clamped: the JAX package's scan clamps such codes and its
stripe kernel maps them to a sentinel, and the two disagree.

This module is framework-free numpy, the same data as
``swtpu.core.substitution``; the port keeps its own copy so that it never
imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .encode import PROTEIN_ALPHABET

NEG_SUB = -(1 << 20)
# largest |S| a table may hold: real scores stay above the sentinel score
MAX_ABS_SCORE = 1 << 20

# BLOSUM62 over ARNDCQEGHILKMFPSTWYVX (standard published half-bit matrix).
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -1
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3 -1
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3 -1
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2 -1
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2 -1
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3 -1
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -1
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2 -1
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -1
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2 -1
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -1
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -1
-1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
"""

BLOSUM62 = np.array([[int(x) for x in row.split()]
                     for row in _B62.strip().splitlines()], dtype=np.int32)
assert BLOSUM62.shape == (len(PROTEIN_ALPHABET),) * 2
assert (BLOSUM62 == BLOSUM62.T).all()


def dna_matrix(match: int = 3, mismatch: int = -3) -> np.ndarray:
    """The reference's match/mismatch model as a 4x4 matrix (so the
    substitution-matrix path can be held against the compare path)."""
    s = np.full((4, 4), mismatch, np.int32)
    np.fill_diagonal(s, match)
    return s


def embed_sentinels(S: np.ndarray) -> np.ndarray:
    """(A, A) -> (A+3, A+3) table indexed by code+3; sentinel rows/cols get
    NEG_SUB so padding never aligns."""
    A = S.shape[0]
    out = np.full((A + 3, A + 3), NEG_SUB, np.int32)
    out[3:, 3:] = S
    return out


def check_table(S) -> np.ndarray:
    """A substitution table as a square (A, A) int32 array; raises
    ValueError for a table that is not square, not integer, or holds a
    score beyond +-MAX_ABS_SCORE."""
    t = np.asarray(S)
    if t.ndim != 2 or t.shape[0] != t.shape[1] or t.shape[0] < 1:
        raise ValueError(f"substitution table must be square (A, A), "
                         f"got shape {t.shape}")
    if not np.issubdtype(t.dtype, np.integer):
        raise ValueError(f"substitution table must be integer, got {t.dtype}")
    if np.abs(t.astype(np.int64)).max() > MAX_ABS_SCORE:
        raise ValueError(f"substitution scores must lie within "
                         f"+-{MAX_ABS_SCORE}")
    return np.ascontiguousarray(t, dtype=np.int32)
