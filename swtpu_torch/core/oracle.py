"""Golden NumPy oracle — the semantic reference for every device path.

Faithful re-implementation (not a copy) of the reference's serial semantics:

* fill loop ``serial_smithW.c:141-145`` with ``similarityScore``
  ``serial_smithW.c:187-244``;
* tie order: DIAGONAL beats UP beats LEFT beats staying at 0/NONE — the strict
  ``>`` comparison chain at ``serial_smithW.c:221-233``;
* ``maxPos`` keeps the *first* row-major occurrence of the global max (strict
  ``>`` update, ``serial_smithW.c:240``);
* padded ``(n+1) x (m+1)`` matrices with a zero first row/column
  (``calloc``, ``serial_smithW.c:97,103``); ``a`` has length m (columns),
  ``b`` length n (rows);
* traceback negates P along the path and stops at the first NONE predecessor
  (``serial_smithW.c:262-277``).

Two fill implementations are provided: a cell-by-cell port of the exact
semantics (``fill_loop``, authoritative, slow) and a vectorized anti-diagonal
sweep (``fill``, fast, used as the practical oracle), linear and affine.
They are tested equal.

This module is framework-free numpy with the semantics of
``swtpu.core.oracle``; the port keeps its own copy so that it never imports
the JAX package. Where the JAX oracle's ``fill`` loops cell by cell in
affine mode, this one sweeps anti-diagonals there too, so the sanitizer can
hold a card's capture to it at 4096^2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .config import DIAGONAL, E_EXT, F_EXT, LEFT, NONE, UP, Scoring
from .encode import unknown_letter


@dataclasses.dataclass
class OracleResult:
    H: np.ndarray            # (n+1, m+1) int32 scores
    P: np.ndarray            # (n+1, m+1) int8 predecessors (NONE/UP/LEFT/DIAGONAL)
    max_pos: int             # row-major index of first global max (reference maxPos)
    max_score: int
    # affine mode extras (None for linear)
    E: Optional[np.ndarray] = None
    F: Optional[np.ndarray] = None

    @property
    def max_ij(self) -> tuple[int, int]:
        m1 = self.H.shape[1]
        return divmod(self.max_pos, m1)


def _sub_matrix(a: np.ndarray, b: np.ndarray, scoring: Scoring,
                sub=None) -> np.ndarray:
    """(n, m) substitution scores: s[i, j] = score(b[i], a[j])."""
    if sub is not None:
        return np.asarray(sub, np.int32)[a[None, :], b[:, None]]
    return np.where(
        b[:, None] == a[None, :], scoring.match, scoring.mismatch
    ).astype(np.int32)


def fill_loop(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
              sub=None) -> OracleResult:
    """Cell-by-cell fill with the reference's exact comparison order.
    ``sub``: optional (A, A) substitution matrix S[a_code, b_code] replacing
    the match/mismatch compare (protein/BLOSUM extension)."""
    m, n = len(a), len(b)
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    P = np.zeros((n + 1, m + 1), dtype=np.int8)
    if scoring.is_affine:
        return _fill_loop_affine(a, b, scoring, H, P, sub)
    max_pos = 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if sub is not None:
                s = int(sub[a[j - 1], b[i - 1]])
            else:
                s = scoring.match if a[j - 1] == b[i - 1] else scoring.mismatch
            diag = H[i - 1, j - 1] + s
            up = H[i - 1, j] + scoring.gap
            left = H[i, j - 1] + scoring.gap
            best, pred = 0, NONE
            if diag > best:
                best, pred = diag, DIAGONAL
            if up > best:
                best, pred = up, UP
            if left > best:
                best, pred = left, LEFT
            H[i, j] = best
            P[i, j] = pred
            if best > H.flat[max_pos]:
                max_pos = i * (m + 1) + j
    return OracleResult(H, P, max_pos, int(H.flat[max_pos]))


def _fill_loop_affine(a, b, scoring, H, P, sub=None) -> OracleResult:
    """Gotoh affine-gap fill (capability extension; no reference analog —
    the reference is linear-gap only, serial_smithW.c:61)."""
    m, n = len(a), len(b)
    NEG = np.int32(-(1 << 30))
    E = np.full((n + 1, m + 1), NEG, dtype=np.int32)  # gap in b (LEFT moves)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int32)  # gap in a (UP moves)
    E[0, :] = 0
    F[:, 0] = 0
    max_pos = 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if sub is not None:
                s = int(sub[a[j - 1], b[i - 1]])
            else:
                s = scoring.match if a[j - 1] == b[i - 1] else scoring.mismatch
            E[i, j] = max(H[i, j - 1] + scoring.gap_open,
                          E[i, j - 1] + scoring.gap_extend)
            F[i, j] = max(H[i - 1, j] + scoring.gap_open,
                          F[i - 1, j] + scoring.gap_extend)
            diag = H[i - 1, j - 1] + s
            best, pred = 0, NONE
            if diag > best:
                best, pred = diag, DIAGONAL
            if F[i, j] > best:
                best, pred = F[i, j], UP
            if E[i, j] > best:
                best, pred = E[i, j], LEFT
            H[i, j] = best
            # Gotoh state bits for exact affine traceback: did E/F at this
            # cell come from a gap EXTENSION (ties prefer extension)? An
            # H-level P alone cannot encode gap-run structure; a walk using
            # only it can return a sub-optimal alignment string.
            e_ext = E[i, j] == E[i, j - 1] + scoring.gap_extend
            f_ext = F[i, j] == F[i - 1, j] + scoring.gap_extend
            P[i, j] = pred | (E_EXT if e_ext else 0) | (F_EXT if f_ext else 0)
            if best > H.flat[max_pos]:
                max_pos = i * (m + 1) + j
    return OracleResult(H, P, max_pos, int(H.flat[max_pos]), E=E, F=F)


def fill(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
         sub=None) -> OracleResult:
    """Vectorized anti-diagonal fill, semantically identical to fill_loop.

    The wavefront decomposition mirrors the reference's nDiag loop
    (omp_smithW.c:203-217): cells on one anti-diagonal are independent.
    Tie-break and first-max-wins semantics are reproduced with vectorized
    selects; maxPos falls out of np.argmax's first-occurrence-in-C-order rule,
    which equals the reference's strict-``>`` running update.
    """
    if scoring.is_affine:
        return _fill_affine(a, b, scoring, sub)
    m, n = len(a), len(b)
    sub = _sub_matrix(a, b, scoring, sub)
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    P = np.zeros((n + 1, m + 1), dtype=np.int8)
    gap = np.int32(scoring.gap)
    for d in range(2, n + m + 1):          # anti-diagonal: i + j == d
        i_lo = max(1, d - m)
        i_hi = min(n, d - 1)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = d - ii
        diag = H[ii - 1, jj - 1] + sub[ii - 1, jj - 1]
        up = H[ii - 1, jj] + gap
        left = H[ii, jj - 1] + gap
        best = np.zeros_like(diag)
        pred = np.zeros(diag.shape, dtype=np.int8)
        take = diag > best
        best = np.where(take, diag, best)
        pred = np.where(take, DIAGONAL, pred).astype(np.int8)
        take = up > best
        best = np.where(take, up, best)
        pred = np.where(take, UP, pred).astype(np.int8)
        take = left > best
        best = np.where(take, left, best)
        pred = np.where(take, LEFT, pred).astype(np.int8)
        H[ii, jj] = best
        P[ii, jj] = pred
    max_pos = int(np.argmax(H))
    return OracleResult(H, P, max_pos, int(H.flat[max_pos]))


def _fill_affine(a: np.ndarray, b: np.ndarray, scoring: Scoring,
                 sub=None) -> OracleResult:
    """Vectorized anti-diagonal Gotoh fill, semantically identical to
    ``_fill_loop_affine``: E(i, j) and F(i, j) read the previous
    anti-diagonal and DIAG the one before it, so the cells of one
    anti-diagonal are independent."""
    m, n = len(a), len(b)
    s = _sub_matrix(a, b, scoring, sub)
    NEG = np.int32(-(1 << 30))
    g_open, g_ext = np.int32(scoring.gap_open), np.int32(scoring.gap_extend)
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    P = np.zeros((n + 1, m + 1), dtype=np.int8)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int32)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int32)
    E[0, :] = 0
    F[:, 0] = 0
    for d in range(2, n + m + 1):          # anti-diagonal: i + j == d
        ii = np.arange(max(1, d - m), min(n, d - 1) + 1)
        jj = d - ii
        e_prev, f_prev = E[ii, jj - 1], F[ii - 1, jj]
        e = np.maximum(H[ii, jj - 1] + g_open, e_prev + g_ext)
        f = np.maximum(H[ii - 1, jj] + g_open, f_prev + g_ext)
        diag = H[ii - 1, jj - 1] + s[ii - 1, jj - 1]
        best = np.zeros_like(diag)
        pred = np.zeros(diag.shape, dtype=np.int8)
        for cand, code in ((diag, DIAGONAL), (f, UP), (e, LEFT)):
            take = cand > best
            best = np.where(take, cand, best)
            pred = np.where(take, code, pred).astype(np.int8)
        pred |= np.where(e == e_prev + g_ext, E_EXT, 0).astype(np.int8)
        pred |= np.where(f == f_prev + g_ext, F_EXT, 0).astype(np.int8)
        H[ii, jj], P[ii, jj], E[ii, jj], F[ii, jj] = best, pred, e, f
    max_pos = int(np.argmax(H))
    return OracleResult(H, P, max_pos, int(H.flat[max_pos]), E=E, F=F)


def backtrack(P: np.ndarray, max_pos: int) -> list[int]:
    """Walk predecessors from max_pos to the first NONE cell; returns the
    row-major path indices (max_pos first). Mirrors serial_smithW.c:262-277
    including the do-while structure (max_pos itself is always on the path).
    Affine P (with E_EXT/F_EXT state bits) walks the exact Gotoh state
    machine: an UP/LEFT move enters the F/E state and stays there while the
    extension bit says the gap run continues."""
    m1 = P.shape[1]
    flat = P.reshape(-1)
    path = []
    pos = max_pos
    state = 0                      # 0 = H, UP = in F run, LEFT = in E run
    while True:
        path.append(pos)
        code = int(flat[pos])
        base = code & 3
        if state == UP:
            pred = pos - m1
            state = 0 if not (code & F_EXT) else UP
        elif state == LEFT:
            pred = pos - 1
            state = 0 if not (code & E_EXT) else LEFT
        elif base == DIAGONAL:
            pred = pos - m1 - 1
        elif base == UP:
            pred = pos - m1
            state = 0 if not (code & F_EXT) else UP
        elif base == LEFT:
            pred = pos - 1
            state = 0 if not (code & E_EXT) else LEFT
        else:  # NONE at the start cell: reference would stop before marking
            break
        if state == 0 and (flat[pred] & 3) == NONE:
            break
        pos = pred
    return path


def mark_path(P: np.ndarray, max_pos: int) -> np.ndarray:
    """Return a copy of P with path cells negated — the reference's in-place
    P[pos] *= PATH marking (serial_smithW.c:274), kept pure here."""
    out = P.copy()
    flat = out.reshape(-1)
    for pos in backtrack(P, max_pos):
        flat[pos] = -flat[pos]
    return out


def alignment_strings(
    a: np.ndarray, b: np.ndarray, P: np.ndarray, max_pos: int,
    alphabet: str = "ACGT",
) -> tuple[str, str]:
    """Reconstruct the aligned subsequences (with '-' gaps) from the path;
    a negative code (an unknown base) renders as 'N', or 'X' for an
    alphabet that carries one.

    The reference only marks the path for printing (printPredecessorMatrix,
    serial_smithW.c:298-328); emitting the actual alignment strings is a
    usability extension.
    """
    m1 = P.shape[1]
    unk = unknown_letter(alphabet)

    def letter(code) -> str:
        # a negative code renders as ``encode.decode`` renders it
        return alphabet[code] if code >= 0 else unk

    out_a, out_b = [], []
    flat = P.reshape(-1)
    pos = max_pos
    state = 0
    while True:
        i, j = divmod(pos, m1)
        code = int(flat[pos])
        base = code & 3
        move = state if state else base
        if move == DIAGONAL:
            out_a.append(letter(a[j - 1]))
            out_b.append(letter(b[i - 1]))
            pred = pos - m1 - 1
        elif move == UP:
            out_a.append("-")
            out_b.append(letter(b[i - 1]))
            pred = pos - m1
            state = UP if (code & F_EXT) else 0
        elif move == LEFT:
            out_a.append(letter(a[j - 1]))
            out_b.append("-")
            pred = pos - 1
            state = LEFT if (code & E_EXT) else 0
        else:
            break
        if state == 0 and (flat[pred] & 3) == NONE:
            break
        pos = pred
    return "".join(reversed(out_a)), "".join(reversed(out_b))
