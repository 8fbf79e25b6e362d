"""The native host tiers: numpy in, numpy out, over ``csrc/swtpu_native.cpp``.

Counterpart of ``swtpu.runtime_native`` for what the port's dispatch
needs: the serial fill ``fill`` (the ``host`` tier of ``align()``), the
walk of P ``traceback``, and the striped SIMD score-only fills
``score_simd``, ``score_simd_pos`` (the ``host-simd`` tier of score-only
``align()``/``score()``), ``score_simd_batch`` (``batch_score(plan=
'host-simd')``) and ``score_simd_window`` (``search(plan='host-simd')``),
with their gates ``simd_shape_ok``, ``simd_eligible`` and
``simd_reject_reason``, the per-core rate probe ``measured_simd_gcups``
(a printed check beside the measured crossovers; no route reads it),
``omp_threads``, the threads of the batch scorers' OpenMP regions, and
``reference_random``, glibc's ``rand()`` stream as a reference C binary's
generator maps it (``core.encode.GlibcRand``'s twin).

The library is built with g++ for this host at first use
(``kernels._native``), never at import; a failed build raises, and no
NumPy version stands in for it. There is no ``alignment_strings``: the
host tier renders strings with ``core.oracle.alignment_strings``, which
renders an unknown base as 'N' ('X'), where the JAX package's native
strings render it as a gap.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

import numpy as np

from .core.config import Scoring
from .core.oracle import OracleResult
from .kernels import _native

# int16 saturation guard of the SIMD tier: the largest reachable score
# (max positive table entry times the shorter side) stays clear of 32767,
# where the saturating adds would under-report instead of overflowing
SIMD_SCORE_CAP = 32000
# positions ride the int16 lanes
SIMD_MAX_LEN = 32767
# what the C entries return for an unsupported build (no AVX2) or a
# refused scoring
_REFUSED = -(1 << 31)

_simd_probe: dict = {"ok": None}
_simd_rate: dict = {"gcups": None}


def available() -> bool:
    """Does the host library build and load here?"""
    try:
        _native.library()
    except RuntimeError:
        return False
    return True


def omp_threads() -> int:
    """The threads the batch and window scorers' OpenMP regions use (1 in
    a build without OpenMP). Builds the library on first use."""
    return int(_native.library().sw_omp_max_threads())


def reference_random(length: int, seed: int = 1) -> np.ndarray:
    """The int8 ACGT codes a reference binary's generate() makes from
    glibc's ``rand()`` seeded with ``seed`` (its serial generator never
    seeds: 1; 0 is taken as 1, as glibc takes it), equal to
    ``GlibcRand(seed).reference_sequence(length)``. Builds the library on
    first use; a failed build raises."""
    if length < 0:
        raise ValueError(f"length must be >= 0, got {length}")
    out = np.empty(length, np.int8)
    _native.library().sw_reference_random(seed & 0xFFFFFFFF, length, out)
    return out


def _model(scoring: Scoring, sub) -> tuple:
    """(affine, match, mismatch, gap_open, gap_extend, sub_ptr, nsym,
    keepalive) of the C entries; linear mode reads its gap from
    gap_open. nsym is 4 (the DNA codes) without a table."""
    keep, ptr, nsym = None, None, 4
    if sub is not None:
        keep = np.ascontiguousarray(sub, np.int32)
        if keep.ndim != 2 or keep.shape[0] != keep.shape[1]:
            raise ValueError(f"substitution must be a square table, got "
                             f"{keep.shape}")
        nsym = keep.shape[0]
        ptr = keep.ctypes.data_as(ctypes.c_void_p)
    if scoring.is_affine:
        gaps = (int(scoring.gap_open), int(scoring.gap_extend))
    else:
        gaps = (int(scoring.gap), 0)
    return (int(scoring.is_affine), int(scoring.match),
            int(scoring.mismatch), *gaps, ptr, nsym, keep)


def fill(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
         sub=None) -> OracleResult:
    """The native serial fill of a (m,) against b (n,): H, P (with the
    affine E_EXT/F_EXT bits), the first row-major max and its score, equal
    to ``core.oracle.fill``. With ``sub`` every code must lie in [0, A)
    (ValueError otherwise); without, any int8 code compares raw."""
    a = np.ascontiguousarray(a, np.int8)
    b = np.ascontiguousarray(b, np.int8)
    m, n = len(a), len(b)
    *model, keep = _model(scoring, sub)
    if sub is not None and m and n:
        nsym = model[-1]
        if min(a.min(), b.min()) < 0 or max(a.max(), b.max()) >= nsym:
            raise ValueError(f"the native fill with a table needs codes in "
                             f"[0, {nsym})")
    H = np.empty((n + 1, m + 1), np.int32)
    P = np.empty((n + 1, m + 1), np.int8)
    maxpos = ctypes.c_long(0)
    score = _native.library().sw_fill(a, b, m, n, *model, H, P,
                                      ctypes.byref(maxpos))
    del keep
    return OracleResult(H, P, int(maxpos.value), int(score))


def traceback(P: np.ndarray, max_pos: int) -> list[int]:
    """The native walk of a linear P from max_pos: row-major indices,
    end-first, equal to ``core.oracle.backtrack``. Raises ValueError on a
    malformed P."""
    P = np.ascontiguousarray(P, np.int8)
    n1, m1 = P.shape
    path = np.empty(n1 + m1 + 2, np.int64)
    ln = _native.library().sw_traceback(P, n1, m1, max_pos, path, len(path))
    if ln < 0:
        raise ValueError("malformed predecessor matrix")
    return path[:ln].tolist()


def _table_range(scoring: Scoring, sub) -> tuple:
    """(hi, lo, go, ge): the largest positive score (at least 1), the most
    negative one (at most 0), and the gap open and extend costs."""
    if sub is not None:
        sub32 = np.asarray(sub, np.int32)
        hi, lo = max(int(sub32.max()), 1), min(int(sub32.min()), 0)
    else:
        hi, lo = max(int(scoring.match), 1), min(int(scoring.mismatch), 0)
    if scoring.is_affine:
        go, ge = int(scoring.gap_open), int(scoring.gap_extend)
    else:
        go = ge = int(scoring.gap)
    return hi, lo, go, ge


def simd_shape_ok(m: int, n: int, scoring: Optional[Scoring] = None,
                  sub=None) -> bool:
    """The arithmetic half of ``simd_eligible``, with no library load:
    1 <= m, n <= 32767 (positions ride int16 lanes), the largest reachable
    score hi * min(m, n) within SIMD_SCORE_CAP, negative gaps with
    gap_extend >= gap_open (the lazy-F loop only extends a propagated
    gap), and every penalty within the cap."""
    scoring = Scoring() if scoring is None else scoring
    if not (1 <= m <= SIMD_MAX_LEN and 1 <= n <= SIMD_MAX_LEN):
        return False
    hi, lo, go, ge = _table_range(scoring, sub)
    return (hi * min(m, n) <= SIMD_SCORE_CAP and go < 0 and ge < 0
            and ge >= go and min(lo, go, ge) >= -SIMD_SCORE_CAP)


def simd_supported() -> bool:
    """Was the library built with the SIMD fills? A build without AVX2
    compiles them to a stub that returns INT32_MIN; one probe call a
    process reads that. Builds the library on first use."""
    if _simd_probe["ok"] is None:
        z = np.zeros(4, np.int8)
        _simd_probe["ok"] = _native.library().sw_score_simd(
            z, z, 4, 4, 0, 3, -3, -2, 0, None, 4) != _REFUSED
    return _simd_probe["ok"]


def simd_eligible(m: int, n: int, scoring: Optional[Scoring] = None,
                  sub=None) -> bool:
    """The full gate of the SIMD fills, with no data: ``simd_shape_ok``
    and a library built with them."""
    return simd_shape_ok(m, n, scoring, sub) and simd_supported()


def simd_reject_reason(m: int, n: int, scoring: Optional[Scoring] = None,
                       sub=None) -> str:
    """Why the SIMD tier refuses this problem, for the error a forced
    ``plan='host-simd'`` raises. Builds the library on first use."""
    scoring = Scoring() if scoring is None else scoring
    if not simd_supported():
        return "host library built without AVX2 SIMD support"
    if m <= 0 or n <= 0:
        return f"empty operand (m={m}, n={n})"
    if m > SIMD_MAX_LEN or n > SIMD_MAX_LEN:
        return (f"positions ride int16 lanes: m={m}, n={n} exceed "
                f"{SIMD_MAX_LEN}")
    hi, lo, go, ge = _table_range(scoring, sub)
    if hi * min(m, n) > SIMD_SCORE_CAP:
        return (f"max reachable score {hi}*{min(m, n)} exceeds the int16 "
                f"saturation cap {SIMD_SCORE_CAP}")
    if not (go < 0 and ge < 0):
        return f"gap costs must be negative (gap_open={go}, gap_extend={ge})"
    if ge < go:
        return (f"gap_extend ({ge}) more negative than gap_open ({go}): "
                "the lazy-F loop only extends propagated gaps")
    if min(lo, go, ge) < -SIMD_SCORE_CAP:
        return f"a penalty exceeds the int16 cap {-SIMD_SCORE_CAP}"
    return "input codes outside the kernel's [-3, nsym) range"


def _codes_ok(codes: np.ndarray, nsym: int) -> bool:
    """Codes that select a profile row: [-3, nsym). The sentinels -3..-1
    score as the oracle scores them; the other operand's codes are free."""
    return int(codes.min()) >= -3 and int(codes.max()) < nsym


def score_simd(a: np.ndarray, b: np.ndarray,
               scoring: Optional[Scoring] = None, sub=None) -> Optional[int]:
    """The striped SIMD score-only fill: the max score, or None where the
    tier refuses the problem (``simd_eligible``, a-codes outside [-3,
    A))."""
    scoring = Scoring() if scoring is None else scoring
    a = np.ascontiguousarray(a, np.int8)
    b = np.ascontiguousarray(b, np.int8)
    if len(a) == 0 or len(b) == 0:
        return 0
    if not simd_eligible(len(a), len(b), scoring, sub):
        return None
    *model, keep = _model(scoring, sub)
    if not _codes_ok(a, model[-1]):
        return None
    got = _native.library().sw_score_simd(a, b, len(a), len(b), *model)
    del keep
    return None if got == _REFUSED else int(got)


def score_simd_pos(a: np.ndarray, b: np.ndarray,
                   scoring: Optional[Scoring] = None, sub=None):
    """The striped SIMD fill with the first row-major max and the last
    cell: (score, max_i, max_j, last_cell), 1-based padded coordinates
    (0, 0 when the score is 0), equal to the oracle's; or None where the
    tier refuses the problem."""
    scoring = Scoring() if scoring is None else scoring
    a = np.ascontiguousarray(a, np.int8)
    b = np.ascontiguousarray(b, np.int8)
    m, n = len(a), len(b)
    if not simd_eligible(m, n, scoring, sub):
        return None
    *model, keep = _model(scoring, sub)
    if not _codes_ok(a, model[-1]):
        return None
    oi, oj, ol = ctypes.c_int32(0), ctypes.c_int32(0), ctypes.c_int32(0)
    got = _native.library().sw_score_simd_pos(
        a, b, m, n, *model, ctypes.byref(oi), ctypes.byref(oj),
        ctypes.byref(ol))
    del keep
    if got == _REFUSED:
        return None
    return int(got), int(oi.value), int(oj.value), int(ol.value)


def _batch_out(B: int) -> tuple:
    return (np.empty(B, np.int32), np.empty(B, np.int32),
            np.empty(B, np.int32))


def score_simd_batch(a_batch: np.ndarray, b_batch: np.ndarray,
                     scoring: Optional[Scoring] = None, sub=None):
    """B pairs of one shape, a (B, m) against b (B, n), through the SIMD
    fill (OpenMP across the pairs): (scores, max_i, max_j) int32 (B,)
    arrays equal to the oracle's, or None where the tier refuses the
    problem."""
    scoring = Scoring() if scoring is None else scoring
    a_batch = np.ascontiguousarray(a_batch, np.int8)
    b_batch = np.ascontiguousarray(b_batch, np.int8)
    B, m = a_batch.shape
    n = b_batch.shape[1]
    if B == 0 or not simd_eligible(m, n, scoring, sub):
        return None
    *model, keep = _model(scoring, sub)
    if not _codes_ok(a_batch, model[-1]):
        return None
    out = _batch_out(B)
    _native.library().sw_score_simd_batch(
        a_batch.reshape(-1), b_batch.reshape(-1), B, m, n, *model, *out)
    del keep
    if (out[0] == _REFUSED).any():
        return None
    return out


def score_simd_window(window: np.ndarray, reads: np.ndarray,
                      scoring: Optional[Scoring] = None, sub=None):
    """B reads (B, n) against one shared window (m,), the searcher's
    shape (inter-sequence groups of one read a lane for B >= 4 and n <=
    8192, else the striped fill a read; OpenMP across them): (scores,
    read_i, win_j) int32 (B,) arrays equal to the oracle's, or None where
    the tier refuses the problem. The reads may carry the -3 padding and
    -1 unknown sentinels; the window's codes must lie in [-3, A)."""
    scoring = Scoring() if scoring is None else scoring
    window = np.ascontiguousarray(window, np.int8)
    reads = np.ascontiguousarray(reads, np.int8)
    B, n = reads.shape
    m = len(window)
    if B == 0 or not simd_eligible(m, n, scoring, sub):
        return None
    *model, keep = _model(scoring, sub)
    if not _codes_ok(window, model[-1]):
        return None
    out = _batch_out(B)
    _native.library().sw_score_simd_batch1(window, reads.reshape(-1), B, m,
                                           n, *model, *out)
    del keep
    if (out[0] == _REFUSED).any():
        return None
    return out


def measured_simd_gcups(m: int = 1056, n: int = 1056,
                        repeats: int = 5) -> Optional[float]:
    """This host's one-core rate of the SIMD fill in GCUPS: the fastest of
    ``repeats`` score-only fills of a seeded m x n DNA pair, measured once
    a process. None where the library has no SIMD fills."""
    if _simd_rate["gcups"] is None:
        if not simd_supported():
            return None
        rng = np.random.default_rng(0)
        a = rng.integers(0, 4, m).astype(np.int8)
        b = rng.integers(0, 4, n).astype(np.int8)
        score_simd(a, b)                                  # warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            score_simd(a, b)
            best = min(best, time.perf_counter() - t0)
        _simd_rate["gcups"] = m * n / best / 1e9
    return _simd_rate["gcups"]
