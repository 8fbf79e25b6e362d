#!/usr/bin/env python3
"""Smoke run of the swtpu_torch main path on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Builds the CUDA kernels from ``swtpu_torch/csrc``, holds each against its
plain PyTorch version on the card, then drives the public ``align()`` and
``score()`` at the benchmark sizes, in three scorings (DNA linear 3/-3/-2,
DNA affine 3/-3 -4/-1, BLOSUM62 protein affine -11/-1), and checks the
answers against independent numpy row scans and the known values for those
seeded pairs. Five paths are driven, each with the launch counts set to 0
just before it and read just after: the full-P path (score 25632^2, align
16384^2), the lean and banded path (align 25632^2 through locate +
windowed refill + the device walk, Hirschberg at 16384^2 linear and
4096^2 affine, banded score and align at 16384^2), the batch path
(``batch_score`` on 64 pairs of 1056^2 through each plan and banded, and
on 64 pairs of 1000^2, ``batch_align`` on the first, ``score_many`` and
``align_many`` on 16 mixed pairs of 14500-16300), and the search path
(``search`` of 2048 reads of 152 against a 1 Mb reference in each scoring,
``align_hits`` of the best 512 hits, ``map_reads`` single-end on 2048
reads of 150 and paired-end on 1024 pairs against the reference as two
records, and ``python -m swtpu_torch map`` on 256 of those reads; long
reads, K6 above 512 rows: ``search`` of 64 reads of 5000 planted in the
reference, linear and DNA affine, and of 256 protein queries of 600 at a
cut, ``align_hits`` of the best 4), and the sanitize path
(``swtpu_torch.sanitize`` at 4096^2 and ``sanitize_pairs_packed`` on 16
pairs of 1056^2, every cell of the K9
capture checked against the numpy oracle, and ``python -m swtpu_torch
4096 4096 --skip-backtrack --sanitize``), and the tools path
(``swtpu_torch.bench_sweep``'s quick square and rectangular grids, each
score against the host serial fill; ``instrument.profiling``'s
spans of the stripe call at 64^2 and 25632^2 and a ``trace()``
that must name ``sw_stripe_rb_linear``, its score the host serial fill's;
``instrument.access``'s ``validate_model`` at 4096^2 in each scoring
against the allocator, ptxas and the launcher, each plan's answer the
plain sweep's; ``examples/torch_*.py`` on the card, at a cut size equal to their
CPU runs; ``scripts/torch_map_warm.py``; ``reference_random`` against
``GlibcRand``). Two more paths run the
multi-device layer (``swtpu_torch.dist``): mesh1, a world-1 NCCL mesh in
this process (``align(mesh=, plan='pipeline')`` score-only at 65536^2
linear and 16384^2 DNA affine and protein, with traceback at 16384^2, and
``batch_score(mesh=, plan='pipeline')`` on 4 pairs of 4096^2, each equal
to the single-card answer, K5's launches equal to the blocks each pass
fills; before it K5 at every stage of a 2048^2 pipeline against the plain
block fill, after it the block_rows x T sweep at 65536^2), and mesh4, four
gloo ranks spawned on the one card (the pipeline at 16384^2 and the batch
pipeline, the sharded scorer and best-hit reducer on 64 x 1056^2,
``search(mesh=)`` of the 1 Mb search with n_best 1 and 2, ``map_reads(mesh=)``
on ``examples/read_mapping.py``'s set), against the world-1 answers,
``batch_score``, the single-card search of each shard merged on the host,
the unsharded search and single-card ``map_reads``. The pipeline_model
phase then loads the committed pipeline cost record
(``swtpu_torch/dispatch/pipe_h100.json``, which must be this card's),
holds its predictions against the times the paths took (``score()`` at
25632^2 in each scoring, the world-1 sweep at 65536^2 at K5's default T),
each within 1.25x, and prints the projected speedups and block rows at
65536^2, 2^19^2 and 2^20^2 on 2, 4 and 8 cards; it launches nothing.
Fourteen kernels
have a second,
earlier design beside them: unbanded score-only runs the register-blocked
K1, K2 and K3 (``csrc/stripe_rb.cu``), unbanded P capture its K4
(``csrc/stripe_rb_p.cu``, a row's codes of a tile stored as words), every
block fill its K5 (``csrc/stripe_rb_block.cu``), a band its band form
(K4b, ``csrc/stripe_rb_band.cu``, each stripe visiting only the columns
its rows' band reaches), the sanitizer its capture form (K9,
``csrc/stripe_rb_debug.cu``, the tile score() runs), an unbanded batch
its batch form (K8, ``csrc/stripe_rb_pairs.cu``), a banded batch its
batch form with the band (K8[band], ``csrc/stripe_rb_pairs_band.cu``),
the lean walk the tile-staged walk (``sw_walk_p_tiled``,
``csrc/walk_p.cu``), and the search's window scorer the warp-per-read K6
(``csrc/window_warp.cu``) for reads of up to 512 rows and the batch form
with one shared window (``csrc/stripe_rb_window.cu``) above,
``plan='packed'`` its packed form (K7, ``csrc/stripe_rb_packed.cu``,
every stripe starting at a pair's first row) and
``sanitize_pairs_packed`` that form's capture (the packed K9,
``csrc/stripe_rb_packed_debug.cu``); the earlier K1-K8, K4b, K8[band] and
K9 (single-pair and packed), the stripe template's, and the one-thread
walk ``sw_walk_p`` are held to their plain versions and timed in turns
with the new ones in the same run (they launch on no path; the template's
packed K9 held to its plain version on 4 of the 16 pairs), K4 and K4b
into guarded buffers (no byte off P written), and K1-K5, K4b, K7, K8,
K8[band] and K6 above 512 rows are swept over their (T, R, C).
K4b is also timed against the template's at 4 x the path's n,
score-only. Each
phase prints one line; any failure raises, so the exit code is not 0. The
line before the last is a JSON object describing each kernel of the paths
(launches in the paths' runs, exactness, kernel and plain times, and the
least time the card could take for the same work); the last line is a
JSON object naming the device.

Without a CUDA device it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import swtpu_torch
from swtpu_torch import EngineConfig, Scoring, random_batch, random_pair
from swtpu_torch.core.encode import (DNA_ALPHABET, PROTEIN_ALPHABET, decode,
                                     revcomp)
from swtpu_torch.core.substitution import BLOSUM62
from swtpu_torch.dispatch import cost
from swtpu_torch.dispatch import plan as dp
from swtpu_torch.dist import database as db
from swtpu_torch.dist import batch as tbatch
from swtpu_torch.dist import dryrun
from swtpu_torch.dist import mesh as msh
from swtpu_torch.dist import pipeline as pl
from swtpu_torch.dist.batch import (make_best_hit_reducer,
                                    make_sharded_batch_scorer)
from swtpu_torch.engine import traceback as tb
from swtpu_torch.instrument import sanitize as san
from swtpu_torch.instrument.metrics import gcups
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import debug_fill as df
from swtpu_torch.kernels import pack_rows as pk
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf
from swtpu_torch.kernels import window_fill as wf

SCORING = Scoring()               # linear 3/-3/-2, the benchmark's scoring
DNA_AFFINE = Scoring(mode="affine")                     # 3/-3, -4/-1
PROTEIN = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
PROTEIN_LINEAR = Scoring(gap=-6)
SCORE_N = 25632                   # the benchmark pair, score-only
ALIGN_N = 16384                   # full-P traceback: exactly 2^28 cells
THIN = (25632, 8192)              # score() swaps this pair (m > 2n)
# (max, i, j, last) of the seed-0 pairs: random_pair(m, n, seed=0) for DNA,
# protein_pair(n) for BLOSUM62
KNOWN = {("linear", SCORE_N, SCORE_N): (18276, 25632, 25624, 18273),
         ("linear", ALIGN_N, ALIGN_N): (11743, 16369, 16384, 11723),
         ("linear", *THIN): (6376, 8191, 25455, 6300),
         ("dna_affine", SCORE_N, SCORE_N): (12335, 25535, 25630, 12311),
         ("dna_affine", ALIGN_N, ALIGN_N): (7783, 16369, 16384, 7773),
         ("protein", SCORE_N, SCORE_N): (94, 24948, 18296, 2),
         ("protein", ALIGN_N, ALIGN_N): (77, 8114, 8809, 0)}
HIRSCH_AFFINE_N = 4096           # Myers-Miller: its host base case is slow
BAND = 64                         # the banded path's half-width
NEG = -(1 << 30)
CSRC = "swtpu_torch/csrc/"
# (source, TPU code replaced) of each kind of C entry
ORIGIN = {
    "stripe": (CSRC + "stripe_fill.cu",
               "swtpu/kernels/pallas_fill.py:1008"),   # _stripe_call
    "band": (CSRC + "stripe_fill.cu",
             "swtpu/kernels/pallas_fill.py:358"),      # _kernel band mode
    "block": (CSRC + "stripe_block.cu",
              "swtpu/kernels/pallas_fill.py:1466"),    # stripe_block_fn
    "walk": (CSRC + "walk_p.cu",
             "swtpu/engine/traceback.py:561"),         # the jitted walk
    "pairs": (CSRC + "pairs_fill.cu",
              "swtpu/kernels/pallas_fill.py:1962"),    # pairs_score_fn
    "packed": (CSRC + "pairs_fill.cu",
               "swtpu/kernels/pallas_fill.py:1730"),   # pairs_packed_score_fn
    "window": (CSRC + "window_fill.cu",
               "swtpu/kernels/pallas_fill.py:1608"),   # batch_score_fn
    "sanitize": (CSRC + "sanitize_fill.cu",
                 "swtpu/kernels/pallas_fill.py:597"),  # _kernel's debug_h
    "warp": (CSRC + "window_warp.cu",
             "swtpu/kernels/pallas_fill.py:1608"),     # batch_score_fn
    "rb": (CSRC + "stripe_rb.cu",
           "swtpu/kernels/pallas_fill.py:1249"),       # stripe_score_fn
    "rb_gotoh": (CSRC + "stripe_rb.cu",
                 "swtpu/kernels/pallas_fill.py:1008"),  # _stripe_call
    "rb_p": (CSRC + "stripe_rb_p.cu",
             "swtpu/kernels/pallas_fill.py:1190"),     # stripe_fill, return_p
    "rb_block": (CSRC + "stripe_rb_block.cu",
                 "swtpu/kernels/pallas_fill.py:1466"),  # stripe_block_fn
    "rb_band": (CSRC + "stripe_rb_band.cu",
                "swtpu/kernels/pallas_fill.py:358"),   # _kernel band mode
    "rb_debug": (CSRC + "stripe_rb_debug.cu",
                 "swtpu/kernels/pallas_fill.py:597"),  # _kernel's debug_h
    "rb_pairs": (CSRC + "stripe_rb_pairs.cu",
                 "swtpu/kernels/pallas_fill.py:1962"),  # pairs_score_fn
    # the pair grid's band mode (_kernel :358); the JAX package scans
    # banded batches
    "rb_pairs_band": (CSRC + "stripe_rb_pairs_band.cu",
                      "swtpu/kernels/pallas_fill.py:1962"),
    "rb_window": (CSRC + "stripe_rb_window.cu",
                  "swtpu/kernels/pallas_fill.py:1608"),  # batch_score_fn
    "rb_packed": (CSRC + "stripe_rb_packed.cu",
                  "swtpu/kernels/pallas_fill.py:1730"),  # pairs_packed_score_fn
    # _kernel's debug_h on pairs_packed_score_fn's packing
    "rb_packed_debug": (CSRC + "stripe_rb_packed_debug.cu",
                        "swtpu/kernels/pallas_fill.py:597"),
    # score_many's buckets, padded on the host there
    "pack_rows": (CSRC + "pack_rows.cu", "swtpu/dist/batch.py:316"),
}
BATCH = (64, 1056)                # the JAX bench's bench_pairs_small batch
# a batch of the same size whose n no stripe height of K7 fits (no multiple
# of 32 up to 1024 divides 1000 or is a multiple of it): 'auto' runs K8
NO_FIT = (64, 1000)
# the 16 mixed mid-size pairs of the JAX package's score_many probe
# (scripts/tpu_round4.py amortize_probe): random_pair(m, n, seed=s), twice
MIXED = [(16000, 15000), (15000, 16000), (14500, 15500), (15500, 14500),
         (16300, 16300), (15000, 15000), (16000, 16000), (14500, 16300)]
# (label, B, m, n, T, kind) of the batch kernels' small shapes: the JAX
# batch tests' own ("ties": a motif planted twice), plus m = 1, B = 1, a
# ragged n (1100: the register-blocked K8's stripes of 1024 rows and 256
# rows both cut), pairs with no positive cell ("dark": the odd pairs of two
# disjoint letters) and sentinel codes in every pair
PAIR_SHAPES = [("6x40x300", 6, 40, 300, None, ""),
               ("45x40x5 T=32", 45, 40, 5, 32, ""),
               ("45x40x5 T=256", 45, 40, 5, 256, ""),
               ("ties 8x64x96", 8, 64, 96, None, "ties"),
               ("7x52x33", 7, 52, 33, None, ""),
               ("5x30x44", 5, 30, 44, None, ""),
               ("m=1 3x1x70", 3, 1, 70, 64, ""),
               ("B=1 1x60x90", 1, 60, 90, 32, ""),
               ("ragged 3x70x1100", 3, 70, 1100, None, ""),
               ("no positive cell 6x50x140", 6, 50, 140, 32, "dark"),
               ("sentinels 4x70x300", 4, 70, 300, 32, "sentinels")]
# the register-blocked K8's (T, R, C) at the small shapes beside the route's
# (in every form's tiles), and its sweep at 64 x 1056^2 and 64 x 1000^2,
# banded (K8[band]) at BAND too
PAIRS_RB_SHAPES = [(32, 4, 4), (64, 8, 2), (256, 8, 4)]
PAIRS_SWEEP = {mode: [(T, R, C) for T in (32, 64, 128, 256)
                      for R, C in sf.RB_FORM_TILES[mode]]
               for mode in sf.RB_FORM_TILES}
# K8[band]'s bands at the small shapes, and m + n + 5, past every cell
PAIRS_BANDS = (-1, 0, 1, 31, 32, 33, BAND)
# the stripe template's K8, K8[band] and K7, the earlier designs, on no path
EARLIER_PAIRS = (*pf.PAIRS_KERNELS.values(),
                 *(k + sf.BAND_SUFFIX for k in pf.PAIRS_KERNELS.values()),
                 *pf.PACKED_KERNELS.values())
# the packed K7's sweep at 64 x 1056^2: T x the form's tiles; T of 320 and
# 512 at R = 8 hold 2 and 3 pairs a stripe (q), the rest 1 or a pair
# across stripes
PACKED_SWEEP = {mode: [(T, R, C) for T in (64, 128, 160, 256, 320, 512)
                       for R, C in sf.RB_FORM_TILES[mode]]
                for mode in sf.RB_FORM_TILES}

# The least time the card could take (bound_ms): the larger of the int32
# operations over the card's int32 rate and the bytes over its memory rate.
# Memory: 3.35 TB/s (H100 SXM HBM3, NVIDIA's data sheet). int32: 64 results
# per clock per SM for 32-bit integer add, compare, min and max at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), times the SMs and the maximum SM clock this card reports.
MEM_BYTES_PER_S = 3.35e12
INT32_PER_CLOCK_PER_SM = 64
# int32 operations per cell, counted from the kernels' step: linear
# H = max(0, DIAG + s, UP + g, LEFT + g) is a compare and a select for s,
# three adds and three maxes, plus the argmax's compare (9); affine adds
# E and F (an add each to open, an add each to extend, a max each) in
# place of the two gap adds (13); a table lookup replaces the compare and
# select (protein, affine: 12). P capture adds the code's three selects
# (and, affine, the two extension tests); a band, its distance and compare.
OPS_PER_CELL = {"linear": 9, "dna_affine": 13, "protein": 12}
P_OPS = {"linear": 3, "dna_affine": 5, "protein": 5}
BAND_OPS = 2
WALK_OPS = 6              # per move: the P load's address, decode, state


def origin(name: str) -> tuple:
    kind = ("pack_rows" if name == pk.PACK_KERNEL
            else "rb_debug" if name.startswith("sw_sanitize_rb_")
            else "rb_packed_debug" if name.startswith("sw_sanitize_packed_rb_")
            else "rb_packed" if name.startswith("sw_packed_rb_")
            else "rb_pairs_band" if name.startswith("sw_pairs_rb_band_")
            else "rb_pairs" if name.startswith("sw_pairs_rb_")
            else "rb_window" if name.startswith("sw_window_rb_")
            else "sanitize" if name.startswith("sw_sanitize_")
            else "warp" if name.startswith("sw_window_warp_")
            else "rb" if name == sf.RB_KERNEL
            else "rb_gotoh" if name in sf.RB_KERNELS.values()
            else "rb_p" if name in sf.RB_P_KERNELS.values()
            else "rb_block" if name in sf.RB_BLOCK_KERNELS.values()
            else "rb_band" if name in (*sf.RB_BAND_KERNELS.values(),
                                       *sf.RB_BAND_P_KERNELS.values())
            else "pairs" if name.startswith("sw_pairs_")
            else "packed" if name.startswith("sw_packed_")
            else "window" if name.startswith("sw_window_")
            else "band" if name.endswith(sf.BAND_SUFFIX)
            else "block" if name in sf.BLOCK_KERNELS.values()
            else "walk" if name in (sf.WALK_KERNEL, sf.WALK_SCALAR_KERNEL)
            else "stripe")
    return ORIGIN[kind]


@functools.cache
def int32_rate() -> float:
    """int32 operations per second of card 0 at its maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60).stdout)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_PER_CLOCK_PER_SM * mhz * 1e6


def bound(cells: float, ops_per_cell: float, nbytes: float) -> dict:
    """bound_ms, bound_by and library_ms (no single PyTorch call computes
    a Smith-Waterman fill or walk) of a kernel record."""
    op_ms = cells * ops_per_cell / int32_rate() * 1e3
    byte_ms = nbytes / MEM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                library_ms=None)


def band_cells(m: int, n: int, band: int) -> int:
    """Cells (i, j) of an n x m matrix with |i - j| <= band."""
    i = np.arange(1, n + 1, dtype=np.int64)
    return int(np.clip(np.minimum(m, i + band) - np.maximum(1, i - band) + 1,
                       0, None).sum())


def fill_bytes(m: int, n: int, S=None, p: bool = False) -> int:
    """Bytes a single-pair fill must move: the codes (and table) in; the
    right column, the (4,) best (and P) out."""
    table = 0 if S is None else 4 * S.size
    return m + n + table + 4 * (n + 1) + 16 + ((n + 1) * (m + 1) if p else 0)


_T0 = time.perf_counter()


def phase(name: str, msg: str) -> None:
    """One phase line, ending with the seconds since the script started."""
    print(f"[{name}] {msg} [{time.perf_counter() - _T0:.0f} s]", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def protein_pair(n: int) -> tuple:
    """The JAX bench's protein pair: 20 letters from default_rng(0)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 20, n).astype(np.int8)
    b = rng.integers(0, 20, n).astype(np.int8)
    return a, b


# scoring name -> (Scoring, table, alphabet, pair maker)
MODELS = {
    "linear": (SCORING, None, DNA_ALPHABET,
               lambda m, n: random_pair(m, n, seed=0)),
    "dna_affine": (DNA_AFFINE, None, DNA_ALPHABET,
                   lambda m, n: random_pair(m, n, seed=0)),
    "protein": (PROTEIN, BLOSUM62, PROTEIN_ALPHABET,
                lambda m, n: protein_pair(n)),
}


def row_scan(a: np.ndarray, b: np.ndarray, sc: Scoring, S=None,
             band=None) -> tuple:
    """(max, i, j, last) by an independent numpy scan, one row at a time.

    Linear: X = max(0, DIAG, UP), then H[j] = max over k <= j of
    X[k] + gap*(j-k), a prefix max of X - gap*k. Affine: F from the row
    above, X = max(0, DIAG, F), then E[j] = open + ext*(j-1) + max over
    k < j of X[k] - ext*k (exact for gap_open <= gap_extend) and
    H = max(X, E). First row-major max by strict '>' over rows and
    argmax's first index within a row. ``band``: only the columns
    |i - j| <= band of row i are filled; the cells outside hold H = 0 and
    F = NEG, so the prefix max starts at the cell left of the band."""
    m = len(a)
    a64 = a.astype(np.int64)
    step = sc.gap_extend if sc.is_affine else sc.gap
    neg = -(1 << 30)
    prev = np.zeros(m + 1, np.int64)
    f = np.full(m + 1, neg, np.int64)
    best = bi = bj = 0
    for i in range(1, len(b) + 1):
        lo, hi = (1, m) if band is None else (max(1, i - band),
                                              min(m, i + band))
        h = np.zeros(m + 1, np.int64)
        if lo > hi:                       # the band has left the matrix
            prev, f = h, np.full(m + 1, neg, np.int64)
            continue
        s = (S[a64[lo - 1:hi], b[i - 1]] if S is not None
             else np.where(a[lo - 1:hi] == b[i - 1], sc.match, sc.mismatch))
        diag = prev[lo - 1:hi] + s
        ramp = step * np.arange(lo - 1, hi + 1, dtype=np.int64)
        x = np.zeros(hi - lo + 2, np.int64)    # columns lo-1 .. hi
        if sc.is_affine:
            fw = np.maximum(prev[lo:hi + 1] + sc.gap_open,
                            f[lo:hi + 1] + sc.gap_extend)
            x[1:] = np.maximum(np.maximum(diag, fw), 0)
            e = (np.maximum.accumulate(x - ramp)[:-1] + sc.gap_open
                 + ramp[:-1])
            h[lo:hi + 1] = np.maximum(x[1:], e)
            f = np.full(m + 1, neg, np.int64)
            f[lo:hi + 1] = fw
        else:
            x[1:] = np.maximum(np.maximum(diag, prev[lo:hi + 1] + sc.gap), 0)
            h[lo:hi + 1] = (np.maximum.accumulate(x - ramp) + ramp)[1:]
        top = int(h.max())
        if top > best:
            best, bi, bj = top, i, int(h.argmax())
        prev = h
    return best, bi, bj, int(prev[m])


def rescore(sa: str, sb: str, sc: Scoring, S=None,
            alphabet: str = DNA_ALPHABET) -> int:
    """Re-score aligned strings under the model. A gap run continues only
    while the gap stays in the same sequence: gap_open for its first
    column, gap_extend for each further one (linear: gap for each)."""
    total, run = 0, None
    for x, y in zip(sa, sb):
        side = "a" if x == "-" else "b" if y == "-" else None
        if side is None:
            total += (int(S[alphabet.index(x), alphabet.index(y)])
                      if S is not None else
                      sc.match if x == y else sc.mismatch)
        elif not sc.is_affine:
            total += sc.gap
        else:
            total += sc.gap_extend if run == side else sc.gap_open
        run = side
    return total


def timed_ms(fn, reps: int) -> tuple:
    """(min ms over reps, last result) by CUDA events; one warm-up first
    when reps > 1."""
    if reps > 1:
        fn()
    best, out = float("inf"), None
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best, out


def diff(x: torch.Tensor, y: torch.Tensor) -> int:
    require(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
    return int((x.to(torch.int32) - y.to(torch.int32)).abs().max())


def on_card(*arrays, dev) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in arrays)


def build_line() -> str:
    """ptxas's registers and spills for each kernel: every instantiation of
    the stripe template <kCaptureP, kAffine, kSub, kBand, kBlock, kPairs,
    kPacked, kWindow, kDebugH>, the two walks, the warp-per-read K6 <R,
    kAffine, kSub> and the register-blocked K1-K5, K4b, K9, K8, K8[band],
    K6, K7 and the packed K9 <R, C, kAffine, kSub, kP, kBlock, kBand,
    kDebugH, kPairs, kShared, kPacked> (rb_ K1-K3, rb_p_ K4, rb_block_ K5,
    rb_band_ and rb_p_band_ K4b, rb_debug_ K9, rb_pairs_ K8,
    rb_pairs_band_ K8[band], rb_window_ K6, rb_packed_ K7,
    rb_debug_packed_ the packed K9), and score_many's pack kernel."""
    out, name, spill = [], None, ""
    for ln in _cuda.BUILD.log.splitlines():
        got = re.search(r"stripe_kernelI" + r"Lb(\d)E" * 9, ln)
        warp = re.search(r"window_warp_kernelILi(\d+)ELb(\d)ELb(\d)E", ln)
        rb = re.search(r"stripe_rb_kernelILi(\d+)ELi(\d+)E" + r"Lb(\d)E" * 9,
                       ln)
        if "Compiling entry function" in ln and warp:
            R, aff, sub = (int(v) for v in warp.groups())
            name = (f"warp_{'sub_' if sub else ''}"
                    f"{'affine' if aff else 'linear'}_R{R}")
        elif "Compiling entry function" in ln and rb:
            R, C, aff, sub, p, blk, band, debug, pairs, shared, packed = (
                int(v) for v in rb.groups())
            kind = (("p_" if p else "block_" if blk else "debug_" if debug
                     else "window_" if shared else "pairs_" if pairs else "")
                    + ("band_" if band else "")
                    + ("packed_" if packed else ""))
            name = (f"rb_{kind}{'sub_' if sub else ''}"
                    f"{'affine' if aff else 'linear'}_R{R}_C{C}")
        elif "Compiling entry function" in ln and got:
            p, aff, sub, band, blk, pairs, packed, window, debug = (
                int(v) for v in got.groups())
            kind = ("fill_p" if p else "block" if blk else "pairs" if pairs
                    else "window" if window else "packed" if packed
                    else "score")
            kind = f"debug_{kind}" if debug else kind
            name = (f"{kind}_{'sub_' if sub else ''}"
                    f"{'affine' if aff else 'linear'}{'_band' if band else ''}")
        elif "Compiling entry function" in ln and "walk_p_kernel" in ln:
            name = "walk"
        elif ("Compiling entry function" in ln
              and "walk_p_tiled_kernel" in ln):
            name = "walk_tiled"
        elif "Compiling entry function" in ln and "pack_rows_kernel" in ln:
            name = "pack_rows"
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name} {regs} regs, {spill}")
            name = None
    return "; ".join(out)


def _small_cases() -> list:
    """(label, a, b, T, reps, protein) of the kernel-vs-plain phase."""
    rng = np.random.default_rng(7)
    two = rng.integers(0, 2, 2600).astype(np.int8)
    zeros = np.zeros(700, np.int8)
    pa, pb = protein_pair(2500)
    # sentinel codes in both sequences, around a shared segment
    sent_a, sent_b = pa[:400].copy(), pb[:1300].copy()
    sent_b[200:300] = sent_a[100:200]
    sent_a[[0, 55, 101]], sent_b[[3, 250, 1299]] = -1, -3
    sent_b[[10, 999]] = -2
    return [
        ("one stripe", *random_pair(60, 100, seed=1), None, 1, False),
        ("ragged, 10 stripes x3", *random_pair(300, 9 * 256 + 7, seed=2),
         256, 3, False),
        ("m<n", *random_pair(200, 1500, seed=3), 128, 1, False),
        ("m>n", *random_pair(1500, 200, seed=4), 64, 1, False),
        ("m=2", *random_pair(2, 700, seed=5), 64, 1, False),
        ("m=1", *random_pair(1, 700, seed=6), 64, 1, False),
        ("ties: two letters", two[:1200], two[1200:], 128, 1, False),
        ("ties: one letter", zeros, zeros[:650].copy(), 32, 1, False),
        ("ties: a = b", two[:900], two[:900].copy(), 256, 1, False),
        ("protein ragged, 10 stripes x3", pa[:300], pb[:9 * 256 + 7], 256,
         3, True),
        ("protein ties: two letters", two[:700], two[700:2000].copy(), 32,
         1, True),
        ("protein sentinels", sent_a, sent_b, 128, 1, True),
        ("protein T=1024", pa[:900], pb, 1024, 1, True),
        ("protein a = b", pa[:900], pa[:900].copy(), 1024, 1, True),
        ("protein m=1", pb[5:6].copy(), pb[:700], 64, 1, True),
    ]


# the template's score, fill_p and block entries, unbanded and banded, the
# earlier K1-K5 and K4b, and the one-thread walk: on no path
EARLIER_SCORE = (sf.SCORE_KERNEL, sf.SCORE_AFFINE_KERNEL, sf.SCORE_SUB_KERNEL)
EARLIER = (*EARLIER_SCORE, sf.FILL_P_KERNEL, sf.FILL_P_AFFINE_KERNEL,
           sf.FILL_P_SUB_KERNEL, *sf.BLOCK_KERNELS.values(),
           *(k + sf.BAND_SUFFIX for k in (*EARLIER_SCORE, sf.FILL_P_KERNEL,
                                          sf.FILL_P_AFFINE_KERNEL,
                                          sf.FILL_P_SUB_KERNEL)),
           sf.WALK_SCALAR_KERNEL)
# kernel mode -> (template score kernel, fill_p kernel, scorings, table)
MODES = {
    "linear": (sf.SCORE_KERNEL, sf.FILL_P_KERNEL, [SCORING], None),
    "dna_affine": (sf.SCORE_AFFINE_KERNEL, sf.FILL_P_AFFINE_KERNEL,
                   [DNA_AFFINE], None),
    # one kernel entry, both gap models
    "protein": (sf.SCORE_SUB_KERNEL, sf.FILL_P_SUB_KERNEL,
                [PROTEIN, PROTEIN_LINEAR], BLOSUM62),
}


def ab_ms(new, old, reps: int = 3) -> tuple:
    """(new ms, old ms, new result, old result): two designs timed in turns
    in one run (new, old, new, old), each by ``timed_ms`` (min of reps
    after a warm-up), the min of its two turns kept."""
    n1, kn = timed_ms(new, reps)
    o1, ko = timed_ms(old, reps)
    n2, _ = timed_ms(new, reps)
    o2, _ = timed_ms(old, reps)
    return min(n1, n2), min(o1, o2), kn, ko


def guarded_p(n: int, m: int, dev) -> tuple:
    """(P, buffer, mask of P's cells): K4's (n+1, m+1) P in the layout of
    ``sf.p_matrix`` inside a buffer of GUARD bytes with 64 before and
    after it; every byte off P's cells must keep GUARD."""
    pitch = -(-(m + 1) // sf.P_PITCH_ALIGN) * sf.P_PITCH_ALIGN
    base = 64 + 3
    buf = torch.full((base + (n + 1) * pitch + 64,), GUARD,
                     dtype=torch.int8, device=dev)
    cells = torch.zeros(buf.shape, dtype=torch.bool, device=dev)
    cells[base:base + (n + 1) * pitch].view(n + 1, pitch)[:, :m + 1] = True
    return (buf[base:base + (n + 1) * pitch].view(n + 1, pitch)[:, :m + 1],
            buf, cells)


def rb_p_vs_plain(at, bt, sc: Scoring, sub, pf, shapes) -> int:
    """The register-blocked K4 at each (T, R, C) of ``shapes``, into a
    guarded P, against the plain version ``pf``: best, right column and P
    bit-equal, no byte off P's cells written. Returns the max error."""
    e = 0
    for shape in shapes:
        P, buf, cells = guarded_p(bt.numel(), at.numel(), at.device)
        k = sf._launch_rb_p(at, bt, sc, *shape, sub=sub, P=P)
        torch.cuda.synchronize()
        e = max(e, diff(k.best, pf.best), diff(k.right_col, pf.right_col),
                diff(k.P, pf.P))
        require(e == 0 and bool((buf[~cells] == GUARD).all()),
                f"{sf.fill_kernel_name(sc, sub)} (T, R, C) = {shape}: "
                "kernel != plain or a guard byte written")
    return e


def kernels_vs_plain(dev) -> dict:
    """Each kernel against its plain version; returns per-kernel records.
    Score-only runs its route, the register-blocked K1-K3 (at most
    RB_MAX_THREADS threads), also at each (T, R, C) of its form's
    RB_SHAPES, and the template's K1-K3 through the private launcher, the
    earlier design; fill_p likewise the register-blocked K4 (also at
    RB_EXT_SHAPES into a guarded P, and swept over RB_EXT_SWEEP at the
    full-P path's size) and the template's K4."""
    err = {k: 0 for k in sf.launches}
    table = on_card(BLOSUM62, dev=dev)[0]
    for label, a, b, T, reps, protein in _small_cases():
        at, bt = on_card(a, b, dev=dev)
        # DNA shapes run through the DNA kernels, protein shapes through
        # the substitution kernels (both gap models)
        for mode, (ks_name, kf_name, scorings, S) in MODES.items():
            if (S is not None) != protein:
                continue
            sub = None if S is None else table
            for sc in scorings:
                ps = sf.stripe_score_plain(at, bt, sc, sub)
                pf = sf.stripe_fill_plain(at, bt, sc, sub)
                runs = []
                route = sf.score_kernel_name(sc, S)
                fill = sf.fill_kernel_name(sc, S)
                T_rb = None if T is None else min(T, sf.RB_MAX_THREADS)
                for _ in range(reps):
                    ks = sf.stripe_score(at, bt, sc, T=T_rb,
                                         substitution=sub)
                    kf = sf.stripe_fill(at, bt, sc, T=T_rb, substitution=sub)
                    torch.cuda.synchronize()
                    e1 = max(diff(ks.best, ps.best),
                             diff(ks.right_col, ps.right_col))
                    e4 = max(diff(kf.best, pf.best),
                             diff(kf.right_col, pf.right_col),
                             diff(kf.P, pf.P))
                    err[route] = max(err[route], e1)
                    err[fill] = max(err[fill], e4)
                    require(e1 == 0 and e4 == 0,
                            f"{label} {mode} {sc.mode}: kernel != plain")
                    runs.append((ks.best.tolist(), kf.P.sum().item()))
                    # the earlier K1-K4, the template's, too
                    ko = sf._launch(at, bt, sc, T, sub, False, None)
                    kfo = sf._launch(at, bt, sc, T, sub, True, None)
                    torch.cuda.synchronize()
                    e = max(diff(ko.best, ps.best),
                            diff(ko.right_col, ps.right_col))
                    err[ks_name] = max(err[ks_name], e)
                    e4 = max(diff(kfo.best, pf.best),
                             diff(kfo.right_col, pf.right_col),
                             diff(kfo.P, pf.P))
                    err[kf_name] = max(err[kf_name], e4)
                    require(e == 0 and e4 == 0,
                            f"{label} {ks_name}/{kf_name}: kernel != plain")
                err[fill] = max(err[fill], rb_p_vs_plain(
                    at, bt, sc, sub, pf, RB_EXT_SHAPES))
                for shape in RB_SHAPES[_rb_form(route)]:
                    k = sf._launch_rb(at, bt, sc, *shape, sub=sub)
                    torch.cuda.synchronize()
                    e = max(diff(k.best, ps.best),
                            diff(k.right_col, ps.right_col))
                    err[route] = max(err[route], e)
                    require(e == 0, f"{label} {route} (T, R, C) = {shape}: "
                            "kernel != plain")
                require(all(r == runs[0] for r in runs),
                        f"{label} {mode}: runs differ")
                phase("kernels", f"{label} [{mode} {sc.mode}] m={len(a)} "
                      f"n={len(b)} T={T}: {ps.best.tolist()} equal x{reps}, "
                      f"{route} at {len(RB_SHAPES[_rb_form(route)])} "
                      f"(T, R, C) too, {fill} at {len(RB_EXT_SHAPES)} "
                      "(T, R, C), guard bytes untouched")

    # the main path's shapes: kernel min of 3 after a warm-up, plain once;
    # the register-blocked K1-K3 and the earlier K1-K3 in turns
    recs = {}
    for mode, (ks_name, kf_name, scorings, S) in MODES.items():
        sc, sub = scorings[0], (None if S is None else table)
        make = MODELS[mode][3]
        at, bt = on_card(*make(SCORE_N, SCORE_N), dev=dev)
        route = sf.score_kernel_name(sc, S)
        p_ms, ps = timed_ms(
            lambda: sf.stripe_score_plain(at, bt, sc, sub), 1)
        names = {route: None}
        if route == ks_name:
            k_ms, ks = timed_ms(
                lambda: sf.stripe_score(at, bt, sc, substitution=sub), 3)
            names[route] = (k_ms, ks)
        else:
            k_ms, o_ms, ks, ko = ab_ms(
                lambda: sf.stripe_score(at, bt, sc, substitution=sub),
                lambda: sf._launch(at, bt, sc, None, sub, False, None))
            names[route], names[ks_name] = (k_ms, ks), (o_ms, ko)
        rb_sweep(at, bt, ps, sc, sub)
        ab = []
        for name, (ms, k) in names.items():
            e = max(diff(k.best, ps.best), diff(k.right_col, ps.right_col))
            require(e == 0 and tuple(k.best.tolist())
                    == KNOWN[mode, SCORE_N, SCORE_N],
                    f"{name} != plain at the benchmark size")
            recs[name] = dict(ms=ms, plain_ms=p_ms,
                              max_abs_err=max(e, err[name]),
                              **bound(SCORE_N ** 2, OPS_PER_CELL[mode],
                                      fill_bytes(SCORE_N, SCORE_N, S)))
            ab.append(f"{name} {ms:.3f} ms "
                      f"({gcups(SCORE_N ** 2, ms / 1e3):.2f} GCUPS)")
        phase("kernels", f"{SCORE_N}^2 [{mode}]: {ks.best.tolist()} "
              f"{', '.join(ab)}; plain {p_ms:.1f} ms, equal, right "
              "column too")
        del at, bt, ks, ps, names
        at, bt = on_card(*make(ALIGN_N, ALIGN_N), dev=dev)
        p_ms, pf = timed_ms(
            lambda: sf.stripe_fill_plain(at, bt, sc, sub), 1)
        # the register-blocked K4, into a P allocated outside the timed
        # call, and the template's K4, in turns; then K4's sweep
        fill = sf.fill_kernel_name(sc, S)
        P = sf.p_matrix(ALIGN_N, ALIGN_N, dev)
        f_ms, fo_ms, kf, kfo = ab_ms(
            lambda: sf._launch_rb_p(at, bt, sc, None, sub=sub, P=P),
            lambda: sf._launch(at, bt, sc, None, sub, True, None))
        for name, ms, k in ((fill, f_ms, kf), (kf_name, fo_ms, kfo)):
            e = max(diff(k.best, pf.best), diff(k.right_col, pf.right_col),
                    diff(k.P, pf.P))
            require(e == 0 and tuple(k.best.tolist())
                    == KNOWN[mode, ALIGN_N, ALIGN_N],
                    f"{name} != plain at the align size")
            recs[name] = dict(ms=ms, plain_ms=p_ms,
                              max_abs_err=max(e, err[name]),
                              **bound(ALIGN_N ** 2,
                                      OPS_PER_CELL[mode] + P_OPS[mode],
                                      fill_bytes(ALIGN_N, ALIGN_N, S, True)))
        del kfo
        Q = sf.p_matrix(ALIGN_N, ALIGN_N, dev)
        fill_sweep = ext_sweep(
            fill, lambda T, R, C: sf._launch_rb_p(at, bt, sc, T, R, C,
                                                  sub=sub, P=Q),
            lambda x: diff(x.P, pf.P) == 0 and diff(x.best, pf.best) == 0)
        phase("kernels", f"K4 {ALIGN_N}^2 [{mode}]: {pf.best.tolist()} "
              f"{fill} {f_ms:.3f} ms, {kf_name} {fo_ms:.3f} ms (in turns, "
              f"P allocated outside the timed call; {kf_name} allocates "
              f"and clears its own), plain {p_ms:.1f} ms, P bit-equal; "
              f"{fill_sweep}")
        del P, Q, kf, k
        del at, bt, pf
        torch.cuda.empty_cache()
    return recs


# the register-blocked K1-K3's (T, R, C) at the small shapes by form
# (None: the form's default T), their edges (label, m, n, seed) beside the
# shapes of _small_cases, and their sweeps at 25632^2
RB_SHAPES = {
    "linear": [(32, 8, 1), (32, 8, 4), (64, 16, 4), (128, 8, 8), (512, 4, 4),
               (256, 8, 2), (None, sf.RB_ROWS, sf.RB_COLS)],
    "gotoh": [(32, 8, 4), (32, 4, 4), (64, 8, 2), (128, 8, 4), (256, 4, 4),
              (512, 8, 2), (None, None, None)],
}
RB_EDGES = [("n<32", 300, 20, 1), ("n=33", 90, 33, 2), ("m=1 n<32", 1, 7, 3),
            ("m=33", 33, 3000, 4), ("m=7 n=5000", 7, 5000, 5)]
# (m, n) of the sentinel edges of K2 and K3 (_sentinel_pair)
RB_SENTINELS = [(300, 700), (50, 24), (4, 90)]
RB_SWEEP = {mode: [(T, R, C) for T in (64, 128, 256)
                   for R, C in sf.RB_FORM_TILES[mode]]
            for mode in sf.RB_FORM_TILES}
RB_SWEEP_ROUNDS = 3
# the register-blocked K4's and K5's (T, R, C) at the small shapes (512
# threads: their R = 4 tile), and their sweeps at the path's sizes (K4 at
# 16384^2 and the lean route's window, K5 at its 25632^2 reverse pass)
RB_EXT_SHAPES = [(32, 8, 4), (32, 4, 4), (64, 8, 2), (256, 8, 4),
                 (512, None, None), (None, None, None)]
RB_EXT_SWEEP = [(T, R, C) for T in (64, 128, 256)
                for R, C in sf.RB_EXT_TILES] + [(512, *sf.RB_WIDE_TILE)]
GUARD = 0x5A              # the byte around a guarded P


def _sentinel_pair(mode: str, m: int, n: int, seed: int) -> tuple:
    """A small pair of the mode's alphabet with a shared segment, the
    sentinel codes -1, -2, -3 in a and in b, and a -1 in both at one
    aligned spot of the segment (N against N)."""
    a, b = (x.copy() for x in _small_pair(mode, m, n, seed))
    rng = np.random.default_rng(seed)
    L = min(m, n) // 2
    i0, j0 = n // 3, m // 4
    b[i0:i0 + L] = a[j0:j0 + L]
    a[j0 + L // 2] = b[i0 + L // 2] = -1
    a[rng.choice(m, 3, replace=False)] = [-1, -2, -3]
    b[rng.choice(n, 3, replace=False)] = [-3, -2, -1]
    return a, b


def _rb_form(name: str) -> str:
    """The RB_SHAPES key of a register-blocked entry."""
    return "linear" if name == sf.RB_KERNEL else "gotoh"


def rb_vs_plain(dev) -> dict:
    """The register-blocked K1-K3 against their plain versions at RB_EDGES
    in their alphabet (DNA for K1 and K2, protein for K3 in both gap
    models) and, K2 and K3, at RB_SENTINELS, each at its form's RB_SHAPES
    (kernels_vs_plain holds them at the shapes of _small_cases), and K1
    at THIN through ``stripe_score``; returns the max error per entry."""
    table = on_card(BLOSUM62, dev=dev)[0]
    err = dict.fromkeys(sf.RB_KERNELS.values(), 0)
    for mode, (_, _, scorings, S) in MODES.items():
        cases = [(label, *_small_pair(mode, m, n, seed))
                 for label, m, n, seed in RB_EDGES]
        if mode != "linear":
            cases += [(f"sentinels {m}x{n}", *_sentinel_pair(mode, m, n, 9))
                      for m, n in RB_SENTINELS]
        sub = None if S is None else table
        for sc in scorings:
            name = sf.score_kernel_name(sc, S)
            shapes = RB_SHAPES[_rb_form(name)]
            for label, a, b in cases:
                at, bt = on_card(a, b, dev=dev)
                p = sf.stripe_score_plain(at, bt, sc, sub)
                for T, R, C in shapes:
                    k = sf._launch_rb(at, bt, sc, T, R, C, sub=sub)
                    torch.cuda.synchronize()
                    e = max(diff(k.best, p.best),
                            diff(k.right_col, p.right_col))
                    err[name] = max(err[name], e)
                    require(e == 0, f"{name} [{mode} {sc.mode}] {label} T={T}"
                            f" R={R} C={C}: kernel != plain")
            phase("kernels", f"{name} [{mode} {sc.mode}] at {len(cases)} "
                  f"shapes x {len(shapes)} (T, R, C): equal")
    m, n = THIN
    at, bt = on_card(*random_pair(m, n, seed=0), dev=dev)
    p_ms, p = timed_ms(lambda: sf.stripe_score_plain(at, bt), 1)
    k_ms, k = timed_ms(lambda: sf.stripe_score(at, bt), 3)
    e = max(diff(k.best, p.best), diff(k.right_col, p.right_col))
    require(e == 0 and tuple(k.best.tolist()) == KNOWN["linear", *THIN],
            f"{sf.RB_KERNEL} {m}x{n}: kernel != plain")
    phase("kernels", f"{sf.RB_KERNEL} THIN a={m} b={n}: {k.best.tolist()} "
          f"{k_ms:.3f} ms, plain {p_ms:.1f} ms, equal, right column too")
    err[sf.RB_KERNEL] = max(err[sf.RB_KERNEL], e)
    return err


def rb_sweep(at, bt, ps, sc: Scoring, sub) -> None:
    """The register-blocked entry of the scoring at 25632^2 over its
    form's RB_SWEEP, each point bit-equal to the plain version ``ps``
    (best and right column) and timed in RB_SWEEP_ROUNDS rounds over
    every point, so that a drift of the card's clock weighs on all alike,
    the min of its rounds kept; and, linear, one stripe of 256 rows at
    T = 32, R = 8, C = 1 and 4: the cost of a step."""
    mode = sf._mode(sc, sub)
    name = sf.RB_KERNELS[mode]
    for T, R, C in RB_SWEEP[mode]:
        k = sf._launch_rb(at, bt, sc, T, R, C, sub=sub)
        require(diff(k.best, ps.best) == 0
                and diff(k.right_col, ps.right_col) == 0,
                f"{name} T={T} R={R} C={C}: kernel != plain")
    best = dict.fromkeys(RB_SWEEP[mode], float("inf"))
    for _ in range(RB_SWEEP_ROUNDS):
        for T, R, C in RB_SWEEP[mode]:
            ms, _ = timed_ms(lambda: sf._launch_rb(at, bt, sc, T, R, C,
                                                   sub=sub), 1)
            best[T, R, C] = min(best[T, R, C], ms)
    fastest = min(best, key=best.get)
    default = sf.rb_shape(bt.numel(), mode=mode,
                          A=0 if sub is None else sub.shape[0])
    phase("kernels", f"{name} sweep at {SCORE_N}^2, ms by "
          f"(T, R, C), min of {RB_SWEEP_ROUNDS} rounds, all equal: "
          + ", ".join(f"{T}/{R}/{C} {ms:.3f}" for (T, R, C), ms in
                      best.items())
          + f"; fastest {fastest} {best[fastest]:.3f} ms, default "
          f"{default} {best[default]:.3f} ms "
          f"({best[default] / best[fastest]:.3f} x the fastest)")
    if mode != "linear":
        return
    per = []
    for C in (1, 4):
        ms, _ = timed_ms(lambda: sf._launch_rb(at, bt[:256], SCORING, 32, 8,
                                               C), 3)
        steps = -(-SCORE_N // C) + 31
        per.append(f"C={C} {ms:.3f} ms = {ms / steps * 1e3:.4f} us a step")
    phase("kernels", f"{sf.RB_KERNEL} one stripe (T=32, R=8, 256 rows) x "
          f"{SCORE_N} columns: " + "; ".join(per))


def _small_pair(mode: str, m: int, n: int, seed: int) -> tuple:
    """A small pair of the mode's alphabet."""
    if mode == "protein":
        rng = np.random.default_rng(seed)
        return (rng.integers(0, 20, m).astype(np.int8),
                rng.integers(0, 20, n).astype(np.int8))
    return random_pair(m, n, seed=seed)


# K4b's small shapes (label, m, n): n not a multiple of any stripe's rows,
# m < n and m > n (|n - m| of 990 and 700, past every band but 5000: whole
# stripes outside the band), square; its bands: none kept (-1), the diagonal, a
# window ending inside, at and past a chunk of 32 columns (31 / 32 / 33 at
# 128-row stripes), the path's 64, and wider than a stripe and the pair
# (5000); the band form's (T, R, C) sweep, at the small shapes and at the
# path's 16384^2; the score-only size 4 x the path's n (the band form's
# work is O(n band), its steps O(n))
BAND_SHAPES = [("m<n", 300, 32 * 40 + 10), ("m>n", 1000, 300),
               ("square", 300, 300)]
BAND_BANDS = (-1, 0, 31, 32, 33, BAND, 5000)
BAND_SWEEP = [(T, R, C) for T in (32, 64, 128) for R, C in sf.RB_EXT_TILES]
BAND_BIG_N = 4 * ALIGN_N


def _band_pair(mode: str, m: int, n: int, seed: int) -> tuple:
    """A pair of the mode's alphabet similar along the diagonal (b is a
    with 30 % of its letters redrawn and three deleted), so a band cuts
    through the alignment."""
    rng = np.random.default_rng(seed)
    letters = 20 if mode == "protein" else 4
    a = rng.integers(0, letters, m).astype(np.int8)
    b = np.resize(a, n + 3)
    flip = rng.random(n + 3) < 0.3
    b[flip] = rng.integers(0, letters, int(flip.sum()))
    return a, np.delete(b, [n // 3, n // 3 + 1, n // 2])


def band_vs_plain(dev) -> tuple:
    """K4b: the band form (the route: ``stripe_score``/``stripe_fill`` with
    a band, and ``_launch_rb``/``_launch_rb_p`` at every (T, R, C) of
    BAND_SWEEP) and the template's band mode (``_launch``, the earlier
    design, at T = 32 and its default) against their plain version at
    BAND_SHAPES x BAND_BANDS, the band form's P into guarded buffers; then,
    at the banded path's 16384^2 band 64, the two in turns, bit-equal, the
    band form's sweep, and score-only at BAND_BIG_N^2 band 64 the two in
    turns, best and right column equal. Returns (records, phase lines)."""
    table = on_card(BLOSUM62, dev=dev)[0]
    recs, err, lines = {}, {}, []
    for mode, (_, _, scorings, S) in MODES.items():
        sub = None if S is None else table
        for sc in scorings:
            names = (sf.score_kernel_name(sc, S, True),
                     sf.fill_kernel_name(sc, S, True),
                     sf.kernel_name(sc, S, False, True),
                     sf.kernel_name(sc, S, True, True))
            for label, m, n in BAND_SHAPES:
                at, bt = on_card(*_band_pair(mode, m, n, m + n), dev=dev)
                for band in BAND_BANDS:
                    p = sf.stripe_fill_plain(at, bt, sc, sub, band)
                    runs = [
                        (names[0], "route", lambda: sf.stripe_score(
                            at, bt, sc, substitution=sub, band=band)),
                        (names[1], "route", lambda: sf.stripe_fill(
                            at, bt, sc, substitution=sub, band=band))]
                    for shape in BAND_SWEEP:
                        runs.append((names[0], shape, lambda shape=shape:
                                     sf._launch_rb(at, bt, sc, *shape,
                                                   sub=sub, band=band)))
                        runs.append((names[1], shape, lambda shape=shape:
                                     sf._launch_rb_p(
                                         at, bt, sc, *shape, sub=sub,
                                         P=guarded[0], band=band)))
                    for T in (32, None):
                        runs.append((names[2], T, lambda T=T: sf._launch(
                            at, bt, sc, T, sub, False, band)))
                        runs.append((names[3], T, lambda T=T: sf._launch(
                            at, bt, sc, T, sub, True, band)))
                    for name, shape, run in runs:
                        guarded = guarded_p(bt.numel(), at.numel(), dev)
                        k = run()
                        torch.cuda.synchronize()
                        e = max(diff(k.best, p.best),
                                diff(k.right_col, p.right_col),
                                0 if k.P is None else diff(k.P, p.P))
                        if k.P is not None and k.P.data_ptr() == \
                                guarded[0].data_ptr():
                            require(bool((guarded[1][~guarded[2]]
                                          == GUARD).all()),
                                    f"{name} {shape}: a guard byte written")
                        err[name] = max(err.get(name, 0), e)
                        require(e == 0, f"{name} [{mode} {sc.mode}] {label} "
                                f"band {band} {shape}: kernel != plain")
            phase("kernels", f"band [{mode} {sc.mode}] {len(BAND_SHAPES)} "
                  f"shapes x bands {'/'.join(map(str, BAND_BANDS))}: "
                  f"{names[0]} and {names[1]} routed and at "
                  f"{len(BAND_SWEEP)} (T, R, C), P guarded; {names[2]} and "
                  f"{names[3]} at T=32/default: equal")

        # the banded path's size: the band form and the template in turns
        sc = scorings[0]
        names = (sf.score_kernel_name(sc, S, True),
                 sf.fill_kernel_name(sc, S, True),
                 sf.kernel_name(sc, S, False, True),
                 sf.kernel_name(sc, S, True, True))
        at, bt = on_card(*MODELS[mode][3](ALIGN_N, ALIGN_N), dev=dev)
        ps_ms, ps = timed_ms(lambda: sf.stripe_score_plain(at, bt, sc, sub,
                                                           BAND), 1)
        pf_ms, pf = timed_ms(lambda: sf.stripe_fill_plain(at, bt, sc, sub,
                                                          BAND), 1)
        P = sf.p_matrix(ALIGN_N, ALIGN_N, dev)
        s_ms, so_ms, ks, kso = ab_ms(
            lambda: sf.stripe_score(at, bt, sc, substitution=sub, band=BAND),
            lambda: sf._launch(at, bt, sc, None, sub, False, BAND))
        f_ms, fo_ms, kf, kfo = ab_ms(
            lambda: sf._launch_rb_p(at, bt, sc, None, sub=sub, P=P,
                                    band=BAND),
            lambda: sf._launch(at, bt, sc, None, sub, True, BAND))
        cells = band_cells(ALIGN_N, ALIGN_N, BAND)
        for name, ms, k, p, p_ms in ((names[0], s_ms, ks, ps, ps_ms),
                                     (names[2], so_ms, kso, ps, ps_ms),
                                     (names[1], f_ms, kf, pf, pf_ms),
                                     (names[3], fo_ms, kfo, pf, pf_ms)):
            e = max(diff(k.best, p.best), diff(k.right_col, p.right_col),
                    0 if k.P is None else diff(k.P, p.P))
            require(e == 0, f"{name} != plain at the banded path's size")
            capture_p = k.P is not None
            recs[name] = dict(
                ms=ms, plain_ms=p_ms, max_abs_err=max(e, err[name]),
                **bound(cells, OPS_PER_CELL[mode] + BAND_OPS
                        + (P_OPS[mode] if capture_p else 0),
                        fill_bytes(ALIGN_N, ALIGN_N, S, capture_p)))
        del kfo, kso
        sweep = {}
        for kind, launch, same in (
                ("score", lambda T, R, C: sf._launch_rb(
                    at, bt, sc, T, R, C, sub=sub, band=BAND),
                 lambda x: diff(x.best, ps.best) == 0
                 and diff(x.right_col, ps.right_col) == 0),
                ("fill_p", lambda T, R, C: sf._launch_rb_p(
                    at, bt, sc, T, R, C, sub=sub, P=P, band=BAND),
                 lambda x: diff(x.best, pf.best) == 0
                 and diff(x.P, pf.P) == 0)):
            sweep[kind] = ext_sweep(names[kind == "fill_p"], launch, same,
                                    BAND_SWEEP)
        del P, kf, ks, ps, pf
        torch.cuda.empty_cache()
        # score-only at 4 x n: the band form's steps grow with n, the
        # template's with n + m
        at, bt = on_card(*MODELS[mode][3](BAND_BIG_N, BAND_BIG_N), dev=dev)
        b_ms, bo_ms, kb, kbo = ab_ms(
            lambda: sf.stripe_score(at, bt, sc, substitution=sub, band=BAND),
            lambda: sf._launch(at, bt, sc, None, sub, False, BAND))
        require(diff(kb.best, kbo.best) == 0
                and diff(kb.right_col, kbo.right_col) == 0,
                f"{names[0]} != {names[2]} at {BAND_BIG_N}^2 band {BAND}")
        del at, bt, kb, kbo
        torch.cuda.empty_cache()
        lines += [
            f"[{mode}] {ALIGN_N}^2 band {BAND} in turns: {names[0]} "
            f"{s_ms:.3f} ms, {names[2]} {so_ms:.3f} ms ({so_ms / s_ms:.2f}x); "
            f"{names[1]} {f_ms:.3f} ms (P cleared in the call), {names[3]} "
            f"{fo_ms:.3f} ms ({fo_ms / f_ms:.2f}x); plain {ps_ms:.1f} / "
            f"{pf_ms:.1f} ms; all equal",
            f"[{mode}] {BAND_BIG_N}^2 band {BAND} score-only in turns: "
            f"{names[0]} {b_ms:.3f} ms ({b_ms / s_ms:.2f}x its {ALIGN_N}^2), "
            f"{names[2]} {bo_ms:.3f} ms ({bo_ms / so_ms:.2f}x); best and "
            "right column equal",
            f"[{mode}] {ALIGN_N}^2 band {BAND}: {sweep['score']}",
            f"[{mode}] {ALIGN_N}^2 band {BAND}: {sweep['fill_p']}"]
    return recs, lines


def _bounds(m: int, n: int, seed: int, anchored: bool, dev) -> tuple:
    """(top, left, top_f, left_e) on the card: random finite boundaries
    sharing the corner, or the anchored reverse pass's NEG ones."""
    rng = np.random.default_rng(seed)
    if anchored:
        top, left = np.full(m + 1, NEG, np.int32), np.full(n + 1, NEG, np.int32)
        top[0] = left[0] = 0
        tf, le = np.full(m + 1, NEG, np.int32), np.full(n + 1, NEG, np.int32)
    else:
        top = rng.integers(-40, 40, m + 1).astype(np.int32)
        left = rng.integers(-40, 40, n + 1).astype(np.int32)
        left[0] = top[0]
        tf = rng.integers(-50, 20, m + 1).astype(np.int32)
        le = rng.integers(-50, 20, n + 1).astype(np.int32)
    return on_card(top, left, tf, le, dev=dev)


def block_vs_plain(dev) -> dict:
    """K5 at small shapes: every block entry against its plain version,
    local and global, injected and anchored boundaries, the route (the
    register-blocked K5) at T=32 (many stripes, ragged n), the default and
    RB_EXT_SHAPES, the template's K5 at T=32 and its default; returns max
    errors per entry."""
    table = on_card(BLOSUM62, dev=dev)[0]
    err = dict.fromkeys([*sf.BLOCK_KERNELS.values(),
                         *sf.RB_BLOCK_KERNELS.values()], 0)
    for mode, (_, _, scorings, S) in MODES.items():
        sub = None if S is None else table
        for sc in scorings:
            name = sf.block_route_name(sc, S)
            old = sf.block_kernel_name(sc, S)
            for m, n, seed in ((300, 32 * 30 + 7, 1), (2, 500, 2),
                               (1, 400, 4), (700, 1300, 3)):
                at, bt = on_card(*_small_pair(mode, m, n, seed), dev=dev)
                m, n = at.numel(), bt.numel()
                for anchored in (False, True):
                    top, left, tf, le = _bounds(m, n, seed, anchored, dev)
                    if not sc.is_affine:
                        tf = le = None
                    for local in (True, False):
                        p = sf.stripe_block_plain(
                            at, bt, sc, top, left, tf, le, local=local,
                            substitution=sub, want_bottom=True)
                        bounds = sf._check_block(at, bt, sc, top, left, tf,
                                                 le)
                        runs = [(name, T, lambda T=T: sf.stripe_block(
                            at, bt, sc, top, left, tf, le, local=local,
                            substitution=sub, want_bottom=True, T=T))
                            for T in (32, None)]
                        runs += [(name, shape, lambda shape=shape:
                                  sf._launch_rb_block(
                                      at, bt, sc, shape[0], sub, *bounds,
                                      local, True, R=shape[1], C=shape[2]))
                                 for shape in RB_EXT_SHAPES]
                        runs += [(old, T, lambda T=T: sf._launch_block(
                            at, bt, sc, T, sub, *bounds, local, True))
                            for T in (32, None)]
                        for entry, shape, run in runs:
                            k = run()
                            torch.cuda.synchronize()
                            e = max(diff(x, y) for x, y in zip(k, p)
                                    if x is not None or y is not None)
                            err[entry] = max(err[entry], e)
                            require(e == 0, f"{entry} {sc.mode} m={m} n={n} "
                                    f"anchored={anchored} local={local} "
                                    f"{shape}: kernel != plain")
            phase("kernels", f"{name} [{mode} {sc.mode}] 4 shapes x "
                  "injected/anchored x local/global x T=32/default and "
                  f"{len(RB_EXT_SHAPES)} (T, R, C); {old} T=32/256: equal")
    return err


# scoring -> (a's width, rows) of the top-level Hirschberg / Myers-Miller
# row pass of the path (the first half of b)
ROW_PASSES = {"linear": (ALIGN_N, ALIGN_N // 2),
              "dna_affine": (HIRSCH_AFFINE_N, HIRSCH_AFFINE_N // 2),
              "protein": (HIRSCH_AFFINE_N, HIRSCH_AFFINE_N // 2)}


def rows_vs_plain(dev) -> dict:
    """K5's last-row export (want_bottom, global mode) against its plain
    version at the path's top-level row pass, with the boundaries
    ``_nw_last_row`` and ``_nw_last_rows_affine`` give it: H and F of row
    n feed every split of the recursion. Returns max errors per entry."""
    err = {}
    for mode, (m, n) in ROW_PASSES.items():
        sc, S, _, make = MODELS[mode]
        a, b = make(m, 2 * n)
        sub = None if S is None else on_card(S, dev=dev)[0]
        if sc.is_affine:
            g0, ext = sc.gap_open - sc.gap_extend, sc.gap_extend
            top = g0 + ext * np.arange(m + 1)
            top[0] = 0
            left = g0 + ext * np.arange(n + 1)      # tbg = g0 at the top
            left[0] = 0
        else:
            top, left = sc.gap * np.arange(m + 1), sc.gap * np.arange(n + 1)
        at, bt, top, left = on_card(a, b[:n], top.astype(np.int32),
                                    left.astype(np.int32), dev=dev)
        name = sf.block_route_name(sc, S)
        kw = dict(local=False, substitution=sub, want_bottom=True)
        k_ms, k = timed_ms(lambda: sf.stripe_block(at, bt, sc, top, left,
                                                   **kw), 1)
        p_ms, p = timed_ms(lambda: sf.stripe_block_plain(at, bt, sc, top,
                                                         left, **kw), 1)
        e = max(diff(x, y) for x, y in zip(k, p) if x is not None)
        require(k.bottom_row is not None and p.bottom_row is not None
                and (k.bottom_f is not None) == sc.is_affine
                and (p.bottom_f is not None) == sc.is_affine,
                f"{name}: the row-n export is missing")
        require(e == 0, f"{name} row pass {m}x{n}: kernel != plain")
        err[name] = e
        phase("kernels", f"{name} [{mode}] row pass {m}x{n} want_bottom: "
              f"bottom_row{' and bottom_f' if sc.is_affine else ''} equal "
              f"(max_abs_err 0); kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        del at, bt, k, p
    return err


def _gap_runs_p(dev) -> tuple:
    """(P, corner) on the card: random codes, and from the corner a path of
    20 DIAGONAL moves, a 70-long UP run (F_EXT on all its cells but the
    last) across a 64-row tile's border, 10 DIAGONAL, a 70-long LEFT run
    (E_EXT) across a 64-column tile's border, then DIAGONAL to row 0."""
    rng = np.random.default_rng(21)
    P = rng.integers(1, 16, (260, 320)).astype(np.int8)
    i, j = 250, 300
    for kind, length in (("D", 20), ("U", 70), ("D", 10), ("L", 70),
                         ("D", 150)):
        for t in range(length):
            if kind == "D":
                P[i, j] = 3
                i, j = i - 1, j - 1
            elif kind == "U":
                P[i, j] = ((1 if t == 0 else int(P[i, j]) & 7)
                           | (8 if t < length - 1 else 0))
                i -= 1
            else:
                P[i, j] = ((2 if t == 0 else int(P[i, j]) & 11)
                           | (4 if t < length - 1 else 0))
                j -= 1
    return on_card(P, dev=dev)[0], (250, 300)


def _layouts(P: torch.Tensor) -> list:
    """P in three layouts on its card: K4's (``sf.p_matrix``: rows padded
    to 16 bytes, 3 bytes into the allocation), contiguous, and 5 bytes into
    a buffer at a pitch of 7 bytes past its width."""
    n1, m1 = P.shape
    padded = sf.p_matrix(n1 - 1, m1 - 1, P.device)
    padded.copy_(P)
    buf = torch.zeros(5 + n1 * (m1 + 7), dtype=torch.int8, device=P.device)
    odd = buf[5:].view(n1, m1 + 7)[:, :m1]
    odd.copy_(P)
    return [padded, P.contiguous(), odd]


def walk_vs_plain(dev) -> dict:
    """The walk kernels, the route's tile-staged one and the earlier
    one-thread one, against their plain version on linear, affine and
    protein P of the register-blocked K4 at a 900x800 pair (the route's
    padded P and a contiguous copy), from the max, the corner, corners on
    64-cell tile edges and near row and column 0; on P of random codes and
    on a P whose path holds 70-long UP and LEFT runs across tile borders,
    each in three layouts (``_layouts``). Returns max errors by entry."""
    table = on_card(BLOSUM62, dev=dev)[0]
    cases = []
    for mode, (_, _, scorings, S) in MODES.items():
        sc, sub = scorings[0], (None if S is None else table)
        at, bt = on_card(*_small_pair(mode, 900, 800, 4), dev=dev)
        out = sf.stripe_fill(at, bt, sc, substitution=sub, T=32)
        _, i, j, _ = out.best.tolist()
        n, m = bt.numel(), at.numel()
        cases.append((mode, [out.P, out.P.contiguous()],
                      [(i, j), (n, m), (0, 9), (n - 1, 3), (64, 64),
                       (128, 127), (127, 128), (640, 704)]))
    rng = np.random.default_rng(20)
    codes = rng.integers(1, 16, (300, 333)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.002] = 0
    cases.append(("random codes", _layouts(on_card(codes, dev=dev)[0]),
                  [(64, 64), (63, 63), (128, 127), (299, 332), (200, 64)]))
    runs, start = _gap_runs_p(dev)
    cases.append(("gap runs", _layouts(runs), [start, (192, 256)]))
    for label, layouts, corners in cases:
        for P in layouts:
            for corner in corners:
                p = sf.walk_p_plain(P, *corner)
                require(torch.equal(sf.walk_p(P, *corner), p)
                        and torch.equal(sf._launch_walk(
                            P, *corner, sf.WALK_SCALAR_KERNEL), p),
                        f"walk {label} {corner} rows of {P.stride(0)}: "
                        "kernel != plain")
        phase("kernels", f"{sf.WALK_KERNEL} and {sf.WALK_SCALAR_KERNEL} "
              f"[{label}] {len(corners)} corners of a {tuple(layouts[0].shape)}"
              f" P, rows of {'/'.join(str(P.stride(0)) for P in layouts)} "
              "bytes: equal")
    want = "D" * 20 + "U" * 70 + "D" * 10 + "L" * 70 + "D" * 150
    require("".join("-ULD"[x] for x in sf.walk_p(runs, *start).tolist())
            == want, "walk: the gap runs' path")
    return dict.fromkeys((sf.WALK_KERNEL, sf.WALK_SCALAR_KERNEL), 0)


def walk_ab(P: torch.Tensor, wn: int, wm: int) -> tuple:
    """(tile-staged ms, one-thread ms, moves): the route's walk and the
    earlier one timed in turns (``ab_ms``) by CUDA events around the launch
    alone (the moves' buffer allocated before, their fetch after), each
    one's moves equal."""
    moves = torch.empty(max(wn + wm, 1), dtype=torch.int8, device=P.device)
    count = torch.empty(1, dtype=torch.int32, device=P.device)

    def run(name):
        return lambda: sf._call(name, P.device, [
            P.data_ptr(), P.stride(0), wn, wm, moves.data_ptr(),
            count.data_ptr()])

    t_ms, s_ms, _, _ = ab_ms(run(sf.WALK_KERNEL), run(sf.WALK_SCALAR_KERNEL))
    got = []
    for name in (sf.WALK_KERNEL, sf.WALK_SCALAR_KERNEL):
        run(name)()
        got.append(moves[:int(count)].cpu())
    require(torch.equal(*got), "the two walks differ")
    return t_ms, s_ms, got[0]


def ext_sweep(name: str, launch, same, shapes=RB_EXT_SWEEP) -> str:
    """The register-blocked K4, K5 or K4b entry ``name`` at ``shapes``'
    (T, R, C), each point ``launch(T, R, C)`` checked bit-equal by
    ``same`` and timed in RB_SWEEP_ROUNDS rounds over every point, the
    min of its rounds kept; returns the phase line's part."""
    for shape in shapes:
        require(same(launch(*shape)), f"{name} {shape}: sweep point differs")
    best = dict.fromkeys(shapes, float("inf"))
    for _ in range(RB_SWEEP_ROUNDS):
        for shape in shapes:
            ms, _ = timed_ms(lambda: launch(*shape), 1)
            best[shape] = min(best[shape], ms)
    fastest = min(best, key=best.get)
    return (f"{name} sweep, ms by (T, R, C), min of {RB_SWEEP_ROUNDS} "
            "rounds, all equal: " + ", ".join(
                f"{T}/{R}/{C} {ms:.3f}" for (T, R, C), ms in best.items())
            + f"; fastest {fastest} {best[fastest]:.3f} ms")


def lean_parts(mode: str, dev) -> tuple:
    """The lean traceback's parts at the path's size, one by one: the
    forward score pass, the anchored reverse pass (the register-blocked
    K5 and the template's in turns, against their plain version, and K5's
    sweep), the window refill with P (the register-blocked K4, min of 3
    into a P allocated outside the timed call, and the template's in
    turns, and K4's sweep), the walk (against its plain version) and the
    host's assembly of the strings. Returns (records by entry, phase
    lines)."""
    sc, S, alphabet, make = MODELS[mode]
    a, b = make(SCORE_N, SCORE_N)
    sub = None if S is None else on_card(S, dev=dev)[0]
    t0 = time.perf_counter()
    score, ei, ej, _ = tb._local_score(a, b, sc, S, dev)
    fwd_s = time.perf_counter() - t0
    ar, br = on_card(a[:ej][::-1], b[:ei][::-1], dev=dev)
    top, left, _, _ = _bounds(ej, ei, 0, True, dev)
    bounds = sf._check_block(ar, br, sc, top, left, None, None)
    name, old = sf.block_route_name(sc, S), sf.block_kernel_name(sc, S)
    k_ms, o_ms, k, ko = ab_ms(
        lambda: sf.stripe_block(ar, br, sc, top, left, local=False,
                                substitution=sub),
        lambda: sf._launch_block(ar, br, sc, None, sub, *bounds, False,
                                 False))
    p_ms, p = timed_ms(lambda: sf.stripe_block_plain(
        ar, br, sc, top, left, local=False, substitution=sub), 1)
    e = max(diff(x, y) for x, y in zip(k, p) if x is not None)
    e_old = max(diff(x, y) for x, y in zip(ko, p) if x is not None)
    require(e == 0 and e_old == 0,
            f"{name} / {old} != plain at the reverse pass's size")
    rs, ri, rj, _ = k.best.tolist()
    require(rs == score, f"{mode}: reverse pass {rs} != forward {score}")
    block_sweep = ext_sweep(
        name, lambda T, R, C: sf._launch_rb_block(
            ar, br, sc, T, sub, *bounds, False, False, R=R, C=C),
        lambda x: all(diff(u, v) == 0 for u, v in zip(x, p)
                      if u is not None))
    # in: codes, table, top and left (affine: and F, E); out: the right
    # column (affine: and E), the best
    sides = (2 if sc.is_affine else 1) * 4 * (ej + 1 + 2 * (ei + 1))
    work = bound(ei * ej, OPS_PER_CELL[mode],
                 fill_bytes(ej, ei, S) - 4 * (ei + 1) + sides)
    recs = {name: dict(ms=k_ms, plain_ms=p_ms, max_abs_err=e, **work),
            old: dict(ms=o_ms, plain_ms=p_ms, max_abs_err=e_old, **work)}
    del ar, br, k, ko, p
    si, sj = ei - ri + 1, ej - rj + 1
    wn, wm = ei - si + 1, ej - sj + 1
    wa, wb = on_card(a[sj - 1:ej], b[si - 1:ei], dev=dev)
    P = sf.p_matrix(wn, wm, dev)
    fill, fill_old = sf.fill_kernel_name(sc, S), sf.kernel_name(sc, S, True)
    f_ms, fo_ms, out, out_old = ab_ms(
        lambda: sf._launch_rb_p(wa, wb, sc, None, sub=sub, P=P),
        lambda: sf._launch(wa, wb, sc, None, sub, True, None))
    require(diff(out.P, out_old.P) == 0 and diff(out.best, out_old.best) == 0
            and diff(out.right_col, out_old.right_col) == 0,
            f"{fill} != {fill_old} at the window")
    del out_old
    Q = sf.p_matrix(wn, wm, dev)
    fill_sweep = ext_sweep(
        fill, lambda T, R, C: sf._launch_rb_p(wa, wb, sc, T, R, C, sub=sub,
                                              P=Q),
        lambda x: diff(x.P, out.P) == 0 and diff(x.best, out.best) == 0)
    del Q
    w_ms, ws_ms, moves = walk_ab(out.P, wn, wm)
    pw_ms, pmoves = timed_ms(lambda: sf.walk_p_plain(out.P, wn, wm), 1)
    require(torch.equal(moves, pmoves) and torch.equal(
        sf.walk_p(out.P, wn, wm), pmoves), f"{mode}: walk kernel != plain")
    del out, P
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ca, cb = tb._apply_moves(a[sj - 1:ej], b[si - 1:ei], wn, wm,
                             moves.numpy())
    tb._render(ca, cb, alphabet)
    host_s = time.perf_counter() - t0
    # one byte of P read and one move written per move
    for entry, ms in ((sf.WALK_KERNEL, w_ms), (sf.WALK_SCALAR_KERNEL, ws_ms)):
        recs[entry] = dict(ms=ms, plain_ms=pw_ms, max_abs_err=0,
                           **bound(len(moves), WALK_OPS, 2 * len(moves) + 4))
    lines = [
        f"{SCORE_N}^2 parts: forward {fwd_s * 1e3:.1f} ms (wall); reverse "
        f"{ei}x{ej} {name} {k_ms:.3f} ms, {old} {o_ms:.3f} ms in turns "
        f"(plain {p_ms:.1f} ms, equal); window {wn}x{wm} refill {fill} "
        f"{f_ms:.3f} ms (min of 3, P allocated outside the call), "
        f"{fill_old} {fo_ms:.3f} ms in turns (P equal); walk {len(moves)} "
        f"moves {sf.WALK_KERNEL} {w_ms:.3f} ms, {sf.WALK_SCALAR_KERNEL} "
        f"{ws_ms:.3f} ms in turns (the launch alone; plain {pw_ms:.1f} ms, "
        f"P copied to the host; equal); host strings {host_s * 1e3:.1f} ms",
        f"{ei}x{ej} reverse pass: {block_sweep}",
        f"{wn}x{wm} window: {fill_sweep}"]
    return recs, lines


def drive_lean(refs: dict) -> list:
    """The lean and banded path through the public calls; returns phase
    lines."""
    lines = []
    for mode in MODES:
        sc, S, alphabet, make = MODELS[mode]
        kw = dict(substitution=S, alphabet=alphabet, device="cuda")
        a, b = make(SCORE_N, SCORE_N)
        # two calls: the first also pays what the process does once (the
        # allocator's first block for P)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            r = swtpu_torch.align(a, b, sc, **kw)
            walls.append(time.perf_counter() - t0)
            got = (r.max_score, r.max_i, r.max_j, r.last_cell)
            want = refs[mode, SCORE_N, SCORE_N]
            require(got == want and r.path is None,
                    f"{mode} lean align {SCORE_N}^2: {got} != {want}")
            check_alignment(r, a, b, mode)
        lines.append(f"[{mode}] align {SCORE_N}^2 windowed -> {got}, "
                     f"{len(r.aligned_a)} columns re-score to "
                     f"{r.max_score}, wall {walls[0]:.3f} s, again "
                     f"{walls[1]:.3f} s")

    cfg = EngineConfig(traceback_method="hirschberg")
    for mode, n in (("linear", ALIGN_N), ("dna_affine", HIRSCH_AFFINE_N)):
        sc, S, alphabet, make = MODELS[mode]
        a, b = make(n, n)
        t0 = time.perf_counter()
        r = swtpu_torch.align(a, b, sc, cfg, device="cuda")
        wall = time.perf_counter() - t0
        got = (r.max_score, r.max_i, r.max_j, r.last_cell)
        require(got == refs[mode, n, n],
                f"{mode} hirschberg {n}^2: {got} != {refs[mode, n, n]}")
        check_alignment(r, a, b, mode)
        lines.append(f"[{mode}] align {n}^2 hirschberg -> {got}, "
                     f"{len(r.aligned_a)} columns re-score, wall {wall:.3f} s")

    cfg = EngineConfig(band=BAND)
    for mode in MODES:
        sc, S, alphabet, make = MODELS[mode]
        kw = dict(substitution=S, alphabet=alphabet, device="cuda")
        a, b = make(ALIGN_N, ALIGN_N)
        want = refs[mode, "band", ALIGN_N]
        ms, s_ = timed_ms(lambda: swtpu_torch.score(a, b, sc, cfg, **kw), 1)
        t0 = time.perf_counter()
        r = swtpu_torch.align(a, b, sc, cfg, **kw)
        wall = time.perf_counter() - t0
        got = (r.max_score, r.max_i, r.max_j, r.last_cell)
        require(s_ == want[0] and got == want,
                f"{mode} band {BAND} {ALIGN_N}^2: {s_}, {got} != {want}")
        check_alignment(r, a, b, mode)
        lines.append(f"[{mode}] band {BAND} {ALIGN_N}^2 -> {got}; score() "
                     f"{ms:.3f} ms, align wall {wall:.3f} s")
    return lines


def check_alignment(r, a, b, mode: str) -> None:
    """The walked strings re-score to the max and are substrings of the
    inputs ending at the max cell."""
    sc, S, alphabet, _ = MODELS[mode]
    require(rescore(r.aligned_a, r.aligned_b, sc, S, alphabet)
            == r.max_score,
            f"{mode}: aligned strings do not re-score to {r.max_score}")
    ua, ub = r.aligned_a.replace("-", ""), r.aligned_b.replace("-", "")
    require(decode(a[r.max_j - len(ua):r.max_j], alphabet) == ua
            and decode(b[r.max_i - len(ub):r.max_i], alphabet) == ub,
            f"{mode}: aligned strings are not the inputs' substrings")


def drive(mode: str, refs: dict) -> tuple:
    """The public calls at the main path's sizes in one scoring; returns
    the phase line and score()'s ms at SCORE_N^2."""
    sc, S, alphabet, make = MODELS[mode]
    kw = dict(substitution=S, alphabet=alphabet, device="cuda")
    a, b = make(SCORE_N, SCORE_N)
    ms, s = timed_ms(lambda: swtpu_torch.score(a, b, sc, **kw), 3)
    full = swtpu_torch.align(a, b, sc, traceback=False, **kw)
    got = (full.max_score, full.max_i, full.max_j, full.last_cell)
    want = refs[mode, SCORE_N, SCORE_N]
    require(s == got[0] and got == want,
            f"{mode} score {SCORE_N}^2: {s}, {got} != {want}")
    msg = (f"score {SCORE_N}^2 -> {got}; score() {ms / 1e3:.6f} s = "
           f"{gcups(SCORE_N ** 2, ms / 1e3):.2f} GCUPS (min of 3, CUDA "
           "events, host conversion and fetch included)")

    a, b = make(ALIGN_N, ALIGN_N)
    t0 = time.perf_counter()
    r = swtpu_torch.align(a, b, sc, **kw)
    wall = time.perf_counter() - t0
    got = (r.max_score, r.max_i, r.max_j, r.last_cell)
    want = refs[mode, ALIGN_N, ALIGN_N]
    require(got == want, f"{mode} align {ALIGN_N}^2: {got} != {want}")
    check_alignment(r, a, b, mode)
    return (f"{msg}; align {ALIGN_N}^2 full-P -> {got}, "
            f"{len(r.aligned_a)} columns re-score to {r.max_score}, "
            f"wall {wall:.3f} s"), ms


def hits_diff(x, y) -> int:
    """Max abs difference of two (scores, max_i, max_j) triples."""
    return max(diff(u, v) for u, v in zip(x, y))


def _pairs_batch(mode: str, B: int, m: int, n: int, seed: int,
                 kind: str = "") -> tuple:
    """A small batch of the mode's alphabet with a planted shared prefix;
    ``kind`` 'ties': one motif planted twice in every pair (the JAX batch
    tests' tie-rich batch); 'dark': the odd pairs of two disjoint letters,
    no positive cell; 'sentinels': codes -1, -2, -3 in every pair's a and
    b, and -1 against -1 inside the shared prefix."""
    rng = np.random.default_rng(seed)
    A = 20 if mode == "protein" else 4
    aa = rng.integers(0, A, (B, m)).astype(np.int8)
    bb = rng.integers(0, A, (B, n)).astype(np.int8)
    k = min(m, n) // 2
    bb[:, :k] = aa[:, :k]
    if kind == "ties":
        aa[:, 10:18] = aa[:, 40:48]
        bb[:, 5:13] = aa[:, 10:18]
        bb[:, 60:68] = aa[:, 10:18]
    elif kind == "dark":
        aa[1::2], bb[1::2] = 0, 1
    elif kind == "sentinels":
        for g in range(B):
            aa[g, rng.choice(m, 3, replace=False)] = [-1, -2, -3]
            bb[g, rng.choice(n, 3, replace=False)] = [-3, -2, -1]
        aa[:, k // 2] = bb[:, k // 2] = -1
    return aa, bb


def full_batch(mode: str) -> tuple:
    """The 64 x 1056^2 batch: random_batch(64, 1056, 1056, seed=0) for DNA,
    20 letters from default_rng(0) for protein."""
    B, n = BATCH
    if mode == "protein":
        rng = np.random.default_rng(0)
        return (rng.integers(0, 20, (B, n)).astype(np.int8),
                rng.integers(0, 20, (B, n)).astype(np.int8))
    return random_batch(B, n, n, seed=0)


def mixed_set() -> tuple:
    pairs = [random_pair(m, n, seed=s) for s, (m, n) in enumerate(MIXED)] * 2
    return [p[0] for p in pairs], [p[1] for p in pairs]


def pairs_vs_plain(dev) -> dict:
    """K8 (the register-blocked batch form, the route, three runs at the
    shape's T and once at each of PAIRS_RB_SHAPES; the template's, the
    earlier design), K8[band] (the register-blocked band form, the route,
    at the shape's T and at each of PAIRS_RB_SHAPES; the template's) at
    each of PAIRS_BANDS and m + n + 5, and K7 (the register-blocked packed
    form, the route, three runs at the shape's T and once at each of
    PAIRS_RB_SHAPES; the template's, the earlier design, at the shape's T
    and its own) against their plain version at the small shapes; returns
    the max error per counter."""
    table = on_card(BLOSUM62, dev=dev)[0]
    err = dict.fromkeys(pf.launches, 0)
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        sub = None if S is None else table
        k8, k7 = pf.pairs_kernel_name(sc, S), pf.packed_kernel_name(sc, S)
        k8b = pf.pairs_kernel_name(sc, S, True)
        k8t = pf.pairs_template_name(sc, S)
        k8bt = pf.pairs_template_name(sc, S, True)
        k7t = pf.packed_template_name(sc, S)
        for label, B, m, n, T, kind in PAIR_SHAPES:
            at, bt = on_card(*_pairs_batch(mode, B, m, n, B + m + n, kind),
                             dev=dev)
            p = pf.pairs_score_plain(at, bt, sc, sub)
            runs = [(k8, pf.pairs_score(at, bt, sc, T, sub))
                    for _ in range(3)]
            runs += [(k8, pf._launch_pairs_rb(at, bt, sc, *shape, sub=sub))
                     for shape in PAIRS_RB_SHAPES]
            runs += [(k7, pf.pairs_packed_score(at, bt, sc, T, sub))
                     for _ in range(3)]
            runs += [(k7, pf._launch_packed_rb(at, bt, sc, *shape, sub=sub))
                     for shape in PAIRS_RB_SHAPES]
            runs += [(k8t, pf._launch_pairs(at, bt, sc, T, sub, None)),
                     (k7t, pf._launch_packed(at, bt, sc, T, sub)),
                     (k7t, pf._launch_packed(at, bt, sc, None, sub))]
            for band in (*PAIRS_BANDS, m + n + 5):
                pb = pf.pairs_score_plain(at, bt, sc, sub, band)
                runs += [(k8b, pf.pairs_score(at, bt, sc, T, sub, band), pb),
                         (k8bt, pf._launch_pairs(at, bt, sc, T, sub, band),
                          pb)]
                runs += [(k8b, pf._launch_pairs_rb(at, bt, sc, *shape,
                                                   sub=sub, band=band), pb)
                         for shape in PAIRS_RB_SHAPES]
            torch.cuda.synchronize()
            for name, k, *plain in runs:
                e = hits_diff(k, plain[0] if plain else p)
                err[name] = max(err[name], e)
                require(e == 0, f"{name} {label} [{mode}]: kernel != plain")
            if kind == "dark":
                require(p.scores[1::2].abs().sum().item() == 0,
                        f"{label} [{mode}]: a dark pair scored")
        phase("kernels", f"{k8} (x3, and at {len(PAIRS_RB_SHAPES)} (T, R, "
              f"C)), {k8t}, {k8b} (and at {len(PAIRS_RB_SHAPES)} (T, R, C)) "
              f"and {k8bt} at bands {'/'.join(map(str, PAIRS_BANDS))}/m+n+5, "
              f"{k7} (x3, and at {len(PAIRS_RB_SHAPES)} (T, R, C)) and {k7t} "
              f"[{mode}] at {len(PAIR_SHAPES)} batch shapes: equal")
    return err


def pairs_sweep(at, bt, p, sc: Scoring, sub, label: str,
                band=None) -> None:
    """The register-blocked K8 (with ``band`` K8[band]) of the scoring over
    its form's PAIRS_SWEEP, each point equal to the plain result ``p`` and
    timed in RB_SWEEP_ROUNDS rounds over every point, the min of its rounds
    kept."""
    mode = sf._mode(sc, sub)
    name = pf.pairs_kernel_name(sc, sub, band is not None)
    for shape in PAIRS_SWEEP[mode]:
        k = pf._launch_pairs_rb(at, bt, sc, *shape, sub=sub, band=band)
        require(hits_diff(k, p) == 0, f"{name} {shape} {label}: kernel != "
                "plain")
    best = dict.fromkeys(PAIRS_SWEEP[mode], float("inf"))
    for _ in range(RB_SWEEP_ROUNDS):
        for shape in PAIRS_SWEEP[mode]:
            ms, _ = timed_ms(lambda: pf._launch_pairs_rb(
                at, bt, sc, *shape, sub=sub, band=band), 1)
            best[shape] = min(best[shape], ms)
    fastest = min(best, key=best.get)
    default = sf.rb_shape(bt.shape[1], mode=mode,
                          A=0 if sub is None else sub.shape[0],
                          kind="pairs" if band is None else "pairs_band")
    phase("batch", f"{name} sweep at {label}, ms by "
          f"(T, R, C), min of {RB_SWEEP_ROUNDS} rounds, all equal: "
          + ", ".join(f"{T}/{R}/{C} {ms:.3f}" for (T, R, C), ms in
                      best.items())
          + f"; fastest {fastest} {best[fastest]:.3f} ms, default "
          f"{default} {best[default]:.3f} ms "
          f"({best[default] / best[fastest]:.3f} x the fastest)")


def packed_sweep(at, bt, p, sc: Scoring, sub, label: str) -> None:
    """The register-blocked K7 of the scoring over its form's PACKED_SWEEP
    (q, the pairs a stripe holds, by packed_rb_geometry), each point equal
    to the plain result ``p`` and timed in RB_SWEEP_ROUNDS rounds over
    every point, the min of its rounds kept."""
    mode = sf._mode(sc, sub)
    name = pf.packed_kernel_name(sc, sub)
    A = 0 if sub is None else sub.shape[0]
    B, n = bt.shape
    shapes = {}
    for shape in PACKED_SWEEP[mode]:
        T, R, C = sf.rb_shape(n, *shape, mode, A, "packed")
        geo = pf.packed_rb_geometry(B, n, T, R)
        shapes[shape] = (geo.T, geo.per if geo.spp == 1 else f"1/{geo.spp}")
        k = pf._launch_packed_rb(at, bt, sc, *shape, sub=sub)
        require(hits_diff(k, p) == 0, f"{name} {shape} {label}: kernel != "
                "plain")
    best = dict.fromkeys(shapes, float("inf"))
    for _ in range(RB_SWEEP_ROUNDS):
        for shape in shapes:
            ms, _ = timed_ms(lambda: pf._launch_packed_rb(at, bt, sc, *shape,
                                                          sub=sub), 1)
            best[shape] = min(best[shape], ms)
    fastest = min(best, key=best.get)
    default = sf.rb_shape(n, mode=mode, A=A, kind="packed")
    phase("batch", f"{name} sweep at {label}, ms by (T, R, C) [launch T, "
          f"pairs a stripe q or 1/stripes a pair], min of {RB_SWEEP_ROUNDS} "
          "rounds, all equal: "
          + ", ".join(f"{T}/{R}/{C} [{shapes[T, R, C][0]}, q="
                      f"{shapes[T, R, C][1]}] {ms:.3f}"
                      for (T, R, C), ms in best.items())
          + f"; fastest {fastest} {best[fastest]:.3f} ms, default "
          f"{default} {best[default]:.3f} ms "
          f"({best[default] / best[fastest]:.3f} x the fastest)")


def pairs_full(dev) -> tuple:
    """K8 and K7 at 64 x 1056^2 in each scoring, against the plain batched
    fill and the per-pair single-pair kernels (K1-K3), kernel min of 3
    after a warm-up, plain once: the register-blocked K8 (the route) in
    turns with the template's K8 (the earlier design); the register-blocked
    K7 (the route of plan='packed') in turns with the template's K7 (at
    the T that cuts its chain) and with K8; all through their private
    launchers (past the wrappers' checks), the template's K8 also at the
    template K7's height, the template's K7 also at T=256 (its chain then
    crosses pairs), the register-blocked K8 and K7 swept over their tiles;
    K8[band] at BAND likewise: its band form (the route) in turns with the
    template's, swept over its tiles. Returns (records, plain results per
    mode, banded plain results per mode)."""
    table = on_card(BLOSUM62, dev=dev)[0]
    B, n = BATCH
    cells = B * n * n
    recs, want, want_band = {}, {}, {}
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        sub = None if S is None else table
        at, bt = on_card(*full_batch(mode), dev=dev)
        io = 2 * B * n + 12 * B + (0 if S is None else 4 * S.size)
        p_ms, p = timed_ms(lambda: pf.pairs_score_plain(at, bt, sc, sub), 1)
        single = torch.stack([sf.stripe_score(at[g], bt[g], sc,
                                              substitution=sub).best[:3]
                              for g in range(B)]).T
        require(hits_diff(p, single) == 0,
                f"{mode}: the plain batch != the per-pair kernels")
        fit = pf.chain_cutting_rows(n, 0 if S is None else S.shape[0])

        # the A/B through the private launchers, past the public
        # wrappers' checks of the codes (a host sync with a table)
        def new():
            return pf._launch_pairs_rb(at, bt, sc, None, sub=sub)

        def k7():
            return pf._launch_packed_rb(at, bt, sc, None, sub=sub)

        times = {}
        times["K8"], times["K8 template"], k, ko = ab_ms(
            new, lambda: pf._launch_pairs(at, bt, sc, None, sub, None))
        require(hits_diff(k, p) == 0 and hits_diff(ko, p) == 0,
                f"K8 [{mode}] {B}x{n}^2: kernel != plain")
        times["K7"], times[f"K7 template T={fit}"], k, ko = ab_ms(
            k7, lambda: pf._launch_packed(at, bt, sc, None, sub))
        require(hits_diff(k, p) == 0 and hits_diff(ko, p) == 0,
                f"K7 [{mode}] {B}x{n}^2: kernel != plain")
        k7_vs_k8, k8_vs_k7, k, _ = ab_ms(k7, new)
        require(hits_diff(k, single) == 0,
                f"K7 [{mode}] {B}x{n}^2: kernel != the per-pair kernels")
        times["K7"] = min(times["K7"], k7_vs_k8)
        times["K8"] = min(times["K8"], k8_vs_k7)
        for label, fn in (
                (f"K8 template T={fit}", lambda: pf._launch_pairs(
                    at, bt, sc, fit, sub, None)),
                ("K7 template T=256", lambda: pf._launch_packed(
                    at, bt, sc, 256, sub))):
            times[label], k = timed_ms(fn, 3)
            require(hits_diff(k, p) == 0,
                    f"{label} [{mode}] {B}x{n}^2: kernel != plain")
        pairs_sweep(at, bt, p, sc, sub, f"{B}x{n}^2")
        packed_sweep(at, bt, p, sc, sub, f"{B}x{n}^2")
        pb_ms, pb = timed_ms(
            lambda: pf.pairs_score_plain(at, bt, sc, sub, BAND), 1)
        kb_ms, kbt_ms, kb, kbt = ab_ms(
            lambda: pf._launch_pairs_rb(at, bt, sc, None, sub=sub, band=BAND),
            lambda: pf._launch_pairs(at, bt, sc, None, sub, BAND))
        require(hits_diff(kb, pb) == 0 and hits_diff(kbt, pb) == 0,
                f"band {BAND} [{mode}] {B}x{n}^2: kernel != plain")
        require(hits_diff(pf.pairs_score(at, bt, sc, substitution=sub,
                                         band=BAND), pb) == 0,
                f"pairs_score band {BAND} [{mode}] {B}x{n}^2 != plain")
        pairs_sweep(at, bt, pb, sc, sub, f"{B}x{n}^2 band {BAND}", BAND)
        ops = OPS_PER_CELL[mode]
        k8, k7 = pf.pairs_kernel_name(sc, S), pf.packed_kernel_name(sc, S)
        k8b = pf.pairs_kernel_name(sc, S, True)
        k8t = pf.pairs_template_name(sc, S)
        k8bt = pf.pairs_template_name(sc, S, True)
        k7t = pf.packed_template_name(sc, S)
        # K7's bound is K8's: the same cells and the same answer (its pad
        # rows are not cells, its per-row bests not the function's output)
        for name, label in ((k8, "K8"), (k8t, "K8 template"), (k7, "K7"),
                            (k7t, f"K7 template T={fit}")):
            recs[name] = dict(ms=times[label], plain_ms=p_ms, max_abs_err=0,
                              **bound(cells, ops, io))
        for name, ms in ((k8b, kb_ms), (k8bt, kbt_ms)):
            recs[name] = dict(ms=ms, plain_ms=pb_ms, max_abs_err=0,
                              **bound(B * band_cells(n, n, BAND),
                                      ops + BAND_OPS, io))
        want[mode] = [x.tolist() for x in p]
        want_band[mode] = [x.tolist() for x in pb]
        phase("batch", f"[{mode}] {B}x{n}^2: " + ", ".join(
            f"{k} {v:.3f} ms ({gcups(cells, v / 1e3):.2f} GCUPS)"
            for k, v in times.items())
            + f" (K8 = {k8} in turns with the template's, K7 = {k7} in turns "
            f"with the template's and with K8: {k7_vs_k8:.3f} against "
            f"{k8_vs_k7:.3f} ms); "
            f"plain {p_ms:.1f} ms; equal to the plain version and to "
            f"{B} x {sf.score_kernel_name(sc, S)}; band {BAND}: {k8b} "
            f"{kb_ms:.3f} ms against the template's {k8bt} {kbt_ms:.3f} ms "
            f"in turns ({kbt_ms / kb_ms:.2f}x; plain {pb_ms:.1f} ms), "
            "equal")
        del at, bt
    return recs, want, want_band


def no_fit_batch(dev) -> tuple:
    """K8 and K7 at NO_FIT in each scoring, where the template's K7 runs at
    the default T=256 and its chain crosses pairs: the register-blocked K8
    in turns with the template's, the register-blocked K7 in turns with
    the template's K7 and with K8, kernel min of 3 after a warm-up, plain
    once, all equal; the register-blocked K8 swept over its tiles; K8[band]
    at BAND in turns with the template's, equal to the plain banded fill.
    Returns (the linear plain result, the phase lines)."""
    B, n = NO_FIT
    cells = B * n * n
    table = on_card(BLOSUM62, dev=dev)[0]
    lines, want = [], None
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        sub = None if S is None else table
        aa, bb = (random_batch(B, n, n, seed=0) if mode != "protein"
                  else _pairs_batch(mode, B, n, n, 0))
        at, bt = on_card(aa, bb, dev=dev)
        p_ms, p = timed_ms(lambda: pf.pairs_score_plain(at, bt, sc, sub), 1)
        times = {}
        times["K8"], times["K8 template"], k, ko = ab_ms(
            lambda: pf._launch_pairs_rb(at, bt, sc, None, sub=sub),
            lambda: pf._launch_pairs(at, bt, sc, None, sub, None))
        times["K7"], times[f"K7 template T={pf.packed_stripe_rows(n, B)}"], \
            k7, k7t = ab_ms(
                lambda: pf._launch_packed_rb(at, bt, sc, None, sub=sub),
                lambda: pf._launch_packed(at, bt, sc, None, sub))
        k7_vs_k8, k8_vs_k7, _, _ = ab_ms(
            lambda: pf._launch_packed_rb(at, bt, sc, None, sub=sub),
            lambda: pf._launch_pairs_rb(at, bt, sc, None, sub=sub))
        times["K7"] = min(times["K7"], k7_vs_k8)
        times["K8"] = min(times["K8"], k8_vs_k7)
        require(all(hits_diff(x, p) == 0 for x in (k, ko, k7, k7t)),
                f"{B}x{n}^2 [{mode}]: kernel != plain")
        pairs_sweep(at, bt, p, sc, sub, f"{B}x{n}^2")
        pb = pf.pairs_score_plain(at, bt, sc, sub, BAND)
        times[f"K8[band] {BAND}"], times[f"K8[band] {BAND} template"], kb, \
            kbt = ab_ms(lambda: pf._launch_pairs_rb(at, bt, sc, None,
                                                    sub=sub, band=BAND),
                        lambda: pf._launch_pairs(at, bt, sc, None, sub, BAND))
        require(hits_diff(kb, pb) == 0 and hits_diff(kbt, pb) == 0,
                f"{B}x{n}^2 band {BAND} [{mode}]: kernel != plain")
        if mode == "linear":
            want = [x.tolist() for x in p]
        lines.append(
            f"[{mode}] {B}x{n}^2 (no stripe height cuts the template K7's "
            "chain): "
            + ", ".join(f"{k} {v:.3f} ms ({gcups(cells, v / 1e3):.2f} GCUPS)"
                        for k, v in times.items())
            + f" (K7 in turns with K8: {k7_vs_k8:.3f} against "
            f"{k8_vs_k7:.3f} ms); plain {p_ms:.1f} ms; equal (banded to the "
            "banded plain)")
    return want, lines


def bucket_kernels(dev) -> str:
    """K8 (the register-blocked route and the template's) and K7 (the
    register-blocked packed form and the template's) at the score_many
    bucket of the mixed set (16 x 16384^2, padded as score_many pads it),
    kernel min of 3 after a warm-up, the two K8 in turns, the two K7 in
    turns, the register-blocked K7 in turns with K8; all equal. Returns
    the phase line."""
    a_list, b_list = mixed_set()
    nb = 1 << (max(max(s) for s in MIXED) - 1).bit_length()
    aa = np.full((len(a_list), nb), -3, np.int8)
    bb = np.full((len(b_list), nb), -2, np.int8)
    for r, (a, b) in enumerate(zip(a_list, b_list)):
        aa[r, :len(a)], bb[r, :len(b)] = a, b
    at, bt = on_card(aa, bb, dev=dev)
    cells = sum(len(a) * len(b) for a, b in zip(a_list, b_list))
    times = {}
    times["K8"], times["K8 template"], k, ko = ab_ms(
        lambda: pf._launch_pairs_rb(at, bt, SCORING, None),
        lambda: pf._launch_pairs(at, bt, SCORING, None, None, None))
    times["K7"], times["K7 template"], k7, k7t = ab_ms(
        lambda: pf._launch_packed_rb(at, bt, SCORING, None),
        lambda: pf._launch_packed(at, bt, SCORING, None, None))
    k7_vs_k8, k8_vs_k7, _, _ = ab_ms(
        lambda: pf._launch_packed_rb(at, bt, SCORING, None),
        lambda: pf._launch_pairs_rb(at, bt, SCORING, None))
    require(all(hits_diff(x, k) == 0 for x in (ko, k7, k7t)),
            "the bucket's kernels disagree")
    return (f"score_many bucket {len(aa)}x{nb}^2 ({cells / 1e9:.2f} G real "
            "cells): " + ", ".join(
                f"{k} {v:.3f} ms ({gcups(cells, v / 1e3):.2f} GCUPS)"
                for k, v in times.items()) + " (the two K8 in turns, the two "
            f"K7 in turns; K7 in turns with K8: {k7_vs_k8:.3f} against "
            f"{k8_vs_k7:.3f} ms), equal")


# the database search's longest query and its entries (the benchmark's
# protein-dbsearch: Swiss-Prot's length model, mean 360, sigma 0.7,
# clipped to [2, 35213])
DB_QUERY, DB_ENTRIES = 5478, 8906


def db_lists(seed: int = 0) -> tuple:
    """``[query] * DB_ENTRIES`` (one object) and the entries, protein
    codes."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(rng.lognormal(np.log(360) - 0.7 ** 2 / 2, 0.7,
                                          DB_ENTRIES)), 2, 35213)
    q = rng.integers(0, 20, DB_QUERY).astype(np.int8)
    return [q] * DB_ENTRIES, [rng.integers(0, 20, int(n)).astype(np.int8)
                              for n in lens]


def pack_vs_plain(dev) -> tuple:
    """score_many's pack kernel against its plain version, bit-equal, at
    the main path's shapes: both sides of every bucket of the mixed set
    and of the database search's longest query against its entries, and a
    ragged DB_ENTRIES x 8192 side (rows of 0 to 8192 bytes at any offset,
    one ending at the buffer's last byte). Timed (min of 5 by CUDA events)
    on the database's 8192-wide query side, beside the bound of the bytes
    it stores and the same side built by PyTorch's own ops (an index and a
    where) as library_ms. Returns (records, lines)."""
    cpu, lines = torch.device("cpu"), []
    for label, (a_list, b_list) in (("mixed set", mixed_set()),
                                    ("database", db_lists())):
        on_dev = tbatch._upload(a_list, b_list, dev)
        on_cpu = tbatch._upload(a_list, b_list, cpu)
        rows = 0
        for k in range(len(on_dev.buckets)):
            for got, want in zip(tbatch._pack(on_dev, k),
                                 tbatch._pack(on_cpu, k)):
                require(torch.equal(got.cpu(), want),
                        f"{pk.PACK_KERNEL} {label} bucket "
                        f"{on_dev.buckets[k]} != plain")
                rows += got.shape[0]
        lines.append(f"{pk.PACK_KERNEL} {label}: {len(on_dev.buckets)} "
                     f"buckets, {rows} rows, {on_dev.flat.numel()} distinct "
                     "bytes uploaded, equal to the plain pack")
    # the database's query side, every bucket's a rows in one launch
    a_off, a_len = (torch.cat([t[i] for t in on_dev.tables]) for i in (0, 1))
    p_off, p_len = (torch.cat([t[i] for t in on_cpu.tables]) for i in (0, 1))
    width, rows = on_dev.buckets[0][0], a_off.numel()
    require((width, rows) == (8192, DB_ENTRIES), f"query side {rows}x{width}")
    k_ms, got = timed_ms(
        lambda: pk.pack_rows(on_dev.flat, a_off, a_len, width, -3), 5)
    t0 = time.perf_counter()
    want = pk.pack_rows_plain(on_cpu.flat, p_off, p_len, width, -3)
    p_ms = (time.perf_counter() - t0) * 1e3
    col = torch.arange(width, device=dev)
    last = on_dev.flat.numel() - 1
    lib_ms, lib = timed_ms(lambda: torch.where(
        col < a_len[:, None],
        on_dev.flat[(a_off[:, None].long() + col).clamp_(max=last)], -3), 3)
    require(torch.equal(got.cpu(), want) and torch.equal(lib.cpu(), want),
            f"{pk.PACK_KERNEL} query side: kernel, plain and library differ")
    rec = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=0,
               **bound(0, 0, rows * width))
    rec["library_ms"] = lib_ms
    # ragged rows, the buffer's ends among them
    rng = np.random.default_rng(1)
    flat = rng.integers(-128, 128, 3 * width + 37).astype(np.int8)
    lens = rng.integers(0, width + 1, DB_ENTRIES)
    lens[:4] = [width, 0, 37, width - 5]
    off = rng.integers(0, len(flat) - lens + 1)
    off[1] = len(flat)
    off[2] = len(flat) - lens[2]
    host = [torch.from_numpy(x) for x in (flat, off.astype(np.int32),
                                          lens.astype(np.int32))]
    dflat, doff, dlen = (x.to(dev) for x in host)
    for fill in (-3, -2):
        require(torch.equal(pk.pack_rows(dflat, doff, dlen, width,
                                         fill).cpu(),
                            pk.pack_rows_plain(*host, width, fill)),
                f"{pk.PACK_KERNEL} ragged {DB_ENTRIES}x{width} fill {fill} "
                "!= plain")
    lines.append(
        f"{pk.PACK_KERNEL} ragged {DB_ENTRIES}x{width} equal to the plain "
        f"pack (both sentinels); the database's {rows}x{width} query side "
        f"{k_ms * 1e3:.2f} us ({rows * width / k_ms / 1e9:.3f} TB/s stored) "
        f"against the bound {rec['bound_ms'] * 1e3:.2f} us "
        f"({rows * width / 1e6:.1f} MB at 3.35 TB/s), PyTorch's index and "
        f"where {lib_ms * 1e3:.2f} us, the plain pack on the host "
        f"{p_ms:.1f} ms")
    return {pk.PACK_KERNEL: rec}, lines


def check_records(recs: list, scores: list, top: int, mode: str,
                  pair) -> None:
    """batch_align's contract: the best ``top`` positive pairs, best
    first, ties by index, scores equal to the batch's, strings that
    re-score to them."""
    order = sorted((i for i, s in enumerate(scores) if s > 0),
                   key=lambda i: (-scores[i], i))[:top]
    require([i for i, _ in recs] == order, f"{mode}: not best-first")
    for i, r in recs:
        require(r.max_score == scores[i], f"{mode}: pair {i} re-aligned "
                f"to {r.max_score}, batch {scores[i]}")
        check_alignment(r, *pair(i), mode)


def drive_batch(want: dict, want_band: dict, want_no_fit: list,
                dev) -> tuple:
    """The batch path through the public calls on ``dev``; returns (phase
    lines, score_many's hits, its wall in s)."""
    lines = []
    B, n = NO_FIT
    k7 = dict(pf.launches)
    t0 = time.perf_counter()
    got = [x.tolist() for x in swtpu_torch.batch_score(
        *random_batch(B, n, n, seed=0), device=dev)]
    wall = time.perf_counter() - t0
    require(got == want_no_fit, f"batch_score {B}x{n}^2 != the plain version")
    require(pf.launches == {**k7, "sw_pairs_rb_linear":
                            k7["sw_pairs_rb_linear"] + 1},
            f"batch_score {B}x{n}^2 did not run K8 alone")
    lines.append(f"[linear] batch_score {B}x{n}^2 auto: K8, wall "
                 f"{wall * 1e3:.1f} ms, equal")
    B, n = BATCH
    for mode in MODES:
        sc, S, alphabet, _ = MODELS[mode]
        aa, bb = full_batch(mode)
        kw = dict(substitution=S, device=dev)
        walls = {}
        for plan in ("auto", "stripe", "packed"):
            t0 = time.perf_counter()
            got = [x.tolist() for x in swtpu_torch.batch_score(
                aa, bb, sc, plan=plan, **kw)]
            walls[plan] = time.perf_counter() - t0
            require(got == want[mode],
                    f"{mode} batch_score plan={plan} != the plain version")
        got = [x.tolist() for x in swtpu_torch.batch_score(
            aa, bb, sc, band=BAND, **kw)]
        require(got == want_band[mode], f"{mode} banded batch_score != "
                "the plain version")
        t0 = time.perf_counter()
        recs = swtpu_torch.batch_align(aa, bb, sc, top=8, alphabet=alphabet,
                                       **kw)
        wall = time.perf_counter() - t0
        check_records(recs, want[mode][0], 8, mode, lambda i: (aa[i], bb[i]))
        lines.append(
            f"[{mode}] batch_score {B}x{n}^2 wall " + ", ".join(
                f"{p} {s * 1e3:.1f} ms" for p, s in walls.items())
            + f" (conversion, copy, kernel and fetch), banded {BAND} equal; "
            f"batch_align top=8 {wall:.3f} s, scores "
            f"{[r.max_score for _, r in recs]}, strings re-score")
    a_list, b_list = mixed_set()
    t0 = time.perf_counter()
    hits = swtpu_torch.score_many(a_list, b_list, device=dev)
    many_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = swtpu_torch.align_many(a_list, b_list, top=4, device=dev)
    wall = time.perf_counter() - t0
    check_records(recs, hits.scores.tolist(), 4, "linear",
                  lambda i: (a_list[i], b_list[i]))
    lines.append(f"[linear] score_many {len(a_list)} mixed pairs wall "
                 f"{many_s:.3f} s; align_many top=4 {wall:.3f} s, scores "
                 f"{[r.max_score for _, r in recs]}, strings re-score")
    return lines, hits, many_s


# ---- the search path ----

# the JAX bench's bench_db_search (bench.py:195-231), not cut: reads,
# read length, reference bases
DB = (2048, 152, 1_000_000)
SEARCH_WINDOW = 32768              # search()'s default window
TOP_HITS = 512                     # the JAX bench's align_hits(top=512)
# examples/read_mapping.py's reads of 150 with 5 SNPs each, against the
# same reference as two records of 600 and 400 kb
MAP_READS, MAP_LEN, MAP_SPLIT = 2048, 150, 600_000
MAP_NAMES = ["chrA", "chrB"]
MAP_WINDOW = 2048                  # map_reads' top-2 window clamp here
PAIRS = 1024                       # paired-end: inserts of 300-500
CLI_READS = 256
# cut of the checks against the plain sweep (it walks one anti-diagonal
# of tensor ops per step): reads, reference, window; the search's check
# against the plain sweep takes only the reference's first 16 kb
CUT = (256, 32768, 4096)
SEARCH_CHECK_REF = 16384
# (label, B, rlen, W, T, seed) of K6's small shapes: a read length no
# stripe height cuts, B = 1, a window narrower than T, sentinels, ties
WINDOW_SHAPES = [("5x45 W=300", 5, 45, 300, 32, 1),
                 ("1x24 W=100", 1, 24, 100, 64, 2),
                 ("9x20 W=18", 9, 20, 18, 256, 3),
                 ("7x150 W=700", 7, 150, 700, 64, 4),
                 ("3x70 W=1", 3, 70, 1, 32, 5),
                 ("ties 4x40 W=300", 4, 40, 300, 32, 6)]


# the warp-per-read K6's edges (label, B, rlen, W, seed): reads of 1, 31,
# 32, 33 and 32 * WARP_MAX_ROWS rows, a window narrower than a warp, and
# reads all of sentinels (-3 after a read's end, -1 unknown)
WARP_EDGES = [("rlen=1", 6, 1, 300, 21), ("rlen=31", 5, 31, 200, 22),
              ("rlen=32", 5, 32, 200, 23), ("rlen=33", 5, 33, 200, 24),
              (f"rlen={32 * wf.WARP_MAX_ROWS}", 3, 32 * wf.WARP_MAX_ROWS,
               700, 25),
              ("W=7", 4, 40, 7, 26), ("sentinel reads", 4, 60, 300, 27)]


# K6 above 512 rows (the register-blocked shared-window form): DNA reads of
# 5000 (long reads) planted in the search's 1 Mb reference, and protein
# queries of 600 residues (past the warp route's 512 rows) planted in its
# protein reference at the cut
LONG = (64, 5000)
PROTEIN_LONG = (256, 600)
LONG_TOP = 4                       # align_hits of the long-read search
# (label, read lengths, W, seed, kind) of its small shapes: mixed lengths
# padded with -3, W from 300 to 2048, ties, no positive cell, every read
# -3 but one; at the route's (T, R, C) and at WINDOW_RB_TILES
WINDOW_RB_SHAPES = [
    ("600/513/560 W=300", (600, 513, 560), 300, 31, ""),
    ("1100/700 W=2048", (1100, 700), 2048, 32, ""),
    ("4x513 W=1000", (513,) * 4, 1000, 33, ""),
    ("ties 540/600/513 W=700", (540, 600, 513), 700, 34, "ties"),
    ("no positive cell 530/600 W=500", (530, 600), 500, 35, "dark"),
    ("all -3 but one 600/520/1000 W=1500", (600, 520, 1000), 1500, 36,
     "one_read"),
]
WINDOW_RB_TILES = [(32, (4, 4)), (64, (8, 2)), (256, (8, 4))]
# its sweep at the full-width launches
WINDOW_SWEEP = {mode: [(T, R, C) for T in (64, 128, 256, 512)
                       for R, C in sf.RB_FORM_TILES[mode]]
                for mode in sf.RB_FORM_TILES}


def db_inputs(mode: str) -> tuple:
    """(reference, reads, {read: planted position}) of the search: the JAX
    bench's draws from default_rng(0), reference first, then reads, every
    fourth read planted from the reference; protein draws 20 letters and
    plants with 6 substitutions (examples/protein_search.py)."""
    B, qlen, L = DB
    A = 20 if mode == "protein" else 4
    rng = np.random.default_rng(0)
    ref = rng.integers(0, A, L).astype(np.int8)
    reads = rng.integers(0, A, (B, qlen)).astype(np.int8)
    planted = {}
    for i in range(0, B, 4):
        p = int(rng.integers(0, L - qlen))
        q = ref[p:p + qlen].copy()
        if mode == "protein":
            muts = rng.integers(0, qlen, 6)
            q[muts] = (q[muts] + rng.integers(1, 20, 6)) % 20
        reads[i] = q
        planted[i] = p
    return ref, reads, planted


def long_inputs(mode: str) -> tuple:
    """(reference, reads, {read: planted position}) of the long-read search:
    DNA, the search's reference (``db_inputs``) and LONG's reads from
    default_rng(3), every fourth planted from the reference; protein,
    PROTEIN_LONG's queries against the reference's first CUT[1] residues,
    every fourth planted with 24 substitutions."""
    ref = db_inputs(mode)[0]
    B, qlen = PROTEIN_LONG if mode == "protein" else LONG
    A = 20 if mode == "protein" else 4
    if mode == "protein":
        ref = ref[:CUT[1]]
    rng = np.random.default_rng(3)
    reads = rng.integers(0, A, (B, qlen)).astype(np.int8)
    planted = {}
    for i in range(0, B, 4):
        p = int(rng.integers(0, len(ref) - qlen))
        q = ref[p:p + qlen].copy()
        if mode == "protein":
            muts = rng.integers(0, qlen, 24)
            q[muts] = (q[muts] + rng.integers(1, 20, 24)) % 20
        reads[i] = q
        planted[i] = p
    return ref, reads, planted


def long_window(mode: str, lengths: tuple, W: int, seed: int,
                kind: str) -> tuple:
    """(reads, window) of K6's small shapes above 512 rows: reads of the
    given lengths padded with -3 to the longest, a planted segment of the
    window in read 0, -1 in a read and the window, -2 at the window's end;
    ``kind`` 'ties': a motif planted twice in the window and twice in every
    read, the window and the reads of disjoint halves of the alphabet;
    'dark': reads and window of two disjoint letters; 'one_read': every
    read -3 but read 1."""
    rng = np.random.default_rng(seed)
    A = 20 if mode == "protein" else 4
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
    elif kind == "dark":
        win[:] = 1
        reads[reads >= 0] = 0
    else:
        k = min(lengths[0] - 202, W - 4, 400)
        reads[0, 200:200 + k] = win[3:3 + k]
        reads[0, 200 + k // 2] = -1
        win[1], win[-1] = -1, -2
        if kind == "one_read":
            reads[[g for g in range(len(lengths)) if g != 1]] = -3
    return reads, win


def small_window(mode: str, B: int, rlen: int, W: int, seed: int,
                 ties: bool) -> tuple:
    """A small K6 case with a planted read, sentinel codes (-1 in a read
    and the window, -3 after a shorter read, -2 at the window's end) and,
    ``ties``, one read planted twice in the window."""
    rng = np.random.default_rng(seed)
    A = 20 if mode == "protein" else 4
    win = rng.integers(0, A, W).astype(np.int8)
    reads = rng.integers(0, A, (B, rlen)).astype(np.int8)
    k = min(rlen - 2, W - 4)
    if k > 0:
        reads[0, 1:1 + k] = win[3:3 + k]
    if ties:
        win[W - rlen - 2:W - 2] = win[3:3 + rlen]
        reads[-1] = win[3:3 + rlen]
    elif W > 10 and rlen > 10:
        reads[0, rlen // 2] = -1
        reads[-1, rlen - 5:] = -3
        win[1], win[-1] = -1, -2
    return reads, win


def window_sweep(scorer, shard: torch.Tensor, W: int, qlen: int) -> None:
    """One search's windows through a WindowScorer, as make_searcher
    sweeps them (the fold left out)."""
    ext = shard.numel()
    step = W - qlen
    for w in range(max(1, -(-max(1, ext - qlen) // step))):
        off = min(w * step, ext - W)
        scorer(shard[off:off + W])


def map_inputs() -> tuple:
    """(records, reads, truth) of map_reads: the linear reference as two
    records, 2048 reads of 150 from default_rng(1) with 5 SNPs each
    (examples/read_mapping.py), every second one reverse-complemented;
    truth[k] = (record, local position, strand). No read straddles the
    records' boundary."""
    ref = db_inputs("linear")[0]
    L = len(ref)
    rng = np.random.default_rng(1)
    reads, truth = [], []
    for k in range(MAP_READS):
        pos = int(rng.integers(0, L - MAP_LEN))
        if MAP_SPLIT - MAP_LEN < pos < MAP_SPLIT:
            pos -= MAP_LEN
        r = ref[pos:pos + MAP_LEN].copy()
        muts = rng.integers(0, MAP_LEN, 5)
        r[muts] = (r[muts] + rng.integers(1, 4, 5)) % 4
        reads.append(np.ascontiguousarray(revcomp(r)) if k % 2 else r)
        rec = int(pos >= MAP_SPLIT)
        truth.append((rec, pos - rec * MAP_SPLIT, "-" if k % 2 else "+"))
    return [ref[:MAP_SPLIT], ref[MAP_SPLIT:]], reads, truth


def pair_inputs() -> tuple:
    """(mates 1, mates 2, inserts) of paired-end map_reads: fragments of
    300-500 from default_rng(2) within one record; mate 1 the fragment's
    first 150, mate 2 the reverse complement of its last 150."""
    ref = db_inputs("linear")[0]
    rng = np.random.default_rng(2)
    m1, m2, ins = [], [], []
    for _ in range(PAIRS):
        n = int(rng.integers(300, 501))
        f = int(rng.integers(0, len(ref) - n))
        if f < MAP_SPLIT < f + n:
            f = MAP_SPLIT - n
        m1.append(ref[f:f + MAP_LEN].copy())
        m2.append(np.ascontiguousarray(revcomp(ref[f + n - MAP_LEN:f + n])))
        ins.append(n)
    return m1, m2, ins


def window_vs_plain(dev) -> dict:
    """K6 against its plain version on the card in each scoring: the
    warp-per-read route (``window_score``) and the stripe template's (the
    private ``_TemplateWindow``, at the shape's T and its own) at
    the small shapes, the route at WARP_EDGES; the search's launch (2048 x 152
    against one 32768-column window) and one search's 31 windows, both
    designs timed in turns, plain once; linear, the map's launch (2048
    reads and their reverse complements, 150 rows, against 2048 columns)
    likewise. Then search(plan='stripe') against search(plan='scan') at
    CUT's reads and window against the reference's first SEARCH_CHECK_REF
    letters, n_best 1 and 2, forward and both strands (protein forward).
    Returns the records of both designs' entries."""
    table = on_card(BLOSUM62, dev=dev)[0]
    B, qlen, L = DB
    W = SEARCH_WINDOW
    recs = {}
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        sub = None if S is None else table
        name, warp = wf.window_kernel_name(sc, S), wf.warp_kernel_name(sc, S)
        err = dict.fromkeys((name, warp), 0)

        def check(k_name, got, want, what):
            e = hits_diff(got, want)
            err[k_name] = max(err[k_name], e)
            require(e == 0, f"{k_name} {what}: kernel != plain")

        for label, b, rlen, w, T, seed in WINDOW_SHAPES:
            rt, wt = on_card(*small_window(mode, b, rlen, w, seed,
                                           label.startswith("ties")),
                             dev=dev)
            p = wf.window_score_plain(rt, wt, sc, sub)
            check(warp, wf.window_score(rt, wt, sc, substitution=sub), p,
                  label)
            for t in (T, None):
                check(name, wf._TemplateWindow(rt, w, sc, sub, t)(wt), p,
                      f"{label} T={t}")
        for label, b, rlen, w, seed in WARP_EDGES:
            reads, win = small_window(mode, b, rlen, w, seed, False)
            if label == "sentinel reads":
                reads[1], reads[2] = -3, -1
            rt, wt = on_card(reads, win, dev=dev)
            check(warp, wf.window_score(rt, wt, sc, substitution=sub),
                  wf.window_score_plain(rt, wt, sc, sub), label)
        ref, reads, _ = db_inputs(mode)
        shard = on_card(db.shard_reference(ref, 1, qlen)[0][0], dev=dev)[0]
        rt = on_card(reads, dev=dev)[0]
        scorer = wf.WindowScorer(rt, W, sc, substitution=sub)
        stripe = wf._TemplateWindow(rt, W, sc, sub)
        require(scorer.form == "warp" and scorer.R == 5, "K6 routes")
        k_ms, o_ms, k, ko = ab_ms(lambda: scorer(shard[:W]),
                                  lambda: stripe(shard[:W]))
        p_ms, p = timed_ms(lambda: wf.window_score_plain(rt, shard[:W], sc,
                                                         sub), 1)
        check(warp, k, p, f"{B}x{qlen} W={W}")
        check(name, ko, p, f"{B}x{qlen} W={W}")
        sweep_ms, sweep_old_ms, _, _ = ab_ms(
            lambda: window_sweep(scorer, shard, W, qlen),
            lambda: window_sweep(stripe, shard, W, qlen), 1)
        extra = ""
        if mode == "linear":
            _, mreads, _ = map_inputs()
            q = db.pad_queries(mreads, MAP_LEN)
            mt, mw = on_card(np.concatenate([q, db.revcomp_padded(q)]),
                             ref[:MAP_WINDOW], dev=dev)
            mnew = wf.WindowScorer(mt, MAP_WINDOW, sc)
            mold = wf._TemplateWindow(mt, MAP_WINDOW, sc, None)
            m_ms, mo_ms, mk, mko = ab_ms(lambda: mnew(mw), lambda: mold(mw))
            mp = wf.window_score_plain(mt, mw, sc)
            check(warp, mk, mp, "map launch")
            check(name, mko, mp, "map launch")
            extra = (f"; map launch {len(mt)}x{MAP_LEN} W={MAP_WINDOW}: "
                     f"{warp} {m_ms:.3f} ms, {name} (152 rows) "
                     f"{mo_ms:.3f} ms, equal")
        rpad = stripe.padded.shape[1]
        # in: the window, the reads (and table); out: each read's answer
        # (warp) or the row bests (stripe)
        io = W + B * qlen + (0 if S is None else 4 * S.size)
        for k_name, ms, out_bytes in ((warp, k_ms, 12 * B),
                                      (name, o_ms, 8 * B * rpad)):
            recs[k_name] = dict(ms=ms, plain_ms=p_ms,
                                max_abs_err=err[k_name],
                                **bound(B * qlen * W, OPS_PER_CELL[mode],
                                        io + out_bytes))
        phase("kernels", f"K6 [{mode}] {len(WINDOW_SHAPES)} small shapes "
              f"and {len(WARP_EDGES)} edges equal; {B}x{qlen} W={W}: "
              f"{warp} (R={scorer.R}) {k_ms:.3f} ms "
              f"({gcups(B * qlen * W, k_ms / 1e3):.2f} GCUPS), {name} "
              f"(T={stripe.T}) {o_ms:.3f} ms, plain {p_ms:.1f} ms, equal; "
              f"one search's windows {sweep_ms:.1f} ms against "
              f"{sweep_old_ms:.1f} ms" + extra)
        del rt, shard, scorer, stripe
    n, Lc, Wc = CUT
    Lc = SEARCH_CHECK_REF
    ref, reads, _ = db_inputs("linear")
    cut = reads[:n].copy()
    for i in range(0, n, 4):            # plant within the cut, a quarter
        p = (i * 97) % (Lc - qlen)      # of them reverse-complemented
        cut[i] = ref[p:p + qlen] if i % 8 else revcomp(ref[p:p + qlen])
    for kw in (dict(), dict(n_best=2), dict(strand="both"),
               dict(strand="both", n_best=2)):
        got = db.search(cut, ref[:Lc], window=Wc, device=dev, **kw)
        want = db.search(cut, ref[:Lc], window=Wc, plan="scan", device=dev,
                         **kw)
        require(all(torch.equal(x, y) for x, y in zip(got, want)),
                f"search {kw} at the cut != the plain sweep's")
    pref, preads, _ = db_inputs("protein")
    kw = dict(window=Wc, scoring=PROTEIN, substitution=BLOSUM62, device=dev)
    got = db.search(preads[:n], pref[:Lc], **kw)
    want = db.search(preads[:n], pref[:Lc], plan="scan", **kw)
    require(all(torch.equal(x, y) for x, y in zip(got, want)),
            "protein search at the cut != the plain sweep's")
    phase("kernels", f"search(plan='stripe') == search(plan='scan') on the "
          f"card at the cut {n} reads x {Lc // 1024} kb, window {Wc}: "
          "n_best 1/2, forward and both strands (linear), forward "
          "(protein)")
    return recs


def window_rb_vs_plain(dev) -> tuple:
    """K6 above 512 rows in each scoring: the register-blocked
    shared-window form (the route, ``window_score``; ``_RbWindow`` at
    WINDOW_RB_TILES, each called twice, its counters cleared between
    windows) and the stripe template's (``_TemplateWindow``, the earlier
    design) against the plain version at WINDOW_RB_SHAPES; the full-width
    launch (LONG's reads, protein PROTEIN_LONG's, against one
    SEARCH_WINDOW of the reference), new and template in turns, each
    bit-equal to the plain version there, timed once; protein, the
    search's own launch (against CUT[2] columns) against the plain version
    too; the new swept over WINDOW_SWEEP, each point equal to the plain
    version; linear, one search's windows through both in turns. Returns
    (the new entries' records, phase lines)."""
    table = on_card(BLOSUM62, dev=dev)[0]
    W = SEARCH_WINDOW
    recs, lines = {}, []
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        sub = None if S is None else table
        name, tmpl = wf.window_rb_name(sc, S), wf.window_kernel_name(sc, S)
        err = 0
        for label, lengths, w, seed, kind in WINDOW_RB_SHAPES:
            rt, wt = on_card(*long_window(mode, lengths, w, seed, kind),
                             dev=dev)
            p = wf.window_score_plain(rt, wt, sc, sub)
            scorers = [wf._RbWindow(rt, w, sc, sub, T, *tile)
                       for T, tile in WINDOW_RB_TILES]
            runs = [(name, wf.window_score(rt, wt, sc, substitution=sub))]
            runs += [(name, f(wt)) for f in scorers for _ in range(2)]
            runs.append((tmpl, wf._TemplateWindow(rt, w, sc, sub)(wt)))
            torch.cuda.synchronize()
            for k_name, k in runs:
                e = hits_diff(k, p)
                if k_name == name:
                    err = max(err, e)
                require(e == 0, f"{k_name} {label} [{mode}]: kernel != plain")
            if kind == "dark":
                require(not p.scores.any(), f"{label} [{mode}]: scored")
        B, qlen = PROTEIN_LONG if mode == "protein" else LONG
        ref, reads, _ = long_inputs(mode)
        shard = on_card(db.shard_reference(ref, 1, qlen)[0][0], dev=dev)[0]
        rt = on_card(reads, dev=dev)[0]
        new = wf.WindowScorer(rt, W, sc, substitution=sub)
        old = wf._TemplateWindow(rt, W, sc, sub)
        require(new.form == "rb" and new.name == name and old.name == tmpl,
                f"K6 routes at {qlen} rows")
        k_ms, o_ms, k, ko = ab_ms(lambda: new(shard[:W]),
                                  lambda: old(shard[:W]))
        p_ms, p = timed_ms(lambda: wf.window_score_plain(
            rt, shard[:W], sc, sub), 1)
        err = max(err, hits_diff(k, p))
        require(err == 0, f"{name} {B}x{qlen} W={W} [{mode}] != plain")
        require(hits_diff(ko, p) == 0,
                f"{tmpl} {B}x{qlen} W={W} [{mode}] != plain")
        at_cut = ""
        if mode == "protein":
            wc = CUT[2]
            pc = wf.window_score_plain(rt, shard[:wc], sc, sub)
            kc = wf.WindowScorer(rt, wc, sc, substitution=sub)(shard[:wc])
            err = max(err, hits_diff(kc, pc))
            require(err == 0, f"{name} {B}x{qlen} W={wc} [{mode}] != plain")
            at_cut = f", and at the search's W={wc}"
        best = {}
        for T, R, C in WINDOW_SWEEP[sf._mode(sc, sub)]:
            f = wf._RbWindow(rt, W, sc, sub, T, R, C)
            require(hits_diff(f(shard[:W]), p) == 0,
                    f"{name} ({T}, {R}, {C}) [{mode}] != plain")
            best[f.T, R, C] = min(best.get((f.T, R, C), float("inf")),
                                  timed_ms(lambda: f(shard[:W]), 2)[0])
        fastest = min(best, key=best.get)
        cells = B * qlen * W
        rb = new._rb
        stripes = -(-qlen // (rb.T * rb.R))
        # in: the window, the reads (and table); out: the stripe firsts
        recs[name] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err, **bound(
            cells, OPS_PER_CELL[mode], W + B * qlen
            + (0 if S is None else 4 * S.size) + 16 * B * stripes))
        extra = ""
        if mode == "linear":
            s_ms, so_ms, _, _ = ab_ms(
                lambda: window_sweep(new, shard, W, qlen),
                lambda: window_sweep(old, shard, W, qlen), 1)
            nwin = -(-(len(ref)) // (W - qlen))
            extra = (f"; one search's {nwin} windows {s_ms:.1f} ms against "
                     f"{so_ms:.1f} ms through the template, in turns")
        lines.append(
            f"K6 above 512 rows [{mode}] {len(WINDOW_RB_SHAPES)} small shapes "
            f"x {1 + 2 * len(WINDOW_RB_TILES)} runs equal, the template's "
            f"too; {B}x{qlen} W={W}: {name} (T={rb.T}, R={rb.R}, "
            f"C={rb.C}) {k_ms:.3f} ms ({gcups(cells, k_ms / 1e3):.2f} "
            f"GCUPS) against the template's {tmpl} (T={old.T}) "
            f"{o_ms:.3f} ms in turns ({o_ms / k_ms:.2f}x); plain "
            f"{p_ms:.1f} ms, both equal to it{at_cut}; bound "
            f"{recs[name]['bound_ms']:.3f} ms; sweep (min of 2), all equal: "
            + ", ".join(f"{T}/{R}/{C} {ms:.3f}" for (T, R, C), ms in
                        sorted(best.items()))
            + f"; fastest {fastest} {best[fastest]:.3f} ms" + extra)
        del rt, shard, new, old, k, ko, p
        torch.cuda.empty_cache()
    return recs, lines


def check_search(mode: str, hits, ref, reads, planted) -> str:
    """Every planted read found at its locus: DNA at its end p + 151 with
    score 3 x 152; protein, ending inside its locus with at least its
    best ungapped score there."""
    qlen = reads.shape[1]
    scores, pos = hits.scores.tolist(), hits.ref_pos.tolist()
    for i, p in planted.items():
        if mode == "protein":
            s = BLOSUM62[ref[p:p + qlen], reads[i]].astype(np.int64)
            run = best = 0
            for x in s:                       # best ungapped local score
                run = max(0, run + int(x))
                best = max(best, run)
            ok = p <= pos[i] <= p + qlen - 1 and scores[i] >= best
        else:
            ok = scores[i] == 3 * qlen and pos[i] == p + qlen - 1
        require(ok, f"{mode}: planted read {i} at {p}: score {scores[i]} "
                f"at {pos[i]}")
    return f"{len(planted)} planted reads found at their loci"


def drive_long_search(dev) -> tuple:
    """Long reads, K6 above 512 rows, through the public calls on ``dev``:
    ``search`` of LONG's reads against the 1 Mb reference (linear, DNA
    affine) and of PROTEIN_LONG's queries against the protein reference at
    the cut, every planted read found at its locus; ``align_hits`` of the
    best LONG_TOP, whose strings re-score (DNA: the planted reads, whole
    at their position). Returns (phase lines, walls)."""
    lines, walls = [], {}
    for mode in MODES:
        sc, S, alphabet, _ = MODELS[mode]
        ref, reads, planted = long_inputs(mode)
        B, qlen = reads.shape
        kw = dict(scoring=sc, substitution=S, device=dev)
        if mode == "protein":
            kw["window"] = CUT[2]
        best = float("inf")
        for _ in range(2 if mode != "protein" else 1):
            t0 = time.perf_counter()
            hits = swtpu_torch.search(reads, ref, **kw)
            hits.scores.tolist()               # the fetch ends the search
            best = min(best, time.perf_counter() - t0)
        found = check_search(mode, hits, ref, reads, planted)
        t0 = time.perf_counter()
        recs = swtpu_torch.align_hits(hits, reads, ref, sc, top=LONG_TOP,
                                      substitution=S, alphabet=alphabet,
                                      device=dev)
        aln_s = time.perf_counter() - t0
        require(len(recs) == LONG_TOP, f"{mode}: {len(recs)} long records")
        scores = hits.scores.tolist()
        for r in recs:
            require(rescore(r.aligned_ref, r.aligned_read, sc, S, alphabet)
                    == r.score >= scores[r.read],
                    f"{mode}: long read {r.read}'s record does not re-score")
            if mode != "protein":
                require(r.read in planted and r.cigar == f"{qlen}M"
                        and r.ref_start == planted[r.read],
                        f"{mode}: long read {r.read}: {r.cigar} at "
                        f"{r.ref_start}")
        walls[f"long {mode}"] = best
        lines.append(
            f"[{mode}] search {B}x{qlen} vs {len(ref) // 1000} kb"
            + (f", window {CUT[2]}" if mode == "protein" else "")
            + f" (K6 above 512 rows): wall {best:.3f} s"
            + (" min of 2" if mode != "protein" else "") + f"; {found}; "
            f"align_hits(top={LONG_TOP}) {aln_s:.3f} s, records re-score"
            + ("" if mode == "protein" else f", {qlen}M at p"))
    return lines, walls


def drive_search(dev) -> tuple:
    """The search path through the public calls on ``dev``; returns (phase
    lines, walls)."""
    lines, walls = [], {}
    B, qlen, L = DB
    for mode in MODES:
        sc, S, alphabet, _ = MODELS[mode]
        ref, reads, planted = db_inputs(mode)
        kw = dict(scoring=sc, substitution=S, device=dev)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            hits = swtpu_torch.search(reads, ref, **kw)
            hits.scores.tolist()               # the fetch ends the search
            best = min(best, time.perf_counter() - t0)
        found = check_search(mode, hits, ref, reads, planted)
        t0 = time.perf_counter()
        recs = swtpu_torch.align_hits(hits, reads, ref, sc, top=TOP_HITS,
                                      substitution=S, alphabet=alphabet,
                                      device=dev)
        aln_s = time.perf_counter() - t0
        require(len(recs) == TOP_HITS, f"{mode}: {len(recs)} records")
        scores = hits.scores.tolist()
        for r in recs:
            require(rescore(r.aligned_ref, r.aligned_read, sc, S, alphabet)
                    == r.score >= scores[r.read],
                    f"{mode}: read {r.read}'s record does not re-score")
            if mode != "protein" and r.read in planted:
                require(r.cigar == f"{qlen}M"
                        and r.ref_start == planted[r.read],
                        f"{mode}: planted read {r.read}: {r.cigar} at "
                        f"{r.ref_start}")
        walls[mode] = (best, aln_s)
        lines.append(
            f"[{mode}] search {B}x{qlen} vs {L // 1000} kb: wall "
            f"{best:.3f} s min of 3 ({gcups(B * qlen * L, best):.1f} "
            f"effective GCUPS); {found}; align_hits(top={TOP_HITS}) "
            f"{aln_s:.3f} s ({TOP_HITS / aln_s:.0f} alignments/s), records "
            "re-score"
            + ("" if mode == "protein" else ", planted reads 152M at p"))
    long_lines, long_walls = drive_long_search(dev)
    lines += long_lines
    walls.update(long_walls)
    # map_reads, single-end: both strands, top-2, default window
    records, mreads, truth = map_inputs()
    t0 = time.perf_counter()
    res = swtpu_torch.map_reads(records, mreads, ref_names=MAP_NAMES,
                                device=dev)
    map_s = time.perf_counter() - t0
    prim = {r.read: r for r in res.records
            if not r.is_secondary and not r.is_unmapped}
    for k, (rec, lp, strand) in enumerate(truth):
        r = prim.get(k)
        require(r is not None and r.rname == MAP_NAMES[rec]
                and r.strand == strand
                and r.ref_start <= lp + MAP_LEN - 1 and r.ref_end >= lp,
                f"read {k} ({MAP_NAMES[rec]}:{lp} {strand}) mapped to {r}")
    names = [f"read{k}" for k in range(MAP_READS)]
    sam = swtpu_torch.to_sam(res.records, res.reads_all, read_names=names,
                             sq=res.sq, so=res.so)
    per = {}
    for ln in sam.splitlines():
        f = ln.split("\t")
        if not ln.startswith("@") and not int(f[1]) & 0x100:
            per[f[0]] = per.get(f[0], 0) + 1
    require(per == dict.fromkeys(names, 1),
            "the SAM lacks one primary or unmapped record per read")
    lines.append(f"[linear] map_reads {MAP_READS}x{MAP_LEN} (5 SNPs, half "
                 f"reverse) vs 2 records: wall {map_s:.3f} s; every read on "
                 "its record and strand over its locus; one primary record "
                 "per read in the SAM")
    # paired-end
    m1, m2, ins = pair_inputs()
    t0 = time.perf_counter()
    res = swtpu_torch.map_reads(records, m1, reads2=m2, ref_names=MAP_NAMES,
                                device=dev)
    pair_s = time.perf_counter() - t0
    mapped = [r for r in res.records if not r.is_unmapped]
    require(len(mapped) == 2 * PAIRS
            and all(r.flag_extra & 0x2 and abs(r.tlen) == ins[r.read % PAIRS]
                    for r in mapped),
            "paired map_reads: not every planted pair proper at its insert")
    lines.append(f"[linear] map_reads paired {PAIRS} pairs (inserts "
                 f"300-500): wall {pair_s:.3f} s; every pair proper (0x2), "
                 "TLEN = insert")
    # the map CLI in a subprocess, against the library on the same files
    with tempfile.TemporaryDirectory() as d:
        ref_fa, reads_fq = os.path.join(d, "ref.fa"), os.path.join(d, "r.fq")
        with open(ref_fa, "w") as f:
            for name, seq in zip(MAP_NAMES, records):
                f.write(f">{name}\n{decode(seq)}\n")
        with open(reads_fq, "w") as f:
            for k in range(CLI_READS):
                f.write(f"@read{k}\n{decode(mreads[k])}\n+\n"
                        f"{'I' * MAP_LEN}\n")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "swtpu_torch", "map", ref_fa, reads_fq],
            capture_output=True, text=True, timeout=600,
            cwd=Path(__file__).resolve().parent)
        cli_s = time.perf_counter() - t0
    require(out.returncode == 0, f"map CLI failed: {out.stderr[-2000:]}")
    res = swtpu_torch.map_reads(records, mreads[:CLI_READS],
                                ref_names=MAP_NAMES, device=dev)
    lib = swtpu_torch.to_sam(res.records, res.reads_all,
                             read_names=names[:CLI_READS],
                             quals=["I" * MAP_LEN] * CLI_READS, sq=res.sq,
                             so=res.so)
    require([ln for ln in out.stdout.splitlines() if not ln.startswith("@PG")]
            == lib.splitlines(), "the map CLI's SAM != the library's")
    lines.append(f"[linear] python -m swtpu_torch map, {CLI_READS} reads "
                 f"(FASTQ) vs 2 records (FASTA): process wall {cli_s:.1f} s; "
                 f"SAM equal to the library's apart from @PG; "
                 f"{out.stderr.strip().splitlines()[-1]}")
    walls["map"], walls["paired"] = map_s, pair_s
    return lines, walls


# ---- the dispatch phase: the host tiers, the crossovers, the tuned table

# the host crossover's squares, each tier timed against the card (three
# runs a point, the fastest kept; dispatch.autotune.host_crossover)
CROSS_HOST = (128, 256, 384, 512, 768)
CROSS_SIMD = (512, 1024, 2048, 3072)
# the OpenMP probes in child processes: the batch the children score, and
# how long a forked child may take before it counts as hung
OMP_BATCH = (64, 300, 400)
FORK_WAIT_S = 5.0
# the search of one window: the search's reads against the reference's
# first DISPATCH_WINDOW - qlen bases, one window of DISPATCH_WINDOW columns
# (the host SIMD fill's positions ride int16 lanes: at most 32767)
DISPATCH_WINDOW = 32767
# tuned lookups, score-only, DNA linear
TUNED_SIZES = (2048, 8192, 25632)


def _in_turns(new, old, reps: int = 2) -> tuple:
    """(best new s, best old s, new's result, old's result): new, old,
    old, new, ..., host clocks around calls that end on the host."""
    t_new, t_old, r_new, r_old = [], [], None, None
    for k in range(reps):
        for which in ((new, old) if k % 2 == 0 else (old, new)):
            t0 = time.perf_counter()
            got = which()
            dt = time.perf_counter() - t0
            if which is new:
                t_new.append(dt)
                r_new = got
            else:
                t_old.append(dt)
                r_old = got
    return min(t_new), min(t_old), r_new, r_old


_OMP_CHILD = """
import json, sys, numpy as np, torch
from swtpu_torch import runtime_native as rn
B, m, n = {shape}
rng = np.random.default_rng(7)
aa = rng.integers(0, 4, (B, m)).astype(np.int8)
bb = rng.integers(0, 4, (B, n)).astype(np.int8)
x = torch.randn(512, 512)
s = float((x @ x).sum())
got = [v.tolist() for v in rn.score_simd_batch(aa, bb)]
print(json.dumps({{"omp": rn.omp_threads(), "torch": torch.get_num_threads(),
                  "got": got}}))
"""


def _omp_batch() -> tuple:
    B, m, n = OMP_BATCH
    rng = np.random.default_rng(7)
    return (rng.integers(0, 4, (B, m)).astype(np.int8),
            rng.integers(0, 4, (B, n)).astype(np.int8))


def _omp_fork_child(what: str, conn) -> None:
    """A forked child's work: a torch matmul on the host, or the native
    batch scorer; sends 'ok' when it returns."""
    from swtpu_torch import runtime_native as rn
    if what == "torch":
        x = torch.randn(512, 512)
        float((x @ x).sum())
    else:
        rn.score_simd_batch(*_omp_batch())
    conn.send("ok")


def omp_coexistence(rn) -> list:
    """The native library's OpenMP runtime beside torch's: the runtimes
    this process maps and their threads, the batch scorer's answers in a
    spawned interpreter (as the mesh's ranks start) after this process ran
    both, and whether a child forked after both runs either. A spawned
    child that fails or disagrees fails the run; a forked one is reported
    (nothing in the port forks)."""
    aa, bb = _omp_batch()
    x = torch.randn(512, 512)
    float((x @ x).sum())
    want = [v.tolist() for v in rn.score_simd_batch(aa, bb)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c",
                           _OMP_CHILD.format(shape=OMP_BATCH)],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(Path(__file__).resolve().parent))
    require(proc.returncode == 0, f"spawned OpenMP child: {proc.stderr}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    require(child["got"] == want, "spawned OpenMP child: batch scores differ")
    spawn_s = time.perf_counter() - t0
    forked = []
    ctx = multiprocessing.get_context("fork")
    for what in ("torch", "native"):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_omp_fork_child, args=(what, send))
        p.start()
        ok = recv.poll(FORK_WAIT_S)
        if p.is_alive():
            p.kill()
        p.join()
        forked.append(f"{what} {'returned' if ok else 'hung (killed)'}")
    runtimes = sorted({ln.split()[-1] for ln in open("/proc/self/maps")
                       if "gomp" in ln or "iomp" in ln or "libomp" in ln})
    return [f"OpenMP: runtimes mapped {runtimes}; native regions "
            f"{rn.omp_threads()} threads, torch {torch.get_num_threads()}; "
            f"a spawned child after both: native {child['omp']} threads, "
            f"torch {child['torch']}, the {OMP_BATCH[0]}x{OMP_BATCH[1]}x"
            f"{OMP_BATCH[2]} batch equal, in {spawn_s:.1f} s; a child forked "
            f"after both: {', '.join(forked)} within {FORK_WAIT_S} s"]


def drive_dispatch(dev) -> list:
    """The host tiers and the dispatch layer on the card: the native build
    and its OpenMP runtime beside torch's (in this process, a spawned and
    a forked child), the SIMD rate and the card's floor as a check on the
    committed crossovers, the crossovers measured again, the host tiers
    serving through the public calls against the kernels and the plain
    versions, align_hits and map_reads against the K4 route (the host
    tier off) in turns, tuned lookups and a small sweep. Returns phase
    lines."""
    from swtpu_torch import runtime_native as rn
    from swtpu_torch.core import config as cf
    from swtpu_torch.dispatch import autotune as at
    from swtpu_torch.dispatch import plan as dp
    from swtpu_torch.engine import align as ealign
    from swtpu_torch.kernels import _native
    lines = []
    t0 = time.perf_counter()
    _native.library()
    lines.append(f"host library {_native.BUILD.path.name}: "
                 f"{_native.BUILD.cxx} {_native.BUILD.seconds:.2f} s, "
                 f"loaded in {time.perf_counter() - t0:.2f} s, flags "
                 f"{' '.join(_native.BUILD.flags)}; host "
                 f"{_native.cpu_model()}, {os.cpu_count()} cores"
                 + (f"; the OpenMP probes failed: {_native.BUILD.openmp_log}"
                    if _native.BUILD.openmp_log else ""))
    lines += omp_coexistence(rn)
    rate = rn.measured_simd_gcups()
    floor = at.card_floor_s()
    cap = EngineConfig().simd_cells_cap()
    require(rate and rate > 0 and cap == cf.HOST_SIMD_MAX_CELLS,
            f"SIMD rate {rate}, the SIMD cap {cap}")
    lines.append(f"SIMD fill {rate:.3f} GCUPS a core (min of 5 at 1056^2) "
                 f"x card floor {floor * 1e6:.1f} us (min of "
                 f"{at.FLOOR_PROBE_CALLS} warm score() at "
                 f"{at.FLOOR_PROBE_N}^2) = {int(rate * 1e9 * floor)} cells, "
                 f"a check on the committed caps: host_simd_max_cells "
                 f"{cap} (~{int(cap ** 0.5)}^2), host_max_cells "
                 f"{cf.HOST_MAX_CELLS} (~{int(cf.HOST_MAX_CELLS ** 0.5)}^2)")
    cross = at.host_crossover(CROSS_HOST, CROSS_SIMD, k=3, verbose=False)
    for tier in ("host", "simd"):
        lines.append(f"{tier} tier wins up to {cross[tier + '_max_side']}^2"
                     ": " + ", ".join(
                         f"{r['side']}^2 {r['host_s'] * 1e3:.3f}/"
                         f"{r['card_s'] * 1e3:.3f} ms"
                         for r in cross[tier]) + " (host/card)")

    # align() at 64^2 and score() under the cap, 'auto' against 'stripe'
    # and the plain version, in each scoring
    side = max(16, min(1024, int(cap ** 0.5) // 2))
    for mode in MODES:
        sc, S, alphabet, make = MODELS[mode]
        kw = dict(substitution=S, alphabet=alphabet)
        a, b = make(64, 64)
        pf.reset_counts()
        r = swtpu_torch.align(a, b, sc, device=dev, **kw)
        require(r.plan == "host" and not any(sf.launches.values()),
                f"{mode} align 64^2 auto: plan {r.plan}, {sf.launches}")
        k = swtpu_torch.align(a, b, sc, plan="stripe", device=dev, **kw)
        p = swtpu_torch.align(a, b, sc, plan="scan", device="cpu", **kw)
        fields = [(x.max_score, x.max_i, x.max_j, x.last_cell, x.path,
                   x.aligned_a, x.aligned_b) for x in (r, k, p)]
        require(fields[0] == fields[1] == fields[2] and k.plan == "stripe"
                and sf.launches[sf.fill_kernel_name(sc, S)] == 1,
                f"{mode} align 64^2: host {fields[0]} stripe {fields[1]} "
                f"plain {fields[2]}")
        a, b = make(side, side)
        got = None
        if rn.simd_shape_ok(side, side, sc, S) and side * side <= cap:
            pf.reset_counts()
            r = swtpu_torch.align(a, b, sc, traceback=False, device=dev,
                                  **kw)
            require(r.plan == "host-simd" and not any(sf.launches.values()),
                    f"{mode} score {side}^2 auto: plan {r.plan}")
            got = (r.max_score, r.max_i, r.max_j, r.last_cell)
            k = swtpu_torch.align(a, b, sc, traceback=False, plan="stripe",
                                  device=dev, **kw)
            p = swtpu_torch.align(a, b, sc, traceback=False, plan="scan",
                                  device="cpu", **kw)
            require(got == (k.max_score, k.max_i, k.max_j, k.last_cell)
                    == (p.max_score, p.max_i, p.max_j, p.last_cell)
                    and swtpu_torch.score(a, b, sc, device=dev,
                                          substitution=S) == got[0],
                    f"{mode} score {side}^2: host-simd {got} != the kernel "
                    "or the plain version")
        lines.append(f"[{mode}] align 64^2 auto -> host, equal to "
                     f"plan='stripe' (K4) and the plain version; score "
                     f"{side}^2 auto -> "
                     + ("host-simd " + str(got) + ", equal" if got else
                        "not under the cap (the SIMD gate)"))

    # batch_score(plan='host-simd') against K8 on the batch path's batch
    B, n = BATCH
    for mode in MODES:
        sc, S, _, _ = MODELS[mode]
        aa, bb = full_batch(mode)
        kw = dict(substitution=S)
        host_s, k8_s, hh, kk = _in_turns(
            lambda: [x.tolist() for x in swtpu_torch.batch_score(
                aa, bb, sc, plan="host-simd", device=dev, **kw)],
            lambda: [x.tolist() for x in swtpu_torch.batch_score(
                aa, bb, sc, plan="stripe", device=dev, **kw)])
        require(hh == kk, f"{mode} batch_score host-simd != K8")
        lines.append(f"[{mode}] batch_score {B}x{n}^2 host-simd "
                     f"{host_s * 1e3:.1f} ms vs K8 {k8_s * 1e3:.1f} ms "
                     "(walls, in turns), equal")

    # search(plan='host-simd') against K6 over one window
    Bq, qlen, _ = DB
    for mode in MODES:
        sc, S, _, _ = MODELS[mode]
        ref, reads, _ = db_inputs(mode)
        ref = ref[:DISPATCH_WINDOW - qlen]
        kw = dict(scoring=sc, substitution=S, window=DISPATCH_WINDOW,
                  device=dev)
        host_s, k6_s, hh, kk = _in_turns(
            lambda: [x.tolist() for x in swtpu_torch.search(
                reads, ref, plan="host-simd", **kw)],
            lambda: [x.tolist() for x in swtpu_torch.search(
                reads, ref, plan="stripe", **kw)])
        require(hh == kk, f"{mode} search host-simd != K6")
        lines.append(f"[{mode}] search {Bq}x{qlen} x one {DISPATCH_WINDOW}"
                     f"-column window: host-simd {host_s * 1e3:.1f} ms vs "
                     f"K6 {k6_s * 1e3:.1f} ms (walls, in turns), equal")

    # align_hits(top=512) and map_reads: the host tier against the K4
    # route (every re-alignment a K4 launch, the copy of P, a host walk)
    sc, S, alphabet, _ = MODELS["linear"]
    ref, reads, _ = db_inputs("linear")
    hits = swtpu_torch.search(reads, ref, device=dev)
    records, mreads, _ = map_inputs()

    real_choose = ealign.choose_exec

    def no_host_tier(m, n, config, *args, **kw):
        return real_choose(m, n, dataclasses.replace(config,
                                                     host_max_cells=0),
                           *args, **kw)

    def new(fn):
        return fn()

    def old(fn):
        ealign.choose_exec = no_host_tier
        try:
            return fn()
        finally:
            ealign.choose_exec = real_choose

    def hits_fn():
        return [tuple(r) for r in swtpu_torch.align_hits(
            hits, reads, ref, sc, top=TOP_HITS, device=dev)]

    def map_fn():
        return [tuple(r) for r in swtpu_torch.map_reads(
            records, mreads, ref_names=MAP_NAMES, device=dev).records]

    pf.reset_counts()
    new(hits_fn)
    k4 = sf.fill_kernel_name(sc, S)
    require(sf.launches[k4] == 0, f"align_hits on the host tier ran {k4}")
    h_new, h_old, rh_new, rh_old = _in_turns(lambda: new(hits_fn),
                                             lambda: old(hits_fn))
    require(rh_new == rh_old and sf.launches[k4] >= 2 * TOP_HITS,
            f"align_hits: host tier != the K4 route, or {k4} ran "
            f"{sf.launches[k4]} times")
    m_new, m_old, rm_new, rm_old = _in_turns(lambda: new(map_fn),
                                             lambda: old(map_fn))
    require(rm_new == rm_old, "map_reads: host tier != the K4 route")
    lines.append(f"[linear] align_hits(top={TOP_HITS}) host tier "
                 f"{h_new:.3f} s vs the K4 route (host tier off) "
                 f"{h_old:.3f} s; "
                 f"map_reads {MAP_READS}x{MAP_LEN} {m_new:.3f} s vs "
                 f"{m_old:.3f} s (walls, best of 2 in turns); records equal")

    # tuned lookups, and the score they run against the defaults'
    pol = dp._tuned_policy()
    looked = []
    for s in TUNED_SIZES:
        e = dp.choose_exec(s, s, EngineConfig(), SCORING, False, dev)
        looked.append(f"{s}^2 -> {e.plan} T={e.T} R={e.R} C={e.C} "
                      f"({e.source})")
        a, b = random_pair(s, s, seed=0)
        require(swtpu_torch.score(a, b, device=dev) == swtpu_torch.score(
            a, b, plan="stripe", device=dev), f"tuned score {s}^2")
    stamp = None if pol is None else pol.table.get("device")
    lines.append(f"tuned table {'loaded' if pol else 'not loaded'} "
                 f"(stamp {stamp}): " + "; ".join(looked)
                 + "; each score() equal to the defaults'")

    # a two-size, three-tile sweep (DNA affine: its form's three tiles)
    t0 = time.perf_counter()
    table = at.sweep(sizes=(2048, 8192), threads=(128,), scoring=DNA_AFFINE,
                     k=3, verbose=False)
    rows = []
    for e in table["entries"]:
        fast = min(e["all"], key=lambda r: r["s"])
        rows.append(f"{e['m']}^2 fastest T={fast['T']} R={fast['R']} "
                    f"C={fast['C']} {fast['s'] * 1e3:.3f} ms, the default "
                    f"{e['default']['s'] * 1e3:.3f} ms, spread "
                    f"{e['spread'] * 100:.1f} % of {len(e['all'])}: "
                    + ("a winner" if e["best"] else "the default stands"))
    require(all(len(e["all"]) == 3 for e in table["entries"])
            and at.stamp_matches(table), "autotune.sweep's table")
    lines.append(f"autotune.sweep [affine] in {time.perf_counter() - t0:.1f}"
                 f" s: " + "; ".join(rows))
    return lines


# ---- the sanitize path ----

SANITIZE_N = 4096                  # sanitize() at 4096^2: 16.8 M cells
SANITIZE_B = 16                    # sanitize_pairs_packed on 16 x 1056^2
# its K9 held to the plain capture on the first 8 of them (the plain
# capture walks a diagonal of tensor ops a step: 12-18 s at 16 pairs)
SANITIZE_PLAIN_B = 8
# the template's single-pair K9, on no path: its record and plain
# comparison at 1024^2
TEMPLATE_DEBUG_N = 1024
# the template's packed K9, on no path since the packed form's capture:
# its record and plain comparison on the first 4 pairs of the 16
TEMPLATE_PACKED_B = 4
# K9's small shapes, each at T = 32 and 128 (the plain capture walks
# anti-diagonals in tensor ops): (label, m, n) single pairs with ragged
# stripes, m = 1 and m > n; (label, B, m, n) packed batches whose pairs
# straddle stripes. The register-blocked K9 runs the single pairs at both
# its tiles (sf.RB_DEBUG_TILES)
DEBUG_PAIRS = [("300x1290", 300, 1290), ("ragged 200x583", 200, 583),
               ("m=1 1x700", 1, 700), ("m>n 700x200", 700, 200)]
DEBUG_BATCHES = [("5x300x45", 5, 300, 45), ("9x18x20", 9, 18, 20),
                 ("3x1x70", 3, 1, 70), ("4x40x130", 4, 40, 130)]
# the register-blocked packed K9's: those, and pairs across stripes at T =
# 32 in both tiles
PACKED_DEBUG_BATCHES = [*DEBUG_BATCHES, ("3x40x300", 3, 40, 300),
                        ("2x25x1100", 2, 25, 1100)]
DEBUG_T = (32, 128)
# the register-blocked K9s at the small shapes: T = 32 alone, where they
# span stripes (score()'s T = 128 is held at the path's shapes,
# debug_records)
RB_DEBUG_T = (32,)


def capture_bytes(cap) -> int:
    """Bytes a K9 launch writes beyond its twin's: H of every slot of the
    steps its stripes run, and the progress seen, a row of m + 1 a
    stripe."""
    return 4 * int((cap.h != df.UNSCHEDULED).sum()) + 4 * cap.seen.numel()


def _held(cap, H, maxes, skew: int, what: str) -> None:
    """A capture passes the checks, or under the test hook is rejected."""
    try:
        san.check_capture(cap, H, maxes)
        caught = False
    except san.SanitizeError:
        caught = True
    require(caught == (skew > 0),
            f"{what} skew={skew}: checks {'missed' if skew else 'failed'}")


def debug_vs_plain(dev) -> dict:
    """K9 against its plain capture on the card at the small shapes, in
    each scoring (the table in both gap models): h bit-equal and the
    captures passing the checks. The register-blocked K9 (the route) at
    DEBUG_PAIRS x its tiles x RB_DEBUG_T, with the hand-off test hook
    (skew=1) where the pair spans stripes and m > 1: h bit-equal again,
    and the checks reject both captures. The register-blocked packed K9
    (sanitize_pairs_packed's route) at PACKED_DEBUG_BATCHES x its tiles x
    RB_DEBUG_T, the hook wherever a pair spans stripes and m > 1. The
    template's K9 at its shapes, the hook at T = 128: packed pairs and
    single pairs (the earlier designs, on no path), single pairs at T =
    128 alone. Returns the max error per counter."""
    table = on_card(BLOSUM62, dev=dev)[0]
    err = dict.fromkeys([*df.launches, *df.rb_launches,
                         *df.packed_rb_launches], 0)
    for mode, (_, _, scorings, S) in MODES.items():
        sub = None if S is None else table
        for sc in scorings:
            name = df.rb_debug_kernel_name(sc, S)
            t0 = time.perf_counter()
            hooked = 0
            for label, m, n in DEBUG_PAIRS:
                a, b = _small_pair(mode, m, n, m + n)
                H, maxes = san.reference(a, b, sc, S)
                at, bt = on_card(a, b, dev=dev)
                for R, C in sf.RB_DEBUG_TILES:
                    for T in RB_DEBUG_T:
                        shape = df.rb_capture_shape(bt, sc, sub, T, R, C)
                        hook = (T == RB_DEBUG_T[0] and m > 1
                                and n > shape[0] * R)
                        hooked += hook
                        for skew in (0, 1) if hook else (0,):
                            what = (f"{name} {label} {sc.mode} (T, R, C) = "
                                    f"{shape}")
                            k = df.stripe_rb_capture(at, bt, sc, T, R, C,
                                                     sub, skew)
                            p = df.stripe_rb_capture_plain(at, bt, sc, T, R,
                                                           C, sub, skew)
                            torch.cuda.synchronize()
                            e = df.same_capture(k, p, skew > 0)
                            err[name] = max(err[name], e)
                            require(e == 0, f"{what} skew={skew}: kernel != "
                                    "plain")
                            for cap in (k, p):
                                _held(cap, H, maxes, skew, what)
            phase("kernels", f"{name} [{mode} {sc.mode}] {len(DEBUG_PAIRS)} "
                  f"shapes x (R, C) {sf.RB_DEBUG_TILES} x T=32: h equal,"
                  f" checks pass; skew=1 at T=32 ({hooked} shapes): h "
                  f"equal, checks reject both; "
                  f"{time.perf_counter() - t0:.1f} s")
            name = df.packed_rb_debug_kernel_name(sc, S)
            t0 = time.perf_counter()
            hooked = 0
            for label, B, m, n in PACKED_DEBUG_BATCHES:
                a, b = _pairs_batch(mode, B, m, n, B + m + n)
                H, maxes = san.reference(a, b, sc, S)
                at, bt = on_card(a, b, dev=dev)
                for R, C in sf.RB_DEBUG_TILES:
                    for T in RB_DEBUG_T:
                        _, geo = df.packed_rb_capture_geometry(bt, sc, sub,
                                                               T, R, C)
                        hook = geo.spp > 1 and m > 1
                        hooked += hook
                        for skew in (0, 1) if hook else (0,):
                            what = (f"{name} {label} {sc.mode} (T, R, C) = "
                                    f"{(geo.T, R, C)}")
                            k = df.packed_rb_capture(at, bt, sc, T, R, C,
                                                     sub, skew)
                            p = df.packed_rb_capture_plain(at, bt, sc, T, R,
                                                           C, sub, skew)
                            torch.cuda.synchronize()
                            e = df.same_capture(k, p, skew > 0)
                            err[name] = max(err[name], e)
                            require(e == 0, f"{what} skew={skew}: kernel != "
                                    "plain")
                            for cap in (k, p):
                                _held(cap, H, maxes, skew, what)
            phase("kernels", f"{name} [{mode} {sc.mode}] "
                  f"{len(PACKED_DEBUG_BATCHES)} batches x (R, C) "
                  f"{sf.RB_DEBUG_TILES} x T=32: h equal, checks pass; "
                  f"skew=1 where a pair spans stripes ({hooked} points): h "
                  f"equal, checks reject both; "
                  f"{time.perf_counter() - t0:.1f} s")
            for packed, shapes in ((False, DEBUG_PAIRS),
                                   (True, DEBUG_BATCHES)):
                t0 = time.perf_counter()
                name = df.debug_kernel_name(sc, S, packed)
                kfn = df.packed_capture if packed else df.stripe_capture
                pfn = (df.packed_capture_plain if packed
                       else df.stripe_capture_plain)
                Ts = DEBUG_T if packed else DEBUG_T[-1:]
                for label, *shape in shapes:
                    a, b = (_pairs_batch(mode, *shape, sum(shape)) if packed
                            else _small_pair(mode, *shape, sum(shape)))
                    H, maxes = san.reference(a, b, sc, S)
                    at, bt = on_card(a, b, dev=dev)
                    for T in Ts:
                        hook = T == DEBUG_T[-1] and a.shape[-1] > 1
                        for skew in (0, 1) if hook else (0,):
                            k = kfn(at, bt, sc, T, sub, skew)
                            p = pfn(at, bt, sc, T, sub, skew)
                            torch.cuda.synchronize()
                            e = df.same_capture(k, p, skew > 0)
                            err[name] = max(err[name], e)
                            require(e == 0, f"{name} {label} {sc.mode} T={T} "
                                    f"skew={skew}: kernel != plain")
                            for cap in (k, p):
                                _held(cap, H, maxes, skew,
                                      f"{name} {label} {sc.mode} T={T}")
                phase("kernels", f"{name} [{mode} {sc.mode}] "
                      f"{len(shapes)} shapes x T={'/'.join(map(str, Ts))}: "
                      "h equal, checks pass; skew=1 at T=128: h equal, "
                      "checks reject both; "
                      f"{time.perf_counter() - t0:.1f} s")
    return err


def sanitize_batch(mode: str) -> tuple:
    """The first 16 pairs of the 64 x 1056^2 batch."""
    aa, bb = full_batch(mode)
    return aa[:SANITIZE_B], bb[:SANITIZE_B]


def debug_records(dev) -> dict:
    """Each K9 entry at its shapes: the register-blocked K9 at the sanitize
    path's 4096^2 at score()'s tile, in turns with the template's K9 there
    (kernel min of 3 after a warm-up), every cell of its capture checked
    against the numpy oracle (``check_capture``), its plain capture timed
    once, h bit-equal; the template's single-pair K9, on no path, likewise
    at TEMPLATE_DEBUG_N^2; the register-blocked packed K9 at the sanitize
    path's 16 x 1056^2 at K7's (T, R, C) and geometry, in turns with the
    template's packed K9 there, checked likewise and held to its plain
    capture on the first SANITIZE_PLAIN_B pairs; the template's packed K9, on no path, likewise on the first
    TEMPLATE_PACKED_B pairs. Returns the records."""
    table = on_card(BLOSUM62, dev=dev)[0]
    recs = {}
    for mode in MODES:
        sc, S, _, make = MODELS[mode]
        sub = None if S is None else table
        for kind in ("rb", "template", "packed", "packed template"):
            t0 = time.perf_counter()
            if kind == "packed":
                a, b = sanitize_batch(mode)
                kfn, pfn = df.packed_rb_capture, df.packed_rb_capture_plain
                name = df.packed_rb_debug_kernel_name(sc, S)
            elif kind == "packed template":
                a, b = (x[:TEMPLATE_PACKED_B] for x in sanitize_batch(mode))
                kfn, pfn = df.packed_capture, df.packed_capture_plain
                name = df.debug_kernel_name(sc, S, True)
            elif kind == "rb":
                a, b = make(SANITIZE_N, SANITIZE_N)
                kfn, pfn = df.stripe_rb_capture, df.stripe_rb_capture_plain
                name = df.rb_debug_kernel_name(sc, S)
            else:
                a, b = make(TEMPLATE_DEBUG_N, TEMPLATE_DEBUG_N)
                kfn, pfn = df.stripe_capture, df.stripe_capture_plain
                name = df.debug_kernel_name(sc, S, False)
            rb = kind in ("rb", "packed")
            at, bt = on_card(a, b, dev=dev)
            ab = ""
            if rb:
                old = df.stripe_capture if kind == "rb" else df.packed_capture
                k_ms, o_ms, k, ko = ab_ms(
                    lambda: kfn(at, bt, sc, None, substitution=sub),
                    lambda: old(at, bt, sc, None, sub))
                if kind == "rb":
                    san.check_capture(ko, *san.reference(a, b, sc, S))
                ab = (f"; in turns, {df.debug_kernel_name(sc, S, kind != 'rb')}"
                      f" {o_ms:.3f} ms (T={ko.T}"
                      + (", its every cell equal to the oracle's too"
                         if kind == "rb" else "")
                      + f"), {o_ms / k_ms:.2f} x")
                del ko
            else:
                k_ms, k = timed_ms(lambda: kfn(at, bt, sc, None, sub), 3)
            san.check_capture(k, *san.reference(a, b, sc, S))
            pa, pb, pk = at, bt, k
            if kind == "packed":
                pa, pb = at[:SANITIZE_PLAIN_B], bt[:SANITIZE_PLAIN_B]
                pk = kfn(pa, pb, sc, None, substitution=sub)
            p_ms, p = timed_ms(lambda: (pfn(pa, pb, sc, None,
                                            substitution=sub)
                                        if rb else pfn(pa, pb, sc, None,
                                                       sub)), 1)
            e = df.same_capture(pk, p)
            require(e == 0, f"{name} [{mode}] {tuple(b.shape)}: kernel != "
                    "plain")
            m, n = a.shape[-1], b.size
            packed = kind.startswith("packed")
            # in: codes (and table); out: the twin's bests (packed: one per
            # row) and right column (not the packed form's), and the capture
            io = (a.size + b.size + (0 if S is None else 4 * S.size)
                  + (0 if kind == "packed" else 4 * (n + 1))
                  + (8 * n if packed else 16) + capture_bytes(k))
            recs[name] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=e,
                              **bound(m * n, OPS_PER_CELL[mode], io))
            phase("kernels", f"{name} [{mode}] {'x'.join(map(str, b.shape))}"
                  f" x {m} (T, R, C) = {(k.T, k.R, k.C)}"
                  + (f", {k.geometry}" if k.geometry is not None else "")
                  + f": capture {k.h.numel() * 4 / 1e6:.1f} MB, kernel "
                  f"{k_ms:.3f} ms, every cell equal to the oracle's; plain "
                  + (f"on the first {SANITIZE_PLAIN_B} pairs "
                     if kind == "packed" else "")
                  + f"{p_ms:.1f} ms, h equal; bound "
                  f"{recs[name]['bound_ms']:.4f} ms "
                  f"({recs[name]['bound_by']}){ab}; "
                  f"{time.perf_counter() - t0:.1f} s")
            del at, bt, k, p, pa, pb, pk
            torch.cuda.empty_cache()
    return recs


def drive_sanitize(dev) -> list:
    """The sanitize path through the public calls on ``dev``; returns
    phase lines."""
    lines = []
    N = SANITIZE_N
    for mode in MODES:
        sc, S, _, make = MODELS[mode]
        a, b = make(N, N)
        t0 = time.perf_counter()
        rep = swtpu_torch.sanitize(a, b, scoring=sc, substitution=S,
                                   device=dev)
        wall = time.perf_counter() - t0
        # score()'s tile for the pair: (128, 8, 4), stripes of 1024 rows
        tile = sf.rb_shape(N, mode=sf._mode(sc, S),
                           A=0 if S is None else S.shape[0])
        require(rep.valid_cells == N * N
                and rep.config == (*tile, -(-N // (tile[0] * tile[1]))),
                f"{mode} sanitize {N}^2: {rep}")
        lines.append(f"[{mode}] sanitize {N}^2: {rep.valid_cells} cells "
                     f"bit-checked, {rep.prestart_cells} pre-start, "
                     f"{rep.garbage_cells} garbage, config {rep.config}; "
                     f"wall {wall:.2f} s (capture, copy, oracle, checks)")
    n = BATCH[1]
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        aa, bb = sanitize_batch(mode)
        t0 = time.perf_counter()
        rep = san.sanitize_pairs_packed(aa, bb, sc, substitution=S,
                                        device=dev)
        wall = time.perf_counter() - t0
        # K7's tile and geometry: (128, 8, 4), 2 stripes a pair
        T, R, C = sf.rb_shape(n, mode=sf._mode(sc, S),
                              A=0 if S is None else S.shape[0],
                              kind="packed")
        geo = pf.packed_rb_geometry(SANITIZE_B, n, T, R)
        require(rep.valid_cells == SANITIZE_B * n * n
                and rep.config == (geo.T, R, C, geo.stripes),
                f"{mode} sanitize_pairs_packed {SANITIZE_B}x{n}^2: {rep}")
        lines.append(f"[{mode}] sanitize_pairs_packed {SANITIZE_B}x{n}^2: "
                     f"{rep.valid_cells} cells bit-checked, config "
                     f"{rep.config}; wall {wall:.2f} s")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "swtpu_torch", str(N), str(N),
         "--skip-backtrack", "--sanitize"],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    cli_s = time.perf_counter() - t0
    ok = [ln for ln in out.stdout.splitlines() if ln.startswith("Sanitizer")]
    require(out.returncode == 0 and ok and ok[0].startswith(
        f"Sanitizer: OK — {N * N} cells bit-checked"),
        f"the sanitize CLI failed: {out.stdout[-2000:]}{out.stderr[-2000:]}")
    lines.append(f"[linear] python -m swtpu_torch {N} {N} --skip-backtrack "
                 f"--sanitize: process wall {cli_s:.1f} s; {ok[0]}")
    return lines


# ---- the mesh paths: the column-stripe pipeline, the sharded calls ----

MESH_BIG = 65536                   # bench.py's bench_big pair, seed 0
MESH_N = 16384                     # the pipeline's pairs in every scoring
# K5 a stage against the plain block fill, several block rows: a pair and
# its block rows (the plain fill walks one anti-diagonal of tensor ops a
# step); the MESH_N^2 passes are checked at the default rows
MESH_CHECK = (2048, 512)
SWEEP_ROWS = (4096, 8192, 16384, 32768, 65536)
SWEEP_T = (64, 128, 256)
MESH_PAIRS = (4, 4096)             # the batch pipeline's pairs
MESH_RANKS = 4
# examples/read_mapping.py's set: a reference of 200 kb, 2000 reads of
# 150 with 5 SNPs each and one random read, from default_rng(0)
EXAMPLE = (200_000, 2000, 150)
MESH_COUNTERS = ("launches", "plain_calls")


def example_set() -> tuple:
    ref_len, n_reads, rlen = EXAMPLE
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, ref_len).astype(np.int8)
    reads = []
    for _ in range(n_reads):
        pos = int(rng.integers(0, ref_len - rlen))
        r = ref[pos:pos + rlen].copy()
        muts = rng.integers(0, rlen, 5)
        r[muts] = (r[muts] + rng.integers(1, 4, 5)) % 4
        reads.append(r)
    reads.append(rng.integers(0, 4, rlen).astype(np.int8))
    return ref, reads


def mesh_pairs(mode: str) -> tuple:
    """The batch pipeline's 4 pairs of 4096^2: random_batch, seed 5 (20
    letters from default_rng(5) for protein)."""
    B, n = MESH_PAIRS
    if mode == "protein":
        rng = np.random.default_rng(5)
        return (rng.integers(0, 20, (B, n)).astype(np.int8),
                rng.integers(0, 20, (B, n)).astype(np.int8))
    return random_batch(B, n, n, seed=5)


def counts() -> dict:
    """Every kernel's launches and every plain version's calls."""
    out = {}
    for mod in (sf, pf, wf):
        for what in MESH_COUNTERS:
            out.update(getattr(mod, what))
    return out


def blocks(m: int, n: int, D: int) -> int:
    """The block rows one pipeline pass of n x m fills on each rank, at
    the default block height."""
    R = pl.default_block_rows(m, n, D)
    return -(-max(n, 1) // R)


def mesh_block_check(mesh) -> tuple:
    """K5 at the pipeline's stages, held against the plain block fill in
    the block's own mode (local or anchored global), every output of every
    block compared: in each scoring a MESH_CHECK pipeline (2048^2, 4 block
    rows of 512, each block's top row handed down) and the mesh1 path's own
    MESH_N^2 pass at the default rows; in linear that pass is the
    traceback's locate, whose anchored reverse pass fills global-mode
    blocks. Returns ({entry: max_abs_err}, line)."""
    errs, parts = {}, []
    fill = pl._Pipe._fill
    modes = set()

    def both(pipe, *args):
        require(pipe.kernel, f"a stage of {pipe.mc} x {pipe.R} runs no K5")
        k = fill(pipe, *args)
        p = sf.stripe_block_plain(*args[:2], pipe.scoring, *args[2:],
                                  local=pipe.local, substitution=pipe.sub,
                                  want_bottom=True)
        name = sf.block_route_name(pipe.scoring, pipe.substitution)
        errs[name] = max([errs.get(name, 0)] + [
            diff(x, y) for x, y in zip(k, p) if x is not None])
        modes.add("local" if pipe.local else "global")
        return k

    m, R = MESH_CHECK
    pl._Pipe._fill = both
    try:
        for mode in MODES:
            sc, S = MODELS[mode][:2]
            t0 = time.perf_counter()
            pl.make_pipeline(mesh, m, m, R, sc, substitution=S)(
                *on_card(*MODELS[mode][3](m, m), dev=mesh.device))
            a, b = MODELS[mode][3](MESH_N, MESH_N)
            if mode == "linear":
                pl.pipeline_locate(a, b, mesh)
            else:
                pl.pipeline_align(a, b, mesh, scoring=sc, substitution=S)
            parts.append(f"{mode} {time.perf_counter() - t0:.1f} s")
    finally:
        pl._Pipe._fill = fill
    require(not any(errs.values()) and modes == {"local", "global"},
            f"K5 != plain at a pipeline stage: {errs}, modes {modes}")
    return errs, (f"{sf.RB_BLOCK_KERNELS['linear']} and its forms at every "
                  f"stage of world-1 pipelines against the plain block "
                  f"fill in the block's mode, every output of every block "
                  f"bit-equal: {m}^2 in {m // R} block rows of {R}, and "
                  f"{MESH_N}^2 at the default rows (linear: the "
                  f"traceback's locate, its local forward and anchored "
                  f"global reverse pass): {', '.join(parts)}")


def mesh_sweep(mesh, at, bt, want: list) -> tuple:
    """The world-1 pipeline at MESH_BIG^2 over SWEEP_ROWS x SWEEP_T (K5's
    threads, tile (8, 4)), min of 2 by CUDA events after a warm-up, each
    point's answer equal to single-card score()'s; single-card score()'s
    K1 beside it. Returns (lines, {(rows, T): ms})."""
    grid = {}
    for R in SWEEP_ROWS:
        for T in SWEEP_T:
            fn = pl.make_pipeline(mesh, MESH_BIG, MESH_BIG, R, SCORING, T=T)
            ms, res = timed_ms(lambda: fn(at, bt), 2)
            require([int(x) for x in res] == want,
                    f"pipeline rows {R} T {T}: {res} != {want}")
            grid[R, T] = ms
    k1_ms, k1 = timed_ms(lambda: sf.stripe_score(at, bt, SCORING), 3)
    require(k1.best.tolist() == want, "score() moved")
    best = min(grid, key=grid.get)
    rows = "; ".join(
        f"rows {R} ({-(-MESH_BIG // R)} blocks): " + ", ".join(
            f"T={T} {grid[R, T]:.2f}" for T in SWEEP_T) for R in SWEEP_ROWS)
    return [f"block_rows x T sweep of the world-1 pipeline at {MESH_BIG}^2 "
            f"linear, ms min of 2 (answers equal to score()): {rows}; "
            f"fastest rows {best[0]} T={best[1]} {grid[best]:.2f} ms; "
            f"single-card score() ({sf.RB_KERNEL}) {k1_ms:.2f} ms"], grid


def drive_mesh1(mesh, dev) -> tuple:
    """The world-1 NCCL mesh's path through the public calls, counted from
    zero: align(mesh=) score-only at MESH_BIG^2 linear and MESH_N^2 DNA
    affine and protein, with traceback at MESH_N^2 linear, the batch
    pipeline on MESH_PAIRS; each against single-card score() / align() /
    batch_score(), computed before the path. Returns (lines, answers for
    mesh4, counts)."""
    want, pairs_want, inputs = {}, {}, {}
    for mode, n in (("linear", MESH_BIG), ("dna_affine", MESH_N),
                    ("protein", MESH_N)):
        sc, S = MODELS[mode][:2]
        a, b = MODELS[mode][3](n, n)
        inputs[mode] = (a, b)
        r = swtpu_torch.align(a, b, sc, traceback=False, substitution=S,
                              device=dev)
        want[mode] = [r.max_score, r.max_i, r.max_j, r.last_cell]
        aa, bb = mesh_pairs(mode)
        pairs_want[mode] = [x.tolist() for x in swtpu_torch.batch_score(
            aa, bb, sc, substitution=S, device=dev)]
    a16, b16 = random_pair(MESH_N, MESH_N, seed=0)
    r16 = swtpu_torch.align(a16, b16, traceback=False, device=dev)
    want["linear16"] = [r16.max_score, r16.max_i, r16.max_j, r16.last_cell]
    pf.reset_counts()                  # every module's counters
    lines, per_pass, expect = [], [], {}
    t0 = time.perf_counter()
    got = {}
    for mode, (a, b) in inputs.items():
        sc, S = MODELS[mode][:2]
        t1 = time.perf_counter()
        r = swtpu_torch.align(a, b, sc, traceback=False, substitution=S,
                              plan="pipeline", mesh=mesh)
        per_pass.append(f"{mode} {len(a)}^2 {time.perf_counter() - t1:.3f}"
                        " s")
        require(r.plan == "pipeline", f"{mode}: plan {r.plan}")
        got[mode] = [r.max_score, r.max_i, r.max_j, r.last_cell]
        name = sf.block_route_name(sc, S)
        expect[name] = expect.get(name, 0) + blocks(len(a), len(b), 1)
    t1 = time.perf_counter()
    rt = swtpu_torch.align(a16, b16, plan="pipeline", mesh=mesh)
    tb_s = time.perf_counter() - t1
    got["linear16"] = [rt.max_score, rt.max_i, rt.max_j, rt.last_cell]
    expect[sf.block_route_name(SCORING, None)] += blocks(MESH_N, MESH_N, 1)
    got_pairs = {}
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        aa, bb = mesh_pairs(mode)
        res = swtpu_torch.batch_score(aa, bb, sc, substitution=S,
                                      plan="pipeline", mesh=mesh)
        got_pairs[mode] = [x.tolist() for x in res]
        name = sf.block_route_name(sc, S)
        expect[name] = expect.get(name, 0) + MESH_PAIRS[0] * blocks(
            MESH_PAIRS[1], MESH_PAIRS[1], 1)
    path_s = time.perf_counter() - t0
    seen = counts()
    # ---- end of the mesh1 path ----
    # the reverse pass of the traceback: its prefix at the default rows
    loc_i, loc_j = rt.max_i, rt.max_j
    expect[sf.block_route_name(SCORING, None)] += blocks(loc_j, loc_i, 1)
    require(got == want, f"pipeline {got} != single-card {want}")
    require(got_pairs == pairs_want,
            f"batch pipeline {got_pairs} != batch_score {pairs_want}")
    require(rescore(rt.aligned_a, rt.aligned_b, SCORING) == rt.max_score,
            "the pipeline traceback's strings do not re-score")
    for name, k in expect.items():
        require(seen[name] == k, f"{name}: {seen[name]} launches, the "
                f"passes fill {k} blocks")
    require(seen[sf.fill_kernel_name(SCORING, None)] == 1
            and seen[sf.WALK_KERNEL] == 1, f"the refill: {seen}")
    require(not any(seen[k] for k in (*sf.plain_calls, *pf.plain_calls,
                                      *wf.plain_calls)),
            f"plain versions ran: {seen}")
    lines.append(
        f"align(mesh=, plan='pipeline') score-only {', '.join(per_pass)} "
        f"(wall), equal to single-card align(traceback=False) {want}; "
        f"with traceback at {MESH_N}^2 {tb_s:.3f} s, strings re-score to "
        f"{rt.max_score}; batch_score(mesh=, plan='pipeline') on "
        f"{MESH_PAIRS[0]} x {MESH_PAIRS[1]}^2 equal to batch_score in every "
        f"scoring; path {path_s:.1f} s, K5 launches {expect} = the blocks "
        "each pass fills (world 1: one block a pass at the default rows)")
    return lines, dict(want=want, pairs=got_pairs), {
        k: v for k, v in seen.items() if v}


def mesh4_rank() -> dict:
    """One of MESH_RANKS gloo ranks sharing the card: the pipeline at
    MESH_N^2 linear, the batch pipeline on MESH_PAIRS, the sharded scorer
    and reducer on BATCH, search(mesh=) of DB (n_best 1 and 2) and
    map_reads(mesh=) on EXAMPLE, in every scoring where it applies, its
    counts from zero."""
    from swtpu_torch.dist import dryrun
    seq, data = dryrun.rank_mesh("seq", MESH_RANKS), \
        dryrun.rank_mesh("data", MESH_RANKS)
    out, walls = {}, {}
    pf.reset_counts()
    t0 = time.perf_counter()
    a, b = random_pair(MESH_N, MESH_N, seed=0)
    r = pl.pipeline_align(a, b, seq)
    out["pipe"] = [int(x) for x in r]
    walls["pipeline"] = time.perf_counter() - t0
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        aa, bb = mesh_pairs(mode)
        out["pairs", mode] = [x.tolist() for x in pl.pipeline_align_batch(
            aa, bb, seq, scoring=sc, substitution=S)[:3]]
        aa, bb = full_batch(mode)
        out["scorer", mode] = [x.tolist() for x in make_sharded_batch_scorer(
            data, sc, substitution=S)(aa, bb)]
        out["best", mode] = [int(x) for x in make_best_hit_reducer(
            data, sc, substitution=S)(aa, bb)]
    walls["batch"] = time.perf_counter() - t0 - walls["pipeline"]
    t1 = time.perf_counter()
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        ref, reads, _ = db_inputs(mode)
        for n_best in (1, 2):
            out["search", mode, n_best] = [
                x.tolist() for x in swtpu_torch.search(
                    reads, ref, mesh=data, scoring=sc, substitution=S,
                    n_best=n_best)]
    walls["search"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    ref, reads = example_set()
    out["map"] = [tuple(x) for x in swtpu_torch.map_reads(
        ref, reads, mesh=data).records]
    walls["map"] = time.perf_counter() - t1
    out["counts"] = {k: v for k, v in counts().items() if v}
    out["walls"] = walls
    return out


def shard_search(reads, ref, sc, S, n_best: int, dev) -> list:
    """The sharded search's answer by single-card searches: each of the
    MESH_RANKS shards (``shard_reference``) searched alone, its positions
    offset, the shards merged on the host in rank order as the ranks
    merge them (n_best 1: max score, min position, its read end; n_best 2:
    the top-2 fold)."""
    B, qlen = reads.shape
    shards, L = db.shard_reference(ref, MESH_RANKS, qlen)
    window = min(SEARCH_WINDOW, shards.shape[1])
    parts = []
    for d in range(MESH_RANKS):
        fn = db.make_searcher(qlen, L, window, sc, substitution=S,
                              n_best=n_best, device=dev)
        h = [x.cpu() for x in fn(reads, shards[d:d + 1])]
        for k in range(0, len(h), 3):         # positions: global, or FAR
            h[k + 1] = torch.where(h[k] > 0, h[k + 1] + d * L,
                                   -1 if n_best == 1 else db._FAR)
        parts.append(h)
    if n_best == 1:
        s = torch.stack([p[0] for p in parts])
        gbs = s.max(0).values
        pos = torch.stack([torch.where((p[0] == gbs) & (gbs > 0), p[1],
                                       db._FAR) for p in parts])
        gbp = pos.min(0).values
        be = torch.stack([torch.where((p[0] == gbs) & (p[1] == gbp), p[2],
                                      0) for p in parts]).max(0).values
        return [gbs.tolist(), torch.where(gbs > 0, gbp, -1).tolist(),
                be.tolist()]
    mind = db._read_lengths(torch.from_numpy(reads))
    z = torch.zeros(B, dtype=torch.int32)
    far = torch.full((B,), db._FAR, dtype=torch.int32)
    c = (z, far, z, z, far, z)
    for p in parts:
        c = db._merge2(c, tuple(p), min_dist=mind)
    s1, p1, e1, s2, p2, e2 = c
    return [x.tolist() for x in (s1, torch.where(s1 > 0, p1, -1), e1, s2,
                                 torch.where(s2 > 0, p2, -1), e2)]


def drive_mesh4(dev, mesh1_out: dict) -> tuple:
    """MESH_RANKS gloo ranks sharing the card (NCCL refuses two ranks a
    card; the halos go through host memory): their answers against the
    world-1 mesh's, single-card batch_score, the single-card searches of
    each shard merged on the host, the unsharded single-card search and
    single-card map_reads. A correctness check: its times say nothing of
    four cards. Returns (lines, counts summed over the ranks)."""
    t0 = time.perf_counter()
    per = dryrun.launch(MESH_RANKS, mesh4_rank, device="cuda",
                        backend="gloo", timeout=600)
    ranks_s = time.perf_counter() - t0
    for r in per[1:]:
        require({k: v for k, v in r.items() if k not in ("counts", "walls")}
                == {k: v for k, v in per[0].items()
                    if k not in ("counts", "walls")},
                "the ranks' answers differ")
    got = per[0]
    want = mesh1_out["want"]["linear16"]
    require(got["pipe"] == want, f"4 ranks {got['pipe']} != world 1 {want}")
    lines = [f"{MESH_RANKS} gloo ranks on one card, spawned and run in "
             f"{ranks_s:.1f} s (walls of rank 0: " + ", ".join(
                 f"{k} {v:.1f} s" for k, v in got["walls"].items())
             + f"); every rank's answers equal; pipeline {MESH_N}^2 "
             f"{got['pipe']} equal to the world-1 mesh's"]
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        require(got["pairs", mode] == mesh1_out["pairs"][mode][:3],
                f"{mode}: the batch pipeline differs from world 1")
        aa, bb = full_batch(mode)
        hits = [x.tolist() for x in swtpu_torch.batch_score(
            aa, bb, sc, substitution=S, device=dev)]
        require(got["scorer", mode] == hits,
                f"{mode}: the sharded scorer != batch_score")
        k = int(np.argmax(hits[0]))
        require(got["best", mode] == [hits[0][k], k, hits[1][k], hits[2][k]],
                f"{mode}: best hit {got['best', mode]}")
    lines.append(f"batch pipeline on {MESH_PAIRS[0]} x {MESH_PAIRS[1]}^2 "
                 f"equal to the world-1 mesh's; sharded scorer and best-hit "
                 f"reducer on {BATCH[0]} x {BATCH[1]}^2 equal to batch_score, "
                 "in every scoring")
    parts = []
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        ref, reads, planted = db_inputs(mode)
        for n_best in (1, 2):
            sharded = got["search", mode, n_best]
            require(sharded == shard_search(reads, ref, sc, S, n_best, dev),
                    f"{mode} n_best={n_best}: != the shards searched alone")
            one = [x.tolist() for x in swtpu_torch.search(
                reads, ref, scoring=sc, substitution=S, n_best=n_best,
                device=dev)]
            require(all([f[i] for f in sharded[:3]] == [f[i] for f in one[:3]]
                        for i in planted),
                    f"{mode} n_best={n_best}: a planted read's hit moved")
            scores = sum(x != y for x, y in zip(sharded[0], one[0]))
            moved = sum([f[i] for f in sharded] != [f[i] for f in one]
                        for i in range(len(reads)))
            parts.append(f"{mode} n_best={n_best}: {scores} scores, {moved} "
                         "hits")
    lines.append(
        f"search(mesh=) of {DB[0]}x{DB[1]} vs {DB[2] // 1000} kb: equal to "
        f"each shard searched alone on the card, merged on the host; every "
        f"planted read's best hit equal to the unsharded single-card "
        f"search's; reads differing from it (the windows lie elsewhere, so "
        f"an alignment longer than the read's window overlap, and a "
        f"window's one candidate for the second locus, differ): "
        + ", ".join(parts))
    ref, reads = example_set()
    one = [tuple(x) for x in swtpu_torch.map_reads(ref, reads,
                                                   device=dev).records]
    # the primary records of the reads drawn from the reference; the one
    # random read's best is a chance alignment, as in the search
    prim = lambda recs: [r[:11] for r in recs
                         if not r[10] and r[0] < EXAMPLE[1]]
    require(prim(got["map"]) == prim(one) and len(got["map"]) == len(one),
            "map_reads(mesh=) primaries != single-card map_reads")
    xs = sum(x != y for x, y in zip(got["map"], one))
    lines.append(f"map_reads(mesh=) on examples/read_mapping.py's set "
                 f"({EXAMPLE[1] + 1} reads of {EXAMPLE[2]} vs "
                 f"{EXAMPLE[0] // 1000} kb): the primary record of every "
                 f"read drawn from the reference equal to single-card "
                 f"map_reads; records differing in any field: {xs}")
    total = {}
    for r in per:
        for k, v in r["counts"].items():
            total[k] = total.get(k, 0) + v
    # every rank fills each block row of its stripe once a pass
    k5 = {sf.block_route_name(*MODELS[mode][:2]): MESH_RANKS * MESH_PAIRS[0]
          * blocks(MESH_PAIRS[1], MESH_PAIRS[1], MESH_RANKS)
          for mode in MODES}
    k5[sf.block_route_name(SCORING, None)] += MESH_RANKS * blocks(
        MESH_N, MESH_N, MESH_RANKS)
    require(all(total.get(k, 0) == v for k, v in k5.items()),
            f"K5 launches {total} != the blocks the passes fill {k5}")
    per_pair = blocks(MESH_PAIRS[1], MESH_PAIRS[1], MESH_RANKS)
    lines.append(f"K5 launches over the ranks {k5} = the blocks each pass "
                 f"fills ({blocks(MESH_N, MESH_N, MESH_RANKS)} block rows "
                 f"a rank at {MESH_N}^2, {per_pair} a pair at "
                 f"{MESH_PAIRS[1]}^2)")
    return lines, total


def run_mesh(dev) -> tuple:
    """The two mesh phases; returns (launches summed over both paths,
    K5's max_abs_err at a stage, the sweep's {(rows, T): ms})."""
    with tempfile.TemporaryDirectory() as tmp:
        msh.initialize(f"file://{tmp}/store", 1, 0, "cuda")
        try:
            mesh = msh.pipeline_mesh(1, device="cuda")
            errs, line = mesh_block_check(mesh)
            phase("mesh1", line)
            lines, out, seen1 = drive_mesh1(mesh, dev)
            for ln in lines:
                phase("mesh1", ln)
            a, b = on_card(*random_pair(MESH_BIG, MESH_BIG, seed=0), dev=dev)
            sweep_lines, grid = mesh_sweep(mesh, a, b,
                                           out["want"]["linear"])
            del a, b
            for ln in sweep_lines:
                phase("mesh1", ln)
        finally:
            dist.destroy_process_group()
    phase("path", f"mesh1 path (world-1 NCCL): kernel launches and plain "
          f"calls {seen1}")
    lines, seen4 = drive_mesh4(dev, out)
    for ln in lines:
        phase("mesh4", ln)
    phase("path", f"mesh4 path ({MESH_RANKS} gloo ranks, summed): kernel "
          f"launches and plain calls {seen4}")
    k5 = [sf.block_route_name(*MODELS[m][:2]) for m in MODES]
    k8 = [pf.pairs_kernel_name(*MODELS[m][:2]) for m in MODES]
    k6 = [*wf.WARP_KERNELS.values()]
    require(all(seen4.get(k, 0) > 0 for k in k5 + k8)
            and any(seen4.get(k, 0) > 0 for k in k6),
            f"mesh4 launches {seen4}")
    require(not any(seen4.get(k, 0) for k in (*sf.plain_calls,
                                              *pf.plain_calls,
                                              *wf.plain_calls)),
            f"plain versions ran on the mesh4 path: {seen4}")
    total = dict(seen1)
    for k, v in seen4.items():
        total[k] = total.get(k, 0) + v
    return total, errs, grid


# ---- the pipeline cost model: predictions against this run's times ----
MODEL_TOLERANCE = 1.25
PROJECTED_SIDES = (MESH_BIG, 1 << 19, 1 << 20)
PROJECTED_CARDS = (2, 4, 8)


def pipeline_model(headline: dict, grid: dict) -> list:
    """The committed cost record's predictions beside this run's own
    times, each within MODEL_TOLERANCE: score() at SCORE_N^2 in each
    scoring (the full-P path's), and the world-1 pipeline at MESH_BIG^2
    at each of SWEEP_ROWS (the sweep's, at K5's default T); then the
    projections on PROJECTED_CARDS cards. No launch. Fails when the
    record does not load on this card, or this machine would project."""
    rec = cost.load_record()
    require(rec is not None, f"{cost.DEFAULT_PIPE_RECORD.name} does not "
            "load on this card (its stamp, or malformed)")
    dev = rec["device"]
    out, worst = [], 1.0

    def held(what: str, pred: float, got: float) -> str:
        nonlocal worst
        r = max(pred / got, got / pred)
        worst = max(worst, r)
        require(r <= MODEL_TOLERANCE, f"{what}: model {pred:.3f} ms, "
                f"measured {got:.3f} ms, {r:.3f}x")
        return f"{pred:.2f}/{got:.2f}"

    parts = []
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        pred = cost.stripe_cost_s(SCORE_N, SCORE_N, sc, S, "score",
                                  record=rec) * 1e3
        parts.append(f"{mode} " + held(f"score() {mode}", pred,
                                       headline[mode]))
    out.append(f"record {cost.DEFAULT_PIPE_RECORD.name} of {dev['name']} "
               f"(capability {dev['capability']}, {dev['power_limit']}, "
               f"{rec['date']}) loads; score() at {SCORE_N}^2, ms model/"
               f"measured: {', '.join(parts)}")
    T = sf.RB_BLOCK_DEFAULTS["linear"][0]
    over = rec["overhead_s"]["linear"]
    parts = []
    for R in SWEEP_ROWS:
        nb = -(-MESH_BIG // R)
        pred = nb * (cost.stripe_cost_s(MESH_BIG, R, SCORING, None, "block",
                                        record=rec) + over) * 1e3
        parts.append(f"{nb} blocks " + held(f"pipeline rows {R}", pred,
                                            grid[R, T]))
    out.append(f"world-1 pipeline at {MESH_BIG}^2 linear, T={T}, ms model "
               f"(blocks x (K5 + {over * 1e6:.1f} us a stage))/measured: "
               f"{', '.join(parts)}; worst {worst:.3f}x of "
               f"{MODEL_TOLERANCE}x")
    parts = []
    for side in PROJECTED_SIDES:
        for D in PROJECTED_CARDS:
            sp, rows = dp.pipeline_projection(side, side, D)
            parts.append(f"{side}^2 D={D} {sp:.2f}x rows {rows}")
    gated = [side for side in PROJECTED_SIDES
             if dp.pipeline_projection(side, side, 8)[0]
             >= dp.PIPE_MIN_SPEEDUP]
    out.append(f"projected speedup over one card (linear): "
               f"{'; '.join(parts)}; the gate (>= {dp.PIPE_MIN_SPEEDUP}x) "
               f"opens at D=8 for {gated or 'none'}")
    # this machine: one card, so no call leaves it
    require(dp.pipeline_devices() == 1
            and dp.choose_exec(1 << 20, 1 << 20).plan != "pipeline",
            "a one-card machine would take the mesh")
    out.append("one card here: pipeline_devices() == 1, choose_exec keeps "
               f"{1 << 20}^2 on the card")
    return out


# ---- the tools path: instrument/, bench_sweep, the examples ----
# the host serial fill checks the sweep's rows up to this many cells (its
# H and P, 5 bytes a cell, in about a second on the card's host); above
# it the one row is the benchmark pair, whose answer is KNOWN
SERIAL_CHECK_CELLS = 3 * 10 ** 8
SWEEPS = (("square", "auto"), ("rect", "auto"), ("square", "stripe"))
PHASE_SIDES = (64, SCORE_N)        # the card's per-call floor; the bench pair
PHASE_REPORTS = 5
TRACE_N = 4096
VALIDATE_N = 4096
GLIBC_SEEDS = (0, 1, 12345)
# each example at its small sizes on the card, and at a cut size on the
# card and on the CPU (the plain versions), whose answers must agree:
# (argv, environment) of each
EXAMPLES = {
    "examples/torch_batch_pairs.py": (([], {}), (["8", "64"], {})),
    "examples/torch_read_mapping.py": (
        ([], {"SWTPU_DEMO_REF": "20000", "SWTPU_DEMO_READS": "50"}),
        ([], {"SWTPU_DEMO_REF": "9600", "SWTPU_DEMO_READS": "10"})),
    "examples/torch_protein_search.py": (
        ([], {}), ([], {"SWTPU_DEMO_DB": "3000",
                        "SWTPU_DEMO_QUERIES": "20"})),
}
MAP_WARM = "scripts/torch_map_warm.py"
# the kernels the tools path must launch: the sweep's and the phase
# reports' K1, validate_model's K1-K4 in each scoring, the batch example's
# K8, the search examples' and the mapping script's warp-per-read K6
TOOLS_KERNELS = (
    *sf.RB_KERNELS.values(), *sf.RB_P_KERNELS.values(),
    pf.pairs_kernel_name(SCORING, None),
    wf.warp_kernel_name(SCORING, None), wf.warp_kernel_name(PROTEIN, BLOSUM62))


def load_script(rel: str):
    """A script of the repository (an example, the mapping benchmark),
    imported as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv: list, env: dict) -> str:
    """``mod.main(argv)`` with ``env`` set around it; its standard output.
    Raises unless main returns 0."""
    import contextlib
    import io
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(rc == 0, f"{mod.__name__}.main({argv}) returned {rc}")
    return buf.getvalue()


def stable_lines(text: str) -> list:
    """An example's output without its timed lines."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("searched ", "(first call"))
            and " cold " not in ln]


def example_references() -> tuple:
    """({script: stable lines}, seconds): each example at its cut size on
    the CPU, the plain versions; run in the reference process, beside
    the kernel phases, on two threads."""
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    out = {}
    for rel, (_, (argv, env)) in EXAMPLES.items():
        out[rel] = stable_lines(run_main(load_script(rel),
                                         argv + ["--device", "cpu"], env))
    return out, time.perf_counter() - t0


def _strict(const):
    raise ValueError(f"not strict JSON: {const}")


def check_sweep(text: str, grid: str, plan: str, serial: dict) -> list:
    """The sweep's records, checked: a backend-init record first (gcups
    0.0), every line strict JSON, the grid's sizes in order, every score
    the host serial fill's (KNOWN at the benchmark pair)."""
    from swtpu_torch import runtime_native as rn
    from swtpu_torch.bench_sweep import _grid
    recs = [json.loads(ln, parse_constant=_strict)
            for ln in text.splitlines()]
    require(recs[0]["name"] == f"backend-init-{grid}"
            and recs[0]["gcups"] == 0.0 and recs[0]["m"] == 0,
            f"first record {recs[0]}")
    require([(r["m"], r["n"]) for r in recs[1:]] == _grid(grid, True),
            f"{grid} sizes {[(r['m'], r['n']) for r in recs[1:]]}")
    for r in recs[1:]:
        m, n, got = r["m"], r["n"], r["extra"]["score"]
        if (m, n) == (SCORE_N, SCORE_N):
            want = KNOWN["linear", m, n][0]
        else:
            require(m * n <= SERIAL_CHECK_CELLS, f"{m}x{n} unchecked")
            if (m, n) not in serial:
                serial[m, n] = int(rn.fill(*random_pair(m, n, seed=0))
                                   .max_score)
            want = serial[m, n]
        require(got == want, f"sweep {grid} {plan} {m}x{n}: {got} != "
                f"{want}")
    return recs


FILL_SPANS = ("swtpu.fill.prep", "swtpu.fill.run", "swtpu.fill.fetch")


def call_floor(side: int, dev) -> str:
    """The card's per-call floor (ROADMAP P3) at side^2: PHASE_REPORTS
    ``score(plan='stripe')`` calls, warm, under ``profiling.trace()``; the
    fill's own spans (the uploads, the launch with its scratch and
    reductions, the fetch), the call's root span and K1's time, all read
    from that one trace on the profiler's clock. Each answer is held to
    the host serial fill's (KNOWN at 25632^2). Returns the phase line."""
    from swtpu_torch import runtime_native as rn
    from swtpu_torch.instrument import profiling
    a, b = random_pair(side, side, seed=0)
    want = (KNOWN["linear", side, side][0] if side == SCORE_N
            else int(rn.fill(a, b).max_score))
    swtpu_torch.score(a, b, plan="stripe", device=dev)
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir, device=dev):
            got = [swtpu_torch.score(a, b, plan="stripe", device=dev)
                   for _ in range(PHASE_REPORTS)]
        with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    profiling.clear()
    require(got == [want] * PHASE_REPORTS,
            f"score() at {side}^2 under trace(): {got} != {want}")
    us = {n: sorted(float(e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] == n)
          for n in ("swtpu.align", *FILL_SPANS)}
    us["K1"] = sorted(float(e["dur"]) for e in events
                      if e.get("cat") == "kernel"
                      and profiling.entry_of(e["name"]) == sf.RB_KERNEL)
    require(all(len(v) == PHASE_REPORTS for v in us.values()),
            f"score() at {side}^2: spans and K1 launches "
            f"{ {k: len(v) for k, v in us.items()} }, not "
            f"{PHASE_REPORTS} each")
    mid = PHASE_REPORTS // 2
    return (f"the fill's spans of {PHASE_REPORTS} score(plan='stripe') "
            f"calls at {side}^2 (= {want}) under trace(), min / median us: "
            + ", ".join(f"{n.removeprefix('swtpu.')} {v[0]:.0f} / "
                        f"{v[mid]:.0f}" for n, v in us.items()))


def drive_tools(dev, ex_cpu: dict) -> list:
    """The tools path on the card: bench_sweep's quick grids (auto on both,
    stripe on the square), the fill's spans of score()'s stripe call at
    64^2 and 25632^2 (``call_floor``), a trace() of a 4096^2 score(),
    validate_model at 4096^2 in each scoring, the three examples (at their
    small sizes, and at the cut sizes against ``ex_cpu``), torch_map_warm
    at full size and reference_random against GlibcRand. Returns phase
    lines."""
    import contextlib
    import io
    from swtpu_torch import bench_sweep
    from swtpu_torch import runtime_native as rn
    from swtpu_torch.core.encode import GlibcRand
    from swtpu_torch.instrument import access, profiling
    lines = []

    t0 = time.perf_counter()
    serial = {}
    for grid, plan in SWEEPS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench_sweep.main(["--grid", grid, "--quick", "--plan", plan])
        require(rc == 0, f"bench_sweep {grid} {plan} returned {rc}")
        recs = check_sweep(buf.getvalue(), grid, plan, serial)
        lines.append(
            f"bench_sweep --grid {grid} --quick --plan {plan}: init "
            f"{recs[0]['extra']['init_s']} s; " + ", ".join(
                f"{r['m']}x{r['n']} {r['plan']} {r['fill_s'] * 1e3:.3f} ms "
                f"({r['gcups']:.2f} GCUPS) = {r['extra']['score']}"
                for r in recs[1:]))
    best = KNOWN["linear", SCORE_N, SCORE_N][0]
    lines.append(f"every row equal to the host serial fill ({len(serial)} "
                 f"sizes) and 25632^2 to {best}, in "
                 f"{time.perf_counter() - t0:.1f} s")

    for side in PHASE_SIDES:
        lines.append(call_floor(side, dev))

    t0 = time.perf_counter()
    a, b = random_pair(TRACE_N, TRACE_N, seed=0)
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir, device=dev) as prof:
            with torch.profiler.record_function("score 4096^2"):
                traced = swtpu_torch.score(a, b, device=dev)
        kernels = profiling.trace_kernels(logdir)
        size = os.path.getsize(os.path.join(logdir, profiling.TRACE_FILE))
    require(kernels.get(sf.RB_KERNEL, 0) >= 1,
            f"the trace names no {sf.RB_KERNEL}: {dict(kernels)}")
    want = int(rn.fill(a, b).max_score)
    require(traced == want, f"traced score() {traced} != the host serial "
            f"fill's {want}")
    dev_us = sum(e.device_time_total for e in prof.key_averages()
                 if "stripe_rb_kernel" in e.key)
    ours = {k: v for k, v in kernels.items() if k.startswith("sw_")}
    lines.append(f"trace() of score() at {TRACE_N}^2 (= {traced}, the "
                 f"host serial fill's): "
                 f"{size} bytes, the port's kernels {ours} "
                 f"beside {sum(kernels.values()) - sum(ours.values())} of "
                 f"torch's (fills, the upload's copy, the reduction), the "
                 f"stripe_rb_kernel's device time {dev_us:.1f} us (key_"
                 f"averages), in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    usage = access.ptxas_usage(_cuda.BUILD.log)
    require(usage, "no ptxas figures: the kernel library was not built "
            "in this process")
    for mode in MODES:
        sc, S = MODELS[mode][:2]
        got = access.validate_model(VALIDATE_N, VALIDATE_N, sc, dev,
                                    substitution=S)
        require(set(got) == {"scan", "scan+P", "stripe", "stripe+P"},
                f"validate_model [{mode}]: {sorted(got)}")
        # every measured call's answer: K1-K3's and K4's best (score, end
        # cell, H[n, m]) and right column the plain sweep's, K4's P the
        # sweep's P
        scan, scan_p, k13, k4 = (got[p][1].result for p in
                                 ("scan", "scan+P", "stripe", "stripe+P"))
        want = sf._pack(scan).tolist()
        p_want = sf.diag_to_rowmajor(scan_p.p_diag, VALIDATE_N, VALIDATE_N)
        for plan, out in (("scan+P", scan_p), ("stripe", k13),
                          ("stripe+P", k4)):
            best = (out.best if plan.startswith("stripe")
                    else sf._pack(out)).tolist()
            e = diff(out.right_col, scan.right_col)
            if plan == "stripe+P":
                e = max(e, diff(out.P, p_want))
            require(best == want and e == 0, f"validate_model [{mode}] "
                    f"{plan}: {best} != the plain sweep's {want}, or its "
                    f"right column or P differs ({e})")
        del scan, scan_p, k13, k4, p_want
        parts = []
        for plan, (model, meas) in got.items():
            parts.append(f"{plan} {model.plan}: P {model.p_bytes}/"
                         f"{meas.output_bytes}, scratch "
                         f"{model.scratch_bytes}/{meas.temp_bytes}")
            if model.p_bytes:
                r = meas.output_bytes / model.p_bytes
                require(0.8 <= r <= 1.25, f"[{mode}] {plan}: output "
                        f"{meas.output_bytes} against P {model.p_bytes}")
            if plan.startswith("stripe"):
                r = meas.temp_bytes / model.scratch_bytes
                require(0.5 <= r <= 2, f"[{mode}] {plan}: temp "
                        f"{meas.temp_bytes} against scratch "
                        f"{model.scratch_bytes}")
                res = access.launched_resident(
                    usage, VALIDATE_N, VALIDATE_N,
                    traceback=plan == "stripe+P", scoring=sc,
                    substitution=S)
                r = res / model.resident_bytes
                require(0.5 <= r <= 2, f"[{mode}] {plan}: resident "
                        f"{model.resident_bytes} against ptxas and the "
                        f"launcher {res}")
                parts[-1] += f", resident {model.resident_bytes}/{res}"
        lines.append(f"validate_model({VALIDATE_N}, {VALIDATE_N}) [{mode}] "
                     f"answers {want}, the four plans equal; "
                     "model/measured bytes: " + "; ".join(parts))
    lines.append(f"validate_model in {time.perf_counter() - t0:.1f} s")

    for rel, ((argv, env), (cut_argv, cut_env)) in EXAMPLES.items():
        t0 = time.perf_counter()
        mod = load_script(rel)
        out = run_main(mod, argv + ["--device", "cuda"], env)
        cut = stable_lines(run_main(mod, cut_argv + ["--device", "cuda"],
                                    cut_env))
        require(cut == ex_cpu[rel], f"{rel} at its cut size: the card's "
                f"{cut} != the CPU's {ex_cpu[rel]}")
        head = " | ".join(out.strip().splitlines()[:3])
        lines.append(f"{rel} ({' '.join(argv) or 'defaults'}"
                     f"{' ' + str(env) if env else ''}): {head} ...; at "
                     f"{' '.join(cut_argv) or str(cut_env)} its "
                     f"{len(cut)} answer lines equal the CPU's; "
                     f"{time.perf_counter() - t0:.1f} s")

    mod = load_script(MAP_WARM)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.json")
        with contextlib.redirect_stdout(io.StringIO()):
            out = mod.main(["--out", path])
        with open(path) as f:
            require(json.loads(f.read()) == out, "torch_map_warm --out")
    require(out["mapped"] >= 0.99 * out["B"], f"torch_map_warm {out}")
    lines.append(f"{MAP_WARM}: {json.dumps(out)}")

    for seed in GLIBC_SEEDS:
        got = rn.reference_random(4096, seed)
        require(np.array_equal(got, GlibcRand(seed).reference_sequence(4096)),
                f"reference_random(4096, {seed}) != GlibcRand({seed})")
    lines.append(f"reference_random(4096, seed) == GlibcRand(seed) for "
                 f"seeds {GLIBC_SEEDS}")
    return lines


def reference_scans() -> tuple:
    """(refs, seconds): independent references for the main paths, numpy
    row scans on the host, each equal to its known value; the banded scan
    first against the plain fill on the CPU at a small pair."""
    t0 = time.perf_counter()
    refs = {}
    for (mode, m, n), known in KNOWN.items():
        sc, S, _, make = MODELS[mode]
        refs[mode, m, n] = row_scan(*make(m, n), sc, S)
        require(refs[mode, m, n] == known, f"row scan {mode} {m}x{n} "
                f"{refs[mode, m, n]} != known {known}")
    n = HIRSCH_AFFINE_N
    refs["dna_affine", n, n] = row_scan(*random_pair(n, n, seed=0),
                                        DNA_AFFINE)
    for mode, (sc, S, _, make) in MODELS.items():
        a, b = _small_pair(mode, 300, 280, 5)
        for band in (0, 3, BAND):
            want = sf.stripe_fill_plain(
                *on_card(a, b, dev=torch.device("cpu")), sc,
                None if S is None else torch.from_numpy(S), band)
            require(list(row_scan(a, b, sc, S, band)) == want.best.tolist(),
                    f"banded row scan {mode} band {band} != plain fill")
        refs[mode, "band", ALIGN_N] = row_scan(*make(ALIGN_N, ALIGN_N), sc,
                                               S, BAND)
    return refs, time.perf_counter() - t0


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    phase("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    # the host's row scans run in a process of their own while the kernel
    # phases run here; a fresh interpreter (spawn) touches no CUDA state
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        return run(dev, name, start, pool, pool.apply_async(reference_scans),
                   pool.apply_async(example_references))
    finally:
        pool.terminate()


def run(dev, name: str, start: float, pool, scans, examples) -> int:
    """The phases and the counted paths; ``scans`` yields the row scans'
    references, ``examples`` the examples' answers on the CPU."""
    t0 = time.perf_counter()
    _cuda.library()
    built = build_line()
    phase("build", f"{_cuda.BUILD.path.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_cuda.BUILD.seconds:.2f} s;"
          f" {built})")
    for prefix in ("warp_", "rb_"):
        new = [x for x in built.split("; ") if x.startswith(prefix)]
        regs = [int(x.split()[1]) for x in new]
        spilled = [x.split()[0] for x in new
                   if "0 bytes spill stores, 0 bytes spill loads" not in x]
        require(new and not spilled, f"{prefix}* spills: {spilled}")
        phase("build", f"{len(new)} {prefix}* instantiations: {min(regs)}-"
              f"{max(regs)} registers, no spills")

    t0 = time.perf_counter()
    recs = kernels_vs_plain(dev)
    for entry, e in rb_vs_plain(dev).items():
        recs[entry]["max_abs_err"] = max(recs[entry]["max_abs_err"], e)
    phase("kernels", f"K1-K4 and the register-blocked K1-K4 against their "
          f"plain versions in {time.perf_counter() - t0:.1f} s")
    band_recs, band_lines = band_vs_plain(dev)
    recs.update(band_recs)
    for line in band_lines:
        phase("kernels", line)
    block_err = block_vs_plain(dev)
    for entry, e in rows_vs_plain(dev).items():
        block_err[entry] = max(block_err[entry], e)
    walk_err = walk_vs_plain(dev)
    for mode in MODES:
        lean_recs, lines = lean_parts(mode, dev)
        for entry, rec in lean_recs.items():
            if entry in walk_err:
                if mode != "linear":    # the benchmark pair's walk
                    continue
                rec["max_abs_err"] = max(rec["max_abs_err"], walk_err[entry])
            else:
                rec["max_abs_err"] = max(rec["max_abs_err"], block_err[entry])
            recs[entry] = rec
        for line in lines:
            phase(mode, line)
    pair_err = pairs_vs_plain(dev)
    batch_recs, batch_want, batch_want_band = pairs_full(dev)
    for entry, rec in batch_recs.items():
        rec["max_abs_err"] = max(rec["max_abs_err"], pair_err[entry])
    recs.update(batch_recs)
    batch_want_no_fit, lines = no_fit_batch(dev)
    for line in lines:
        phase("batch", line)
    phase("batch", bucket_kernels(dev))
    pack_recs, lines = pack_vs_plain(dev)
    recs.update(pack_recs)
    for line in lines:
        phase("batch", line)
    recs.update(window_vs_plain(dev))
    window_recs, lines = window_rb_vs_plain(dev)
    recs.update(window_recs)
    for line in lines:
        phase("kernels", line)
    t0 = time.perf_counter()
    debug_err = debug_vs_plain(dev)
    for entry, rec in debug_records(dev).items():
        rec["max_abs_err"] = max(rec["max_abs_err"], debug_err[entry])
        recs[entry] = rec
    phase("kernels", f"K9 against its plain capture in "
          f"{time.perf_counter() - t0:.1f} s")

    refs, ref_s = scans.get()
    ex_cpu, ex_s = examples.get()
    pool.close()
    pool.join()
    phase("reference", f"numpy row scans of {len(refs)} pairs in "
          f"{ref_s:.1f} s (in a process of their own, beside the kernel "
          f"phases), equal to the known values {refs}; the examples at "
          f"their cut sizes on the CPU in {ex_s:.1f} s there")

    # ---- the host tiers and the dispatch layer (no counted path) ----
    t0 = time.perf_counter()
    for ln in drive_dispatch(dev):
        phase("dispatch", ln)
    phase("dispatch", f"dispatch phase in {time.perf_counter() - t0:.1f} s")

    # ---- the full-P path: public calls only, counted from zero ----
    sf.reset_counts()
    # the golden pair is far below host_max_cells: pinned to the kernels
    r = swtpu_torch.align(swtpu_torch.BUILTIN_A, swtpu_torch.BUILTIN_B,
                          plan="stripe", device="cuda")
    require((r.max_score, r.max_pos, r.last_cell) == (13, 69, 7)
            and (r.aligned_a, r.aligned_b) == ("GTT-AC", "GTTGAC"),
            f"golden: {r}")
    golden_fill = sf.fill_kernel_name(SCORING, None)
    require(sf.launches[golden_fill] == 1, "golden did not run K4")
    phase("golden", f"13 @ 69, last 7, {r.aligned_a}/{r.aligned_b} via "
          f"{golden_fill}")

    headline = {}
    line, headline["linear"] = drive("linear", refs)
    m, n = THIN
    thin = swtpu_torch.score(*random_pair(m, n, seed=0), device="cuda")
    require(thin == refs["linear", *THIN][0], f"score {m}x{n}: {thin}")
    phase("linear", f"{line}; {m}x{n} transposed -> {thin}")
    for mode in ("dna_affine", "protein"):
        line, headline[mode] = drive(mode, refs)
        phase(mode, line)

    launches = dict(sf.launches)
    plain = dict(sf.plain_calls)
    # ---- end of the full-P path ----
    # score() runs the register-blocked K1, K2 or K3, align() its K4; the
    # earlier unbanded K1-K4 and K5 are on no route of the package
    full_p = [sf.score_kernel_name(*MODELS[mode][:2]) for mode in MODES] + [
        sf.fill_kernel_name(*MODELS[mode][:2]) for mode in MODES]
    require(all(launches[k] > 0 for k in full_p), f"launches {launches}")
    require(not any(launches[k] for k in EARLIER),
            f"the earlier K1-K5 ran on the full-P path: {launches}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    phase("path", f"full-P path: kernel launches {launches}, plain calls "
          f"{plain}")

    # ---- the lean and banded path: public calls only, from zero ----
    sf.reset_counts()
    t0 = time.perf_counter()
    lines = drive_lean(refs)
    lean_s = time.perf_counter() - t0
    lean = dict(sf.launches)
    plain = dict(sf.plain_calls)
    # ---- end of the lean and banded path ----
    for ln in lines:
        phase("lean", ln)
    lean_path = [n for n in sf.launches if n not in EARLIER]
    require(all(lean[k] > 0 for k in lean_path), f"launches {lean}")
    require(not any(lean[k] for k in EARLIER),
            f"the earlier K1-K5 ran on the lean path: {lean}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    phase("path", f"lean and banded path in {lean_s:.1f} s: kernel "
          f"launches {lean}, plain calls {plain}")

    # ---- the batch path: public calls only, from zero ----
    pf.reset_counts()
    t0 = time.perf_counter()
    lines, hits, many_s = drive_batch(batch_want, batch_want_band,
                                      batch_want_no_fit, dev)
    batch_s = time.perf_counter() - t0
    batch = {**sf.launches, **pf.launches, **pk.launches}
    plain = {**sf.plain_calls, **pf.plain_calls, **pk.plain_calls}
    # ---- end of the batch path ----
    for ln in lines:
        phase("batch", ln)
    require(all(batch[k] > 0 for k in (*pf.launches, *pk.launches)
                if k not in EARLIER_PAIRS)
            and not any(batch[k] for k in EARLIER_PAIRS),
            f"launches {batch}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    phase("path", f"batch path in {batch_s:.1f} s: kernel launches "
          f"{ {k: v for k, v in batch.items() if v} }, plain calls {plain}")
    a_list, b_list = mixed_set()
    t0 = time.perf_counter()
    per = [swtpu_torch.score(a, b, device="cuda")
           for a, b in zip(a_list, b_list)]
    per_s = time.perf_counter() - t0
    ends = [swtpu_torch.align(a, b, traceback=False, device="cuda")
            for a, b in zip(a_list, b_list)]
    require(hits.scores.tolist() == per
            == [r.max_score for r in ends]
            and hits.max_i.tolist() == [r.max_i for r in ends]
            and hits.max_j.tolist() == [r.max_j for r in ends],
            f"score_many {hits} != per-pair score() {per}")
    phase("batch", f"score_many on the {len(per)} mixed pairs equals "
          f"per-pair score() and align(traceback=False): {per}; wall "
          f"score_many {many_s:.3f} s, {len(per)} x score() {per_s:.3f} s")

    # ---- the search path: public calls only, from zero ----
    pf.reset_counts()
    t0 = time.perf_counter()
    lines, _ = drive_search(dev)
    search_s = time.perf_counter() - t0
    search = {**sf.launches, **pf.launches, **pk.launches, **wf.launches}
    plain = {**sf.plain_calls, **pf.plain_calls, **pk.plain_calls,
             **wf.plain_calls}
    # ---- end of the search path ----
    for ln in lines:
        phase("search", ln)
    # reads of 150 and 152 rows take the warp-per-read K6, reads of 600 and
    # 5000 rows the register-blocked one; the template's K6 is on no path
    require(all(search[k] > 0 for k in (*wf.WARP_KERNELS.values(),
                                        *wf.WINDOW_RB_KERNELS.values()))
            and not any(search[k] for k in wf.WINDOW_KERNELS.values()),
            f"launches {search}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    phase("path", f"search path in {search_s:.1f} s: kernel launches "
          f"{ {k: v for k, v in search.items() if v} }, plain calls {plain}")

    # ---- the sanitize path: public calls only, from zero ----
    pf.reset_counts()
    t0 = time.perf_counter()
    lines = drive_sanitize(dev)
    sanitize_s = time.perf_counter() - t0
    sanitize = {**sf.launches, **pf.launches, **pk.launches, **wf.launches,
                **df.launches, **df.rb_launches, **df.packed_rb_launches}
    plain = {**sf.plain_calls, **pf.plain_calls, **pk.plain_calls,
             **wf.plain_calls, **df.plain_calls, **df.rb_plain_calls,
             **df.packed_rb_plain_calls}
    # ---- end of the sanitize path ----
    for ln in lines:
        phase("sanitize", ln)
    # sanitize() runs the register-blocked K9 alone, sanitize_pairs_packed
    # the register-blocked packed one and K7's packed form; the template's
    # K9 (single-pair and packed) and K7 are on no path
    require(all(sanitize[k] > 0 for k in (
        *df.rb_launches, *df.packed_rb_launches,
        *(pf.packed_kernel_name(*MODELS[mode][:2]) for mode in MODES)))
            and not any(sanitize[k] for k in (*df.launches,
                                              *pf.PACKED_KERNELS.values())),
            f"launches {sanitize}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    phase("path", f"sanitize path in {sanitize_s:.1f} s: kernel launches "
          f"{ {k: v for k, v in sanitize.items() if v} }, plain calls "
          f"{plain}")

    # ---- the tools path: instrument/, bench_sweep, the examples, from
    # zero ----
    pf.reset_counts()
    t0 = time.perf_counter()
    lines = drive_tools(dev, ex_cpu)
    tools_s = time.perf_counter() - t0
    tools = {**sf.launches, **pf.launches, **pk.launches, **wf.launches,
             **df.launches, **df.rb_launches, **df.packed_rb_launches}
    plain = {**sf.plain_calls, **pf.plain_calls, **pk.plain_calls,
             **wf.plain_calls, **df.plain_calls, **df.rb_plain_calls,
             **df.packed_rb_plain_calls}
    # ---- end of the tools path ----
    for ln in lines:
        phase("tools", ln)
    require(all(tools[k] > 0 for k in TOOLS_KERNELS)
            and not any(tools[k] for k in (*EARLIER, *EARLIER_PAIRS,
                                           *wf.WINDOW_KERNELS.values(),
                                           *df.launches)),
            f"launches {tools}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    phase("path", f"tools path in {tools_s:.1f} s: kernel launches "
          f"{ {k: v for k, v in tools.items() if v} }, plain calls {plain}")

    # ---- the mesh paths: world-1 NCCL, then four gloo ranks ----
    t0 = time.perf_counter()
    mesh_seen, k5_err, grid = run_mesh(dev)
    for entry, e in k5_err.items():
        recs[entry]["max_abs_err"] = max(recs[entry]["max_abs_err"], e)
    phase("mesh", f"mesh1 and mesh4 in {time.perf_counter() - t0:.1f} s")
    for ln in pipeline_model(headline, grid):
        phase("pipeline_model", ln)

    # launches: the eight paths' runs (the tools path's K1-K4, K8 and K6
    # among them); the K7/K8/K8[band] counters run on
    # the batch path (K7 also on the sanitize path), the K6 counters (warp
    # per read, and above 512 rows the register-blocked) on the search path
    # alone, the K9 counters on the sanitize path alone; the earlier
    # unbanded K1-K4, K5, K6, K7, K8, K8[band] and K9 (single-pair and
    # packed) entries count 0 (their times are the A/B's)
    kernels = [dict(name=k, route="cuda", source=origin(k)[0],
                    replaces=origin(k)[1],
                    launches=(launches.get(k, 0) + lean.get(k, 0)
                              + batch.get(k, 0) + search.get(k, 0)
                              + sanitize[k] + tools[k]
                              + mesh_seen.get(k, 0)),
                    **recs[k])
               for k in sanitize]
    phase("done", f"all phases in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
