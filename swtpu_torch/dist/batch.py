"""Batched scoring and alignment of many pairs on one device.

Counterpart of ``swtpu.dist.batch``: ``batch_score`` for B pairs of one
shape, ``score_many`` for pairs of any shapes (padded into power-of-two
buckets, one ``batch_score`` per bucket), and ``batch_align`` /
``align_many``, which add alignment strings for the best pairs by one
``align()`` each. Each takes ``device``, 'cuda' by default, and raises
without a card; it never carries on on the CPU.

Plans of ``batch_score``: 'stripe' (K8, the pair grid), 'packed' (K7,
packed pairs), 'scan' (the plain batched sweep) and 'auto'. On a card
'auto' runs K8 (``auto_plan``), and only the kernels: a scoring they do
not take raises ValueError there, as the lean traceback does, and the
plain sweep runs on a card only when asked for by ``plan='scan'``. On the
CPU every plan runs the sweep. Not ported yet: the native host tier
(``plan='host-simd'``) and the multi-device pipeline (``mesh=``,
``plan='pipeline'``), which raise ValueError, and the sharded scorer and
best-hit reducer.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core.config import EngineConfig, Scoring
from ..core.substitution import check_table
from ..engine.align import align, resolve_device
from ..kernels.pairs_fill import (BatchHits, pairs_packed_score,
                                  pairs_score, pairs_score_plain)
from ..kernels.stripe_fill import kernels_take

PLANS = ("auto", "stripe", "packed", "scan")

__all__ = ["BatchHits", "batch_score", "score_many", "batch_align",
           "align_many"]


def auto_plan(n: int, band: Optional[int], A: int = 0) -> str:
    """The kernel 'auto' runs on a card for pairs of n target rows (a band
    of ``band``, an alphabet of A letters): K8 ('stripe') for every batch.
    Unbanded, K8 is the register-blocked batch form, which beat K7 in
    turns even where a stripe height cuts K7's chain at every pair's first
    row (``chain_cutting_rows``), in every scoring; banded, K8 is its band
    form (K8[band]), each pair's stripes visiting only the columns their
    rows' band reaches, which beat the template's banded instantiation in
    turns in every scoring (at 64 x 1056^2 band 64, about 0.5 ms against
    1.2). From chip_smoke.py's times on an NVIDIA H100 80GB HBM3 at 700 W
    (PERF.md, section 6), in turns: at 64 x 1056^2 K8 took 0.344 / 0.385
    / 0.369 ms (linear / DNA affine / BLOSUM62 affine) against K7's
    (T=352) 0.963 / 1.021 / 1.080 ms; on the 16 x 16384^2 bucket of the
    mixed pairs 5.941 ms against 24.600; at 64 x 1000^2, where no T cuts
    K7's chain, 0.297 ms against K7's 18.142. No threshold of the JAX
    package's TPU routing carries over."""
    return "stripe"


def _require_kernels(dev: torch.device, scoring: Scoring, substitution,
                     what: str, hint: str, m: int = 1, n: int = 1) -> None:
    """On a card the batch path runs the kernels and never their plain
    version: a scoring or an m x n shape they do not take
    (``kernels_take``: non-negative penalties, or non-negative gaps with a
    table) raises there."""
    if dev.type == "cuda" and not kernels_take(m, n, scoring, substitution):
        raise ValueError(
            f"{what} on a CUDA device runs only the kernels, which do not "
            f"take {scoring} at {m} x {n} (they need a negative mismatch "
            "and negative gaps, or negative gaps with a substitution "
            f"table); {hint}")


def _check_plan(plan: str, band: Optional[int], mesh) -> None:
    if mesh is not None or plan == "pipeline":
        raise ValueError("mesh= and plan='pipeline' (the multi-device "
                         "pipeline) are not ported yet")
    if plan == "host-simd":
        raise ValueError("plan='host-simd' (the native host SIMD tier) is "
                         "not ported yet")
    if plan not in PLANS:
        raise ValueError(f"unknown plan {plan!r} (use one of {PLANS})")
    if band is not None and plan in ("stripe", "packed"):
        raise ValueError(f"plan={plan!r} batch scoring does not support "
                         "band; use plan='auto' or 'scan' for banded "
                         "batches")


def _codes(x, dev: torch.device) -> torch.Tensor:
    """A batch of codes as an int8 tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int8)
    return torch.from_numpy(np.ascontiguousarray(x, np.int8)).to(dev)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(np.int8, copy=False)
    return np.asarray(x, np.int8)


def batch_score(a_batch, b_batch, scoring: Scoring = Scoring(),
                band: Optional[int] = None, plan: str = "auto",
                mesh=None, substitution=None,
                device: Union[str, torch.device] = "cuda") -> BatchHits:
    """Score B pairs of one shape: a_batch (B, m) against b_batch (B, n)
    codes (numpy or torch). ``substitution``: an (A, A) table S[a_code,
    b_code], or None. Returns ``BatchHits`` of (B,) int32 tensors on
    ``device``: each pair's max score and its first row-major end cell,
    bit-equal to the JAX package's."""
    _check_plan(plan, band, mesh)
    dev = resolve_device(device)
    a, b = _codes(a_batch, dev), _codes(b_batch, dev)
    sub_np = None if substitution is None else check_table(substitution)
    sub = None if sub_np is None else torch.from_numpy(sub_np).to(dev)
    if plan == "auto" and dev.type == "cuda":
        _require_kernels(dev, scoring, sub_np, "batch_score(plan='auto')",
                         "pass plan='scan' for the plain sweep on the card, "
                         "or device='cpu'", a.shape[-1], b.shape[-1])
        plan = auto_plan(b.shape[-1], band,
                         0 if sub_np is None else sub_np.shape[0])
    if plan == "stripe":
        return pairs_score(a, b, scoring, substitution=sub, band=band)
    if plan == "packed":
        return pairs_packed_score(a, b, scoring, substitution=sub)
    return pairs_score_plain(a, b, scoring, sub, band)


def _bucket_len(x: int) -> int:
    """Next power of two (min 16): pairs of many shapes land in ~log2
    shape buckets, one ``batch_score`` each."""
    return max(16, 1 << (x - 1).bit_length())


def _pad_exact(scoring: Scoring, substitution) -> bool:
    """Is trailing sentinel padding provably score- and
    position-preserving? a pads with -3, b with -2, so a sentinel never
    meets an equal one: every cell involving padding scores a mismatch or
    the table's strongly negative sentinel score; with negative gaps the
    padded region never rises above the zero floor, and padding cells come
    after every real cell of their row in row-major order, so the first
    max is unchanged."""
    if scoring.is_affine:
        gaps = scoring.gap_open < 0 and scoring.gap_extend < 0
    else:
        gaps = scoring.gap < 0
    if substitution is not None:
        return gaps
    return gaps and scoring.mismatch < 0


def score_many(a_list, b_list, scoring: Scoring = Scoring(),
               substitution=None, plan: str = "auto", mesh=None,
               device: Union[str, torch.device] = "cuda") -> BatchHits:
    """Exact scoring of pairs of any shapes: each pair is padded into its
    power-of-two shape bucket (exact, see ``_pad_exact``) and each bucket
    runs one ``batch_score``. A scoring whose padding is not provably exact
    runs one plain ``align(traceback=False)`` per pair: on the CPU, or on
    a card when ``plan='scan'`` asks for the plain sweep (such a scoring is
    one the kernels do not take, so it raises on a card otherwise). Empty
    operands score (0, 0, 0). Returns ``BatchHits`` of int32 CPU tensors in
    input order; positions are 1-based in each pair's own matrix."""
    B = len(a_list)
    if len(b_list) != B:
        raise ValueError(f"{B} a-sequences vs {len(b_list)} b-sequences")
    _check_plan(plan, None, mesh)
    dev = resolve_device(device)
    out = np.zeros((3, B), np.int32)
    if not _pad_exact(scoring, substitution):
        if plan != "scan":
            _require_kernels(dev, scoring, substitution, "score_many",
                             "pass plan='scan' for the plain sweep on the "
                             "card, or device='cpu'")
        for k in range(B):
            res = align(_host(a_list[k]), _host(b_list[k]), scoring,
                        traceback=False, plan="scan",
                        substitution=substitution, device=dev)
            out[:, k] = res.max_score, res.max_i, res.max_j
        return BatchHits(*torch.from_numpy(out))
    buckets: dict = {}
    for k in range(B):
        m, n = len(a_list[k]), len(b_list[k])
        if m == 0 or n == 0:
            continue          # empty operand: all-zero matrix
        buckets.setdefault((_bucket_len(m), _bucket_len(n)), []).append(k)
    for (mb, nb), idx in sorted(buckets.items()):
        aa = np.full((len(idx), mb), -3, np.int8)
        bb = np.full((len(idx), nb), -2, np.int8)
        for r, k in enumerate(idx):
            aa[r, :len(a_list[k])] = _host(a_list[k])
            bb[r, :len(b_list[k])] = _host(b_list[k])
        hits = batch_score(aa, bb, scoring, plan=plan,
                           substitution=substitution, device=dev)
        out[:, idx] = torch.stack(list(hits)).cpu().numpy()
    return BatchHits(*torch.from_numpy(out))


def _align_best(hits: BatchHits, pair, scoring: Scoring, config: EngineConfig,
                substitution, alphabet: Optional[str], top: Optional[int],
                dev: torch.device) -> list:
    """(index, Alignment) of the pairs with a positive score, best first,
    ties by index, at most ``top``: one ``align()`` each, its score held
    against the batch's."""
    scores = hits.scores.tolist()
    order = sorted((i for i, s in enumerate(scores) if s > 0),
                   key=lambda i: (-scores[i], i))
    if top is not None:
        order = order[:top]
    kw = {} if alphabet is None else {"alphabet": alphabet}
    out = []
    for i in order:
        a, b = pair(i)
        res = align(a, b, scoring, config, traceback=True,
                    substitution=substitution, device=dev, **kw)
        if res.max_score != scores[i]:
            raise AssertionError(f"pair {i}: batch score {scores[i]} != "
                                 f"re-aligned {res.max_score}")
        out.append((i, res))
    return out


def batch_align(a_batch, b_batch, scoring: Scoring = Scoring(),
                band: Optional[int] = None, plan: str = "auto", mesh=None,
                substitution=None, alphabet: Optional[str] = None,
                top: Optional[int] = None,
                device: Union[str, torch.device] = "cuda") -> list:
    """``batch_score`` for every pair, then alignment strings for the
    pairs with a positive score, best first (ties by index); ``top``
    limits how many are aligned. Returns a list of (pair index,
    Alignment). On a card a scoring the kernels do not take raises
    ValueError, whatever the plan: each pair's ``align()`` would run the
    plain fill there."""
    _require_kernels(resolve_device(device), scoring, substitution,
                     "batch_align", "run it with device='cpu'")
    hits = batch_score(a_batch, b_batch, scoring, band=band, plan=plan,
                       mesh=mesh, substitution=substitution, device=device)
    a_np, b_np = _host(a_batch), _host(b_batch)
    return _align_best(hits, lambda i: (a_np[i], b_np[i]), scoring,
                       EngineConfig(band=band), substitution, alphabet, top,
                       resolve_device(device))


def align_many(a_list, b_list, scoring: Scoring = Scoring(),
               substitution=None, plan: str = "auto", mesh=None,
               alphabet: Optional[str] = None, top: Optional[int] = None,
               device: Union[str, torch.device] = "cuda") -> list:
    """``batch_align`` for pairs of any shapes: one ``score_many`` for
    every score, then alignment strings for the best pairs, exactly
    ``batch_align``'s contract (a scoring the kernels do not take raises
    on a card)."""
    _require_kernels(resolve_device(device), scoring, substitution,
                     "align_many", "run it with device='cpu'")
    hits = score_many(a_list, b_list, scoring, substitution=substitution,
                      plan=plan, mesh=mesh, device=device)
    return _align_best(hits, lambda i: (_host(a_list[i]), _host(b_list[i])),
                       scoring, EngineConfig(), substitution, alphabet, top,
                       resolve_device(device))
