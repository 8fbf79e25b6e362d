"""Batched scoring and alignment of many pairs, on one device or a mesh.

Counterpart of ``swtpu.dist.batch``: ``batch_score`` for B pairs of one
shape, ``score_many`` for pairs of any shapes (padded into power-of-two
buckets, one ``batch_score`` per bucket), and ``batch_align`` /
``align_many``, which add alignment strings for the best pairs by one
``align()`` each. Each takes ``device``, 'cuda' by default, and raises
without a card; it never carries on on the CPU.

Plans of ``batch_score``: 'stripe' (K8, the pair grid), 'packed' (K7,
packed pairs), 'scan' (the plain batched sweep), 'host-simd' (the striped
SIMD fill on the host, ``runtime_native.score_simd_batch``, OpenMP across
the pairs, its answers moved to ``device``), 'pipeline' (with ``mesh=``:
the bubble-filled column-stripe pipeline, ``dist.pipeline``) and 'auto'.
On a card 'auto' runs K8 (``auto_plan``) where the kernels take the
scoring, and the plain sweep on the card where they do not, decided
before any launch (``dispatch.plan.runs_kernels``), as the JAX package
runs its scan there; on the CPU every plan but 'host-simd' runs the
sweep. 'auto' never takes 'host-simd', as the JAX package's does not on
a TPU. 'host-simd' raises ValueError with a mesh, with a band, or where
the SIMD fill refuses the problem (``simd_reject_reason``). With a mesh,
pairs wider than the kernels' MAX_WIDTH, or ``plan='pipeline'``, take the
pipeline across the mesh axis; otherwise the mesh's device serves the
call.

``batch_align`` and ``align_many`` re-align each chosen pair with the
default ``EngineConfig``, whose ``host_max_cells`` is the card machine's
measured crossover (``core.config.HOST_MAX_CELLS``, 192^2), where the JAX
package raises it to 2^20: on a card a pair that small runs the native
serial fill and the host walk rather than a launch and the copy of P, and
a larger one K4, since above ~192^2 to 256^2 the serial fill and its walk
lose to the card's full-P ``align()`` (PERF.md section 6).

Across a mesh (every rank calls with the same arguments):
``make_sharded_batch_scorer`` scores each rank's slice of the batch with
``batch_score`` (K8 on a card) and all-gathers the (B,) results;
``make_best_hit_reducer`` merges each rank's best pair into the global
one with a max, two mins and two sums.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import runtime_native as rn
from ..core.config import EngineConfig, Scoring
from ..core.substitution import check_table
from ..dispatch.plan import runs_kernels
from ..engine.align import align, resolve_device
from ..instrument import profiling
from ..kernels.pack_rows import pack_rows
from ..kernels.pairs_fill import (BatchHits, pairs_packed_score,
                                  pairs_score, pairs_score_plain)
from ..kernels.stripe_fill import MAX_WIDTH
from .mesh import all_gather, all_reduce, check_mesh, first_axis

PLANS = ("auto", "stripe", "packed", "scan", "host-simd", "pipeline")
__all__ = ["BatchHits", "BestHit", "batch_score", "score_many",
           "batch_align", "align_many", "make_sharded_batch_scorer",
           "make_best_hit_reducer"]


class BestHit(NamedTuple):
    score: torch.Tensor    # () int32 best score over the whole batch
    pair: torch.Tensor     # () int32 index of the first best pair
    max_i: torch.Tensor    # () int32
    max_j: torch.Tensor    # () int32


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
    / 0.369 ms (linear / DNA affine / BLOSUM62 affine) against the
    stripe template's K7 (T=352) 0.963 / 1.021 / 1.080 ms; on the 16 x
    16384^2 bucket of the mixed pairs 5.941 ms against 24.600; at 64 x
    1000^2, where no T cuts that K7's chain, 0.297 ms against 18.142. K7's
    register-blocked packed form, at K8's own geometry there, stays 7-11 %
    above K8 (0.376 / 0.414 / 0.413 against 0.347 / 0.388 / 0.371 ms at
    64 x 1056^2). No threshold of the JAX package's TPU routing carries
    over."""
    return "stripe"


def _check_plan(plan: str, band: Optional[int]) -> None:
    if plan not in PLANS:
        raise ValueError(f"unknown plan {plan!r} (use one of {PLANS})")
    if band is not None and plan in ("stripe", "packed"):
        raise ValueError(f"plan={plan!r} batch scoring does not support "
                         "band; use plan='auto' or 'scan' for banded "
                         "batches")


def _device(mesh, device) -> torch.device:
    """The mesh's device when there is a mesh, else ``device``."""
    if mesh is not None:
        return check_mesh(mesh).device
    return resolve_device(device)


def _codes(x, dev: torch.device) -> torch.Tensor:
    """A batch of codes as an int8 tensor on ``dev``; codes in host memory
    count as ``h2d_bytes``, copied where ``dev`` is a card."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu":
            profiling.count("h2d_bytes", x.numel())
        return x.to(device=dev, dtype=torch.int8)
    x = np.ascontiguousarray(x, np.int8)
    profiling.count("h2d_bytes", x.nbytes)
    return torch.from_numpy(x).to(dev)


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
    ``device`` (with a mesh, its device): each pair's max score and its
    first row-major end cell, bit-equal to the JAX package's."""
    return _batch_score(a_batch, b_batch, scoring, band, plan, mesh,
                        substitution, device, built=False)


def _batch_score(a_batch, b_batch, scoring: Scoring, band, plan: str, mesh,
                 substitution, device, built: bool) -> BatchHits:
    """``batch_score``; ``built``: the batches are int8 tensors already on
    the call's device, built there from an upload counted as it was made
    (``score_many``'s buckets), so not counted again."""
    _check_plan(plan, band)
    if plan == "host-simd":
        return _host_simd(a_batch, b_batch, scoring, band, mesh,
                          substitution, device)
    dev = _device(mesh, device)
    m = np.shape(a_batch)[-1]
    if mesh is not None and band is None \
            and (m > MAX_WIDTH or plan == "pipeline"):
        # block rows: the projection over the mesh's cards where it has
        # any (pipeline.block_rows_for), else the default rule
        from .pipeline import pipeline_align_batch
        res = pipeline_align_batch(_host(a_batch), _host(b_batch), mesh,
                                   scoring=scoring,
                                   substitution=substitution)
        return BatchHits(res.scores, res.max_i, res.max_j)
    if plan == "pipeline":
        plan = "auto"               # no mesh: the single-device plans
    a, b = ((a_batch, b_batch) if built
            else (_codes(a_batch, dev), _codes(b_batch, dev)))
    sub_np = None if substitution is None else check_table(substitution)
    sub = None if sub_np is None else torch.from_numpy(sub_np).to(dev)
    if plan == "auto":
        plan = (auto_plan(b.shape[-1], band,
                          0 if sub_np is None else sub_np.shape[0])
                if runs_kernels(dev, scoring, sub_np, a.shape[-1],
                                b.shape[-1]) else "scan")
    if plan == "stripe":
        return pairs_score(a, b, scoring, substitution=sub, band=band)
    if plan == "packed":
        return pairs_packed_score(a, b, scoring, substitution=sub)
    return pairs_score_plain(a, b, scoring, sub, band)


def _host_simd(a_batch, b_batch, scoring: Scoring, band, mesh, substitution,
               device) -> BatchHits:
    """``batch_score(plan='host-simd')``: the SIMD fill on the host, its
    (B,) answers moved to ``device``. A forced host tier runs or raises:
    with a mesh, with a band, or where the fill refuses the problem."""
    if mesh is not None:
        raise ValueError("plan='host-simd' batch scoring runs on the host; "
                         "it cannot be combined with a device mesh")
    if band is not None:
        raise ValueError("plan='host-simd' batch scoring does not support "
                         "band; use plan='auto' or 'scan' for banded "
                         "batches")
    dev = resolve_device(device)
    a, b = _host(a_batch), _host(b_batch)
    sub_np = None if substitution is None else check_table(substitution)
    got = rn.score_simd_batch(a, b, scoring, sub_np)
    if got is None:
        raise ValueError(
            "plan='host-simd' was forced but the host SIMD tier is "
            "ineligible for this problem: " + rn.simd_reject_reason(
                a.shape[-1], b.shape[-1], scoring, sub_np))
    return BatchHits(*(torch.from_numpy(x).to(dev) for x in got))


def make_sharded_batch_scorer(mesh, scoring: Scoring = Scoring(),
                              band: Optional[int] = None,
                              axis: Optional[str] = None, substitution=None):
    """fn((B, m) codes, (B, n) codes) -> BatchHits, the batch sharded over
    ``axis`` (default: the mesh's first): rank d scores rows [d B/D, (d +
    1) B/D) with ``batch_score`` on its device (K8 on a card), and one
    all-gather hands every rank the (B,) results. B must divide by the
    axis size (pad the batch)."""
    check_mesh(mesh)
    axis = first_axis(mesh) if axis is None else axis
    D = mesh.shape[axis]

    def fn(a_batch, b_batch) -> BatchHits:
        B = len(a_batch)
        if B % D:
            raise ValueError(f"B={B} pairs must divide across {D} ranks")
        lo = mesh.index(axis) * (B // D)
        hits = batch_score(a_batch[lo:lo + B // D], b_batch[lo:lo + B // D],
                           scoring, band, substitution=substitution,
                           device=mesh.device)
        return BatchHits(*(all_gather(x, mesh, axis).reshape(-1)
                           for x in hits))

    return fn


def make_best_hit_reducer(mesh, scoring: Scoring = Scoring(),
                          band: Optional[int] = None,
                          axis: Optional[str] = None, substitution=None):
    """fn((B, m), (B, n)) -> BestHit: the global best pair (its score,
    index and end cell), the first pair on a tie. Each rank scores its
    slice as ``make_sharded_batch_scorer`` does and takes its first best;
    the ranks merge in int32: a max of the score, a min of the pair index
    among the score's winners, and sums of the one winner's (i, j)."""
    check_mesh(mesh)
    axis = first_axis(mesh) if axis is None else axis
    D = mesh.shape[axis]

    def fn(a_batch, b_batch) -> BestHit:
        B = len(a_batch)
        if B % D:
            raise ValueError(f"B={B} pairs must divide across {D} ranks")
        lb = B // D
        lo = mesh.index(axis) * lb
        hits = batch_score(a_batch[lo:lo + lb], b_batch[lo:lo + lb],
                           scoring, band, substitution=substitution,
                           device=mesh.device)
        k = torch.argmax(hits.scores)            # the first best pair
        s, i, j = hits.scores[k], hits.max_i[k], hits.max_j[k]
        pid = (k + lo).to(torch.int32)
        best = all_reduce(s, "max", mesh, axis)
        pair = all_reduce(torch.where(s == best, pid, 2**31 - 1), "min",
                          mesh, axis)
        mine = (pair == pid) & (s == best)
        bi = all_reduce(torch.where(mine, i, 0), "sum", mesh, axis)
        bj = all_reduce(torch.where(mine, j, 0), "sum", mesh, axis)
        return BestHit(best, pair, bi, bj)

    return fn


def _bucket_lens(x: np.ndarray) -> np.ndarray:
    """Each length's next power of two (min 16), for lengths of at least 1:
    pairs of many shapes land in ~log2 shape buckets, one ``batch_score``
    each. The exponent ``frexp`` gives x - 1 is its bit length, exact below
    2^53."""
    bits = np.frexp(np.asarray(x, np.int64) - 1)[1].astype(np.int64)
    return np.maximum(16, np.left_shift(1, bits))


class _Packing(NamedTuple):
    """What ``score_many`` uploads for its buckets: every distinct sequence
    once and a table of the rows that read it, the pairs in bucket order."""
    flat: torch.Tensor      # the distinct sequences, concatenated, int8
    order: np.ndarray       # (K,) the pairs with no empty operand
    la: np.ndarray          # (K,) their a lengths
    lb: np.ndarray          # (K,) their b lengths
    buckets: list           # (mb, nb, lo, hi): pairs order[lo:hi]
    tables: list            # a bucket's int32 a offsets, a lengths, b
                            # offsets, b lengths, on flat's device


def _upload(a_list, b_list, dev: torch.device) -> Optional[_Packing]:
    """Bucket the pairs by their lengths and copy what the buckets read to
    ``dev`` in one copy; None where every pair has an empty operand.

    The buckets are the power-of-two (mb, nb) shapes, in ascending order,
    each holding its pairs in input order (a stable sort). A sequence
    object that several pairs share (``[q] * N``) is uploaded once; equal
    contents in different objects are uploaded each. Nothing is kept
    between calls."""
    # the items held in lists, so that each keeps its object (and its id)
    # while the call runs, also where the caller passed a 2-D array
    both = [*a_list, *b_list]
    B = len(both) // 2
    lens = np.fromiter(map(len, both), np.int64, 2 * B)
    la, lb = lens[:B], lens[B:]
    keep = np.flatnonzero((la > 0) & (lb > 0))   # empty: all-zero matrix
    if not len(keep):
        return None
    mb, nb = _bucket_lens(la[keep]), _bucket_lens(lb[keep])
    s = np.lexsort((nb, mb))
    order, mb, nb = keep[s], mb[s], nb[s]
    K = len(order)
    cuts = np.flatnonzero((mb[1:] != mb[:-1]) | (nb[1:] != nb[:-1])) + 1
    lo, hi = np.r_[0, cuts], np.r_[cuts, K]
    buckets = [(int(mb[i]), int(nb[i]), int(i), int(j))
               for i, j in zip(lo, hi)]
    # the 2K row slots, a's then b's, as indices into both; the distinct
    # objects among them in the order first seen, and each slot's one
    rows = np.r_[order, order + B]
    ids = np.fromiter(map(id, both), np.int64, 2 * B)[rows]
    _, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    rank = np.argsort(first)
    src = rows[first[rank]]
    slot = np.empty_like(rank)
    slot[rank] = np.arange(len(rank))
    seqs = [both[k] for k in src.tolist()]
    if any(issubclass(t, torch.Tensor) for t in set(map(type, seqs))):
        seqs = [_host(x) for x in seqs]
    start = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(lens[src], out=start[1:])
    if start[-1] > (1 << 31) - 1:
        raise ValueError(f"{start[-1]} bytes of distinct sequences overflow "
                         "the int32 offsets")
    # one host buffer, one copy: the tables, then the sequences
    buf = np.empty(16 * K + int(start[-1]), np.uint8)
    tab = buf[:16 * K].view(np.int32).reshape(4, K)
    offs = start[slot[inv.reshape(-1)]]
    tab[0], tab[1] = offs[:K], la[order]
    tab[2], tab[3] = offs[K:], lb[order]
    np.concatenate(seqs, out=buf[16 * K:].view(np.int8), casting="unsafe")
    profiling.count("h2d_bytes", buf.nbytes)
    profiling.count("batch.seqs_distinct", len(seqs))
    on_dev = torch.from_numpy(buf).to(dev)
    # each bucket's four table rows, cut in one split
    tables = on_dev[:16 * K].view(torch.int32).view(4, K).split(
        (hi - lo).tolist(), 1)
    return _Packing(on_dev[16 * K:].view(torch.int8), order, la[order],
                    lb[order], buckets, [t.unbind(0) for t in tables])


def _pack(p: _Packing, k: int) -> tuple:
    """The padded (rows, mb) and (rows, nb) codes of bucket k, on the
    packing's device, each side's sentinel after each row (see
    ``_pad_exact``)."""
    mb, nb, _, _ = p.buckets[k]
    a_off, a_len, b_off, b_len = p.tables[k]
    return (pack_rows(p.flat, a_off, a_len, mb, -3),
            pack_rows(p.flat, b_off, b_len, nb, -2))


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


@profiling.spanned("swtpu.score_many")
def score_many(a_list, b_list, scoring: Scoring = Scoring(),
               substitution=None, plan: str = "auto", mesh=None,
               device: Union[str, torch.device] = "cuda") -> BatchHits:
    """Exact scoring of pairs of any shapes: each pair is padded into its
    power-of-two shape bucket (exact, see ``_pad_exact``) and each bucket
    runs one ``batch_score`` (with ``mesh``, as ``batch_score`` runs it
    there). The buckets are built on the device: each distinct sequence
    object is uploaded once (``_upload``) and each bucket's padded rows
    are written there (``kernels.pack_rows``). A scoring whose padding is
    not provably exact, one the kernels do not take, runs one plain
    ``align(traceback=False)`` per pair on the device, a card included.
    Empty operands score (0, 0, 0). The distinct sequences of one call
    may hold up to 2^31 - 1 bytes (their offsets are int32). Returns
    ``BatchHits`` of int32 CPU tensors in input order; positions are
    1-based in each pair's own matrix."""
    B = len(a_list)
    if len(b_list) != B:
        raise ValueError(f"{B} a-sequences vs {len(b_list)} b-sequences")
    _check_plan(plan, None)
    dev = _device(mesh, device)
    out = np.zeros((3, B), np.int32)
    if not _pad_exact(scoring, substitution):
        for k in range(B):
            res = align(_host(a_list[k]), _host(b_list[k]), scoring,
                        traceback=False, plan="scan",
                        substitution=substitution, device=dev)
            out[:, k] = res.max_score, res.max_i, res.max_j
        return BatchHits(*torch.from_numpy(out))
    # the host SIMD tier reads host arrays: pack there
    pack_dev = torch.device("cpu") if plan == "host-simd" else dev
    with profiling.span("swtpu.batch.bucket"):
        packing = _upload(a_list, b_list, pack_dev)
    for k, (mb, nb, lo, hi) in enumerate(
            [] if packing is None else packing.buckets):
        with profiling.span("swtpu.batch.pack"):
            aa, bb = _pack(packing, k)
        if profiling.recording():
            profiling.count("batch.cells_real", int(np.dot(
                packing.la[lo:hi], packing.lb[lo:hi])))
            profiling.count("batch.cells_bucket", (hi - lo) * mb * nb)
        with profiling.span("swtpu.batch.score"):
            hits = _batch_score(aa, bb, scoring, None, plan, mesh,
                                substitution, dev, built=True)
        with profiling.span("swtpu.batch.fetch"):
            out[:, packing.order[lo:hi]] = torch.stack(
                list(hits)).cpu().numpy()
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
    """``batch_score`` for every pair (``mesh`` passed through), then
    alignment strings for the pairs with a positive score, best first
    (ties by index); ``top`` limits how many are aligned. Returns a list
    of (pair index, Alignment). On a card a scoring the kernels do not
    take runs the plain fills there."""
    hits = batch_score(a_batch, b_batch, scoring, band=band, plan=plan,
                       mesh=mesh, substitution=substitution, device=device)
    a_np, b_np = _host(a_batch), _host(b_batch)
    return _align_best(hits, lambda i: (a_np[i], b_np[i]), scoring,
                       EngineConfig(band=band),
                       substitution, alphabet, top, _device(mesh, device))


def align_many(a_list, b_list, scoring: Scoring = Scoring(),
               substitution=None, plan: str = "auto", mesh=None,
               alphabet: Optional[str] = None, top: Optional[int] = None,
               device: Union[str, torch.device] = "cuda") -> list:
    """``batch_align`` for pairs of any shapes: one ``score_many`` for
    every score, then alignment strings for the best pairs, exactly
    ``batch_align``'s contract."""
    hits = score_many(a_list, b_list, scoring, substitution=substitution,
                      plan=plan, mesh=mesh, device=device)
    return _align_best(hits, lambda i: (_host(a_list[i]), _host(b_list[i])),
                       scoring, EngineConfig(),
                       substitution, alphabet, top, _device(mesh, device))
