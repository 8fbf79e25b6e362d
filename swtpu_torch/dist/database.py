"""Database search: a batch of short reads against a long reference.

Counterpart of ``swtpu.dist.database`` on one device. The reference is
cut into windows of ``window`` columns that overlap by the padded read
length (an alignment of a read spans fewer reference columns than that
beyond a window's edge, so no alignment is lost at a boundary), and the
whole read batch is scored against each window in turn. Per-read bests
fold across windows on the device, with no host sync between windows:
the highest score, ties to the lowest reference position; or, with
``n_best=2``, the best two hits at distinct loci (``_upd2``).

The window scorer is K6 (``kernels.window_fill``): on a CUDA device a
hand-written kernel, one launch per window (one warp a read for reads of
up to 512 rows, else the register-blocked stripe's shared-window batch
form, each read its own chain of stripes, its scratch allocated once per
search and its counters cleared on the stream before each window); on the
CPU its plain version, the batched sweep. Plans of
``search``/``make_searcher``: 'auto' (K6 on a card where it takes the
scoring, the plain sweep on the card where it does not, decided before
any launch, and the plain sweep on the CPU), 'stripe' (K6), 'scan' (the
plain sweep) and 'host-simd' (the SIMD fill on the host,
``runtime_native.score_simd_window``, one call a window, OpenMP across
the reads, its answers folded on ``device``; windows of at most 32767
columns, where its positions ride int16 lanes). 'auto' never takes
'host-simd', as the JAX package's does not on a TPU; a forced
'host-simd' raises ValueError up front with a mesh or where the SIMD fill
refuses the search (``simd_reject_reason``). The JAX package's searcher
memo and tuned-table lookup have no counterpart, since the port traces
nothing.

With ``mesh=``, the reference is sharded along the mesh axis
(``shard_reference``: each rank's shard plus a read length of the next),
every rank sweeps its own shard's windows on its device, and the ranks
merge: the single best by a max of the score, a min of the position among
its winners and a max of the read end; the best two by one all-gather of
the six top-2 carries, which every rank then folds identically
(``_merge2``). Every rank calls with the same arguments and gets the
merged hits.

``align_hits`` re-aligns selected hits with one ``align()`` each on the
same device, with the default ``EngineConfig`` (the JAX package raises
``host_max_cells`` to 2^20; the port keeps the card machine's measured
crossover): on a card a hit's window of at most 192^2 cells runs the
native serial fill and the host walk.
``pair_hits`` chooses mate placements, ``to_sam`` renders SAM. Hits are
tuples of (B,) int32 tensors on the search's device; ``align_hits``,
``pair_hits`` and ``to_sam`` also take numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import runtime_native as rn
from ..core.config import EngineConfig, Scoring
from ..core.encode import DNA_ALPHABET, PROTEIN_ALPHABET, decode, revcomp
from ..core.substitution import check_table
from ..engine.align import align, resolve_device
from ..instrument import profiling
from ..kernels.window_fill import (WindowScorer, check_window,
                                   window_score_plain)
from ..kernels.scan_fill import check_codes
from ..dispatch.plan import runs_kernels
from .batch import _codes, _host
from .mesh import all_gather, all_reduce, check_mesh, first_axis

PLANS = ("auto", "stripe", "scan", "host-simd")
# the "no position" sentinel of the fold, as in the JAX package
_FAR = 2**31 - 1


class SearchHits(NamedTuple):
    scores: torch.Tensor    # (B,) int32 best score per read
    ref_pos: torch.Tensor   # (B,) int32 global 0-based reference index of
    #                         the alignment end column (-1 if score 0)
    read_end: torch.Tensor  # (B,) int32 1-based padded row of the read end


class SearchHits2(NamedTuple):
    """Best two hits per read at DISTINCT loci: end positions more than a
    read length apart, so the two window views of one boundary-straddling
    alignment never count as two loci (see ``make_searcher(n_best=2)``).
    Secondary fields are 0 / -1 / 0 when no second locus scored > 0."""

    scores: torch.Tensor
    ref_pos: torch.Tensor
    read_end: torch.Tensor
    scores2: torch.Tensor
    ref_pos2: torch.Tensor
    read_end2: torch.Tensor

    @property
    def primary(self) -> SearchHits:
        return SearchHits(self.scores, self.ref_pos, self.read_end)

    @property
    def secondary(self) -> SearchHits:
        return SearchHits(self.scores2, self.ref_pos2, self.read_end2)


class StrandedHits(NamedTuple):
    """Per-read best hit over both DNA strands (see ``search(strand=)``).
    ``read_end`` refers to the read in its reported orientation (the
    reverse complement for ``strand == -1``)."""

    scores: torch.Tensor
    ref_pos: torch.Tensor
    read_end: torch.Tensor
    strand: torch.Tensor    # (B,) int8: +1 forward, -1 reverse, 0 no hit


class StrandedHits2(NamedTuple):
    """Best two hits per read across both strands and distinct loci (see
    ``search(strand="both", n_best=2)``)."""

    scores: torch.Tensor
    ref_pos: torch.Tensor
    read_end: torch.Tensor
    strand: torch.Tensor
    scores2: torch.Tensor
    ref_pos2: torch.Tensor
    read_end2: torch.Tensor
    strand2: torch.Tensor

    @property
    def primary(self) -> StrandedHits:
        return StrandedHits(self.scores, self.ref_pos, self.read_end,
                            self.strand)

    @property
    def secondary(self) -> StrandedHits:
        return StrandedHits(self.scores2, self.ref_pos2, self.read_end2,
                            self.strand2)


def _np(x) -> np.ndarray:
    """A field of a hit tuple (tensor or array) as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _read_lengths(queries: torch.Tensor) -> torch.Tensor:
    """(B,) int32 unpadded read lengths of a ``pad_queries`` batch (the
    count of non -3 codes per row): the per-read locus-dedup distance."""
    return (queries != -3).sum(dim=1).to(torch.int32)


def _upd2(carry, s, pos, qi, min_dist=0):
    """Fold one candidate (score s, global end column pos, read end qi)
    into a top-2-distinct-loci carry of six (B,) int32 tensors. The two
    slots hold loci whose end positions are more than ``min_dist`` apart
    (a scalar or a (B,) tensor of per-read lengths): a candidate within
    that distance of a slot is a view of the same alignment and refreshes
    it when better; a farther one competes for a slot. Ties prefer the
    lower position, as the single-best fold does."""
    s1, p1, e1, s2, p2, e2 = carry
    where = torch.where
    near1 = (pos - p1).abs() <= min_dist
    near2 = (pos - p2).abs() <= min_dist
    # same-locus refresh (the untruncated view of a known alignment)
    r1 = near1 & (s > s1)
    s1_, e1_, p1_ = where(r1, s, s1), where(r1, qi, e1), where(r1, pos, p1)
    r2 = near2 & (s > s2) & ~near1
    s2_, e2_, p2_ = where(r2, s, s2), where(r2, qi, e2), where(r2, pos, p2)
    # distinct-locus competition
    fresh = (s > 0) & ~near1
    new1 = fresh & ((s > s1_) | ((s == s1_) & (pos < p1_)))
    new2 = fresh & ~new1 & ~near2 & ((s > s2_) | ((s == s2_) & (pos < p2_)))
    # on promotion the old slot 1 (necessarily farther than min_dist, or
    # the candidate would have refreshed it) drops to slot 2
    s2n = where(new1, s1_, where(new2, s, s2_))
    p2n = where(new1, p1_, where(new2, pos, p2_))
    e2n = where(new1, e1_, where(new2, qi, e2_))
    # a new primary can also invalidate a slot 2 within min_dist of it
    kill2 = (p2n - where(new1, pos, p1_)).abs() <= min_dist
    s2n = where(kill2, 0, s2n)
    p2n = where(kill2, _FAR, p2n)
    e2n = where(kill2, 0, e2n)
    return (where(new1, s, s1_), where(new1, pos, p1_), where(new1, qi, e1_),
            s2n, p2n, e2n)


def _merge2(c, other, min_dist=0):
    """Merge another top-2 carry into c."""
    c = _upd2(c, other[0], other[1], other[2], min_dist)
    return _upd2(c, other[3], other[4], other[5], min_dist)


def _check_plan(plan: str) -> None:
    if plan not in PLANS:
        raise ValueError(f"unknown plan {plan!r} (use one of {PLANS})")


def _check_host_simd(mesh, qlen: int, window: int, scoring: Scoring,
                     sub_np) -> None:
    """A forced ``plan='host-simd'`` search runs or raises up front: with
    a mesh, or where the SIMD fill refuses reads of qlen against windows
    of at most 32767 columns."""
    if mesh is not None:
        raise ValueError("plan='host-simd' searches run on the host; it "
                         "cannot be combined with a device mesh")
    w16 = min(window, rn.SIMD_MAX_LEN)
    if not rn.simd_eligible(w16, qlen, scoring, sub_np):
        raise ValueError(
            "plan='host-simd' was forced but the host SIMD tier is "
            "ineligible for this search: "
            + rn.simd_reject_reason(w16, qlen, scoring, sub_np))


def make_searcher(qlen: int, shard_len: int, window: int = 32768,
                  scoring: Scoring = Scoring(), plan: str = "auto",
                  substitution=None, n_best: int = 1,
                  sec_resolution: int = 2048,
                  device: Union[str, torch.device] = "cuda", mesh=None,
                  axis: Optional[str] = None):
    """Build a searcher: fn(queries, ref_sharded) -> hits on ``device``
    (with a mesh, its device).

    queries: (B, qlen) int8 (reads padded with the -3 sentinel);
    ref_sharded: (D, shard_len + qlen) int8, a ``shard_reference`` of D
    shards, D = 1 without a mesh, else the size of the mesh ``axis``
    (default: its first), every rank given all of it; numpy or torch.
    Returns SearchHits, or with ``n_best=2`` SearchHits2, the best two hits
    at distinct end positions per read, merged across the ranks.

    Secondary-locus resolution is the window: each window contributes its
    single best candidate to the top-2 carry, so two loci inside one
    window collapse to the better one. With n_best=2 the window is
    therefore clamped to ``max(2*qlen, sec_resolution)``."""
    if n_best not in (1, 2):
        raise ValueError(f"n_best must be 1 or 2, got {n_best}")
    _check_plan(plan)
    if mesh is not None:
        check_mesh(mesh)
        axis = first_axis(mesh) if axis is None else axis
        D, d = mesh.shape[axis], mesh.index(axis)
        dev = mesh.device
    else:
        D, d = 1, 0
        dev = resolve_device(device)
    if n_best == 2:
        window = min(window, max(2 * qlen, sec_resolution))
    ext = shard_len + qlen                 # shard + boundary halo
    window = min(window, ext)              # a window never exceeds a shard
    if window <= qlen:
        raise ValueError(
            f"window ({window}) must exceed the padded read length "
            f"({qlen}): windows overlap by qlen, so the stride would "
            "be non-positive")
    step = window - qlen                   # window stride (qlen overlap)
    nwin = max(1, -(-max(1, ext - qlen) // step))
    sub_np = None if substitution is None else check_table(substitution)
    if plan == "auto":
        plan = ("stripe" if runs_kernels(dev, scoring, sub_np, window, qlen)
                else "scan")
    if plan == "host-simd":
        _check_host_simd(mesh, qlen, window, scoring, sub_np)
        if window > rn.SIMD_MAX_LEN:
            # window columns ride the SIMD fill's int16 lanes
            window = rn.SIMD_MAX_LEN
            step = window - qlen
            nwin = max(1, -(-max(1, ext - qlen) // step))
    sub = None if sub_np is None else torch.from_numpy(sub_np).to(dev)

    def host_scorer(q: np.ndarray):
        def score(win: np.ndarray):
            got = rn.score_simd_window(win, q, scoring, sub_np)
            if got is None:                    # checked up front
                raise RuntimeError("the host SIMD fill refused a window")
            return tuple(torch.from_numpy(x).to(dev) for x in got)
        return score

    def prepare(queries, ref_sharded):
        q = _codes(queries, dev)
        if len(ref_sharded) != D:
            raise ValueError(f"ref_sharded holds {len(ref_sharded)} shards "
                             f"for {D} ranks")
        if plan == "host-simd":
            shard = _host(ref_sharded[d:d + 1])[0]
            nsym = 4 if sub_np is None else sub_np.shape[0]
            if len(shard) and (shard.min() < -3 or shard.max() >= nsym):
                raise ValueError(f"plan='host-simd' needs reference codes "
                                 f"in [-3, {nsym})")
            return q, shard, host_scorer(_host(queries))
        shard = _codes(ref_sharded[d:d + 1], dev)[0]
        if plan == "scan":
            return q, shard, (lambda win: window_score_plain(q, win, scoring,
                                                             sub))
        # the codes are checked once here, not per window
        check_window(q, shard[:window], scoring, sub)
        if sub is not None:
            check_codes(shard, q, sub.shape[0])
        return q, shard, WindowScorer(q, window, scoring, substitution=sub)

    def windows(shard, score):
        for w in range(nwin):
            off = min(w * step, ext - window)
            s, qi, wj = score(shard[off:off + window])
            yield s, d * shard_len + off + wj - 1, qi  # the global end

    def run(queries, ref_sharded) -> SearchHits:
        with profiling.span("swtpu.search.prepare"):
            q, shard, score = prepare(queries, ref_sharded)
        B = q.shape[0]
        with profiling.span("swtpu.search.windows"):
            bs = torch.zeros(B, dtype=torch.int32, device=dev)
            bp = torch.full((B,), _FAR, dtype=torch.int32, device=dev)
            be = torch.zeros(B, dtype=torch.int32, device=dev)
            for s, pos, qi in windows(shard, score):
                # prefer the higher score; a tie goes to the lower position
                better = (s > bs) | ((s == bs) & (pos < bp) & (s > 0))
                bs = torch.where(better, s, bs)
                bp = torch.where(better, pos, bp)
                be = torch.where(better, qi, be)
            bp = torch.where(bs > 0, bp, -1)
            if D > 1:
                # max score, then min position among its winners, then the
                # read end of the one winner
                gbs = all_reduce(bs, "max", mesh, axis)
                gbp = all_reduce(torch.where((bs == gbs) & (gbs > 0), bp,
                                             _FAR), "min", mesh, axis)
                mine = (bs == gbs) & (bp == gbp)
                be = all_reduce(torch.where(mine, be, 0), "max", mesh, axis)
                bs, bp = gbs, torch.where(gbs > 0, gbp, -1)
        return SearchHits(bs, bp, be)

    def run2(queries, ref_sharded) -> SearchHits2:
        with profiling.span("swtpu.search.prepare"):
            q, shard, score = prepare(queries, ref_sharded)
        B = q.shape[0]
        with profiling.span("swtpu.search.windows"):
            # the dedup radius is each read's own length, not the padded
            # qlen
            mind = _read_lengths(q)
            z = torch.zeros(B, dtype=torch.int32, device=dev)
            far = torch.full((B,), _FAR, dtype=torch.int32, device=dev)
            c = (z, far, z, z, far, z)
            for s, pos, qi in windows(shard, score):
                c = _upd2(c, s, pos, qi, min_dist=mind)
            if D > 1:
                # every rank folds all D top-2 carries in rank order
                g = all_gather(torch.stack(c), mesh, axis)   # (D, 6, B)
                c = (z, far, z, z, far, z)
                for i in range(D):
                    c = _merge2(c, tuple(g[i]), min_dist=mind)
        s1, p1, e1, s2, p2, e2 = c
        return SearchHits2(s1, torch.where(s1 > 0, p1, -1), e1,
                           s2, torch.where(s2 > 0, p2, -1), e2)

    return run2 if n_best == 2 else run


def shard_reference(ref: np.ndarray, n_shards: int, qlen: int
                    ) -> tuple[np.ndarray, int]:
    """Split the reference into (D, shard_len + qlen) rows with halo
    overlap. Pads the tail with the -2 sentinel (never matches)."""
    L = len(ref)
    shard_len = -(-L // n_shards)
    ext = shard_len + qlen
    out = np.full((n_shards, ext), -2, np.int8)
    for d in range(n_shards):
        lo = d * shard_len
        hi = min(L, lo + ext)
        if lo < L:
            out[d, : hi - lo] = ref[lo:hi]
    return out, shard_len


def concat_references(seqs: list[np.ndarray], qlen: int,
                      scoring: Scoring = Scoring(), substitution=None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate reference records (chromosomes) into one searchable
    array with never-matching -2 spacers long enough that no local
    alignment can profitably span two records: crossing a spacer of
    length L costs at least L x |cheapest per-base gap|, while the read
    can gain at most max_per_base x qlen (``scoring.match`` for DNA, the
    table's max under a substitution table), so L > max_per_base*qlen/|gap|
    + 1 makes any spanning alignment strictly worse than its best side
    alone (plus a qlen pad so windows land cleanly). Returns (cat, starts),
    starts[i] being record i's offset into cat. Pass the same
    ``substitution`` given to ``search``."""
    ge = abs(scoring.gap_extend if scoring.is_affine else scoring.gap)
    per_base = (int(np.max(np.asarray(substitution)))
                if substitution is not None else int(scoring.match))
    spacer = per_base * qlen // max(1, ge) + qlen + 1
    starts = []
    parts = []
    off = 0
    gap = np.full(spacer, -2, np.int8)
    for i, s in enumerate(seqs):
        s = np.asarray(s, np.int8)
        starts.append(off)
        parts.append(s)
        off += len(s)
        if i != len(seqs) - 1:
            parts.append(gap)
            off += spacer
    return np.concatenate(parts), np.asarray(starts, np.int64)


def locate_record(starts: np.ndarray, seqs: list[np.ndarray],
                  global_pos: int) -> tuple[int, int]:
    """(record index, local position) for a ``concat_references`` global
    position. Raises if the position falls in a spacer or is negative
    (such as the -1 no-hit sentinel of ``SearchHits.ref_pos``)."""
    i = int(np.searchsorted(starts, global_pos, side="right")) - 1
    if i < 0:
        raise ValueError(f"position {global_pos} is before the first "
                         "record (no-hit sentinel?)")
    local = global_pos - int(starts[i])
    if local >= len(seqs[i]):
        raise ValueError(f"position {global_pos} falls in the spacer "
                         f"after record {i}")
    return i, local


def pad_queries(queries: list[np.ndarray], qlen: int) -> np.ndarray:
    """Stack variable-length reads into (B, qlen) with the -3 sentinel
    (distinct from the reference pad, so padding never matches)."""
    out = np.full((len(queries), qlen), -3, np.int8)
    for i, q in enumerate(queries):
        ln = min(len(q), qlen)
        out[i, :ln] = q[:ln]
    return out


def revcomp_padded(queries: np.ndarray) -> np.ndarray:
    """Reverse-complement each row of a ``pad_queries`` batch, keeping the
    -3 padding at the END of every row."""
    q = np.asarray(queries, np.int8)
    B, qlen = q.shape
    lens = (q != -3).sum(axis=1)
    idx = lens[:, None] - 1 - np.arange(qlen)[None, :]
    valid = idx >= 0
    gathered = q[np.arange(B)[:, None], np.clip(idx, 0, qlen - 1)]
    comp = np.where(gathered >= 0, 3 - gathered, gathered)
    return np.where(valid, comp, -3).astype(np.int8)


class HitAlignment(NamedTuple):
    """Full alignment record for one search hit, with the fields SAM
    needs."""

    read: int            # batch index into queries
    score: int
    ref_start: int       # global 0-based reference col of the first pair
    ref_end: int         # global 0-based reference col of the last pair
    read_start: int      # 0-based offset within the (unpadded) read
    read_end: int
    aligned_read: str    # with '-' gaps
    aligned_ref: str
    cigar: str           # SAM-style M/I/D runs (read as the query)
    strand: str = "+"    # '-' = the read aligned reverse-complemented;
    #                      read coords/strings are in that orientation
    is_secondary: bool = False   # SAM flag 0x100 when rendered
    xs: Optional[int] = None     # second-locus score: 0 = searched, no
    #                              competitor (MAPQ 60); None = never
    #                              searched (MAPQ 255)
    rname: Optional[str] = None  # per-record reference name (multi-chrom)
    flag_extra: int = 0          # extra SAM flag bits OR'd in (pairing)
    is_unmapped: bool = False    # flag 0x4 record: CIGAR '*', MAPQ 0;
    #                              rname/ref_start = the mapped mate's
    #                              placement when paired, else unplaced
    rnext: Optional[str] = None  # mate reference name ('=' = same); None
    #                              = unpaired (RNEXT '*', PNEXT 0)
    pnext: int = 0               # mate ref_start, 0-based
    tlen: int = 0                # signed observed template length


def _strip_queries(queries) -> list[np.ndarray]:
    """(B, qlen) ``pad_queries`` array (-3 pad stripped) or a list of
    unpadded reads -> list of unpadded int8 code arrays."""
    if isinstance(queries, torch.Tensor):
        queries = queries.cpu().numpy()
    if isinstance(queries, np.ndarray):
        return [q[q != -3] for q in np.asarray(queries, np.int8)]
    return [np.asarray(q, np.int8) for q in queries]


def _cigar(aligned_read: str, aligned_ref: str) -> str:
    runs: list[list] = []
    for cr, cf in zip(aligned_read, aligned_ref):
        op = "D" if cr == "-" else ("I" if cf == "-" else "M")
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    return "".join(f"{n}{op}" for op, n in runs)


def align_hits(hits, queries, reference, scoring: Scoring = Scoring(), *,
               top: Optional[int] = None, reads=None, substitution=None,
               alphabet: Optional[str] = None,
               device: Union[str, torch.device] = "cuda"
               ) -> list[HitAlignment]:
    """Alignment records for selected hits of a ``search``.

    Re-aligns each selected read against a reference window ending at the
    hit's end column with one ``align()`` on ``device``, doubling the
    window until the hit's score is reached. The record's score is the
    re-aligned one, which can exceed the search's: a gapped alignment
    whose reference span exceeds qlen and straddles a window boundary is
    under-reported by the search.

    queries: the (B, qlen) padded batch given to ``search`` (-3 pad
    stripped) or a list of unpadded reads. Select hits with ``reads``
    (batch indices) or ``top`` (best K by score, ties by lower reference
    position, then index); default: every read with a positive score.
    ``StrandedHits`` orient each read by its strand."""
    if alphabet is None:
        alphabet = DNA_ALPHABET if substitution is None else PROTEIN_ALPHABET
    dev = resolve_device(device)
    reference = np.asarray(reference, np.int8)
    scores = _np(hits.scores)
    pos = _np(hits.ref_pos)
    strands = _np(hits.strand) if hasattr(hits, "strand") else None
    qlist = _strip_queries(queries)
    if strands is not None:
        qlist = [revcomp(q) if strands[i] < 0 else q
                 for i, q in enumerate(qlist)]
    if reads is None:
        reads = sorted((i for i in range(len(qlist)) if scores[i] > 0),
                       key=lambda i: (-scores[i], pos[i], i))
        if top is not None:
            reads = reads[:top]
    cfg = EngineConfig()
    out: list[HitAlignment] = []
    for i in reads:
        s = int(scores[i])
        if s <= 0:
            continue
        q = qlist[i]
        end = int(pos[i])                  # global 0-based end column
        W = len(q) + 32
        while True:
            start = max(0, end + 1 - W)
            res = align(reference[start:end + 1], q, scoring, cfg,
                        traceback=True, substitution=substitution,
                        alphabet=alphabet, device=dev)
            if res.max_score >= s or start == 0:
                break
            W *= 2
        if res.max_score < s:
            raise ValueError(
                f"read {i}: window [0, {end}] reproduces score "
                f"{res.max_score}, search reported {s}: scoring or "
                "substitution differ between search() and align_hits()?")
        # start coordinates from the consumed-character counts
        ref_used = sum(c != "-" for c in res.aligned_a)
        read_used = sum(c != "-" for c in res.aligned_b)
        out.append(HitAlignment(
            read=i, score=int(res.max_score),
            ref_start=start + res.max_j - ref_used,
            ref_end=start + res.max_j - 1,
            read_start=res.max_i - read_used, read_end=res.max_i - 1,
            aligned_read=res.aligned_b, aligned_ref=res.aligned_a,
            cigar=_cigar(res.aligned_b, res.aligned_a),
            strand="-" if strands is not None and strands[i] < 0 else "+"))
    return out


def _merge_stranded2(hits: SearchHits2, Bh: int) -> StrandedHits2:
    """Top-2 over both strands, on the device: rank the four labelled
    candidates per read (forward/reverse x primary/secondary) by score
    desc, then forward first, then position asc. The columns come in that
    preference order and, within a strand, slot 1 already dominates slot
    2, so only a strictly higher score displaces an earlier candidate.
    Same-position hits on opposite strands are distinct alignments and may
    fill both slots."""
    cols = [(hits.scores[:Bh], hits.ref_pos[:Bh], hits.read_end[:Bh], 1),
            (hits.scores2[:Bh], hits.ref_pos2[:Bh], hits.read_end2[:Bh], 1),
            (hits.scores[Bh:], hits.ref_pos[Bh:], hits.read_end[Bh:], -1),
            (hits.scores2[Bh:], hits.ref_pos2[Bh:], hits.read_end2[Bh:],
             -1)]
    where = torch.where

    def top(excl_idx):
        zb = torch.zeros_like(cols[0][0])
        best = (zb - 1, zb - 1, zb, zb.to(torch.int8), zb - 1)
        for i, (s, p, e, st) in enumerate(cols):
            if excl_idx is not None:
                s = where(excl_idx == i, -1, s)
            take = s > best[0]
            best = (where(take, s, best[0]), where(take, p, best[1]),
                    where(take, e, best[2]),
                    where(take, st, best[3]).to(torch.int8),
                    where(take, i, best[4]))
        return best

    s1, p1, e1, st1, i1 = top(None)
    s2, p2, e2, st2, _ = top(i1)
    return StrandedHits2(
        s1.clamp(min=0), where(s1 > 0, p1, -1), e1,
        where(s1 > 0, st1, 0).to(torch.int8),
        s2.clamp(min=0), where(s2 > 0, p2, -1), e2,
        where(s2 > 0, st2, 0).to(torch.int8))


class PairSelection(NamedTuple):
    """Per-pair mate placements chosen by ``pair_hits``."""

    mate1: StrandedHits      # selected candidate for each first mate
    mate2: StrandedHits      # selected candidate for each second mate
    proper: np.ndarray       # (B,) bool: FR orientation within bounds
    alt_scores1: np.ndarray  # the not-chosen candidate's score (XS tag)
    alt_scores2: np.ndarray


def pair_hits(h1: StrandedHits2, h2: StrandedHits2, *,
              min_insert: int = 0, max_insert: int = 1000,
              record_starts=None) -> PairSelection:
    """Select mate placements for paired-end reads from the two ends'
    top-2 both-strand candidates (``search(strand="both", n_best=2)`` per
    end): among the 4 combinations per pair take the highest-scoring
    PROPER one (mates on opposite strands, the forward mate upstream of
    the reverse one, estimated template length within [min_insert,
    max_insert]), else the two independent best placements (improper).
    With a ``concat_references`` reference pass its ``starts`` as
    ``record_starts``, so that a proper pair lies on one record. Host-side
    numpy; the mates' fields come back as numpy arrays."""
    def cands(h):
        return (np.stack([_np(h.scores), _np(h.scores2)]),
                np.stack([_np(h.ref_pos), _np(h.ref_pos2)]),
                np.stack([_np(h.read_end), _np(h.read_end2)]),
                np.stack([_np(h.strand), _np(h.strand2)]))

    s1, p1, e1, st1 = cands(h1)
    s2, p2, e2, st2 = cands(h2)
    B = s1.shape[1]
    if record_starts is not None:
        starts = np.asarray(record_starts)
        rec1 = np.searchsorted(starts, p1, side="right") - 1
        rec2 = np.searchsorted(starts, p2, side="right") - 1
    best = np.full(B, -1, np.int64)
    a_i = np.zeros(B, np.int64)
    b_i = np.zeros(B, np.int64)
    for a in (0, 1):
        for b in (0, 1):
            ok = (s1[a] > 0) & (s2[b] > 0) & (st1[a] * st2[b] == -1)
            if record_starts is not None:
                ok &= rec1[a] == rec2[b]     # proper = same record
            a_fwd = st1[a] == 1
            fwd_start = np.where(a_fwd, p1[a] - e1[a], p2[b] - e2[b])
            rev_end = np.where(a_fwd, p2[b], p1[a])
            ins = rev_end - fwd_start + 1
            ok &= (ins >= max(1, min_insert)) & (ins <= max_insert)
            sc = s1[a] + s2[b]
            take = ok & (sc > best)
            best = np.where(take, sc, best)
            a_i = np.where(take, a, a_i)
            b_i = np.where(take, b, b_i)
    ar = np.arange(B)

    def pick(s, p, e, st, idx):
        return StrandedHits(s[idx, ar], p[idx, ar], e[idx, ar],
                            st[idx, ar])

    return PairSelection(pick(s1, p1, e1, st1, a_i),
                         pick(s2, p2, e2, st2, b_i),
                         best >= 0,
                         s1[1 - a_i, ar], s2[1 - b_i, ar])


def mapq(primary: int, secondary: Optional[int], scale: int = 60) -> int:
    """Mapping quality from the best/second-best score gap (the AS-XS
    form): 0 when the two loci tie, ``scale`` when no competing locus
    exists, linear in the relative gap between."""
    if primary <= 0:
        return 0
    if secondary is None or secondary <= 0:
        return scale
    return max(0, min(scale, round(scale * (primary - secondary) / primary)))


def to_sam(records: list[HitAlignment], queries, *, ref_name: str = "ref",
           ref_len: Optional[int] = None, read_names=None,
           alphabet: Optional[str] = None, sq=None, quals=None,
           pg: Optional[str] = None, so: str = "unknown") -> str:
    """Render ``align_hits`` records as minimal SAM (header + one line per
    record): soft clips for the unaligned read ends, flag 0x10 and the
    stored (reverse-complemented) sequence on the minus strand, the score
    as AS:i. MAPQ is ``mapq(score, xs)`` when the record carries a
    second-best score, 0 for secondary records, else 255. ``quals``
    (per-read Phred strings, None entries allowed) fills QUAL, reversed on
    the minus strand. ``pg``: the command line of a @PG line naming
    swtpu_torch. ``queries`` as given to ``align_hits``."""
    if alphabet is None:
        alphabet = DNA_ALPHABET
    qlist = _strip_queries(queries)
    lines = [f"@HD\tVN:1.6\tSO:{so}"]
    if sq is not None:                 # multi-reference: (name, len) pairs
        for name, ln in sq:
            lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
    elif ref_len is not None:
        lines.append(f"@SQ\tSN:{ref_name}\tLN:{ref_len}")
    if pg is not None:                 # command line for provenance
        from .. import __version__
        lines.append(f"@PG\tID:swtpu_torch\tPN:swtpu_torch"
                     f"\tVN:{__version__}\tCL:{pg}")
    for r in records:
        q = qlist[r.read]
        name = (read_names[r.read] if read_names is not None
                else f"read{r.read}")
        if r.is_unmapped:
            # flag-4 record: CIGAR '*', MAPQ 0, SEQ as read; placed at the
            # mapped mate's coordinate when the caller set one
            qual = quals[r.read] if quals is not None else None
            placed = r.ref_start >= 0
            fields = [
                name, str(4 | r.flag_extra),
                (r.rname or ref_name) if placed else "*",
                str(r.ref_start + 1) if placed else "0",
                "0", "*",
                r.rnext or "*",
                str(r.pnext + 1) if r.rnext else "0",
                "0", decode(q, alphabet) or "*",    # empty read: '*' SEQ
                qual or "*"]
            lines.append("\t".join(fields))
            continue
        if r.strand == "-":
            q = revcomp(q)
        flag = (16 if r.strand == "-" else 0) \
            | (256 if r.is_secondary else 0) | r.flag_extra
        head = f"{r.read_start}S" if r.read_start else ""
        tail_n = len(q) - 1 - r.read_end
        tail = f"{tail_n}S" if tail_n else ""
        if r.is_secondary:
            mq = "0"
        elif r.xs is not None:
            mq = str(mapq(r.score, r.xs))
        else:
            mq = "255"
        qual = quals[r.read] if quals is not None else None
        if qual is not None and r.strand == "-":
            qual = qual[::-1]
        fields = [
            name, str(flag), r.rname or ref_name, str(r.ref_start + 1),
            mq,
            head + r.cigar + tail,
            r.rnext or "*",
            str(r.pnext + 1) if r.rnext else "0",
            str(r.tlen),
            decode(q, alphabet), qual or "*", f"AS:i:{r.score}"]
        if r.xs:                       # xs == 0 means "no competitor":
            fields.append(f"XS:i:{r.xs}")  # it feeds MAPQ, not a tag
        lines.append("\t".join(fields))
    return "\n".join(lines) + "\n"


@profiling.spanned("swtpu.search")
def search(queries, reference, mesh=None, window: int = 32768,
           scoring: Scoring = Scoring(), axis: Optional[str] = None,
           substitution=None, strand: str = "forward", n_best: int = 1,
           sec_resolution: int = 2048, plan: str = "auto",
           device: Union[str, torch.device] = "cuda"
           ) -> Union[SearchHits, StrandedHits, SearchHits2, StrandedHits2]:
    """One-shot search of a (B, qlen) ``pad_queries`` batch against a
    reference (int8 codes, numpy or torch) on ``device``, 'cuda' by
    default. Returns a hit tuple of (B,) int32 tensors on that device.
    With ``mesh`` the reference is sharded along ``axis`` (default: the
    mesh's first) and the hits merge across the ranks, on the mesh's
    device.

    ``n_best=2`` returns SearchHits2, the best two hits per read at
    distinct end positions; with ``strand="both"`` StrandedHits2, the top
    two over all four strand/locus candidates. ``sec_resolution`` is the
    secondary-locus window clamp under n_best=2 (see ``make_searcher``).
    ``strand="both"`` (DNA only) also searches every read's reverse
    complement in the same sweep and returns StrandedHits with the
    winning strand per read (higher score wins; ties prefer forward)."""
    _check_plan(plan)
    D = 1
    if mesh is not None:
        check_mesh(mesh)
        axis = first_axis(mesh) if axis is None else axis
        D = mesh.shape[axis]
    if isinstance(queries, torch.Tensor):
        queries = queries.cpu().numpy()
    queries = np.asarray(queries, np.int8)
    if strand not in ("forward", "both"):
        raise ValueError(f"strand must be 'forward' or 'both', got {strand!r}")
    if strand == "both":
        if substitution is not None:
            raise ValueError("strand='both' is DNA-only (reverse "
                             "complement is undefined for protein codes)")
        with profiling.span("swtpu.search.revcomp"):
            queries = np.concatenate([queries, revcomp_padded(queries)])
    B, qlen = queries.shape
    if isinstance(reference, torch.Tensor):
        reference = reference.cpu().numpy()
    with profiling.span("swtpu.search.shard"):
        shards, shard_len = shard_reference(np.asarray(reference, np.int8),
                                            D, qlen)
    window = min(window, shards.shape[1])
    with profiling.span("swtpu.search.prepare"):
        fn = make_searcher(qlen, shard_len, window, scoring, plan=plan,
                           substitution=substitution, n_best=n_best,
                           sec_resolution=sec_resolution, device=device,
                           mesh=mesh, axis=axis)
    hits = fn(queries, shards)
    if strand == "forward":
        return hits
    with profiling.span("swtpu.search.merge"):
        Bh = B // 2
        if n_best == 2:
            return _merge_stranded2(hits, Bh)
        fs, rs = hits.scores[:Bh], hits.scores[Bh:]
        rev = rs > fs                             # ties prefer forward
        sc = torch.where(rev, rs, fs)
        return StrandedHits(
            scores=sc,
            ref_pos=torch.where(rev, hits.ref_pos[Bh:], hits.ref_pos[:Bh]),
            read_end=torch.where(rev, hits.read_end[Bh:],
                                 hits.read_end[:Bh]),
            strand=torch.where(sc > 0, torch.where(rev, -1, 1), 0
                               ).to(torch.int8))
