"""Mega-matrix sequence-parallel pipeline: one DP matrix across ranks.

Counterpart of ``swtpu.dist.pipeline`` over ``torch.distributed``. The
score matrix is split into column stripes, one per rank of the mesh axis;
row blocks advance as a block wavefront. At stage t, rank d fills block
row t - d of its stripe (an R x m/D block with its row 0 and column 0
injected) and sends its right column, and affine E of that column, to
rank d + 1 (``mesh.shift``). The global max merges with three
all-reduces that keep the first row-major occurrence across ranks.
Stages = nblocks + D - 1: the first and last D - 1 stages underfill the
mesh, the wavefront's ramp.

The block fill of a stage is K5, the hand-written block kernel
(``kernels.stripe_fill.stripe_block``), on a card wherever the kernels
take the scoring (``dispatch.plan.runs_kernels``); for a scoring they
refuse, the plain block fill (``stripe_block_plain``) runs on the same
card, chosen before any launch, as the JAX package runs its scan there.
On the CPU the plain fill runs.

The JAX stage fills a block on every device and masks the inactive ones;
here a rank inactive at a stage launches nothing and sends the global
boundary (H = 0 local, NEGB global; E = NEGB), which gives the same carry.
Every rank of the axis calls the same function with the same arguments,
and each returns the merged, replicated result on its own device.

Under a running profiler (``instrument.profiling``) the pipeline's parts
are spans: ``swtpu.pipe.plan`` (the projected rows and their broadcast),
``swtpu.pipe.agree`` (the verdict's all-reduce), ``swtpu.pipe.fill`` (a
stage's block fill), ``swtpu.pipe.halo`` (its ``shift``) and
``swtpu.pipe.merge`` (the three all-reduces of the best and the last
cell's; ``engine.align``'s score route fetches the answer under the same
name, since the fetch waits for them). Each pass counts, on each rank, its ``pipe.stages``, the stages
in which this rank filled a block (``pipe.blocks``), the bytes this rank
sent in the halo (``pipe.halo_bytes``) and its ``pipe.block_rows``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.config import Scoring
from ..core.substitution import check_table
from ..dispatch.plan import (pipeline_devices, pipeline_projection,
                             runs_kernels)
from ..instrument import profiling
from ..kernels import stripe_fill as sf
from .batch import _codes, _host
from .mesh import (Mesh, all_reduce, broadcast_object, check_mesh,
                   first_axis, shift)

NEGB = -(1 << 30)
_I32MAX = 2**31 - 1


class PipelineResult(NamedTuple):
    max_score: torch.Tensor   # () int32
    max_i: torch.Tensor       # () int32 row of the first max
    max_j: torch.Tensor       # () int32 column of the first max
    last_cell: torch.Tensor   # () int32 H[n, m]


class PipelineBatchResult(NamedTuple):
    scores: torch.Tensor      # (P,) int32
    max_i: torch.Tensor       # (P,) int32 row of each pair's first max
    max_j: torch.Tensor       # (P,) int32
    last_cells: torch.Tensor  # (P,) int32 H[n, m] per pair


def default_block_rows(m: int, n: int, D: int) -> int:
    """Rows a block where the cost model has none (one card, gloo ranks
    sharing a card, no record fitted on this card): the fewest, tallest
    blocks that still keep every rank of the axis busy at once, one block
    row a rank (n/D rows; all n at world 1). In chip_smoke.py's sweep of
    the world-1 pipeline at 65536^2 on an NVIDIA H100 80GB HBM3 at 700 W
    (PERF.md section 6), one block took 22.82 ms, two 35.87, four 61.36,
    eight 115.31 and sixteen 219.60 (K5 at T = 128; single-card score()
    21.16 ms): every block is a chain of m/C + rows/R steps, so fewer,
    taller blocks win. With fewer than D block rows no stage has every
    rank filling."""
    return -(-max(n, 1) // max(D, 1))


def projected_rows(m: int, n: int, mesh: Mesh, axis: str,
                   scoring: Scoring = Scoring(),
                   substitution=None) -> Optional[int]:
    """The rows of ``dispatch.plan.pipeline_projection`` for an n x m pass
    over the cards of ``mesh``'s ``axis`` (``pipeline_devices``), where
    there are two or more and it projects any, else None. Each rank
    projects from its own record, so the axis' rank 0's rows go to every
    rank (``broadcast_object``): ranks whose records differ still cut the
    same blocks."""
    cards = pipeline_devices(mesh, axis=axis)
    if cards < 2:
        return None
    with profiling.span("swtpu.pipe.plan"):
        _, rows = pipeline_projection(m, n, cards, scoring, substitution)
        return broadcast_object(rows or None, mesh, axis)


def block_rows_for(m: int, n: int, mesh: Mesh, axis: str,
                   scoring: Scoring = Scoring(), substitution=None) -> int:
    """Rows a block of an n x m pass on ``mesh``'s ``axis`` when the caller
    names none: ``projected_rows``, else ``default_block_rows``. The
    answer does not depend on them."""
    return (projected_rows(m, n, mesh, axis, scoring, substitution)
            or default_block_rows(m, n, mesh.shape[axis]))


def agree(mesh: Mesh, verdict: bool, key: tuple) -> bool:
    """True on every rank of ``mesh``'s pipeline axis (its first) where
    every rank's ``verdict`` holds and every rank passed the same integers
    ``key``, else False on every rank: one all-reduce of the minimum of
    (verdict, key, -key). Every rank of the axis calls it."""
    axis = _resolve(mesh, None)
    k = [int(x) for x in key]
    with profiling.span("swtpu.pipe.agree"):
        got = all_reduce(torch.tensor(
            [int(bool(verdict)), *k, *(-x for x in k)], dtype=torch.int64,
            device=mesh.device), "min", mesh, axis).tolist()
    low, high = got[1:1 + len(k)], [-x for x in got[1 + len(k):]]
    return bool(got[0]) and low == high


@dataclasses.dataclass
class _Pipe:
    """THE pipeline stage, shared by ``make_pipeline``,
    ``make_pipeline_batch`` and ``checkpoint.ResumablePipeline``, as in
    the JAX package. Carry: (prev_bottom (mc+1,), prev_bottom_f (mc+1,),
    left_in (R+1,), left_e_in (R+1,), best (P, 3) score/i/j, lasts (P,)),
    int32 on the mesh device. ``npb``: blocks a pair; a pair's first
    block row resets the top boundary (local mode)."""

    mesh: Mesh
    axis: str
    mc: int
    R: int
    nblocks: int
    npb: int
    scoring: Scoring
    substitution: Optional[np.ndarray]
    local: bool
    T: Optional[int] = None

    def __post_init__(self):
        self.D = self.mesh.shape[self.axis]
        self.d = self.mesh.index(self.axis)
        self.dev = self.mesh.device
        self.affine = self.scoring.is_affine
        # K5 where a card's kernels take the scoring and an mc x R block,
        # else the plain block fill: the JAX package's _block_fill_plan
        self.kernel = runs_kernels(self.dev, self.scoring,
                                   self.substitution, self.mc, self.R)
        self.sub = (None if self.substitution is None else
                    torch.from_numpy(self.substitution).to(self.dev))
        self.stages = self.nblocks + self.D - 1

    def _full(self, size: int, fill: int) -> torch.Tensor:
        return torch.full((size,), fill, dtype=torch.int32, device=self.dev)

    def carry0(self, P: int = 1) -> tuple:
        """Zero boundaries for the local recurrence; NEGB with the origin
        for anchored NW (only rank 0's stripe holds (0, 0))."""
        mc, R = self.mc, self.R
        if self.local:
            top0, left0 = self._full(mc + 1, 0), self._full(R + 1, 0)
        else:
            top0, left0 = self._full(mc + 1, NEGB), self._full(R + 1, NEGB)
            if self.d == 0:
                top0[0] = left0[0] = 0
        return (top0, self._full(mc + 1, NEGB), left0,
                self._full(R + 1, NEGB),
                torch.zeros((P, 3), dtype=torch.int32, device=self.dev),
                torch.zeros(P, dtype=torch.int32, device=self.dev))

    def _fill(self, a, b, top, left, top_f, left_e) -> sf.BlockOut:
        fill = sf.stripe_block if self.kernel else sf.stripe_block_plain
        kw = {"T": self.T} if self.kernel else {}
        return fill(a, b, self.scoring, top, left, top_f, left_e,
                    local=self.local, substitution=self.sub,
                    want_bottom=True, **kw)

    def stage(self, t: int, carry: tuple, a_of_pid, b_full) -> tuple:
        """Stage t: fill block row t - d if this rank has one, then the
        halo exchange, which every rank of the axis joins."""
        prev_bottom, prev_bottom_f, left_in, left_e_in, best, lasts = carry
        d, R, mc = self.d, self.R, self.mc
        r = t - d
        if 0 <= r < self.nblocks:
            pid, within = divmod(r, self.npb)
            top, top_f = prev_bottom, prev_bottom_f
            with profiling.span("swtpu.pipe.fill"):
                if self.local and within == 0:
                    top = torch.zeros_like(prev_bottom)
                    top_f = torch.full_like(prev_bottom_f, NEGB)
                o = self._fill(a_of_pid(pid), b_full[r * R:(r + 1) * R], top,
                               left_in, top_f, left_e_in)
                score = o.best[0]
                cand = torch.stack([score, within * R + o.best[1],
                                    d * mc + o.best[2]])
                cur = best[pid]
                # score desc, then (i, j) asc: the first row-major occurrence
                upd = (score > 0) & ((score > cur[0]) | (
                    (score == cur[0]) & ((cand[1] < cur[1]) | (
                        (cand[1] == cur[1]) & (cand[2] < cur[2])))))
                best = best.clone()
                best[pid] = torch.where(upd, cand, cur)
                if within == self.npb - 1 and d == self.D - 1:
                    lasts = lasts.clone()
                    lasts[pid] = o.bottom_row[mc]
            prev_bottom = o.bottom_row
            halo = o.right_col
            if self.affine:
                prev_bottom_f = o.bottom_f
                halo_e = o.right_e
        else:
            # an inactive sender ships the global boundary
            halo = self._full(R + 1, 0 if self.local else NEGB)
            halo_e = self._full(R + 1, NEGB)
        with profiling.span("swtpu.pipe.halo"):
            if self.affine:
                nxt = shift(torch.stack([halo, halo_e]), self.mesh, self.axis)
                left_next = nxt[0]
                # rank 0 has no sender: E of column 0 is -inf
                left_e_next = self._full(R + 1, NEGB) if d == 0 else nxt[1]
            else:
                left_next = shift(halo, self.mesh, self.axis)
                left_e_next = left_e_in
        if not self.local and d == 0:
            # NW: rank 0's column 0 below block 0 is -inf
            left_next = self._full(R + 1, NEGB)
        return (prev_bottom, prev_bottom_f, left_next.contiguous(),
                left_e_next.contiguous(), best, lasts)

    def run(self, carry: tuple, a_of_pid, b_full, t0: int = 0,
            t1: Optional[int] = None) -> tuple:
        t1 = self.stages if t1 is None else min(t1, self.stages)
        for t in range(t0, t1):
            carry = self.stage(t, carry, a_of_pid, b_full)
        self._count(t0, t1)
        return carry

    def _count(self, t0: int, t1: int) -> None:
        """The pass's counters for stages [t0, t1) on this rank, so that a
        pass run in segments counts as one run whole; the block rows once,
        with its first stage."""
        if t1 <= t0 or not profiling.recording():
            return
        filled = max(0, min(t1, self.d + self.nblocks) - max(t0, self.d))
        sent = 0
        if self.d + 1 < self.D:
            words = (2 if self.affine else 1) * (self.R + 1)
            sent = (t1 - t0) * words * 4
        profiling.count("pipe.stages", t1 - t0)
        profiling.count("pipe.blocks", filled)
        profiling.count("pipe.halo_bytes", sent)
        if t0 == 0:
            profiling.count("pipe.block_rows", self.R)


def merge_best(mesh: Mesh, axis: str, best: torch.Tensor,
               lasts: torch.Tensor) -> tuple:
    """Cross-rank merge of the (P, 3) per-pair bests: score desc, then
    (i, j) asc, the first row-major occurrence, by three all-reduces
    (``_merge_best``); H[n, m] by a max, since only the axis' last rank
    holds it."""
    bs, bi, bj = best[:, 0], best[:, 1], best[:, 2]
    with profiling.span("swtpu.pipe.merge"):
        gbs = all_reduce(bs, "max", mesh, axis)
        win = bs == gbs
        gbi = all_reduce(torch.where(win, bi, _I32MAX), "min", mesh, axis)
        win &= bi == gbi
        gbj = all_reduce(torch.where(win, bj, _I32MAX), "min", mesh, axis)
        glast = all_reduce(lasts, "max", mesh, axis)
        none = gbs <= 0
        return (gbs.clamp(min=0), torch.where(none, 0, gbi),
                torch.where(none, 0, gbj), glast)


def _resolve(mesh: Mesh, axis: Optional[str]) -> str:
    axis = first_axis(check_mesh(mesh)) if axis is None else axis
    check_mesh(mesh, axis)
    return axis


def _sub_np(substitution) -> Optional[np.ndarray]:
    return None if substitution is None else check_table(substitution)


def make_pipeline(mesh: Mesh, m: int, n: int, block_rows: int,
                  scoring: Scoring = Scoring(), axis: Optional[str] = None,
                  mode: str = "local", substitution=None, T: Optional[int] = None):
    """(a (m,), b (n,)) -> PipelineResult for one n x m pair; m divides by
    the axis size D, n by ``block_rows``. Each rank fills its m/D columns.
    ``mode='global'`` runs the anchored Needleman-Wunsch recurrence (the
    mesh form of the anchored reverse locate pass): no zero floor, NEGB
    boundaries but the (0, 0) origin. ``T``: K5's threads per block."""
    axis = _resolve(mesh, axis)
    D = mesh.shape[axis]
    if m % D:
        raise ValueError(f"m={m} must divide across {D} ranks")
    if n % block_rows:
        raise ValueError(f"n={n} must divide by block_rows={block_rows}")
    if mode not in ("local", "global"):
        raise ValueError(f"mode must be 'local' or 'global', got {mode!r}")
    mc = m // D
    pipe = _Pipe(mesh, axis, mc, block_rows, n // block_rows,
                 n // block_rows, scoring, _sub_np(substitution),
                 mode == "local", T)

    def fn(a, b) -> PipelineResult:
        a_t, b_t = _codes(a, mesh.device), _codes(b, mesh.device)
        if a_t.shape != (m,) or b_t.shape != (n,):
            raise ValueError(f"want a ({m},) and b ({n},), got "
                             f"{tuple(a_t.shape)} and {tuple(b_t.shape)}")
        shard = a_t[pipe.d * mc:(pipe.d + 1) * mc]
        carry = pipe.run(pipe.carry0(), lambda pid: shard, b_t)
        s, i, j, last = merge_best(mesh, axis, carry[4], carry[5])
        return PipelineResult(s[0], i[0], j[0], last[0])

    fn.pipe = pipe
    return fn


def _pad_shapes(m: int, n: int, D: int, block_rows: int) -> tuple:
    return -(-max(m, 1) // D) * D, -(-max(n, 1) // block_rows) * block_rows


def pipeline_align(a_codes, b_codes, mesh: Mesh,
                   block_rows: Optional[int] = None,
                   scoring: Scoring = Scoring(), axis: Optional[str] = None,
                   substitution=None) -> PipelineResult:
    """Pad to divisibility and run the pipeline.

    Padding goes on the left and top: under the local zero floor a
    sentinel prefix (-1 for a, -2 for b) fills with exact zeros, so it
    only extends the zero boundary, the padded matrix's bottom-right
    corner is the true H[n, m], and max positions shift by the constant
    offsets. ``block_rows`` None: ``block_rows_for``."""
    axis = _resolve(mesh, axis)
    a_codes, b_codes = _host(a_codes), _host(b_codes)
    D = mesh.shape[axis]
    m, n = len(a_codes), len(b_codes)
    R = block_rows or block_rows_for(m, n, mesh, axis, scoring,
                                     substitution)
    mp, np_ = _pad_shapes(m, n, D, R)
    a_pad = np.full((mp,), -1, np.int8)
    a_pad[mp - m:] = a_codes
    b_pad = np.full((np_,), -2, np.int8)
    b_pad[np_ - n:] = b_codes
    fn = make_pipeline(mesh, mp, np_, R, scoring, axis,
                       substitution=substitution)
    res = fn(a_pad, b_pad)
    di, dj = np_ - n, mp - m
    if di or dj:
        has = res.max_score > 0
        res = PipelineResult(res.max_score,
                             torch.where(has, res.max_i - di, 0),
                             torch.where(has, res.max_j - dj, 0),
                             res.last_cell)
    return res


def _pipeline_nw_argmax(a_codes: np.ndarray, b_codes: np.ndarray,
                        mesh: Mesh, block_rows: Optional[int],
                        scoring: Scoring, axis: str,
                        substitution=None) -> tuple:
    """Anchored NW argmax over the mesh: (score, i, j) of the first
    row-major maximum of the global-mode DP with NEGB boundaries. Padding
    goes on the right and bottom, where the origin stays at (0, 0) and
    padded cells decay strictly, so they never tie the positive max."""
    D = mesh.shape[axis]
    m, n = len(a_codes), len(b_codes)
    R = block_rows or block_rows_for(m, n, mesh, axis, scoring,
                                     substitution)
    mp, np_ = _pad_shapes(m, n, D, R)
    a_pad = np.full((mp,), -1, np.int8)
    a_pad[:m] = a_codes
    b_pad = np.full((np_,), -2, np.int8)
    b_pad[:n] = b_codes
    fn = make_pipeline(mesh, mp, np_, R, scoring, axis, mode="global",
                       substitution=substitution)
    res = fn(a_pad, b_pad)
    return int(res.max_score), int(res.max_i), int(res.max_j)


def pipeline_locate(a_codes, b_codes, mesh: Mesh,
                    block_rows: Optional[int] = None,
                    scoring: Scoring = Scoring(), axis: Optional[str] = None,
                    substitution=None):
    """Locate across the mesh: the forward pipeline finds (score, end), an
    anchored NW pipeline over the reversed prefixes finds the start.
    ``block_rows`` None: the forward's ``projected_rows`` for both passes
    where there are any, else each pass's ``default_block_rows``. Returns
    a ``Located`` or None; raises ``AnchoredReverseMismatch`` when the
    reverse pass does not reach the forward score."""
    from ..engine.traceback import AnchoredReverseMismatch, Located
    axis = _resolve(mesh, axis)
    a_codes, b_codes = _host(a_codes), _host(b_codes)
    # the projection's rows, where there are any, serve both passes
    block_rows = block_rows or projected_rows(
        len(a_codes), len(b_codes), mesh, axis, scoring, substitution)
    fwd = pipeline_align(a_codes, b_codes, mesh, block_rows, scoring, axis,
                         substitution)
    score = int(fwd.max_score)
    if score <= 0:
        return None
    ei, ej = int(fwd.max_i), int(fwd.max_j)
    ar = a_codes[:ej][::-1].copy()
    br = b_codes[:ei][::-1].copy()
    # reversed operands keep the table's orientation, S[a', b']
    rs, ri, rj = _pipeline_nw_argmax(ar, br, mesh, block_rows, scoring,
                                     axis, substitution)
    if rs != score:
        raise AnchoredReverseMismatch(score, rs, ei, ej,
                                      int(fwd.last_cell))
    return Located(score, ei - ri + 1, ej - rj + 1, ei, ej,
                   int(fwd.last_cell))


def pipeline_traceback(a_codes, b_codes, mesh: Mesh,
                       block_rows: Optional[int] = None,
                       scoring: Scoring = Scoring(),
                       axis: Optional[str] = None,
                       max_window_cells: Optional[int] = None,
                       alphabet: str = "ACGT", substitution=None):
    """Alignment strings for a pair that needed the mesh: the pipeline
    locate, then a single-card windowed refill of the located window (K4
    and the tile-staged walk on a card) on the axis' rank 0, its result
    sent to every rank of the axis. Returns (score, Located, aligned_a,
    aligned_b) or None.

    A located window over ``max_window_cells`` takes
    ``engine.traceback.hirschberg`` (O(span) memory). When the anchored
    reverse pass misses the forward score, the full-P walk from the end
    recovers the alignment if [1..end] fits the budget; otherwise the
    typed ``AnchoredReverseMismatch`` propagates on every rank."""
    from ..engine import traceback as tb
    axis = _resolve(mesh, axis)
    a_codes, b_codes = _host(a_codes), _host(b_codes)
    sub = _sub_np(substitution)
    loc = err = None
    try:
        loc = pipeline_locate(a_codes, b_codes, mesh, block_rows, scoring,
                              axis, sub)
    except tb.AnchoredReverseMismatch as e:
        budget = max_window_cells if max_window_cells is not None \
            else (1 << 26)
        if e.end_i * e.end_j > budget:
            raise
        err = e
    if loc is None and err is None:
        return None
    got = None
    if mesh.index(axis) == 0:
        if err is not None:
            got = tb.walk_from_end(a_codes, b_codes, scoring,
                                   err.forward_score, err.end_i, err.end_j,
                                   err.last_cell, alphabet=alphabet,
                                   sub=sub, device=mesh.device)
        else:
            got = tb.windowed(a_codes, b_codes, scoring,
                              max_window_cells=max_window_cells, loc=loc,
                              alphabet=alphabet, sub=sub,
                              device=mesh.device)
    return broadcast_object(got, mesh, axis)


def make_pipeline_batch(mesh: Mesh, P_pairs: int, m: int, n: int,
                        block_rows: int, scoring: Scoring = Scoring(),
                        axis: Optional[str] = None, substitution=None):
    """Bubble-filled pipeline: P same-shape pairs stream back to back
    through the block wavefront, so the D - 1 ramp stages amortize over
    P * n / block_rows stages. Each pair's first block row resets the top
    boundary to zeros (F to NEGB); the per-pair bests update at the
    block's pair. Returns fn(a_batch (P, m), b_batch (P, n)) -> (scores,
    max_i, max_j, last_cells), each (P,) int32."""
    axis = _resolve(mesh, axis)
    D = mesh.shape[axis]
    if m % D:
        raise ValueError(f"m={m} must divide across {D} ranks")
    if n % block_rows:
        raise ValueError(f"n={n} must divide by block_rows={block_rows}")
    mc = m // D
    npb = n // block_rows
    pipe = _Pipe(mesh, axis, mc, block_rows, P_pairs * npb, npb, scoring,
                 _sub_np(substitution), True)

    def fn(a_batch, b_batch) -> tuple:
        a_t, b_t = _codes(a_batch, mesh.device), _codes(b_batch, mesh.device)
        if a_t.shape != (P_pairs, m) or b_t.shape != (P_pairs, n):
            raise ValueError(f"want a ({P_pairs}, {m}) and b ({P_pairs}, "
                             f"{n}), got {tuple(a_t.shape)} and "
                             f"{tuple(b_t.shape)}")
        shards = a_t[:, pipe.d * mc:(pipe.d + 1) * mc].contiguous()
        carry = pipe.run(pipe.carry0(P_pairs), lambda pid: shards[pid],
                         b_t.reshape(-1))
        return merge_best(mesh, axis, carry[4], carry[5])

    fn.pipe = pipe
    return fn


def pipeline_align_batch(a_batch, b_batch, mesh: Mesh,
                         block_rows: Optional[int] = None,
                         scoring: Scoring = Scoring(),
                         axis: Optional[str] = None,
                         substitution=None) -> PipelineBatchResult:
    """The bubble-filled batch pipeline for P same-shape pairs (P, m) x
    (P, n), padded as ``pipeline_align`` pads (left and top sentinels, the
    positions shifted back; ``block_rows`` None: ``block_rows_for``)."""
    axis = _resolve(mesh, axis)
    a_batch = _host(a_batch)
    b_batch = _host(b_batch)
    Pp, m = a_batch.shape
    n = b_batch.shape[1]
    D = mesh.shape[axis]
    R = block_rows or block_rows_for(m, n, mesh, axis, scoring,
                                     substitution)
    mp, np_ = _pad_shapes(m, n, D, R)
    a_pad = np.full((Pp, mp), -1, np.int8)
    a_pad[:, mp - m:] = a_batch
    b_pad = np.full((Pp, np_), -2, np.int8)
    b_pad[:, np_ - n:] = b_batch
    fn = make_pipeline_batch(mesh, Pp, mp, np_, R, scoring, axis,
                             substitution=substitution)
    s, bi, bj, lasts = fn(a_pad, b_pad)
    di, dj = np_ - n, mp - m
    if di or dj:
        has = s > 0
        bi = torch.where(has, bi - di, 0)
        bj = torch.where(has, bj - dj, 0)
    return PipelineBatchResult(s, bi, bj, lasts)
