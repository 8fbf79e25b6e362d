"""Top-level alignment engine: ``align()`` and ``score()`` for one pair.

Counterpart of ``swtpu.engine.align`` with an explicit ``device``. Plans:
'stripe' (the hand-written CUDA kernels, on a CUDA device), 'scan' (the
PyTorch sweep, on any device), 'host' (the native serial fill on the host,
``runtime_native.fill``, its P walked there and the strings rendered by
the oracle, on either device) and 'pipeline' (the column-stripe pipeline
across the ranks of a mesh, ``dist.pipeline``); 'auto' lets
``dispatch.plan.choose_exec`` decide (its tiers, its profit gate of the
pipeline across the cards of a mesh, and tuned (T, R, C)), and takes the
pipeline for a pair wider than the kernels' MAX_WIDTH. Before
dispatch, an 'auto' score-only unbanded call on a CUDA device of at most
``config.simd_cells_cap()`` cells runs the striped SIMD fill on the host
(``runtime_native.score_simd_pos``) where it is eligible. On the CPU
'auto' takes neither host tier. 'pipeline' runs on ``mesh=``, or on the
whole initialized process group (``dist.mesh.default_mesh``); with
neither, or for ``return_matrices`` or a band, it runs the single-card
plans, as the JAX package does on one device. Under 'auto' the profit
gate sends a pair to the pipeline only across the D >= 2 cards of
``mesh=``: a call without a mesh stays on one card below MAX_WIDTH and
enters no collective. On such a mesh an 'auto' call is a collective of
its ranks, which route together: each rank's own verdict (the gate, or
a pair wider than one kernel) and its pair's sizes go through one
all-reduce (``dist.pipeline.agree``), and the call takes the mesh only
where every rank's verdict holds for the same sizes; otherwise every
rank keeps to its own card. ``Alignment.plan`` says
which plan ran ('host-simd' for the SIMD tier). With a mesh every rank of
it calls the same function and the mesh's device serves the call. A
request for ``device='cuda'`` on a machine without a card raises, for a
pair of any size; it never carries on on the CPU.

Scoring: linear or affine (Gotoh) gaps, with the match/mismatch compare or,
given ``substitution=``, an (A, A) table S[a_code, b_code] such as
``core.substitution.BLOSUM62`` (protein codes over ``PROTEIN_ALPHABET``).

Traceback up to ``full_p_max_cells`` walks the full predecessor matrix P
on the host (``oracle.backtrack``), the JAX package's exact route. Above
it, ``traceback_method='auto'`` takes the lean route of
``engine.traceback``: ``windowed`` (locate by a forward score pass and an
anchored reverse NW pass, refill the window with P and walk it on the
device), or ``hirschberg`` (linear space), either returning the strings
without ``path``; on a card its passes launch the kernels whatever the
plan where they take the scoring (negative penalties), and the plain
versions on the card where they do not. ``config.band`` keeps the cells
with |i - j| <= band, on score-only calls too, and always takes full P.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .. import runtime_native as rn
from ..core import oracle
from ..core.config import EngineConfig, Scoring
from ..core.encode import DNA_ALPHABET, encode
from ..core.substitution import check_table
from ..dispatch.plan import choose_exec
from ..dist.mesh import check_mesh, default_mesh
from ..instrument import profiling
from ..kernels.scan_fill import diag_to_rowmajor, embed_table, scan_fill
from ..kernels.stripe_fill import (MAX_WIDTH, stripe_fill,
                                   stripe_fill_supported, stripe_score)
from . import traceback as tb


@dataclasses.dataclass
class Alignment:
    """Structured result record."""

    max_score: int
    max_i: int                 # padded row index of the first global max
    max_j: int                 # padded col index
    last_cell: int             # H[n, m] — the reference's H[m*n-1] invariant
    aligned_a: Optional[str] = None
    aligned_b: Optional[str] = None
    path: Optional[list] = None          # row-major indices, end-first
    H: Optional[np.ndarray] = None       # (n+1, m+1) when return_matrices
    P: Optional[np.ndarray] = None
    plan: Optional[str] = None           # the plan that ran

    @property
    def max_pos(self) -> int:
        """Row-major padded index — the reference's maxPos."""
        if self.P is not None:
            m1 = self.P.shape[1]
        else:
            m1 = self._m1
        return self.max_i * m1 + self.max_j

    _m1: int = 0  # padded width, set by the engine


def _as_codes(seq, alphabet: str = DNA_ALPHABET) -> np.ndarray:
    if isinstance(seq, str):
        return encode(seq, alphabet)
    # contiguous: a reversed view (revcomp) has negative strides, which
    # torch.from_numpy refuses
    return np.ascontiguousarray(seq, dtype=np.int8)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device for a request; raises for 'cuda' without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the scan plan")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


def _host_codes_ok(a_codes, b_codes, sub_np) -> bool:
    """The serial fill takes any codes without a table, and codes in [0,
    A) with one."""
    if sub_np is None:
        return True
    nsym = sub_np.shape[0]
    return bool((a_codes >= 0).all() and (a_codes < nsym).all()
                and (b_codes >= 0).all() and (b_codes < nsym).all())


def _host_path(a_codes, b_codes, scoring: Scoring, sub_np, want_tb: bool,
               return_matrices: bool, alphabet: str) -> Alignment:
    """The 'host' plan: the native serial fill, its P walked on the host
    (natively in linear mode, by the oracle's state machine in affine
    mode, as the JAX package walks it) and the strings rendered by the
    oracle."""
    m, n = len(a_codes), len(b_codes)
    out = rn.fill(a_codes, b_codes, scoring, sub_np)
    bi, bj = out.max_ij
    res = Alignment(max_score=out.max_score, max_i=bi, max_j=bj,
                    last_cell=int(out.H[n, m]),
                    H=out.H if return_matrices else None,
                    P=out.P if return_matrices else None, plan="host")
    res._m1 = m + 1
    if want_tb and out.max_score > 0:
        with profiling.span("swtpu.tb.strings"):
            walk = oracle.backtrack if scoring.is_affine else rn.traceback
            res.path = walk(out.P, out.max_pos)
            res.aligned_a, res.aligned_b = oracle.alignment_strings(
                a_codes, b_codes, out.P, out.max_pos, alphabet=alphabet)
    return res


def stripe_call(a_codes, b_codes, scoring: Scoring, sub_np,
                dev: torch.device, want_tb: bool = False,
                band: Optional[int] = None, T: Optional[int] = None,
                R: Optional[int] = None, C: Optional[int] = None) -> tuple:
    """The stripe plan's card work: the codes (and table) to ``dev``, one
    kernel launch at (T, R, C), one fetch of the (4,) result. Returns
    ([max, i, j, last], P on the host or None)."""
    with profiling.span("swtpu.fill.prep"):
        a_t, b_t, sub_t = _upload(a_codes, b_codes, sub_np, dev)
    with profiling.span("swtpu.fill.run"):
        fill = stripe_fill if want_tb else stripe_score
        out = fill(a_t, b_t, scoring, T=T, substitution=sub_t, band=band,
                   R=R, C=C)
    with profiling.span("swtpu.fill.fetch"):
        vals = out.best.tolist()                         # one small fetch
        return vals, (out.P.cpu().numpy() if want_tb else None)


def _upload(a_codes, b_codes, sub_np, dev: torch.device) -> tuple:
    """The codes and the table (or None) on ``dev``, counted as
    ``h2d_bytes``."""
    profiling.count("h2d_bytes", a_codes.nbytes + b_codes.nbytes
                    + (0 if sub_np is None else sub_np.nbytes))
    return (torch.from_numpy(a_codes).to(dev),
            torch.from_numpy(b_codes).to(dev),
            None if sub_np is None else torch.from_numpy(sub_np).to(dev))


def _resolve_traceback_method(m: int, n: int, config: EngineConfig) -> str:
    """'auto' -> 'full' up to full_p_max_cells, 'windowed' above; a banded
    problem always takes 'full'."""
    method = config.traceback_method
    if method == "auto":
        method = "full" if m * n <= config.full_p_max_cells else "windowed"
    if config.band is not None:
        method = "full"
    return method


@profiling.spanned("swtpu.align")
def align(
    a: Union[str, np.ndarray],
    b: Union[str, np.ndarray],
    scoring: Scoring = Scoring(),
    config: EngineConfig = EngineConfig(),
    *,
    traceback: Optional[bool] = None,
    return_matrices: bool = False,
    plan: Optional[str] = None,
    substitution: Optional[np.ndarray] = None,
    alphabet: str = DNA_ALPHABET,
    device: Union[str, torch.device] = "cuda",
    mesh=None,
) -> Alignment:
    """Align sequence ``a`` (columns, length m) against ``b`` (rows, length
    n) on ``device``. Plans: 'stripe', 'scan', 'pipeline', or None/'auto'.
    ``substitution``: optional (A, A) integer table S[a_code, b_code] in
    place of the match/mismatch compare; codes must then lie in [-3, A).
    ``mesh``: a ``dist.mesh.Mesh`` for the pipeline, whose device then
    serves the call. The device is resolved first, so a request for a
    card that is not there raises whatever the pair's size."""
    if mesh is not None:
        dev = check_mesh(mesh).device
    else:
        dev = resolve_device(device)
    with profiling.span("swtpu.encode"):
        a_codes = _as_codes(a, alphabet)
        b_codes = _as_codes(b, alphabet)
        sub_np = None if substitution is None else check_table(substitution)
    m, n = len(a_codes), len(b_codes)
    want_tb = config.traceback if traceback is None else traceback

    with profiling.span("swtpu.dispatch"):
        auto = plan in (None, "auto")
        simd = auto and m > 0 and n > 0 and dev.type == "cuda" \
            and not want_tb and not return_matrices and config.band is None \
            and rn.simd_shape_ok(m, n, scoring, sub_np) \
            and m * n <= config.simd_cells_cap()
        # on a mesh of cards, every rank of it decides the route together,
        # before any rank returns: the pipeline, or each on its own card
        alone = piped = False
        if auto and mesh is not None:
            from ..dist import pipeline as pl
            if pl.pipeline_devices(mesh) >= 2:
                own = m > 0 and n > 0 and not simd and not return_matrices \
                    and config.band is None and (m > MAX_WIDTH or choose_exec(
                        m, n, config, scoring, want_tb, dev,
                        substitution=sub_np, mesh=mesh).plan == "pipeline")
                piped = pl.agree(mesh, own, (m, n, want_tb, scoring.is_affine,
                                             sub_np is not None))
                alone = not piped
    if piped:
        return _pipeline_path(a_codes, b_codes, scoring, mesh, want_tb,
                              alphabet, sub_np)

    if m == 0 or n == 0:
        # Degenerate: an empty sequence aligns to nothing (all-zero matrix).
        res = Alignment(max_score=0, max_i=0, max_j=0, last_cell=0)
        if return_matrices:
            res.H = np.zeros((n + 1, m + 1), np.int32)
            res.P = np.zeros((n + 1, m + 1), np.int8)
        res._m1 = m + 1
        return res

    # the score-only SIMD tier on the host, below the card's per-call
    # floor: the score, the first end cell and the last cell
    if simd:
        got = rn.score_simd_pos(a_codes, b_codes, scoring, sub_np)
        if got is not None:
            s, bi, bj, last = got
            res = Alignment(max_score=s, max_i=bi, max_j=bj, last_cell=last,
                            plan="host-simd")
            res._m1 = m + 1
            return res

    with profiling.span("swtpu.dispatch"):
        if auto and m > MAX_WIDTH:
            plan = "pipeline"       # wider than one kernel
        if plan == "pipeline" and not alone:
            mesh = mesh if mesh is not None else default_mesh(dev)
            piped = mesh is not None and not return_matrices \
                and config.band is None
        if plan == "pipeline":
            plan = None             # no mesh: the single-card plans
        exec_plan = None
        if plan in (None, "auto") and not piped:
            # one card: the gate, which counts a mesh's cards, is not asked
            exec_plan = choose_exec(m, n, config, scoring, want_tb, dev,
                                    substitution=sub_np)
            plan = exec_plan.plan
            if plan == "pipeline":  # wider than one kernel, and no mesh
                plan = "scan"
    if piped:
        return _pipeline_path(a_codes, b_codes, scoring, mesh, want_tb,
                              alphabet, sub_np)
    if plan not in ("stripe", "scan", "host"):
        raise ValueError(f"unknown plan {plan!r} (use 'stripe', 'scan', "
                         "'host' or 'pipeline')")
    if plan == "host":
        if config.band is None and _host_codes_ok(a_codes, b_codes, sub_np):
            return _host_path(a_codes, b_codes, scoring, sub_np, want_tb,
                              return_matrices, alphabet)
        # a band, or a table's sentinel codes: the device's plans
        plan = ("stripe" if dev.type == "cuda" and stripe_fill_supported(
            m, n, want_tb, scoring, sub_np) else "scan")
    # the tuned (T, R, C), unless the caller named the kernel's shape
    kern = dict(T=config.stripe_rows, R=None, C=None)
    if exec_plan is not None and exec_plan.source == "tuned" \
            and config.stripe_rows is None \
            and config.stripe_rows_per_lane is None:
        kern = dict(T=exec_plan.T, R=exec_plan.R, C=exec_plan.C)

    # memory-lean traceback: locate + windowed refill / Hirschberg, no
    # full P (engine/traceback.py); like the JAX package, it serves every
    # plan, on a card through the kernels
    method = _resolve_traceback_method(m, n, config)
    if want_tb and method in ("windowed", "hirschberg") \
            and not return_matrices:
        lean = tb.windowed if method == "windowed" else tb.hirschberg
        got = lean(a_codes, b_codes, scoring, sub=sub_np, alphabet=alphabet,
                   device=dev)
        if got is None:
            res = Alignment(max_score=0, max_i=0, max_j=0, last_cell=0)
        else:
            score_v, loc, ra, rb = got
            res = Alignment(max_score=score_v, max_i=loc.end_i,
                            max_j=loc.end_j, last_cell=loc.last_cell,
                            aligned_a=ra, aligned_b=rb)
        res.plan = plan
        res._m1 = m + 1
        return res

    if plan == "stripe" and (return_matrices or not stripe_fill_supported(
            m, n, want_tb, scoring, sub_np)):
        plan = "scan"     # the stripe kernels never materialize H

    H = P = None
    if plan == "stripe":
        vals, P = stripe_call(a_codes, b_codes, scoring, sub_np, dev,
                              want_tb, config.band, **kern)
    else:
        with profiling.span("swtpu.fill.prep"):
            a_t, b_t, sub_t = _upload(a_codes, b_codes, sub_np, dev)
            table = None if sub_t is None else embed_table(sub_t)
        with profiling.span("swtpu.fill.run"):
            out = scan_fill(a_t, b_t, scoring=scoring,
                            return_p=want_tb or return_matrices,
                            return_h=return_matrices, band=config.band,
                            sub_table=table)
        with profiling.span("swtpu.fill.fetch"):
            vals = torch.stack([out.max_score, out.max_i, out.max_j,
                                out.last_cell]).tolist()
            if out.p_diag is not None:
                P = diag_to_rowmajor(out.p_diag, n, m).cpu().numpy()
            if out.h_diag is not None:
                H = diag_to_rowmajor(out.h_diag, n, m).cpu().numpy()

    s, bi, bj, last = vals
    res = Alignment(max_score=s, max_i=bi, max_j=bj, last_cell=last,
                    H=H if return_matrices else None,
                    P=P if return_matrices else None, plan=plan)
    res._m1 = m + 1
    if want_tb and P is not None and res.max_score > 0:
        with profiling.span("swtpu.tb.strings"):
            max_pos = res.max_i * (m + 1) + res.max_j
            res.path = oracle.backtrack(P, max_pos)
            res.aligned_a, res.aligned_b = oracle.alignment_strings(
                a_codes, b_codes, P, max_pos, alphabet=alphabet)
    return res


def _pipeline_path(a_codes, b_codes, scoring: Scoring, mesh, want_tb: bool,
                   alphabet: str, sub_np) -> Alignment:
    """The pipeline across the mesh: the score (``pipeline_align``), or
    the locate and a windowed refill (``pipeline_traceback``), whose
    strings come without ``path``. Block rows: the dist layer's
    (``dist.pipeline.block_rows_for``), one height for every pass of a
    call. Its span is ``swtpu.pipe``; the score's fetch, which waits for
    the merge's all-reduces, is a part of ``swtpu.pipe.merge``."""
    from ..dist import pipeline as pl
    m = len(a_codes)
    with profiling.span("swtpu.pipe"):
        if not want_tb:
            out = pl.pipeline_align(a_codes, b_codes, mesh, scoring=scoring,
                                    substitution=sub_np)
            with profiling.span("swtpu.pipe.merge"):
                s, i, j, last = torch.stack(list(out)).tolist()
            res = Alignment(max_score=s, max_i=i, max_j=j, last_cell=last)
        else:
            got = pl.pipeline_traceback(a_codes, b_codes, mesh,
                                        scoring=scoring, alphabet=alphabet,
                                        substitution=sub_np)
            if got is None:
                res = Alignment(max_score=0, max_i=0, max_j=0, last_cell=0)
            else:
                score_v, loc, ra, rb = got
                res = Alignment(max_score=score_v, max_i=loc.end_i,
                                max_j=loc.end_j, last_cell=loc.last_cell,
                                aligned_a=ra, aligned_b=rb)
    res.plan = "pipeline"
    res._m1 = m + 1
    return res


def score(
    a: Union[str, np.ndarray],
    b: Union[str, np.ndarray],
    scoring: Scoring = Scoring(),
    config: EngineConfig = EngineConfig(),
    *,
    plan: Optional[str] = None,
    substitution: Optional[np.ndarray] = None,
    alphabet: str = DNA_ALPHABET,
    device: Union[str, torch.device] = "cuda",
    mesh=None,
) -> int:
    """Score-only fast path (the -DSKIP_BACKTRACK benchmark mode).

    The max score is symmetric under transposing the DP matrix, so thin
    problems are swapped to put the long side in rows, where the stripe
    wavefront's parallelism is. Positions are NOT symmetric (tie order),
    which is why align() never does this. A substitution table is
    transposed with the pair, so S[a_code, b_code] keeps its meaning."""
    a_codes = _as_codes(a, alphabet)
    b_codes = _as_codes(b, alphabet)
    sub = substitution
    if len(a_codes) > 2 * len(b_codes):
        a_codes, b_codes = b_codes, a_codes
        if sub is not None:
            sub = np.asarray(sub).T
    return align(a_codes, b_codes, scoring, config, traceback=False,
                 plan=plan, substitution=sub, device=device,
                 mesh=mesh).max_score
