"""Execution-plan dispatch for one pair.

Counterpart of ``swtpu.dispatch.plan``. ``choose_exec`` resolves the plan
and the kernel's (T, R, C) of an ``align()``/``score()`` with plan 'auto',
in this order:

* 'pipeline' for a pair wider than the kernels' MAX_WIDTH;
* on the CPU, 'scan', the plain versions: the CPU is the port's test and
  reference device, and ``auto`` keeps it off the host tiers (the JAX
  package takes them off the TPU; ``plan='host'`` runs them anywhere);
* on a CUDA device, 'host', the native serial fill on the host, for an
  unbanded pair of at most ``config.host_max_cells`` cells, where the
  fill and the host walk beat a launch, a sync and the copy of P;
* 'scan' for a scoring the kernels refuse (``stripe_fill_supported``, the
  JAX package's gates);
* 'pipeline' (source 'projected'), the column-stripe pipeline across the
  cards of the mesh the call names (``mesh=``), for an unbanded pair
  where ``pipeline_projection`` puts it at least ``PIPE_MIN_SPEEDUP``
  ahead of one card: D >= 2 cards (``pipeline_devices``) and a cost
  record fitted on this card (``cost.load_record``). A call without a
  mesh stays on one card. The gate reads m, n, D, the scoring and the
  record, never a timing; since ranks may hold different pairs or
  records, ``engine.align`` has the mesh's ranks agree on the route
  (``dist.pipeline.agree``) before any of them takes the mesh;
* for a score-only unbanded call, the nearest entry of the tuned table of
  the same scoring signature (``autotune.Policy.choose_near``), held to
  the shapes the kernels take (``_sanitize``): ('stripe', T, R, C,
  source 'tuned'). A sweep writes a winner into an entry only where it
  beat the kernels' defaults by more than the sweep's own spread between
  two rounds; an entry without one keeps the defaults;
* 'stripe', the kernels at their defaults.

The score-only ``host-simd`` tier comes before dispatch, in
``engine.align`` (``EngineConfig.simd_cells_cap``). The table loads once a
process from ``SWTPU_TORCH_TUNED_TABLE``, else the committed
``dispatch/tuned_h100.json``, and only when it was tuned on this process's
card (``autotune.load``); the JAX package's TPU tables are never read.
Calls do not feed the table: it changes only by a sweep
(``python -m swtpu_torch.dispatch.autotune``).

``choose_plan`` is its plan name alone.

``pipeline_projection`` is the JAX package's: the D-card pipeline's
stages, each a K5 block of m / D columns plus the measured per-stage
overhead (``pipe_stage_overhead``), against one card's ``score()``, both
from the card's step model (``dispatch.cost``), over a geometric grid of
block rows; it also sizes the pipeline's blocks (``dist.pipeline``,
where the axis' rank 0's rows serve every rank).
Without a record fitted on this card it projects (0.0, 0): the gate stays
off and the pipeline keeps ``dist.pipeline.default_block_rows``. The
overhead was measured on a world-1 mesh, whose halo exchanges nothing: no
cross-card halo is in it.

``runs_kernels`` is the gate of every route that has a kernel and its
plain version (the lean traceback's passes, the batch, the search, the
pipeline's block fill): on a card, the kernels where they take the
scoring, and the plain version on the card where they do not, decided
before any launch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..core.config import EngineConfig, Scoring
from ..kernels.stripe_fill import (MAX_WIDTH, _mode, kernels_take, rb_shape,
                                   stripe_fill_supported)
from .cost import load_record, stripe_cost_s

TABLE_ENV = "SWTPU_TORCH_TUNED_TABLE"
# the projected speedup the mesh must reach before a pair leaves one card:
# a margin over the model, not a measurement
PIPE_MIN_SPEEDUP = 1.5


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """A resolved execution decision: the plan and, for 'stripe', the
    kernel's threads per block and tile (None: the kernel's default).
    ``source`` says what decided: 'threshold', 'tuned' or 'projected'."""

    plan: str                      # 'host' | 'scan' | 'stripe' | 'pipeline'
    T: Optional[int] = None
    R: Optional[int] = None
    C: Optional[int] = None
    source: str = "threshold"


_policy_cache: dict = {"loaded": False, "policy": None}


def _tuned_policy():
    """The session's ``autotune.Policy``, its table loaded once a process
    from ``SWTPU_TORCH_TUNED_TABLE`` or the committed table, or None when
    there is none tuned on this card."""
    from .autotune import DEFAULT_TABLE, Policy, load
    if not _policy_cache["loaded"]:
        _policy_cache["loaded"] = True
        table = load(os.environ.get(TABLE_ENV) or DEFAULT_TABLE)
        if table:
            _policy_cache["policy"] = Policy(table)
    return _policy_cache["policy"]


def _sanitize(e: dict, n: int, scoring: Scoring = Scoring(),
              substitution=None) -> Optional[ExecPlan]:
    """A tuned row as an ExecPlan of a score-only call over n rows, or None
    unless it names the stripe plan and a (T, R, C) that ``rb_shape``
    takes for this scoring's form: a tile it instantiates and a T it
    launches. Dispatch never emits a shape the kernels refuse."""
    if e.get("plan", "stripe") != "stripe":
        return None
    T, R, C = e.get("T"), e.get("R"), e.get("C")
    A = 0 if substitution is None else len(substitution)
    try:
        rb_shape(n, T, R, C, _mode(scoring, substitution), A, "score")
    except (TypeError, ValueError):
        return None
    return ExecPlan("stripe", T=T, R=R, C=C, source="tuned")


def pipe_stage_overhead(scoring: Scoring = Scoring(),
                        substitution=None) -> Optional[float]:
    """Seconds a pipeline stage costs beyond its K5 launch in this
    scoring's form: the median over the fit's shapes of the world-1
    pipeline's stage wall less K5's launch alone, from the record fitted
    on this card (``cost.load_record``), or None without one. At world 1
    the halo exchanges nothing, so no cross-card halo is in it."""
    rec = load_record()
    return None if rec is None else \
        rec["overhead_s"][_mode(scoring, substitution)]


def pipeline_devices(mesh=None, axis: Optional[str] = None) -> int:
    """The cards along the pipeline axis ``axis`` (default its first) of
    ``mesh``: its ranks, each on a card of its own (NCCL); for ranks that
    exchange through host memory (gloo, ``Mesh.host_transport``) the
    cards among them, a rank's card ``LOCAL_RANK`` modulo the cards of the
    machine, so that ranks sharing one card count as one. 1 without a
    mesh, and for a mesh on the CPU."""
    if mesh is None or mesh.device.type != "cuda":
        return 1
    D = mesh.shape[axis or mesh.axis_names[0]]
    if D < 2:
        return 1
    return max(1, min(D, torch.cuda.device_count())) \
        if mesh.host_transport else D


def pipeline_projection(m: int, n: int, D: int, scoring: Scoring = Scoring(),
                        substitution=None,
                        block_rows: Optional[int] = None) -> tuple:
    """(projected speedup, best block rows) of the D-card column-stripe
    pipeline over one card's ``score()``: the single card's modelled time
    (``cost.stripe_cost_s``, kind 'score') over (blocks + D - 1) stages,
    each a K5 block of ceil(m / D) columns and ``block_rows`` rows (kind
    'block') plus ``pipe_stage_overhead``, maximized over block rows from
    one stripe of K5 (its T x R) up to n / D, doubling (fewer blocks than
    cards leave cards idle), or at ``block_rows`` alone. (0.0, 0) for D <
    2, and without a cost record fitted on this card."""
    rec = load_record() if D >= 2 else None
    if rec is None:
        return 0.0, 0
    form = _mode(scoring, substitution)
    single = stripe_cost_s(m, n, scoring, substitution, "score", record=rec)
    over = rec["overhead_s"][form]
    mc = -(-m // D)
    if block_rows:
        cands = [block_rows]
    else:
        A = 0 if substitution is None else len(substitution)
        T, R, _ = rb_shape(max(n, 1), None, None, None, form, A, "block")
        cands, br = [], T * R
        while br <= max(T * R, n // D):
            cands.append(br)
            br *= 2
    best, best_br = 0.0, 0
    for br in cands:
        br = min(br, n)
        stage = stripe_cost_s(mc, br, scoring, substitution, "block",
                              record=rec) + over
        speedup = single / ((-(-n // br) + D - 1) * stage)
        if speedup > best:
            best, best_br = speedup, br
    return best, best_br


def choose_exec(m: int, n: int, config: EngineConfig = EngineConfig(),
                scoring: Scoring = Scoring(), traceback: bool = False,
                device: torch.device = torch.device("cuda"),
                substitution=None, mesh=None) -> ExecPlan:
    """Plan for a problem of m columns and n rows on ``device`` (the tier
    order of the module docstring); ``substitution``: the (A, A) table, or
    None for match/mismatch; ``mesh``: the mesh the call names, whose
    pipeline axis' cards the profit gate counts (``pipeline_devices``;
    None: one card)."""
    if m > MAX_WIDTH:
        return ExecPlan("pipeline")
    if device.type != "cuda":
        return ExecPlan("scan")
    if m * n <= config.host_max_cells and config.band is None:
        return ExecPlan("host")
    if not stripe_fill_supported(m, n, traceback, scoring, substitution):
        return ExecPlan("scan")
    if config.band is None:
        D = pipeline_devices(mesh)
        if D >= 2 and pipeline_projection(
                m, n, D, scoring, substitution)[0] >= PIPE_MIN_SPEEDUP:
            return ExecPlan("pipeline", source="projected")
    if not traceback and config.band is None:
        pol = _tuned_policy()
        if pol is not None:
            from .autotune import scoring_sig
            e = pol.choose_near(m, n, sig=scoring_sig(scoring, substitution))
            got = None if e is None else _sanitize(e, n, scoring,
                                                   substitution)
            if got is not None:
                return got
    return ExecPlan("stripe")


def choose_plan(m: int, n: int, config: EngineConfig = EngineConfig(),
                device: torch.device = torch.device("cuda")) -> str:
    """The plan name alone of ``choose_exec`` for an m x n problem of the
    default scoring on ``device``."""
    return choose_exec(m, n, config, device=torch.device(device)).plan


def runs_kernels(device: torch.device, scoring: Scoring = Scoring(),
                 substitution=None, m: int = 1, n: int = 1) -> bool:
    """Does a route on ``device`` launch the kernels for this scoring and
    an m x n problem? On a CUDA device where ``kernels_take``; never on
    the CPU, where the plain versions run."""
    return device.type == "cuda" and kernels_take(m, n, scoring,
                                                  substitution)
