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

Not ported: the JAX package's cost model that picks the multi-device
pipeline below MAX_WIDTH (``pipeline_projection``): ``plan='pipeline'``
is asked for, or taken above MAX_WIDTH.

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

TABLE_ENV = "SWTPU_TORCH_TUNED_TABLE"


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """A resolved execution decision: the plan and, for 'stripe', the
    kernel's threads per block and tile (None: the kernel's default).
    ``source`` says what decided: 'threshold' or 'tuned'."""

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


def choose_exec(m: int, n: int, config: EngineConfig = EngineConfig(),
                scoring: Scoring = Scoring(), traceback: bool = False,
                device: torch.device = torch.device("cuda"),
                substitution=None) -> ExecPlan:
    """Plan for a problem of m columns and n rows on ``device`` (the tier
    order of the module docstring); ``substitution``: the (A, A) table, or
    None for match/mismatch."""
    if m > MAX_WIDTH:
        return ExecPlan("pipeline")
    if device.type != "cuda":
        return ExecPlan("scan")
    if m * n <= config.host_max_cells and config.band is None:
        return ExecPlan("host")
    if not stripe_fill_supported(m, n, traceback, scoring, substitution):
        return ExecPlan("scan")
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


def runs_kernels(device: torch.device, scoring: Scoring = Scoring(),
                 substitution=None, m: int = 1, n: int = 1) -> bool:
    """Does a route on ``device`` launch the kernels for this scoring and
    an m x n problem? On a CUDA device where ``kernels_take``; never on
    the CPU, where the plain versions run."""
    return device.type == "cuda" and kernels_take(m, n, scoring,
                                                  substitution)
