"""Execution-plan dispatch for one pair.

The port decides by the device of the request. On a CUDA device, a
problem the stripe kernels take (``stripe_fill_supported``, the JAX
package's gates: negative penalties, or negative gaps with a substitution
table) runs the ``stripe`` plan, the hand-written CUDA kernels, banded or
not;
anything else runs the ``scan`` plan, as the JAX package does for a
scoring its kernel rejects. On the CPU the ``scan`` plan runs.

Not ported yet (ROADMAP Queue 1, "host tiers via ctypes" and
"dispatch/plan.py tiers + dispatch/autotune.py"): the JAX package's host
tiers (native serial fill, striped SIMD score), its tuned table and
autotune, live ``observe`` feedback and the multi-device pipeline tier.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import EngineConfig, Scoring
from ..kernels.stripe_fill import stripe_fill_supported


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """A resolved execution decision. The JAX package's tuned kernel
    fields (T, R, CB, C, unroll) come with the tuned table."""

    plan: str                      # 'scan' | 'stripe'


def choose_exec(m: int, n: int, config: EngineConfig = EngineConfig(),
                scoring: Scoring = Scoring(), traceback: bool = False,
                device: torch.device = torch.device("cuda"),
                substitution=None) -> ExecPlan:
    """Plan for a problem of m columns and n rows on ``device``;
    ``substitution``: the (A, A) table, or None for match/mismatch."""
    if device.type == "cuda" and stripe_fill_supported(
            m, n, traceback, scoring, substitution):
        return ExecPlan("stripe")
    return ExecPlan("scan")
