"""A step model of the register-blocked stripe, fitted on the card.

Counterpart of ``swtpu.kernels.pallas_fill.choose_params_cost``, whose
constants describe the TPU's vector unit and stay behind. Here a call's
time is

    floor_s + max(steps x step_s, cells / rate_cps)

* ``steps`` is the chain of the launch's geometry (``stripe_steps``, at
  the default (T, R, C) ``stripe_fill.rb_shape`` resolves, the only
  shape the constants were fitted at): thread k of a stripe
  visits its tile of columns (t - k) C + 1 .. + C at step t, so a stripe
  takes ceil(m / C) + T - 1 steps; the stripe below starts chunk c of
  ``PUBLISH_COLS`` columns once this one published through chunk c + 1
  (``csrc/stripe_rb.cuh``), T + 2 PUBLISH_COLS / C steps later. While
  the stripes in flight each hold an SM's scheduler to itself, a step
  costs one warp's latency, whatever the rows;
* ``rate_cps`` is the cells a second the card fills once the stripes
  outnumber what its SMs keep resident and instruction slots, not the
  chain, bind;
* ``floor_s`` is the call's fixed cost (the uploads, the scratch, the
  reduction and the fetch of ``score()``; the checks and scratch of
  ``stripe_block``).

The three constants are fitted per kind ('score': ``score()`` on K1-K3;
'block': K5, ``stripe_block``, what a pipeline stage launches) and per
form ('linear', 'affine', 'sub': a substitution table, either gap model)
by ``python -m swtpu_torch.dispatch.autotune --pipeline`` on the card, and
kept with the per-stage overhead of the world-1 pipeline in the record
``dispatch/pipe_h100.json``, stamped with the card. ``load_record`` reads
it from ``SWTPU_TORCH_PIPE_RECORD``, else the committed file, and only
when it was fitted on this process's card (``autotune.stamp_matches``):
without one no cost is known (``stripe_cost_s`` raises LookupError) and
the pipeline's profit gate stays off (``dispatch.plan``).
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Optional

from ..core.config import Scoring
from ..kernels.stripe_fill import _mode, rb_shape

PIPE_RECORD_ENV = "SWTPU_TORCH_PIPE_RECORD"
# the committed record of this package, fitted on an H100
DEFAULT_PIPE_RECORD = Path(__file__).resolve().parent / "pipe_h100.json"
# kPublish of csrc/stripe_rb.cuh: columns of the boundary row a stripe
# publishes at once; its reader waits for the chunk after the one it starts
PUBLISH_COLS = 32
KINDS = ("score", "block")
FORMS = ("linear", "affine", "sub")

_record_cache: dict = {}


def stripe_steps(m: int, n: int, T: int, R: int, C: int) -> int:
    """The chain of one register-blocked launch over m columns and n rows
    at T threads of R rows and C columns a step: ceil(m / C) + T - 1 steps
    of the last stripe, which starts T + 2 PUBLISH_COLS / C steps after
    the stripe above it."""
    stripes = -(-max(n, 1) // (T * R))
    lag = T + -(-2 * PUBLISH_COLS // C)
    return -(-max(m, 1) // C) + T - 1 + (stripes - 1) * lag


def geometry(m: int, n: int, scoring: Scoring = Scoring(),
             substitution=None, kind: str = "score") -> dict:
    """The launch a call of ``kind`` runs over m x n at the kernels'
    default shape, the one the record was fitted at: its form, (T, R, C)
    as ``rb_shape`` resolves them, its stripes, steps and cells."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    form = _mode(scoring, substitution)
    A = 0 if substitution is None else len(substitution)
    T, R, C = rb_shape(n, None, None, None, form, A, kind)
    return {"form": form, "T": T, "R": R, "C": C,
            "stripes": -(-max(n, 1) // (T * R)),
            "steps": stripe_steps(m, n, T, R, C), "cells": m * n}


def model_s(constants: dict, steps: int, cells: int) -> float:
    """floor_s + max(steps x step_s, cells / rate_cps)."""
    return constants["floor_s"] + max(steps * constants["step_s"],
                                      cells / constants["rate_cps"])


def rate_bound(constants: dict, steps: int, cells: int) -> bool:
    """Does the rate term bind at this launch?"""
    return cells / constants["rate_cps"] > steps * constants["step_s"]


def valid_record(rec) -> bool:
    """Has ``rec`` a positive, finite step_s and rate_cps and a
    non-negative floor_s for every kind and form, and a non-negative
    overhead_s for every form?"""
    def num(x, low):
        return (isinstance(x, (int, float)) and math.isfinite(x)
                and x >= low)
    try:
        return all(
            num(rec["model"][k][f]["floor_s"], 0)
            and num(rec["model"][k][f]["step_s"], 0)
            and rec["model"][k][f]["step_s"] > 0
            and num(rec["model"][k][f]["rate_cps"], 0)
            and rec["model"][k][f]["rate_cps"] > 0
            for k in KINDS for f in FORMS) and all(
            num(rec["overhead_s"][f], 0) for f in FORMS)
    except (KeyError, TypeError):
        return False


def load_record(path=None, stamp: Optional[dict] = None) -> Optional[dict]:
    """The pipeline cost record at ``path`` (default: the one
    ``SWTPU_TORCH_PIPE_RECORD`` names, else the committed
    ``DEFAULT_PIPE_RECORD``), or None when there is none, it is malformed,
    or it was fitted on another card than ``stamp``'s (default: this
    process's). Read once a process a path."""
    from .autotune import stamp_matches
    path = Path(path or os.environ.get(PIPE_RECORD_ENV) or
                DEFAULT_PIPE_RECORD)
    if path not in _record_cache:
        try:
            rec = json.loads(path.read_text())
        except (OSError, ValueError):
            rec = None
        _record_cache[path] = rec if valid_record(rec) else None
    rec = _record_cache[path]
    return rec if rec is not None and stamp_matches(rec, stamp) else None


def stripe_cost_s(m: int, n: int, scoring: Scoring = Scoring(),
                  substitution=None, kind: str = "score",
                  record: Optional[dict] = None) -> float:
    """Modelled seconds of a call of ``kind`` over m columns and n rows,
    at the kernels' default shape, on the card of ``record`` (default:
    ``load_record()``): 'score', a score-only ``score()`` on K1-K3;
    'block', K5 (``stripe_block``) over an m x n block. Raises LookupError
    with no record for this card."""
    rec = load_record() if record is None else record
    if rec is None:
        raise LookupError("no pipeline cost record fitted on this card "
                          "(python -m swtpu_torch.dispatch.autotune "
                          "--pipeline)")
    g = geometry(m, n, scoring, substitution, kind)
    return model_s(rec["model"][kind][g["form"]], g["steps"], g["cells"])


def choose_params_cost(m: int, n: int, scoring: Scoring = Scoring(),
                       substitution=None, kind: str = "score",
                       record: Optional[dict] = None) -> tuple:
    """(T, R, C, modelled seconds) of a call of ``kind`` at the kernels'
    default shape: the counterpart of the JAX package's
    ``choose_params_cost``, whose cost is in model cycles of the TPU.
    Raises LookupError with no record for this card."""
    g = geometry(m, n, scoring, substitution, kind)
    return (g["T"], g["R"], g["C"],
            stripe_cost_s(m, n, scoring, substitution, kind,
                          record=record))


def fit(points: list) -> dict:
    """The constants of one kind and form from measured launches,
    ``points`` a list of {'steps', 'cells', 's'}. For each k from 0 up to
    all but two, the launches but the k of most cells fit floor_s and
    step_s by least squares on the relative error (floor_s held at 0
    where it would fall below); then rate_cps is the rate, among the
    rates the launches reached (cells / (s - floor_s)) and a geometric
    grid between half the lowest and twice the highest, at which the
    model misses its worst launch by the least. The k with the least such
    miss wins. ``rate_measured`` says whether the rate term binds at any
    launch; where it binds at none, rate_cps is the highest rate a launch
    reached, a lower bound. Returns {'floor_s', 'step_s', 'rate_cps',
    'rate_measured', 'worst'}, 'worst' the largest ratio of model to
    measurement or back."""
    pts = sorted(points, key=lambda p: p["cells"])
    if len(pts) < 2:
        raise ValueError("fit needs at least two launches")

    def worst(c):
        return max(max(model_s(c, p["steps"], p["cells"]) / p["s"],
                       p["s"] / model_s(c, p["steps"], p["cells"]))
                   for p in pts)

    best = None
    for k in range(0, len(pts) - 1):
        floor, step = _lsq(pts[:len(pts) - k])
        reached = [p["cells"] / (p["s"] - floor) for p in pts
                   if p["s"] > floor]
        if not reached:
            continue
        lo, hi = min(reached) / 2, max(reached) * 2
        grid = [lo * (hi / lo) ** (i / 400) for i in range(401)]
        for rate in reached + grid:
            c = {"floor_s": floor, "step_s": step, "rate_cps": rate}
            w = worst(c)
            if best is None or w < best["worst"] - 1e-12:
                best = dict(c, worst=w)
    c = {k: best[k] for k in ("floor_s", "step_s", "rate_cps")}
    if not any(rate_bound(c, p["steps"], p["cells"]) for p in pts):
        # the rate bound no launch: keep the highest a launch reached
        c["rate_cps"] = max(p["cells"] / (p["s"] - c["floor_s"])
                            for p in pts if p["s"] > c["floor_s"])
        best = dict(best, rate_cps=c["rate_cps"], worst=worst(c))
    best["rate_measured"] = any(rate_bound(c, p["steps"], p["cells"])
                                for p in pts)
    return best


def _lsq(pts: list) -> tuple:
    """(floor, step) minimizing the sum of ((floor + steps step) / s -
    1)^2; floor held at 0 where the free fit puts it below."""
    a11 = sum(1 / p["s"] ** 2 for p in pts)
    a12 = sum(p["steps"] / p["s"] ** 2 for p in pts)
    a22 = sum(p["steps"] ** 2 / p["s"] ** 2 for p in pts)
    b1 = sum(1 / p["s"] for p in pts)
    b2 = sum(p["steps"] / p["s"] for p in pts)
    det = a11 * a22 - a12 * a12
    if det > 0:
        floor = (b1 * a22 - b2 * a12) / det
        step = (a11 * b2 - a12 * b1) / det
        if floor >= 0 and step > 0:
            return floor, step
    return 0.0, b2 / a22
