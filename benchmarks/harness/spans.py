"""The program's own spans and counters in a traced window.

``swtpu_torch.instrument.profiling`` keeps a record of each span (``name``,
``parent``, ``t0_ns``, ``t1_ns`` on ``time.perf_counter_ns``) and counter
step (``value``) while a profiler runs. The benchmark stamps each call
with the same host clock (``Call.t0``, ``Call.t1``) and the trace holds
each call's ``bench.call`` span on the profiler's clock, so the two
clocks are pinned call by call: call k's offset is ``((S_k + E_k) - (t0_k
+ t1_k) * 1e6) / 2`` µs, taking both ends so that the delay of entering
and leaving the span mostly cancels, and every record is mapped by the
median offset. Where the calls and the spans do not pair (their counts
differ) or the offsets spread by more than ``MAX_IQR_US`` between their
quartiles, nothing is mapped and every reader finds nothing to read.
Records outside the traced window (left from an earlier run in the same
process) are dropped.

``idle_by_part`` charges each microsecond in which no operation ran on the
card inside a ``bench.call`` span (the card's intervals merged as
``device_idle_pct`` merges them) to the innermost program span open then;
time under a root span (the public call's outermost, ``parent`` -1) or
under none goes to ``None``. The parts sum to the idle time inside the
calls, which is ``host_ms_per_call`` times the calls.
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional

from .trace import merged

MAX_IQR_US = 250.0


def _records() -> Optional[list]:
    """The program's records, or None where it keeps none."""
    try:
        from swtpu_torch.instrument import profiling
        got = profiling.recorded()
    except (ImportError, AttributeError):
        return None
    return got or None


def offset_us(run) -> Optional[tuple]:
    """(median offset, residuals) from the host clock in µs to the trace's,
    or None where the calls and the trace's call spans do not pair or
    spread by more than ``MAX_IQR_US``."""
    spans = run.trace.spans
    if not spans or len(spans) != len(run.calls):
        return None
    offs = [((s + e) - (c.t0 + c.t1) * 1e6) / 2
            for (s, e), c in zip(spans, run.calls)]
    mid = statistics.median(offs)
    res = [o - mid for o in offs]
    if len(res) >= 2:
        q1, _, q3 = statistics.quantiles(res, n=4, method="inclusive")
        if q3 - q1 > MAX_IQR_US:
            return None
    return mid, res


def mapped(run) -> Optional[tuple]:
    """(spans, counters) of the window on the trace's clock: spans as
    sorted (start, end, name, root), counters as (time, name, value); None
    where there is nothing to map."""
    if run.trace is None:
        return None
    recs = _records()
    if recs is None:
        return None
    got = offset_us(run)
    if got is None:
        return None
    off = got[0]
    lo, hi = run.trace.window
    spans, counters = [], []
    for r in recs:
        a, b = r.t0_ns / 1e3 + off, r.t1_ns / 1e3 + off
        if b < lo or a > hi:
            continue
        if r.value is None:
            spans.append((a, b, r.name, r.parent < 0))
        else:
            counters.append((a, r.name, r.value))
    spans.sort(key=lambda s: (s[0], -s[1]))
    return spans, counters


def _segments(spans: list) -> list:
    """Sorted, disjoint (start, end, name) of the innermost span open at
    each moment that some span covers; a root's name is None."""
    out, stack, t = [], [], None

    def emit(a, b):
        if stack and b > a:
            top = stack[-1]
            out.append((a, b, None if top[3] else top[2]))

    for s in spans:
        while stack and stack[-1][1] <= s[0]:
            emit(t, stack[-1][1])
            t = stack.pop()[1]
        if stack:
            emit(t, s[0])
        t = s[0]
        stack.append(s)
    while stack:
        emit(t, stack[-1][1])
        t = stack.pop()[1]
    return out


def idle_by_part(run) -> Optional[dict]:
    """{span name or None: µs of card idle inside the calls charged to it},
    every non-root span of the window among the names, or None where there
    is nothing to map."""
    got = mapped(run)
    if got is None:
        return None
    trace = run.trace
    lo, hi = trace.window
    busy = merged(trace.device, lo, hi)
    idle = []                   # the card's idle intervals inside the calls
    k = 0
    for a, b in trace.spans:
        t = a
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        j = k
        while j < len(busy) and busy[j][0] < b:
            if busy[j][0] > t:
                idle.append((t, busy[j][0]))
            t = max(t, busy[j][1])
            j += 1
        if b > t:
            idle.append((t, b))
    # every span of the window is a part, charged or not
    parts: collections.Counter = collections.Counter(
        {s[2]: 0.0 for s in got[0] if not s[3]})
    segs = _segments(got[0])
    k = 0
    for a, b in idle:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        t, j = a, k
        while j < len(segs) and segs[j][0] < b:
            s0, s1, name = segs[j]
            if s0 > t:
                parts[None] += min(s0, b) - t
            lo_, hi_ = max(s0, t), min(s1, b)
            if hi_ > lo_:
                parts[name] += hi_ - lo_
            t = max(t, min(s1, b))
            j += 1
        if b > t:
            parts[None] += b - t
    return dict(parts)


def ms_per_call(run, names) -> Optional[float]:
    """Card-idle ms per call charged to the spans ``names`` (a name ending
    in '.' takes every name it begins); None where none of them ran in the
    window."""
    parts = idle_by_part(run)
    if parts is None:
        return None
    hit = [v for n, v in parts.items() if n is not None and any(
        n.startswith(x) if x.endswith(".") else n == x for x in names)]
    return sum(hit) / len(run.trace.spans) / 1e3 if hit else None


def unnamed_pct(run) -> Optional[float]:
    """The share of the card's idle time inside the calls charged to a root
    span or to none, in %."""
    parts = idle_by_part(run)
    total = sum(parts.values()) if parts else 0.0
    return 100.0 * parts.get(None, 0.0) / total if total > 0 else None


def counted(run, name: str) -> Optional[int]:
    """The counter ``name`` summed over the window, None where it never
    stepped there."""
    got = mapped(run)
    if got is None:
        return None
    vals = [v for _, n, v in got[1] if n == name]
    return sum(vals) if vals else None
