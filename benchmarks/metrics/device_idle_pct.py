"""device_idle_pct: the share of the traced window (first call span's
start to the last one's end) in which no operation ran on the card (no
kernel, copy or set), from the profiler's device intervals merged, in %."""

from benchmarks.harness.trace import busy


def value(run):
    if run.trace is None or not run.trace.device:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - busy(run.trace, lo, hi) / (hi - lo))
