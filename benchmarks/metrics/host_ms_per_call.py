"""host_ms_per_call: the mean over the traced calls of each call's span
less the time inside it in which an operation ran on the card, in ms:
the host's own share of a call's wall time."""

from benchmarks.harness.trace import busy_each


def value(run):
    if run.trace is None or not run.trace.spans:
        return None
    spans = run.trace.spans
    own = [(b - a) - d for (a, b), d in zip(spans, busy_each(run.trace, spans))]
    return sum(own) / len(own) / 1e3
