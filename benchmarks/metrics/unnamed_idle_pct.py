"""unnamed_idle_pct: the share of the card's idle time inside the calls
that no part of the program's spans covers: charged to a public call's
root span or to no span (``harness/spans.py``), in %."""

from benchmarks.harness.spans import unnamed_pct


def value(run):
    return unnamed_pct(run)
