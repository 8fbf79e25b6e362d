"""strings_ms_per_call: the card's idle ms a call while the host builds
the alignment strings, on any route (the program's span
``swtpu.tb.strings``, ``harness/spans.py``)."""

from benchmarks.harness.spans import ms_per_call


def value(run):
    return ms_per_call(run, ("swtpu.tb.strings",))
