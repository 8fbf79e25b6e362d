"""fill_host_ms_per_call: the card's idle ms a call inside the fill's own
host steps: the uploads, the launch with its scratch and reductions, and
the fetch (the program's spans ``swtpu.fill.*``, ``harness/spans.py``)."""

from benchmarks.harness.spans import ms_per_call


def value(run):
    return ms_per_call(run, ("swtpu.fill.",))
