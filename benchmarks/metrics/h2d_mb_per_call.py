"""h2d_mb_per_call: the bytes the program copies from the host to the card
in the window (its counter ``h2d_bytes``: codes and tables), over the
calls, in MB (1e6 bytes)."""

from benchmarks.harness.spans import counted


def value(run):
    n = counted(run, "h2d_bytes")
    return n / len(run.trace.spans) / 1e6 if n else None
