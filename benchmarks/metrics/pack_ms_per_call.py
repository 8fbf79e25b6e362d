"""pack_ms_per_call: the card's idle ms a call while ``score_many`` sorts
the pairs into buckets and packs each bucket (the program's spans
``swtpu.batch.bucket`` and ``swtpu.batch.pack``, ``harness/spans.py``)."""

from benchmarks.harness.spans import ms_per_call


def value(run):
    return ms_per_call(run, ("swtpu.batch.bucket", "swtpu.batch.pack"))
