"""padded_cell_pct: the share of the cells ``score_many``'s buckets fill
that are padding, over the window: 100 (cells_bucket - cells_real) /
cells_bucket, from the program's counters ``batch.cells_bucket`` (pairs
times the bucket's padded shape) and ``batch.cells_real`` (m n of each
pair), in %."""

from benchmarks.harness.spans import counted


def value(run):
    real = counted(run, "batch.cells_real")
    bucket = counted(run, "batch.cells_bucket")
    if not real or not bucket:
        return None
    return 100.0 * (bucket - real) / bucket
