"""pipe_active_pct: the share of the pipeline's stages in which rank 0
filled a block, over the traced window: 100 pipe.blocks / pipe.stages,
from the program's counters (``dist/pipeline.py``: a pass of nblocks block
rows over D ranks has nblocks + D - 1 stages, of which each rank fills
nblocks), in %. Nothing to read where the program keeps no such
counters."""

from benchmarks.harness.spans import counted


def value(run):
    stages = counted(run, "pipe.stages")
    blocks = counted(run, "pipe.blocks")
    if not stages or blocks is None:
        return None
    return 100.0 * blocks / stages
