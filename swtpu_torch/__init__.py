"""swtpu_torch — the PyTorch/CUDA port of swtpu for one NVIDIA H100.

Exact int32 Smith-Waterman scoring and alignment, linear or affine gaps,
match/mismatch or a substitution table such as BLOSUM62, with the same
public calls and the same answers as the JAX package ``swtpu``. One pair:
``align``/``score``, the max score, first row-major end cell,
``last_cell``, predecessor codes and alignment strings, full-P or lean
(locate + windowed refill, Hirschberg) traceback, banded or not. Many
pairs: ``batch_score`` (one shape), ``score_many`` (any shapes, bucketed),
``batch_align`` and ``align_many`` (strings for the best pairs). Reads
against a reference: ``search`` (best or best two hits per read, one or
both strands), ``align_hits`` (alignment records for the hits),
``pair_hits`` (mate placement), ``to_sam`` and ``map_reads`` (the whole
mapping pipeline, also ``python -m swtpu_torch map``). ``sanitize`` runs
the stripe kernel with every cell captured and checks it against the numpy
oracle (also ``python -m swtpu_torch --sanitize``). On a CUDA device the
fills and the walk of P run hand-written CUDA kernels (``csrc/``); on the
CPU their plain PyTorch versions run.

This package imports torch and numpy and never JAX or ``swtpu``.
"""

from .core.config import (
    BUILTIN_A,
    BUILTIN_B,
    BUILTIN_LAST_CELL,
    BUILTIN_MAX_POS,
    BUILTIN_MAX_SCORE,
    DIAGONAL,
    LEFT,
    NONE,
    PATH,
    UP,
    EngineConfig,
    Scoring,
)
from .core.encode import decode, encode, random_batch, random_pair, revcomp
from .dist.batch import align_many, batch_align, batch_score, score_many
from .dist.database import align_hits, pair_hits, search, to_sam
from .dist.mapping import map_reads
from .engine.align import Alignment, align, score
from .engine.traceback import AnchoredReverseMismatch
from .instrument.sanitize import sanitize_stripe as sanitize

__version__ = "0.1.0"


__all__ = [
    "align", "score",
    "batch_score", "score_many", "batch_align", "align_many",
    "search", "align_hits", "pair_hits", "to_sam", "map_reads", "sanitize",
    "Alignment", "Scoring", "EngineConfig", "AnchoredReverseMismatch",
    "encode", "decode", "random_pair", "random_batch", "revcomp",
    "NONE", "UP", "LEFT", "DIAGONAL", "PATH",
    "BUILTIN_A", "BUILTIN_B", "BUILTIN_MAX_SCORE", "BUILTIN_MAX_POS",
    "BUILTIN_LAST_CELL",
]
