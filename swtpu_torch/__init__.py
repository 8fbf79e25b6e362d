"""swtpu_torch — the PyTorch/CUDA port of swtpu for one NVIDIA H100.

Exact int32 Smith-Waterman scoring and alignment of one pair, linear or
affine gaps, match/mismatch or a substitution table such as BLOSUM62, with
the same public calls and the same answers as the JAX package ``swtpu``:
max score, first row-major end cell, ``last_cell``, predecessor codes and
alignment strings. On a CUDA device the fill runs hand-written CUDA kernels
(``csrc/stripe_fill.cu``); on the CPU it runs the PyTorch ``scan`` plan.

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
from .engine.align import Alignment, align, score

__version__ = "0.1.0"

__all__ = [
    "align", "score",
    "Alignment", "Scoring", "EngineConfig",
    "encode", "decode", "random_pair", "random_batch", "revcomp",
    "NONE", "UP", "LEFT", "DIAGONAL", "PATH",
    "BUILTIN_A", "BUILTIN_B", "BUILTIN_MAX_SCORE", "BUILTIN_MAX_POS",
    "BUILTIN_LAST_CELL",
]
