"""Scoring model and framework configuration.

The same runtime surface as ``swtpu.core.config``: predecessor codes, the
built-in golden example, ``Scoring`` and ``EngineConfig``. Every default is
equal to the JAX package's, so a configuration carried across with
``swtpu_torch.convert`` computes with the same parameters.

Left out, because they describe the TPU and its host link rather than the
problem: ``EngineConfig.tpu_full_p_fetch_max_cells`` and the host-SIMD
crossover derivation from a measured device floor. ``host_max_cells``,
``host_simd_max_cells`` and ``scan_max_cells`` are carried so the state
round-trips, but no port tier reads them yet (ROADMAP Queue 1, "host
tiers via ctypes").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Predecessor codes (reference constant block NONE/UP/LEFT/DIAGONAL = 0..3).
# The traceback marks path cells by negation (PATH = -1 multiplier).
NONE = 0
UP = 1
LEFT = 2
DIAGONAL = 3
PATH = -1
# Affine traceback state bits OR'd into P: E/F at this cell chose gap
# EXTENSION (ties prefer extension).
E_EXT = 4
F_EXT = 8


@dataclasses.dataclass(frozen=True)
class Scoring:
    """Substitution + gap model.

    ``mode='linear'`` is the reference's one gap penalty; ``mode='affine'``
    is the Gotoh H/E/F model (gap_open charged on opening, gap_extend per
    extension). The port's fills run both, with the match/mismatch compare
    or with a substitution table (``align(..., substitution=...)``).
    """

    match: int = 3
    mismatch: int = -3
    gap: int = -2                 # linear gap penalty (mode='linear')
    gap_open: int = -4            # affine: cost of the first gap position
    gap_extend: int = -1          # affine: cost of each further gap position
    mode: str = "linear"          # 'linear' | 'affine'

    def __post_init__(self):
        if self.mode not in ("linear", "affine"):
            raise ValueError(f"unknown gap mode {self.mode!r}")

    @property
    def is_affine(self) -> bool:
        return self.mode == "affine"


# The reference's built-in golden example: a="TGTTACGG", b="GGTTGACTA".
# Invariants: global max score 13 at padded row-major index 69 (i=7, j=6
# with m=9 padded columns), bottom-right cell H[last]==7.
BUILTIN_A = "TGTTACGG"
BUILTIN_B = "GGTTGACTA"
BUILTIN_MAX_SCORE = 13
BUILTIN_MAX_POS = 69          # row-major index in the padded (n+1)x(m+1) matrix
BUILTIN_LAST_CELL = 7


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution-plan configuration. Thresholds are in cells (m*n)."""

    # host tiers of the JAX package (native serial fill, striped SIMD
    # score); carried for state parity, not read by the port yet
    host_max_cells: int = 1 << 13
    host_simd_max_cells: Optional[int] = None
    scan_max_cells: int = 1 << 14
    # threads T per thread block of the CUDA kernels, a multiple of 32:
    # up to 1024 on the stripe template's (one row a thread, T rows a
    # stripe), which banded calls run; up to 512 on the register-blocked
    # K1-K5 that unbanded calls run (the form's R rows a thread,
    # stripe_fill.RB_DEFAULTS, RB_P_DEFAULTS, RB_BLOCK_DEFAULTS, T times
    # that a stripe; K4 and K5 above 256 threads run their R = 4 tile,
    # stripe_fill.RB_WIDE_TILE; a larger T raises there, and a table's
    # profile may cap it). None = the kernel wrapper's default.
    stripe_rows: Optional[int] = None
    # register blocking R of the TPU kernel; not read by the port: the
    # template's CUDA kernels run R=1, the register-blocked K1-K5 their
    # form's fixed R (stripe_fill.RB_DEFAULTS, RB_P_DEFAULTS,
    # RB_BLOCK_DEFAULTS)
    stripe_rows_per_lane: Optional[int] = None
    # banded mode: half-width of the band (|i-j| <= band). None = full.
    band: Optional[int] = None
    # keep the predecessor matrix for traceback. False = score-only.
    traceback: bool = True
    # 'full' = device-captured P matrix, exact reference tie-breaking;
    # 'windowed' / 'hirschberg' = the lean routes of the JAX package;
    # 'auto' = full up to full_p_max_cells, windowed above
    traceback_method: str = "auto"
    full_p_max_cells: int = 1 << 28
    # score dtype; int32 is the parity dtype (reference uses C int)
    dtype: str = "int32"
