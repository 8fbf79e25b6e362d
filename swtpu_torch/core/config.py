"""Scoring model and framework configuration.

The same runtime surface as ``swtpu.core.config``: predecessor codes, the
built-in golden example, ``Scoring`` and ``EngineConfig``. Every default but
``host_max_cells`` is equal to the JAX package's, so a configuration
carried across with ``swtpu_torch.convert`` computes with the same
parameters; ``host_max_cells``' default is the crossover measured on a card
machine (``HOST_MAX_CELLS``).

The host tiers read ``host_max_cells`` (``dispatch.plan.choose_exec``'s
``host`` tier on a CUDA device) and ``host_simd_max_cells``
(``EngineConfig.simd_cells_cap``, the score-only ``host-simd`` tier of
``engine.align``). Both defaults are crossovers measured on a card machine
by ``dispatch.autotune.host_crossover`` and committed with their readings
(``HOST_MAX_CELLS``, ``HOST_SIMD_MAX_CELLS``); no route times anything to
decide. ``scan_max_cells`` is carried so the state round-trips; no tier
reads it.

Left out, because it describes the TPU and its host link rather than the
problem: ``EngineConfig.tpu_full_p_fetch_max_cells``, and the JAX
package's TPU floor (``DEVICE_FLOOR_FALLBACK_S`` and its fit record).
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


# the largest pair, in cells, that align() sends to the native serial fill
# on a CUDA device: the largest square of dispatch.autotune.host_crossover's
# sweep (32^2 to 1024^2, the fastest of 5 after a warm-up) where the fill,
# the host walk of P and the strings beat the card's full-P align() (K4,
# the copy of P, the same walk) in all three scorings: 192^2 (linear 0.815
# against 1.315 ms, DNA affine 0.731 / 0.774, BLOSUM62 affine 0.476 /
# 0.779; at 256^2 linear 0.793 / 0.838, affine 1.093 / 0.950, BLOSUM62
# 0.735 / 0.658), on an NVIDIA H100 80GB HBM3 at 700 W whose host has 8
# cores of a GenuineIntel family 6 model 207 (its model name unreported),
# with AVX-512 (PERF.md section 6)
HOST_MAX_CELLS = 192 * 192

# the largest score-only pair, in cells, that score() on a CUDA device
# sends to the striped SIMD fill on one host core: the largest square of
# dispatch.autotune.host_crossover's sweep (64^2 to 4096^2, the fastest of
# 5 after a warm-up) where the SIMD fill beat the card's score-only
# score() (the codes to the card, K1-K3, one fetch) by more than 20 % in
# all three scorings: 2560^2 (linear 0.985 against 1.307 ms, DNA affine
# 1.077 / 1.327, BLOSUM62 affine 0.975 / 1.328). At 2880^2 it still won,
# by 1.4 % in DNA affine (1.436 / 1.456), within the run-to-run spread,
# and at 3072^2 it lost there (1.788 / 1.517); on the same NVIDIA H100
# 80GB HBM3 at 700 W and 8-core host as HOST_MAX_CELLS (PERF.md section 6)
HOST_SIMD_MAX_CELLS = 2560 * 2560


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution-plan configuration. Thresholds are in cells (m*n)."""

    # the native serial fill on the host (runtime_native.fill, the host
    # walk of P and the oracle's strings): align() on a CUDA device sends
    # an unbanded pair of at most this many cells there
    # (dispatch.plan.choose_exec); 0 turns the tier off
    host_max_cells: int = HOST_MAX_CELLS
    # score-only calls on a CUDA device of at most this many cells run the
    # striped SIMD fill on the host (runtime_native.score_simd_pos), where
    # it is eligible; 0 turns the tier off. None (the JAX package's
    # default, carried over by swtpu_torch.convert) is HOST_SIMD_MAX_CELLS
    host_simd_max_cells: Optional[int] = HOST_SIMD_MAX_CELLS
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

    def simd_cells_cap(self) -> int:
        """The host-SIMD crossover in cells: ``host_simd_max_cells``, or
        the measured HOST_SIMD_MAX_CELLS where it is None."""
        if self.host_simd_max_cells is None:
            return HOST_SIMD_MAX_CELLS
        return self.host_simd_max_cells
