"""The CUDA kernels of the single-pair path, and their plain versions.

Counterpart of ``swtpu.kernels.pallas_fill``'s single-pair entry points and
of the device walk of ``swtpu.engine.traceback``:

* ``stripe_score`` (the ``stripe_score_fn`` counterpart): max score, its
  first row-major end cell and ``last_cell`` reduced on the device into one
  (4,) tensor, so the caller makes one small fetch; plus the right column
  H[:, m].
* ``stripe_fill`` (the ``stripe_fill`` counterpart with ``return_p=True``):
  the same, plus the predecessor codes as a row-major (n+1, m+1) int8 P on
  the device (on a card, a view of rows padded to ``P_PITCH_ALIGN``
  bytes).
* ``band=`` on both (``stripe_fill_raw(band=)``): cells with |i-j| > band
  are H = 0, P = NONE; a stripe visits only the columns its rows' band
  reaches.
* ``stripe_block`` (the ``stripe_block_fn`` counterpart): a fill with
  injected row 0 and column 0, local or global (NW), exporting the right
  column, E of column m and, on request, H and F of row n.
* ``walk_p`` (the device walk of ``_stripe_window_walk``): the Gotoh walk
  of a row-major P from a corner, the moves end-first.

The scoring picks the kernel: linear match/mismatch, affine
match/mismatch and a substitution table with linear or affine gaps. Every
call runs the register-blocked stripe of ``csrc/stripe_rb.cuh`` in the
scoring's form: ``stripe_score`` its score-only entries
(``csrc/stripe_rb.cu``: K1 ``sw_stripe_rb_linear``, K2
``sw_stripe_rb_affine``, K3 ``sw_stripe_rb_sub``, either gap model),
``stripe_fill`` its P-capture entries (``csrc/stripe_rb_p.cu``: K4
``sw_stripe_rb_fill_p_{linear,affine,sub}``) and ``stripe_block`` its
block entries (``csrc/stripe_rb_block.cu``: K5
``sw_stripe_rb_block_{linear,affine,sub}``); with a band, its band form
(``csrc/stripe_rb_band.cu``, K4b: ``sw_stripe_rb_band_*`` and
``sw_stripe_rb_fill_p_band_*``). The walk is ``sw_walk_p_tiled``.
``_launch``, ``_launch_block`` and ``_launch_walk`` also reach the earlier
designs, on no route of the package: the stripe template's K1-K4 and their
band mode (``sw_stripe_score_*``, ``sw_stripe_fill_p_*``,
``csrc/stripe_fill.cu``), its K5 (``sw_stripe_block_*``,
``csrc/stripe_block.cu``) and the one-thread walk ``sw_walk_p``.

Each runs its hand-written kernel of ``csrc/`` for a tensor on a CUDA
device and its plain version (``stripe_score_plain``,
``stripe_fill_plain``, ``stripe_block_plain``, built on ``scan_fill``, and
``walk_p_plain``, a host loop) for a tensor on the CPU, and nowhere else. A
CUDA tensor launches the kernel or raises: a failed build or launch is
never answered by the plain version.

``launches`` counts the kernel launches, a banded one under its entry's
name plus ``BAND_SUFFIX``, and ``plain_calls`` the plain versions' calls,
so a run can show which one served it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import E_EXT, F_EXT, LEFT, NONE, UP, Scoring
from . import _cuda
from .scan_fill import (NEG, check_codes, diag_to_rowmajor, embed_table,
                        scan_fill)

# widest a the kernels take; the same gate as the JAX package
MAX_WIDTH = 1 << 20
# the band argument of an unbanded launch (kNoBand in csrc/)
NO_BAND = -(1 << 31)
# rows per stripe (threads per block) when the caller names none
DEFAULT_STRIPE_ROWS = 256
# shared memory a block may opt into on an H100 (227 KB), less room for
# the kernel's static arrays: bounds the substitution profile, A*T int32
SUB_PROFILE_BYTES = 227 * 1024 - 1024

SCORE_KERNEL = "sw_stripe_score_linear"
RB_KERNEL = "sw_stripe_rb_linear"
RB_AFFINE_KERNEL = "sw_stripe_rb_affine"
RB_SUB_KERNEL = "sw_stripe_rb_sub"
# mode -> the register-blocked entry of csrc/stripe_rb.cu
RB_KERNELS = {"linear": RB_KERNEL, "affine": RB_AFFINE_KERNEL,
              "sub": RB_SUB_KERNEL}
# the register-blocked K1's threads per block, rows per thread and columns
# per step when the caller names no T: the fastest of chip_smoke.py's
# sweep at 25632^2, min of 5 interleaved rounds, 8.451 ms against 8.533
# for (128, 8, 8) and 8.867 for (64, 8, 4) on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md section 6)
RB_THREADS = 128
RB_ROWS = 8
RB_COLS = 4
# the (R, C) tiles csrc/stripe_rb.cu instantiates: the default and its
# neighbours in R and in C, the points of the sweep
RB_TILES = ((8, 4), (4, 4), (16, 4), (8, 1), (8, 2), (8, 8))
# each form's tiles and its default (T, R, C): K2's and K3's the fastest
# of chip_smoke.py's sweeps at 25632^2, min of 5 interleaved rounds, K2
# 10.175 ms against 10.227 for (128, 4, 4), K3 10.137 against 10.315 for
# (64, 8, 4), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6)
RB_FORM_TILES = {"linear": RB_TILES, "affine": ((8, 4), (8, 2), (4, 4)),
                 "sub": ((8, 4), (8, 2), (4, 4))}
RB_DEFAULTS = {"linear": (RB_THREADS, RB_ROWS, RB_COLS),
               "affine": (128, 8, 4), "sub": (128, 8, 4)}
RB_MAX_THREADS = 512            # its __launch_bounds__
# shared memory a register-blocked block may opt into (227 KB) less its
# static arrays (the query ring, edges, chunks) and the affine F arrays:
# bounds K3's profile, (min(A, RB_MAX_SYMBOLS) + 1) * R * T int32 (no
# int8 code reaches a row past RB_MAX_SYMBOLS)
RB_PROFILE_BYTES = 227 * 1024 - 16 * 1024
RB_MAX_SYMBOLS = 128
# the register-blocked K4 and K5 (csrc/stripe_rb_p.cu, stripe_rb_block.cu):
# mode -> entry
RB_P_KERNELS = {mode: f"sw_stripe_rb_fill_p_{mode}"
                for mode in ("linear", "affine", "sub")}
RB_BLOCK_KERNELS = {mode: f"sw_stripe_rb_block_{mode}"
                    for mode in ("linear", "affine", "sub")}
# their (R, C) tiles, in every form, and their default (T, R, C), the
# fastest of chip_smoke.py's sweeps at the path's sizes (K4 at 16384^2, K5
# at the lean route's 25632^2 reverse pass), min of 5 interleaved rounds,
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): K4 (64, 4, 4),
# since P's scattered stores load each SM's store pipe and 256-row stripes
# spread them over more SMs than (128, 8, 4)'s 1024 rows; K5 (128, 8, 4)
RB_EXT_TILES = ((8, 4), (8, 2), (4, 4))
RB_P_DEFAULTS = dict.fromkeys(RB_P_KERNELS, (64, 4, 4))
RB_BLOCK_DEFAULTS = dict.fromkeys(RB_BLOCK_KERNELS, (128, 8, 4))
# the band form (K4b, csrc/stripe_rb_band.cu): score-only and P-capture
# entries by mode, in RB_EXT_TILES under the same launch bounds, and their
# default (T, R, C), the fastest of chip_smoke.py's sweeps at 16384^2 band
# 64 (9 points, min of 5 rounds) in each of three runs on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md section 6): score-only (128, 8, 4) for
# linear and the table, 0.1-2.7 % and 1.5-7.5 % faster than (128, 4, 4),
# which DNA affine takes (2 % faster than (128, 8, 4)); P capture (128, 4,
# 4) in every form. The sweeps ran at one band, so the band does not pick T
RB_BAND_KERNELS = {mode: f"sw_stripe_rb_band_{mode}"
                   for mode in ("linear", "affine", "sub")}
RB_BAND_P_KERNELS = {mode: f"sw_stripe_rb_fill_p_band_{mode}"
                     for mode in ("linear", "affine", "sub")}
RB_BAND_DEFAULTS = {"linear": (128, 8, 4), "affine": (128, 4, 4),
                    "sub": (128, 8, 4)}
RB_BAND_P_DEFAULTS = dict.fromkeys(RB_BAND_P_KERNELS, (128, 4, 4))
# their launch bounds: 256 threads at R = 8, whose registers (up to 203)
# pass the 128 a 512-thread block allows, and RB_MAX_THREADS for the one R =
# 4 tile (at most 117), which a T above 256 runs when the caller names no
# tile
RB_EXT_MAX_THREADS = 256
RB_WIDE_TILE = (4, 4)
# the capture form (K9, csrc/stripe_rb_debug.cu): what score() runs in
# every form, (8, 4) at RB_DEFAULTS' T, and the small tile RB_WIDE_TILE,
# which gives many hand-offs at small shapes, under the K4 and K5 forms'
# launch bounds (its R x C capture registers sit on top of the tile's)
RB_DEBUG_TILES = ((8, 4), RB_WIDE_TILE)
# the batch form (K8, csrc/stripe_rb_pairs.cu) takes the form's
# RB_FORM_TILES and RB_DEFAULTS: (128, 8, 4) was the fastest, or within
# 4.5 % of the fastest, of chip_smoke.py's sweeps at 64 x 1056^2 and 64 x
# 1000^2 in every form (24 points linear, 12 affine and table, min of 5
# rounds, an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6)
# the batch form with the band (K8[band], csrc/stripe_rb_pairs_band.cu,
# under K4b's launch bounds) and with one shared window (K6 for reads
# longer than 512 rows, csrc/stripe_rb_window.cu) take the batch form's
# RB_FORM_TILES and RB_DEFAULTS too: in chip_smoke.py's sweeps, at one
# shape each (K8[band] at 64 x 1056^2 band 64; K6 at one 32768-column
# window against 64 DNA reads of 5000 rows and 256 protein queries of
# 600 residues, where T clamps to 96), (128, 8, 4) came within 1 % of
# the fastest point for K8[band] and within 7 % for K6 (PERF.md section 6)
# the packed form (K7, csrc/stripe_rb_packed.cu, T up to RB_MAX_THREADS)
# takes RB_FORM_TILES and RB_DEFAULTS too, and its capture (the packed K9,
# csrc/stripe_rb_packed_debug.cu) K9's RB_DEBUG_TILES and launch bounds
# K4 stores a row's codes of a tile at once, into rows of a pitch rounded
# up to P_PITCH_ALIGN bytes and shifted so that column 1 is word-aligned
P_PITCH_ALIGN = 16
# the flags of csrc/stripe_rb.cuh's stripe_rb_kernel<R, C, kAffine, kSub,
# kP, kBlock, kBand, kDebugH, kPairs, kShared, kPacked>, after (R, C)
RB_FLAGS = ("kAffine", "kSub", "kP", "kBlock", "kBand", "kDebugH",
            "kPairs", "kShared", "kPacked")
# every register-blocked C entry of csrc/stripe_rb*.cu, its scoring as
# {mode}, -> the flags it sets beside kAffine and kSub, which follow the
# mode (a table's entry takes either gap model); the one place that maps
# an entry to its instantiation and back
RB_ENTRY_FLAGS = {
    "sw_stripe_rb_{mode}": (),
    "sw_stripe_rb_fill_p_{mode}": ("kP",),
    "sw_stripe_rb_block_{mode}": ("kBlock",),
    "sw_stripe_rb_band_{mode}": ("kBand",),
    "sw_stripe_rb_fill_p_band_{mode}": ("kP", "kBand"),
    "sw_sanitize_rb_{mode}": ("kDebugH",),
    "sw_sanitize_packed_rb_{mode}": ("kDebugH", "kPacked"),
    "sw_pairs_rb_{mode}": ("kPairs",),
    "sw_pairs_rb_band_{mode}": ("kPairs", "kBand"),
    "sw_window_rb_{mode}": ("kPairs", "kShared"),
    "sw_packed_rb_{mode}": ("kPacked",),
}
FILL_P_KERNEL = "sw_stripe_fill_p_linear"
SCORE_AFFINE_KERNEL = "sw_stripe_score_affine"
FILL_P_AFFINE_KERNEL = "sw_stripe_fill_p_affine"
SCORE_SUB_KERNEL = "sw_stripe_score_sub"
FILL_P_SUB_KERNEL = "sw_stripe_fill_p_sub"
BAND_SUFFIX = "[band]"
BLOCK_KERNELS = {"linear": "sw_stripe_block_linear",
                 "affine": "sw_stripe_block_affine",
                 "sub": "sw_stripe_block_sub"}
# the walk of P: the tile-staged walk, the route's, and the one-thread
# walk, the earlier design
WALK_KERNEL = "sw_walk_p_tiled"
WALK_SCALAR_KERNEL = "sw_walk_p"
# (capture P, mode) -> the C entry of csrc/stripe_fill.cu
_KERNELS = {
    (False, "linear"): SCORE_KERNEL, (True, "linear"): FILL_P_KERNEL,
    (False, "affine"): SCORE_AFFINE_KERNEL,
    (True, "affine"): FILL_P_AFFINE_KERNEL,
    (False, "sub"): SCORE_SUB_KERNEL, (True, "sub"): FILL_P_SUB_KERNEL,
}
launches = dict.fromkeys(
    [*_KERNELS.values(), *(k + BAND_SUFFIX for k in _KERNELS.values()),
     *BLOCK_KERNELS.values(), WALK_KERNEL, WALK_SCALAR_KERNEL,
     *RB_KERNELS.values(), *RB_P_KERNELS.values(),
     *RB_BLOCK_KERNELS.values(), *RB_BAND_KERNELS.values(),
     *RB_BAND_P_KERNELS.values()], 0)
plain_calls = {"stripe_score_plain": 0, "stripe_fill_plain": 0,
               "stripe_block_plain": 0, "walk_p_plain": 0}


def reset_counts() -> None:
    for counts in (launches, plain_calls):
        for name in counts:
            counts[name] = 0


def rb_flags(entry: str, affine: bool = False) -> tuple:
    """The nine template flags (RB_FLAGS, in order) of the instantiation
    the register-blocked C entry ``entry`` launches; ``affine``: a table
    entry's gap model (a DNA entry's is its mode's)."""
    form, mode = entry.rsplit("_", 1)
    on = {*RB_ENTRY_FLAGS[form + "_{mode}"]}
    if mode == "affine" or (mode == "sub" and affine):
        on.add("kAffine")
    if mode == "sub":
        on.add("kSub")
    return tuple(f in on for f in RB_FLAGS)


def rb_kind(entry: str) -> str:
    """``rb_shape``'s kind of the launch that the register-blocked C entry
    ``entry`` makes, read off its flags (RB_ENTRY_FLAGS)."""
    on = set(RB_ENTRY_FLAGS[entry.rsplit("_", 1)[0] + "_{mode}"])
    if "kDebugH" in on:
        return "packed_debug" if "kPacked" in on else "debug"
    if "kPacked" in on:
        return "packed"
    if "kPairs" in on:
        return ("window" if "kShared" in on
                else "pairs_band" if "kBand" in on else "pairs")
    if "kBlock" in on:
        return "block"
    return "_".join(["fill_p"] * ("kP" in on)
                    + ["band"] * ("kBand" in on)) or "score"


def rb_entry(flags: tuple) -> Optional[str]:
    """The register-blocked C entry that launches the instantiation of
    these nine flags (RB_FLAGS, in order), or None where none does."""
    affine, sub = flags[:2]
    on = {f for f, v in zip(RB_FLAGS[2:], flags[2:]) if v}
    mode = "sub" if sub else "affine" if affine else "linear"
    for form, extra in RB_ENTRY_FLAGS.items():
        if set(extra) == on:
            return form.format(mode=mode)
    return None


def _mode(scoring: Scoring, substitution) -> str:
    return ("sub" if substitution is not None
            else "affine" if scoring.is_affine else "linear")


def kernel_name(scoring: Scoring, substitution, capture_p: bool,
                banded: bool = False) -> str:
    """The launch counter of the stripe template's K1-K4 entry of this
    scoring, the earlier design: the entry's name, plus ``BAND_SUFFIX``
    when banded (its band mode, the earlier K4b)."""
    name = _KERNELS[capture_p, _mode(scoring, substitution)]
    return name + BAND_SUFFIX if banded else name


def score_kernel_name(scoring: Scoring, substitution,
                      banded: bool = False) -> str:
    """The launch counter of what ``stripe_score`` runs on a CUDA device:
    the register-blocked entry of the scoring, its band form when
    banded."""
    return (RB_BAND_KERNELS if banded else RB_KERNELS)[
        _mode(scoring, substitution)]


def fill_kernel_name(scoring: Scoring, substitution,
                     banded: bool = False) -> str:
    """The launch counter of what ``stripe_fill`` runs on a CUDA device:
    the register-blocked K4 entry of the scoring, its band form when
    banded."""
    return (RB_BAND_P_KERNELS if banded else RB_P_KERNELS)[
        _mode(scoring, substitution)]


def block_route_name(scoring: Scoring, substitution) -> str:
    """The launch counter of what ``stripe_block`` runs on a CUDA device:
    the register-blocked K5 entry of the scoring."""
    return RB_BLOCK_KERNELS[_mode(scoring, substitution)]


def rb_shape(n: int, T: Optional[int] = None, R: Optional[int] = None,
             C: Optional[int] = None, mode: str = "linear",
             A: int = 0, kind: str = "score") -> tuple:
    """(threads, rows per thread, columns per step) of a register-blocked
    launch of ``kind`` ('score' K1-K3, 'fill_p' K4, 'block' K5, the band
    form K4b, 'band' and 'fill_p_band', the capture form K9, 'debug', the
    batch form K8, 'pairs', over each pair's n rows, its band form
    K8[band], 'pairs_band', its shared-window form K6, 'window', over
    each read's n rows, or its packed form K7, 'packed', and that form's
    capture, the packed K9, 'packed_debug', over each pair's n rows) in
    ``mode`` ('linear', 'affine' or 'sub', an alphabet of A symbols) over
    n rows: T threads (default the form's, RB_DEFAULTS (K1-K3, K9, K8,
    K8[band], K6, K7 and the packed K9), RB_P_DEFAULTS,
    RB_BLOCK_DEFAULTS, RB_BAND_DEFAULTS or RB_BAND_P_DEFAULTS; a multiple
    of 32 up to RB_MAX_THREADS, each holding R rows; K1-K3, K8, K8[band],
    K6 and K7 in the form's RB_FORM_TILES, K9 and the packed K9 in
    RB_DEBUG_TILES, the others in RB_EXT_TILES; every form but K1-K3, K8,
    K6 and K7 above RB_EXT_MAX_THREADS only in RB_WIDE_TILE, its default
    there), no more than ceil(n / R) needs, rounded up to a warp (K7 and
    the packed K9: rounded by ``pairs_fill.packed_rb_geometry`` instead,
    to the warps of the whole pairs a stripe holds), and, for a table, no
    more than the profile's shared memory holds (RB_PROFILE_BYTES, with
    K9's capture staging beside it)."""
    if kind in ("score", "pairs", "pairs_band", "window", "packed"):
        defaults, tiles = RB_DEFAULTS, RB_FORM_TILES[mode]
    else:
        defaults = {"fill_p": RB_P_DEFAULTS, "block": RB_BLOCK_DEFAULTS,
                    "band": RB_BAND_DEFAULTS,
                    "fill_p_band": RB_BAND_P_DEFAULTS,
                    "debug": RB_DEFAULTS, "packed_debug": RB_DEFAULTS}[kind]
        tiles = (RB_DEBUG_TILES if kind in ("debug", "packed_debug")
                 else RB_EXT_TILES)
    dT, dR, dC = defaults[mode]
    T = dT if T is None else T
    if T < 32 or T > RB_MAX_THREADS or T % 32:
        raise ValueError(f"threads T={T} of the register-blocked {kind} "
                         "kernels must be a multiple of 32 in [32, "
                         f"{RB_MAX_THREADS}]")
    if kind not in ("score", "pairs", "window", "packed") \
            and T > RB_EXT_MAX_THREADS:
        (dR, dC), tiles = RB_WIDE_TILE, (RB_WIDE_TILE,)
    R, C = dR if R is None else R, dC if C is None else C
    if (R, C) not in tiles:
        raise ValueError(f"rows per thread R={R} and columns per step C={C}"
                         f" must be one of the {mode} {kind} tiles {tiles}"
                         f" at T={T}")
    if kind not in ("packed", "packed_debug"):
        T = min(T, -(-(-(-n // R)) // 32) * 32)
    if mode == "sub":
        # the profile, and K9's capture staging (R * C / 4 + 1 int4 a thread)
        rows = min(A, RB_MAX_SYMBOLS) + 1
        per = 4 * rows * R + (16 * (R * C // 4 + 1)
                              if kind in ("debug", "packed_debug") else 0)
        T = min(T, RB_PROFILE_BYTES // per // 32 * 32)
    return T, R, C


def block_kernel_name(scoring: Scoring, substitution) -> str:
    """The stripe template's K5 entry of this scoring, the earlier design
    (``block_route_name`` names what a CUDA device runs)."""
    return BLOCK_KERNELS[_mode(scoring, substitution)]


class StripeOut(NamedTuple):
    """Results as tensors on the input's device."""
    best: torch.Tensor          # (4,) int32: max_score, max_i, max_j, last_cell
    right_col: torch.Tensor     # (n+1,) int32: H[:, m]
    P: Optional[torch.Tensor]   # (n+1, m+1) int8 row-major, stripe_fill only


class BlockOut(NamedTuple):
    """``stripe_block`` results as tensors on the input's device."""
    best: torch.Tensor          # (4,) int32: positive max, i, j, H[n, m]
    bottom_row: Optional[torch.Tensor]  # (m+1,) H[n, :] when want_bottom
    right_col: torch.Tensor     # (n+1,) H[:, m]; [0] = top_row[m]
    bottom_f: Optional[torch.Tensor]    # (m+1,) F[n, :], affine, want_bottom
    right_e: Optional[torch.Tensor]     # (n+1,) E[:, m], affine


def stripe_fill_supported(m: int, n: int, traceback: bool,
                          scoring: Scoring = Scoring(),
                          substitution=None) -> bool:
    """The JAX package's gates, which pick the stripe plan: m >= 2, and
    what the wrappers take (``kernels_take``)."""
    return m >= 2 and kernels_take(m, n, scoring, substitution)


def kernels_take(m: int, n: int, scoring: Scoring = Scoring(),
                 substitution=None) -> bool:
    """What the wrappers take, on a card and on the CPU: 1 <= m <=
    MAX_WIDTH, n >= 1, and negative penalties (``_penalties_negative``),
    or, with a substitution table, only negative gaps (``_sub_gaps_ok``).
    The kernels mask their edges, so a width of 1 needs no gate."""
    if not (1 <= m <= MAX_WIDTH and n >= 1):
        return False
    if substitution is not None:
        return _sub_gaps_ok(scoring)
    return _penalties_negative(scoring)


def _penalties_negative(scoring: Scoring) -> bool:
    if scoring.mismatch >= 0:
        return False
    return _sub_gaps_ok(scoring)


def _sub_gaps_ok(scoring: Scoring) -> bool:
    if scoring.is_affine:
        return scoring.gap_open < 0 and scoring.gap_extend < 0
    return scoring.gap < 0


def stripe_score(a: torch.Tensor, b: torch.Tensor,
                 scoring: Scoring = Scoring(), T: Optional[int] = None,
                 substitution: Optional[torch.Tensor] = None,
                 band: Optional[int] = None, R: Optional[int] = None,
                 C: Optional[int] = None) -> StripeOut:
    """Score-only local fill of a (m,) against b (n,), int8 codes on one
    device. ``T``: threads per block (CUDA only; a thread holds its form's
    R rows, up to RB_MAX_THREADS threads, ``rb_shape``). ``substitution``:
    an (A, A) int32 table S[a_code, b_code] on the same device, or None
    for the match/mismatch compare. ``band``: keep only the cells with
    |i - j| <= band (None: every cell). ``R``, ``C`` (CUDA only): the
    thread's tile of rows and columns a step, one the form instantiates
    (``rb_shape``), None its default."""
    if _route(a, b, scoring, substitution) == "cpu":
        return stripe_score_plain(a, b, scoring, substitution, band)
    return _launch_rb(a, b, scoring, T, R, C, sub=substitution, band=band)


def stripe_fill(a: torch.Tensor, b: torch.Tensor,
                scoring: Scoring = Scoring(), T: Optional[int] = None,
                substitution: Optional[torch.Tensor] = None,
                band: Optional[int] = None, R: Optional[int] = None,
                C: Optional[int] = None) -> StripeOut:
    """``stripe_score`` plus the row-major predecessor matrix P. ``T``:
    threads per block (CUDA only; each holds R rows, up to RB_MAX_THREADS
    threads, ``rb_shape``); ``R``, ``C`` as ``stripe_score``'s."""
    if _route(a, b, scoring, substitution) == "cpu":
        return stripe_fill_plain(a, b, scoring, substitution, band)
    return _launch_rb_p(a, b, scoring, T, R, C, sub=substitution, band=band)


def stripe_score_plain(a: torch.Tensor, b: torch.Tensor,
                       scoring: Scoring = Scoring(),
                       substitution: Optional[torch.Tensor] = None,
                       band: Optional[int] = None) -> StripeOut:
    """Plain PyTorch version of the score kernels, on any device."""
    plain_calls["stripe_score_plain"] += 1
    out = scan_fill(a, b, scoring=scoring, sub_table=_table(substitution),
                    band=band)
    return StripeOut(_pack(out), out.right_col, None)


def stripe_fill_plain(a: torch.Tensor, b: torch.Tensor,
                      scoring: Scoring = Scoring(),
                      substitution: Optional[torch.Tensor] = None,
                      band: Optional[int] = None) -> StripeOut:
    """Plain PyTorch version of the fill_p kernels, on any device."""
    plain_calls["stripe_fill_plain"] += 1
    out = scan_fill(a, b, scoring=scoring, return_p=True,
                    sub_table=_table(substitution), band=band)
    P = diag_to_rowmajor(out.p_diag, b.numel(), a.numel())
    return StripeOut(_pack(out), out.right_col, P)


def stripe_block(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
                 top_row: torch.Tensor, left_col: torch.Tensor,
                 top_f: Optional[torch.Tensor] = None,
                 left_e: Optional[torch.Tensor] = None, local: bool = True,
                 substitution: Optional[torch.Tensor] = None,
                 want_bottom: bool = False,
                 T: Optional[int] = None) -> BlockOut:
    """Fill a (m,) against b (n,) with row 0 = ``top_row`` (m+1,) and
    column 0 = ``left_col`` (n+1,), int32, both holding the corner H[0, 0];
    affine also F of row 0 = ``top_f`` (m+1,) and E of column 0 =
    ``left_e`` (n+1,), NEG where None. ``local=False`` runs the global
    (Needleman-Wunsch) recurrence; the max then counts positive cells
    only. ``want_bottom``: also export H and F of row n. ``T``: threads
    per block (CUDA only; each holds R rows, up to RB_MAX_THREADS,
    ``rb_shape``)."""
    dev = _route(a, b, scoring, substitution)
    bounds = _check_block(a, b, scoring, top_row, left_col, top_f, left_e)
    if dev == "cpu":
        return stripe_block_plain(a, b, scoring, *bounds, local=local,
                                  substitution=substitution,
                                  want_bottom=want_bottom)
    return _launch_rb_block(a, b, scoring, T, substitution, *bounds, local,
                            want_bottom)


def stripe_block_plain(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
                       top_row: torch.Tensor, left_col: torch.Tensor,
                       top_f: Optional[torch.Tensor] = None,
                       left_e: Optional[torch.Tensor] = None,
                       local: bool = True,
                       substitution: Optional[torch.Tensor] = None,
                       want_bottom: bool = False) -> BlockOut:
    """Plain PyTorch version of the block kernels, on any device."""
    plain_calls["stripe_block_plain"] += 1
    out = scan_fill(a, b, scoring=scoring, top_row=top_row,
                    left_col=left_col, top_f=top_f, left_e=left_e,
                    local=local, sub_table=_table(substitution))
    return BlockOut(_pack(out), out.bottom_row if want_bottom else None,
                    out.right_col,
                    out.bottom_f if want_bottom else None, out.right_e)


def walk_p(P: torch.Tensor, wn: int, wm: int) -> torch.Tensor:
    """Walk the row-major int8 predecessor matrix P from (wn, wm) with the
    Gotoh state machine until a NONE code or row or column 0. Returns the
    moves (UP, LEFT, DIAGONAL codes), end-first, as an int8 tensor on the
    CPU: on a card only they leave it."""
    if P.dtype != torch.int8 or P.dim() != 2:
        raise ValueError(f"P must be a 2-D int8 tensor, got {P.dtype} "
                         f"{tuple(P.shape)}")
    if not (0 <= wn < P.shape[0] and 0 <= wm < P.shape[1]):
        raise ValueError(f"corner ({wn}, {wm}) outside P {tuple(P.shape)}")
    if P.device.type == "cpu":
        return walk_p_plain(P, wn, wm)
    if P.device.type != "cuda":
        raise ValueError(f"no walk for device {P.device}")
    return _launch_walk(P, wn, wm)


def _launch_walk(P: torch.Tensor, wn: int, wm: int,
                 name: str = WALK_KERNEL) -> torch.Tensor:
    """The walk entry ``name`` (the route's WALK_KERNEL or the earlier
    WALK_SCALAR_KERNEL) on a CUDA P; the moves on the CPU."""
    if P.stride(1) != 1:
        P = P.contiguous()
    # the row pitch: K4's padded rows are walked in place
    moves = torch.empty(max(wn + wm, 1), dtype=torch.int8, device=P.device)
    count = torch.empty(1, dtype=torch.int32, device=P.device)
    _call(name, P.device, [P.data_ptr(), P.stride(0), wn, wm,
                           moves.data_ptr(), count.data_ptr()])
    return moves[:int(count)].cpu()


def walk_p_plain(P: torch.Tensor, wn: int, wm: int) -> torch.Tensor:
    """Plain version of the walk: a host loop over P copied to the host
    (the JAX package's ``_scan_window_walk`` loop)."""
    plain_calls["walk_p_plain"] += 1
    Pn = P.cpu().numpy()
    moves = []
    i, j, state = wn, wm, 0
    while i > 0 and j > 0:
        code = int(Pn[i, j])
        move = state if state else code & 3
        if move == NONE:
            break
        moves.append(move)
        if move == UP:
            state = UP if code & F_EXT else 0
            i -= 1
        elif move == LEFT:
            state = LEFT if code & E_EXT else 0
            j -= 1
        else:
            state = 0
            i -= 1
            j -= 1
    return torch.tensor(moves, dtype=torch.int8)


def _table(substitution: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if substitution is None else embed_table(substitution)


def _pack(out) -> torch.Tensor:
    return torch.stack([out.max_score, out.max_i, out.max_j,
                        out.last_cell]).to(torch.int32)


def _route(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
           substitution: Optional[torch.Tensor], batched: bool = False) -> str:
    """Validate the inputs, one pair (1-D) or, ``batched``, B >= 1 pairs
    of one shape ((B, m) and (B, n)); return their device type, 'cpu' or
    'cuda'."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {a.dtype} and {b.dtype}")
    if batched:
        if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] \
                or a.shape[0] < 1:
            raise ValueError(f"a (B, m) and b (B, n) must share B >= 1, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
    elif a.dim() != 1 or b.dim() != 1:
        raise ValueError("a and b must be 1-D code tensors")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stripe fill for device {a.device}")
    m, n = a.shape[-1], b.shape[-1]
    if not kernels_take(m, n, scoring, substitution):
        raise ValueError(
            f"stripe kernel needs 1 <= m <= {MAX_WIDTH}, n >= 1 and negative "
            "gap penalties, and a negative mismatch without a substitution "
            f"table (m={m}, n={n}, {scoring})")
    if substitution is not None:
        S = substitution
        if S.dtype != torch.int32 or S.dim() != 2 or S.shape[0] != S.shape[1]:
            raise ValueError(f"substitution must be a square int32 table, "
                             f"got {S.dtype} {tuple(S.shape)}")
        if S.device != a.device:
            raise ValueError(f"substitution on {S.device}, codes on "
                             f"{a.device}")
        check_codes(a, b, S.shape[0])
        if max(int(S.max()), 1) * min(m, n) >= 1 << 30:
            raise ValueError("substitution scores times min(m, n) may "
                             "overflow int32")
    return a.device.type


def _stripe_rows(n: int, T: Optional[int], A: int = 0) -> int:
    """Rows per stripe: T (or the default), no more than n needs, and, for
    an alphabet of A symbols, no more than the profile's shared memory
    holds."""
    if T is None:
        T = DEFAULT_STRIPE_ROWS
    if T < 32 or T > 1024 or T % 32:
        raise ValueError(f"stripe rows T={T} must be a multiple of 32 "
                         "in [32, 1024]")
    T = min(T, -(-n // 32) * 32)        # no idle warps on short inputs
    if A:
        cap = SUB_PROFILE_BYTES // (4 * A) // 32 * 32
        if cap < 32:
            raise ValueError(f"a {A}-symbol substitution profile does not "
                             "fit in shared memory at 32 rows per stripe")
        T = min(T, cap)
    return T


def _check_block(a, b, scoring, top_row, left_col, top_f, left_e):
    """Validate the injected boundaries; return them as (top_row,
    left_col, top_f, left_e), the affine ones NEG where None (and None for
    a linear scoring)."""
    m, n = a.numel(), b.numel()
    want = {"top_row": (top_row, m + 1), "left_col": (left_col, n + 1)}
    if scoring.is_affine:
        neg = dict(dtype=torch.int32, device=a.device)
        if top_f is None:
            top_f = torch.full((m + 1,), NEG, **neg)
        if left_e is None:
            left_e = torch.full((n + 1,), NEG, **neg)
        want.update(top_f=(top_f, m + 1), left_e=(left_e, n + 1))
    else:
        top_f = left_e = None
    for name, (x, size) in want.items():
        if x.dtype != torch.int32 or x.shape != (size,):
            raise ValueError(f"{name} must be int32 of shape ({size},), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != a.device:
            raise ValueError(f"{name} on {x.device}, codes on {a.device}")
    return top_row, left_col, top_f, left_e


def _model(scoring: Scoring, sub: Optional[torch.Tensor]) -> list:
    """The scoring arguments of a C entry."""
    if sub is not None:
        return [sub.data_ptr(), sub.shape[0], int(scoring.is_affine),
                scoring.gap, scoring.gap_open, scoring.gap_extend]
    if scoring.is_affine:
        return [scoring.match, scoring.mismatch, scoring.gap_open,
                scoring.gap_extend]
    return [scoring.match, scoring.mismatch, scoring.gap]


def _call(name: str, dev: torch.device, args: list,
          counter: Optional[str] = None,
          counts: Optional[dict] = None) -> None:
    """Launch the C entry ``name`` on ``dev``'s current stream; count it
    under ``counter`` (default: the name) in ``counts`` (default:
    ``launches``)."""
    lib = _cuda.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda.check(name, getattr(lib, name)(*args, stream))
    (launches if counts is None else counts)[counter or name] += 1


def _scratch(n: int, m: int, T: Optional[int], sub, affine: bool,
             dev: torch.device):
    """(T, sync, bnd, bnd_f, best) of one launch: the stripe ticket and
    progress counters (zeroed), the H (and affine F) rows handed between
    stripes, the per-stripe firsts."""
    T = _stripe_rows(n, T, 0 if sub is None else sub.shape[0])
    stripes = -(-n // T)
    i32 = torch.int32
    sync = torch.zeros(stripes + 1, dtype=i32, device=dev)
    bnd = torch.empty(max(stripes - 1, 1) * (m + 1), dtype=i32, device=dev)
    bnd_f = torch.empty_like(bnd) if affine else None
    best = torch.empty((stripes, 4), dtype=i32, device=dev)
    return T, sync, bnd, bnd_f, best


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _launch(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
            T: Optional[int], sub: Optional[torch.Tensor],
            capture_p: bool, band: Optional[int]) -> StripeOut:
    """The stripe template's K1-K4 (``kernel_name``), or their band mode,
    the earlier designs, at T rows a stripe."""
    name = kernel_name(scoring, sub, capture_p)
    m, n = a.numel(), b.numel()
    dev = a.device
    a, b = a.contiguous(), b.contiguous()
    sub = None if sub is None else sub.contiguous()
    T, sync, bnd, bnd_f, best = _scratch(n, m, T, sub, scoring.is_affine,
                                         dev)
    right = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    # the linear substitution entry takes a null F row
    bnds = [bnd.data_ptr()]
    if sub is not None or scoring.is_affine:
        bnds.append(_ptr(bnd_f))
    args = [a.data_ptr(), b.data_ptr(), m, n, *_model(scoring, sub), T,
            sync.data_ptr(), *bnds, best.data_ptr(), right.data_ptr()]
    P = None
    if capture_p:
        P = torch.zeros((n + 1, m + 1), dtype=torch.int8, device=dev)
        args.append(P.data_ptr())
    args.append(NO_BAND if band is None else _clamp_band(band, m, n))
    _call(name, dev, args, kernel_name(scoring, sub, capture_p,
                                       band is not None))
    return StripeOut(_reduce(best, right, n), right, P)


def _clamp_band(band: int, m: int, n: int) -> int:
    """|i - j| < m + n everywhere: a wider band changes nothing and a band
    below -1 keeps no more cells than -1."""
    return max(-1, min(int(band), m + n))


def _rb_scratch(a, b, scoring: Scoring, sub, T: int, R: int) -> tuple:
    """(a, b, sub, sync, bnd, bnd_f, best) of a register-blocked launch:
    the inputs contiguous, the stripe ticket and progress counters
    (zeroed), the H (and affine F) rows handed between stripes, the
    per-stripe firsts."""
    m, n = a.numel(), b.numel()
    if n > (1 << 31) - 1 - T * R:
        raise ValueError(f"n={n} rows overflow int32")
    dev, i32 = a.device, torch.int32
    stripes = -(-n // (T * R))
    sync = torch.zeros(stripes + 1, dtype=i32, device=dev)
    bnd = torch.empty(max(stripes - 1, 1) * (m + 1), dtype=i32, device=dev)
    bnd_f = torch.empty_like(bnd) if scoring.is_affine else None
    best = torch.empty((stripes, 4), dtype=i32, device=dev)
    return (a.contiguous(), b.contiguous(),
            None if sub is None else sub.contiguous(), sync, bnd, bnd_f, best)


def _launch_rb(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
               T: Optional[int], R: Optional[int] = None,
               C: Optional[int] = None,
               sub: Optional[torch.Tensor] = None,
               band: Optional[int] = None) -> StripeOut:
    """The register-blocked K1-K3 (``RB_KERNELS``, by the scoring), or
    with a band their band form (``RB_BAND_KERNELS``), at T threads of R
    rows and C columns a step (``rb_shape``)."""
    mode = _mode(scoring, sub)
    m, n = a.numel(), b.numel()
    T, R, C = rb_shape(n, T, R, C, mode, 0 if sub is None else sub.shape[0],
                       "score" if band is None else "band")
    a, b, sub, sync, bnd, bnd_f, best = _rb_scratch(a, b, scoring, sub, T, R)
    # the F rows handed between stripes; the linear table entry takes null
    bnds = [bnd.data_ptr()] + ([_ptr(bnd_f)] if mode != "linear" else [])
    # zeroed: a banded launch writes only the rows whose band reaches m
    right = torch.zeros(n + 1, dtype=torch.int32, device=a.device)
    args = [a.data_ptr(), b.data_ptr(), m, n, *_model(scoring, sub), T, R, C,
            sync.data_ptr(), *bnds, best.data_ptr(), right.data_ptr()]
    if band is None:
        _call(RB_KERNELS[mode], a.device, args)
    else:
        _call(RB_BAND_KERNELS[mode], a.device,
              args + [_clamp_band(band, m, n)])
    return StripeOut(_reduce(best, right, n), right, None)


def p_matrix(n: int, m: int, device: torch.device) -> torch.Tensor:
    """An uninitialized (n+1, m+1) int8 P for K4: a view of rows of a pitch
    rounded up to P_PITCH_ALIGN bytes whose column 1 lies on a 4-byte
    boundary (the storage starts 3 bytes into its allocation), so that a
    row's codes of a tile store as words."""
    pitch = -(-(m + 1) // P_PITCH_ALIGN) * P_PITCH_ALIGN
    buf = torch.empty(3 + (n + 1) * pitch, dtype=torch.int8, device=device)
    return buf[3:].view(n + 1, pitch)[:, :m + 1]


def _launch_rb_p(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
                 T: Optional[int], R: Optional[int] = None,
                 C: Optional[int] = None,
                 sub: Optional[torch.Tensor] = None,
                 P: Optional[torch.Tensor] = None,
                 band: Optional[int] = None) -> StripeOut:
    """The register-blocked K4 (``RB_P_KERNELS``, by the scoring), or with
    a band its band form (``RB_BAND_P_KERNELS``), at T threads of R rows
    and C columns a step (``rb_shape``). ``P``: the (n+1, m+1) int8 output
    with unit column stride, column 1 and the row pitch 4-byte aligned,
    default ``p_matrix``'s; the kernel writes every cell of it (banded:
    every cell of its windows, after the wrapper clears P's cells) and no
    other byte."""
    mode = _mode(scoring, sub)
    m, n = a.numel(), b.numel()
    T, R, C = rb_shape(n, T, R, C, mode, 0 if sub is None else sub.shape[0],
                       "fill_p" if band is None else "fill_p_band")
    if P is None:
        P = p_matrix(n, m, a.device)
    if P.dtype != torch.int8 or P.shape != (n + 1, m + 1) \
            or P.stride(1) != 1 or P.stride(0) % 4 \
            or (P.data_ptr() + 1) % 4 or P.device != a.device:
        raise ValueError(f"P must be int8 ({n + 1}, {m + 1}) with unit "
                         "column stride, column 1 and the row pitch 4-byte "
                         f"aligned, on {a.device}, got {P.dtype} "
                         f"{tuple(P.shape)} {P.stride()} on {P.device}")
    if band is not None:
        P.zero_()           # NONE: the band form stores its windows only
    a, b, sub, sync, bnd, bnd_f, best = _rb_scratch(a, b, scoring, sub, T, R)
    bnds = [bnd.data_ptr()] + ([_ptr(bnd_f)] if mode != "linear" else [])
    right = torch.zeros(n + 1, dtype=torch.int32, device=a.device)
    args = [a.data_ptr(), b.data_ptr(), m, n, *_model(scoring, sub), T, R, C,
            sync.data_ptr(), *bnds, best.data_ptr(), right.data_ptr(),
            P.data_ptr(), P.stride(0)]
    if band is None:
        _call(RB_P_KERNELS[mode], a.device, args)
    else:
        _call(RB_BAND_P_KERNELS[mode], a.device,
              args + [_clamp_band(band, m, n)])
    return StripeOut(_reduce(best, right, n), right, P)


def _launch_rb_block(a, b, scoring, T, sub, top_row, left_col, top_f,
                     left_e, local, want_bottom, R=None, C=None) -> BlockOut:
    """The register-blocked K5 (``RB_BLOCK_KERNELS``, by the scoring) at T
    threads of R rows and C columns a step (``rb_shape``); the
    boundaries as ``_check_block`` returns them."""
    mode = _mode(scoring, sub)
    m, n = a.numel(), b.numel()
    T, R, C = rb_shape(n, T, R, C, mode, 0 if sub is None else sub.shape[0],
                       "block")
    a, b, sub, sync, bnd, bnd_f, best = _rb_scratch(a, b, scoring, sub, T, R)
    exports, args = _block_args(a, b, scoring, sub, [T, R, C], local,
                                top_row, left_col, top_f, left_e,
                                want_bottom, sync, bnd, bnd_f, best)
    _call(RB_BLOCK_KERNELS[mode], a.device, args)
    return BlockOut(_reduce(best, exports[1], n), *exports)


def _block_args(a, b, scoring, sub, shape, local, top_row, left_col, top_f,
                left_e, want_bottom, sync, bnd, bnd_f, best) -> tuple:
    """((bottom, right, bottom_f, right_e), the arguments of a K5 entry,
    the template's or the register-blocked one by ``shape``, [T] or [T,
    R, C]): the exports allocated, [0] of each set from the boundaries
    (the kernels write the rest): right[0] = top_row[m], bottom[0] =
    left_col[n], the affine ones NEG."""
    m, n = a.numel(), b.numel()
    i32 = torch.int32
    right = torch.empty(n + 1, dtype=i32, device=a.device)
    right[0] = top_row[m]
    bottom = bottom_f = right_e = None
    if want_bottom:
        bottom = torch.empty(m + 1, dtype=i32, device=a.device)
        bottom[0] = left_col[n]
    top_row, left_col = top_row.contiguous(), left_col.contiguous()
    args = [a.data_ptr(), b.data_ptr(), m, n, *_model(scoring, sub), *shape,
            int(local), top_row.data_ptr(), left_col.data_ptr()]
    if scoring.is_affine:
        top_f, left_e = top_f.contiguous(), left_e.contiguous()
        right_e = torch.full((n + 1,), NEG, dtype=i32, device=a.device)
        if want_bottom:
            bottom_f = torch.full((m + 1,), NEG, dtype=i32, device=a.device)
    if scoring.is_affine or sub is not None:
        args += [_ptr(top_f), _ptr(left_e), sync.data_ptr(), bnd.data_ptr(),
                 _ptr(bnd_f), best.data_ptr(), right.data_ptr(),
                 _ptr(right_e), _ptr(bottom), _ptr(bottom_f)]
    else:
        args += [sync.data_ptr(), bnd.data_ptr(), best.data_ptr(),
                 right.data_ptr(), _ptr(bottom)]
    return (bottom, right, bottom_f, right_e), args


def _launch_block(a, b, scoring, T, sub, top_row, left_col, top_f, left_e,
                  local, want_bottom) -> BlockOut:
    """The stripe template's K5 (``block_kernel_name``), the earlier
    design, at T rows a stripe."""
    name = block_kernel_name(scoring, sub)
    m, n = a.numel(), b.numel()
    a, b = a.contiguous(), b.contiguous()
    sub = None if sub is None else sub.contiguous()
    T, sync, bnd, bnd_f, best = _scratch(n, m, T, sub, scoring.is_affine,
                                         a.device)
    exports, args = _block_args(a, b, scoring, sub, [T], local, top_row,
                                left_col, top_f, left_e, want_bottom, sync,
                                bnd, bnd_f, best)
    _call(name, a.device, args)
    return BlockOut(_reduce(best, exports[1], n), *exports)


def _reduce(best: torch.Tensor, right: torch.Tensor, n: int) -> torch.Tensor:
    """(stripes, 4) per-stripe firsts -> (4,) on the device: the first
    stripe holding the global max wins (its rows come first)."""
    scores = best[:, 0]
    top = scores.max()
    rank = torch.arange(best.shape[0], dtype=torch.int32, device=best.device)
    row = best[torch.where(scores == top, rank, best.shape[0]).min()]
    has = top > 0
    return torch.stack([top.clamp(min=0), torch.where(has, row[1], 0),
                        torch.where(has, row[2], 0), right[n]]).to(torch.int32)
