"""The CUDA kernels of the batch path, and their plain version.

Counterpart of ``swtpu.kernels.pallas_fill``'s two batch scorers, for B
independent pairs of one shape, a (B, m) against b (B, n) int8 codes:

* ``pairs_score`` (K8, the ``pairs_score_fn`` counterpart): the pair grid,
  one launch of B x S stripe blocks. Unbanded it runs the batch form of
  the register-blocked stripe (C entries ``sw_pairs_rb_linear``,
  ``_affine``, ``_sub``, ``csrc/stripe_rb_pairs.cu``: T threads of R rows
  and C columns a step, ``rb_shape``'s 'pairs' kind); ``band=`` runs its
  band form (K8[band], ``sw_pairs_rb_band_linear``, ``_affine``, ``_sub``,
  ``csrc/stripe_rb_pairs_band.cu``, the 'pairs_band' kind: each pair's
  stripes visit only the columns their rows' band reaches). The stripe
  template's K8, one row a thread (``sw_pairs_score_linear``, ``_affine``,
  ``_sub``, a banded launch counted as ``<entry>[band]``), is the earlier
  design of both, on no route (``_launch_pairs``).
* ``pairs_packed_score`` (K7, the ``pairs_packed_score_fn`` counterpart):
  the B*n target rows packed into one stripe chain, a reset row at each
  pair's start (``sw_packed_score_linear``, ``_affine``, ``_sub``).

Both return ``BatchHits``: each pair's max and its first row-major end
cell, 1-based in the pair's own matrix, (0, 0, 0) for a pair with no
positive cell, as (B,) int32 tensors on the input's device. Their plain
version is ``pairs_score_plain``, the batched sweep ``batch_scan_fill``.

Each wrapper runs its kernel for tensors on a CUDA device and the plain
version for tensors on the CPU, and nowhere else; a failed build or launch
on a card raises. ``launches`` and ``plain_calls`` count them;
``reset_counts()`` zeroes these and the counters of
``kernels.stripe_fill``, ``kernels.window_fill`` and ``kernels.debug_fill``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import Scoring
from . import stripe_fill as sf
from .scan_fill import batch_scan_fill

PAIRS_KERNELS = {"linear": "sw_pairs_score_linear",
                 "affine": "sw_pairs_score_affine",
                 "sub": "sw_pairs_score_sub"}
# the register-blocked K8 entries by mode, and their band form's
PAIRS_RB_KERNELS = {mode: f"sw_pairs_rb_{mode}"
                    for mode in ("linear", "affine", "sub")}
PAIRS_RB_BAND_KERNELS = {mode: f"sw_pairs_rb_band_{mode}"
                         for mode in ("linear", "affine", "sub")}
PACKED_KERNELS = {"linear": "sw_packed_score_linear",
                  "affine": "sw_packed_score_affine",
                  "sub": "sw_packed_score_sub"}
launches = dict.fromkeys(
    [*PAIRS_RB_KERNELS.values(), *PAIRS_RB_BAND_KERNELS.values(),
     *PAIRS_KERNELS.values(),
     *(k + sf.BAND_SUFFIX for k in PAIRS_KERNELS.values()),
     *PACKED_KERNELS.values()], 0)
plain_calls = {"pairs_score_plain": 0}


class BatchHits(NamedTuple):
    """Per-pair results, (B,) int32 tensors."""
    scores: torch.Tensor        # each pair's max score
    max_i: torch.Tensor         # row of its first row-major max (1-based)
    max_j: torch.Tensor         # column of it


def reset_counts() -> None:
    """Zero every launch and plain-call counter of the port's kernels."""
    # both import this module, so not at the top
    from . import debug_fill, window_fill
    sf.reset_counts()
    for counts in (launches, plain_calls, window_fill.launches,
                   window_fill.plain_calls, debug_fill.launches,
                   debug_fill.plain_calls, debug_fill.rb_launches,
                   debug_fill.rb_plain_calls):
        for name in counts:
            counts[name] = 0


def pairs_kernel_name(scoring: Scoring, substitution,
                      banded: bool = False) -> str:
    """The launch counter of the K8 entry that ``pairs_score`` runs for
    this scoring on a card: the register-blocked entry, its band form
    with a band."""
    return (PAIRS_RB_BAND_KERNELS if banded else PAIRS_RB_KERNELS)[
        sf._mode(scoring, substitution)]


def pairs_template_name(scoring: Scoring, substitution,
                        banded: bool = False) -> str:
    """The launch counter of the stripe template's K8 entry of this
    scoring, the earlier design (``_launch_pairs``): the entry's name,
    plus ``BAND_SUFFIX`` when banded."""
    name = PAIRS_KERNELS[sf._mode(scoring, substitution)]
    return name + sf.BAND_SUFFIX if banded else name


def packed_kernel_name(scoring: Scoring, substitution) -> str:
    """The K7 entry that serves this scoring."""
    return PACKED_KERNELS[sf._mode(scoring, substitution)]


def pairs_score(a: torch.Tensor, b: torch.Tensor,
                scoring: Scoring = Scoring(), T: Optional[int] = None,
                substitution: Optional[torch.Tensor] = None,
                band: Optional[int] = None) -> BatchHits:
    """K8: score B pairs, a (B, m) against b (B, n) int8 codes on one
    device. ``T`` (CUDA only): threads per block of the register-blocked
    form (each holding R rows, ``rb_shape``). ``substitution``: an (A, A)
    int32 table on the same device, or None for match/mismatch. ``band``:
    keep only the cells with |i - j| <= band."""
    if sf._route(a, b, scoring, substitution, batched=True) == "cpu":
        return pairs_score_plain(a, b, scoring, substitution, band)
    return _launch_pairs_rb(a, b, scoring, T, sub=substitution, band=band)


def pairs_packed_score(a: torch.Tensor, b: torch.Tensor,
                       scoring: Scoring = Scoring(), T: Optional[int] = None,
                       substitution: Optional[torch.Tensor] = None
                       ) -> BatchHits:
    """K7: ``pairs_score``'s function with every pair's rows packed into
    one stripe chain. ``T``: rows per stripe (CUDA only); by default one
    that divides n or is a multiple of n where one fits
    (``packed_stripe_rows``)."""
    if sf._route(a, b, scoring, substitution, batched=True) == "cpu":
        return pairs_score_plain(a, b, scoring, substitution)
    return _launch_packed(a, b, scoring, T, substitution)


def pairs_score_plain(a: torch.Tensor, b: torch.Tensor,
                      scoring: Scoring = Scoring(),
                      substitution: Optional[torch.Tensor] = None,
                      band: Optional[int] = None) -> BatchHits:
    """Plain PyTorch version of K8 and K7, on any device."""
    plain_calls["pairs_score_plain"] += 1
    return BatchHits(*batch_scan_fill(a, b, scoring=scoring, band=band,
                                      sub_table=sf._table(substitution)))


def chain_cutting_rows(n: int, A: int = 0) -> Optional[int]:
    """The multiple of 32 within [32, 1024] (and the profile's cap for an
    alphabet of A letters) nearest the default that divides n or is a
    multiple of n, so that every stripe holding a pair's first row starts
    a chain of its own in K7; None where no such T exists (n = 300, 1000,
    1500, ...), and K7's chain then crosses pair boundaries."""
    cap = sf._stripe_rows(1024, 1024, A)
    fits = [t for t in range(32, cap + 1, 32) if n % t == 0 or t % n == 0]
    if not fits:
        return None
    return min(fits, key=lambda t: (abs(t - sf.DEFAULT_STRIPE_ROWS), -t))


def packed_stripe_rows(n: int, B: int, T: Optional[int] = None,
                       A: int = 0) -> int:
    """K7's rows per stripe for B pairs of n rows: T if given, else
    ``chain_cutting_rows`` where one exists, else the default."""
    if T is None:
        T = chain_cutting_rows(n, A)
    return sf._stripe_rows(B * n, T, A)


def _scratch(stripes: int, m: int, affine: bool, dev: torch.device):
    """(bnd, bnd_f) of a launch: ``stripes`` boundary rows of m + 1 int32
    (at least one), the F rows only when affine."""
    bnd = torch.empty(max(stripes, 1) * (m + 1), dtype=torch.int32,
                      device=dev)
    return bnd, (torch.empty_like(bnd) if affine else None)


def _launch_pairs_rb(a, b, scoring, T, R=None, C=None, sub=None,
                     band=None) -> BatchHits:
    """The register-blocked K8 (``PAIRS_RB_KERNELS``, by the scoring), or
    with a band its band form (``PAIRS_RB_BAND_KERNELS``), at T threads of
    R rows and C columns a step (``rb_shape``'s 'pairs' or 'pairs_band'
    kind over each pair's n rows)."""
    (B, m), n = a.shape, b.shape[1]
    mode = sf._mode(scoring, sub)
    T, R, C = sf.rb_shape(n, T, R, C, mode,
                          0 if sub is None else sub.shape[0],
                          "pairs" if band is None else "pairs_band")
    # the band form's sums (its windows' ends, the cell's band test) too
    if n > (1 << 31) - 1 - T * R or B * max(m, n) > (1 << 31) - 1 or (
            band is not None and 2 * (m + n) + T * R + 8 > (1 << 31) - 1):
        raise ValueError(f"{B} pairs of {m} x {n} overflow int32")
    dev, i32 = a.device, torch.int32
    a, b = a.contiguous(), b.contiguous()
    sub = None if sub is None else sub.contiguous()
    S = -(-n // (T * R))
    sync = torch.zeros(1 + B * S, dtype=i32, device=dev)
    bnd, bnd_f = _scratch(B * (S - 1), m, scoring.is_affine, dev)
    best = torch.empty((B, S, 4), dtype=i32, device=dev)
    # the F rows handed between stripes; the linear table entry takes null
    bnds = [bnd.data_ptr()] + ([sf._ptr(bnd_f)] if mode != "linear" else [])
    args = [a.data_ptr(), b.data_ptr(), B, m, n, *sf._model(scoring, sub), T,
            R, C, sync.data_ptr(), *bnds, best.data_ptr()]
    if band is None:
        sf._call(PAIRS_RB_KERNELS[mode], dev, args, None, launches)
    else:
        sf._call(PAIRS_RB_BAND_KERNELS[mode], dev,
                 args + [sf._clamp_band(band, m, n)], None, launches)
    return _reduce_stripes(best)


def _launch_pairs(a, b, scoring, T, sub, band) -> BatchHits:
    """The stripe template's K8 at T rows a stripe, or with a band its
    banded instantiation, the earlier designs of K8 and K8[band]."""
    (B, m), n = a.shape, b.shape[1]
    dev = a.device
    i32 = torch.int32
    a, b = a.contiguous(), b.contiguous()
    sub = None if sub is None else sub.contiguous()
    T = sf._stripe_rows(n, T, 0 if sub is None else sub.shape[0])
    S = -(-n // T)
    sync = torch.zeros(1 + B * S, dtype=i32, device=dev)
    bnd, bnd_f = _scratch(B * (S - 1), m, scoring.is_affine, dev)
    best = torch.empty((B, S, 4), dtype=i32, device=dev)
    right = torch.empty(B * (n + 1), dtype=i32, device=dev)
    bnds = [bnd.data_ptr()]
    if sub is not None or scoring.is_affine:
        bnds.append(sf._ptr(bnd_f))
    args = [a.data_ptr(), b.data_ptr(), B, m, n, *sf._model(scoring, sub), T,
            sync.data_ptr(), *bnds, best.data_ptr(), right.data_ptr(),
            sf.NO_BAND if band is None else sf._clamp_band(band, m, n)]
    sf._call(pairs_template_name(scoring, sub), dev, args,
             pairs_template_name(scoring, sub, band is not None), launches)
    return _reduce_stripes(best)


def _launch_packed(a, b, scoring, T, sub) -> BatchHits:
    (B, m), n = a.shape, b.shape[1]
    if B * n > (1 << 31) - 1 - 1024:
        raise ValueError(f"{B} x {n} packed rows overflow int32")
    dev = a.device
    i32 = torch.int32
    a, b = a.contiguous(), b.contiguous()
    sub = None if sub is None else sub.contiguous()
    T = packed_stripe_rows(n, B, T, 0 if sub is None else sub.shape[0])
    S = -(-(B * n) // T)
    sync = torch.zeros(1 + S, dtype=i32, device=dev)
    bnd, bnd_f = _scratch(S - 1, m, scoring.is_affine, dev)
    row_best = torch.empty((B, n, 2), dtype=i32, device=dev)
    right = torch.empty(B * n + 1, dtype=i32, device=dev)
    bnds = [bnd.data_ptr()]
    if sub is not None or scoring.is_affine:
        bnds.append(sf._ptr(bnd_f))
    args = [a.data_ptr(), b.data_ptr(), B, m, n, *sf._model(scoring, sub), T,
            sync.data_ptr(), *bnds, row_best.data_ptr(), right.data_ptr()]
    name = packed_kernel_name(scoring, sub)
    sf._call(name, dev, args, name, launches)
    return _reduce_rows(row_best)


def _reduce_stripes(best: torch.Tensor) -> BatchHits:
    """(B, S, 4) stripe bests -> each pair's first stripe holding its max
    (its rows come first), on the device (``_reduce`` per pair)."""
    scores = best[..., 0]
    top = scores.max(dim=1).values
    rank = torch.arange(best.shape[1], dtype=torch.int32, device=best.device)
    first = torch.where(scores == top[:, None], rank, best.shape[1]) \
        .min(dim=1).values
    row = best[torch.arange(best.shape[0], device=best.device), first.long()]
    has = top > 0
    return BatchHits(top.clamp(min=0), torch.where(has, row[:, 1], 0),
                     torch.where(has, row[:, 2], 0))


def _reduce_rows(row_best: torch.Tensor) -> BatchHits:
    """(B, n, 2) per-row (best, first column) -> each pair's max and the
    first row holding it, on the device (the JAX ``per_pair`` reduce)."""
    scores = row_best[..., 0]
    top = scores.max(dim=1).values
    n = row_best.shape[1]
    rank = torch.arange(n, dtype=torch.int32, device=row_best.device)
    first = torch.where(scores == top[:, None], rank, n).min(dim=1).values
    col = row_best[torch.arange(row_best.shape[0], device=row_best.device),
                   first.long(), 1]
    has = top > 0
    return BatchHits(top.clamp(min=0), torch.where(has, first + 1, 0),
                     torch.where(has, col, 0))
