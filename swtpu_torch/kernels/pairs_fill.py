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
  the pairs' rows packed into stripes, every stripe starting at a pair's
  first row. It runs the packed form of the register-blocked stripe (C
  entries ``sw_packed_rb_linear``, ``_affine``, ``_sub``,
  ``csrc/stripe_rb_packed.cu``, ``rb_shape``'s 'packed' kind), whose
  geometry is ``packed_rb_geometry``: each pair's rows at a pitch of whole
  threads, whole pairs a stripe where a pair's rows fit one, else each
  pair's own chain of stripes. The stripe template's K7, the B*n rows in
  one stripe chain with a reset row at each pair's start
  (``sw_packed_score_linear``, ``_affine``, ``_sub``), is its earlier
  design, on no route (``_launch_packed``).

Both return ``BatchHits``: each pair's max and its first row-major end
cell, 1-based in the pair's own matrix, (0, 0, 0) for a pair with no
positive cell, as (B,) int32 tensors on the input's device. Their plain
version is ``pairs_score_plain``, the batched sweep ``batch_scan_fill``.

Each wrapper runs its kernel for tensors on a CUDA device and the plain
version for tensors on the CPU, and nowhere else; a failed build or launch
on a card raises. ``launches`` and ``plain_calls`` count them;
``reset_counts()`` zeroes these and the counters of
``kernels.stripe_fill``, ``kernels.window_fill``, ``kernels.debug_fill``
and ``kernels.pack_rows``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import Scoring
from . import pack_rows
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
# the register-blocked K7 entries by mode (its packed form)
PACKED_RB_KERNELS = {mode: f"sw_packed_rb_{mode}"
                     for mode in ("linear", "affine", "sub")}
launches = dict.fromkeys(
    [*PAIRS_RB_KERNELS.values(), *PAIRS_RB_BAND_KERNELS.values(),
     *PAIRS_KERNELS.values(),
     *(k + sf.BAND_SUFFIX for k in PAIRS_KERNELS.values()),
     *PACKED_KERNELS.values(), *PACKED_RB_KERNELS.values()], 0)
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
    for counts in (launches, plain_calls, pack_rows.launches,
                   pack_rows.plain_calls, window_fill.launches,
                   window_fill.plain_calls, debug_fill.launches,
                   debug_fill.plain_calls, debug_fill.rb_launches,
                   debug_fill.rb_plain_calls, debug_fill.packed_rb_launches,
                   debug_fill.packed_rb_plain_calls):
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
    """The launch counter of the K7 entry that ``pairs_packed_score`` runs
    for this scoring on a card: the packed form of the register-blocked
    stripe."""
    return PACKED_RB_KERNELS[sf._mode(scoring, substitution)]


def packed_template_name(scoring: Scoring, substitution) -> str:
    """The launch counter of the stripe template's K7 entry of this
    scoring, the earlier design (``_launch_packed``)."""
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
                       substitution: Optional[torch.Tensor] = None,
                       R: Optional[int] = None,
                       C: Optional[int] = None) -> BatchHits:
    """K7: ``pairs_score``'s function with the pairs' rows packed into
    stripes that each start at a pair's first row (``packed_rb_geometry``).
    ``T`` (CUDA only): threads per block, each holding R rows and C columns
    a step (``rb_shape``'s 'packed' kind); where a pair's rows fit a
    stripe, rounded to the warps of the whole pairs it holds."""
    if sf._route(a, b, scoring, substitution, batched=True) == "cpu":
        return pairs_score_plain(a, b, scoring, substitution)
    return _launch_packed_rb(a, b, scoring, T, R, C, substitution)


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
    a chain of its own in the stripe template's K7; None where no such T
    exists (n = 300, 1000, 1500, ...), and that K7's chain then crosses
    pair boundaries (the packed form's geometry cuts it at every pair)."""
    cap = sf._stripe_rows(1024, 1024, A)
    fits = [t for t in range(32, cap + 1, 32) if n % t == 0 or t % n == 0]
    if not fits:
        return None
    return min(fits, key=lambda t: (abs(t - sf.DEFAULT_STRIPE_ROWS), -t))


def packed_stripe_rows(n: int, B: int, T: Optional[int] = None,
                       A: int = 0) -> int:
    """The stripe template's K7's rows per stripe for B pairs of n rows: T
    if given, else ``chain_cutting_rows`` where one exists, else the
    default."""
    if T is None:
        T = chain_cutting_rows(n, A)
    return sf._stripe_rows(B * n, T, A)


class PackedGeometry(NamedTuple):
    """Where the packed form of K7 (and its capture, the packed K9) puts
    every row of every pair: ``packed_rb_geometry``'s answer."""
    B: int              # pairs
    n: int              # rows a pair
    T: int              # threads a block, the launch's
    R: int              # rows a thread
    rlen: int           # the pair pitch: ceil(n / R) * R rows, whole threads
    per: int            # pairs a stripe (1 where a pair spans stripes)
    spp: int            # stripes a pair (1 where a stripe holds whole pairs)
    stripes: int        # blocks of the launch

    @property
    def tpp(self) -> int:
        """Threads of one pair in a stripe: rlen / R where a stripe holds
        whole pairs, else T."""
        return self.rlen // self.R if self.spp == 1 else self.T

    def threads(self, device=None) -> tuple:
        """(g, row0, kk), each (stripes, T) int64: thread k of stripe s
        holds rows row0 + 1 .. row0 + R (1-based, past n the pad rows) of
        pair g and visits the tile t - kk at step t; g = -1, row0 = n and
        kk = T in a thread that holds no pair (past the stripe's last)."""
        s = torch.arange(self.stripes, device=device)[:, None]
        k = torch.arange(self.T, device=device)[None, :]
        if self.spp > 1:        # stripe s % spp of pair s // spp
            g, kk = s // self.spp + 0 * k, k + 0 * s
            row0, live = (s % self.spp) * self.T * self.R + k * self.R, None
        else:                   # per whole pairs of tpp threads each
            slot = k // self.tpp
            g = s * self.per + slot
            live = (slot < self.per) & (g < self.B)
            kk = k - slot * self.tpp
            row0 = kk * self.R
        if live is not None:
            g = torch.where(live, g, -1)
            row0 = torch.where(live, row0, self.n)
            kk = torch.where(live, kk, self.T)
        return g, row0, kk

    def cells(self, steps: int, C: int, device=None) -> tuple:
        """(g, i, j): the cell of every slot (s, t, k, r, c) of a capture
        of ``steps`` steps, C columns a step, as int64 tensors broadcasting
        to (stripes, steps, T, R, C): row i (1-based, pad rows past n) of
        pair g (-1: no pair), column j = (t - kk) * C + c + 1 (columns
        outside 1..m included). The one map the kernel wrapper, the plain
        capture and ``check_capture`` read."""
        g, row0, kk = (x[:, None, :, None, None]
                       for x in self.threads(device))
        t = torch.arange(steps, device=device).view(1, -1, 1, 1, 1)
        r = torch.arange(self.R, device=device).view(1, 1, 1, -1, 1)
        c = torch.arange(C, device=device).view(1, 1, 1, 1, -1)
        return g, row0 + r + 1, (t - kk) * C + c + 1

    def stripe_steps(self, m: int, C: int) -> torch.Tensor:
        """(stripes,) int64: the steps each stripe runs, ceil(m / C) + kt
        - 1, kt the threads of its pair (each, alike) holding rows."""
        s = torch.arange(self.stripes)
        rows = (self.n - (s % self.spp) * self.T * self.R).clamp(
            max=self.T * self.R)
        return -(-m // C) + -(-rows // self.R) - 1

    def reads(self) -> torch.Tensor:
        """(stripes,) bool: the stripes that read a boundary row, those
        that continue a pair from the stripe above."""
        return torch.arange(self.stripes) % self.spp != 0


def packed_rb_geometry(B: int, n: int, T: int, R: int) -> PackedGeometry:
    """The packed form's geometry for B pairs of n rows at T threads of R
    rows (the port's ``packed_pairs_geometry``, the one source of it: the
    kernel wrapper, the plain capture, ``check_capture`` and chip_smoke.py
    read it). Each pair's rows sit at a pitch of rlen = ceil(n / R) * R, so
    a thread's R rows are one pair's and every stripe starts at a pair's
    row 1: where rlen <= T * R a stripe holds per = T // (rlen / R) whole
    pairs (at most B) and T is rounded up to the warps they need, its
    threads past the last pair idle; above, each pair takes spp = ceil(n /
    (T * R)) stripes of its own. Raises ValueError where the rows or
    ``row_best``'s offsets overflow int32."""
    if B < 1 or n < 1 or T < 32 or T % 32 or R < 1:
        raise ValueError(f"no packed geometry for B={B}, n={n}, T={T}, "
                         f"R={R}")
    rlen = -(-n // R) * R
    if 2 * B * rlen > (1 << 31) - 1 - T * R:
        raise ValueError(f"{B} pairs of {n} rows overflow int32")
    if rlen > T * R:
        spp = -(-rlen // (T * R))
        return PackedGeometry(B, n, T, R, rlen, 1, spp, B * spp)
    tpp = rlen // R
    T = -(-min(T // tpp, B) * tpp // 32) * 32
    per = T // tpp
    return PackedGeometry(B, n, T, R, rlen, per, 1, -(-B // per))


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


def _launch_packed_rb(a, b, scoring, T, R=None, C=None,
                      sub=None) -> BatchHits:
    """The register-blocked K7 (``PACKED_RB_KERNELS``, by the scoring) at
    ``packed_rb_geometry``'s launch of T threads of R rows and C columns a
    step (``rb_shape``'s 'packed' kind)."""
    n = b.shape[1]
    mode = sf._mode(scoring, sub)
    T, R, C = sf.rb_shape(n, T, R, C, mode,
                          0 if sub is None else sub.shape[0], "packed")
    args, row_best = packed_args(a, b, scoring, sub,
                                 packed_rb_geometry(a.shape[0], n, T, R), C)
    sf._call(PACKED_RB_KERNELS[mode], a.device, args, None, launches)
    return _reduce_rows(row_best)


def packed_args(a, b, scoring, sub, geo: PackedGeometry, C: int) -> tuple:
    """(args, row_best) of a launch of the packed form (K7, and the packed
    K9 before its capture's own arguments) at ``geo`` and C columns a step:
    the codes and the model, (T, R, C), the ticket and a counter a ticket
    (zeroed), the H (and affine F) rows handed between a pair's stripes,
    and row_best (B, n, 2), each row's (best, first column)."""
    (B, m), n = a.shape, b.shape[1]
    if B * m > (1 << 31) - 1:
        raise ValueError(f"{B} pairs of {m} x {n} overflow int32")
    dev, i32 = a.device, torch.int32
    a, b = a.contiguous(), b.contiguous()
    sub = None if sub is None else sub.contiguous()
    sync = torch.zeros(1 + geo.stripes, dtype=i32, device=dev)
    bnd, bnd_f = _scratch(B * (geo.spp - 1), m, scoring.is_affine, dev)
    row_best = torch.empty((B, n, 2), dtype=i32, device=dev)
    # the F rows handed between stripes; the linear table entry takes null
    bnds = [bnd.data_ptr()] + ([sf._ptr(bnd_f)]
                               if sf._mode(scoring, sub) != "linear" else [])
    return ([a.data_ptr(), b.data_ptr(), B, m, n, *sf._model(scoring, sub),
             geo.T, geo.R, C, sync.data_ptr(), *bnds, row_best.data_ptr()],
            row_best)


def _launch_packed(a, b, scoring, T, sub) -> BatchHits:
    """The stripe template's K7 at T rows a stripe (``packed_stripe_rows``),
    the earlier design."""
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
    name = packed_template_name(scoring, sub)
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
