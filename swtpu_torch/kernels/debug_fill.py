"""The sanitizer's capture kernel, K9, and its plain version.

Counterpart of ``swtpu.kernels.pallas_fill``'s ``_stripe_call(debug_h=
True)``: a score-only fill that also returns H of every thread slot at
every step, for ``instrument.sanitize`` to check cell by cell.

* ``stripe_capture``: one pair, a (m,) against b (n,) int8 codes, in the
  K1-K3 scorings (C entries ``sw_sanitize_stripe_linear``, ``_affine``,
  ``_sub``), at the stripe height ``stripe_fill`` launches.
* ``packed_capture``: B pairs of one shape, a (B, m) against b (B, n),
  packed as K7 packs them (``sw_sanitize_packed_linear``, ``_affine``,
  ``_sub``), at the stripe height ``pairs_packed_score`` launches.

Both return ``Capture``: ``h``, (stripes, m + T - 1, T) int32, slot
(s, t, k) holding H of cell (s*T + k + 1, t - k + 1) after step t (0 for a
slot outside the matrix, ``UNSCHEDULED`` for the last stripe's steps past
its own m + rows - 1); ``seen``, (stripes, m + 1) int32, the progress of
stripe s - 1 that stripe s had seen when it read column j of the boundary
row (-1 where it read none); and each pair's max score.

Each wrapper launches its kernel for tensors on a CUDA device and runs its
plain version (``stripe_capture_plain``, ``packed_capture_plain``) for
tensors on the CPU, and nowhere else; a failed build or launch raises. The
plain version follows the kernel's stripe schedule: one ``scan_fill`` per
stripe (per segment between a pair's first rows in the packed mode), each
starting from the stripe above's last row, so that the test hook ``skew``
(read boundary column j - skew: a broken hand-off) gives the same wrong
cells on the card and off it. A sequential producer has always finished,
so the plain ``seen`` is m wherever a stripe reads the boundary.

``launches`` and ``plain_calls`` count them; ``pairs_fill.reset_counts()``
zeroes them with every other kernel's counters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import Scoring
from . import pairs_fill as pf
from . import stripe_fill as sf
from .scan_fill import NEG, scan_fill

# the largest capture the sanitizer takes, in int32 slots (1 GiB)
SANITIZE_MAX_SLOTS = 1 << 28
# what a slot the kernel never schedules keeps
UNSCHEDULED = -(1 << 31)

DEBUG_KERNELS = {
    (False, "linear"): "sw_sanitize_stripe_linear",
    (False, "affine"): "sw_sanitize_stripe_affine",
    (False, "sub"): "sw_sanitize_stripe_sub",
    (True, "linear"): "sw_sanitize_packed_linear",
    (True, "affine"): "sw_sanitize_packed_affine",
    (True, "sub"): "sw_sanitize_packed_sub",
}
launches = dict.fromkeys(DEBUG_KERNELS.values(), 0)
plain_calls = {"stripe_capture_plain": 0, "packed_capture_plain": 0}


class Capture(NamedTuple):
    """A K9 capture, tensors on the input's device."""
    h: torch.Tensor         # (stripes, m + T - 1, T) int32
    seen: torch.Tensor      # (stripes, m + 1) int32
    T: int                  # rows per stripe
    scores: torch.Tensor    # (B,) int32: each pair's max (B = 1: one pair)


def same_capture(k: Capture, p: Capture, skewed: bool = False) -> int:
    """The max |h| difference of a kernel capture ``k`` and a plain capture
    ``p`` of the same inputs, after holding their T, shapes and scores
    equal and their ``seen`` to what it proves: the card's is a race
    observation (the plain producer has always finished), so both must
    read the boundary in the same stripes and, but under the test hook
    (``skewed``), each read must follow its column's release. Raises
    ValueError where they differ."""
    if k.T != p.T or k.h.shape != p.h.shape:
        raise ValueError(f"T {k.T} != {p.T} or h {tuple(k.h.shape)} != "
                         f"{tuple(p.h.shape)}")
    if not torch.equal(k.scores.cpu(), p.scores.cpu()):
        raise ValueError(f"scores {k.scores.tolist()} != "
                         f"{p.scores.tolist()}")
    ks, ps = k.seen.cpu(), p.seen.cpu()
    if not torch.equal(ks == -1, ps == -1):
        raise ValueError("the stripes that read the boundary differ")
    col = torch.arange(ks.shape[1])
    if not skewed and not bool(((ks >= col) | (ks == -1)).all()):
        raise ValueError("a boundary read preceded its column's release")
    return int((k.h.long() - p.h.long()).abs().max())


def debug_kernel_name(scoring: Scoring, substitution, packed: bool) -> str:
    """The K9 entry that serves this scoring."""
    return DEBUG_KERNELS[packed, sf._mode(scoring, substitution)]


def stripe_capture(a: torch.Tensor, b: torch.Tensor,
                   scoring: Scoring = Scoring(), T: Optional[int] = None,
                   substitution: Optional[torch.Tensor] = None,
                   skew: int = 0) -> Capture:
    """K9 on one pair: ``stripe_score``'s fill with the capture. ``T``:
    rows per stripe, resolved as ``stripe_score`` resolves it on both
    devices; ``skew``: the hand-off test hook, 0 in a sanitizer run."""
    if sf._route(a, b, scoring, substitution) == "cpu":
        return stripe_capture_plain(a, b, scoring, T, substitution, skew)
    return _launch(a[None], b, b.numel(), scoring, substitution, skew,
                   _stripe_rows(b, T, substitution))


def packed_capture(a: torch.Tensor, b: torch.Tensor,
                   scoring: Scoring = Scoring(), T: Optional[int] = None,
                   substitution: Optional[torch.Tensor] = None,
                   skew: int = 0) -> Capture:
    """K9 on B pairs, a (B, m) against b (B, n), packed as K7 packs them
    (``pairs_packed_score``)."""
    if sf._route(a, b, scoring, substitution, batched=True) == "cpu":
        return packed_capture_plain(a, b, scoring, T, substitution, skew)
    return _launch(a, b, b.shape[1], scoring, substitution, skew,
                   _packed_rows(b, T, substitution))


def stripe_capture_plain(a: torch.Tensor, b: torch.Tensor,
                         scoring: Scoring = Scoring(),
                         T: Optional[int] = None,
                         substitution: Optional[torch.Tensor] = None,
                         skew: int = 0) -> Capture:
    """Plain PyTorch version of the single-pair K9 entries, on any
    device."""
    plain_calls["stripe_capture_plain"] += 1
    return _plain(a[None], b, b.numel(), scoring, substitution, skew,
                  _stripe_rows(b, T, substitution))


def packed_capture_plain(a: torch.Tensor, b: torch.Tensor,
                         scoring: Scoring = Scoring(),
                         T: Optional[int] = None,
                         substitution: Optional[torch.Tensor] = None,
                         skew: int = 0) -> Capture:
    """Plain PyTorch version of the packed K9 entries, on any device."""
    plain_calls["packed_capture_plain"] += 1
    return _plain(a, b.reshape(-1), b.shape[1], scoring, substitution, skew,
                  _packed_rows(b, T, substitution))


def _alphabet(sub: Optional[torch.Tensor]) -> int:
    return 0 if sub is None else sub.shape[0]


def _stripe_rows(b, T, sub) -> int:
    return sf._stripe_rows(b.numel(), T, _alphabet(sub))


def _packed_rows(b, T, sub) -> int:
    return pf.packed_stripe_rows(b.shape[1], b.shape[0], T, _alphabet(sub))


def _buffers(n: int, m: int, T: int, skew: int, dev: torch.device) -> tuple:
    """(h, seen) of a capture of n rows by m columns: h all UNSCHEDULED,
    seen all -1. Raises ValueError above SANITIZE_MAX_SLOTS (which keeps
    n far below int32's range) or for a negative skew."""
    if skew < 0:
        raise ValueError(f"skew must be >= 0, got {skew}")
    stripes = -(-n // T)
    if stripes * (m + T - 1) * T > SANITIZE_MAX_SLOTS:
        raise ValueError(
            f"a capture of {stripes} stripes x {m + T - 1} steps x {T} rows "
            f"exceeds {SANITIZE_MAX_SLOTS} slots: the sanitizer is sized "
            "for debug shapes")
    i32 = torch.int32
    return (torch.full((stripes, m + T - 1, T), UNSCHEDULED, dtype=i32,
                       device=dev),
            torch.full((stripes, m + 1), -1, dtype=i32, device=dev))


def _launch(a: torch.Tensor, b: torch.Tensor, rows: int, scoring: Scoring,
            sub: Optional[torch.Tensor], skew: int, T: int) -> Capture:
    """Launch K9 on a (B, m) against b: one pair's (n,) codes (rows = n)
    or B pairs' (B, rows), packed."""
    packed = b.dim() == 2
    (B, m), n = a.shape, b.numel()
    dev = a.device
    h, seen = _buffers(n, m, T, skew, dev)
    i32 = torch.int32
    a, b = a.contiguous(), b.contiguous()
    sub = None if sub is None else sub.contiguous()
    stripes = h.shape[0]
    sync = torch.zeros(stripes + 1, dtype=i32, device=dev)
    bnd, bnd_f = pf._scratch(stripes - 1, m, scoring.is_affine, dev)
    bnds = [bnd.data_ptr()]
    if sub is not None or scoring.is_affine:
        bnds.append(sf._ptr(bnd_f))
    right = torch.zeros(n + 1, dtype=i32, device=dev)
    shape = [B, m, rows] if packed else [m, n]
    if packed:
        best = torch.empty((B, rows, 2), dtype=i32, device=dev)
    else:
        best = torch.empty((stripes, 4), dtype=i32, device=dev)
    args = [a.data_ptr(), b.data_ptr(), *shape, *sf._model(scoring, sub), T,
            sync.data_ptr(), *bnds, best.data_ptr(), right.data_ptr(),
            h.data_ptr(), seen.data_ptr(), skew]
    name = debug_kernel_name(scoring, sub, packed)
    sf._call(name, dev, args, name, launches)
    scores = (pf._reduce_rows(best).scores if packed
              else sf._reduce(best, right, n)[:1])
    return Capture(h, seen, T, scores)


def _shift(row: torch.Tensor, skew: int, fill: int) -> torch.Tensor:
    """The boundary row a skewed consumer reads: column j takes the
    producer's column j - skew, ``fill`` where that is < 1."""
    if not skew:
        return row
    out = torch.full_like(row, fill)
    out[skew + 1:] = row[1:max(row.numel() - skew, 1)]
    return out


def _plain(a: torch.Tensor, b: torch.Tensor, rows: int, scoring: Scoring,
           sub: Optional[torch.Tensor], skew: int, T: int) -> Capture:
    """The capture by one ``scan_fill`` per stripe segment: a (G, m) codes
    of G pairs, b the G * rows packed target codes (G = 1: one pair)."""
    (G, m), n = a.shape, b.numel()
    dev = a.device
    h, seen = _buffers(n, m, T, skew, dev)
    table = sf._table(sub)
    affine = scoring.is_affine
    scores = torch.zeros(G, dtype=torch.int32, device=dev)
    bottom = bottom_f = None            # the stripe above's last row
    for s in range(h.shape[0]):
        lo, hi = s * T, min(n, s * T + T)
        h[s, :m + hi - lo - 1] = 0
        r0 = lo
        while r0 < hi:                  # segments split at a pair's row 1
            g = r0 // rows
            r1 = min(hi, (g + 1) * rows)
            kw = {}
            if r0 % rows:               # continues the stripe above
                kw["top_row"] = _shift(bottom, skew, 0)
                if affine:
                    kw["top_f"] = _shift(bottom_f, skew, NEG)
                seen[s, 1:] = m
            out = scan_fill(a[g], b[r0:r1], scoring=scoring, return_h=True,
                            sub_table=table, **kw)
            k0 = r0 - lo
            h[s, k0:k0 + m + r1 - r0 - 1, k0:k0 + r1 - r0] = out.h_diag
            scores[g] = torch.maximum(scores[g], out.max_score)
            bottom, bottom_f = out.bottom_row, out.bottom_f
            r0 = r1
    return Capture(h, seen, T, scores)
