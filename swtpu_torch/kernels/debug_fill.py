"""The sanitizer's capture kernels, K9, and their plain versions.

Counterpart of ``swtpu.kernels.pallas_fill``'s ``_stripe_call(debug_h=
True)``: a score-only fill that also returns H of every thread slot at
every step, for ``instrument.sanitize`` to check cell by cell.

* ``stripe_rb_capture``: one pair, a (m,) against b (n,) int8 codes, on
  the register-blocked stripe that ``stripe_score`` (``score()``) runs, in
  its K1-K3 scorings (C entries ``sw_sanitize_rb_linear``, ``_affine``,
  ``_sub``, ``csrc/stripe_rb_debug.cu``), at ``_launch_rb``'s geometry:
  T threads of R rows and C columns a step (``rb_shape``'s 'debug' kind:
  by default the (T, R, C) score() runs), the same stripes, ticket order,
  query ring and chunked hand-off.
* ``stripe_capture``: the same on the stripe template's K1-K3, one row a
  thread (``sw_sanitize_stripe_linear``, ``_affine``, ``_sub``,
  ``csrc/sanitize_fill.cu``), the earlier design, on no route.
* ``packed_rb_capture``: B pairs of one shape, a (B, m) against b (B,
  n), on the packed form of the register-blocked stripe that
  ``pairs_packed_score`` (K7) runs (C entries
  ``sw_sanitize_packed_rb_linear``, ``_affine``, ``_sub``,
  ``csrc/stripe_rb_packed_debug.cu``), at K7's (T, R, C) (``rb_shape``'s
  'packed_debug' kind) and its geometry (``pairs_fill.packed_rb_geometry``),
  which the capture carries.
* ``packed_capture``: the same packed as the stripe template's K7 packs
  them (``sw_sanitize_packed_linear``, ``_affine``, ``_sub``), at the
  stripe height the template's K7 (``pairs_fill._launch_packed``) takes,
  the earlier design, on no route.

Each returns ``Capture``: ``h``, H of every slot after every step;
``seen``, (stripes, m + 1) int32, the progress of stripe s - 1 that stripe
s had seen when it read column j of the boundary row (-1 where it read
none); each pair's max score; and the tile, T threads of R rows and C
columns. The register-blocked ``h`` is (stripes, ceil(m / C) + T - 1, T,
R, C), the template's (stripes, m + T - 1, T), its R = C = 1 case: slot
(s, t, k, r, c) holds H of cell (s*T*R + k*R + r + 1, (t - k)*C + c + 1)
after step t (``slot_cells``), 0 for a slot whose cell lies outside the
matrix, and ``UNSCHEDULED`` for the last stripe's steps past its own
ceil(m / C) + kt - 1 (kt its threads holding rows). The register-blocked
kernel computes the cells of a thread's rows past n and discards them;
the capture stores 0 there, as for every slot outside the matrix: those
rows lie below row n, so no cell of the matrix reads them, and one rule,
"exactly 0", holds every slot outside it.

The packed register-blocked capture's slot (s, t, k, r, c) holds H of row
kk*R + r + 1 of its stripe's rows of pair g, column (t - kk)*C + c + 1
(``PackedGeometry.cells``: kk the thread's place among its pair's threads
in the stripe, where the skew restarts), 0 in a pad row, in a thread past
the stripe's last pair and outside columns 1..m, and ``UNSCHEDULED`` past
each stripe's own ceil(m / C) + kt - 1 steps.

Each wrapper launches its kernel for tensors on a CUDA device and runs its
plain version (``stripe_rb_capture_plain``, ``packed_rb_capture_plain``,
``stripe_capture_plain``, ``packed_capture_plain``) for tensors on the
CPU, and nowhere else; a failed build or launch raises. The plain versions
follow their kernel's stripe schedule: one ``scan_fill`` per stripe (per
segment of a pair inside a stripe in the packed modes), each starting from
the stripe above's last row, so that the test hook ``skew`` (read boundary
column j - skew: a broken hand-off) gives the same wrong cells on the card
and off it; the register-blocked ones gather each segment's H into the
tile layout through ``slot_cells`` or the geometry's ``cells``. A
sequential producer has always finished, so the plain ``seen`` is m
wherever a stripe reads the boundary.

``rb_launches`` and ``rb_plain_calls`` count the register-blocked
single-pair entries and their plain version, ``packed_rb_launches`` and
``packed_rb_plain_calls`` the register-blocked packed ones, ``launches``
and ``plain_calls`` the template's; ``pairs_fill.reset_counts()`` zeroes
them with every other kernel's counters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import Scoring
from . import pairs_fill as pf
from . import stripe_fill as sf
from .scan_fill import NEG, diag_to_rowmajor, scan_fill

# the largest capture the sanitizer takes, in int32 slots (1 GiB)
SANITIZE_MAX_SLOTS = 1 << 28
# what a slot the kernel never schedules keeps
UNSCHEDULED = -(1 << 31)

# the register-blocked K9 entries by mode
RB_DEBUG_KERNELS = {mode: f"sw_sanitize_rb_{mode}"
                    for mode in ("linear", "affine", "sub")}
# (packed, mode) -> the stripe template's K9 entry
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
# the register-blocked K9's own counters
rb_launches = dict.fromkeys(RB_DEBUG_KERNELS.values(), 0)
rb_plain_calls = {"stripe_rb_capture_plain": 0}
# the register-blocked packed K9 entries by mode, and their counters
PACKED_RB_DEBUG_KERNELS = {mode: f"sw_sanitize_packed_rb_{mode}"
                           for mode in ("linear", "affine", "sub")}
packed_rb_launches = dict.fromkeys(PACKED_RB_DEBUG_KERNELS.values(), 0)
packed_rb_plain_calls = {"packed_rb_capture_plain": 0}


class Capture(NamedTuple):
    """A K9 capture, tensors on the input's device."""
    h: torch.Tensor         # (stripes, steps, T, R, C) int32; the
                            # template's (stripes, m + T - 1, T)
    seen: torch.Tensor      # (stripes, m + 1) int32
    T: int                  # threads a stripe
    scores: torch.Tensor    # (B,) int32: each pair's max (B = 1: one pair)
    R: int = 1              # rows a thread
    C: int = 1              # columns a step
    # the packed register-blocked capture's map of slots to cells; None:
    # slot_cells' map, pairs (if several) back to back at n rows each
    geometry: Optional[pf.PackedGeometry] = None


def slot_cells(stripes: int, steps: int, T: int, R: int = 1, C: int = 1,
               device=None) -> tuple:
    """(i, j): the cell of every slot (s, t, k, r, c) of a capture of
    ``stripes`` stripes of T threads of R rows, C columns a step, as int64
    tensors broadcasting to (stripes, steps, T, R, C): i = s*T*R + k*R +
    r + 1, j = (t - k)*C + c + 1 (rows past n and columns outside 1..m
    included). The one map the checks, the plain capture and the tests
    read."""
    def axis(size, dim):
        shape = [1] * 5
        shape[dim] = size
        return torch.arange(size, device=device).view(shape)

    s, t, k, r, c = (axis(x, d) for d, x in enumerate((stripes, steps, T,
                                                        R, C)))
    return s * T * R + k * R + r + 1, (t - k) * C + c + 1


def same_capture(k: Capture, p: Capture, skewed: bool = False) -> int:
    """The max |h| difference of a kernel capture ``k`` and a plain capture
    ``p`` of the same inputs, after holding their T, shapes and scores
    equal and their ``seen`` to what it proves: the card's is a race
    observation (the plain producer has always finished), so both must
    read the boundary in the same stripes and, but under the test hook
    (``skewed``), each read must follow its column's release. Raises
    ValueError where they differ."""
    if (k.T, k.R, k.C, k.geometry) != (p.T, p.R, p.C, p.geometry) \
            or k.h.shape != p.h.shape:
        raise ValueError(f"(T, R, C) {(k.T, k.R, k.C)} != {(p.T, p.R, p.C)}"
                         f", geometry {k.geometry} != {p.geometry} or h "
                         f"{tuple(k.h.shape)} != {tuple(p.h.shape)}")
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
    """The stripe template's K9 entry of this scoring (packed: what
    ``packed_capture`` runs; else the earlier single-pair design)."""
    return DEBUG_KERNELS[packed, sf._mode(scoring, substitution)]


def rb_debug_kernel_name(scoring: Scoring, substitution) -> str:
    """The register-blocked K9 entry of this scoring, what
    ``stripe_rb_capture`` (and so ``sanitize()``) runs on a card."""
    return RB_DEBUG_KERNELS[sf._mode(scoring, substitution)]


def packed_rb_debug_kernel_name(scoring: Scoring, substitution) -> str:
    """The register-blocked packed K9 entry of this scoring, what
    ``packed_rb_capture`` (and so ``sanitize_pairs_packed``) runs on a
    card."""
    return PACKED_RB_DEBUG_KERNELS[sf._mode(scoring, substitution)]


def packed_rb_capture_geometry(b: torch.Tensor, scoring: Scoring,
                               substitution: Optional[torch.Tensor],
                               T: Optional[int] = None,
                               R: Optional[int] = None,
                               C: Optional[int] = None) -> tuple:
    """((T, R, C), geometry) of ``packed_rb_capture`` over b's (B, n)
    rows: ``rb_shape``'s 'packed_debug' kind, by default the (T, R, C)
    that ``pairs_packed_score`` runs, and ``packed_rb_geometry`` there (T
    the launch's)."""
    B, n = b.shape
    T, R, C = sf.rb_shape(n, T, R, C, sf._mode(scoring, substitution),
                          _alphabet(substitution), "packed_debug")
    geo = pf.packed_rb_geometry(B, n, T, R)
    return (geo.T, R, C), geo


def rb_capture_shape(b: torch.Tensor, scoring: Scoring,
                     substitution: Optional[torch.Tensor],
                     T: Optional[int] = None, R: Optional[int] = None,
                     C: Optional[int] = None) -> tuple:
    """The (T, R, C) of ``stripe_rb_capture`` over b's rows: ``rb_shape``'s
    'debug' kind, by default the (T, R, C) that ``stripe_score`` runs."""
    return sf.rb_shape(b.numel(), T, R, C, sf._mode(scoring, substitution),
                       _alphabet(substitution), "debug")


def stripe_rb_capture(a: torch.Tensor, b: torch.Tensor,
                      scoring: Scoring = Scoring(), T: Optional[int] = None,
                      R: Optional[int] = None, C: Optional[int] = None,
                      substitution: Optional[torch.Tensor] = None,
                      skew: int = 0) -> Capture:
    """K9 on one pair on the register-blocked stripe: ``stripe_score``'s
    fill with the capture, at ``rb_capture_shape``'s (T, R, C) on both
    devices; ``skew``: the hand-off test hook, 0 in a sanitizer run."""
    if sf._route(a, b, scoring, substitution) == "cpu":
        return stripe_rb_capture_plain(a, b, scoring, T, R, C, substitution,
                                       skew)
    T, R, C = rb_capture_shape(b, scoring, substitution, T, R, C)
    return _launch_rb(a, b, scoring, substitution, skew, T, R, C)


def stripe_rb_capture_plain(a: torch.Tensor, b: torch.Tensor,
                            scoring: Scoring = Scoring(),
                            T: Optional[int] = None, R: Optional[int] = None,
                            C: Optional[int] = None,
                            substitution: Optional[torch.Tensor] = None,
                            skew: int = 0) -> Capture:
    """Plain PyTorch version of the register-blocked K9 entries, on any
    device: one ``scan_fill`` per stripe of T*R rows, each from the stripe
    above's last row (shifted under ``skew``), its H gathered into the
    tile layout through ``slot_cells``."""
    rb_plain_calls["stripe_rb_capture_plain"] += 1
    T, R, C = rb_capture_shape(b, scoring, substitution, T, R, C)
    m, n = a.numel(), b.numel()
    dev = a.device
    h, seen = _buffers(n, m, T, skew, dev, R, C)
    stripes, steps = h.shape[:2]
    rows, tiles = T * R, -(-m // C)
    i, j = slot_cells(1, steps, T, R, C, dev)       # i: the stripe's row
    t = torch.arange(steps, device=dev).view(1, -1, 1, 1, 1)
    table = sf._table(substitution)
    best = torch.zeros((), dtype=torch.int32, device=dev)
    bottom = bottom_f = None            # the stripe above's last row
    for s in range(stripes):
        lo, hi = s * rows, min(n, s * rows + rows)
        kw = {}
        if s:
            kw["top_row"] = _shift(bottom, skew, 0)
            if scoring.is_affine:
                kw["top_f"] = _shift(bottom_f, skew, NEG)
            seen[s, 1:] = m
        out = scan_fill(a, b[lo:hi], scoring=scoring, return_h=True,
                        sub_table=table, **kw)
        H = diag_to_rowmajor(out.h_diag, hi - lo, m)
        inside = (j >= 1) & (j <= m) & (i <= hi - lo)
        cells = torch.where(inside, H[i.clamp(max=hi - lo), j.clamp(0, m)],
                            0)
        kt = -(-(hi - lo) // R)
        h[s] = torch.where(t < tiles + kt - 1, cells, UNSCHEDULED)[0]
        best = torch.maximum(best, out.max_score)
        bottom, bottom_f = out.bottom_row, out.bottom_f
    return Capture(h, seen, T, best.view(1), R, C)


def packed_rb_capture(a: torch.Tensor, b: torch.Tensor,
                      scoring: Scoring = Scoring(), T: Optional[int] = None,
                      R: Optional[int] = None, C: Optional[int] = None,
                      substitution: Optional[torch.Tensor] = None,
                      skew: int = 0) -> Capture:
    """The packed K9: B pairs, a (B, m) against b (B, n), on the packed
    form of the register-blocked stripe, ``pairs_packed_score``'s fill
    with the capture, at ``packed_rb_capture_geometry``'s (T, R, C) and
    geometry on both devices; ``skew``: the hand-off test hook, 0 in a
    sanitizer run."""
    if sf._route(a, b, scoring, substitution, batched=True) == "cpu":
        return packed_rb_capture_plain(a, b, scoring, T, R, C, substitution,
                                       skew)
    (T, R, C), geo = packed_rb_capture_geometry(b, scoring, substitution, T,
                                                R, C)
    h, seen = _buffers(b.shape[1], a.shape[1], T, skew, a.device, R, C,
                       geo.stripes)
    args, row_best = pf.packed_args(a, b, scoring, substitution, geo, C)
    name = packed_rb_debug_kernel_name(scoring, substitution)
    sf._call(name, a.device, args + [h.data_ptr(), seen.data_ptr(), skew],
             name, packed_rb_launches)
    return Capture(h, seen, T, pf._reduce_rows(row_best).scores, R, C, geo)


def packed_rb_capture_plain(a: torch.Tensor, b: torch.Tensor,
                            scoring: Scoring = Scoring(),
                            T: Optional[int] = None, R: Optional[int] = None,
                            C: Optional[int] = None,
                            substitution: Optional[torch.Tensor] = None,
                            skew: int = 0) -> Capture:
    """Plain PyTorch version of the packed register-blocked K9 entries, on
    any device: one ``scan_fill`` per segment of a pair inside a stripe,
    a segment that continues its pair from the stripe above's last row
    (shifted under ``skew``), its H gathered into the tile layout through
    the geometry's ``cells``."""
    packed_rb_plain_calls["packed_rb_capture_plain"] += 1
    (T, R, C), geo = packed_rb_capture_geometry(b, scoring, substitution, T,
                                                R, C)
    (B, m), n = a.shape, b.shape[1]
    dev = a.device
    h, seen = _buffers(n, m, T, skew, dev, R, C, geo.stripes)
    steps, tpp = h.shape[1], geo.tpp
    _, i_all, j_all = geo.cells(steps, C, dev)
    sched = (torch.arange(steps, device=dev)[None, :] <
             geo.stripe_steps(m, C).to(dev)[:, None])
    table = sf._table(substitution)
    scores = torch.zeros(B, dtype=torch.int32, device=dev)
    bottom = {}                         # pair -> its stripe above's last row
    for s in range(geo.stripes):
        ss = s % geo.spp
        # every slot the stripe runs: 0 unless a segment's cell lies there
        h[s] = torch.where(sched[s].view(-1, 1, 1, 1), 0, UNSCHEDULED)
        for p in range(geo.per):
            g = s // geo.spp if geo.spp > 1 else s * geo.per + p
            if g >= B:
                break
            lo = ss * geo.T * R
            hi = min(n, lo + tpp * R)
            kw = {}
            if ss:
                top, top_f = bottom[g]
                kw["top_row"] = _shift(top, skew, 0)
                if scoring.is_affine:
                    kw["top_f"] = _shift(top_f, skew, NEG)
                seen[s, 1:] = m
            out = scan_fill(a[g], b[g, lo:hi], scoring=scoring,
                            return_h=True, sub_table=table, **kw)
            H = diag_to_rowmajor(out.h_diag, hi - lo, m)
            ks = slice(p * tpp, (p + 1) * tpp)
            i = i_all[s, :, ks] - lo                 # the segment's row
            j = j_all[s, :, ks].expand(steps, -1, R, C)
            inside = (j >= 1) & (j <= m) & (i <= hi - lo)
            cells = torch.where(inside, H[i.clamp(max=hi - lo),
                                          j.clamp(0, m)], 0)
            h[s, :, ks] = torch.where(sched[s].view(-1, 1, 1, 1), cells,
                                      UNSCHEDULED)
            scores[g] = torch.maximum(scores[g], out.max_score)
            bottom[g] = out.bottom_row, out.bottom_f
    return Capture(h, seen, T, scores, R, C, geo)


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


def _buffers(n: int, m: int, T: int, skew: int, dev: torch.device,
             R: int = 1, C: int = 1, stripes: Optional[int] = None) -> tuple:
    """(h, seen) of a capture of n rows by m columns at T threads of R rows
    and C columns a step (``stripes`` of them, by default ceil(n / (T *
    R))): h all UNSCHEDULED, (stripes, ceil(m / C) + T - 1, T, R, C); seen
    all -1. Raises ValueError above SANITIZE_MAX_SLOTS (which keeps n far
    below int32's range) or for a negative skew."""
    if skew < 0:
        raise ValueError(f"skew must be >= 0, got {skew}")
    if stripes is None:
        stripes = -(-n // (T * R))
    shape = (stripes, -(-m // C) + T - 1, T, R, C)
    slots = stripes * shape[1] * T * R * C
    if slots > SANITIZE_MAX_SLOTS:
        raise ValueError(
            f"a capture of {' x '.join(map(str, shape))} slots exceeds "
            f"{SANITIZE_MAX_SLOTS}: the sanitizer is sized for debug "
            "shapes")
    i32 = torch.int32
    return (torch.full(shape, UNSCHEDULED, dtype=i32, device=dev),
            torch.full((stripes, m + 1), -1, dtype=i32, device=dev))


def _launch_rb(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
               sub: Optional[torch.Tensor], skew: int, T: int, R: int,
               C: int) -> Capture:
    """Launch the register-blocked K9 on one pair at (T, R, C): the
    arguments of ``stripe_fill._launch_rb``'s entry, then h, seen, skew."""
    m, n = a.numel(), b.numel()
    h, seen = _buffers(n, m, T, skew, a.device, R, C)
    a, b, sub, sync, bnd, bnd_f, best = sf._rb_scratch(a, b, scoring, sub, T,
                                                       R)
    mode = sf._mode(scoring, sub)
    bnds = [bnd.data_ptr()] + ([sf._ptr(bnd_f)] if mode != "linear" else [])
    right = torch.zeros(n + 1, dtype=torch.int32, device=a.device)
    args = [a.data_ptr(), b.data_ptr(), m, n, *sf._model(scoring, sub), T, R,
            C, sync.data_ptr(), *bnds, best.data_ptr(), right.data_ptr(),
            h.data_ptr(), seen.data_ptr(), skew]
    name = RB_DEBUG_KERNELS[mode]
    sf._call(name, a.device, args, name, rb_launches)
    return Capture(h, seen, T, sf._reduce(best, right, n)[:1], R, C)


def _launch(a: torch.Tensor, b: torch.Tensor, rows: int, scoring: Scoring,
            sub: Optional[torch.Tensor], skew: int, T: int) -> Capture:
    """Launch K9 on a (B, m) against b: one pair's (n,) codes (rows = n)
    or B pairs' (B, rows), packed."""
    packed = b.dim() == 2
    (B, m), n = a.shape, b.numel()
    dev = a.device
    h, seen = _buffers(n, m, T, skew, dev)
    h = h.flatten(2)                    # the template's (stripes, steps, T)
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
    h = h.flatten(2)
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
