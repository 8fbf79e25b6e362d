"""Anti-diagonal sweep in PyTorch: the portable ``scan`` plan.

Port of ``swtpu.kernels.scan_fill`` (a ``lax.scan`` over anti-diagonals) to
a Python loop of tensor ops on any torch device. It is the correctness
backstop of the port and the plain version of every CUDA stripe kernel
(``kernels/stripe_fill.py``).

Layout: **row-stationary**. Lane ``k`` (0..n-1) always holds row
``i = k+1`` of the padded matrix; at step ``t`` it holds cell
``(k+1, t-k+1)``. Then:

* LEFT  neighbour ``(i, j-1)``   = same lane, previous step;
* UP    neighbour ``(i-1, j)``   = lane k-1, previous step;
* DIAG  neighbour ``(i-1, j-1)`` = lane k-1, two steps back, which is the
  UP value lane k saw one step earlier.

Each step computes only the lanes inside the matrix, the contiguous range
``max(0, t-m+1) .. min(n-1, t)``, so no validity mask is needed; a lane
keeps H(i, m) after it leaves the matrix, a value no later cell reads.

The global max follows the reference's first-occurrence-in-row-major rule:
each lane keeps its row's best under a strict ``>`` while j ascends, and
the final reduce takes the smallest row among the lanes holding the max.
The sweep runs on the device without a host sync; the caller fetches.

Affine (Gotoh) mode carries E per lane (the LEFT chain: the same lane,
previous step) and F from lane k-1 (the UP chain), starting both at NEG so
that E(i, 1) and F(1, j) open a gap; P then carries the ``E_EXT``/``F_EXT``
state bits (a tie counts as extension). ``sub_table`` mode reads the
per-cell score from an (A+3, A+3) table indexed by ``code + 3``
(``core.substitution.embed_sentinels``) in place of the match/mismatch
compare.

Boundary injection (``top_row``/``left_col``, affine ``top_f``/``left_e``)
replaces the zero row 0 and column 0: lane 0 reads H(0, j) and F(0, j)
from the top row as its UP inflow, and a lane carries ``left_col[i]``
(and ``left_e[i]``) until it enters the matrix, so its first LEFT and DIAG
reads see the injected column. ``local=False`` is the global
(Needleman-Wunsch) recurrence: no zero floor, DIAG the default code; the
max still counts positive cells only (the anchored-reverse contract).
``band`` keeps the cells with ``|i - j| <= band`` (``|2k - t| <= band``);
a cell outside carries its lane's boundary H, P ``NONE``, E ``e_init`` and
F ``NEG``, as the JAX scan does. A banded step computes only the lanes of
the band plus one on each side (the lane leaving it, which must be reset,
and the lane entering it, whose DIAG carry must be current), so a narrow
band costs a narrow step.

``batch_scan_fill`` is the same local sweep over B same-shape pairs at
once, the batch dimension written out where the JAX package vmaps its
scan (``swtpu.dist.batch``): every pair shares m and n, so every step
computes the same lane range for all of them. It is the plain version of
the batch kernels (``kernels/pairs_fill.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import DIAGONAL, E_EXT, F_EXT, LEFT, NONE, UP, Scoring
from ..core.substitution import NEG_SUB

# affine "minus infinity": E before column 1 and F above row 1; adding a
# gap penalty to it cannot wrap int32
NEG = -(1 << 30)


def check_codes(a: torch.Tensor, b: torch.Tensor, A: int) -> None:
    """Substitution mode takes codes in [-3, A): 0..A-1 index the table
    and -3..-1 are the sentinels. Raise ValueError for any other code."""
    lo_a, hi_a, lo_b, hi_b = torch.stack(
        [a.min(), a.max(), b.min(), b.max()]).tolist()   # one fetch
    if min(lo_a, lo_b) < -3 or max(hi_a, hi_b) >= A:
        raise ValueError(
            f"substitution codes must lie in [-3, {A}): a spans "
            f"[{lo_a}, {hi_a}], b spans [{lo_b}, {hi_b}]")


def embed_table(sub: torch.Tensor) -> torch.Tensor:
    """(A, A) table -> the (A+3, A+3) table ``scan_fill`` reads, indexed by
    code+3, on the same device; sentinel rows and columns hold NEG_SUB
    (the torch twin of ``core.substitution.embed_sentinels``)."""
    A = sub.shape[0]
    out = torch.full((A + 3, A + 3), NEG_SUB, dtype=torch.int32,
                     device=sub.device)
    out[3:, 3:] = sub
    return out


class FillOut(NamedTuple):
    """Fill results as tensors on the input's device (diagonal-major where
    2D)."""
    max_score: torch.Tensor     # () int32
    max_i: torch.Tensor         # () int32: padded row index of first max
    max_j: torch.Tensor         # () int32: padded col index of first max
    last_cell: torch.Tensor     # () int32: H[n, m]
    bottom_row: torch.Tensor    # (m+1,) int32: H[n, :]
    right_col: torch.Tensor     # (n+1,) int32: H[:, m]
    p_diag: Optional[torch.Tensor]    # (n+m-1, n) int8 or None
    h_diag: Optional[torch.Tensor]    # (n+m-1, n) int32 or None
    bottom_f: Optional[torch.Tensor] = None   # (m+1,) F[n, :] (affine)
    right_e: Optional[torch.Tensor] = None    # (n+1,) E[:, m] (affine)


def _boundary(x: Optional[torch.Tensor], size: int, fill: int,
              dev: torch.device, name: str) -> torch.Tensor:
    """An injected boundary vector as int32 on ``dev``, or ``fill``."""
    if x is None:
        return torch.full((size,), fill, dtype=torch.int32, device=dev)
    if x.shape != (size,):
        raise ValueError(f"{name} must have shape ({size},), got "
                         f"{tuple(x.shape)}")
    return x.to(device=dev, dtype=torch.int32)


def scan_fill(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    scoring: Scoring = Scoring(),
    return_p: bool = False,
    return_h: bool = False,
    band: Optional[int] = None,
    top_row: Optional[torch.Tensor] = None,
    left_col: Optional[torch.Tensor] = None,
    top_f: Optional[torch.Tensor] = None,
    left_e: Optional[torch.Tensor] = None,
    local: bool = True,
    sub_table: Optional[torch.Tensor] = None,
) -> FillOut:
    """Fill the (n+1)x(m+1) DP matrix for one pair. a: (m,) codes, b: (n,)
    codes, both integer tensors on one device; m, n >= 1. ``sub_table``:
    (A+3, A+3) int32 embedded substitution table on the same device.
    ``top_row`` (m+1,) / ``left_col`` (n+1,): H of row 0 / column 0, both
    holding the corner H[0, 0]; ``top_f`` (m+1,) / ``left_e`` (n+1,): F of
    row 0 / E of column 0 (affine only, NEG when None)."""
    m, n = a.numel(), b.numel()
    if m < 1 or n < 1:
        raise ValueError(f"scan_fill needs non-empty sequences, got m={m}, n={n}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    dev = a.device
    i32 = torch.int32
    steps = n + m - 1
    gap, match, mismatch = scoring.gap, scoring.match, scoring.mismatch
    affine = scoring.is_affine
    g_open, g_ext = scoring.gap_open, scoring.gap_extend

    ar = a.to(i32).flip(0)            # ar[m-1-t+k] == a[t-k], ascending in k
    b32 = b.to(i32)
    if sub_table is not None:
        A3 = sub_table.shape[0]
        check_codes(a, b, A3 - 3)
        flat_sub = sub_table.to(i32).reshape(-1)
        ar = (ar + 3) * A3            # row offsets into the flat table
        b32 = b32 + 3
    top = _boundary(top_row, m + 1, 0, dev, "top_row")
    left = _boundary(left_col, n + 1, 0, dev, "left_col")
    h_init = left[1:]                 # a lane's H before it enters
    # hx[k+1] = lane k's H after the last step; hx[0] is lane 0's UP inflow,
    # H(0, t+1) of the top row
    hx = torch.cat([top[1:2], h_init])
    # next step's DIAG; a lane enters with H(i-1, 0), lane 0 with the corner
    up_prev = torch.cat([top[:1], left[1:n]])
    if affine:
        ftop = _boundary(top_f, m + 1, NEG, dev, "top_f")
        e_init = _boundary(left_e, n + 1, NEG, dev, "left_e")[1:]
        ex = e_init.clone()                                    # E(i, j-1)
        fx = torch.cat([ftop[1:2],                             # like hx, F
                        torch.full((n,), NEG, dtype=i32, device=dev)])
        right_e = torch.cat([torch.full((1,), NEG, dtype=i32, device=dev),
                             e_init])
        bottom_f = torch.full((m + 1,), NEG, dtype=i32, device=dev)
    lane_best = torch.zeros(n, dtype=i32, device=dev)
    lane_t = torch.zeros(n, dtype=i32, device=dev)    # step of lane_best
    # a lane not computed at its edge step (outside the band) holds h_init
    right_col = torch.cat([top[m:], h_init])
    bottom_row = left[n:].repeat(m + 1)
    p_diag = (torch.zeros((steps, n), dtype=torch.int8, device=dev)
              if return_p else None)
    h_diag = (torch.zeros((steps, n), dtype=i32, device=dev)
              if return_h else None)
    lanes = torch.arange(n, dtype=i32, device=dev)

    for t in range(steps):
        mlo = max(0, t - m + 1)       # lanes [mlo, hi) lie in the matrix
        lo, hi = mlo, min(n - 1, t) + 1
        if band is not None:
            # the band's lanes ceil((t-band)/2) .. floor((t+band)/2), one
            # more on each side
            lo = max(lo, (t - band + 1) // 2 - 1)
            hi = min(hi, (t + band) // 2 + 2)
            if lo >= hi:
                continue
        if lo == 0 and top_row is not None:
            hx[0] = top[t + 1]
        if lo == 0 and affine and top_f is not None:
            fx[0] = ftop[t + 1]
        w = ar[m - 1 - t + lo:m - 1 - t + hi]
        if sub_table is not None:
            sub = flat_sub[w + b32[lo:hi]]
        else:
            sub = torch.where(w == b32[lo:hi], match, mismatch)
        up = hx[lo:hi]
        diag = up_prev[lo:hi] + sub
        if affine:
            e_prev, f_prev = ex[lo:hi], fx[lo:hi]
            left_g = torch.maximum(hx[lo + 1:hi + 1] + g_open, e_prev + g_ext)
            up_g = torch.maximum(up + g_open, f_prev + g_ext)
            e_ext = left_g == e_prev + g_ext
            f_ext = up_g == f_prev + g_ext
        else:
            left_g = hx[lo + 1:hi + 1] + gap
            up_g = up + gap
        up_prev[lo:hi] = up
        # tie order DIAG > UP > LEFT (> staying at 0/NONE), strict '>'
        h = diag.clamp(min=0) if local else diag
        take_up = up_g > h
        h = torch.where(take_up, up_g, h)
        take_left = left_g > h
        h = torch.where(take_left, left_g, h)
        if return_p:
            p = (torch.where(diag > 0, DIAGONAL, NONE) if local
                 else torch.full_like(diag, DIAGONAL)).to(torch.int8)
            p.masked_fill_(take_up, UP)
            p.masked_fill_(take_left, LEFT)
            if affine:
                p += (e_ext * E_EXT + f_ext * F_EXT).to(torch.int8)
        inb = None
        if band is not None:
            inb = (2 * lanes[lo:hi] - t).abs() <= band
            h = torch.where(inb, h, h_init[lo:hi])
            if return_p:
                p.masked_fill_(~inb, NONE)
            if affine:
                left_g = torch.where(inb, left_g, e_init[lo:hi])
                up_g = torch.where(inb, up_g, NEG)
        if affine:
            ex[lo:hi] = left_g
            fx[lo + 1:hi + 1] = up_g
        if return_p:
            p_diag[t, lo:hi] = p
        if return_h:
            h_diag[t, lo:hi] = h if inb is None else torch.where(inb, h, 0)
        hx[lo + 1:hi + 1] = h
        better = h > lane_best[lo:hi]
        if inb is not None:
            better &= inb
        lane_best[lo:hi] = torch.where(better, h, lane_best[lo:hi])
        lane_t[lo:hi].masked_fill_(better, t)
        if t >= m - 1 and lo == mlo:      # lane mlo sits on column m
            right_col[lo + 1] = h[0]
            if affine:
                right_e[lo + 1] = left_g[0]
        if hi == n:                       # lane n-1 sits on row n
            bottom_row[t - n + 2] = h[-1]
            if affine:
                bottom_f[t - n + 2] = up_g[-1]

    kk = torch.arange(n, dtype=i32, device=dev)
    best = lane_best.max()
    k = torch.where(lane_best == best, kk, n).min()
    has = best > 0
    max_i = torch.where(has, k + 1, 0).to(i32)
    max_j = torch.where(has, lane_t[k] - k + 1, 0).to(i32)
    return FillOut(
        max_score=best, max_i=max_i, max_j=max_j, last_cell=right_col[n],
        bottom_row=bottom_row, right_col=right_col,
        p_diag=p_diag, h_diag=h_diag,
        bottom_f=bottom_f if affine else None,
        right_e=right_e if affine else None,
    )


def batch_scan_fill(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    scoring: Scoring = Scoring(),
    band: Optional[int] = None,
    sub_table: Optional[torch.Tensor] = None,
) -> tuple:
    """Local fill of B pairs at once: a (B, m) against b (B, n) codes, both
    on one device, m, n >= 1. Returns (scores, max_i, max_j), each (B,)
    int32 on that device: every pair's max and its first row-major end
    cell, (0, 0, 0) for a pair with no positive cell. ``band`` and
    ``sub_table`` as in ``scan_fill``."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a (B, m) and b (B, n) must share B, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (B, m), n = a.shape, b.shape[1]
    if m < 1 or n < 1:
        raise ValueError(f"batch_scan_fill needs non-empty sequences, got "
                         f"m={m}, n={n}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    dev = a.device
    i32 = torch.int32
    affine = scoring.is_affine
    gap, g_open, g_ext = scoring.gap, scoring.gap_open, scoring.gap_extend

    ar = a.to(i32).flip(1)            # ar[:, m-1-t+k] == a[:, t-k]
    b32 = b.to(i32)
    if sub_table is not None:
        A3 = sub_table.shape[0]
        check_codes(a, b, A3 - 3)
        flat_sub = sub_table.to(i32).reshape(-1)
        ar = (ar + 3) * A3
        b32 = b32 + 3
    # hx[:, k+1] = lane k's H after the last step; hx[:, 0] = 0 is row 0
    hx = torch.zeros((B, n + 1), dtype=i32, device=dev)
    up_prev = torch.zeros((B, n), dtype=i32, device=dev)       # next DIAG
    if affine:
        ex = torch.full((B, n), NEG, dtype=i32, device=dev)    # E(i, j-1)
        fx = torch.full((B, n + 1), NEG, dtype=i32, device=dev)
    lane_best = torch.zeros((B, n), dtype=i32, device=dev)
    lane_t = torch.zeros((B, n), dtype=i32, device=dev)
    lanes = torch.arange(n, dtype=i32, device=dev)

    for t in range(n + m - 1):
        lo, hi = max(0, t - m + 1), min(n - 1, t) + 1
        if band is not None:
            lo = max(lo, (t - band + 1) // 2 - 1)
            hi = min(hi, (t + band) // 2 + 2)
            if lo >= hi:
                continue
        w = ar[:, m - 1 - t + lo:m - 1 - t + hi]
        if sub_table is not None:
            sub = flat_sub[w + b32[:, lo:hi]]
        else:
            sub = torch.where(w == b32[:, lo:hi], scoring.match,
                              scoring.mismatch)
        up = hx[:, lo:hi]
        diag = up_prev[:, lo:hi] + sub
        if affine:
            left_g = torch.maximum(hx[:, lo + 1:hi + 1] + g_open,
                                   ex[:, lo:hi] + g_ext)
            up_g = torch.maximum(up + g_open, fx[:, lo:hi] + g_ext)
        else:
            left_g = hx[:, lo + 1:hi + 1] + gap
            up_g = up + gap
        up_prev[:, lo:hi] = up
        h = torch.maximum(torch.maximum(diag.clamp(min=0), up_g), left_g)
        inb = None
        if band is not None:
            inb = (2 * lanes[lo:hi] - t).abs() <= band
            h = torch.where(inb, h, 0)
            if affine:
                left_g = torch.where(inb, left_g, NEG)
                up_g = torch.where(inb, up_g, NEG)
        if affine:
            ex[:, lo:hi] = left_g
            fx[:, lo + 1:hi + 1] = up_g
        hx[:, lo + 1:hi + 1] = h
        better = h > lane_best[:, lo:hi]
        if inb is not None:
            better &= inb
        lane_best[:, lo:hi] = torch.where(better, h, lane_best[:, lo:hi])
        lane_t[:, lo:hi].masked_fill_(better, t)

    best = lane_best.max(dim=1).values
    kk = torch.arange(n, dtype=i32, device=dev)
    k = torch.where(lane_best == best[:, None], kk, n).min(dim=1).values
    has = best > 0
    t_at = lane_t.gather(1, k[:, None].long()).squeeze(1)
    max_i = torch.where(has, k + 1, 0).to(i32)
    max_j = torch.where(has, t_at - k + 1, 0).to(i32)
    return best, max_i, max_j


def diag_to_rowmajor(diag: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Diagonal-major (n+m-1, n) -> padded row-major (n+1, m+1) on the same
    device. Cell (i, j) lives at [i+j-2, i-1], flat offset
    (i-1)*(n+1) + (j-1)*n: a strided view, copied once."""
    d = diag.contiguous()
    out = torch.zeros((n + 1, m + 1), dtype=d.dtype, device=d.device)
    out[1:, 1:] = d.as_strided((n, m), (n + 1, n), d.storage_offset())
    return out
