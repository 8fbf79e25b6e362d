"""The benchmark's plain reference: Smith-Waterman fills in plain PyTorch,
on any device, written from the upstream's serial semantics and
independent of the program under test (it imports nothing of it).

Semantics, which the program promises to keep (chunhualiao/Smith-Waterman
``serial_smithW.c``; Gotoh for affine gaps):

* ``a`` lies along the columns (length m), ``b`` along the rows (length
  n); the matrix has a row 0 and a column 0 of zeros, so a cell (i, j) is
  1-based in b and in a.
* Linear gaps: H(i, j) = max(0, H(i-1, j-1) + s, H(i-1, j) + gap,
  H(i, j-1) + gap).
* Affine gaps: a gap of k letters costs gap_open + (k - 1) * gap_extend;
  E runs along a row, F down a column, H = max(0, diag, F, E).
* s is ``match`` where two codes are equal and ``mismatch`` where not, or
  a table's S[a code, b code]. Padding codes are negative and equal no
  letter.
* Tie order: of the cells that hold the max score, the first in row-major
  order, the lowest row i and then the lowest column j (the upstream's
  strict ``>`` running update, serial_smithW.c:240). The last cell is
  H(n, m).

``sweep`` fills row by row. A row's in-row gap recursion is a prefix max:
H(i, j) = max over k <= j of t(k) + gap * (j - k), where t holds the
row's other candidates, so it is ``torch.cummax`` of t shifted by the
penalty of each column's distance; for affine gaps the same scan, one
column behind, gives E. Many matrices share one sweep as segments of the
columns, each with its own column 0; a segment never reads another.

``cap`` makes the control: every candidate is clamped to at most ``cap``,
as a saturating integer type of that width clamps it (32767 for int16,
127 for int8), i.e. the reference in a narrower precision than the
configuration states.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

NEG = -(1 << 30)
# the prefix max scans blocks of this many columns, then carries each
# block's last value on: a scan along a long row runs in step with its
# length, one over many short blocks all at once
_BLOCK = 512
# saturating widths of the control
CAPS = {"int16": (1 << 15) - 1, "int8": (1 << 7) - 1}
# the control's width: the one below a configuration's precision
BELOW = {"int32": "int16", "int16": "int8"}


@dataclasses.dataclass(frozen=True)
class Scoring:
    """Match/mismatch or table scores and linear or affine gaps."""
    mode: str = "linear"          # 'linear' | 'affine'
    match: int = 3
    mismatch: int = -3
    gap: int = -2                 # linear: every gap letter
    gap_open: int = -12           # affine: the first gap letter
    gap_extend: int = -1          # affine: each further gap letter

    @classmethod
    def of(cls, d: dict) -> "Scoring":
        return cls(**d)

    @property
    def affine(self) -> bool:
        return self.mode == "affine"


def sweep(rows: torch.Tensor, cols: torch.Tensor, starts: torch.Tensor,
          scoring: Scoring, table: Optional[torch.Tensor] = None,
          cap: Optional[int] = None,
          row_len: Optional[torch.Tensor] = None) -> tuple:
    """Fill B matrices at once, one row a step.

    rows: (B, n) int64 codes, one row of each matrix a step; cols: (B, L)
    or (1, L) int64 codes along a row, cut into segments that begin where
    ``starts`` (L,) is true, each segment a matrix of its own; table: an
    (A, A) int32 S[row code, col code] (codes then in [0, A)), or None;
    row_len: (B,) rows that count in each batch row (later rows are
    computed but never recorded), or None for all n.

    Returns (best, first, last), each (B, L) int32: every column's highest
    H, the first row (1-based) that reached it, and the last row's H."""
    dev = cols.device
    B, n = rows.shape
    L = cols.shape[1]
    seg = torch.cumsum(starts.long(), 0) - 1
    col = torch.arange(L, device=dev)
    local = col - torch.nonzero(starts).flatten()[seg]
    pen = -(scoring.gap_extend if scoring.affine else scoring.gap)
    # each segment's offset lies above any t (at most the best score a
    # letter times the rows, or the cap) plus any distance penalty, so a
    # segment's scan never reads an earlier one; int32 where it fits
    best_s = scoring.match if table is None else int(table.max())
    top = (cap if cap is not None else max(1, best_s) * n) \
        + pen * int(local.max()) + 1
    step = 1 << top.bit_length()
    wide = (int(seg[-1]) + 2) * step >= (1 << 31)
    dt = torch.int64 if wide else torch.int32
    off = (pen * local + seg * step).to(dt)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    neg = torch.full((), NEG, dtype=torch.int32, device=dev)
    H = torch.zeros((B, L), dtype=torch.int32, device=dev)
    F = torch.full((B, L), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros((B, L), dtype=torch.int32, device=dev)
    first = torch.zeros((B, L), dtype=torch.int32, device=dev)
    trows = None if table is None else table.to(dev, torch.int32)
    for r in range(n):
        code = rows[:, r:r + 1]
        if trows is None:
            s = torch.where(cols == code, scoring.match, scoring.mismatch)
        else:
            s = trows[code.flatten()].gather(1, cols.expand(B, L))
        diag = torch.where(starts, zero, torch.roll(H, 1, 1)) + s
        if scoring.affine:
            F = torch.maximum(H + scoring.gap_open, F + scoring.gap_extend)
            t = torch.maximum(diag, F)
        else:
            t = torch.maximum(diag, H + scoring.gap)
        t = t.clamp(min=0) if cap is None else t.clamp(0, cap)
        cm = prefix_max(t.to(dt) + off) - off
        if scoring.affine:
            E = torch.where(starts, neg,
                            torch.roll(cm, 1, 1).int() + scoring.gap_open)
            H = torch.maximum(t, E)
        else:
            H = cm.int()
        better = H > best
        if row_len is not None:
            better &= (row_len > r)[:, None]
        best = torch.where(better, H, best)
        first = torch.where(better, r + 1, first)
    return best, first, H


def prefix_max(v: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(v, 1).values``, by blocks of ``_BLOCK`` columns:
    each block's own prefix max, then the max of every earlier block's
    last value carried in."""
    B, L = v.shape
    pad = (-L) % _BLOCK
    low = torch.iinfo(v.dtype).min
    if pad:
        v = torch.nn.functional.pad(v, (0, pad), value=low)
    inner = torch.cummax(v.view(B, -1, _BLOCK), 2).values
    carry = torch.cummax(inner[:, :, -1], 1).values
    carry = torch.cat([torch.full_like(carry[:, :1], low), carry[:, :-1]], 1)
    return torch.maximum(inner, carry[:, :, None]).view(B, -1)[:, :L]


def segment_first_max(best: torch.Tensor, first: torch.Tensor,
                      starts: torch.Tensor, scanned: str) -> tuple:
    """Each segment's (score, i, j): its max and the first cell in
    row-major order that holds it, from ``sweep``'s per-column best and
    first row. ``scanned`` says which of the matrix's axes the sweep
    stepped along: 'rows' (the sweep's rows are the matrix rows i, the
    columns j) or 'cols' (the sweep's rows are the columns j, its columns
    the rows i). Returns three (B, S) int64 tensors."""
    B, L = best.shape
    dev = best.device
    seg = (torch.cumsum(starts.long(), 0) - 1).expand(B, L)
    S = int(seg[0, -1]) + 1
    local = (torch.arange(L, device=dev)
             - torch.nonzero(starts).flatten()[seg[0]]) + 1
    b64 = best.long()
    score = torch.zeros((B, S), dtype=torch.int64, device=dev)
    score = score.scatter_reduce(1, seg, b64, "amax", include_self=True)
    f64 = first.long()
    wide = int(max(L, first.max().item())) + 1
    key = f64 * wide + local if scanned == "rows" else local * wide + f64
    key = torch.where(b64 == score.gather(1, seg), key,
                      torch.full_like(key, 1 << 62))
    low = torch.full((B, S), 1 << 62, dtype=torch.int64, device=dev)
    low = low.scatter_reduce(1, seg, key, "amin", include_self=True)
    i, j = low // wide, low % wide
    # a segment whose max is 0 ends at the origin, as the upstream's
    # maxPos starts at 0 and only a strict > moves it
    none = score <= 0
    return (score, torch.where(none, 0, i), torch.where(none, 0, j))


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), device=device).long()


def pairs(a: np.ndarray, b: np.ndarray, scoring: Scoring,
          table: Optional[np.ndarray] = None, cap: Optional[int] = None,
          device="cpu") -> np.ndarray:
    """B pairs of one shape, a (B, m) against b (B, n): a (B, 4) int64
    array of (score, i, j, last cell H(n, m))."""
    a_t, b_t = _long(a, device), _long(b, device)
    L = a_t.shape[1]
    starts = torch.zeros(L, dtype=torch.bool, device=device)
    starts[0] = True
    tab = None if table is None else _long(np.asarray(table).T, device)
    best, first, last = sweep(b_t, a_t, starts, scoring, tab, cap)
    score, i, j = segment_first_max(best, first, starts, "rows")
    out = torch.stack([score[:, 0], i[:, 0], j[:, 0], last[:, -1].long()], 1)
    return out.cpu().numpy()


def database(queries: list, entries: list, scoring: Scoring,
             table: Optional[np.ndarray] = None, cap: Optional[int] = None,
             device="cpu", group: int = 4) -> list:
    """Each query (a, the columns) against every entry (b, the rows): for
    each query an (N, 3) int64 array of (score, i, j) per entry. The
    entries lie side by side as segments of the sweep's columns and the
    query's letters are its rows; queries of similar length share a sweep,
    ``group`` at a time."""
    cat = np.concatenate([np.asarray(e) for e in entries])
    lens = np.array([len(e) for e in entries])
    starts_np = np.zeros(len(cat), bool)
    starts_np[np.concatenate([[0], np.cumsum(lens)[:-1]])] = True
    cols = _long(cat, device)[None, :]
    starts = torch.as_tensor(starts_np, device=device)
    tab = None if table is None else _long(table, device)
    out = [None] * len(queries)
    order = sorted(range(len(queries)), key=lambda k: len(queries[k]))
    for g in range(0, len(order), group):
        ks = order[g:g + group]
        n = max(len(queries[k]) for k in ks)
        rows = np.zeros((len(ks), n), np.int64)
        for r, k in enumerate(ks):
            rows[r, :len(queries[k])] = queries[k]
        row_len = torch.as_tensor([len(queries[k]) for k in ks],
                                  device=device)
        best, first, _ = sweep(_long(rows, device), cols, starts, scoring,
                               tab, cap, row_len)
        score, i, j = segment_first_max(best, first, starts, "cols")
        got = torch.stack([score, i, j], 2).cpu().numpy()
        for r, k in enumerate(ks):
            out[k] = got[r]
    return out


def _revcomp_padded(q: np.ndarray) -> np.ndarray:
    """Reverse complement of each read of a padded batch (real codes
    0..3, padding -3 at the end), the padding kept at the end."""
    out = np.full_like(q, -3)
    for r, row in enumerate(q):
        real = row[row != -3]
        out[r, :len(real)] = (3 - real)[::-1]
    return out


def search_windows(ref_len: int, qlen: int, window: int) -> list:
    """(offsets, width) of the search's windows into the reference padded
    to ref_len + qlen with a never-matching code: windows of ``window``
    columns (at most the padded length) overlapping by qlen, the last
    ending at the end."""
    ext = ref_len + qlen
    window = min(window, ext)
    step = window - qlen
    if step <= 0:
        raise ValueError("the window must be longer than the reads")
    nwin = max(1, -(-max(1, ext - qlen) // step))
    return [min(w * step, ext - window) for w in range(nwin)], window


def search(reads: np.ndarray, ref: np.ndarray, scoring: Scoring,
           window: int = 32768, cap: Optional[int] = None, device="cpu",
           block: int = 16) -> np.ndarray:
    """Each padded read (a row of reads, -3 after its letters) against the
    reference on both strands, window by window as the search's
    semantics define it: a (B, 4) int64 array of (score, end position,
    read end, strand) per read.

    A window's answer is its best cell, the first in row-major order (read
    row i, then column j); the read's answer over the windows is the
    highest score, a tie going to the lower end position (0-based, into
    the reference: the window's offset + j - 1); over the strands the
    reverse one wins only with a strictly higher score. The read end is
    the 1-based row in the strand's read; a score of 0 has position -1,
    read end 0 and strand 0."""
    B, qlen = reads.shape
    offs, window = search_windows(len(ref), qlen, window)
    padded = np.full(len(ref) + qlen, -2, np.int64)
    padded[:len(ref)] = ref
    idx = np.asarray(offs)[:, None] + np.arange(window)[None, :]
    cols = _long(padded[idx].reshape(-1), device)[None, :]
    starts = torch.zeros(cols.shape[1], dtype=torch.bool, device=device)
    starts[::window] = True
    offs_t = torch.as_tensor(offs, device=device)
    strands = []
    for q in (reads, _revcomp_padded(reads)):
        got = []
        for lo in range(0, B, block):
            rows = _long(q[lo:lo + block], device)
            best, first, _ = sweep(rows, cols, starts, scoring, None, cap)
            s, i, j = segment_first_max(best, first, starts, "rows")
            pos = offs_t[None, :] + j - 1
            bs = torch.zeros(len(rows), dtype=torch.int64, device=device)
            bp = torch.full_like(bs, 1 << 40)
            be = torch.zeros_like(bs)
            for w in range(len(offs)):
                sw, pw = s[:, w], pos[:, w]
                win = (sw > bs) | ((sw == bs) & (pw < bp) & (sw > 0))
                bs = torch.where(win, sw, bs)
                bp = torch.where(win, pw, bp)
                be = torch.where(win, i[:, w], be)
            got.append(torch.stack([bs, torch.where(bs > 0, bp, -1), be], 1))
        strands.append(torch.cat(got).cpu().numpy())
    fwd, rev = strands
    take = rev[:, 0] > fwd[:, 0]
    out = np.where(take[:, None], rev, fwd)
    strand = np.where(out[:, 0] > 0, np.where(take, -1, 1), 0)
    return np.concatenate([out, strand[:, None]], 1)
