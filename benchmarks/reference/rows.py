"""A plain reference for one long pair: the Smith-Waterman fill row by row,
in plain PyTorch operations, on any device, fast enough to check a pair of
a million columns by a million rows on one card.

Semantics, which ``benchmarks/reference/sw.py`` states and this module
keeps exactly (chunhualiao/Smith-Waterman ``serial_smithW.c``; Gotoh for
affine gaps):

* ``a`` lies along the columns (length m), ``b`` along the rows (length
  n); the matrix has a row 0 and a column 0 of zeros, so a cell (i, j) is
  1-based in b and in a.
* Linear gaps: H(i, j) = max(0, H(i-1, j-1) + s, H(i-1, j) + gap,
  H(i, j-1) + gap).
* Affine gaps: a gap of k letters costs gap_open + (k - 1) * gap_extend;
  E runs along a row, F down a column, H = max(0, diag, F, E).
* s is ``match`` where the two codes are equal and ``mismatch`` where not.
* The answer is (score, i, j, last): the max score and, of the cells that
  hold it, the first in row-major order (the lowest row i, then the
  lowest column j: the upstream's strict ``>`` running update,
  serial_smithW.c:240); a max of 0 answers the origin (0, 0), as the
  upstream's maxPos starts there; last is H(n, m).

How it runs. Every number is int32 (int64 only where a row's offsets
would pass 2^31). Each distinct letter of ``b`` has a profile row, s for
every column, made once. The previous row's H lives in a buffer with a
leading zero column, so H(i-1, j-1) and H(i-1, j) are two views of it
and no row is rolled or copied. The in-row gap is a prefix max: H(i, j)
(linear) or E(i, j + 1) - gap_open (affine) is the max over k <= j of
t(k) - pen * (j - k), where t holds the row's other candidates and pen
the in-row gap's cost a letter, so it is a cummax of t(k) + pen * k, less
pen * j. A card's ``torch.cummax`` scans each row of its input with one
group of threads, so the scan runs over blocks of ``_BLOCK`` columns
(rows of a view) and then carries each block's last value on. A running
best and the first row that reached it, per column, give the answer at
the end.

On a card, ``rows_a_replay`` rows are captured once as a CUDA graph
(``torch.cuda.graph``) and replayed: each row reads its letter from a
device tensor through a row counter on the device, so the host issues
one replay for that many rows. The first rows run eagerly (they warm
the operations the graph captures) and so do the rows that do not fill
a last replay. On the CPU every row runs eagerly, the same operations.

``cap`` makes the control: every candidate is clamped to at most
``cap``, as a saturating integer type of that width clamps it (32767 for
int16), i.e. the reference in a narrower precision than a configuration
states.

It imports nothing of the program under test. ``scoring`` is any object
with ``mode`` ('linear' or 'affine'), ``match``, ``mismatch``, ``gap``,
``gap_open`` and ``gap_extend``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG = -(1 << 30)
# columns a block of the prefix max scans; the carry scans one value a block
_BLOCK = 512
# rows a CUDA graph holds, and the rows run eagerly before its capture
ROWS_A_REPLAY = 1024
_EAGER = 2


class _Sweep:
    """The state of one pair's sweep and its row step."""

    def __init__(self, a: np.ndarray, b: np.ndarray, scoring, cap, device,
                 block: int):
        dev = torch.device(device)
        m, n = len(a), len(b)
        self.affine = scoring.mode == "affine"
        self.cap = cap
        self.go, self.ge = scoring.gap_open, scoring.gap_extend
        self.gap = scoring.gap
        pen = -(self.ge if self.affine else self.gap)
        top = (cap if cap is not None else max(1, scoring.match) * n) \
            + pen * m + 1
        self.dt = torch.int32 if top < (1 << 31) else torch.int64
        vals, inv = np.unique(np.asarray(b, np.int64), return_inverse=True)
        a_t = torch.as_tensor(np.asarray(a, np.int64), device=dev)
        self.prof = torch.where(
            a_t[None, :] == torch.as_tensor(vals, device=dev)[:, None],
            scoring.match, scoring.mismatch).to(torch.int32)
        # row r (1-based) reads letter r; letter 0 is never read
        self.letters = torch.as_tensor(
            np.concatenate([[0], inv.reshape(-1)]), dtype=torch.int32,
            device=dev)
        self.row = torch.ones(1, dtype=torch.int32, device=dev)
        self.pencol = (pen * torch.arange(m, device=dev)).to(self.dt)
        # E(j + 1) = prefix(j) - pen * j + gap_open: one subtraction
        self.pen_go = self.pencol - self.go
        self.Hb = torch.zeros(m + 1, dtype=torch.int32, device=dev)
        self.F = torch.full((m,), NEG, dtype=torch.int32, device=dev)
        self.Eb = torch.full((m + 1,), NEG, dtype=torch.int32, device=dev)
        self.best = torch.zeros(m, dtype=torch.int32, device=dev)
        self.first = torch.zeros(m, dtype=torch.int32, device=dev)
        self.block = block
        nb = -(-m // block)
        self.low = torch.iinfo(self.dt).min
        self.U = torch.full((nb * block,), self.low, dtype=self.dt,
                            device=dev)
        self.carry = torch.full((nb,), self.low, dtype=self.dt, device=dev)
        self.m = m

    def prefix(self, t: torch.Tensor) -> torch.Tensor:
        """max over k <= j of t(k) + pen * k, for every column j."""
        m, U = self.m, self.U
        torch.add(t, self.pencol, out=U[:m])
        inner = torch.cummax(U.view(-1, self.block), 1).values
        # each block's carry in: the max of every earlier block's last
        self.carry[1:] = torch.cummax(inner[:-1, -1], 0).values
        return torch.maximum(inner, self.carry[:, None]).view(-1)[:m]

    def step(self) -> None:
        """Fill the row the counter names and move the counter on."""
        code = self.letters.index_select(0, self.row)
        s = self.prof.index_select(0, code)[0]
        H = self.Hb[1:]
        diag = self.Hb[:-1] + s
        if self.affine:
            torch.maximum(self.F.add_(self.ge), H + self.go, out=self.F)
            t = torch.maximum(diag, self.F)
        else:
            t = torch.maximum(diag, H + self.gap)
        t = t.clamp_(min=0) if self.cap is None else t.clamp_(0, self.cap)
        p = self.prefix(t)
        if self.affine:
            torch.sub(p, self.pen_go, out=self.Eb[1:])
            torch.maximum(t, self.Eb[:-1], out=H)
        else:
            torch.sub(p, self.pencol, out=H)
        torch.where(H > self.best, self.row, self.first, out=self.first)
        torch.maximum(self.best, H, out=self.best)
        self.row.add_(1)

    def answer(self) -> tuple:
        """(score, i, j, last) from the per-column best and first row."""
        score = int(self.best.max())
        last = int(self.Hb[-1])
        if score <= 0:
            return 0, 0, 0, last
        at = self.best == score
        i = int(torch.where(at, self.first, torch.iinfo(torch.int32).max)
                .min())
        j = int(torch.nonzero(at & (self.first == i))[0, 0]) + 1
        return score, i, j, last


def pair(a: np.ndarray, b: np.ndarray, scoring, cap: Optional[int] = None,
         device="cpu", rows_a_replay: int = ROWS_A_REPLAY,
         block: int = _BLOCK) -> tuple:
    """One pair, ``a`` (m,) along the columns against ``b`` (n,) along the
    rows, integer codes: (score, i, j, last) as Python ints."""
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return 0, 0, 0, 0
    dev = torch.device(device)
    sw = _Sweep(a, b, scoring, cap, dev, block)
    done = 0
    if dev.type == "cuda" and n >= _EAGER + rows_a_replay:
        with torch.cuda.device(dev):
            for _ in range(_EAGER):
                sw.step()
            done = _EAGER
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(rows_a_replay):
                    sw.step()
            while done + rows_a_replay <= n:
                graph.replay()
                done += rows_a_replay
            torch.cuda.synchronize(dev)
            del graph
    for _ in range(done, n):
        sw.step()
    return sw.answer()
