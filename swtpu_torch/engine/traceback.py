"""Memory-lean traceback for large matrices: locate + windowed refill +
Hirschberg / Myers-Miller divide-and-conquer.

Counterpart of ``swtpu.engine.traceback``, with its names and answers and
an explicit ``device``:

1. ``locate()``: a forward score pass finds the alignment END; an anchored
   reverse pass, global mode with NEG boundaries but the origin, over the
   reversed clipped prefixes finds its START. O(1) extra memory.
2. ``windowed()``: if the located window fits a budget, refill just the
   window with predecessors (P) and walk it. O(window) memory; on a card P
   stays there and only the moves come back.
3. ``hirschberg()``: otherwise, global-align the located substrings in
   O(m+n) memory by divide and conquer, the row passes running the NW
   block fill and only the small base cases (``_nw_host``,
   ``_nw_host_affine``) filling matrices, in numpy on the host. Affine gaps
   use the full Myers-Miller state split.

On a CUDA device every pass runs the hand-written kernels of
``kernels.stripe_fill`` (forward score K1/K2/K3, reverse and row passes
K5, window refill K4, the walk), at any width from 1, for a scoring they
take; for one they do not (``kernels_take``: non-negative penalties), the
passes run the plain versions on the card, chosen before any launch
(``dispatch.plan.runs_kernels``), as the JAX package runs its scan there.
On the CPU the passes run the plain versions. The JAX package's TPU-only
gates are not carried over: the CUDA kernels keep the scan's NEG = -2^30
and mask edges, so they need no minimum size or width, no -2^24 sentinel
bound and no packed-argmax bound; and the passes are not padded to
power-of-two widths, which exist there for XLA's per-shape compiles.

As in the JAX package, the linear-space paths return an optimal alignment
with the forward score; on ties the path may differ from the full-P walk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core.config import DIAGONAL, LEFT, UP, Scoring
from ..core.encode import DNA_ALPHABET, unknown_letter
from ..dispatch.plan import runs_kernels
from ..instrument import profiling
from ..kernels import stripe_fill as sf

_NEG = -(1 << 30)
# the gap of the code lists the host routes build: no int8 code takes it,
# so a sentinel code (-1, an unknown base; -2 and -3, padding) stays a base
GAP = -256
Device = Union[str, torch.device]


def _on_card(device: torch.device, scoring: Scoring, sub, m: int = 1,
             n: int = 1) -> bool:
    """The passes launch the CUDA kernels on a CUDA device for a scoring
    and shape they take, the plain versions elsewhere."""
    return runs_kernels(device, scoring, sub, m, n)


def _t(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _sub_t(sub, device: torch.device) -> Optional[torch.Tensor]:
    return None if sub is None else _t(np.asarray(sub, np.int32), device)


def _local_score(a: np.ndarray, b: np.ndarray, scoring: Scoring, sub,
                 device: torch.device):
    """Score-only forward pass: (max_score, max_i, max_j, last_cell)."""
    fn = sf.stripe_score if _on_card(device, scoring, sub, len(a), len(b)) \
        else sf.stripe_score_plain
    out = fn(_t(a, device), _t(b, device), scoring,
             substitution=_sub_t(sub, device))
    return tuple(out.best.tolist())


def _block(a: np.ndarray, b: np.ndarray, scoring: Scoring, top, left, sub,
           device: torch.device, want_bottom: bool) -> sf.BlockOut:
    """Global-mode fill of a x b with injected H boundaries; affine E/F
    boundaries NEG (no gap flows in from outside)."""
    fn = sf.stripe_block if _on_card(device, scoring, sub, len(a), len(b)) \
        else sf.stripe_block_plain
    return fn(_t(a, device), _t(b, device), scoring,
              _t(np.asarray(top, np.int32), device),
              _t(np.asarray(left, np.int32), device), local=False,
              substitution=_sub_t(sub, device), want_bottom=want_bottom)


def _nw_argmax(a: np.ndarray, b: np.ndarray, scoring: Scoring,
               top: np.ndarray, left: np.ndarray, sub, device: torch.device):
    """Global-mode fill with injected boundaries; returns
    (max_score, max_i, max_j). Used by the anchored reverse pass, whose
    max is guaranteed positive."""
    s, i, j, _ = _block(a, b, scoring, top, left, sub, device,
                        want_bottom=False).best.tolist()
    return s, i, j


class AnchoredReverseMismatch(RuntimeError):
    """The anchored reverse pass did not reproduce the forward score.

    The locate trick's precondition: an optimal LOCAL alignment starts and
    ends in the H state, so a global-mode reverse DP anchored at the
    forward end cell must reach exactly the forward score. A mismatch
    means the scoring model violates that contract (e.g. a non-negative
    gap/mismatch making terminal gaps free) or an internal inconsistency
    between the forward and reverse fills. It carries the evidence.
    """

    def __init__(self, forward_score: int, reverse_score: int,
                 end_i: int, end_j: int, last_cell: int = 0):
        self.forward_score = int(forward_score)
        self.reverse_score = int(reverse_score)
        self.end_i = int(end_i)
        self.end_j = int(end_j)
        self.last_cell = int(last_cell)
        super().__init__(
            f"anchored reverse pass scored {reverse_score} but the forward "
            f"pass found {forward_score} ending at ({end_i}, {end_j}); the "
            f"locate contract requires negative gap/mismatch penalties so "
            f"optimal local alignments start and end in the H state")


class Located(NamedTuple):
    score: int
    start_i: int     # first aligned row (1-based, padded coords)
    start_j: int
    end_i: int       # last aligned row
    end_j: int
    last_cell: int = 0   # H[n, m] (the reference's H[m*n-1] invariant)


def locate(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
           sub=None, *, device: Device = "cuda") -> Optional[Located]:
    """Find score + start/end cells of the optimal local alignment with two
    score-only passes (no P matrix). Linear/affine, optional substitution
    table ``sub`` (A, A). None when nothing scores above 0."""
    device = torch.device(device)
    with profiling.span("swtpu.tb.locate"):
        score, ei, ej, last = _local_score(a, b, scoring, sub, device)
        if score <= 0:
            return None
        # Anchored reverse pass over the clipped reversed prefixes: global-mode
        # DP with -inf boundaries (except the origin) scores only paths that
        # START at the forward end cell, so its argmax is the true START of a
        # path ending exactly at (ei, ej). A plain reverse SW would be wrong:
        # its zero floor lets it pick a different equal-scoring path whose end
        # is elsewhere. (Affine: an optimal local alignment starts and ends in
        # the H state, so the reversed Gotoh recurrence with -inf E/F
        # boundaries scores exactly the reversed paths.)
        ar = a[:ej][::-1].copy()
        br = b[:ei][::-1].copy()
        top = np.full((ej + 1,), _NEG, np.int32)
        left = np.full((ei + 1,), _NEG, np.int32)
        top[0] = left[0] = 0
        # the table lookup S[a_code, b_code] is the same for reversed inputs
        rs, ri, rj = _nw_argmax(ar, br, scoring, top, left, sub, device)
        if rs != score:
            raise AnchoredReverseMismatch(score, rs, ei, ej, last)
        return Located(score, ei - ri + 1, ej - rj + 1, ei, ej, last)


# ---------------------------------------------------------------------------
# Dense host base cases


def _score_fn(a, b, scoring, sub):
    if sub is not None:
        sm = np.asarray(sub, np.int64)
        return sm[a[None, :], b[:, None]]       # (n, m): s[b_i, a_j]
    return np.where(b[:, None] == a[None, :], scoring.match,
                    scoring.mismatch).astype(np.int64)


def _nw_host(a: np.ndarray, b: np.ndarray, scoring: Scoring, sub=None):
    """Small dense global alignment on host; returns (codes_a, codes_b).
    Base case of the linear Hirschberg recursion."""
    m, n = len(a), len(b)
    g = scoring.gap
    H = np.zeros((n + 1, m + 1), np.int64)
    H[0, :] = g * np.arange(m + 1)
    H[:, 0] = g * np.arange(n + 1)
    P = np.zeros((n + 1, m + 1), np.int8)
    P[0, 1:] = LEFT
    P[1:, 0] = UP
    smat = _score_fn(a, b, scoring, sub)
    # anti-diagonal vectorized NW fill
    for d in range(2, n + m + 1):
        i_lo, i_hi = max(1, d - m), min(n, d - 1)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = d - ii
        diag = H[ii - 1, jj - 1] + smat[ii - 1, jj - 1]
        up = H[ii - 1, jj] + g
        left = H[ii, jj - 1] + g
        best = np.maximum(np.maximum(diag, up), left)
        pred = np.where(diag == best, DIAGONAL,
                        np.where(up == best, UP, LEFT)).astype(np.int8)
        H[ii, jj] = best
        P[ii, jj] = pred
    # walk from (n, m) to (0, 0)
    out_a, out_b = [], []
    i, j = n, m
    while i > 0 or j > 0:
        code = P[i, j]
        if code == DIAGONAL:
            out_a.append(a[j - 1]); out_b.append(b[i - 1]); i -= 1; j -= 1
        elif code == UP:
            out_a.append(GAP); out_b.append(b[i - 1]); i -= 1
        else:
            out_a.append(a[j - 1]); out_b.append(GAP); j -= 1
    return out_a[::-1], out_b[::-1]


def _nw_host_affine(a, b, scoring: Scoring, tbg: int, teg: int, sub=None):
    """Dense global Gotoh alignment with Myers-Miller border gap-open
    parts: a vertical gap that starts at the top border (down column 0)
    opens with g-part ``tbg``, one that ends at the bottom-right corner
    with ``teg`` (0 = the gap continues across the border and was already
    opened there; g0 = open - extend = normal). Returns (codes_a, codes_b).
    """
    m, n = len(a), len(b)
    op, ext = scoring.gap_open, scoring.gap_extend
    g0 = op - ext
    if m == 0:
        return [GAP] * n, list(b)
    if n == 0:
        return list(a), [GAP] * m
    NEG = np.int64(_NEG)
    H = np.empty((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    H[0, 0] = 0
    H[0, 1:] = g0 + ext * np.arange(1, m + 1)
    H[1:, 0] = tbg + ext * np.arange(1, n + 1)
    F[1:, 0] = H[1:, 0]                     # column-0 gap IS the F state
    smat = _score_fn(a, b, scoring, sub)
    for i in range(1, n + 1):
        Ei = NEG
        for j in range(1, m + 1):
            Ei = max(H[i, j - 1] + op, Ei + ext)
            # teg discounts ONLY the final corner gap: any used vertical
            # gap in column m necessarily runs to row n, so discounting
            # opens in column m == discounting the gap glued across the
            # bottom border at the crossing column. A row-n gap at j < m
            # does NOT continue below and must pay the normal open.
            fo = teg + ext if j == m else op
            F[i, j] = max(H[i - 1, j] + fo, F[i - 1, j] + ext)
            E[i, j] = Ei
            H[i, j] = max(H[i - 1, j - 1] + smat[i - 1, j - 1],
                          max(Ei, F[i, j]))
    # walk with the Gotoh state machine
    out_a, out_b = [], []
    i, j = n, m
    state = 0
    while i > 0 or j > 0:
        if j == 0:
            out_a.append(GAP); out_b.append(b[i - 1]); i -= 1
            continue
        if i == 0:
            out_a.append(a[j - 1]); out_b.append(GAP); j -= 1
            continue
        if state == UP:
            out_a.append(GAP); out_b.append(b[i - 1])
            fo = teg + ext if j == m else op
            state = UP if F[i, j] != H[i - 1, j] + fo else 0
            i -= 1
            continue
        if state == LEFT:
            out_a.append(a[j - 1]); out_b.append(GAP)
            state = LEFT if E[i, j] != H[i, j - 1] + op else 0
            j -= 1
            continue
        h = H[i, j]
        if h == H[i - 1, j - 1] + smat[i - 1, j - 1]:
            out_a.append(a[j - 1]); out_b.append(b[i - 1]); i -= 1; j -= 1
        elif h == F[i, j]:
            state = UP
        else:
            state = LEFT
    return out_a[::-1], out_b[::-1]


# ---------------------------------------------------------------------------
# Device last-row passes


def _nw_last_row(a: np.ndarray, b: np.ndarray, scoring: Scoring, sub=None,
                 *, device: Device = "cuda") -> np.ndarray:
    """Last row of the linear global DP via the device fill. O(m) output."""
    m, n = len(a), len(b)
    g = scoring.gap
    if n == 0:
        return g * np.arange(m + 1)
    top = g * np.arange(m + 1)
    left = g * np.arange(n + 1)
    out = _block(a, b, scoring, top, left, sub, torch.device(device),
                 want_bottom=True)
    return out.bottom_row.cpu().numpy().astype(np.int64)


def _nw_last_rows_affine(a: np.ndarray, b: np.ndarray, scoring: Scoring,
                         tbg: int, sub=None, *, device: Device = "cuda"):
    """(H_last, F_last) of the global Gotoh DP of a x b with left-border
    gap-open part ``tbg``: the Myers-Miller forward/reverse pass on the
    device. Both are int64 (m+1,) arrays; F_last[0] is the column-0
    boundary gap value."""
    m, n = len(a), len(b)
    op, ext = scoring.gap_open, scoring.gap_extend
    g0 = op - ext
    if n == 0:
        H = np.empty((m + 1,), np.int64)
        H[0] = 0
        H[1:] = g0 + ext * np.arange(1, m + 1)
        return H, np.full((m + 1,), _NEG, np.int64)
    top = np.empty((m + 1,), np.int64)
    top[0] = 0
    top[1:] = g0 + ext * np.arange(1, m + 1)
    left = tbg + ext * np.arange(n + 1)
    left[0] = 0
    out = _block(a, b, scoring, top, left, sub, torch.device(device),
                 want_bottom=True)
    H = out.bottom_row.cpu().numpy().astype(np.int64)
    F = out.bottom_f.cpu().numpy().astype(np.int64)
    F[0] = left[n]          # the column-0 boundary gap is an F state
    return H, F


_BASE_CELLS = 1 << 18


def _hirschberg(a: np.ndarray, b: np.ndarray, scoring: Scoring, sub=None,
                *, device: Device = "cuda"):
    m, n = len(a), len(b)
    if m == 0:
        return [GAP] * n, list(b)
    if n == 0:
        return list(a), [GAP] * m
    if (m + 1) * (n + 1) <= _BASE_CELLS or n == 1:
        return _nw_host(a, b, scoring, sub=sub)
    half = n // 2
    top = _nw_last_row(a, b[:half], scoring, sub, device=device)
    bot = _nw_last_row(a[::-1].copy(), b[half:][::-1].copy(), scoring, sub,
                       device=device)[::-1]
    split = int(np.argmax(top + bot))
    a1, b1 = _hirschberg(a[:split], b[:half], scoring, sub, device=device)
    a2, b2 = _hirschberg(a[split:], b[half:], scoring, sub, device=device)
    return a1 + a2, b1 + b2


def _mm_affine(a: np.ndarray, b: np.ndarray, scoring: Scoring,
               tbg: int, teg: int, sub=None, *, device: Device = "cuda"):
    """Myers-Miller affine divide-and-conquer (Myers & Miller 1988,
    'Optimal alignments in linear space'): split b (rows) at half; the
    crossing is either an H-state cell (type 1) or a vertical gap spanning
    the split (type 2, joined with a single gap-open: DD + SS - g0).
    ``tbg``/``teg`` are the g-parts charged to gaps touching the top /
    bottom borders (0 when the gap continues across a type-2 split)."""
    m, n = len(a), len(b)
    op, ext = scoring.gap_open, scoring.gap_extend
    g0 = op - ext
    if m == 0 or n <= 2 or (m + 1) * (n + 1) <= _BASE_CELLS:
        return _nw_host_affine(a, b, scoring, tbg, teg, sub=sub)
    half = n // 2
    CC, DD = _nw_last_rows_affine(a, b[:half], scoring, tbg, sub,
                                  device=device)
    RRr, SSr = _nw_last_rows_affine(a[::-1].copy(), b[half:][::-1].copy(),
                                    scoring, teg, sub, device=device)
    RR, SS = RRr[::-1], SSr[::-1]
    t1 = CC + RR
    t2 = DD + SS - g0
    j1, j2 = int(np.argmax(t1)), int(np.argmax(t2))
    if t1[j1] >= t2[j2]:
        j = j1
        a1, b1 = _mm_affine(a[:j], b[:half], scoring, tbg, g0, sub,
                            device=device)
        a2, b2 = _mm_affine(a[j:], b[half:], scoring, g0, teg, sub,
                            device=device)
        return a1 + a2, b1 + b2
    # type 2: rows half and half+1 are inside one vertical gap; emit them
    # explicitly and tell both halves their border gap is already open
    j = j2
    a1, b1 = _mm_affine(a[:j], b[:half - 1], scoring, tbg, 0, sub,
                        device=device)
    a2, b2 = _mm_affine(a[j:], b[half + 1:], scoring, 0, teg, sub,
                        device=device)
    return a1 + [GAP, GAP] + a2, b1 + [b[half - 1], b[half]] + b2


def _render(codes_a, codes_b, alphabet=DNA_ALPHABET):
    """Code lists -> strings: GAP as '-', a code below 0 as ``decode``
    renders it ('N', or 'X' for an alphabet that carries one)."""
    unk = unknown_letter(alphabet)

    def text(codes):
        return "".join("-" if c == GAP else alphabet[c] if c >= 0 else unk
                       for c in codes)

    return text(codes_a), text(codes_b)


def hirschberg(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
               loc: Optional[Located] = None, alphabet: str = DNA_ALPHABET,
               sub=None, *, device: Device = "cuda"):
    """O(m+n)-memory optimal local alignment. Returns (score, Located,
    aligned_a, aligned_b) or None if nothing scores above 0.

    Linear gaps use classic Hirschberg; affine gaps the full Myers-Miller
    state split (type-2 vertical-gap crossings charged one open). ``sub``:
    optional substitution matrix. ``loc``: optional precomputed Located,
    which skips the score passes.
    """
    if loc is None:
        loc = locate(a, b, scoring, sub, device=device)
    if loc is None:
        return None
    sub_a = np.asarray(a[loc.start_j - 1: loc.end_j])
    sub_b = np.asarray(b[loc.start_i - 1: loc.end_i])
    if scoring.is_affine:
        g0 = scoring.gap_open - scoring.gap_extend
        ca, cb = _mm_affine(sub_a, sub_b, scoring, g0, g0, sub,
                            device=device)
    else:
        ca, cb = _hirschberg(sub_a, sub_b, scoring, sub, device=device)
    with profiling.span("swtpu.tb.strings"):
        ra, rb = _render(ca, cb, alphabet)
    return loc.score, loc, ra, rb


def _window_walk(sub_a, sub_b, wn, wm, scoring, sub, device: torch.device):
    """LOCAL P-capture refill of the window, then a walk of P from its
    corner with the Gotoh state machine (linear P has no state bits; the
    same walk covers both). The window's bottom-right corner is the located
    end cell, so walking from there reproduces an optimal path; the
    zero-floor NONE stop is the located start. On a card P never leaves
    it: the walk kernel brings back only the moves."""
    card = _on_card(device, scoring, sub, len(sub_a), len(sub_b))
    with profiling.span("swtpu.tb.refill"):
        at, bt = _t(sub_a, device), _t(sub_b, device)
        st = _sub_t(sub, device)
        fill = sf.stripe_fill if card else sf.stripe_fill_plain
        P = fill(at, bt, scoring, substitution=st).P
    with profiling.span("swtpu.tb.walk"):
        walk = sf.walk_p if card else sf.walk_p_plain
        moves = walk(P, wn, wm).tolist()
    del P
    with profiling.span("swtpu.tb.strings"):
        return _apply_moves(sub_a, sub_b, wn, wm, moves)


def _apply_moves(sub_a, sub_b, wn, wm, moves):
    """End-first move sequence -> (codes_a, codes_b) from the corner."""
    out_a, out_b = [], []
    i, j = wn, wm
    for move in moves:
        if move == DIAGONAL:
            out_a.append(sub_a[j - 1]); out_b.append(sub_b[i - 1])
            i -= 1; j -= 1
        elif move == UP:
            out_a.append(GAP); out_b.append(sub_b[i - 1]); i -= 1
        else:
            out_a.append(sub_a[j - 1]); out_b.append(GAP); j -= 1
    return out_a[::-1], out_b[::-1]


def walk_from_end(a: np.ndarray, b: np.ndarray, scoring: Scoring,
                  score: int, end_i: int, end_j: int, last_cell: int = 0,
                  alphabet: str = DNA_ALPHABET, sub=None, *,
                  device: Device = "cuda"):
    """Full-P fallback when the anchored reverse pass is unavailable: refill
    [1..end_i] x [1..end_j] with predecessors and walk from the end cell
    (the zero-floor NONE stop finds the start without a reverse pass).
    O(end_i * end_j) memory: the caller gates on the window budget."""
    sub_a = np.asarray(a[:end_j])
    sub_b = np.asarray(b[:end_i])
    ca, cb = _window_walk(sub_a, sub_b, end_i, end_j, scoring, sub,
                          torch.device(device))
    si = end_i - sum(1 for c in cb if c != GAP) + 1
    sj = end_j - sum(1 for c in ca if c != GAP) + 1
    loc = Located(int(score), si, sj, end_i, end_j, int(last_cell))
    with profiling.span("swtpu.tb.strings"):
        ra, rb = _render(ca, cb, alphabet)
    return loc.score, loc, ra, rb


def windowed(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
             max_window_cells: Optional[int] = None,
             loc: Optional[Located] = None,
             alphabet: str = DNA_ALPHABET, sub=None, *,
             device: Device = "cuda"):
    """Locate, then refill only the alignment window with predecessors and
    walk it. Falls back to hirschberg() when the window exceeds the budget.
    Linear/affine, optional substitution matrix. ``loc``: optional
    precomputed Located (skips the score passes).

    If the anchored reverse pass inside locate() fails its contract
    (AnchoredReverseMismatch), the full-P end-anchored walk recovers the
    alignment when [1..end] fits the window budget; the typed error
    propagates otherwise."""
    device = torch.device(device)
    if loc is None:
        try:
            loc = locate(a, b, scoring, sub, device=device)
        except AnchoredReverseMismatch as e:
            budget = max_window_cells if max_window_cells is not None \
                else (1 << 26)
            if e.end_i * e.end_j <= budget:
                return walk_from_end(a, b, scoring, e.forward_score,
                                     e.end_i, e.end_j, e.last_cell,
                                     alphabet=alphabet, sub=sub,
                                     device=device)
            raise
    if loc is None:
        return None
    wm = loc.end_j - loc.start_j + 1
    wn = loc.end_i - loc.start_i + 1
    if max_window_cells is None:
        # on a card P stays in HBM (int8) and is walked there, so the
        # budget is device memory: 2^30 cells = 1 GB of P. A 25632^2
        # whole-matrix window (random DNA at the benchmark's scoring aligns
        # across nearly the whole matrix) is 657 M cells.
        max_window_cells = (1 << 30) if device.type == "cuda" \
            else (1 << 26)
    if wm * wn > max_window_cells:
        return hirschberg(a, b, scoring, loc=loc, alphabet=alphabet,
                          sub=sub, device=device)
    sub_a = np.asarray(a[loc.start_j - 1: loc.end_j])
    sub_b = np.asarray(b[loc.start_i - 1: loc.end_i])
    ca, cb = _window_walk(sub_a, sub_b, wn, wm, scoring, sub, device)
    with profiling.span("swtpu.tb.strings"):
        ra, rb = _render(ca, cb, alphabet)
    return loc.score, loc, ra, rb
