"""Structural sanitizer of the stripe kernel: the reference's DEBUG
memory-check analog (counterpart of ``swtpu.instrument.sanitize``).

The reference's DEBUG build wraps every element access in ``at()``/``set()``
checks. Here the stripe kernel runs in its capture mode (K9,
``kernels.debug_fill``): every thread stores its H after every step, and
every stripe that reads the global boundary row stores the progress of the
stripe above that it saw at each read. ``sanitize_stripe`` captures the
register-blocked stripe that ``score()`` runs (``stripe_rb_capture``:
each thread's R x C tile of H, the boundary row read by chunks of 32
columns), at the tile ``score()`` runs for that scoring and shape;
``sanitize_pairs_packed`` the packed form of that stripe that K7
(``pairs_packed_score``) runs (``packed_rb_capture``: each pair's rows at
a pitch of whole threads, every stripe starting at a pair's row 1), at
K7's tile and geometry. On a card that is the production kernel's own
schedule, so a broken hand-off
between stripes, a race that can give the right answer in one run and a
wrong one in the next, shows up as a broken invariant rather than as a
wrong answer downstream. On the CPU the plain capture follows the same
schedule.

The JAX kernel leaves edge slots unmasked and relies on garbage decaying;
the CUDA kernels mask their edges, and the register-blocked capture stores
0 for the cells past row n that its tile computes and discards (no cell of
the matrix reads them), so the checks are stricter. Every capture is read
in the tile layout (``debug_fill.slot_cells``), the template's as its R =
C = 1 case; a packed register-blocked capture through the map its
geometry carries (``PackedGeometry.cells``). In order:

1. every pre-start slot (column < 1) holds exactly 0;
2. every in-matrix slot equals the numpy oracle's H bit for bit (packed:
   its own pair's H, rows rebased to the pair);
3. every post-finish slot (column > m) and every slot of a row past the
   last (the last stripe's idle threads and rows; packed, each pair's pad
   rows and the threads past a stripe's last pair) holds exactly 0, which
   implies the JAX checks that garbage stays below the max and never
   feeds an in-matrix cell;
4. the hand-off: a stripe that reads the boundary row read column j only
   after seeing the stripe above publish j or later; a stripe that reads
   none (stripe 0, and in the packed mode a stripe starting a pair)
   recorded nothing;
5. every slot the kernel never schedules (a stripe's steps past its own
   ceil(m / C) + kt - 1, kt its (pair's) threads holding rows) still
   holds the sentinel;
6. the kernel's own max equals the oracle's; in the packed mode K7's
   public launch (``pairs_fill.pairs_packed_score``, at the capture's (T,
   R, C)) must also give every pair's oracle max.

``sanitize_stripe``/``sanitize_pairs_packed`` raise ``SanitizeError`` at
the first violation, else return a ``SanitizeReport``, whose ``config``
names the tile: (T, R, C, stripes), T threads of R rows and C columns a
step. They run on
``device`` (default ``'cuda'``, which raises without a card) and take the
scorings the kernels take (``kernels_take``: negative penalties). The
capture is sized for debug shapes: above ``SANITIZE_MAX_SLOTS`` int32
slots they raise ``ValueError``. ``skew`` is the checks' test hook: it
breaks the hand-off on purpose (a consumer reads boundary column j - skew),
and the sanitizer must then fail.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..core import oracle
from ..core.config import Scoring
from ..core.substitution import check_table, embed_sentinels
from ..engine.align import _as_codes, resolve_device
from ..kernels import debug_fill
from ..kernels import pairs_fill as pf
from ..kernels import stripe_fill as sf
from ..kernels.debug_fill import SANITIZE_MAX_SLOTS, UNSCHEDULED, Capture

__all__ = ["SanitizeError", "SanitizeReport", "SANITIZE_MAX_SLOTS",
           "sanitize_stripe", "sanitize_pairs_packed", "check_capture",
           "reference"]


class SanitizeError(AssertionError):
    """A stripe-kernel invariant was violated."""


@dataclasses.dataclass
class SanitizeReport:
    valid_cells: int          # in-matrix slots checked bit-equal vs oracle
    prestart_cells: int       # pre-start slots verified == 0
    garbage_cells: int        # post-finish / idle-row slots verified == 0
    config: tuple             # (T, R, C, stripes)


def sanitize_stripe(a, b, scoring: Scoring = Scoring(), T=None,
                    substitution=None,
                    device: Union[str, torch.device] = "cuda", *,
                    skew: int = 0) -> SanitizeReport:
    """Run K9 on one pair, a (m,) against b (n,) (codes, or DNA strings),
    on the register-blocked stripe, and check every invariant of its
    capture. ``T``: rows per stripe, as the JAX sanitizer takes it: the
    capture keeps ``score()``'s tile (R, C) and runs T / R threads,
    rounded up to a warp and at most the capture's RB_EXT_MAX_THREADS;
    None runs exactly the (T, R, C) ``score()`` runs for this scoring and
    shape. ``substitution``: an (A, A) table."""
    dev = resolve_device(device)
    a, b = _as_codes(a), _as_codes(b)
    S = None if substitution is None else check_table(substitution)
    at, bt, st = _on(dev, a, b, S)
    cap = debug_fill.stripe_rb_capture(at, bt, scoring,
                                       _threads(T, scoring, S),
                                       substitution=st, skew=skew)
    return check_capture(cap, *reference(a, b, scoring, S))


def _threads(T, scoring: Scoring, S) -> Union[int, None]:
    """The capture's threads for T rows per stripe: T / R at score()'s
    (and K7's) R, rounded up to a warp, at most RB_EXT_MAX_THREADS; None
    for None."""
    if T is None:
        return None
    R = sf.RB_DEFAULTS[sf._mode(scoring, S)][1]
    return min(sf.RB_EXT_MAX_THREADS, max(32, -(-T // (32 * R)) * 32))


def sanitize_pairs_packed(a_batch, b_batch, scoring: Scoring = Scoring(),
                          T=None, substitution=None,
                          device: Union[str, torch.device] = "cuda", *,
                          skew: int = 0) -> SanitizeReport:
    """Run the packed K9 on B pairs packed as K7 packs them, a (B, m)
    against b (B, n) codes, and check the invariants per pair. ``T``:
    rows per stripe, as ``sanitize_stripe`` takes it (K7's (R, C), T / R
    threads rounded up to a warp, at most the capture's
    RB_EXT_MAX_THREADS, then K7's geometry's rounding); None runs exactly
    the (T, R, C) and geometry ``pairs_packed_score`` runs."""
    dev = resolve_device(device)
    aa = np.ascontiguousarray(a_batch, np.int8)
    bb = np.ascontiguousarray(b_batch, np.int8)
    S = None if substitution is None else check_table(substitution)
    at, bt, st = _on(dev, aa, bb, S)
    cap = debug_fill.packed_rb_capture(at, bt, scoring, _threads(T, scoring,
                                                                 S),
                                       substitution=st, skew=skew)
    H, maxes = reference(aa, bb, scoring, S)
    report = check_capture(cap, H, maxes)
    got = pf.pairs_packed_score(at, bt, scoring, cap.T, st, cap.R,
                                cap.C).scores.tolist()
    for g, (x, y) in enumerate(zip(got, maxes)):
        if x != max(y, 0):
            raise SanitizeError(f"packed pair {g}: K7 max {x} != oracle "
                                f"max {y}")
    return report


def check_capture(cap: Capture, H: list, maxes: list) -> SanitizeReport:
    """Check a capture against the oracle: ``H``, each pair's (rows + 1,
    m + 1) H (one pair: a list of one); ``maxes``, each pair's max. Raises
    SanitizeError at the first violation, in the module's order."""
    T, R, C = cap.T, cap.R, cap.C
    stripes, steps = cap.h.shape[:2]
    h = cap.h.cpu().numpy().reshape(stripes, steps, T, R, C)
    seen = cap.seen.cpu().numpy()
    m = H[0].shape[1] - 1
    rows = H[0].shape[0] - 1
    n = rows * len(H)
    of = (lambda g: f" of pair {g}") if len(H) > 1 else (lambda g: "")
    geo = cap.geometry
    t = np.arange(steps)[None, :, None, None, None]
    if geo is None:
        # the capture a right kernel makes: slot (s, t, k, r, c) is cell
        # (i, j) of slot_cells, pairs back to back at ``rows`` rows; stripe
        # s runs ceil(m / C) + kt - 1 steps, kt its threads holding rows
        i, j = (x.numpy() for x in debug_fill.slot_cells(stripes, steps, T,
                                                          R, C))
        kt = -(-np.minimum(T * R, n - np.arange(stripes) * T * R) // R)
        run = -(-m // C) + kt - 1
        g, r = np.divmod(np.broadcast_to(i, h.shape) - 1, rows)
        held = True                     # every thread holds rows
        inside = i <= n
        # a stripe reads the boundary unless its first row is a pair's row 1
        reading = (np.arange(stripes) * T * R) % rows != 0
    else:
        # the packed form: slot (s, t, k, r, c) is row i of pair g (-1: no
        # pair) at column j, the geometry's map, each stripe its own steps
        if (geo.T, geo.R, geo.B, geo.n) != (T, R, len(H), rows):
            raise SanitizeError(f"capture geometry {geo} does not hold "
                                f"{len(H)} pairs of {rows} rows at (T, R) = "
                                f"{(T, R)}")
        g, i, j = (x.numpy() for x in geo.cells(steps, C))
        run = geo.stripe_steps(m, C).numpy()
        held = g >= 0                   # a thread past the last pair: idle
        inside = held & (i <= rows)
        g = np.broadcast_to(g, h.shape)
        r = np.broadcast_to(i, h.shape) - 1
        reading = geo.reads().numpy()
    sched = np.broadcast_to(t < run[:, None, None, None, None], h.shape)
    pre = sched & (j < 1) & held
    valid = sched & (j >= 1) & (j <= m) & inside
    garbage = sched & ~pre & ~valid
    jj = np.broadcast_to(j, h.shape)
    want = np.where(sched, 0, UNSCHEDULED).astype(np.int32)
    want[valid] = np.stack(H)[g[valid], r[valid] + 1, jj[valid]]
    bad = h != want

    def first(mask):
        return tuple(int(x[0]) for x in np.nonzero(mask))

    def slot(s, t0, k0, r0, c0):
        tile = f", row {r0}, column {c0} of its tile" if R * C > 1 else ""
        return f"(stripe={s}, step={t0}, thread={k0}{tile})"

    if (bad & pre).any():
        x = first(bad & pre)
        raise SanitizeError(f"pre-start slot {slot(*x)} holds {h[x]} != 0")
    if (bad & valid).any():
        x = first(bad & valid)
        raise SanitizeError(
            f"cell (i={r[x] + 1}, j={jj[x]}){of(g[x])} = {h[x]} != oracle "
            f"{want[x]} {slot(*x)} — boundary hand-off/injection invariant "
            "violated")
    if (bad & garbage).any():
        x = first(bad & garbage)
        raise SanitizeError(
            f"post-finish or idle-row slot {slot(*x)} holds {h[x]} != 0: an "
            "edge mask leaks")
    col = np.arange(m + 1)
    floor = np.where(reading[:, None] & (col >= 1), col, -1)
    badseen = np.where(floor >= 1, seen < floor, seen != -1)
    if badseen.any():
        s, j0 = first(badseen)
        if floor[s, j0] >= 1:
            raise SanitizeError(
                f"hand-off: stripe {s} read column {j0} of the boundary row "
                f"after seeing progress {seen[s, j0]} < {j0} of stripe "
                f"{s - 1}")
        raise SanitizeError(
            f"hand-off: stripe {s} recorded progress {seen[s, j0]} at "
            f"column {j0}, where it reads no boundary")
    if (bad & ~sched).any():
        x = first(bad & ~sched)
        raise SanitizeError(
            f"unscheduled slot {slot(*x)} was overwritten with {h[x]}")
    for g0, (x, y) in enumerate(zip(cap.scores.tolist(), maxes)):
        if x != max(y, 0):
            raise SanitizeError(f"kernel max {x}{of(g0)} != oracle max {y}")
    return SanitizeReport(
        valid_cells=int(valid.sum()), prestart_cells=int(pre.sum()),
        garbage_cells=int(garbage.sum()), config=(T, R, C, stripes))


def _on(dev: torch.device, a: np.ndarray, b: np.ndarray, S) -> tuple:
    """Codes (and the table) as tensors on ``dev``."""
    return tuple(None if x is None else torch.from_numpy(x).to(dev)
                 for x in (a, b, S))


def reference(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
              substitution=None) -> tuple:
    """([H], [max]) by the numpy oracle, what ``check_capture`` holds a
    capture to: of one pair, a (m,) against b (n,) codes, or of each pair
    of a (B, m) against b (B, n). With a table, through the
    sentinel-embedded table, so codes -3..-1 score as the kernels score
    them."""
    pairs = zip(a, b) if np.ndim(a) == 2 else [(a, b)]
    if substitution is None:
        refs = [oracle.fill(x, y, scoring) for x, y in pairs]
    else:
        S = embed_sentinels(check_table(substitution))
        refs = [oracle.fill(x.astype(np.int64) + 3, y.astype(np.int64) + 3,
                            scoring, sub=S) for x, y in pairs]
    return [r.H for r in refs], [r.max_score for r in refs]
