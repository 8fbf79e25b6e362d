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
``sanitize_pairs_packed`` the stripe template's packed pairs (K7). On a
card that is the production kernel's own schedule, so a broken hand-off
between stripes, a race that can give the right answer in one run and a
wrong one in the next, shows up as a broken invariant rather than as a
wrong answer downstream. On the CPU the plain capture follows the same
schedule.

The JAX kernel leaves edge slots unmasked and relies on garbage decaying;
the CUDA kernels mask their edges, and the register-blocked capture stores
0 for the cells past row n that its tile computes and discards (no cell of
the matrix reads them), so the checks are stricter. Every capture is read
in the tile layout (``debug_fill.slot_cells``), the template's as its R =
C = 1 case. In order:

1. every pre-start slot (column < 1) holds exactly 0;
2. every in-matrix slot equals the numpy oracle's H bit for bit (packed:
   its own pair's H, rows rebased to the pair);
3. every post-finish slot (column > m) and every slot of a row past the
   last (the last stripe's idle threads and rows) holds exactly 0, which
   implies the JAX checks that garbage stays below the max and never
   feeds an in-matrix cell;
4. the hand-off: a stripe that reads the boundary row read column j only
   after seeing the stripe above publish j or later; a stripe that reads
   none (stripe 0, and in the packed mode a stripe starting a pair)
   recorded nothing;
5. every slot the kernel never schedules (the last stripe's steps past its
   own ceil(m / C) + kt - 1, kt its threads holding rows) still holds the
   sentinel;
6. the kernel's own max equals the oracle's; in the packed mode K7's
   public launch (``pairs_fill.pairs_packed_score``) must also give every
   pair's oracle max.

``sanitize_stripe``/``sanitize_pairs_packed`` raise ``SanitizeError`` at
the first violation, else return a ``SanitizeReport``, whose ``config``
names the tile: (T, R, C, stripes), T threads of R rows and C columns a
step (the template's packed capture: (T, 1, 1, stripes)). They run on
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
    threads = None
    if T is not None:
        R = sf.RB_DEFAULTS[sf._mode(scoring, S)][1]
        threads = min(sf.RB_EXT_MAX_THREADS, max(32, -(-T // (32 * R)) * 32))
    cap = debug_fill.stripe_rb_capture(at, bt, scoring, threads,
                                       substitution=st, skew=skew)
    return check_capture(cap, *reference(a, b, scoring, S))


def sanitize_pairs_packed(a_batch, b_batch, scoring: Scoring = Scoring(),
                          T=None, substitution=None,
                          device: Union[str, torch.device] = "cuda", *,
                          skew: int = 0) -> SanitizeReport:
    """Run K9 on B pairs packed as K7 packs them, a (B, m) against
    b (B, n) codes, and check the invariants per pair."""
    dev = resolve_device(device)
    aa = np.ascontiguousarray(a_batch, np.int8)
    bb = np.ascontiguousarray(b_batch, np.int8)
    S = None if substitution is None else check_table(substitution)
    at, bt, st = _on(dev, aa, bb, S)
    cap = debug_fill.packed_capture(at, bt, scoring, T, st, skew)
    H, maxes = reference(aa, bb, scoring, S)
    report = check_capture(cap, H, maxes)
    got = pf.pairs_packed_score(at, bt, scoring, cap.T, st).scores.tolist()
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
    # the capture a right kernel makes: slot (s, t, k, r, c) is cell (i, j)
    # of slot_cells; stripe s runs ceil(m / C) + kt - 1 steps, kt its
    # threads holding rows
    i, j = (x.numpy() for x in debug_fill.slot_cells(stripes, steps, T, R,
                                                      C))
    kt = -(-np.minimum(T * R, n - np.arange(stripes) * T * R) // R)
    t = np.arange(steps)[None, :, None, None, None]
    sched = np.broadcast_to(
        t < -(-m // C) + kt[:, None, None, None, None] - 1, h.shape)
    pre = sched & (j < 1)
    valid = sched & (j >= 1) & (j <= m) & (i <= n)
    garbage = sched & ~pre & ~valid
    g, r = np.divmod(np.broadcast_to(i, h.shape) - 1, rows)
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
    # a stripe reads the boundary unless its first row is a pair's row 1
    reading = (np.arange(stripes) * T * R) % rows != 0
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
