"""Structural sanitizer of the stripe kernel: the reference's DEBUG
memory-check analog (counterpart of ``swtpu.instrument.sanitize``).

The reference's DEBUG build wraps every element access in ``at()``/``set()``
checks. Here the stripe kernel runs in its capture mode (K9,
``kernels.debug_fill``): every thread stores its H after every step, and
every stripe that reads the global boundary row stores the progress of the
stripe above that it saw at each read. On a card that is the production
kernel's own schedule, so a broken hand-off between stripes, a race that
can give the right answer in one run and a wrong one in the next, shows up
as a broken invariant rather than as a wrong answer downstream. On the CPU
the plain capture follows the same schedule.

The JAX kernel leaves edge slots unmasked and relies on garbage decaying;
the CUDA kernel masks its edges, so the checks are stricter. In order:

1. every pre-start slot (column < 1) holds exactly 0;
2. every in-matrix slot equals the numpy oracle's H bit for bit (packed:
   its own pair's H, rows rebased to the pair);
3. every post-finish slot (column > m) and every slot of a row past the
   last (the last stripe's idle threads) holds exactly 0, which implies
   the JAX checks that garbage stays below the max and decays;
4. the hand-off: a stripe that reads the boundary row read column j only
   after seeing the stripe above publish j or later; a stripe that reads
   none (stripe 0, and in the packed mode a stripe starting a pair)
   recorded nothing;
5. every slot the kernel never schedules (the last stripe's steps past its
   own m + rows - 1) still holds the sentinel;
6. the kernel's own max equals the oracle's; in the packed mode K7's
   public launch (``pairs_fill.pairs_packed_score``) must also give every
   pair's oracle max.

``sanitize_stripe``/``sanitize_pairs_packed`` raise ``SanitizeError`` at
the first violation, else return a ``SanitizeReport``. They run on
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
    config: tuple             # (T, stripes)


def sanitize_stripe(a, b, scoring: Scoring = Scoring(), T=None,
                    substitution=None,
                    device: Union[str, torch.device] = "cuda", *,
                    skew: int = 0) -> SanitizeReport:
    """Run K9 on one pair, a (m,) against b (n,) (codes, or DNA strings),
    and check every invariant of its capture. ``T``: rows per stripe (the
    fill's default when None); ``substitution``: an (A, A) table."""
    dev = resolve_device(device)
    a, b = _as_codes(a), _as_codes(b)
    S = None if substitution is None else check_table(substitution)
    at, bt, st = _on(dev, a, b, S)
    cap = debug_fill.stripe_capture(at, bt, scoring, T, st, skew)
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
    h, seen, T = cap.h.cpu().numpy(), cap.seen.cpu().numpy(), cap.T
    stripes, steps, _ = h.shape
    m = steps - T + 1
    rows = H[0].shape[0] - 1
    n = rows * len(H)
    of = (lambda g: f" of pair {g}") if len(H) > 1 else (lambda g: "")
    # the capture a right kernel makes: slot (s, t, k) is cell
    # (s*T + k + 1, t - k + 1), so row i's cells lie at steps k .. k+m-1
    rows_s = np.minimum(T, n - np.arange(stripes) * T)
    want = np.zeros_like(h)
    for s in range(stripes):
        want[s, m + rows_s[s] - 1:] = UNSCHEDULED
        for k in range(rows_s[s]):
            g, r = divmod(s * T + k, rows)
            want[s, k:k + m, k] = H[g][r + 1, 1:]
    t = np.arange(steps)[None, :, None]
    k = np.arange(T)[None, None, :]
    rs = rows_s[:, None, None]
    sched = t < m + rs - 1
    pre = sched & (t < k)
    valid = sched & (t >= k) & (t < k + m) & (k < rs)
    garbage = sched & ~pre & ~valid
    bad = h != want

    def first(mask):
        return tuple(int(x[0]) for x in np.nonzero(mask))

    if (bad & pre).any():
        s, t0, k0 = first(bad & pre)
        raise SanitizeError(
            f"pre-start slot (stripe={s}, step={t0}, thread={k0}) holds "
            f"{h[s, t0, k0]} != 0")
    if (bad & valid).any():
        s, t0, k0 = first(bad & valid)
        g, r = divmod(s * T + k0, rows)
        raise SanitizeError(
            f"cell (i={r + 1}, j={t0 - k0 + 1}){of(g)} = {h[s, t0, k0]} != "
            f"oracle {want[s, t0, k0]} (stripe={s}, step={t0}, "
            f"thread={k0}) — boundary hand-off/injection invariant violated")
    if (bad & garbage).any():
        s, t0, k0 = first(bad & garbage)
        raise SanitizeError(
            f"post-finish or idle-row slot (stripe={s}, step={t0}, "
            f"thread={k0}) holds {h[s, t0, k0]} != 0: an edge mask leaks")
    # a stripe reads the boundary unless its first row is a pair's row 1
    reading = (np.arange(stripes) * T) % rows != 0
    col = np.arange(m + 1)
    floor = np.where(reading[:, None] & (col >= 1), col, -1)
    badseen = np.where(floor >= 1, seen < floor, seen != -1)
    if badseen.any():
        s, j = first(badseen)
        if floor[s, j] >= 1:
            raise SanitizeError(
                f"hand-off: stripe {s} read column {j} of the boundary row "
                f"after seeing progress {seen[s, j]} < {j} of stripe {s - 1}")
        raise SanitizeError(
            f"hand-off: stripe {s} recorded progress {seen[s, j]} at column "
            f"{j}, where it reads no boundary")
    if (bad & ~sched).any():
        s, t0, k0 = first(bad & ~sched)
        raise SanitizeError(
            f"unscheduled slot (stripe={s}, step={t0}, thread={k0}) was "
            f"overwritten with {h[s, t0, k0]}")
    for g, (x, y) in enumerate(zip(cap.scores.tolist(), maxes)):
        if x != max(y, 0):
            raise SanitizeError(f"kernel max {x}{of(g)} != oracle max {y}")
    return SanitizeReport(
        valid_cells=int(valid.sum()), prestart_cells=int(pre.sum()),
        garbage_cells=int(garbage.sum()), config=(T, stripes))


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
