"""Top-level alignment engine: ``align()`` and ``score()`` for one pair.

Counterpart of ``swtpu.engine.align`` with an explicit ``device``. Plans:
'stripe' (the hand-written CUDA kernels, on a CUDA device) and 'scan' (the
PyTorch sweep, on any device); 'auto' lets ``dispatch.plan.choose_exec``
decide. A request for ``device='cuda'`` on a machine without a card
raises; it never carries on on the CPU.

Scoring: linear or affine (Gotoh) gaps, with the match/mismatch compare or,
given ``substitution=``, an (A, A) table S[a_code, b_code] such as
``core.substitution.BLOSUM62`` (protein codes over ``PROTEIN_ALPHABET``).

Traceback up to ``full_p_max_cells`` walks the full predecessor matrix P
on the host (``oracle.backtrack``), the JAX package's exact route. Above
it, ``traceback_method='auto'`` takes the lean route of
``engine.traceback``: ``windowed`` (locate by a forward score pass and an
anchored reverse NW pass, refill the window with P and walk it on the
device), or ``hirschberg`` (linear space), either returning the strings
without ``path``; on a card its passes launch the kernels whatever the
plan, so it takes the scorings they take (negative penalties) and raises
for the others. ``config.band`` keeps the cells with |i - j| <= band, on
score-only calls too, and always takes full P.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core import oracle
from ..core.config import EngineConfig, Scoring
from ..core.encode import DNA_ALPHABET, encode
from ..core.substitution import check_table
from ..dispatch.plan import choose_exec
from ..kernels.scan_fill import diag_to_rowmajor, embed_table, scan_fill
from ..kernels.stripe_fill import (stripe_fill, stripe_fill_supported,
                                   stripe_score)
from . import traceback as tb


@dataclasses.dataclass
class Alignment:
    """Structured result record."""

    max_score: int
    max_i: int                 # padded row index of the first global max
    max_j: int                 # padded col index
    last_cell: int             # H[n, m] — the reference's H[m*n-1] invariant
    aligned_a: Optional[str] = None
    aligned_b: Optional[str] = None
    path: Optional[list] = None          # row-major indices, end-first
    H: Optional[np.ndarray] = None       # (n+1, m+1) when return_matrices
    P: Optional[np.ndarray] = None

    @property
    def max_pos(self) -> int:
        """Row-major padded index — the reference's maxPos."""
        if self.P is not None:
            m1 = self.P.shape[1]
        else:
            m1 = self._m1
        return self.max_i * m1 + self.max_j

    _m1: int = 0  # padded width, set by the engine


def _as_codes(seq, alphabet: str = DNA_ALPHABET) -> np.ndarray:
    if isinstance(seq, str):
        return encode(seq, alphabet)
    return np.asarray(seq, dtype=np.int8)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device for a request; raises for 'cuda' without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the scan plan")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


def _resolve_traceback_method(m: int, n: int, config: EngineConfig) -> str:
    """'auto' -> 'full' up to full_p_max_cells, 'windowed' above; a banded
    problem always takes 'full'."""
    method = config.traceback_method
    if method == "auto":
        method = "full" if m * n <= config.full_p_max_cells else "windowed"
    if config.band is not None:
        method = "full"
    return method


def align(
    a: Union[str, np.ndarray],
    b: Union[str, np.ndarray],
    scoring: Scoring = Scoring(),
    config: EngineConfig = EngineConfig(),
    *,
    traceback: Optional[bool] = None,
    return_matrices: bool = False,
    plan: Optional[str] = None,
    substitution: Optional[np.ndarray] = None,
    alphabet: str = DNA_ALPHABET,
    device: Union[str, torch.device] = "cuda",
) -> Alignment:
    """Align sequence ``a`` (columns, length m) against ``b`` (rows, length
    n) on ``device``. Plans: 'stripe', 'scan', or None/'auto'.
    ``substitution``: optional (A, A) integer table S[a_code, b_code] in
    place of the match/mismatch compare; codes must then lie in [-3, A)."""
    dev = resolve_device(device)
    a_codes = _as_codes(a, alphabet)
    b_codes = _as_codes(b, alphabet)
    m, n = len(a_codes), len(b_codes)
    want_tb = config.traceback if traceback is None else traceback
    sub_np = None if substitution is None else check_table(substitution)

    if m == 0 or n == 0:
        # Degenerate: an empty sequence aligns to nothing (all-zero matrix).
        res = Alignment(max_score=0, max_i=0, max_j=0, last_cell=0)
        if return_matrices:
            res.H = np.zeros((n + 1, m + 1), np.int32)
            res.P = np.zeros((n + 1, m + 1), np.int8)
        res._m1 = m + 1
        return res

    if plan in (None, "auto"):
        plan = choose_exec(m, n, config, scoring, want_tb, dev,
                           substitution=sub_np).plan
    if plan not in ("stripe", "scan"):
        raise ValueError(f"unknown plan {plan!r} (use 'stripe' or 'scan')")

    # memory-lean traceback: locate + windowed refill / Hirschberg, no
    # full P (engine/traceback.py); like the JAX package, it serves every
    # plan, on a card through the kernels
    method = _resolve_traceback_method(m, n, config)
    if want_tb and method in ("windowed", "hirschberg") \
            and not return_matrices:
        lean = tb.windowed if method == "windowed" else tb.hirschberg
        got = lean(a_codes, b_codes, scoring, sub=sub_np, alphabet=alphabet,
                   device=dev)
        if got is None:
            res = Alignment(max_score=0, max_i=0, max_j=0, last_cell=0)
        else:
            score_v, loc, ra, rb = got
            res = Alignment(max_score=score_v, max_i=loc.end_i,
                            max_j=loc.end_j, last_cell=loc.last_cell,
                            aligned_a=ra, aligned_b=rb)
        res._m1 = m + 1
        return res

    if plan == "stripe" and (return_matrices or not stripe_fill_supported(
            m, n, want_tb, scoring, sub_np)):
        plan = "scan"     # the stripe kernels never materialize H

    a_t = torch.from_numpy(a_codes).to(dev)
    b_t = torch.from_numpy(b_codes).to(dev)
    sub_t = None if sub_np is None else torch.from_numpy(sub_np).to(dev)
    H = P = None
    if plan == "stripe":
        fill = stripe_fill if want_tb else stripe_score
        out = fill(a_t, b_t, scoring, T=config.stripe_rows,
                   substitution=sub_t, band=config.band)
        vals = out.best.tolist()                         # one small fetch
        if want_tb:
            P = out.P.cpu().numpy()
    else:
        table = None if sub_t is None else embed_table(sub_t)
        out = scan_fill(a_t, b_t, scoring=scoring,
                        return_p=want_tb or return_matrices,
                        return_h=return_matrices, band=config.band,
                        sub_table=table)
        vals = torch.stack([out.max_score, out.max_i, out.max_j,
                            out.last_cell]).tolist()
        if out.p_diag is not None:
            P = diag_to_rowmajor(out.p_diag, n, m).cpu().numpy()
        if out.h_diag is not None:
            H = diag_to_rowmajor(out.h_diag, n, m).cpu().numpy()

    s, bi, bj, last = vals
    res = Alignment(max_score=s, max_i=bi, max_j=bj, last_cell=last,
                    H=H if return_matrices else None,
                    P=P if return_matrices else None)
    res._m1 = m + 1
    if want_tb and P is not None and res.max_score > 0:
        max_pos = res.max_i * (m + 1) + res.max_j
        res.path = oracle.backtrack(P, max_pos)
        res.aligned_a, res.aligned_b = oracle.alignment_strings(
            a_codes, b_codes, P, max_pos, alphabet=alphabet)
    return res


def score(
    a: Union[str, np.ndarray],
    b: Union[str, np.ndarray],
    scoring: Scoring = Scoring(),
    config: EngineConfig = EngineConfig(),
    *,
    plan: Optional[str] = None,
    substitution: Optional[np.ndarray] = None,
    alphabet: str = DNA_ALPHABET,
    device: Union[str, torch.device] = "cuda",
) -> int:
    """Score-only fast path (the -DSKIP_BACKTRACK benchmark mode).

    The max score is symmetric under transposing the DP matrix, so thin
    problems are swapped to put the long side in rows, where the stripe
    wavefront's parallelism is. Positions are NOT symmetric (tie order),
    which is why align() never does this. A substitution table is
    transposed with the pair, so S[a_code, b_code] keeps its meaning."""
    a_codes = _as_codes(a, alphabet)
    b_codes = _as_codes(b, alphabet)
    sub = substitution
    if len(a_codes) > 2 * len(b_codes):
        a_codes, b_codes = b_codes, a_codes
        if sub is not None:
            sub = np.asarray(sub).T
    return align(a_codes, b_codes, scoring, config, traceback=False,
                 plan=plan, substitution=sub, device=device).max_score
