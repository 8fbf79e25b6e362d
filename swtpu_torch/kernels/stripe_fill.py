"""The CUDA stripe kernels of the single-pair path, and their plain versions.

Counterpart of ``swtpu.kernels.pallas_fill``'s single-pair entry points:

* ``stripe_score`` (the ``stripe_score_fn`` counterpart): max score, its
  first row-major end cell and ``last_cell`` reduced on the device into one
  (4,) tensor, so the caller makes one small fetch; plus the right column
  H[:, m].
* ``stripe_fill`` (the ``stripe_fill`` counterpart with ``return_p=True``):
  the same, plus the predecessor codes as a row-major (n+1, m+1) int8 P on
  the device.

Each routes by the scoring to one of six kernels: linear match/mismatch
(K1 ``sw_stripe_score_linear``, K4 ``sw_stripe_fill_p_linear``), affine
match/mismatch (K2 ``sw_stripe_score_affine``, ``sw_stripe_fill_p_affine``)
and a substitution table with linear or affine gaps (K3
``sw_stripe_score_sub``, ``sw_stripe_fill_p_sub``).

Both run the hand-written kernels of ``csrc/stripe_fill.cu`` for a tensor
on a CUDA device and their plain PyTorch versions (``stripe_score_plain``,
``stripe_fill_plain``, built on ``scan_fill``) for a tensor on the CPU,
and nowhere else. A CUDA tensor launches the kernel or raises: a failed
build or launch is never answered by the plain version.

``launches`` counts the kernel launches and ``plain_calls`` the plain
versions' calls, so a run can show which one served it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import Scoring
from . import _cuda
from .scan_fill import check_codes, diag_to_rowmajor, embed_table, scan_fill

# widest a the kernels take; the same gate as the JAX package
MAX_WIDTH = 1 << 20
# rows per stripe (threads per block) when the caller names none
DEFAULT_STRIPE_ROWS = 256
# shared memory a block may opt into on an H100 (227 KB), less room for
# the kernel's static arrays: bounds the substitution profile, A*T int32
SUB_PROFILE_BYTES = 227 * 1024 - 1024

SCORE_KERNEL = "sw_stripe_score_linear"
FILL_P_KERNEL = "sw_stripe_fill_p_linear"
SCORE_AFFINE_KERNEL = "sw_stripe_score_affine"
FILL_P_AFFINE_KERNEL = "sw_stripe_fill_p_affine"
SCORE_SUB_KERNEL = "sw_stripe_score_sub"
FILL_P_SUB_KERNEL = "sw_stripe_fill_p_sub"
# (capture P, mode) -> the C entry of csrc/stripe_fill.cu
_KERNELS = {
    (False, "linear"): SCORE_KERNEL, (True, "linear"): FILL_P_KERNEL,
    (False, "affine"): SCORE_AFFINE_KERNEL,
    (True, "affine"): FILL_P_AFFINE_KERNEL,
    (False, "sub"): SCORE_SUB_KERNEL, (True, "sub"): FILL_P_SUB_KERNEL,
}
launches = dict.fromkeys(_KERNELS.values(), 0)
plain_calls = {"stripe_score_plain": 0, "stripe_fill_plain": 0}


def reset_counts() -> None:
    for counts in (launches, plain_calls):
        for name in counts:
            counts[name] = 0


def kernel_name(scoring: Scoring, substitution, capture_p: bool) -> str:
    """The C entry that serves this scoring on a CUDA device."""
    mode = ("sub" if substitution is not None
            else "affine" if scoring.is_affine else "linear")
    return _KERNELS[capture_p, mode]


class StripeOut(NamedTuple):
    """Results as tensors on the input's device."""
    best: torch.Tensor          # (4,) int32: max_score, max_i, max_j, last_cell
    right_col: torch.Tensor     # (n+1,) int32: H[:, m]
    P: Optional[torch.Tensor]   # (n+1, m+1) int8 row-major, stripe_fill only


def stripe_fill_supported(m: int, n: int, traceback: bool,
                          scoring: Scoring = Scoring(),
                          substitution=None) -> bool:
    """The JAX package's gates: m >= 2, n >= 1, m <= MAX_WIDTH, and
    negative penalties (``_penalties_negative``), or, with a substitution
    table, only negative gaps (``_sub_gaps_ok``)."""
    if not (m >= 2 and n >= 1 and m <= MAX_WIDTH):
        return False
    if substitution is not None:
        return _sub_gaps_ok(scoring)
    return _penalties_negative(scoring)


def _penalties_negative(scoring: Scoring) -> bool:
    if scoring.mismatch >= 0:
        return False
    return _sub_gaps_ok(scoring)


def _sub_gaps_ok(scoring: Scoring) -> bool:
    if scoring.is_affine:
        return scoring.gap_open < 0 and scoring.gap_extend < 0
    return scoring.gap < 0


def stripe_score(a: torch.Tensor, b: torch.Tensor,
                 scoring: Scoring = Scoring(), T: Optional[int] = None,
                 substitution: Optional[torch.Tensor] = None) -> StripeOut:
    """Score-only local fill of a (m,) against b (n,), int8 codes on one
    device. ``T``: rows per stripe (CUDA only). ``substitution``: an (A, A)
    int32 table S[a_code, b_code] on the same device, or None for the
    match/mismatch compare."""
    if _route(a, b, scoring, substitution) == "cpu":
        return stripe_score_plain(a, b, scoring, substitution)
    return _launch(a, b, scoring, T, substitution, capture_p=False)


def stripe_fill(a: torch.Tensor, b: torch.Tensor,
                scoring: Scoring = Scoring(), T: Optional[int] = None,
                substitution: Optional[torch.Tensor] = None) -> StripeOut:
    """``stripe_score`` plus the row-major predecessor matrix P."""
    if _route(a, b, scoring, substitution) == "cpu":
        return stripe_fill_plain(a, b, scoring, substitution)
    return _launch(a, b, scoring, T, substitution, capture_p=True)


def stripe_score_plain(a: torch.Tensor, b: torch.Tensor,
                       scoring: Scoring = Scoring(),
                       substitution: Optional[torch.Tensor] = None
                       ) -> StripeOut:
    """Plain PyTorch version of the score kernels, on any device."""
    plain_calls["stripe_score_plain"] += 1
    out = scan_fill(a, b, scoring=scoring, sub_table=_table(substitution))
    return StripeOut(_pack(out), out.right_col, None)


def stripe_fill_plain(a: torch.Tensor, b: torch.Tensor,
                      scoring: Scoring = Scoring(),
                      substitution: Optional[torch.Tensor] = None
                      ) -> StripeOut:
    """Plain PyTorch version of the fill_p kernels, on any device."""
    plain_calls["stripe_fill_plain"] += 1
    out = scan_fill(a, b, scoring=scoring, return_p=True,
                    sub_table=_table(substitution))
    P = diag_to_rowmajor(out.p_diag, b.numel(), a.numel())
    return StripeOut(_pack(out), out.right_col, P)


def _table(substitution: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if substitution is None else embed_table(substitution)


def _pack(out) -> torch.Tensor:
    return torch.stack([out.max_score, out.max_i, out.max_j,
                        out.last_cell]).to(torch.int32)


def _route(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
           substitution: Optional[torch.Tensor]) -> str:
    """Validate the inputs; return their device type, 'cpu' or 'cuda'."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {a.dtype} and {b.dtype}")
    if a.dim() != 1 or b.dim() != 1:
        raise ValueError("a and b must be 1-D code tensors")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stripe fill for device {a.device}")
    m, n = a.numel(), b.numel()
    if not stripe_fill_supported(m, n, False, scoring, substitution):
        raise ValueError(
            f"stripe kernel needs 2 <= m <= {MAX_WIDTH}, n >= 1 and negative "
            "gap penalties, and a negative mismatch without a substitution "
            f"table (m={m}, n={n}, {scoring})")
    if substitution is not None:
        S = substitution
        if S.dtype != torch.int32 or S.dim() != 2 or S.shape[0] != S.shape[1]:
            raise ValueError(f"substitution must be a square int32 table, "
                             f"got {S.dtype} {tuple(S.shape)}")
        if S.device != a.device:
            raise ValueError(f"substitution on {S.device}, codes on "
                             f"{a.device}")
        check_codes(a, b, S.shape[0])
        if max(int(S.max()), 1) * min(m, n) >= 1 << 30:
            raise ValueError("substitution scores times min(m, n) may "
                             "overflow int32")
    return a.device.type


def _stripe_rows(n: int, T: Optional[int], A: int = 0) -> int:
    """Rows per stripe: T (or the default), no more than n needs, and, for
    an alphabet of A symbols, no more than the profile's shared memory
    holds."""
    if T is None:
        T = DEFAULT_STRIPE_ROWS
    if T < 32 or T > 1024 or T % 32:
        raise ValueError(f"stripe rows T={T} must be a multiple of 32 "
                         "in [32, 1024]")
    T = min(T, -(-n // 32) * 32)        # no idle warps on short inputs
    if A:
        cap = SUB_PROFILE_BYTES // (4 * A) // 32 * 32
        if cap < 32:
            raise ValueError(f"a {A}-symbol substitution profile does not "
                             "fit in shared memory at 32 rows per stripe")
        T = min(T, cap)
    return T


def _launch(a: torch.Tensor, b: torch.Tensor, scoring: Scoring,
            T: Optional[int], sub: Optional[torch.Tensor],
            capture_p: bool) -> StripeOut:
    name = kernel_name(scoring, sub, capture_p)
    m, n = a.numel(), b.numel()
    T = _stripe_rows(n, T, 0 if sub is None else sub.shape[0])
    stripes = -(-n // T)
    dev = a.device
    i32 = torch.int32
    a, b = a.contiguous(), b.contiguous()
    sync = torch.zeros(stripes + 1, dtype=i32, device=dev)
    bnd = torch.empty(max(stripes - 1, 1) * (m + 1), dtype=i32, device=dev)
    best = torch.empty((stripes, 4), dtype=i32, device=dev)
    right = torch.zeros(n + 1, dtype=i32, device=dev)
    # the F row between stripes; the linear substitution entry takes null
    bnd_f = torch.empty_like(bnd) if scoring.is_affine else None
    bnds = [bnd.data_ptr()]
    if sub is not None or scoring.is_affine:
        bnds.append(None if bnd_f is None else bnd_f.data_ptr())
    if sub is not None:
        sub = sub.contiguous()
        model = [sub.data_ptr(), sub.shape[0], int(scoring.is_affine),
                 scoring.gap, scoring.gap_open, scoring.gap_extend]
    elif scoring.is_affine:
        model = [scoring.match, scoring.mismatch, scoring.gap_open,
                 scoring.gap_extend]
    else:
        model = [scoring.match, scoring.mismatch, scoring.gap]
    args = [a.data_ptr(), b.data_ptr(), m, n, *model, T, sync.data_ptr(),
            *bnds, best.data_ptr(), right.data_ptr()]
    P = None
    if capture_p:
        P = torch.zeros((n + 1, m + 1), dtype=torch.int8, device=dev)
        args.append(P.data_ptr())
    lib = _cuda.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda.check(name, getattr(lib, name)(*args, stream))
    launches[name] += 1
    return StripeOut(_reduce(best, right, n), right, P)


def _reduce(best: torch.Tensor, right: torch.Tensor, n: int) -> torch.Tensor:
    """(stripes, 4) per-stripe firsts -> (4,) on the device: the first
    stripe holding the global max wins (its rows come first)."""
    scores = best[:, 0]
    top = scores.max()
    rank = torch.arange(best.shape[0], dtype=torch.int32, device=best.device)
    row = best[torch.where(scores == top, rank, best.shape[0]).min()]
    has = top > 0
    return torch.stack([top.clamp(min=0), torch.where(has, row[1], 0),
                        torch.where(has, row[2], 0), right[n]]).to(torch.int32)
