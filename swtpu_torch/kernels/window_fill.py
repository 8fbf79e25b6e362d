"""The CUDA kernel of the database search's window scorer, and its plain
version.

Counterpart of ``swtpu.kernels.pallas_fill``'s ``batch_fill_raw`` and
``batch_score_fn`` (K6): B reads, (B, rlen) int8 codes with the -3
sentinel after each read's end, against one window (W,) int8 of reference
codes that every read shares. Returns ``BatchHits``: each read's max
score, the 1-based row of its first row-major max in the read and the
1-based window column of it, (0, 0, 0) for a read with no positive cell,
as (B,) int32 tensors on the input's device.

* ``window_score`` runs the kernel for tensors on a CUDA device and
  ``window_score_plain``, the batched sweep ``batch_scan_fill`` of the
  window against every read, for tensors on the CPU, and nowhere else; a
  failed build or launch on a card raises.
* ``WindowScorer`` is the same for one batch of reads against many
  windows of one width, as the search sweeps them: it prepares the reads
  and any scratch once; each window then costs one launch (and, on the
  register-blocked route, a clear of the counters and a reduce) on the
  device, with no host sync.

Two kernels, routed by shape in ``WindowScorer.__init__``:

* reads of at most 32 * WARP_MAX_ROWS rows whose substitution profile
  fits (``warp_rows``) take the warp-per-read scorer
  ``sw_window_warp_linear``, ``_affine``, ``_sub``
  (``csrc/window_warp.cu``): one warp a read, R = ceil(rlen / 32) rows a
  lane, the read's answer reduced in the warp;
* longer reads take the shared-window batch form of the register-blocked
  stripe, ``sw_window_rb_linear``, ``_affine``, ``_sub``
  (``csrc/stripe_rb_window.cu``): each read a pair of its own, cut into
  stripes of T threads of R rows and C columns a step (``rb_shape``'s
  'window' kind), every pair reading the one window in place; the reads
  as they are, each read's stripe firsts reduced by
  ``pairs_fill._reduce_stripes``.

The stripe template's ``sw_window_score_linear``, ``_affine``, ``_sub``
(``csrc/window_fill.cu``) is the earlier design of both, on no route:
the private ``_TemplateWindow`` builds it as their yardstick. It packs
the reads into one stripe chain, padded with -3 rows to the next length
that a stripe height cuts (``window_rows``), so that no stripe chain
crosses a read's first row: such rows never match and only decay, so they
never hold or tie a read's max.

``launches`` counts each entry's launches and ``plain_calls`` the plain
version's calls; ``pairs_fill.reset_counts()`` zeroes them with the other
kernels' counters.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import Scoring
from . import stripe_fill as sf
from .pairs_fill import (BatchHits, _reduce_rows, _reduce_stripes,
                         _scratch, chain_cutting_rows)
from .scan_fill import batch_scan_fill, check_codes

WINDOW_KERNELS = {"linear": "sw_window_score_linear",
                  "affine": "sw_window_score_affine",
                  "sub": "sw_window_score_sub"}
WARP_KERNELS = {"linear": "sw_window_warp_linear",
                "affine": "sw_window_warp_affine",
                "sub": "sw_window_warp_sub"}
# the register-blocked K6 by mode, for reads longer than warp_rows takes
WINDOW_RB_KERNELS = {mode: f"sw_window_rb_{mode}"
                     for mode in ("linear", "affine", "sub")}
WARP_MAX_ROWS = 16      # R_max: rows a lane, kMaxRows in window_warp.cu
WARPS_PER_BLOCK = 4     # reads a block, kWarps there
launches = dict.fromkeys([*WINDOW_RB_KERNELS.values(),
                          *WINDOW_KERNELS.values(), *WARP_KERNELS.values()],
                         0)
plain_calls = {"window_score_plain": 0}


def window_kernel_name(scoring: Scoring, substitution) -> str:
    """The stripe template's K6 entry of this scoring, the earlier design,
    on no route (``_TemplateWindow``)."""
    return WINDOW_KERNELS[sf._mode(scoring, substitution)]


def window_rb_name(scoring: Scoring, substitution) -> str:
    """The register-blocked K6 entry of this scoring, which a card runs for
    reads that ``warp_rows`` refuses."""
    return WINDOW_RB_KERNELS[sf._mode(scoring, substitution)]


def warp_kernel_name(scoring: Scoring, substitution) -> str:
    """The warp-per-read K6 entry that serves this scoring."""
    return WARP_KERNELS[sf._mode(scoring, substitution)]


def warp_rows(rlen: int, A: int = 0) -> Optional[int]:
    """R = ceil(rlen / 32), the rows a lane of the warp-per-read K6 holds
    for reads of rlen rows, or None where that scorer does not take them:
    R above WARP_MAX_ROWS, or, for an alphabet of A letters, a block's
    profile (WARPS_PER_BLOCK x (A + 1) x R x 32 int32) beyond the opt-in
    shared memory. None routes the reads to the register-blocked K6."""
    R = -(-rlen // 32)
    if R > WARP_MAX_ROWS:
        return None
    if A and WARPS_PER_BLOCK * (A + 1) * R * 32 * 4 > sf.SUB_PROFILE_BYTES:
        return None
    return R


def window_route_name(rlen: int, scoring: Scoring, substitution) -> str:
    """The launch counter of the K6 entry that a card runs for reads of
    rlen rows under this scoring."""
    A = 0 if substitution is None else substitution.shape[0]
    if warp_rows(rlen, A) is None:
        return window_rb_name(scoring, substitution)
    return warp_kernel_name(scoring, substitution)


def window_rows(rlen: int, B: int, T: Optional[int] = None,
                A: int = 0) -> tuple:
    """(padded read length, stripe height) of the stripe template's K6
    for B reads of rlen rows: the smallest length from rlen on that a
    stripe height cuts (``chain_cutting_rows``: 150 -> 152 at T = 608, 152
    -> 152), at that height unless ``T`` names one."""
    rpad = rlen
    while chain_cutting_rows(rpad, A) is None:
        rpad += 1
    if T is None:
        T = chain_cutting_rows(rpad, A)
    return rpad, sf._stripe_rows(B * rpad, T, A)


def check_window(reads: torch.Tensor, window: torch.Tensor,
                 scoring: Scoring,
                 substitution: Optional[torch.Tensor]) -> str:
    """Validate reads (B, rlen) and a window (W,) of int8 codes on one
    device, as ``stripe_fill._route`` does a pair, the codes of every read
    included; return the device type, 'cpu' or 'cuda'."""
    if reads.dim() != 2 or reads.shape[0] < 1 or window.dim() != 1:
        raise ValueError(f"reads must be (B, rlen) with B >= 1 and the "
                         f"window (W,), got {tuple(reads.shape)} and "
                         f"{tuple(window.shape)}")
    dev = sf._route(window, reads[0], scoring, substitution)
    if substitution is not None:
        check_codes(window, reads, substitution.shape[0])
    return dev


def window_score(reads: torch.Tensor, window: torch.Tensor,
                 scoring: Scoring = Scoring(), T: Optional[int] = None,
                 substitution: Optional[torch.Tensor] = None) -> BatchHits:
    """K6: score B reads (B, rlen) against one window (W,), int8 codes on
    one device. ``T``: threads per block of the register-blocked route
    (CUDA, reads longer than ``warp_rows`` takes; each holding R rows,
    ``rb_shape``; unused on the warp route).
    ``substitution``: an (A, A) int32 table S[window code, read code] on
    the same device, or None for match/mismatch."""
    dev = check_window(reads, window, scoring, substitution)
    if dev == "cpu":
        return window_score_plain(reads, window, scoring, substitution)
    return WindowScorer(reads, window.numel(), scoring, T,
                        substitution)(window)


def window_score_plain(reads: torch.Tensor, window: torch.Tensor,
                       scoring: Scoring = Scoring(),
                       substitution: Optional[torch.Tensor] = None
                       ) -> BatchHits:
    """Plain PyTorch version of K6, on any device: the batched sweep of
    the window against every read."""
    plain_calls["window_score_plain"] += 1
    B, W = reads.shape[0], window.numel()
    return BatchHits(*batch_scan_fill(window.expand(B, W), reads,
                                      scoring=scoring,
                                      sub_table=sf._table(substitution)))


class WindowScorer:
    """K6 for one batch of reads against many windows of width W.

    ``reads``: (B, rlen) int8 codes on the device the windows will lie on;
    ``substitution``: an (A, A) int32 table there, or None. The caller
    checks the codes of the reads and of every window (``check_window``);
    each window is a (W,) int8 tensor on the reads' device. On a CUDA
    device the route is fixed here by the read length (``warp_rows``):
    ``form`` 'warp', the warp-per-read scorer, or 'rb', the
    register-blocked one (``_RbWindow``, ``T`` its threads per block),
    which allocates its scratch once; both take the reads as they are. On
    the CPU each call runs the plain version."""

    def __init__(self, reads: torch.Tensor, W: int,
                 scoring: Scoring = Scoring(), T: Optional[int] = None,
                 substitution: Optional[torch.Tensor] = None):
        self.reads, self.W = reads, W
        self.scoring = scoring
        self.sub = None if substitution is None else substitution.contiguous()
        self.cpu = reads.device.type == "cpu"
        if self.cpu:
            return
        B, rlen = reads.shape
        A = 0 if self.sub is None else self.sub.shape[0]
        self.R = warp_rows(rlen, A)            # rows a lane of the warp route
        if self.R is None:
            self.form = "rb"
            self._rb = _RbWindow(reads, W, scoring, self.sub, T)
            self.name = self._rb.name
            return
        if B * rlen > (1 << 31) - 1:
            raise ValueError(f"{B} x {rlen} read rows overflow int32")
        self.form = "warp"
        self.reads = reads.contiguous()
        self.name = warp_kernel_name(scoring, self.sub)

    def __call__(self, window: torch.Tensor) -> BatchHits:
        if window.shape != (self.W,):
            raise ValueError(f"window of shape {tuple(window.shape)}, the "
                             f"scorer takes ({self.W},)")
        if self.cpu:
            return window_score_plain(self.reads, window, self.scoring,
                                      self.sub)
        if self.form == "rb":
            return self._rb(window)
        window = window.contiguous()
        B, rlen = self.reads.shape
        # a new output each call: the caller may hold the last one
        out = torch.empty((3, B), dtype=torch.int32, device=window.device)
        args = [window.data_ptr(), self.reads.data_ptr(), B, self.W, rlen,
                *sf._model(self.scoring, self.sub), out.data_ptr()]
        sf._call(self.name, window.device, args, self.name, launches)
        return BatchHits(*out)


class _RbWindow:
    """The register-blocked K6 (``sw_window_rb_*``) for one batch of reads
    (B, rlen) on a CUDA device against windows of width W, at
    ``rb_shape``'s 'window' (T, R, C), None taking its defaults: the
    scratch allocated once, each call a clear of the counters, one launch
    and ``_reduce_stripes`` on the stream. ``WindowScorer``'s route for
    reads that ``warp_rows`` refuses; chip_smoke.py sweeps (T, R, C)
    through it."""

    def __init__(self, reads: torch.Tensor, W: int, scoring: Scoring,
                 sub: Optional[torch.Tensor], T: Optional[int] = None,
                 R: Optional[int] = None, C: Optional[int] = None):
        B, rlen = reads.shape
        A = 0 if sub is None else sub.shape[0]
        self.W, self.scoring, self.sub = W, scoring, sub
        self.mode = sf._mode(scoring, sub)
        self.T, self.R, self.C = sf.rb_shape(rlen, T, R, C, self.mode, A,
                                             "window")
        S = -(-rlen // (self.T * self.R))
        # the kernel's int sums: rows, columns, blocks and read rows (the
        # boundary rows' size_t index, under B * S * (W + 1), then stays
        # below 2^52)
        if (rlen > (1 << 31) - 1 - self.T * self.R
                or W > min(sf.MAX_WIDTH, (1 << 31) - 1 - self.T * self.C)
                or B * S > (1 << 31) - 1 or B * rlen > (1 << 31) - 1):
            raise ValueError(
                f"{B} reads of {rlen} rows ({S} stripes of "
                f"{self.T * self.R} rows each) against {W} columns "
                "overflow the kernel's int32 indices")
        dev, i32 = reads.device, torch.int32
        self.reads = reads.contiguous()
        self.sync = torch.zeros(1 + B * S, dtype=i32, device=dev)
        self.bnd, self.bnd_f = _scratch(B * (S - 1), W, scoring.is_affine,
                                        dev)
        self.best = torch.empty((B, S, 4), dtype=i32, device=dev)
        self.name = window_rb_name(scoring, sub)

    def __call__(self, window: torch.Tensor) -> BatchHits:
        window = window.contiguous()
        B, rlen = self.reads.shape
        # the ticket and progress counters, cleared on the stream
        self.sync.zero_()
        # the F rows handed between stripes; the linear table entry takes
        # null
        bnds = [self.bnd.data_ptr()] + (
            [sf._ptr(self.bnd_f)] if self.mode != "linear" else [])
        args = [window.data_ptr(), self.reads.data_ptr(), B, self.W, rlen,
                *sf._model(self.scoring, self.sub), self.T, self.R, self.C,
                self.sync.data_ptr(), *bnds, self.best.data_ptr()]
        sf._call(self.name, window.device, args, self.name, launches)
        return _reduce_stripes(self.best)


class _TemplateWindow:
    """The stripe template's K6 (``sw_window_score_*``), the earlier design
    of both routes and on none, for one batch of reads (B, rlen) on a CUDA
    device against windows of width W: the reads packed into one stripe
    chain of ``T`` rows a stripe (``window_rows``), the scratch allocated
    once. chip_smoke.py's and the card tests' yardstick."""

    def __init__(self, reads: torch.Tensor, W: int, scoring: Scoring,
                 sub: Optional[torch.Tensor], T: Optional[int] = None):
        B, rlen = reads.shape
        A = 0 if sub is None else sub.shape[0]
        self.W, self.scoring, self.sub = W, scoring, sub
        rpad, self.T = window_rows(rlen, B, T, A)
        if B * rpad > (1 << 31) - 1 - 1024:
            raise ValueError(f"{B} x {rpad} packed read rows overflow int32")
        dev, i32 = reads.device, torch.int32
        self.padded = torch.full((B, rpad), -3, dtype=torch.int8, device=dev)
        self.padded[:, :rlen] = reads
        S = -(-(B * rpad) // self.T)
        self.sync = torch.zeros(1 + S, dtype=i32, device=dev)
        self.bnd = torch.empty(max(S - 1, 1) * (W + 1), dtype=i32,
                               device=dev)
        self.bnd_f = (torch.empty_like(self.bnd) if scoring.is_affine
                      else None)
        self.row_best = torch.empty((B, rpad, 2), dtype=i32, device=dev)
        self.right = torch.empty(B * rpad + 1, dtype=i32, device=dev)
        self.name = window_kernel_name(scoring, sub)

    def __call__(self, window: torch.Tensor) -> BatchHits:
        window = window.contiguous()
        B, rpad = self.padded.shape
        self.sync.zero_()
        bnds = [self.bnd.data_ptr()]
        if self.sub is not None or self.scoring.is_affine:
            bnds.append(sf._ptr(self.bnd_f))
        args = [window.data_ptr(), self.padded.data_ptr(), B, self.W, rpad,
                *sf._model(self.scoring, self.sub), self.T,
                self.sync.data_ptr(), *bnds, self.row_best.data_ptr(),
                self.right.data_ptr()]
        sf._call(self.name, window.device, args, self.name, launches)
        return _reduce_rows(self.row_best)
