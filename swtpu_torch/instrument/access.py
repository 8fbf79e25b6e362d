"""Memory-traffic accounting on the H100: an analytic model of the bytes
each plan moves, and the card's allocator as its measurement.

Counterpart of ``swtpu.instrument.access``. The JAX package models its
Pallas stripe and XLA scan and checks them against the compiler's memory
analysis; here the plans are the ones the port launches, and the check is
``torch.cuda.max_memory_allocated`` around a call:

* ``stripe_traffic`` models the register-blocked stripe of
  ``kernels/stripe_fill.py`` (K1-K3 score-only, K4 with ``traceback``) at
  the (T, R, C) ``rb_shape`` gives it, reading every byte off its
  wrapper: the codes (each stripe stages all of a; b once) and the table,
  the int32 hand-off rows ``bnd`` (``bnd_f`` too in affine), the stripe
  tickets and progress counters ``sync`` and the per-stripe firsts
  ``best`` (``_rb_scratch``), the right column, and K4's P at its padded
  row pitch (``p_matrix``). ``hbm_*`` count global-memory traffic (the
  H100's HBM3, or its L2 where a stripe re-reads what another loaded);
  ``resident_bytes`` is the on-chip working set of the blocks in flight:
  each thread's registers (a model of the tile's live values) and each
  block's shared memory (the query ring and chunks of ``stripe_rb.cuh``,
  the affine F arrays and the table's profile).
* ``scan_traffic`` models the plain sweep ``kernels/scan_fill.py`` as it
  runs: a Python loop whose every tensor op reads its operands from and
  writes its result to device memory (the bytes a cell, counted op by op
  from the loop), over lane vectors it allocates once (its
  ``resident_bytes``: it keeps no on-chip state between ops).
* ``reference_v61_traffic`` is the reference's per-diagonal transfer
  pathology, pure arithmetic.
* ``measured_memory(fn, *args)`` runs ``fn`` on the card and reads the
  caching allocator's peak; ``validate_model`` puts each plan's model
  beside it, and ``launched_resident`` reads the on-chip set of the
  launch the model describes off ptxas and the launcher.

What is measured, and so checked, is P's bytes, each call's scratch and
the on-chip set. ``hbm_read_bytes`` and ``hbm_write_bytes`` are the
model's alone: no counter of the card's DRAM traffic is read, so a
roofline share built on them is a modelled one.

``compiled_cost`` is the counterpart of the JAX package's, which reads
XLA's cost analysis of a jitted callable: what the compiler says of one
register-blocked C entry's instantiation, read from the kept build log's
``ptxas -v`` lines (registers, static shared memory, stack frame, spill
stores and loads; ``ptxas_facts``). No compiler counts a hand-written
fill's operations or bytes; those are ``chip_smoke.py``'s bound.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

import numpy as np
import torch

from ..core.config import EngineConfig, Scoring
from ..kernels import _cuda
from ..kernels.stripe_fill import (P_PITCH_ALIGN, RB_ENTRY_FLAGS, RB_KERNELS,
                                   RB_P_KERNELS, _mode, rb_flags, rb_kind,
                                   rb_shape)
from .metrics import _tensors

# the H100's SMs: at most this many stripes run at once, a block an SM or
# more
H100_SMS = 132
# the caching allocator's granularity: every allocation holds a multiple
ALLOC_BLOCK = 512
# the largest number of the wrapper's reduction (``stripe_fill._reduce``)
# tensors alive at once: the 0-d max, the stripe ranks, the comparison,
# the masked ranks, their min and the winning row (then the flag, the
# clamp, two selects and the stack)
REDUCE_TENSORS = 8
# the register-blocked kernel's static shared memory (stripe_rb.cuh):
# s_stripe, s_best, s_k; the query ring (kRing = 8192 bytes); the row
# above's chunk [2][kPublish] and the last row's chunk [kPublish]; plus
# s_edge, 2 * (kMaxThreads / 32) * C ints
_STATIC_SMEM = 3 * 4 + 8192 + 3 * 32 * 4
_EDGE_INTS_PER_COL = 2 * 512 // 32
# the plain sweep's bytes a cell, read and written, counted op by op from
# scan_fill's loop (int32 vectors 4 bytes a lane, masks 1, int8 P 1):
# linear local score-only, 16 ops (the compare and select of the score,
# DIAG, the two gaps, the carries, the clamp, the two takes and selects,
# the lane's best and its step)
_SCAN_RW = {"linear": (97, 52)}
# affine: the two gap maxima, their extension tests and the E/F carries in
# place of the two gaps; a table: the index add and the gather in place of
# the compare and select; P: the DIAG test, the select, the narrowing, the
# two fills and the store; affine P adds the state bits
_SCAN_AFFINE_RW = (56, 34)
_SCAN_SUB_RW = (7, 3)
_SCAN_P_RW = (16, 13)
_SCAN_AFFINE_P_RW = (28, 26)


@dataclasses.dataclass
class TrafficReport:
    plan: str
    cells: int
    hbm_read_bytes: int          # analytic, unmeasured: bytes read from
    hbm_write_bytes: int         # and written to device memory
    resident_bytes: int          # peak on-chip (or device) working set
    bytes_per_cell: float
    notes: str
    # the predecessor matrix's allocation; the device memory the call
    # holds beyond its inputs and outputs, as the allocator holds it
    p_bytes: int = 0
    scratch_bytes: int = 0

    def summary(self) -> str:
        return (f"[{self.plan}] {self.cells/1e9:.2f} Gcells: "
                f"read {self.hbm_read_bytes/1e6:.1f} MB, "
                f"write {self.hbm_write_bytes/1e6:.1f} MB, "
                f"resident {self.resident_bytes/1e3:.0f} KB, "
                f"{self.bytes_per_cell:.4f} B/cell — {self.notes}")


def _alloc(nbytes: int) -> int:
    """What the caching allocator holds for an allocation of nbytes."""
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def rb_registers(R: int, C: int, traceback: bool = False,
                 affine: bool = False) -> int:
    """A model of the registers a thread of the register-blocked stripe
    holds: its R rows' H, diagonal and best (6 words a row; with affine
    gaps also E and F, 9), its C columns of the query and the chunk (2 a
    column, 4 with affine gaps), the row's codes of P in traceback (one
    word a row), and 32 of addresses, indices and loop state; at most
    255."""
    per_row = 9 if affine else 6
    per_col = 4 if affine else 2
    return min(255, 32 + per_row * R + per_col * C + (R if traceback else 0))


def rb_shared_bytes(mode: str, R: int, C: int, T: int, A: int = 0,
                    affine: bool = False) -> int:
    """Shared memory of a register-blocked block: the static arrays, and
    the dynamic ones the launcher sizes (``stripe_rb.cuh``): F's edge
    slots and chunks in affine, the table's profile of (min(A, 128) + 1) *
    R * T ints."""
    dyn = 0
    if affine:
        dyn += (_EDGE_INTS_PER_COL * C + 3 * 32) * 4
    if mode == "sub":
        dyn += (min(A, 128) + 1) * R * T * 4
    return _STATIC_SMEM + _EDGE_INTS_PER_COL * C * 4 + dyn


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers.*?(\d+) bytes smem")


def rb_symbol(mode: str, R: int, C: int, traceback: bool = False,
              affine: bool = False) -> str:
    """The mangled-name fragment of the register-blocked instantiation
    that a score-only (K1-K3) or, with ``traceback``, a K4 launch of
    ``mode`` at tile (R, C) runs: ``stripe_rb_kernel<R, C, ...>`` with its
    entry's flags (``stripe_fill.rb_flags``; a table's entry takes either
    gap model: ``affine``)."""
    entry = (RB_P_KERNELS if traceback else RB_KERNELS)[mode]
    return (f"stripe_rb_kernelILi{R}ELi{C}E"
            + "".join(f"Lb{int(f)}E" for f in rb_flags(entry, affine)))


def ptxas_usage(log: str) -> dict:
    """{mangled entry: (registers, static shared bytes)} from the output of
    ``nvcc -Xptxas -v`` (the kernel build's log, ``_cuda.BUILD.log``)."""
    return {k: (v["registers"], v["smem_bytes"])
            for k, v in ptxas_facts(log).items()}


_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")


def ptxas_facts(log: str) -> dict:
    """{mangled entry: {'registers', 'smem_bytes', 'stack_bytes',
    'spill_store_bytes', 'spill_load_bytes'}} from the output of ``nvcc
    -Xptxas -v``; the last three None where ptxas printed no frame line
    for the entry."""
    out, entry, frame = {}, None, (None, None, None)
    for ln in log.splitlines():
        got = _PTXAS_ENTRY.search(ln)
        if got:
            entry, frame = got.group(1), (None, None, None)
            continue
        got = _PTXAS_FRAME.search(ln)
        if got and entry:
            frame = tuple(int(x) for x in got.groups())
            continue
        got = _PTXAS_USED.search(ln)
        if got and entry:
            out[entry] = {"registers": int(got.group(1)),
                          "smem_bytes": int(got.group(2)),
                          "stack_bytes": frame[0],
                          "spill_store_bytes": frame[1],
                          "spill_load_bytes": frame[2]}
            entry = None
    return out


def compiled_cost(entry: str, log: Optional[str] = None) -> Optional[dict]:
    """The compiler's own facts of the instantiation that the
    register-blocked C entry ``entry`` (``stripe_fill.RB_ENTRY_FLAGS``)
    launches at its kind's default tile (``rb_kind``, ``rb_shape``; a
    table's entry in its linear-gap instantiation, as ``rb_flags`` takes
    it): ``ptxas_facts``' figures with the entry and its mangled name,
    read from ``log`` (default: this process's build log,
    ``_cuda.BUILD.log``). None where there is no log (this process loaded
    a library it did not build, or built none) or the log holds no such
    instantiation. Raises ValueError for an entry that is not
    register-blocked."""
    form, mode = entry.rsplit("_", 1) if "_" in entry else (entry, "")
    if form + "_{mode}" not in RB_ENTRY_FLAGS \
            or mode not in ("linear", "affine", "sub"):
        raise ValueError(f"{entry!r} is no register-blocked C entry")
    log = _cuda.BUILD.log if log is None else log
    if not log:
        return None
    _, R, C = rb_shape(1 << 20, mode=mode, kind=rb_kind(entry))
    frag = (f"stripe_rb_kernelILi{R}ELi{C}E"
            + "".join(f"Lb{int(f)}E" for f in rb_flags(entry)))
    for name, facts in ptxas_facts(log).items():
        if frag in name:
            return {"entry": entry, "symbol": name, **facts}
    return None


def launch_smem(mode: str, R: int, C: int, T: int, A: int = 0,
                affine: bool = False) -> int:
    """The dynamic shared memory a register-blocked block of ``mode`` (K1-K4
    and the forms beside them, not the capture) asks for at tile (R, C)
    and T threads, with a table of A symbols and, for a table, ``affine``
    gaps: the launcher's own figure, read from the kernel library (the C
    entry ``sw_stripe_rb_smem``), which this builds at first use."""
    got = _cuda.library().sw_stripe_rb_smem(
        R, C, int(affine or mode == "affine"), int(mode == "sub"), 0, A, T)
    if got < 0:
        raise ValueError(f"no register-blocked tile has C = {C}")
    return got


def launched_resident(usage: dict, m: int, n: int,
                      T: Optional[int] = None, R: Optional[int] = None,
                      C: Optional[int] = None, traceback: bool = False,
                      scoring: Scoring = Scoring(),
                      substitution=None) -> int:
    """The on-chip working set of the launch ``stripe_traffic`` models,
    measured rather than modelled: 4 bytes x ptxas's registers
    (``ptxas_usage``) of the instantiation it runs x T threads, plus the
    static shared memory ptxas reports and the dynamic shared memory the
    launcher asks for (``launch_smem``), a block, times the stripes in
    flight."""
    A = 0 if substitution is None else len(substitution)
    mode = _mode(scoring, substitution)
    T, R, C = rb_shape(n, T, R, C, mode, A,
                       "fill_p" if traceback else "score")
    sym = rb_symbol(mode, R, C, traceback, scoring.is_affine)
    hits = [v for k, v in usage.items() if sym in k]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} ptxas entries match {sym}")
    regs, smem = hits[0]
    dyn = launch_smem(mode, R, C, T, A, scoring.is_affine)
    stripes = -(-n // (T * R))
    return (4 * regs * T + smem + dyn) * min(stripes, H100_SMS)


def stripe_traffic(m: int, n: int, T: Optional[int] = None,
                   R: Optional[int] = None, C: Optional[int] = None,
                   traceback: bool = False, scoring: Scoring = Scoring(),
                   substitution=None) -> TrafficReport:
    """Analytic traffic of one register-blocked stripe launch over a (m,)
    against b (n,): K1-K3 score-only, or K4 with ``traceback``, at the
    (T, R, C) ``rb_shape`` gives (None: the form's defaults).
    ``substitution``: the (A, A) table or None."""
    A = 0 if substitution is None else len(substitution)
    mode = _mode(scoring, substitution)
    kind = "fill_p" if traceback else "score"
    T, R, C = rb_shape(n, T, R, C, mode, A, kind)
    affine = scoring.is_affine
    stripes = -(-n // (T * R))
    cells = m * n
    # the hand-off rows: stripes - 1 of them, each written by its stripe
    # and read by the next (the wrapper allocates at least one)
    rows = max(stripes - 1, 1) * (m + 1)
    bnd = 4 * rows * (2 if affine else 1)
    handed = 4 * (stripes - 1) * (m + 1) * (2 if affine else 1)
    sync = 4 * (stripes + 1)
    best = 16 * stripes
    right = 4 * (n + 1)
    # progress counters: one store a chunk of 32 columns a stripe, one load
    # of the stripe above's a chunk
    progress = 4 * stripes * -(-(m + 1) // 32)
    table = 4 * A * A * stripes
    reads = stripes * m + n + table + handed + progress + best + 4
    writes = sync + handed + progress + best + 2 * right
    p_bytes = 0
    if traceback:
        pitch = -(-(m + 1) // P_PITCH_ALIGN) * P_PITCH_ALIGN
        p_bytes = 3 + (n + 1) * pitch
        writes += (n + 1) * (m + 1)            # every cell, no padding
    per_block = (4 * rb_registers(R, C, traceback, affine) * T
                 + rb_shared_bytes(mode, R, C, T, A, affine))
    resident = per_block * min(stripes, H100_SMS)
    # what the wrapper holds beyond inputs and outputs, in allocator
    # blocks: sync, bnd (and bnd_f), the per-stripe firsts, the slack of
    # the right column's and the result's blocks, and the reduction
    scratch = (_alloc(sync) + (2 if affine else 1) * _alloc(4 * rows)
               + _alloc(best) + _alloc(right) - right + _alloc(16) - 16
               + REDUCE_TENSORS * ALLOC_BLOCK)
    if traceback:
        scratch += _alloc(p_bytes) - p_bytes
    name = {"linear": "K1", "affine": "K2", "sub": "K3"}[mode]
    return TrafficReport(
        plan=f"stripe(T={T},R={R},C={C},"
             f"{'K4 P' if traceback else name + ' score'})",
        cells=cells, hbm_read_bytes=reads, hbm_write_bytes=writes,
        resident_bytes=resident,
        bytes_per_cell=(reads + writes) / cells,
        notes=f"{stripes} stripes; tile state in registers, query ring in "
              "shared memory; only the hand-off rows cross"
              + ("; P stream dominates" if traceback else ""),
        p_bytes=p_bytes, scratch_bytes=scratch)


def scan_traffic(m: int, n: int, traceback: bool = False,
                 scoring: Scoring = Scoring(),
                 substitution=None) -> TrafficReport:
    """Analytic traffic of the plain sweep ``scan_fill`` over a (m,)
    against b (n,): every tensor op of its loop reads and writes device
    memory; with ``traceback`` it also stores the diagonal-major int8 P of
    (m + n - 1, n)."""
    steps = m + n - 1
    cells = m * n
    affine = scoring.is_affine
    r, w = _SCAN_RW["linear"]
    if affine:
        r, w = r + _SCAN_AFFINE_RW[0], w + _SCAN_AFFINE_RW[1]
    if substitution is not None:
        r, w = r + _SCAN_SUB_RW[0], w + _SCAN_SUB_RW[1]
    if traceback:
        r, w = r + _SCAN_P_RW[0], w + _SCAN_P_RW[1]
        if affine:
            r, w = r + _SCAN_AFFINE_P_RW[0], w + _SCAN_AFFINE_P_RW[1]
    reads = m + n + r * cells
    writes = w * cells + 4 * (m + n + 2)      # the right column, bottom row
    # the lane vectors: the flipped a, b, row 0, column 0, H, UP, the
    # lanes' best and its step, the right column, the bottom row, the
    # lane indices; affine also F of row 0, E of column 0, E, F, the right
    # E and the bottom F
    resident = 4 * (3 * m + 8 * n) + (4 * (2 * m + 4 * n) if affine else 0)
    p_bytes = steps * n if traceback else 0
    return TrafficReport(
        plan=f"scan({'P' if traceback else 'score'})",
        cells=cells, hbm_read_bytes=reads, hbm_write_bytes=writes,
        resident_bytes=resident, bytes_per_cell=(reads + writes) / cells,
        notes="a loop of tensor ops, every op through device memory; "
              "diag-major P when traced",
        p_bytes=p_bytes)


def reference_v61_traffic(m: int, n: int) -> TrafficReport:
    """What the reference's v6.1 pathology moves: the FULL H and P matrices
    cross the device boundary on EVERY anti-diagonal
    (omp_smithW-v6.1-target-inlined.cpp:271 — measured 260 s at 4128^2,
    experiments-lassen/v6.1.log). Kept as the cautionary comparison."""
    diags = m + n - 3
    bytes_moved = diags * 2 * 4 * (m + 1) * (n + 1) * 2   # H+P, to+from
    return TrafficReport(
        plan="reference-v6.1 (per-diagonal full map)",
        cells=m * n, hbm_read_bytes=bytes_moved // 2,
        hbm_write_bytes=bytes_moved // 2,
        resident_bytes=8 * (m + 1) * (n + 1),
        bytes_per_cell=bytes_moved / (m * n),
        notes="the transfer pathology the device-resident design eliminates",
    )


@dataclasses.dataclass
class MeasuredMemory:
    """The card's allocator around ONE call: the bytes of its inputs and
    of its outputs (each distinct storage once, a view counting its whole
    allocation, so K4's padded P counts its pitch), and ``temp_bytes``,
    the peak it allocated beyond both (scratch, rounding slack, the
    reduction's tensors). ``code_bytes`` is 0: a hand-written kernel's
    code sits in the kernel library loaded once a process, not in a call's
    allocation, and the library holds every kernel at once. ``result`` is
    what the call returned, so that its answer can be checked."""

    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    code_bytes: int
    result: object = dataclasses.field(default=None, repr=False,
                                       compare=False)

    def bytes_per_cell(self, cells: int) -> float:
        return (self.argument_bytes + self.output_bytes) / cells


def _storages(x, seen: dict) -> dict:
    """{storage pointer: its bytes} of the tensors in ``x`` (a tensor, or
    a tuple, list, dict or dataclass of them), added to ``seen``."""
    for t in _tensors(x):
        st = t.untyped_storage()
        seen.setdefault(st.data_ptr(), st.nbytes())
    return seen


def measured_memory(fn, *args) -> Optional[MeasuredMemory]:
    """Run ``fn(*args)`` once on the card its tensor arguments live on and
    read the caching allocator: the peak above what was allocated before
    the call, less the outputs, is ``temp_bytes``. None where no argument
    is a CUDA tensor (the CPU has no such allocator), as the JAX version
    answers None where a backend has no memory analysis."""
    devs = {t.device for t in _tensors(args) if t.device.type == "cuda"}
    if not devs:
        return None
    if len(devs) > 1:
        raise ValueError(f"arguments on several cards: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    arg = _storages(args, {})
    new = {k: v for k, v in _storages(out, {}).items() if k not in arg}
    out_b = sum(new.values())
    return MeasuredMemory(argument_bytes=sum(arg.values()),
                          output_bytes=out_b,
                          temp_bytes=max(0, peak - before - out_b),
                          code_bytes=0, result=out)


def _codes(m: int, n: int, substitution, seed: int = 0) -> tuple:
    """A seeded pair: ACGT codes, or codes of the table's alphabet."""
    if substitution is None:
        from ..core.encode import random_pair
        return random_pair(m, n, seed=seed)
    rng = np.random.default_rng(seed)
    A = len(substitution)
    return (rng.integers(0, A, m).astype(np.int8),
            rng.integers(0, A, n).astype(np.int8))


def validate_model(m: int, n: int, scoring: Scoring = Scoring(),
                   device: Union[str, torch.device] = "cuda",
                   substitution=None) -> dict:
    """Measure each plan's call on ``device`` and put the model beside it:
    {plan: (TrafficReport, MeasuredMemory)} for 'scan' and 'scan+P' (the
    plain sweep, its ``FillOut``), 'stripe' (K1-K3) and 'stripe+P' (K4,
    their ``StripeOut``), on a seeded m x n pair; each MeasuredMemory's
    ``result`` is its call's answer. On the CPU, where nothing is
    measured, {}."""
    from ..engine.align import resolve_device
    from ..kernels.scan_fill import embed_table, scan_fill
    from ..kernels.stripe_fill import stripe_fill, stripe_score

    dev = resolve_device(device)
    a, b = _codes(m, n, substitution)
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    sub = (None if substitution is None else
           torch.as_tensor(np.asarray(substitution, np.int32)).to(dev))
    table = None if sub is None else embed_table(sub)
    calls = {
        "scan": (lambda x, y: scan_fill(x, y, scoring=scoring,
                                        sub_table=table),
                 scan_traffic(m, n, False, scoring, substitution)),
        "scan+P": (lambda x, y: scan_fill(x, y, scoring=scoring,
                                          return_p=True, sub_table=table),
                   scan_traffic(m, n, True, scoring, substitution)),
        "stripe": (lambda x, y: stripe_score(x, y, scoring,
                                             substitution=sub),
                   stripe_traffic(m, n, scoring=scoring,
                                  substitution=substitution)),
        "stripe+P": (lambda x, y: stripe_fill(x, y, scoring,
                                              substitution=sub),
                     stripe_traffic(m, n, traceback=True, scoring=scoring,
                                    substitution=substitution)),
    }
    out = {}
    for plan, (fn, model) in calls.items():
        meas = measured_memory(fn, at, bt)
        if meas is not None:
            out[plan] = (model, meas)
    return out


def report(m: int, n: int, config: EngineConfig = EngineConfig()) -> str:
    """Human-readable traffic comparison for a problem size: the plain
    sweep with and without P, the stripe at ``choose_exec``'s (T, R, C) on
    a card, K4 at its defaults, and the reference's pathology."""
    from ..dispatch.plan import choose_exec
    ep = choose_exec(m, n, config, device=torch.device("cuda"))
    lines = [
        scan_traffic(m, n).summary(),
        scan_traffic(m, n, traceback=True).summary(),
        stripe_traffic(m, n, T=ep.T, R=ep.R, C=ep.C).summary(),
        stripe_traffic(m, n, traceback=True).summary(),
        reference_v61_traffic(m, n).summary(),
    ]
    return "\n".join(lines)
