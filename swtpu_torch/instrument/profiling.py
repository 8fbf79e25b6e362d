"""Device traces, and the program's own spans and counters, over
``torch.profiler``.

Counterpart of ``swtpu.instrument.profiling``. ``trace(logdir)`` records
the CPU and CUDA activity of its block with ``torch.profiler`` and writes
a Chrome/Perfetto trace into ``logdir``: the hand-written kernels appear
under their C++ names (``sw_stripe_rb_linear`` launches
``stripe_rb_kernel<...>``; the launch's own ``cudaLaunchKernel`` row sits
under the wrapper's Python frame). A profiler that fails to start or stop
raises: where the JAX version keeps going without a trace, this one has
nothing to protect, since ``torch.profiler`` is always there.

``trace_kernels(path)`` reads a written trace's CUDA kernels back, each
named by the C entry of ``csrc/`` that launches it where the kernel is
one of the port's (the register-blocked stripe's forms by their template
flags, the warp-per-read K6, the walks of P), else by the name the trace
gives it.

Spans and counters. ``span(name)`` marks a part of a public call and
``count(name, n)`` adds n to a counter, so that a trace splits a call's
host time into named parts.

- The switch is a running torch profiler (``trace()``, or any
  ``torch.profiler.profile``), read from
  ``torch.autograd.profiler._is_profiler_enabled`` at each span; there is
  no other (no variable, no setting). With none running, ``span`` hands
  back one shared object that does nothing and ``count`` returns at once;
  ``recording()`` tells a caller whether a counter worth computing would
  be kept.
- While recording, a span enters ``torch.profiler.record_function(name)``,
  so it lands in the profiler's own trace as a ``user_annotation`` event
  beside the kernels, and appends one ``Record`` to an in-memory buffer
  (``recorded()``, ``clear()``).
- Names: ``swtpu.<layer>.<part>`` (``swtpu.fill.prep``,
  ``swtpu.tb.strings``, ``swtpu.batch.pack``); the outermost span of a
  public call is its root (``swtpu.align``, ``swtpu.score_many``,
  ``swtpu.search``) and opens a new call id; nested spans carry that id
  and their parent's index, on a stack of the thread's own. Counters:
  ``h2d_bytes`` (codes and tables copied from the host to the call's
  device; on the CPU, where nothing moves, what a card would be sent),
  ``batch.cells_real`` and ``batch.cells_bucket`` (a ``score_many``
  bucket's m·n summed over its pairs, and its pairs × its padded shape),
  ``batch.seqs_distinct`` (the distinct sequence objects a ``score_many``
  call uploads, once each, for its 2 × B row slots), ``tb.columns`` (the
  columns of an alignment the lean traceback renders, once a rendering).
  The pipeline across ranks (``dist.pipeline``) has ``swtpu.pipe`` and its
  parts ``swtpu.pipe.plan``, ``.agree``, ``.fill``, ``.halo`` and
  ``.merge``, and counts ``pipe.stages``, ``pipe.blocks``,
  ``pipe.halo_bytes`` and ``pipe.block_rows`` once a pass on each rank.
- The buffer holds the newest ``MAX_RECORDS`` (2^20) records; older ones
  are dropped and counted (``dropped()``).
- The clock is ``time.perf_counter_ns()``, the host clock callers time
  their calls with. The records carry no offset to the profiler's clock:
  a caller pins them to the trace through spans of its own that it times
  on both clocks (the benchmark through its ``bench.call`` spans,
  ``benchmarks/harness/spans.py``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re
import threading
import time
from typing import NamedTuple, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from ..kernels.stripe_fill import rb_entry

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, device: Union[str, torch.device] = "cuda"):
    """Record the block's CPU and, on a CUDA ``device``, CUDA activity with
    ``torch.profiler``, and write it as a Chrome/Perfetto trace to
    ``logdir/trace.json`` on exit (open it in Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()`` reads
    the same events. Raises where the profiler cannot start or stop."""
    dev = torch.device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"trace(device={str(device)!r}) but no CUDA "
                               "device is available")
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


MAX_RECORDS = 1 << 20


class Record(NamedTuple):
    """A closed span (``value`` None) or a counter's step (``t0_ns`` ==
    ``t1_ns``). ``index``: its place among every record this process
    opened; ``parent``: the enclosing span's index, -1 at a root or
    outside any span; ``call``: the root's call id, -1 outside any
    span."""
    name: str
    call: int
    index: int
    parent: int
    t0_ns: int
    t1_ns: int
    value: Optional[int] = None


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_dropped = 0
_opened = 0         # records opened so far: the next index
_calls = 0          # call ids handed out so far
_local = threading.local()


class _Off:
    """The span of every block while no profiler runs: it does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def recording() -> bool:
    """Is a torch profiler running, so that spans and counters record?"""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _next_index() -> int:
    global _opened
    _opened += 1
    return _opened - 1


def _keep(rec: Record) -> None:
    global _dropped
    if len(_records) == _records.maxlen:
        _dropped += 1
    _records.append(rec)


class _Span:
    __slots__ = ("name", "call", "index", "parent", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _calls
        stack = _stack()
        if stack:
            top = stack[-1]
            self.call, self.parent = top.call, top.index
        else:
            self.call, self.parent = _calls, -1
            _calls += 1
        self.index = _next_index()
        stack.append(self)
        # the record frames the annotation, so that a span's own cost under
        # the profiler is charged to it and not to its parent
        self.t0 = time.perf_counter_ns()
        self.rf = record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.rf.__exit__(*exc)
        finally:
            _stack().pop()
            _keep(Record(self.name, self.call, self.index, self.parent,
                         self.t0, time.perf_counter_ns()))
        return False


def span(name: str):
    """A context manager that marks its block as the part ``name`` of a
    call while a torch profiler runs, and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorate a public call to run inside ``span(name)``, its root."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` at this moment, while a torch
    profiler runs. A counter whose value takes work to compute is computed
    only where ``recording()``."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _stack()
    top = stack[-1] if stack else None
    t = time.perf_counter_ns()
    _keep(Record(name, top.call if top else -1, _next_index(),
                 top.index if top else -1, t, t, int(n)))


def recorded() -> list:
    """The records kept, oldest first (spans in the order they closed)."""
    return list(_records)


def dropped() -> int:
    """Records dropped from the full buffer since the last ``clear()``."""
    return _dropped


def clear() -> None:
    """Empty the buffer and zero the dropped count."""
    global _dropped
    _records.clear()
    _dropped = 0


# the demangled device symbols of csrc/stripe_rb.cuh's stripe_rb_kernel<R,
# C, kAffine, kSub, kP, kBlock, kBand, kDebugH, kPairs, kShared, kPacked>
# and csrc/window_warp.cu's window_warp_kernel<R, kAffine, kSub>
_RB = re.compile(r"stripe_rb_kernel<(\d+), ?(\d+)"
                 r"((?:, ?(?:true|false)){9})>")
_WARP = re.compile(r"window_warp_kernel<(\d+), ?(true|false), "
                   r"?(true|false)>")


def entry_of(kernel: str) -> str:
    """The C entry of ``csrc/`` that launches the kernel a trace names
    ``kernel`` (its demangled device symbol), or ``kernel`` itself where it
    is none of the register-blocked stripe's forms
    (``stripe_fill.rb_entry``), the warp-per-read K6 or a walk of P."""
    got = _RB.search(kernel)
    if got:
        flags = tuple(f.strip() == "true"
                      for f in got.group(3).strip(", ").split(","))
        return rb_entry(flags) or kernel
    got = _WARP.search(kernel)
    if got:
        aff, sub = (g == "true" for g in got.groups()[1:])
        mode = "sub" if sub else "affine" if aff else "linear"
        return f"sw_window_warp_{mode}"
    if "walk_p_tiled_kernel" in kernel:
        return "sw_walk_p_tiled"
    if "walk_p_kernel" in kernel:
        return "sw_walk_p"
    return kernel


def trace_kernels(path: str) -> collections.Counter:
    """The CUDA kernels of a trace written by ``trace`` (its directory or
    its file): launches by ``entry_of`` name."""
    if os.path.isdir(path):
        path = os.path.join(path, TRACE_FILE)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return collections.Counter(entry_of(e.get("name", "")) for e in events
                               if e.get("cat") == "kernel")
