"""Device traces and per-phase timing over ``torch.profiler``.

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

``phase_report(prep, run, fetch)`` times the three phases of one device
computation: host-side input preparation (the uploads), the device run
(the launch) and the fetch of the result. On a CUDA device the run is the
fastest of ``repeats`` CUDA-event intervals around ``run`` (the card's own
clock), and prep and fetch are host clock, each closed by a synchronize,
so an asynchronous copy is charged to its own phase and not to the next.
On the CPU all three are host clock. Each phase runs inside a
``torch.profiler.record_function`` range (``phase_report.prep``,
``phase_report.run``, ``phase_report.fetch``), so a ``trace()`` around a
``phase_report`` shows them. Nothing here touches the engine's own code.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import time
from typing import Callable, Optional, Union

import torch
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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_report(prep: Callable, run: Callable, fetch: Callable,
                 repeats: int = 3,
                 device: Optional[Union[str, torch.device]] = None) -> dict:
    """Seconds of the three phases of a device computation: ``state =
    prep()``, ``out = run(state)`` (``repeats`` times, the fastest kept)
    and ``fetch(out)``, as ``input_prep_s``, ``device_run_s`` and
    ``result_fetch_s``, rounded to 10 µs. ``device``: where ``run``'s work
    goes, default (None) the current CUDA device, which must exist; pass
    ``"cpu"`` for host-clock times of a CPU computation."""
    dev = torch.device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("phase_report on a CUDA device, but none is "
                               "available; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())

    _sync(dev)
    t0 = time.perf_counter()
    with record_function("phase_report.prep"):
        state = prep()
        _sync(dev)
    prep_s = time.perf_counter() - t0

    run_s = float("inf")
    out = None
    for _ in range(repeats):
        with record_function("phase_report.run"):
            if cuda:
                with torch.cuda.device(dev):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = run(state)
                    end.record()
                    end.synchronize()
                    dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                out = run(state)
                dt = time.perf_counter() - t0
        run_s = min(run_s, dt)

    t0 = time.perf_counter()
    with record_function("phase_report.fetch"):
        fetch(out)
        _sync(dev)
    fetch_s = time.perf_counter() - t0
    return {"input_prep_s": round(prep_s, 5),
            "device_run_s": round(run_s, 5),
            "result_fetch_s": round(fetch_s, 5)}
