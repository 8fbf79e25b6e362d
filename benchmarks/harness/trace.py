"""The traced window: ``torch.profiler`` over the calls, read back from its
Chrome trace into the benchmark's own spans (``bench.call``, one around
each public call), the device's operations and the host's.

Times are the trace's microseconds. Device operations are kernels, copies
and sets; a kernel is named by the C entry of the program's ``csrc/`` that
launches it where it is one of the program's (a frozen copy of the
program's naming, read off the kernel's template flags), else by the name
the trace gives it.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

SPAN = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")

# stripe_rb_kernel<R, C, kAffine, kSub, kP, kBlock, kBand, kDebugH, kPairs,
# kShared, kPacked> and window_warp_kernel<R, kAffine, kSub>
_RB = re.compile(r"stripe_rb_kernel<(\d+), ?(\d+)((?:, ?(?:true|false)){9})>")
_WARP = re.compile(r"window_warp_kernel<(\d+), ?(true|false), ?(true|false)>")
_FLAGS = ("kP", "kBlock", "kBand", "kDebugH", "kPairs", "kShared", "kPacked")
_FORMS = {
    (): "sw_stripe_rb_{mode}",
    ("kP",): "sw_stripe_rb_fill_p_{mode}",
    ("kBlock",): "sw_stripe_rb_block_{mode}",
    ("kBand",): "sw_stripe_rb_band_{mode}",
    ("kP", "kBand"): "sw_stripe_rb_fill_p_band_{mode}",
    ("kDebugH",): "sw_sanitize_rb_{mode}",
    ("kDebugH", "kPacked"): "sw_sanitize_packed_rb_{mode}",
    ("kPairs",): "sw_pairs_rb_{mode}",
    ("kPairs", "kBand"): "sw_pairs_rb_band_{mode}",
    ("kPairs", "kShared"): "sw_window_rb_{mode}",
    ("kPacked",): "sw_packed_rb_{mode}",
}


def _mode(affine: bool, sub: bool) -> str:
    return "sub" if sub else "affine" if affine else "linear"


def entry_of(kernel: str) -> str:
    """The C entry that launches the kernel a trace names ``kernel``."""
    got = _RB.search(kernel)
    if got:
        flags = [f.strip() == "true"
                 for f in got.group(3).strip(", ").split(",")]
        on = tuple(f for f, v in zip(_FLAGS, flags[2:]) if v)
        form = _FORMS.get(on)
        return form.format(mode=_mode(*flags[:2])) if form else kernel
    got = _WARP.search(kernel)
    if got:
        return f"sw_window_warp_{_mode(got.group(2) == 'true', got.group(3) == 'true')}"
    if "walk_p_tiled_kernel" in kernel:
        return "sw_walk_p_tiled"
    if "walk_p_kernel" in kernel:
        return "sw_walk_p"
    return _short(kernel)


def _short(kernel: str) -> str:
    """Another library's kernel by its function's name and its functor's,
    without the template arguments."""
    if "<" not in kernel:
        return kernel
    base = kernel.removeprefix("void ").split("<")[0].strip()
    rest = kernel[kernel.index("<"):]
    got = (re.search(r"(\w+Functor)\b", rest)
           or re.search(r"(\w+(?:Ops|_impl|Op))\b", rest))
    return f"{base}[{got.group(1)}]" if got else base


@dataclasses.dataclass
class Trace:
    spans: list      # [(start, end)] of the benchmark's call spans, in order
    device: list     # [(start, end, name, cat)] of the device's operations
    host: list       # [(start, end, name)] of the host's operations

    @property
    def window(self) -> tuple:
        return self.spans[0][0], self.spans[-1][1]

    def kernels(self, lo: float, hi: float) -> list:
        return [d for d in self.device
                if d[3] == "kernel" and d[0] < hi and d[1] > lo]


def start(device) -> profile:
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop(prof: profile, device) -> Trace:
    """Stop the profiler and read its trace, through a file in a fresh
    temporary directory that is removed at once."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    prof.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans, device, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and name == SPAN:
            spans.append((t0, t1))
        elif cat in DEVICE_CATS:
            device.append((t0, t1, name, cat))
        elif cat in HOST_CATS:
            host.append((t0, t1, name))
    spans.sort()
    device.sort()
    host.sort()
    return Trace(spans, device, host)


def merged(intervals, lo: float, hi: float) -> list:
    """The union of [(start, end, ...)] clipped to [lo, hi], as sorted
    disjoint (start, end) pairs."""
    out = []
    for iv in sorted(intervals):
        a, b = max(iv[0], lo), min(iv[1], hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(trace: Trace, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some operation ran on the device."""
    return sum(b - a for a, b in merged(trace.device, lo, hi))


def busy_each(trace: Trace, spans: list) -> list:
    """``busy`` of each of sorted, disjoint [(lo, hi)] spans, the device's
    operations merged once."""
    edges = merged(trace.device, spans[0][0], spans[-1][1])
    starts = [a for a, _ in edges]
    out = []
    for lo, hi in spans:
        k = max(0, bisect.bisect_right(starts, lo) - 1)
        t = 0.0
        while k < len(edges) and edges[k][0] < hi:
            t += max(0.0, min(edges[k][1], hi) - max(edges[k][0], lo))
            k += 1
        out.append(t)
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, by C
    entry, and the device's idle time by what the host was doing in the
    middle of each gap: the innermost host operation then running, else
    the benchmark's call span ('host code in a call'), else 'between
    calls'. Seconds."""
    lo, hi = trace.window
    ops: collections.Counter = collections.Counter()
    for a, b, name, _ in trace.device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            ops[entry_of(name)] += (b - a) / 1e6
    gaps: collections.Counter = collections.Counter()
    edges = merged(trace.device, lo, hi)
    host_starts = [h[0] for h in trace.host]
    span_starts = [s[0] for s in trace.spans]
    t = lo
    for a, b in edges + [(hi, hi)]:
        if a > t:
            gaps[_doing(trace, host_starts, span_starts, (a + t) / 2)] \
                += (a - t) / 1e6
        t = max(t, b)
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


def _doing(trace: Trace, host_starts: list, span_starts: list,
           t: float) -> str:
    """What the host was doing at t: the latest-starting host operation
    that covers t (looked for among the 256 that started last), else the
    call span that covers t, else 'between calls'."""
    k = bisect.bisect_right(host_starts, t)
    for a, b, name in reversed(trace.host[max(0, k - 256):k]):
        if b > t:
            return name
    k = bisect.bisect_right(span_starts, t)
    if k and trace.spans[k - 1][1] > t:
        return "host code in a call"
    return "between calls"
