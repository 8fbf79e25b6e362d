"""Timers, GCUPS accounting and structured bench records.

``PhaseTimer`` times named phases with CUDA events on a CUDA device (the
device's own clock, read after the phase's last kernel) and with the host
clock on the CPU. Every timing names the device it ran on, so a CPU time
is never read as a device time: ``BenchRecord.backend`` is the card's
name or ``"cpu"``. ``block`` is the ``jax.block_until_ready`` of the
port: it waits for the work queued on the card of a tensor before a host
clock is read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional

import torch


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates named phase durations in seconds on ``device``."""

    device: torch.device = torch.device("cpu")
    phases: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt


def _tensors(x):
    """The tensors in ``x``: a tensor, or a tuple, list, dict or dataclass
    of them, nested."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def block(x):
    """Wait for the work queued on the current stream of every CUDA device
    that a tensor of ``x`` (a tensor, or a tuple, list, dict or dataclass
    of tensors) lives on, and return ``x``: the host clock read after it
    includes that work. For CPU tensors it returns at once."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    return x


def device_name(device) -> str:
    """What a timing on ``device`` is labelled with: the card's name, or
    ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def gcups(cells: int, seconds: float) -> float:
    """Giga cell updates per second — m*n / time / 1e9."""
    return cells / seconds / 1e9 if seconds > 0 else float("inf")


@dataclasses.dataclass
class BenchRecord:
    """One benchmark observation, JSONL-serializable; the fields of the
    JAX package's record. ``backend`` is the device the time was taken on
    (``device_name``: the card's name, or ``"cpu"`` for a host-clock time
    of the CPU)."""

    name: str
    m: int
    n: int
    batch: int = 1
    repeats: int = 1
    fill_s: float = 0.0
    traceback_s: float = 0.0
    compile_s: float = 0.0
    plan: str = "scan"
    backend: str = ""
    devices: int = 1
    extra: Optional[dict] = None

    @property
    def cells(self) -> int:
        return self.m * self.n * self.batch

    @property
    def gcups(self) -> float:
        return gcups(self.cells, self.fill_s)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["cells"] = self.cells
        d["gcups"] = self.gcups
        return json.dumps(d)


def memory_footprint_bytes(m: int, n: int, traceback: bool = True) -> int:
    """Estimated device working set of the stripe plan: the row-major int8
    P when traceback is kept, the right column, the two sequences, and a
    bound on the boundary rows between stripes (at most one int32 row of
    m+1 per 32 rows)."""
    p_matrix = (n + 1) * (m + 1) if traceback else 0
    boundary = 4 * (m + 1) * (-(-n // 32))
    return p_matrix + boundary + 4 * (n + 1) + m + n
