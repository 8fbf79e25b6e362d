"""One run of one cell: set-up, the measured window, the checks, the
metrics and the result line.

Everything a cell needs is found by the names ``BENCHMARK.json`` gives
it: its configuration's file, its traffic mix
(``benchmarks/traffic/<traffic>.json``, read by ``traffic.build`` and
the workload of its ``kind``, ``benchmarks/kinds/<kind>.py``) and each
metric's reader (``benchmarks/metrics/<name>.py``, whose ``value(run)``
returns the number or None where it finds nothing to read).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
import traceback
import types
from pathlib import Path
from typing import Optional

import torch

from . import trace as tr
from .roofline import Peak, Work, card_peak
from .traffic import build

ROOT = Path(__file__).resolve().parents[2]
# top-level modules that may not be loaded in a run: JAX and the JAX
# package this program was ported from, compared by whole names
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "swtpu"})


class Refused(RuntimeError):
    """A run that may print no result."""


@dataclasses.dataclass
class Call:
    t0: float         # host clock at entry
    t1: float         # host clock at the answer on the host
    work: Work
    ok: bool


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    calls: list
    trace: Optional[tr.Trace] = None
    peak: Optional[Peak] = None

    @property
    def window_s(self) -> float:
        return self.calls[-1].t1 - self.calls[0].t0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(spec: dict, name: str) -> tuple:
    """(workload entry, configuration entry) of the cell ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json "
                      f"(there are {', '.join(sorted(cells))})")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, config


def metrics_of(spec: dict, cell: str, traced: bool) -> list:
    """The cell's end-to-end metrics (untraced) or per-layer ones."""
    group = spec["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``value`` of ``benchmarks/metrics/<name>.py``; a metric split
    by cells, ``<base>.<part>``, is read by ``<base>.py`` where it has no
    file of its own."""
    path = ROOT / "benchmarks" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.value


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(spec: dict, name: str, seed: int, seconds: float, traced: bool,
             t0: float, device="cuda", api=None, config: dict = None,
             mix: dict = None, log=print, devices: list = None,
             limit_s: float = 300.0) -> dict:
    """Run cell ``name`` once and return its result line as a dict, the
    checks last. ``api``: the program's package (default ``swtpu_torch``),
    or its module's name; ``config``, ``mix``: the cell's configuration
    and traffic mix in place of its files (a test's smaller ones).
    ``log``: where the lines before the result go.

    A cell of one chip runs here, on ``device``. A cell of N chips runs
    as N ranks in lock step (``harness/ranks.py``), this process rank 0:
    ``devices`` gives each rank's device (default card r for rank r; a
    test or a rehearsal gives N times 'cpu', or N ranks sharing 'cuda:0'),
    ``api`` is then named by module so that every rank can import it, and
    ``limit_s`` is the world's time limit."""
    cell, centry = cell_of(spec, name)
    if config is None:
        config = load_json(ROOT / centry["file"])
    if mix is None:
        mix = load_json(ROOT / "benchmarks" / "traffic"
                        / f"{cell['traffic']}.json")
    if isinstance(api, str):
        api = importlib.import_module(api)
    elif api is None:
        import swtpu_torch as api
    chips = cell["chips"]
    if chips > 1:
        devices = list(devices or [f"cuda:{r}" for r in range(chips)])
        if len(devices) != chips:
            raise ValueError(f"{name} runs on {chips} ranks, not "
                             f"{len(devices)}")
        device = devices[0]
    cuda = torch.device(device).type == "cuda"
    if chips > 1:
        from . import ranks
        if not isinstance(api, types.ModuleType):
            raise TypeError("a cell on several ranks names its program by "
                            "module")
        wl, setup_s, calls, done, trace, t_closed, t_read, peak_bytes, \
            loaded = ranks.run(devices, limit_s, api.__name__, config, mix,
                               seed, t0, seconds, traced, log)
        failed = sum(not c.ok for c in calls)
    else:
        loaded = {}
        wl, setup_s, calls, done, failed, trace, t_closed, t_read = _one(
            config, mix, seed, device, api, seconds, traced, t0, log)
        peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules() + [f"{m} (rank {r})"
                                 for r, ms in sorted(loaded.items())
                                 for m in ms]
    if bad:
        raise Refused("the run loaded " + ", ".join(bad))

    run = Run(setup_s, calls, trace,
              card_peak(chips) if traced and cuda else None)
    if cuda:
        torch.cuda.empty_cache()
    checks = wl.check(done, device)
    t_checked = time.perf_counter()
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)

    metrics = {}
    for m in metrics_of(spec, name, traced):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": peak_bytes}
    log(f"calls {len(calls)} ({failed} failed) in {run.window_s:.6f} s; "
        f"call_p95_ms over {len(calls)} samples; set-up {setup_s:.3f} s, "
        f"trace read {t_read - t_closed:.3f} s, reference and checks "
        f"{t_checked - t_read:.3f} s", file=sys.stderr)
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        lo, hi = trace.window
        dev["busy_s"] = tr.busy(trace, lo, hi) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = tr.breakdown(trace)
        if run.peak is not None:
            p = run.peak
            bound = {run.peak.least_s(c.work)[1] for c in calls}
            w = calls[0].work
            log(f"roofline: {p.name}, power limit {p.power_limit_w} W, "
                f"{p.sms} SMs at {p.max_sm_mhz} MHz: "
                f"{p.issue_per_s():.6g} lane-instructions/s, "
                f"{w.instructions} a cell, lanes of "
                f"{'/'.join(str(b) for b in sorted(w.cells_by_bits))} bits; "
                f"bound by {', '.join(sorted(bound))}", file=sys.stderr)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n} {v} limit {lim}", file=sys.stderr)
    return result


def _one(config: dict, mix: dict, seed: int, device, api, seconds: float,
         traced: bool, t0: float, log) -> tuple:
    """Set-up and window of a cell on one chip, in this process: (the
    workload, setup_s, calls, done, failed, trace, t_closed, t_read)."""
    wl = build(config, mix, seed, device, api)
    wl.warm()
    _sync(device)
    setup_s = time.perf_counter() - t0

    calls, done, failed = [], [], 0
    prof = tr.start(device) if traced else None
    span = (lambda: torch.profiler.record_function(tr.SPAN)) if traced \
        else contextlib.nullcontext
    start = time.perf_counter()
    k = 0
    while True:
        a = time.perf_counter()
        ans = None
        try:
            with span():
                ans = wl.call(k)
        except Exception:                   # a call that gives no answer
            failed += 1
            log(traceback.format_exc(), file=sys.stderr)
        b = time.perf_counter()
        calls.append(Call(a, b, wl.work(k), ans is not None))
        if ans is not None:
            done.append((k, ans))
        k += 1
        if b - start >= seconds:
            break
    t_closed = time.perf_counter()
    trace = tr.stop(prof, device) if traced else None
    t_read = time.perf_counter()
    return wl, setup_s, calls, done, failed, trace, t_closed, t_read
