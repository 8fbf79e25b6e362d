"""A cell on N cards: N ranks, one process a card, driven in lock step.

Rank 0 is the runner's own process, on the first of the run's devices. It
spawns ranks 1 ... N-1 (the ``spawn`` start method: a process forked after
an OpenMP region hangs on the card machine), and all join one
``torch.distributed`` world through a ``file://`` store in a fresh
temporary directory: NCCL where every rank has a card of its own, gloo
where ranks share a card or run on the CPU. The world's time limit
(``limit_s``) bounds every wait in it. Beside the world the harness keeps a
gloo group of its own for its control messages, so that a control message
never queues behind the program's NCCL collectives. Nothing of the
program is imported to do this: a kind builds the program's mesh over the
world that is there.

Every rank builds the same workload from the seed on its own device and
warms it. The first control exchange is the barrier that ends set-up: it
carries each rank's warm seconds, and the limit becomes at least five
times the longest (the warm as a whole bounds its longest call). Then,
before call k, rank 0 sends k, or stop, and in the same exchange (one
``all_gather``) each worker replies with the outcome of its previous call.
Every rank reads the same replies, so every rank stops where rank 0 says
so or any worker's call raised; otherwise every rank makes call k, and
rank 0's answer is the call's answer. After the stop one more exchange
carries each worker's peak device memory and the forbidden modules it
loaded.

Nothing hangs. A worker that ends unasked ends the window: its peers'
gloo exchanges fail at once (NCCL's at the world's limit); rank 0 then
ends every other worker, and where it cannot leave the world itself
within the limit it ends its own process, with no result. A call that
raised on rank 0 ends the window at once, since the workers may be
waiting inside it. A worker ends itself when rank 0's process is gone.
Rank 0 ends its workers on every way out.
"""

from __future__ import annotations

import contextlib
import datetime
import importlib
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from . import trace as tr
from . import traffic
from .bench import FORBIDDEN, Call, forbidden_modules

STOP = -1


def backend_of(devices: list) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    own = all(d.type == "cuda" and d.index is not None for d in devs) \
        and len({d.index for d in devs}) == len(devs)
    return "nccl" if own else "gloo"


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def _join(rank: int, devices: list, init: str, limit_s: float):
    """Join the world as ``rank``; return the control group."""
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_of(devices), init_method=init,
                            world_size=len(devices), rank=rank,
                            timeout=_timeout(limit_s))
    return dist.new_group(backend="gloo", timeout=_timeout(limit_s))


def _exchange(ctrl, *values) -> list:
    """Every rank's ``values`` (whole numbers), in rank order: one
    ``all_gather`` on the control group."""
    mine = torch.tensor(values, dtype=torch.int64)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size(ctrl))]
    dist.all_gather(out, mine, group=ctrl)
    return [x.tolist() for x in out]


def _stops(got: list) -> bool:
    """Rank 0 said stop, or a worker's last call raised."""
    return got[0][0] == STOP or any(r[0] == 0 for r in got[1:])


def _ready(ctrl, warm_s: float, limit_s: float) -> float:
    """The barrier after the warm calls; returns the world's limit, at
    least five times the longest warm, raised on the world and the control
    group where it grows (and where torch can)."""
    longest = max(r[0] for r in _exchange(ctrl, round(warm_s * 1e6))) / 1e6
    if 5 * longest <= limit_s:
        return limit_s
    limit_s = 5 * longest
    extend = getattr(dist.distributed_c10d, "_set_pg_timeout", None)
    if extend is not None:
        for group in (None, ctrl):
            extend(_timeout(limit_s), group)
    return limit_s


def _warm(wl, device) -> float:
    t = time.perf_counter()
    wl.warm()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t


def _peak(device) -> int:
    dev = torch.device(device)
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _mask(names: list) -> int:
    order = sorted(FORBIDDEN)
    return sum(1 << order.index(n) for n in names)


def _names(mask: int) -> list:
    return [n for i, n in enumerate(sorted(FORBIDDEN)) if mask >> i & 1]


def _watch_parent() -> None:
    """End this process when the process that spawned it is gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def worker(rank: int, devices: list, init: str, limit_s: float, program: str,
           kinds: str, config: dict, mix: dict, seed: int) -> None:
    """Rank ``rank`` (1 or more) of a cell: join the world, build and warm
    the same workload, then make each call rank 0 names until the stop."""
    _watch_parent()
    os.environ["LOCAL_RANK"] = str(rank)
    device = devices[rank]
    ctrl = _join(rank, devices, init, limit_s)
    traffic.KINDS = Path(kinds)
    wl = traffic.build(config, mix, seed, device,
                       importlib.import_module(program), rank, devices)
    _ready(ctrl, _warm(wl, device), limit_s)
    ok = 1
    while True:
        got = _exchange(ctrl, ok)
        if _stops(got):
            break
        try:
            wl.call(got[0][0])
            ok = 1
        except Exception:                   # reported in the next reply
            traceback.print_exc()
            ok = 0
    _exchange(ctrl, _peak(device), _mask(forbidden_modules()))
    dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class World:
    """Rank 0's side of a cell on ``len(devices)`` ranks. ``spawn``
    starts the workers, ``join`` joins the world, ``ready`` ends set-up,
    ``window`` drives the calls; ``close`` (also on leaving a ``with``)
    ends every worker and leaves the world. ``peak`` and ``loaded`` hold
    the workers' largest peak device memory and {rank: forbidden modules},
    read after the stop."""

    def __init__(self, devices: list, limit_s: float, log=print):
        self.devices, self.limit_s, self.log = list(devices), limit_s, log
        self.procs: list = []
        self.watcher = None
        self.tmp = tempfile.mkdtemp(prefix="bench_ranks_")
        self.ctrl = None
        self.lost = None            # (rank, exit code) of a worker gone unasked
        self.stopping = False
        self.finished = False       # the workers sent their stop readings
        self.closed = threading.Event()
        self.peak = 0
        self.loaded: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def init(self) -> str:
        return f"file://{self.tmp}/store"

    def spawn(self, program: str, config: dict, mix: dict, seed: int) -> None:
        ctx = multiprocessing.get_context("spawn")
        for r in range(1, len(self.devices)):
            p = ctx.Process(target=worker, daemon=True, args=(
                r, self.devices, self.init, self.limit_s, program,
                str(traffic.KINDS), config, mix, seed))
            p.start()
            self.procs.append(p)
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def join(self) -> None:
        self.ctrl = _join(0, self.devices, self.init, self.limit_s)

    def ready(self, warm_s: float) -> None:
        self.limit_s = _ready(self.ctrl, warm_s, self.limit_s)

    def window(self, wl, seconds: float, traced: bool) -> tuple:
        """Calls in lock step for ``seconds``, until the first that raised
        on any rank: (calls, done, trace, t_closed, t_read). A call whose
        outcome a worker could not report counts as failed."""
        device = self.devices[0]
        calls, done = [], {}
        prof = tr.start(device) if traced else None
        span = (lambda: torch.profiler.record_function(tr.SPAN)) if traced \
            else contextlib.nullcontext
        start = time.perf_counter()
        k, answered, together = 0, True, False
        try:
            while True:
                answered = self._step(k)
                if not answered:            # a worker's last call raised
                    together = True
                    break
                a = time.perf_counter()
                ans = None
                try:
                    with span():
                        ans = wl.call(k)
                except Exception:           # rank 0's call gave no answer
                    self.log(traceback.format_exc(), file=sys.stderr)
                b = time.perf_counter()
                calls.append(Call(a, b, wl.work(k), ans is not None))
                if ans is None:
                    break
                done[k] = ans
                k += 1
                if b - start >= seconds:
                    answered, together = self._step(STOP), True
                    break
        except RuntimeError:                # an exchange with a lost worker
            self.log(traceback.format_exc(), file=sys.stderr)
            answered = False
        if not answered and calls and calls[-1].ok:
            calls[-1] = Call(calls[-1].t0, calls[-1].t1, calls[-1].work,
                             False)
            done.pop(len(calls) - 1, None)
        if not calls:                       # call 0 could not be sent
            now = time.perf_counter()
            calls.append(Call(now, now, wl.work(0), False))
        t_closed = time.perf_counter()
        trace = tr.stop(prof, device) if traced else None
        t_read = time.perf_counter()
        if together:
            self._finish()
        return calls, sorted(done.items()), trace, t_closed, t_read

    def _step(self, k: int) -> bool:
        """Send call k, or STOP; True where every worker's last call
        answered."""
        if self.lost is not None:
            raise RuntimeError(f"rank {self.lost[0]} ended with code "
                               f"{self.lost[1]}")
        return all(r[0] for r in _exchange(self.ctrl, k)[1:])

    def _finish(self) -> None:
        self.stopping = True
        got = _exchange(self.ctrl, 0, 0)
        self.peak = max(r[0] for r in got[1:])
        self.loaded = {r: _names(g[1]) for r, g in enumerate(got)
                       if r and g[1]}
        self.finished = True

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()

    def _watch(self) -> None:
        """A worker gone unasked: end the others, then give rank 0 the
        world's limit (and ten seconds, so that its own waits time out
        first) to leave it, or end its process."""
        while not self.closed.wait(0.2):
            if self.stopping:
                continue
            gone = [(r, p.exitcode) for r, p in enumerate(self.procs, 1)
                    if p.exitcode is not None]
            if not gone:
                continue
            self.lost = gone[0]
            self.log(f"rank {gone[0][0]} ended with code {gone[0][1]}; "
                     "ending the other ranks", file=sys.stderr)
            self._kill()
            if not self.closed.wait(self.limit_s + 10.0):
                self.log(f"rank 0 could not leave the world within "
                         f"{self.limit_s:.0f} s; ending it", file=sys.stderr)
                shutil.rmtree(self.tmp, ignore_errors=True)
                os._exit(3)
            return

    def close(self) -> None:
        """End every worker and leave the world: workers past a clean stop
        end by themselves, the others are killed."""
        self.stopping = True
        deadline = time.monotonic() + (30.0 if self.finished else 0.0)
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        self._kill()
        for p in self.procs:
            p.join()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.closed.set()
        if self.watcher is not None:
            self.watcher.join()


def run(devices: list, limit_s: float, program: str, config: dict, mix: dict,
        seed: int, t0: float, seconds: float, traced: bool, log) -> tuple:
    """Set-up and window of a cell on ``len(devices)`` ranks, this process
    rank 0: (rank 0's workload, setup_s, calls, done, trace, t_closed,
    t_read, the largest peak device memory over the ranks, {rank:
    forbidden modules it loaded}). Every worker has ended when it
    returns."""
    with World(devices, limit_s, log) as world:
        world.spawn(program, config, mix, seed)
        wl = traffic.build(config, mix, seed, devices[0],
                           importlib.import_module(program), 0, devices)
        world.join()
        world.ready(_warm(wl, devices[0]))
        setup_s = time.perf_counter() - t0
        calls, done, trace, t_closed, t_read = world.window(wl, seconds,
                                                            traced)
        peak = max(world.peak, _peak(devices[0]))
    return (wl, setup_s, calls, done, trace, t_closed, t_read, peak,
            world.loaded)
