"""Benchmark sweep harness: the reference's size sweeps as JSONL records.

Counterpart of ``swtpu.bench_sweep``. The reference sweeps sizes with shell
loops (square {32..26000..512}, rectangular 2000 x {2..150000..5000}), 3
repeats each; here each size is one ``instrument.metrics.BenchRecord``
line of a score-only fill:

    python -m swtpu_torch.bench_sweep --grid square --quick --out sweep.jsonl
    python -m swtpu_torch.bench_sweep --grid rect --plan stripe

Plans: ``stripe`` launches the register-blocked score-only kernel (K1 at
this sweep's linear scoring) at ``choose_exec``'s (T, R, C); ``scan`` the
plain sweep; ``host`` the native serial fill and ``host-simd`` the striped
SIMD fill (both on the host, whatever ``--device``); ``auto`` times the
public ``score()`` and records the plan its ``align(traceback=False)``
reports on the same codes (``score()`` transposes a thin pair). A card
plan is timed with CUDA events, the fastest of ``--repeats`` rounds of k
calls; a host plan, or any plan on ``--device cpu``, with the host clock.
``compile_s`` is the first call (the kernel library's build and load
included), and ``extra.score`` the answer. The first line is a
``backend-init-<grid>`` record: the time to bring up the device and fetch
one small result back, kept out of every size's row.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

K = 5                      # calls a round


def _grid(name: str, quick: bool):
    if name == "square":
        # reference: {32..26000..512} (run-v1.sh); quick subsamples
        sizes = list(range(32, 26001, 512))
        if quick:
            sizes = [32, 1056, 4128, 10272, 25632]
        return [(s, s) for s in sizes]
    if name == "rect":
        # reference: 2000 x {2..150000..5000} (run-v0.sh, run-v6.3.sh)
        widths = list(range(2, 150001, 5000))
        if quick:
            widths = [2, 25002, 75002, 145002]
        return [(w, 2000) for w in widths]
    raise ValueError(name)


def _best_of(call, repeats: int, k: int, dev: torch.device,
             host: bool) -> float:
    """Seconds a call: the fastest of ``repeats`` rounds of k calls, by
    CUDA events on a card unless ``host``, else by the host clock."""
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda" and not host:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                call()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                call()
            dt = time.perf_counter() - t0
        best = min(best, dt / k)
    return best


def _first(call):
    """(result, seconds) of the first call."""
    t0 = time.perf_counter()
    out = call()
    return out, time.perf_counter() - t0


def _time_plan(plan: str, m: int, n: int, repeats: int, k: int = K,
               device="cuda"):
    """(fill seconds, first-call seconds, score, plan that ran) of one
    plan at m x n on the seeded pair ``random_pair(m, n, seed=0)``."""
    from . import runtime_native as rn
    from .core.encode import random_pair
    from .engine.align import align, resolve_device, score
    dev = resolve_device(device)
    a, b = random_pair(m, n, seed=0)
    if plan == "host":
        out, first = _first(lambda: rn.fill(a, b))
        fill = _best_of(lambda: rn.fill(a, b), repeats, k, dev, True)
        return fill, first, int(out.max_score), plan
    if plan == "host-simd":
        if not rn.simd_eligible(m, n):
            raise ValueError(f"host-simd refuses {m}x{n}: "
                             + rn.simd_reject_reason(m, n))
        got, first = _first(lambda: rn.score_simd(a, b))
        fill = _best_of(lambda: rn.score_simd(a, b), repeats, k, dev, True)
        return fill, first, int(got), plan
    if plan == "auto":
        # the plan score() takes: align(traceback=False) on the codes it
        # hands on (transposed when thin)
        x, y = (b, a) if m > 2 * n else (a, b)
        ran = align(x, y, traceback=False, device=dev).plan
        got, first = _first(lambda: score(a, b, device=dev))
        host = ran in ("host", "host-simd")
        fill = _best_of(lambda: score(a, b, device=dev), repeats, k, dev,
                        host)
        return fill, first, int(got), ran
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    if plan == "stripe":
        from .dispatch.plan import choose_exec
        from .kernels.stripe_fill import stripe_score
        ep = choose_exec(m, n, device=dev)
        shape = (dict(T=ep.T, R=ep.R, C=ep.C) if ep.plan == "stripe"
                 else {})

        def call():
            return stripe_score(at, bt, **shape).best
    elif plan == "scan":
        from .kernels.scan_fill import scan_fill

        def call():
            return scan_fill(at, bt).max_score
    else:
        raise ValueError(f"unknown plan {plan!r}")
    out, first = _first(lambda: call().tolist())
    fill = _best_of(call, repeats, k, dev, False)
    got = out[0] if isinstance(out, list) else out
    return fill, first, int(got), plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="swtpu_torch.bench_sweep")
    ap.add_argument("--grid", choices=["square", "rect"], default="square")
    ap.add_argument("--plan",
                    choices=["stripe", "scan", "host", "host-simd", "auto"],
                    default="auto")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="subsample the reference grid")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)

    from .engine.align import resolve_device
    from .instrument.metrics import BenchRecord, device_name

    dev = resolve_device(args.device)
    sink = open(args.out, "a") if args.out else sys.stdout
    try:
        # device bring-up OUTSIDE any row's timing: the first call of a
        # process pays the context's creation; it is its own record
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.init()
        (torch.zeros(8, dtype=torch.int32, device=dev) + 1).tolist()
        init_s = time.perf_counter() - t0
        backend = device_name(dev)
        print(BenchRecord(name=f"backend-init-{args.grid}", m=0, n=0,
                          fill_s=init_s, plan="-", backend=backend,
                          extra={"init_s": round(init_s, 3)}).to_json(),
              file=sink, flush=True)
        for m, n in _grid(args.grid, args.quick):
            fill_s, compile_s, score, plan = _time_plan(
                args.plan, m, n, args.repeats, device=dev)
            host = plan in ("host", "host-simd")
            rec = BenchRecord(name=f"sweep-{args.grid}", m=m, n=n,
                              repeats=args.repeats, fill_s=fill_s,
                              compile_s=compile_s, plan=plan,
                              backend=device_name("cpu") if host
                              else backend,
                              extra={"score": score})
            print(rec.to_json(), file=sink, flush=True)
    finally:
        if args.out:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
