"""Rehearse a cell on several ranks through the runner, before its cell
exists: the pipeline's call of a cell on four cards (kind ``mesh_pair``),
a planted fault on a worker (kind ``lockstep``), and the time the plain
reference takes for a slice of a pair.

    python3 benchmarks/tests/rehearse.py mesh --size 1072950 1044459 \\
        --devices cuda:0 cuda:0 cuda:0 cuda:0 --no-reference
    python3 benchmarks/tests/rehearse.py fault --fault die 2 3 \\
        --devices cuda:0 cuda:1 cuda:2 cuda:3 --limit 60
    python3 benchmarks/tests/rehearse.py reference --rows 4096 \\
        --cols 1072950 --pairs 2 --extrapolate 1044459

From the root of a checkout. ``mesh`` and ``fault`` print the run's result
line last, as ``benchmarks/run.py`` does, with ``seconds_a_call`` (the
window over the calls) beside it; ``reference`` prints the seconds of
``reference.sw.pairs`` and, with ``--extrapolate``, the seconds the same
columns would take at that many rows. The configuration is CUDAlign's
DNA scoring (``CUDALIGN``): +1/-3, the first gap letter -5 and each
further -2, int32.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent

CUDALIGN = {"alphabet": "ACGT", "precision": "int32",
            "scoring": {"mode": "affine", "match": 1, "mismatch": -3,
                        "gap_open": -5, "gap_extend": -2}}
CELL = "rehearsal"


def spec() -> dict:
    """BENCHMARK.json with one more cell of four chips, ``CELL``, that
    reports ``setup_s`` and ``gcups``, and traced ``fill_roofline_pct``
    and ``device_idle_pct``."""
    from benchmarks.harness import bench
    s = bench.load_json(ROOT / "BENCHMARK.json")
    s["configs"].append({"name": CELL, "file": "", "reduced": []})
    s["workloads"].append({"name": CELL, "config": CELL, "traffic": CELL,
                           "chips": 4})
    s["end_to_end"].append({"name": "gcups", "unit": "GCUPS",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": [CELL]})
    for name, unit, better in (("fill_roofline_pct", "%", "higher"),
                               ("device_idle_pct", "%", "lower")):
        s["per_layer"].append({"name": name, "unit": unit, "better": better,
                               "source": "device_trace", "layer": CELL,
                               "moves": "gcups", "workloads": [CELL]})
    return s


def run(mix: dict, devices: list, program: str, seconds: float = 1.0,
        config: dict = None, limit_s: float = 300.0, seed: int = 2**31 + 41,
        t0: float = None, log=print, traced: bool = False) -> dict:
    """The rehearsal cell's run on ``devices`` (one rank each) with the
    test kinds, and ``seconds_a_call`` beside its result."""
    from benchmarks.harness import bench, traffic
    kinds = traffic.KINDS
    traffic.KINDS = HERE / "kinds"
    try:
        r = bench.run_cell(spec(), CELL, seed, seconds, traced,
                           time.perf_counter() if t0 is None else t0,
                           api=program, config=config or CUDALIGN, mix=mix,
                           log=log, devices=devices, limit_s=limit_s)
    finally:
        traffic.KINDS = kinds
    if "size" in mix and "gcups" in r["metrics"] and r["failed"] == 0:
        r["seconds_a_call"] = (mix["size"][0] * mix["size"][1]
                               / (r["metrics"]["gcups"]["value"] * 1e9))
    return r


def reference_seconds(rows: int, cols: int, pairs: int, device,
                      seed: int = 7) -> float:
    """Seconds of ``reference.sw.pairs`` for ``pairs`` pairs of ``cols``
    columns and ``rows`` rows at once, CUDAlign's scoring."""
    import numpy as np
    import torch
    from benchmarks.reference import sw
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (pairs, cols)).astype(np.int8)
    b = a[:, :rows].copy()
    sc = sw.Scoring.of(CUDALIGN["scoring"])
    sw.pairs(a[:, :4096], b[:, :256], sc, device=device)      # warm
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    sw.pairs(a, b, sc, device=device)
    return time.perf_counter() - t


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("mesh", "fault", "reference"))
    p.add_argument("--devices", nargs="+", default=["cuda:0"] * 4)
    p.add_argument("--size", type=int, nargs=2, default=[16384, 16384])
    p.add_argument("--plan", default=None,
                   help="align()'s plan (default: the program chooses)")
    p.add_argument("--substitutions", type=float, default=0.01)
    p.add_argument("--no-reference", action="store_true")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--seed", type=int, default=2**31 + 41)
    p.add_argument("--limit", type=float, default=300.0)
    p.add_argument("--fault", nargs=3, default=None)
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--cols", type=int, default=1072950)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--extrapolate", type=int, default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(HERE)]
    if args.what == "reference":
        s = reference_seconds(args.rows, args.cols, args.pairs,
                              args.devices[0])
        out = {"rows": args.rows, "cols": args.cols, "pairs": args.pairs,
               "seconds": s}
        if args.extrapolate:
            out["extrapolated_rows"] = args.extrapolate
            out["extrapolated_seconds"] = s * args.extrapolate / args.rows
        print(json.dumps(out))
        return 0
    with tempfile.TemporaryDirectory(prefix="rehearse_") as tmp:
        r = _rehearse(args, tmp)
    print(json.dumps(r))
    return 0


def _rehearse(args, tmp: str) -> dict:
    if args.what == "mesh":
        mix = {"kind": "mesh_pair", "size": args.size, "plan": args.plan,
               "substitutions": args.substitutions,
               "reference": not args.no_reference}
        program = "swtpu_torch"
    else:
        what, rank, call = args.fault
        mix = {"kind": "lockstep", "warm": 2, "cells": 1, "log": tmp,
               "fault": [what, int(rank), int(call)]}
        program = "rank_faults"
    return run(mix, args.devices, program, args.seconds, limit_s=args.limit,
               seed=args.seed, t0=_T0, traced=bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
