"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 benchmarks/run.py --workload dna-score-25632 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. It makes the cell's inputs from ``--seed``,
warms every shape the cell's calls use (set-up), then one client calls the
program's public API back to back for ``--seconds`` seconds, each call
waiting for its answer. With ``--trace 0`` it reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones from a
``torch.profiler`` trace of the window. After the window it holds the
answers to the plain reference (``benchmarks/reference/``) and prints each
number compared beside its limit, last on standard error and last in the
result, the one JSON object on the last line of standard output.

It exits non-zero and prints no result where there is no CUDA card, or
fewer than the cell asks for, where the program cannot be imported, or
where JAX or the JAX package was loaded by the time the window closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed takes a whole number from 0")
    sys.path.insert(0, str(ROOT))
    from benchmarks.harness import bench

    spec = bench.load_json(ROOT / "BENCHMARK.json")
    try:
        cell, _ = bench.cell_of(spec, args.workload)
    except bench.Refused as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = bench.run_cell(spec, args.workload, args.seed, args.seconds,
                                bool(args.trace), _T0)
    except bench.Refused as e:
        print(e, file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
