"""The control of a cell's comparison, at the cell's own size.

    python3 benchmarks/control.py --workload dna-score-25632 --seeds 1 2 3

For each seed it makes the cell's inputs, puts the plain reference in the
program's place computed in the integer width just below the
configuration's ``precision`` (saturating: int16 below int32, int8 below
int16), and holds those answers to the same comparison a run holds the
program's answers to, one answer for each distinct input of the cell. It
prints one JSON line per seed with each number compared and its limit; a
sound comparison finds the control wrong. Beside them: the highest score
the full-width reference answers (``highest``) and the highest any call of
the cell could answer (``ceiling``), the evidence for the precision. The benchmark's own runs never run this. On a CUDA card where
there is one, else on the CPU (slow at the cells' sizes).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmarks.harness import bench
    from benchmarks.harness.traffic import build
    from benchmarks.reference.sw import BELOW, CAPS

    spec = bench.load_json(ROOT / "BENCHMARK.json")
    cell, centry = bench.cell_of(spec, args.workload)
    config = bench.load_json(ROOT / centry["file"])
    mix = bench.load_json(ROOT / "benchmarks" / "traffic"
                          / f"{cell['traffic']}.json")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    width = BELOW[config["precision"]]
    for seed in args.seeds:
        t0 = time.perf_counter()
        wl = build(config, mix, seed, device)
        ks = list(range(wl.distinct))
        full = wl.control(ks, device, None)
        got = wl.check(wl.control(ks, device, CAPS[width]), device)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "precision": config["precision"], "control": width,
            "highest": max(int(wl.scores(a).max()) for _, a in full),
            "ceiling": wl.highest_possible(), "answers": len(ks),
            "seconds": time.perf_counter() - t0,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in got},
            "fails": any(v > lim for _, v, lim in got)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
