#!/usr/bin/env python
"""Mapping benchmark of swtpu_torch, cold and warm.

The port's counterpart of ``scripts/map_cpu_warm.py``: ``map_reads`` on
the planted-read workload of ``synth_mapping_workload`` (2000 reads of
100 bases with 2 % errors against a 1 Mb reference), called twice in one
process, the first call cold (the kernel library's build and load, the
first launches) and the second warm. Prints one JSON line, and writes it
to ``--out`` when given:

    python scripts/torch_map_warm.py                 # on the card
    python scripts/torch_map_warm.py --device cpu --out map.json
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swtpu_torch.dist.mapping import map_reads           # noqa: E402
from swtpu_torch.engine.align import resolve_device      # noqa: E402
from swtpu_torch.instrument.metrics import device_name   # noqa: E402

# the workload's reference length, reads and read length
L, B, QLEN = 1_000_000, 2000, 100


def synth_mapping_workload(L=1_000_000, B=2000, qlen=100, seed=7,
                           err=0.02):
    """The mapping benchmark's workload: B reads of qlen planted in a
    random reference of L bases, each base mutated with probability err
    (the same draws as the JAX package's scripts, so both packages map the
    same reads)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L).astype(np.int8)
    reads = []
    for _ in range(B):
        s = int(rng.integers(0, L - qlen))
        r = ref[s:s + qlen].copy()
        errs = rng.random(qlen) < err
        r[errs] = (r[errs] + rng.integers(1, 4, errs.sum())) % 4
        reads.append(r)
    return ref, reads


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="torch_map_warm.py")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ref, reads = synth_mapping_workload(L, B, QLEN)
    t0 = time.perf_counter()
    map_reads(ref, reads, device=dev)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = map_reads(ref, reads, device=dev)
    warm = time.perf_counter() - t0
    mapped = sum(1 for r in res.records if not r.is_unmapped)
    out = {"name": "map-torch-warm", "B": B, "qlen": QLEN, "L": L,
           "mapped": mapped, "device": device_name(dev),
           "cold_s": round(cold, 3), "cold_reads_per_s": round(B / cold, 1),
           "warm_s": round(warm, 3), "warm_reads_per_s": round(B / warm, 1),
           "note": "both-strand top-2 search + hit alignment, warm = "
                   "second call in the same process"}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
