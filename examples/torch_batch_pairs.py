#!/usr/bin/env python
"""Batched pair scoring with swtpu_torch: one call for many small alignments.

The port's twin of ``examples/batch_pairs.py``. The reference processes
ONE pair per process; below a few thousand squared a single card call is
dominated by its per-call floor, so the answer to many small problems is
batching. ``batch_score``'s auto plan runs the register-blocked batch
kernel (K8, ``csrc/stripe_rb_pairs.cu``) on a card, B pairs of one shape
in one launch; on the CPU the plain batched sweep.

Run: python examples/torch_batch_pairs.py [B] [size] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swtpu_torch.core.encode import random_batch    # noqa: E402
from swtpu_torch.dist.batch import batch_score      # noqa: E402
from swtpu_torch.instrument.metrics import block    # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_batch_pairs.py")
    ap.add_argument("B", nargs="?", type=int, default=64)
    ap.add_argument("size", nargs="?", type=int, default=1056)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    B, size = args.B, args.size
    a, b = random_batch(B, size, size, seed=0)
    # plant a strong alignment in pair 3 so the output is non-trivial
    b[3, 10: 10 + size // 2] = a[3, 5: 5 + size // 2]

    t0 = time.perf_counter()
    hits = block(batch_score(a, b, device=args.device))
    scores = hits.scores.cpu().numpy()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    block(batch_score(a, b, device=args.device))    # warm: steady state
    warm = time.perf_counter() - t0

    print(f"{B} pairs of {size}x{size}: cold {cold * 1e3:.1f} ms "
          f"(kernel build and load included), warm {warm * 1e3:.1f} ms "
          f"= {B * size * size / warm / 1e9:.2f} effective GCUPS")
    top = np.argsort(-scores)[:5]
    for g in top:
        print(f"  pair {g:3d}: score {scores[g]:6d} at "
              f"(i={int(hits.max_i[g])}, j={int(hits.max_j[g])})")
    assert int(np.argmax(scores)) == 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
