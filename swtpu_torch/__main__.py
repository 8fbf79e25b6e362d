"""CLI — mirrors the reference binaries' interface.

``python -m swtpu_torch``               -> builtin golden example with asserts
``python -m swtpu_torch <cols> <rows>`` -> random pair of that size, timed

``--device`` picks the torch device (default ``cuda``; ``cpu`` runs the
scan plan), ``--plan`` forces an execution plan, ``--skip-backtrack`` is
the score-only benchmark mode, ``--band`` keeps the cells with
|i-j| <= band and ``--debug`` prints H and the arrow predecessor matrix.
``--affine`` takes Gotoh gaps (``--gap-open``, ``--gap-extend``);
``--blosum62`` aligns random 20-letter protein pairs from ``--seed`` under
BLOSUM62 and needs explicit sizes, e.g.
``python -m swtpu_torch 60 50 --blosum62 --affine --gap-open -11
--gap-extend -1 --device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="swtpu_torch",
        description="Smith-Waterman alignment on PyTorch/CUDA")
    ap.add_argument("m", nargs="?", type=int, default=None,
                    help="columns (length of a)")
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="rows (length of b)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--plan", default=None,
                    choices=["auto", "stripe", "scan"],
                    help="execution plan (default: dispatch by device)")
    ap.add_argument("--affine", action="store_true",
                    help="affine gaps (Gotoh) instead of linear")
    ap.add_argument("--blosum62", action="store_true",
                    help="protein mode: random 20-letter sequences scored "
                         "with BLOSUM62 (use with --affine --gap-open -11 "
                         "--gap-extend -1 for standard protein params)")
    ap.add_argument("--match", type=int, default=3)
    ap.add_argument("--mismatch", type=int, default=-3)
    ap.add_argument("--gap", type=int, default=-2)
    ap.add_argument("--gap-open", type=int, default=-4)
    ap.add_argument("--gap-extend", type=int, default=-1)
    ap.add_argument("--band", type=int, default=None,
                    help="band half-width: keep cells with |i-j| <= band")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--debug", action="store_true",
                    help="print H and predecessor matrices (-DDEBUG analog)")
    ap.add_argument("--skip-backtrack", action="store_true",
                    help="score-only benchmark mode (-DSKIP_BACKTRACK analog)")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)

    from . import (BUILTIN_A, BUILTIN_B, BUILTIN_LAST_CELL, BUILTIN_MAX_POS,
                   BUILTIN_MAX_SCORE, EngineConfig, Scoring, align,
                   random_pair)
    from .core import oracle
    from .engine.align import resolve_device
    from .instrument.metrics import PhaseTimer, gcups, memory_footprint_bytes
    from .instrument.printers import format_matrix, format_predecessor_matrix

    if (args.m is not None and args.m <= 0) or (args.n is not None and args.n <= 0):
        ap.error("matrix sizes must be positive")
    device = resolve_device(args.device)
    use_builtin = args.m is None or args.n is None
    sub = None
    alphabet_kw = {}
    if args.blosum62:
        from .core.encode import PROTEIN_ALPHABET
        from .core.substitution import BLOSUM62
        sub = BLOSUM62
        alphabet_kw = {"alphabet": PROTEIN_ALPHABET}
        if use_builtin:
            ap.error("--blosum62 needs explicit sizes (protein inputs)")
    if use_builtin:
        a, b = BUILTIN_A, BUILTIN_B
        m, n = len(a), len(b)
        print("Using built-in data for testing ...")
    elif args.blosum62:
        m, n = args.m, args.n
        rng = np.random.default_rng(args.seed)
        a = rng.integers(0, 20, m).astype(np.int8)
        b = rng.integers(0, 20, n).astype(np.int8)
    else:
        m, n = args.m, args.n
        a, b = random_pair(m, n, seed=args.seed)
    print(f"Matrix[{n}][{m}]  ({m*n/1e6:.2f} Mcells, "
          f"~{memory_footprint_bytes(m, n, not args.skip_backtrack)/1e6:.1f}"
          f" MB working set) on {device}")

    scoring = Scoring(
        match=args.match, mismatch=args.mismatch, gap=args.gap,
        gap_open=args.gap_open, gap_extend=args.gap_extend,
        mode="affine" if args.affine else "linear",
    )
    config = EngineConfig(band=args.band, traceback=not args.skip_backtrack)
    kw = dict(scoring=scoring, config=config, plan=args.plan, device=device,
              substitution=sub, **alphabet_kw)

    # the first call on a card builds the kernels; keep it out of the times
    timer = PhaseTimer(device)
    with timer.phase("warmup"):
        align(a, b, **kw)
    print(f"(warmup, including any kernel build: "
          f"{timer.phases['warmup']:.2f}s)")

    res = None
    for _ in range(max(1, args.repeat)):
        timer = PhaseTimer(device)
        with timer.phase("align"):
            res = align(a, b, **kw)
        dt = timer.phases["align"]
        print(f"Elapsed time for scoring matrix computation: {dt:.6f}  "
              f"({gcups(m*n, dt):.3f} GCUPS)")

    print(f"Max score {res.max_score} at (i={res.max_i}, j={res.max_j}) "
          f"[padded row-major index {res.max_pos}]")
    if res.aligned_a is not None:
        print(f"Alignment:\n  a: {res.aligned_a}\n  b: {res.aligned_b}")

    if args.debug:
        r = align(a, b, return_matrices=True, **kw)
        print("\nSimilarity Matrix:")
        sys.stdout.write(format_matrix(r.H))
        print("\nPredecessor Matrix:")
        marked = oracle.mark_path(r.P, r.max_pos) if r.max_score > 0 else r.P
        sys.stdout.write(format_predecessor_matrix(marked))

    if use_builtin and not args.affine and args.band is None:
        ok = (res.max_score == BUILTIN_MAX_SCORE
              and res.max_pos == BUILTIN_MAX_POS
              and res.last_cell == BUILTIN_LAST_CELL)
        print(f"Verifying correctness using builtin data = {int(ok)}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
