"""CLI — mirrors the reference binaries' interface.

``python -m swtpu_torch``               -> builtin golden example with asserts
``python -m swtpu_torch <cols> <rows>`` -> random pair of that size, timed
``python -m swtpu_torch map ref.fa reads.fa [reads2.fa]`` -> SAM on stdout
(``map_main``; ``--help`` lists its flags)

``--device`` picks the torch device (default ``cuda``; ``cpu`` runs the
scan plan), ``--plan`` forces an execution plan, ``--skip-backtrack`` is
the score-only benchmark mode, ``--band`` keeps the cells with
|i-j| <= band, ``--debug`` prints H and the arrow predecessor matrix and
``--sanitize`` runs the stripe kernel's structural sanitizer on the pair.
``--affine`` takes Gotoh gaps (``--gap-open``, ``--gap-extend``);
``--blosum62`` aligns random 20-letter protein pairs from ``--seed`` under
BLOSUM62 and needs explicit sizes, e.g.
``python -m swtpu_torch 60 50 --blosum62 --affine --gap-open -11
--gap-extend -1 --device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def map_main(argv) -> int:
    """``python -m swtpu_torch map ref.fa reads.fa``: FASTA/FASTQ in, SAM
    out, the whole mapping pipeline (``map_reads``) from the shell, on
    ``--device`` (default cuda)."""
    ap = argparse.ArgumentParser(
        prog="swtpu_torch map",
        description="Map reads against a reference; print SAM")
    ap.add_argument("ref_fasta",
                    help="reference FASTA (multi-record/chromosome OK)")
    ap.add_argument("reads_fasta", nargs="+",
                    help="reads FASTA/FASTQ; TWO files = paired-end "
                         "(mate1 mate2, FR orientation)")
    ap.add_argument("-o", "--output", default="-", help="SAM path or '-'")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--min-insert", type=int, default=0)
    ap.add_argument("--max-insert", type=int, default=1000,
                    help="proper-pair template-length bounds (paired mode)")
    ap.add_argument("--no-unmapped", action="store_true",
                    help="suppress flag-4 records for unmapped reads")
    ap.add_argument("--sec-resolution", type=int, default=2048,
                    help="secondary-locus window clamp (larger = "
                         "faster sweep; nearer same-window loci "
                         "collapse)")
    ap.add_argument("--sort", action="store_true",
                    help="coordinate-sort the output (SO:coordinate; "
                         "default order is best-score-first)")
    ap.add_argument("--strand", default="both",
                    choices=["both", "forward"])
    ap.add_argument("--window", type=int, default=32768)
    ap.add_argument("--top", type=int, default=None,
                    help="only report the best K hits (default: all >0)")
    ap.add_argument("--min-score", type=int, default=1)
    ap.add_argument("--secondary", action="store_true",
                    help="also EMIT each read's second-best locus as a "
                         "flag-256 record (the second locus is always "
                         "searched — it feeds MAPQ and the XS:i tag)")
    ap.add_argument("--match", type=int, default=3)
    ap.add_argument("--mismatch", type=int, default=-3)
    ap.add_argument("--gap", type=int, default=-2)
    ap.add_argument("--affine", action="store_true")
    ap.add_argument("--gap-open", type=int, default=None)
    ap.add_argument("--gap-extend", type=int, default=None)
    ap.add_argument("--blosum62", action="store_true",
                    help="protein mode: BLOSUM62 scoring, protein-alphabet "
                         "FASTA, affine -11/-1 defaults, forward-only")
    args = ap.parse_args(argv)

    from . import Scoring
    from .dist.database import to_sam
    from .core.seqfile import read_seqfile, seq_names, seq_quals

    sub = None
    alphabet = None
    if args.blosum62:
        from .core.encode import PROTEIN_ALPHABET
        from .core.substitution import BLOSUM62
        sub, alphabet = BLOSUM62, PROTEIN_ALPHABET
        args.affine = True
        args.strand = "forward"
    gap_open = args.gap_open if args.gap_open is not None \
        else (-11 if args.blosum62 else -4)
    gap_extend = args.gap_extend if args.gap_extend is not None else -1
    ref_seqs = read_seqfile(args.ref_fasta, alphabet=alphabet)
    ref_names = seq_names(args.ref_fasta)
    if len(ref_names) != len(ref_seqs):
        ref_names = [f"ref{i}" for i in range(len(ref_seqs))]
    paired = len(args.reads_fasta) == 2
    if len(args.reads_fasta) > 2:
        print("at most two read files (mate1 mate2)", file=sys.stderr)
        return 2
    if paired and (args.blosum62 or args.strand != "both"
                   or args.secondary):
        print("paired mode needs both DNA strands and owns the second "
              "locus (no --blosum62/--strand forward/--secondary)",
              file=sys.stderr)
        return 2
    reads = read_seqfile(args.reads_fasta[0], alphabet=alphabet)
    names = seq_names(args.reads_fasta[0])
    if len(names) != len(reads):
        names = [f"read{i}" for i in range(len(reads))]
    reads2 = None
    if paired:
        reads2 = read_seqfile(args.reads_fasta[1], alphabet=alphabet)
        if len(reads2) != len(reads):
            print("mate files differ in read count", file=sys.stderr)
            return 1
        # mates share one QNAME; drop conventional /1 /2 suffixes
        names = [n[:-2] if n.endswith(("/1", "/2")) else n for n in names]
    scoring = Scoring(match=args.match, mismatch=args.mismatch,
                      gap=args.gap, gap_open=gap_open,
                      gap_extend=gap_extend,
                      mode="affine" if args.affine else "linear")
    if not reads or not ref_seqs or \
            max((len(r) for r in reads + (reads2 or [])), default=0) == 0:
        print("no reads or empty reference", file=sys.stderr)
        return 1
    from .dist.mapping import map_reads
    t0 = time.perf_counter()
    res = map_reads(ref_seqs, reads, reads2=reads2, ref_names=ref_names,
                    scoring=scoring, substitution=sub,
                    strand=args.strand, window=args.window,
                    min_score=args.min_score, top=args.top,
                    secondary=args.secondary,
                    min_insert=args.min_insert,
                    max_insert=args.max_insert,
                    unmapped=not args.no_unmapped, sort=args.sort,
                    sec_resolution=args.sec_resolution, device=args.device)
    dt = time.perf_counter() - t0
    nreads = len(res.reads_all)
    reflen = sum(len(s) for s in ref_seqs)
    qlen = max(len(r) for r in res.reads_all)
    print(f"mapped {nreads} reads x {reflen} reference bases in "
          f"{dt:.2f}s ({nreads * qlen * reflen / dt / 1e9:.1f} GCUPS "
          "effective, incl. any kernel build)", file=sys.stderr)
    names_all = names + names if paired else names
    quals = seq_quals(args.reads_fasta[0])
    if paired:
        quals = quals + seq_quals(args.reads_fasta[1])
    if len(quals) != nreads or all(q is None for q in quals):
        quals = None                   # FASTA input: no QUAL column
    recs = res.records
    cl = "swtpu_torch map " + " ".join(argv)
    # one record: @SQ from ref_name/ref_len; several: from res.sq
    sam = to_sam(recs, res.reads_all, ref_name=ref_names[0],
                 ref_len=len(ref_seqs[0]), read_names=names_all,
                 alphabet=alphabet, quals=quals, pg=cl, so=res.so, sq=res.sq)
    if args.output == "-":
        sys.stdout.write(sam)
    else:
        with open(args.output, "w") as f:
            f.write(sam)
        print(f"wrote {len(recs)} records to {args.output}",
              file=sys.stderr)
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "map":
        return map_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="swtpu_torch",
        description="Smith-Waterman alignment on PyTorch/CUDA")
    ap.add_argument("m", nargs="?", type=int, default=None,
                    help="columns (length of a)")
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="rows (length of b)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--plan", default=None,
                    choices=["host", "scan", "stripe", "pipeline", "auto"],
                    help="execution plan (default: dispatch by device, "
                         "size and the tuned table)")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the stripe kernel's structural sanitizer on "
                         "this input (every cell captured and checked "
                         "against the oracle; the DEBUG memory-check "
                         "analog)")
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

    if args.sanitize:
        from .instrument.sanitize import sanitize_stripe
        rep = sanitize_stripe(a, b, scoring=scoring, substitution=sub,
                              device=device)
        print(f"Sanitizer: OK — {rep.valid_cells} cells bit-checked, "
              f"{rep.prestart_cells} pre-start, {rep.garbage_cells} "
              f"garbage slots verified (config {rep.config})")

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
