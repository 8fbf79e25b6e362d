"""End-to-end read mapping with swtpu_torch: FASTA in, the database search
on the card, exact alignment strings and SAM out.

    python examples/torch_read_mapping.py [--device cuda|cpu]

The port's twin of ``examples/read_mapping.py``, with the same data and
the same ``SWTPU_DEMO_REF`` and ``SWTPU_DEMO_READS`` sizes (a quick run on
the CPU: ``SWTPU_DEMO_REF=20000 SWTPU_DEMO_READS=50 python
examples/torch_read_mapping.py --device cpu``). Many reads against a long
reference, batched on the device (the window kernel K6), then exact
tracebacks for the hits you care about, and the whole mapping pipeline
(search, pairing, MAPQ, records) as one call.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import swtpu_torch                                      # noqa: E402
from swtpu_torch.core.encode import DNA_ALPHABET, revcomp  # noqa: E402
from swtpu_torch.core.seqfile import read_seqfile       # noqa: E402
from swtpu_torch.dist.database import (make_searcher,   # noqa: E402
                                       pad_queries, shard_reference)
from swtpu_torch.engine.align import resolve_device     # noqa: E402


def write_fasta(path, named):
    with open(path, "w") as f:
        for name, codes in named.items():
            f.write(f">{name}\n")
            f.write("".join(DNA_ALPHABET[c] for c in codes) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_read_mapping.py")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- a demo reference + reads (with mutations), via FASTA files
    ref_len = int(os.environ.get("SWTPU_DEMO_REF", 200_000))
    n_reads = int(os.environ.get("SWTPU_DEMO_READS", 2000))
    ref_codes = rng.integers(0, 4, ref_len).astype(np.int8)
    reads = []
    for k in range(n_reads):
        pos = int(rng.integers(0, len(ref_codes) - 150))
        r = ref_codes[pos:pos + 150].copy()
        muts = rng.integers(0, 150, 5)
        r[muts] = (r[muts] + rng.integers(1, 4, 5)) % 4   # 5 SNPs per read
        reads.append(r)
    reads.append(rng.integers(0, 4, 150).astype(np.int8))  # one random read

    with tempfile.TemporaryDirectory() as d:
        ref_fa = os.path.join(d, "ref.fa")
        reads_fa = os.path.join(d, "reads.fa")
        write_fasta(ref_fa, {"chr_demo": ref_codes})
        write_fasta(reads_fa, {f"read{k}": r for k, r in enumerate(reads)})

        # --- ingest (core/seqfile.py)
        ref = read_seqfile(ref_fa)[0]
        qlist = read_seqfile(reads_fa)
        queries = pad_queries(qlist, 152)

        # --- device search: every read against every reference window;
        # the searcher is built once and reused for every batch
        shards, shard_len = shard_reference(ref, 1, 152)
        searcher = make_searcher(qlen=152, shard_len=shard_len, device=dev)
        q = torch.from_numpy(queries).to(dev)
        sh = torch.from_numpy(shards).to(dev)
        t0 = time.perf_counter()
        hits = searcher(q, sh)
        hits.scores.cpu()
        print(f"(first call incl. kernel build and load: "
              f"{time.perf_counter() - t0:.1f}s)")
        t0 = time.perf_counter()
        hits = searcher(q, sh)
        scores = hits.scores.cpu().numpy()
        dt = time.perf_counter() - t0
        cells = queries.shape[0] * 152 * len(ref)
        print(f"searched {queries.shape[0]} reads x {len(ref)/1e3:.0f} kb "
              f"in {dt:.2f}s ({cells/dt/1e9:.1f} GCUPS effective)")

        # --- exact alignments (coords + CIGAR) for the top hits
        recs = swtpu_torch.align_hits(hits, queries, ref, top=3, device=dev)
        for r in recs:
            print(f"read{r.read}: score {r.score} at "
                  f"ref[{r.ref_start}:{r.ref_end + 1}]  {r.cigar}")
            print(f"  read: {r.aligned_read}")
            print(f"  ref : {r.aligned_ref}")
        assert recs[0].score == int(scores.max())

        # --- and as SAM
        print(swtpu_torch.to_sam(recs, queries, ref_name="chr_demo",
                                 ref_len=len(ref)), end="")

    # --- or: the WHOLE pipeline (search -> pairing -> MAPQ -> records)
    # as one library call, paired-end, with proper-pair flags and mate
    # fields (python -m swtpu_torch map is a file wrapper around this)
    r1 = [ref_codes[5000:5150].copy(), ref_codes[9000:9150].copy()]
    r2 = [revcomp(ref_codes[5300:5450]), revcomp(ref_codes[9350:9500])]
    res = swtpu_torch.map_reads([ref_codes], r1, reads2=r2,
                                ref_names=["chr_demo"], sort=True,
                                device=dev)
    mapped = [r for r in res.records if not r.is_unmapped]
    print(f"\npaired-end map_reads: {len(mapped)} records, proper flags "
          f"{[hex(r.flag_extra) for r in mapped]}, "
          f"TLENs {[r.tlen for r in mapped]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
