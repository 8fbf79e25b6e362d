"""End-to-end protein search with swtpu_torch: BLOSUM62 + affine gaps.

    python examples/torch_protein_search.py [--device cuda|cpu]

The port's twin of ``examples/protein_search.py``: a batch of peptide
queries is scored against a protein database with the substitution table
on the card (the window kernel K6 in its table form), and the best hit
gets an exact Gotoh alignment. ``SWTPU_DEMO_DB`` and
``SWTPU_DEMO_QUERIES`` (the port's own; the twin has no size variables)
cut the database and the number of planted queries from their defaults,
the twin's 100000 and 200, for a quick run on the CPU.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import swtpu_torch                                        # noqa: E402
from swtpu_torch.core.encode import PROTEIN_ALPHABET      # noqa: E402
from swtpu_torch.core.substitution import BLOSUM62        # noqa: E402
from swtpu_torch.dist.database import pad_queries, search  # noqa: E402
from swtpu_torch.engine.align import resolve_device       # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_protein_search.py")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(1)
    scoring = swtpu_torch.Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    db_len = int(os.environ.get("SWTPU_DEMO_DB", 100_000))
    n_queries = int(os.environ.get("SWTPU_DEMO_QUERIES", 200))

    # demo database: one long concatenated protein sequence
    db = rng.integers(0, 20, db_len).astype(np.int8)

    # queries: mutated fragments of the database + one random decoy
    queries = []
    for _ in range(n_queries):
        pos = int(rng.integers(0, len(db) - 64))
        q = db[pos:pos + 64].copy()
        muts = rng.integers(0, 64, 6)
        q[muts] = (q[muts] + rng.integers(1, 20, 6)) % 20
        queries.append(q)
    queries.append(rng.integers(0, 20, 64).astype(np.int8))
    padded = pad_queries(queries, 64)

    t0 = time.perf_counter()
    hits = search(padded, db, scoring=scoring, substitution=BLOSUM62,
                  device=dev)
    scores = hits.scores.cpu().numpy()
    pos = hits.ref_pos.cpu().numpy()
    dt = time.perf_counter() - t0
    cells = padded.shape[0] * 64 * len(db)
    print(f"searched {padded.shape[0]} peptides x {len(db)/1e3:.0f} kaa "
          f"in {dt:.1f}s incl. kernel build ({cells/dt/1e9:.2f} GCUPS)")

    best = int(np.argmax(scores))
    end = int(pos[best])
    lo = max(0, end - 100)
    window = db[lo:end + 1]
    aln = swtpu_torch.align(window, queries[best], scoring=scoring,
                            substitution=BLOSUM62, alphabet=PROTEIN_ALPHABET,
                            device=dev)
    print(f"best hit: query{best} score {int(scores[best])} "
          f"ending at database position {end}")
    print(f"  query: {aln.aligned_b}")
    print(f"  db   : {aln.aligned_a}")
    assert int(scores[best]) == aln.max_score, (int(scores[best]),
                                                aln.max_score)
    print("traceback re-score: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
