"""Small versions of the cells' configurations and mixes, for the CPU."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(path: str) -> dict:
    with open(ROOT / path) as f:
        return json.load(f)


def dna() -> dict:
    return dict(load("benchmarks/configs/upstream-dna.json"),
                reference_length=3000)


def protein() -> dict:
    cfg = load("benchmarks/configs/swissprot-blosum62.json")
    return dict(cfg, database_entries=40, queries=cfg["queries"][:2])


def mix(traffic: str, **over) -> dict:
    """The cell's mix with its sizes cut to a CPU test's."""
    m = load(f"benchmarks/traffic/{traffic}.json")
    cut = {"pairs": dict(pool=4, size=[48, 48]),
           "database": dict(sample_entries=12),
           "reads": dict(reads=8, read_length=60, pad_to=62,
                         substitutions=2, window=400, batches=2,
                         sample_reads=6)}[m["kind"]]
    return {**m, **cut, **over}


CELLS = {  # workload -> (configuration, mix)
    "dna-score-25632": (dna, "score-25632"),
    "dna-align-25632": (dna, "align-25632"),
    "protein-dbsearch": (protein, "dbsearch-cycle"),
    "dna-readsearch": (dna, "readsearch-1024x150"),
}


def cell(name: str, **over) -> tuple:
    cfg, traffic = CELLS[name]
    return cfg(), mix(traffic, **over)
