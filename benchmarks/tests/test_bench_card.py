"""On the card: the reference there equals the reference on the CPU, and
a short run of a cell prints a correct result line last."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmarks.reference import sw

from small import ROOT, load

pytestmark = pytest.mark.gpu


def test_reference_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, (3, 700))
    b = rng.integers(0, 4, (3, 650))
    assert np.array_equal(sw.pairs(a, b, sw.Scoring(), device=card),
                          sw.pairs(a, b, sw.Scoring()))
    table = np.asarray(load("benchmarks/configs/swissprot-blosum62.json")
                       ["substitution"], np.int32)
    prot = sw.Scoring(mode="affine", gap_open=-12, gap_extend=-1)
    qs = [rng.integers(0, 20, n) for n in (50, 130)]
    es = [rng.integers(0, 20, n) for n in (2, 90, 600, 33)]
    for x, y in zip(sw.database(qs, es, prot, table, device=card),
                    sw.database(qs, es, prot, table)):
        assert np.array_equal(x, y)


def test_a_short_run_is_correct(card):
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "dna-score-25632",
         "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert {"gcups.score", "call_p95_ms.score", "setup_s"} <= set(r["metrics"])
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
