"""The port's pipeline across ranks at CUDAlign's scores against the plain
row reference (``tests/plain_rows.py``), on the CPU, and its spans and
counters.

Four gloo ranks (``swtpu_torch.dist.dryrun.launch``) run
``pipeline_align`` with block rows that make several blocks and leave
ranks idle at the wavefront's ends (203 x 190 at 16 rows a block: 12
blocks; 1000 x 977 at 123: 8 blocks), and ``align(mesh=,
plan='pipeline')`` at its own block rows, on meshes of 2 and 4 ranks, in
CUDAlign's affine DNA scores (+1 / -3, gaps -5 / -2) and the upstream's
linear ones (+3 / -3 / -2). Each pair is a copy of a random sequence with
letters deleted and substituted, as the benchmark's megabase cell makes
its pair. Every rank's answer must equal the reference's exactly.

Under a running profiler the call's pipeline spans come in the order the
stages run them, each rank counts its stages, the stages in which it
filled a block, the bytes it sent and the block rows, once a pass; with
no profiler the same call records nothing.
"""

import json

import numpy as np
import pytest

import plain_rows
from swtpu_torch.core.config import Scoring
from swtpu_torch.dist.dryrun import launch, run_calls

CUDALIGN = Scoring(mode="affine", match=1, mismatch=-3, gap_open=-5,
                   gap_extend=-2)
UPSTREAM = Scoring(match=3, mismatch=-3, gap=-2)
SCORINGS = {"cudalign": CUDALIGN, "upstream": UPSTREAM}
# (m, n, block rows, seed)
SHAPES = {"203x190": (203, 190, 16, 41), "1000x977": (1000, 977, 123, 42)}
WORLDS = (2, 4)


def mutated_pair(m: int, n: int, seed: int, substitutions: float = 0.05):
    """a of m uniform letters; b a copy with m - n letters deleted at
    seeded places and a share of the rest substituted."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, m).astype(np.int8)
    b = a[np.sort(rng.choice(m, size=n, replace=False))]
    sub = np.flatnonzero(rng.random(n) < substitutions)
    b[sub] = (b[sub] + rng.integers(1, 4, len(sub))) % 4
    return a, b


def _cases() -> dict:
    cases = {}
    for sc, scoring in SCORINGS.items():
        for shape, (m, n, rows, seed) in SHAPES.items():
            a, b = mutated_pair(m, n, seed)
            for D in WORLDS:
                cases[f"blocks-{shape}-{sc}-D{D}"] = (
                    "seq", D, "pipeline_align",
                    dict(a=a, b=b, block_rows=rows, scoring=scoring))
                cases[f"align-{shape}-{sc}-D{D}"] = (
                    "seq", D, "align",
                    dict(a=a, b=b, plan="pipeline", traceback=False,
                         scoring=scoring))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def ranks():
    ids = list(CASES)
    per_rank = launch(4, run_calls, ([CASES[k] for k in ids],),
                      device="cpu", timeout=300)
    return {k: [r[i] for r in per_rank] for i, k in enumerate(ids)}


def _answer(got) -> tuple:
    """(score, i, j, last) of a PipelineResult or an Alignment."""
    if isinstance(got, tuple):
        f = got[1]
        return tuple(int(f[k]) for k in ("max_score", "max_i", "max_j",
                                         "last_cell"))
    assert got["plan"] == "pipeline"
    return tuple(int(got[k]) for k in ("max_score", "max_i", "max_j",
                                       "last_cell"))


@pytest.mark.parametrize("case", list(CASES))
def test_the_pipeline_equals_the_row_reference(ranks, case):
    _, shape, sc, d = case.split("-")
    D = int(d[1:])
    kw = CASES[case][3]
    want = plain_rows.pair(kw["a"], kw["b"], SCORINGS[sc])
    got = ranks[case]
    for r in range(4):
        if r < D:
            assert _answer(got[r]) == want, (r, _answer(got[r]), want)
        else:
            assert got[r] is None
    assert want[0] > 0 and want[1:3] != (0, 0)


# ---- spans and counters ----

TRACED = mutated_pair(2200, 2100, 43)     # projected rows: 3 blocks


def _record_stamp() -> dict:
    from swtpu_torch.dispatch.cost import DEFAULT_PIPE_RECORD
    return json.loads(DEFAULT_PIPE_RECORD.read_text())["device"]


@pytest.fixture(scope="module")
def traced_ranks():
    from torch_pipe_ranks import run_traced
    return launch(4, run_traced, (_record_stamp(), *TRACED, CUDALIGN),
                  device="cpu", timeout=300)


@pytest.mark.parametrize("rank", range(4))
def test_no_profiler_records_nothing(traced_ranks, rank):
    plain, left, traced, _, _ = traced_ranks[rank]
    assert left == []
    assert plain["plan"] == traced["plan"] == "pipeline"
    assert _answer(plain) == _answer(traced) == plain_rows.pair(*TRACED,
                                                                CUDALIGN)


def _stages(rows: int, D: int = 4) -> tuple:
    nblocks = -(-len(TRACED[1]) // rows)
    return nblocks, nblocks + D - 1


@pytest.mark.parametrize("rank", range(4))
def test_the_pipeline_spans_come_in_order(traced_ranks, rank):
    _, _, _, recs, rows = traced_ranks[rank]
    spans = sorted((r for r in recs if r[3] is None), key=lambda r: r[1])
    names = [r[0] for r in spans]
    assert names[0] == "swtpu.align" and spans[0][2] == -1
    nblocks, stages = _stages(rows)
    want = ["swtpu.encode", "swtpu.dispatch", "swtpu.pipe.agree",
            "swtpu.pipe", "swtpu.pipe.plan"]
    for t in range(stages):
        if 0 <= t - rank < nblocks:
            want.append("swtpu.pipe.fill")
        want.append("swtpu.pipe.halo")
    want += ["swtpu.pipe.merge", "swtpu.pipe.merge"]
    assert names[1:] == want
    index = {r[1]: r[0] for r in spans}
    # the pipeline's parts lie under swtpu.pipe, the verdict under dispatch
    for name, _, parent, _ in spans[1:]:
        if name == "swtpu.pipe.agree":
            assert index[parent] == "swtpu.dispatch"
        elif name.startswith("swtpu.pipe."):
            assert index[parent] == "swtpu.pipe"


@pytest.mark.parametrize("rank", range(4))
def test_each_rank_counts_its_pass_once(traced_ranks, rank):
    _, _, _, recs, rows = traced_ranks[rank]
    counts = {}
    for name, _, _, value in recs:
        if value is not None and name.startswith("pipe."):
            assert name not in counts, name
            counts[name] = value
    nblocks, stages = _stages(rows)
    assert nblocks > 1 and stages > nblocks
    sent = 0 if rank == 3 else stages * 2 * (rows + 1) * 4
    assert counts == {"pipe.stages": stages, "pipe.blocks": nblocks,
                      "pipe.halo_bytes": sent, "pipe.block_rows": rows}
    assert counts["pipe.blocks"] / counts["pipe.stages"] \
        == nblocks / (nblocks + 3)
