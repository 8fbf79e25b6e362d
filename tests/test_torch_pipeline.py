"""The port's column-stripe pipeline across ranks against the JAX
package's, on the CPU.

Four gloo ranks are spawned once for the module (``swtpu_torch.dist.
dryrun.launch``, a ``file://`` store); they build meshes of 1, 2 and 4
ranks and run every case, importing nothing of JAX, and hand back numpy
results. The parent runs the same inputs through ``swtpu.dist.pipeline``
on the 8-virtual-device CPU mesh of ``tests/conftest.py``
(``pipeline_mesh(D, platform="cpu")``, whose block fill is the scan
there). Each case is a parametrised test. Tolerance: exact equality of
every integer and string, at the shapes of ``tests/test_pipeline.py``, in
linear, DNA affine and BLOSUM62 affine; every rank of a mesh must return
the same answer."""

import functools

import numpy as np
import pytest

from swtpu.core import oracle
from swtpu.core.config import Scoring as JScoring
from swtpu.core.encode import random_batch, random_pair
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.dist import pipeline as jpl
from swtpu.dist.mesh import pipeline_mesh
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.core.encode import DNA_ALPHABET, PROTEIN_ALPHABET
from swtpu_torch.dist.dryrun import launch, run_calls

WORLDS = (1, 2, 4)
SCORINGS = {
    "linear": (JScoring(), None),
    "dna_affine": (JScoring(mode="affine", gap_open=-4, gap_extend=-1), None),
    "blosum62": (JScoring(mode="affine", gap_open=-11, gap_extend=-1),
                 J_BLOSUM62),
}
# (m, n, block_rows, seed) of tests/test_pipeline.py, and its tie case
SHAPES = {"64x48_R16": (64, 48, 16, 112), "128x64_R32": (128, 64, 32, 192),
          "80x100_R20": (80, 100, 20, 180), "padded_99x77": (99, 77, 16, 5),
          "tie": (64, 32, 16, None)}
NW_SHAPES = ("64x48_R16", "80x100_R20", "padded_99x77")
TB_SHAPES = ("64x48_R16", "padded_99x77")


def _pair(shape: str, scoring: str):
    m, n, _, seed = SHAPES[shape]
    if seed is None:                       # ACGT x16 against ACGT x8
        return (np.tile(np.arange(4, dtype=np.int8), m // 4),
                np.tile(np.arange(4, dtype=np.int8), n // 4))
    if scoring != "blosum62":
        return random_pair(m, n, seed=seed)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 20, m).astype(np.int8)
    b = rng.integers(0, 20, n).astype(np.int8)
    k = min(m, n) // 3
    b[k:2 * k] = a[k // 2:k // 2 + k]      # a planted homology
    return a, b


def _batch(scoring: str):
    if scoring != "blosum62":
        aa, bb = random_batch(3, 40, 36, seed=11)
        bb[1, 4:30] = aa[1, 10:36]
        return aa, bb
    rng = np.random.default_rng(11)
    aa = rng.integers(0, 20, (3, 40)).astype(np.int8)
    bb = rng.integers(0, 20, (3, 36)).astype(np.int8)
    bb[1, 4:30] = aa[1, 10:36]
    return aa, bb


def _port(scoring: str) -> dict:
    jsc, jsub = SCORINGS[scoring]
    return dict(scoring=scoring_from_jax(jsc),
                substitution=None if jsub is None
                else substitution_from_jax(jsub))


def _cases() -> dict:
    """case id -> (mesh kind, ranks, call, kwargs)."""
    cases = {}
    for sc in SCORINGS:
        for D in WORLDS:
            for shape in SHAPES:
                a, b = _pair(shape, sc)
                cases[f"align-{shape}-{sc}-D{D}"] = (
                    "seq", D, "pipeline_align",
                    dict(a=a, b=b, block_rows=SHAPES[shape][2], **_port(sc)))
            for shape in NW_SHAPES:
                a, b = _pair(shape, sc)
                cases[f"nw-{shape}-{sc}-D{D}"] = (
                    "seq", D, "nw_argmax",
                    dict(a=a, b=b, block_rows=SHAPES[shape][2], **_port(sc)))
            for shape in TB_SHAPES:
                a, b = _pair(shape, sc)
                alphabet = (PROTEIN_ALPHABET if sc == "blosum62"
                            else DNA_ALPHABET)
                cases[f"tb-{shape}-{sc}-D{D}"] = (
                    "seq", D, "pipeline_traceback",
                    dict(a=a, b=b, block_rows=SHAPES[shape][2],
                         alphabet=alphabet, **_port(sc)))
            aa, bb = _batch(sc)
            cases[f"batch-{sc}-D{D}"] = (
                "seq", D, "pipeline_align_batch",
                dict(aa=aa, bb=bb, block_rows=12, **_port(sc)))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def ranks():
    """Every case's result on each of the four ranks (None outside its
    mesh), from one spawn of the group."""
    ids = list(CASES)
    per_rank = launch(4, run_calls, ([CASES[k] for k in ids],),
                      device="cpu", timeout=120)
    return {k: [r[i] for r in per_rank] for i, k in enumerate(ids)}


def _result(ranks, case):
    """Rank 0's answer, held equal on every rank of the case's mesh."""
    got = ranks[case]
    D = CASES[case][1]
    for r in range(4):
        if r < D:
            _same(got[r], got[0])
        else:
            assert got[r] is None
    return got[0]


def _same(x, y):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        np.testing.assert_array_equal(x, y)
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            _same(u, v)
    elif isinstance(x, dict):
        assert x.keys() == y.keys()
        for k in x:
            _same(x[k], y[k])
    else:
        assert x == y


def _fields(got) -> list:
    """The integers of a (name, {field: array}) named tuple, in order."""
    return [np.asarray(v).tolist() for v in got[1].values()]


def _jax(scoring: str, D: int):
    jsc, jsub = SCORINGS[scoring]
    return pipeline_mesh(D, platform="cpu"), jsc, jsub


def _ids(prefix: str) -> list:
    return [k for k in CASES if k.startswith(prefix)]


@pytest.mark.parametrize("case", _ids("align-"))
def test_pipeline_align_matches_jax(ranks, case):
    _, shape, sc, d = case.split("-")
    mesh, jsc, jsub = _jax(sc, int(d[1:]))
    a, b = _pair(shape, sc)
    want = jpl.pipeline_align(a, b, mesh, block_rows=SHAPES[shape][2],
                              scoring=jsc, substitution=jsub)
    got = _result(ranks, case)
    assert got[0] == "PipelineResult"
    assert _fields(got) == [int(x) for x in want]
    ref = oracle.fill(a, b, jsc, sub=jsub)
    assert _fields(got)[:3] == [ref.max_score, *ref.max_ij]
    assert _fields(got)[3] == int(ref.H[-1, -1])


@pytest.mark.parametrize("case", _ids("nw-"))
def test_nw_argmax_matches_jax(ranks, case):
    _, shape, sc, d = case.split("-")
    mesh, jsc, jsub = _jax(sc, int(d[1:]))
    a, b = _pair(shape, sc)
    want = jpl._pipeline_nw_argmax(a, b, mesh, SHAPES[shape][2], jsc, "seq",
                                   substitution=jsub)
    assert tuple(_result(ranks, case)) == tuple(want)


@pytest.mark.parametrize("case", _ids("tb-"))
def test_pipeline_traceback_matches_jax(ranks, case):
    _, shape, sc, d = case.split("-")
    mesh, jsc, jsub = _jax(sc, int(d[1:]))
    a, b = _pair(shape, sc)
    kw = CASES[case][3]
    want = jpl.pipeline_traceback(a, b, mesh, block_rows=SHAPES[shape][2],
                                  scoring=jsc, substitution=jsub,
                                  alphabet=kw["alphabet"])
    score, loc, ra, rb = _result(ranks, case)
    assert (score, tuple(loc), ra, rb) == (want[0], tuple(want[1]),
                                           want[2], want[3])
    assert score == oracle.fill(a, b, jsc, sub=jsub).max_score


@pytest.mark.parametrize("case", _ids("batch-"))
def test_pipeline_align_batch_matches_jax(ranks, case):
    _, sc, d = case.split("-")
    mesh, jsc, jsub = _jax(sc, int(d[1:]))
    aa, bb = _batch(sc)
    want = jpl.pipeline_align_batch(aa, bb, mesh, block_rows=12,
                                    scoring=jsc, substitution=jsub)
    got = _result(ranks, case)
    assert got[0] == "PipelineBatchResult"
    assert _fields(got) == [np.asarray(x).tolist() for x in want]
    for p in range(len(aa)):
        ref = oracle.fill(aa[p], bb[p], jsc, sub=jsub)
        assert [f[p] for f in _fields(got)[:3]] == [ref.max_score,
                                                    *ref.max_ij]


# ---- block rows from the cost model ----
#
# Four more gloo ranks run as cards of the committed H100 cost record
# (``tests/torch_pipe_ranks.py``: the record's stamp, a card a rank), so
# the public calls size the pipeline's blocks by
# ``dispatch.plan.pipeline_projection``; at these shapes its rows differ
# from default_block_rows' n / D. Each answer must equal the JAX package's
# pipeline, and each rank must have filled ceil(n / rows) blocks a pass
# (the plain block fill's calls). "auto" cases force choose_exec's
# projected tier, the route the profit gate opens on cards.

PROJ_WORLDS = (2, 4)
# (m, n) of the single pairs: one block of all n rows, and two of 1024
PROJ_SHAPES = {"600x500": (600, 500, 21), "300x1100": (300, 1100, 22)}
PROJ_BATCH = (3, 200, 300, 23)


def _proj_pair(shape: str, scoring: str):
    m, n, seed = PROJ_SHAPES[shape]
    if scoring != "blosum62":
        a, b = random_pair(m, n, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 20, m).astype(np.int8)
        b = rng.integers(0, 20, n).astype(np.int8)
    k = min(m, n) // 3
    b[k:2 * k] = a[k // 2:k // 2 + k]      # a planted homology
    return a, b


def _proj_batch(scoring: str):
    B, m, n, seed = PROJ_BATCH
    rng = np.random.default_rng(seed)
    A = 20 if scoring == "blosum62" else 4
    aa = rng.integers(0, A, (B, m)).astype(np.int8)
    bb = rng.integers(0, A, (B, n)).astype(np.int8)
    bb[1, 40:140] = aa[1, 60:160]
    return aa, bb


def _alphabet(scoring: str) -> str:
    return PROTEIN_ALPHABET if scoring == "blosum62" else DNA_ALPHABET


def _proj_cases() -> dict:
    """case id -> (forced, (mesh kind, ranks, call, kwargs))."""
    cases = {}
    for sc in SCORINGS:
        for D in PROJ_WORLDS:
            for shape in PROJ_SHAPES:
                a, b = _proj_pair(shape, sc)
                cases[f"palign-{shape}-{sc}-D{D}"] = (False, (
                    "seq", D, "align",
                    dict(a=a, b=b, plan="pipeline", traceback=False,
                         **_port(sc))))
                cases[f"pscore-{shape}-{sc}-D{D}"] = (False, (
                    "seq", D, "score", dict(a=a, b=b, plan="pipeline",
                                            **_port(sc))))
                cases[f"pauto-{shape}-{sc}-D{D}"] = (True, (
                    "seq", D, "align",
                    dict(a=a, b=b, traceback=False, **_port(sc))))
            a, b = _proj_pair("600x500", sc)
            cases[f"ptb-600x500-{sc}-D{D}"] = (False, (
                "seq", D, "align",
                dict(a=a, b=b, plan="pipeline", traceback=True,
                     alphabet=_alphabet(sc), **_port(sc))))
            aa, bb = _proj_batch(sc)
            cases[f"pbatch-{sc}-D{D}"] = (False, (
                "seq", D, "batch_score",
                dict(aa=aa, bb=bb, plan="pipeline", **_port(sc))))
    return cases


PROJ_CASES = _proj_cases()


def _record_stamp() -> dict:
    from swtpu_torch.dispatch.cost import DEFAULT_PIPE_RECORD
    import json
    return json.loads(DEFAULT_PIPE_RECORD.read_text())["device"]


@pytest.fixture(scope="module")
def proj_ranks():
    """Every projected case's (answer, plain block fills) on each of four
    ranks run as cards of the record, from one spawn."""
    from torch_pipe_ranks import run_projected
    ids = list(PROJ_CASES)
    per_rank = launch(4, run_projected,
                      ([PROJ_CASES[k] for k in ids], _record_stamp()),
                      device="cpu", timeout=300)
    return {k: [r[i] for r in per_rank] for i, k in enumerate(ids)}


@pytest.fixture
def as_the_card(monkeypatch):
    """This process as the record's card, for the rows the ranks saw."""
    from swtpu_torch.dispatch import autotune, cost
    stamp = _record_stamp()
    monkeypatch.setattr(autotune, "device_stamp", lambda: dict(stamp))
    monkeypatch.delenv(cost.PIPE_RECORD_ENV, raising=False)
    cost._record_cache.clear()
    yield
    cost._record_cache.clear()


def _proj_result(proj_ranks, case):
    """Rank 0's (answer, block fills), the answer equal on every rank of
    the mesh and the block fills too."""
    got = proj_ranks[case]
    D = PROJ_CASES[case][1][1]
    for r in range(4):
        if r < D:
            _same(got[r], got[0])
        else:
            assert got[r][0] is None
    return got[0]


@functools.lru_cache(maxsize=None)
def _jax_proj_align(shape: str, sc: str, D: int, traceback: bool):
    """The JAX package's ``align(mesh=, plan='pipeline')`` of a projected
    case's pair, once for the cases that share it."""
    import swtpu
    a, b = _proj_pair(shape, sc)
    kw = dict(alphabet=_alphabet(sc)) if traceback else {}
    return swtpu.align(a, b, plan="pipeline", traceback=traceback,
                       mesh=pipeline_mesh(D, platform="cpu"),
                       scoring=SCORINGS[sc][0], substitution=SCORINGS[sc][1],
                       **kw)


def _proj_rows(m: int, n: int, D: int, sc: str) -> int:
    from swtpu_torch.dispatch.plan import pipeline_projection
    rows = pipeline_projection(m, n, D, **_port(sc))[1]
    assert rows and rows != -(-n // D)     # not default_block_rows'
    return rows


@pytest.mark.parametrize("case", [k for k in PROJ_CASES
                                  if k.startswith(("palign-", "pauto-",
                                                   "pscore-"))])
def test_projected_rows_align_and_score_match_jax(proj_ranks, as_the_card,
                                                  case):
    kind, shape, sc, d = case.split("-")
    D = int(d[1:])
    a, b = _proj_pair(shape, sc)
    got, fills = _proj_result(proj_ranks, case)
    want = _jax_proj_align(shape, sc, D, False)
    if kind == "pscore":
        assert got == want.max_score
    else:
        assert got["plan"] == "pipeline"
        assert [got[k] for k in ("max_score", "max_i", "max_j",
                                 "last_cell")] == [
            want.max_score, want.max_i, want.max_j, want.last_cell]
    ref = oracle.fill(a, b, SCORINGS[sc][0], sub=SCORINGS[sc][1])
    assert want.max_score == ref.max_score > 0
    m, n = len(a), len(b)
    if kind == "pscore" and m > 2 * n:
        m, n = n, m                         # score() transposes thin pairs
    assert fills == -(-n // _proj_rows(m, n, D, sc))


@pytest.mark.parametrize("case", [k for k in PROJ_CASES
                                  if k.startswith("ptb-")])
def test_projected_rows_traceback_matches_jax(proj_ranks, as_the_card,
                                              case):
    _, shape, sc, d = case.split("-")
    D = int(d[1:])
    a, b = _proj_pair(shape, sc)
    got, fills = _proj_result(proj_ranks, case)
    want = _jax_proj_align(shape, sc, D, True)
    fields = ("max_score", "max_i", "max_j", "last_cell", "aligned_a",
              "aligned_b")
    assert [got[k] for k in fields] == [getattr(want, k) for k in fields]
    # the forward pass and the anchored reverse pass over [1..end], both
    # at the forward's projected rows
    rows = _proj_rows(len(a), len(b), D, sc)
    assert fills == -(-len(b) // rows) + -(-got["max_i"] // rows)


@pytest.mark.parametrize("case", [k for k in PROJ_CASES
                                  if k.startswith("pbatch-")])
def test_projected_rows_batch_matches_jax(proj_ranks, as_the_card, case):
    from swtpu.dist.batch import batch_score as jbatch_score
    _, sc, d = case.split("-")
    D = int(d[1:])
    aa, bb = _proj_batch(sc)
    got, fills = _proj_result(proj_ranks, case)
    want = jbatch_score(aa, bb, SCORINGS[sc][0], plan="pipeline",
                        mesh=pipeline_mesh(D, platform="cpu"),
                        substitution=SCORINGS[sc][1])
    assert got[0] == "BatchHits"
    assert _fields(got) == [np.asarray(x).tolist() for x in want]
    B, m, n, _ = PROJ_BATCH
    assert fills == B * -(-n // _proj_rows(m, n, D, sc))


# ---- ranks that disagree ----
#
# An 'auto' call on a mesh of cards is a collective of its ranks: they
# take the pipeline together, or each keeps to its own card. Four ranks
# run as cards of the record and pass different sizes (one an empty
# sequence), or hold the gate shut on one rank, or project other rows on
# one rank (``tests/torch_pipe_ranks.py``). No rank may hang, and each
# must return its own pair's answer.

# (m, n) of each rank's pair; rank 0's is every rank's in the other calls
DISAGREE_SHAPES = [(300, 1100), (280, 1100), (300, 1000), (0, 1100)]
OTHER_ROWS = 64


def _disagree_pairs() -> list:
    out = []
    for k, (m, n) in enumerate(DISAGREE_SHAPES):
        a, b = random_pair(max(m, 1), n, seed=40 + k)
        out.append((a[:m], b))
    return out


@pytest.fixture(scope="module")
def disagree_ranks():
    from torch_pipe_ranks import run_disagreeing
    return launch(4, run_disagreeing,
                  (_record_stamp(), _disagree_pairs(), OTHER_ROWS),
                  device="cpu", timeout=300)


def _answer(got) -> list:
    return [got[k] for k in ("max_score", "max_i", "max_j", "last_cell")]


def _oracle(a, b) -> list:
    if len(a) == 0:
        return [0, 0, 0, 0]
    ref = oracle.fill(a, b, JScoring())
    return [ref.max_score, *ref.max_ij, int(ref.H[-1, -1])]


@pytest.mark.parametrize("rank", range(4))
def test_ranks_of_different_sizes_each_stay_on_their_card(disagree_ranks,
                                                          rank):
    got, fills = disagree_ranks[rank][0]
    a, b = _disagree_pairs()[rank]
    assert _answer(got) == _oracle(a, b)
    assert fills == 0 and got["plan"] == ("scan" if len(a) else None)


@pytest.mark.parametrize("rank", range(4))
def test_one_shut_gate_keeps_every_rank_on_its_card(disagree_ranks, rank):
    got, fills = disagree_ranks[rank][1]
    a, b = _disagree_pairs()[0]
    assert got["plan"] == "scan" and fills == 0
    assert _answer(got) == _oracle(a, b)


@pytest.mark.parametrize("rank", range(4))
def test_ranks_cut_the_blocks_of_rank_0(disagree_ranks, as_the_card, rank):
    got, fills = disagree_ranks[rank][2]
    a, b = _disagree_pairs()[0]
    m, n = len(a), len(b)
    rows = _proj_rows(m, n, 4, "linear")
    assert rows != OTHER_ROWS
    assert got["plan"] == "pipeline"
    assert _answer(got) == _oracle(a, b)
    want = jpl.pipeline_align(a, b, pipeline_mesh(4, platform="cpu"),
                              block_rows=rows, scoring=JScoring())
    assert _answer(got) == [int(x) for x in want]
    assert fills == -(-n // rows)
