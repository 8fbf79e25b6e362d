"""The four-card cell ``dna-score-mesh4`` on the CPU: its kind
(``kinds/mesh_pair.py``) at a small size on four gloo ranks through the
runner, correct; not correct where each answer is altered where it is
made, where the program takes another plan than the pipeline, and with
the int16 control in its place where the scores pass 32767; and the two
readers of the pipeline, ``pipe_wait_pct`` and ``pipe_active_pct``, on
a traced run and on a synthetic trace with synthetic records."""

import dataclasses
import time

import pytest

from benchmarks.harness import bench, spans, traffic
from benchmarks.harness import trace as tr
from benchmarks.harness.roofline import Work
from benchmarks.reference.sw import CAPS
from swtpu_torch.instrument.profiling import Record

import small

CELL = "dna-score-mesh4"
SEED = 2**31 + 23
SPEC = bench.load_json(small.ROOT / "BENCHMARK.json")
QUIET = lambda *a, **k: None       # noqa: E731


def config(**over) -> dict:
    return dict(small.load("benchmarks/configs/cudalign-dna.json"), **over)


# CUDAlign's scores times a thousand: the small pair then scores above
# int16, so the int16 control saturates where it is wrong
SCALED = config(scoring=dict(mode="affine", match=1000, mismatch=-3000,
                             gap_open=-5000, gap_extend=-2000))


def mix(**over) -> dict:
    """The cell's mix at a CPU test's size; on the CPU the program keeps a
    pair this small on one device unless the plan names the pipeline."""
    return {**small.load("benchmarks/traffic/score-megabase.json"),
            "size": [1000, 977], "plan": "pipeline", **over}


def run(program="swtpu_torch", traced=False, cfg=None, **over) -> dict:
    return bench.run_cell(SPEC, CELL, SEED, 0.5, traced, time.perf_counter(),
                          api=program, config=cfg or config(),
                          mix=mix(**over), log=QUIET, devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def runs():
    return {"sound": run(traced=True), "altered": run("mesh_altered"),
            "auto": run(plan=None)}


def test_the_cell_is_correct_on_four_ranks(runs):
    r = runs["sound"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["count"] == 4
    assert r["checks"] == {n: {"value": 0, "limit": 0} for n in (
        "score_wrong", "end_wrong", "last_wrong", "plan_not_pipeline")}


def test_the_pipeline_readers_read_a_traced_run(runs):
    """On the CPU no NCCL kernel runs, so the wait reads 0; rank 0 fills
    its 4 blocks (977 rows over 4 ranks) in 4 of 7 stages."""
    m = runs["sound"]["metrics"]
    assert m["pipe_wait_pct.mesh4"]["value"] == 0.0
    assert m["pipe_active_pct.mesh4"]["value"] == pytest.approx(400 / 7)
    assert "fill_roofline_pct.mesh4" not in m      # no card, no peak


def test_an_altered_answer_is_not_correct(runs):
    r = runs["altered"]
    assert not r["correct"]
    assert r["checks"]["score_wrong"]["value"] == r["attempted"] >= 1


def test_another_plan_is_not_correct(runs):
    r = runs["auto"]
    assert not r["correct"]
    assert r["checks"]["plan_not_pipeline"]["value"] == r["attempted"] >= 1
    assert r["checks"]["score_wrong"]["value"] == 0


@pytest.mark.parametrize("cfg,fails", [(SCALED, True), (config(), False)])
def test_the_int16_control(cfg, fails):
    wl = traffic.build(cfg, mix(), SEED, "cpu")
    full = wl.control([0], "cpu", None)
    assert not any(v > lim for _, v, lim in wl.check(full, "cpu"))
    assert (int(wl.scores(full[0][1]).max()) > CAPS["int16"]) == fails
    got = wl.check(wl.control([0, 1, 2], "cpu", CAPS["int16"]), "cpu")
    assert any(v > lim for _, v, lim in got) == fails


def test_the_pair_is_a_mutated_copy():
    wl = traffic.build(config(), mix(), SEED, "cpu")
    assert (len(wl.a), len(wl.b)) == (1000, 977)
    again = traffic.build(config(), mix(), SEED, "cpu")
    assert (wl.a == again.a).all() and (wl.b == again.b).all()
    assert wl.control([0], "cpu", None)[0][1][0] > 500


# ---- the readers on a synthetic trace ----

def _run(device: list, records: list, calls: int = 2) -> bench.Run:
    """A traced run of ``calls`` calls of 1 s each, host clock s at
    trace clock µs - 1000, with the program's ``records`` (ns)."""
    cs = [bench.Call(10.0 * k, 10.0 * k + 1.0, Work({32: 1}, 4, 1), True)
          for k in range(calls)]
    sp = [(c.t0 * 1e6 + 1000, c.t1 * 1e6 + 1000) for c in cs]
    return bench.Run(1.0, cs, tr.Trace(sp, sorted(device), []))


def _span(name, a_us, b_us, parent=0) -> Record:
    return Record(name, 0, 0, parent, int(a_us * 1e3), int(b_us * 1e3))


def _count(name, value, at_us) -> Record:
    return Record(name, 0, 0, 0, int(at_us * 1e3), int(at_us * 1e3), value)


@pytest.fixture
def records(monkeypatch):
    box = []
    monkeypatch.setattr(spans, "_records", lambda: list(box) or None)
    return box


def test_the_wait_is_nccls_collectives_inside_the_merge_and_verdict(records):
    # on the trace's clock a host second s is s * 1e6 + 1000 µs; call 0
    # spans [1000, 1e6 + 1000], call 1 [1e7 + 1000, 1.1e7 + 1000]
    records += [_span("swtpu.pipe.agree", 0, 100, -1),
                _span("swtpu.pipe.merge", 1000, 2000),
                _span("swtpu.pipe.merge", 2000, 900000),
                _span("swtpu.pipe.halo", 500, 600)]
    dev = [
        (1050, 1090, "ncclDevKernel_AllReduce_Sum_i32_RING_LL(x)", "kernel"),
        (3000, 900500, "ncclDevKernel_AllReduce_Sum_u32_RING_LL(x)",
         "kernel"),                         # ends inside the fetch: waited
        (1500, 800000, "ncclDevKernel_SendRecv(x)", "kernel"),   # the halo
        (1020, 1080, "sw_kernel", "kernel"),
        (950000, 960000, "ncclDevKernel_AllReduce_Sum_u32_RING_LL(x)",
         "kernel")]                         # inside no span of the two
    run = _run(dev, records)
    from benchmarks.metrics import pipe_wait_pct
    window = 1.1e7 - 0.0
    want = 100.0 * ((1090 - 1050) + (900500 - 3000)) / window
    assert pipe_wait_pct.value(run) == pytest.approx(want)


def test_the_wait_reads_nothing_without_the_programs_spans(records):
    run = _run([(1050, 1090, "ncclDevKernel_AllReduce(x)", "kernel")],
               records)
    from benchmarks.metrics import pipe_active_pct, pipe_wait_pct
    assert pipe_wait_pct.value(run) is None
    assert pipe_active_pct.value(run) is None
    records.append(_span("swtpu.align", 0, 10, -1))
    assert pipe_wait_pct.value(run) is None
    assert pipe_active_pct.value(run) is None
    assert pipe_wait_pct.value(dataclasses.replace(run, trace=None)) is None


def test_the_active_share_is_blocks_over_stages(records):
    for k in range(2):
        at = 1e7 * k + 5000
        records += [_count("pipe.stages", 11, at), _count("pipe.blocks", 8, at),
                    _count("pipe.block_rows", 131072, at)]
    from benchmarks.metrics import pipe_active_pct
    assert pipe_active_pct.value(_run([], records)) == pytest.approx(
        100 * 8 / 11)
