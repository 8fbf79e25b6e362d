"""The port's spans and counters (``instrument.profiling``'s ``span``,
``count``, ``spanned``, ``recorded``) on the CPU: nothing recorded and no
``record_function`` entered without a running profiler; under
``profiling.trace(device='cpu')`` the call ids, parents and bounds of the
buffer, the spans as ``user_annotation`` events of the written trace, the
counters of known uploads and buckets exact, and each public call's parts
in the order they run.
"""

import collections
import json

import numpy as np
import pytest
import torch

import swtpu_torch
from swtpu_torch.dist import batch
from swtpu_torch.dist.database import pad_queries
from swtpu_torch.engine import align as engine
from swtpu_torch.instrument import profiling

CPU = torch.device("cpu")


@pytest.fixture
def traced(tmp_path):
    """Run a function under ``profiling.trace(device='cpu')`` with the
    buffer emptied first; returns its records in the order they opened."""
    def run(fn):
        profiling.clear()
        with profiling.trace(str(tmp_path), device="cpu"):
            fn()
        return sorted(profiling.recorded(), key=lambda r: r.index)
    yield run
    profiling.clear()


def names(records) -> list:
    """The spans below the root, in the order they opened."""
    return [r.name for r in records if r.value is None and r.parent >= 0]


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.clear()
    assert not profiling.recording()
    assert profiling.span("swtpu.a") is profiling.span("swtpu.b")
    with profiling.span("swtpu.a"):
        profiling.count("h2d_bytes", 5)
    a, b = swtpu_torch.random_pair(60, 50, seed=3)
    swtpu_torch.align(a, b, device=CPU)
    swtpu_torch.score_many([a, b], [b, a], device=CPU)
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_nesting_call_ids_and_parents(traced):
    def fn():
        for _ in range(2):
            with profiling.span("swtpu.root"):
                with profiling.span("swtpu.x.a"):
                    with profiling.span("swtpu.x.b"):
                        profiling.count("n", 3)
                with profiling.span("swtpu.x.c"):
                    pass
        profiling.count("outside", 1)
    recs = traced(fn)
    got = [(r.name, r.call, r.parent, r.value) for r in recs]
    i0 = recs[0].index
    c0 = recs[0].call
    want = []
    for k in range(2):
        base = i0 + 5 * k
        want += [("swtpu.root", c0 + k, -1, None),
                 ("swtpu.x.a", c0 + k, base, None),
                 ("swtpu.x.b", c0 + k, base + 1, None),
                 ("n", c0 + k, base + 2, 3),
                 ("swtpu.x.c", c0 + k, base, None)]
    want.append(("outside", -1, -1, 1))
    assert got == want
    for r in recs:
        assert r.t1_ns >= r.t0_ns
    root, a, b = recs[:3]
    assert root.t0_ns <= a.t0_ns <= b.t0_ns <= b.t1_ns <= a.t1_ns \
        <= root.t1_ns


def test_a_span_closes_when_its_block_raises(traced):
    def fn():
        with pytest.raises(KeyError):
            with profiling.span("swtpu.root"):
                with profiling.span("swtpu.x.fails"):
                    raise KeyError("x")
        with profiling.span("swtpu.after"):
            pass
    recs = traced(fn)
    assert [(r.name, r.parent) for r in recs] == [
        ("swtpu.root", -1), ("swtpu.x.fails", recs[0].index),
        ("swtpu.after", -1)]
    assert recs[2].call == recs[0].call + 1     # the stack was unwound


def test_the_buffer_is_bounded_and_counts_what_it_drops(traced,
                                                        monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))

    def fn():
        for k in range(20):
            with profiling.span(f"swtpu.s{k}"):
                pass
        profiling.count("c", 1)
    recs = traced(fn)
    assert len(recs) == 8 and profiling.dropped() == 13
    assert [r.name for r in recs] == [f"swtpu.s{k}" for k in range(13, 20)] \
        + ["c"]
    assert profiling.MAX_RECORDS == 1 << 20


def test_spans_are_user_annotations_of_the_trace(tmp_path):
    a, b = swtpu_torch.random_pair(70, 60, seed=1)
    with profiling.trace(str(tmp_path), device="cpu"):
        swtpu_torch.align(a, b, device=CPU)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())[
        "traceEvents"]
    ann = collections.Counter(e["name"] for e in events
                              if e.get("cat") == "user_annotation")
    assert ann["swtpu.align"] == 1 and ann["swtpu.encode"] == 1
    assert ann["swtpu.fill.run"] == 1 and ann["swtpu.tb.strings"] == 1
    assert ann["swtpu.dispatch"] == 2
    profiling.clear()


def test_spanned_keeps_the_function():
    assert swtpu_torch.align.__name__ == "align"
    assert "Align sequence" in swtpu_torch.align.__doc__
    assert swtpu_torch.score_many.__name__ == "score_many"
    assert swtpu_torch.search.__name__ == "search"


def test_h2d_bytes_of_known_uploads(traced):
    sub = np.zeros((24, 24), np.int32)
    a = np.zeros(300, np.int8)
    b = np.ones(200, np.int8)

    def fn():
        batch._codes(np.zeros((3, 7), np.int8), CPU)
        batch._codes(torch.zeros(5, 11, dtype=torch.int8), CPU)
        engine._upload(a, b, sub, CPU)
        engine._upload(a, b, None, CPU)
    recs = traced(fn)
    assert [r.value for r in recs if r.name == "h2d_bytes"] == [
        21, 55, 300 + 200 + 24 * 24 * 4, 500]


def test_score_many_counts_real_and_bucket_cells(traced):
    rng = np.random.default_rng(5)
    shapes = [(10, 20), (17, 5), (0, 4), (30, 30), (12, 31)]
    aa = [rng.integers(0, 4, m).astype(np.int8) for m, _ in shapes]
    bb = [rng.integers(0, 4, n).astype(np.int8) for _, n in shapes]
    recs = traced(lambda: swtpu_torch.score_many(aa, bb, device=CPU))
    real = [r.value for r in recs if r.name == "batch.cells_real"]
    bucket = [r.value for r in recs if r.name == "batch.cells_bucket"]
    # buckets in sorted order: (16, 32) holds 10x20 and 12x31, (32, 16)
    # 17x5, (32, 32) 30x30; the empty pair in none
    assert real == [10 * 20 + 12 * 31, 17 * 5, 30 * 30]
    assert bucket == [2 * 16 * 32, 32 * 16, 32 * 32]
    # one upload: the 8 distinct sequences of the 4 bucketed pairs, then
    # their tables, 4 int32 a row; the buckets built from it count nothing
    assert [r.value for r in recs if r.name == "h2d_bytes"] == [
        10 + 20 + 17 + 5 + 30 + 30 + 12 + 31 + 4 * 4 * 4]


def test_score_many_counts_distinct_sequences(traced):
    rng = np.random.default_rng(6)
    q, r, e1, e2, lone = (rng.integers(0, 4, n).astype(np.int8)
                          for n in (30, 20, 25, 40, 9))
    twin = q.copy()                 # equal contents, another object
    empty = np.zeros(0, np.int8)
    aa = [q, q, q, r, twin, lone]
    bb = [e1, e2, q, e1, e2, empty]  # the last pair is empty: not uploaded
    recs = traced(lambda: swtpu_torch.score_many(aa, bb, device=CPU))
    assert [r.value for r in recs if r.name == "batch.seqs_distinct"] == [5]
    assert [r.value for r in recs if r.name == "h2d_bytes"] == [
        30 + 25 + 40 + 20 + 30 + 5 * 4 * 4]


def _ref():
    ref = np.random.default_rng(0).integers(0, 4, 5000).astype(np.int8)
    return ref, pad_queries([ref[100:140], ref[3000:3040]], 40)


CALLS = {
    "align-score": (
        lambda a, b: swtpu_torch.align(a, b, traceback=False, device=CPU),
        ["swtpu.encode", "swtpu.dispatch", "swtpu.dispatch",
         "swtpu.fill.prep", "swtpu.fill.run", "swtpu.fill.fetch"]),
    "align-lean": (
        lambda a, b: swtpu_torch.align(
            a, b, config=swtpu_torch.EngineConfig(full_p_max_cells=1000),
            device=CPU),
        ["swtpu.encode", "swtpu.dispatch", "swtpu.dispatch",
         "swtpu.tb.locate", "swtpu.tb.refill", "swtpu.tb.walk",
         "swtpu.tb.strings", "swtpu.tb.strings"]),
    "align-full-p": (
        lambda a, b: swtpu_torch.align(a, b, device=CPU),
        ["swtpu.encode", "swtpu.dispatch", "swtpu.dispatch",
         "swtpu.fill.prep", "swtpu.fill.run", "swtpu.fill.fetch",
         "swtpu.tb.strings"]),
    "score_many": (
        lambda a, b: swtpu_torch.score_many([a, b[:40], a[:100]],
                                            [b, a[:20], b[:90]],
                                            device=CPU),
        ["swtpu.batch.bucket"]
        + ["swtpu.batch.pack", "swtpu.batch.score", "swtpu.batch.fetch"]
        * 3),
    "search-both": (
        lambda a, b: swtpu_torch.search(_ref()[1], _ref()[0], window=512,
                                        strand="both", device=CPU),
        ["swtpu.search.revcomp", "swtpu.search.shard",
         "swtpu.search.prepare", "swtpu.search.prepare",
         "swtpu.search.windows", "swtpu.search.merge"]),
}
ROOTS = {"align-score": "swtpu.align", "align-lean": "swtpu.align",
         "align-full-p": "swtpu.align", "score_many": "swtpu.score_many",
         "search-both": "swtpu.search"}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_a_calls_parts_run_in_order(traced, call):
    fn, want = CALLS[call]
    a, b = swtpu_torch.random_pair(200, 180, seed=7)
    recs = traced(lambda: fn(a, b))
    roots = [r for r in recs if r.value is None and r.parent < 0]
    assert [r.name for r in roots] == [ROOTS[call]]
    assert names(recs) == want
    assert {r.call for r in recs if r.value is None} == {roots[0].call}
    # the parts follow one another inside the root
    parts = [r for r in recs if r.value is None and r.parent >= 0]
    for x, y in zip(parts, parts[1:]):
        assert x.t1_ns <= y.t0_ns or y.parent == x.index
    assert roots[0].t0_ns <= parts[0].t0_ns
    assert parts[-1].t1_ns <= roots[0].t1_ns


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_fill_spans_frame_the_kernel_on_the_card(cuda, tmp_path):
    """The middle of three score() calls traced on the card: its fill
    spans in order, and a K1 launched inside its run span and done before
    its fetch returns. (The profiler can miss a few kernels at a
    session's edges, so the first and last calls only open and close
    it.)"""
    from swtpu_torch.kernels import stripe_fill as sf
    a, b = swtpu_torch.random_pair(4096, 4096, seed=2)
    swtpu_torch.score(a, b, device=cuda)
    with profiling.trace(str(tmp_path), device=cuda):
        got = [swtpu_torch.score(a, b, device=cuda) for _ in range(3)]
    assert got == [swtpu_torch.score(a, b, plan="host", device=cuda)] * 3
    events = [e for e in json.loads((tmp_path / profiling.TRACE_FILE)
                                    .read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ann = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            ann[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    names = ("swtpu.align", "swtpu.fill.prep", "swtpu.fill.run",
             "swtpu.fill.fetch")
    assert all(len(ann[n]) == 3 for n in names)
    root, prep, run, fetch = (sorted(ann[n])[1] for n in names)
    assert root[0] <= prep[0] <= prep[1] <= run[0] <= run[1] <= fetch[0] \
        <= fetch[1] <= root[1]
    k1 = [(e["ts"], e["ts"] + e["dur"]) for e in events
          if e.get("cat") == "kernel"
          and profiling.entry_of(e["name"]) == sf.RB_KERNEL
          and run[0] <= e["ts"] <= run[1]]
    assert len(k1) == 1 and k1[0][1] <= fetch[1]
    profiling.clear()
