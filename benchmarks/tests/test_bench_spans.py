"""The program's spans on the trace's clock (``harness/spans.py``) and the
readers built on them: the exact charge of a synthetic trace, the clock
offset recovered, nothing read where the calls and spans do not pair or
nothing was recorded, and a traced small run of each cell on the CPU that
reads every new metric; on a card, each mapped record beside its own
``user_annotation`` event."""

import json
import statistics
import time

import pytest

from benchmarks.harness import bench, spans
from benchmarks.harness.roofline import Work
from benchmarks.harness.trace import Trace, busy_each
from swtpu_torch.instrument import profiling
from swtpu_torch.instrument.profiling import Record

import small

SPEC = bench.load_json(small.ROOT / "BENCHMARK.json")
NEW = {  # cell -> the metrics it gains
    "dna-score-25632": ("fill_host_ms_per_call.score",
                        "unnamed_idle_pct.score"),
    "protein-dbsearch": ("pack_ms_per_call.dbsearch",
                         "padded_cell_pct.dbsearch",
                         "h2d_mb_per_call.dbsearch",
                         "unnamed_idle_pct.dbsearch"),
    "dna-align-25632": ("strings_ms_per_call.align",
                        "unnamed_idle_pct.align"),
}
OFF = 5_000_000.0       # the trace's clock, µs, at host time 0


def span(name, index, parent, t0_us, t1_us, call=0):
    return Record(name, call, index, parent, int(t0_us * 1e3),
                  int(t1_us * 1e3))


def synthetic(records, monkeypatch, device, calls=((0, 100), (200, 300)),
              jitter=0.0):
    """A Run whose calls span ``calls`` µs of host time, traced at OFF,
    with ``device`` busy intervals (trace µs) and the program's
    ``records``."""
    monkeypatch.setattr(profiling, "recorded", lambda: list(records))
    cs = [bench.Call(a / 1e6, b / 1e6, Work({32: 1}, 2, 1), True)
          for a, b in calls]
    tspans = [(a + OFF + jitter * (k % 2), b + OFF + jitter * (k % 2))
              for k, (a, b) in enumerate(calls)]
    trace = Trace(tspans, [(a + OFF, b + OFF, "k", "kernel")
                           for a, b in device], [])
    return bench.Run(1.0, cs, trace)


def test_idle_is_charged_to_the_innermost_part(monkeypatch):
    # call 0: root 0-100, encode 0-10, prep 10-30 with a child pack
    # 15-20, fetch 60-95; call 1: root 200-300, prep 210-250
    recs = [span("swtpu.align", 0, -1, 0, 100),
            span("swtpu.encode", 1, 0, 0, 10),
            span("swtpu.fill.prep", 2, 0, 10, 30),
            span("swtpu.batch.pack", 3, 2, 15, 20),
            span("swtpu.fill.fetch", 4, 0, 60, 95),
            span("swtpu.align", 5, -1, 200, 300, call=1),
            span("swtpu.fill.prep", 6, 5, 210, 250, call=1)]
    # the card busy 25-70 and 240-260 (trace µs less OFF)
    run = synthetic(recs, monkeypatch, [(25, 70), (240, 260)])
    parts = spans.idle_by_part(run)
    assert parts == pytest.approx({
        "swtpu.encode": 10.0, "swtpu.fill.prep": 5 + 5 + 30,
        "swtpu.batch.pack": 5.0, "swtpu.fill.fetch": 25.0,
        None: 5 + 10 + 40})
    idle = sum(b - a - d for (a, b), d in
               zip(run.trace.spans, busy_each(run.trace, run.trace.spans)))
    assert sum(parts.values()) == pytest.approx(idle)
    assert spans.ms_per_call(run, ("swtpu.fill.",)) == \
        pytest.approx((40 + 25) / 2 / 1e3)
    assert spans.unnamed_pct(run) == pytest.approx(100 * 55 / idle)


def test_the_mapping_recovers_the_offset(monkeypatch):
    calls = [(k * 1000.0, k * 1000.0 + 400) for k in range(9)]
    run = synthetic([span("swtpu.align", 0, -1, 10, 390)], monkeypatch, [],
                    calls=calls, jitter=3.0)
    off, res = spans.offset_us(run)
    assert off == pytest.approx(OFF, abs=3.0)
    assert max(abs(r) for r in res) <= 3.0
    (a, b, name, root), = spans.mapped(run)[0]
    assert (a, b) == pytest.approx((OFF + 10, OFF + 390), abs=3.0)
    assert name == "swtpu.align" and root


def test_nothing_is_read_where_calls_and_spans_do_not_pair(monkeypatch):
    run = synthetic([span("swtpu.align", 0, -1, 0, 100)], monkeypatch, [])
    run.calls.append(bench.Call(0.0004, 0.0005, Work({32: 1}, 2, 1), True))
    assert spans.offset_us(run) is None
    assert spans.idle_by_part(run) is None
    for name in ("pack_ms_per_call.dbsearch", "unnamed_idle_pct.score",
                 "h2d_mb_per_call.dbsearch"):
        assert bench.reader(name)(run) is None


def test_nothing_is_read_without_records(monkeypatch):
    run = synthetic([], monkeypatch, [])
    for names in NEW.values():
        for name in names:
            assert bench.reader(name)(run) is None
    # nor from a program that keeps none (the parent of this change)
    monkeypatch.delattr(profiling, "recorded")
    assert spans.mapped(run) is None


def test_counters_sum_over_the_window(monkeypatch):
    recs = [Record("h2d_bytes", 0, 1, 0, 5000, 5000, 3_000_000),
            Record("h2d_bytes", 1, 3, 2, 205_000, 205_000, 1_000_000),
            Record("h2d_bytes", 9, 9, -1, -10**9, -10**9, 7)]  # earlier
    run = synthetic(recs, monkeypatch, [])
    assert spans.counted(run, "h2d_bytes") == 4_000_000
    assert bench.reader("h2d_mb_per_call.dbsearch")(run) == 2.0


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_traced_small_run_reads_every_new_metric(name):
    cfg, mix = small.cell(name)
    r = bench.run_cell(SPEC, name, 2**31 + 5, 0.3, True,
                       time.perf_counter(), device="cpu", config=cfg,
                       mix=mix, log=lambda *a, **k: None)
    assert r["correct"]
    got = r["metrics"]
    for m in NEW[name]:
        assert isinstance(got[m]["value"], float), m
        assert got[m]["value"] >= 0
        if m.startswith("unnamed"):
            assert got[m]["value"] < 100


@pytest.mark.gpu
def test_mapped_records_meet_their_annotations_on_the_card(card, tmp_path):
    """score() calls in bench.call spans under profiling.trace(): the
    offsets' quartiles within 50 µs; each mapped swtpu.* record frames its
    own user_annotation event (a record is taken outside its
    record_function) up to the mapping's noise, a few µs at the median and
    within 50 µs at both ends but for a rare stall inside
    record_function."""
    import swtpu_torch
    from torch.profiler import record_function
    from benchmarks.harness import trace as tr
    pool = [swtpu_torch.random_pair(4096, 4096, seed=s) for s in range(4)]
    for a, b in pool:
        swtpu_torch.align(a, b, traceback=False, device=card)
    profiling.clear()
    calls = []
    with profiling.trace(str(tmp_path), device=card):
        for k in range(40):
            a, b = pool[k % 4]
            t0 = time.perf_counter()
            with record_function(tr.SPAN):
                swtpu_torch.align(a, b, traceback=False, device=card)
            calls.append(bench.Call(t0, time.perf_counter(),
                                    Work({32: 1}, 2, 1), True))
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())[
        "traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    bench_spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in ann if e["name"] == tr.SPAN)
    run = bench.Run(1.0, calls, Trace(bench_spans, [], []))
    off, res = spans.offset_us(run)
    q1, _, q3 = statistics.quantiles(res, n=4, method="inclusive")
    assert q3 - q1 <= 50.0
    recs = [r for r in profiling.recorded() if r.value is None]
    lead, lag = [], []          # annotation start less record start; ends
    for name in {r.name for r in recs}:
        mine = sorted((r.t0_ns / 1e3 + off, r.t1_ns / 1e3 + off)
                      for r in recs if r.name == name)
        theirs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in ann if e["name"] == name)
        assert len(mine) == len(theirs), name
        for (a0, a1), (b0, b1) in zip(mine, theirs):
            lead.append(b0 - a0)
            lag.append(a1 - b1)
    print(f"offset IQR {q3 - q1:.3f} us; {len(lead)} records: start "
          f"{statistics.median(lead):.2f} us before the annotation's "
          f"(least {min(lead):.2f}, most {max(lead):.2f}), end "
          f"{statistics.median(lag):.2f} after (least {min(lag):.2f}, "
          f"most {max(lag):.2f})")
    assert min(lead) >= -10.0 and min(lag) >= -10.0
    assert statistics.median(lead) <= 10.0 and statistics.median(lag) <= 10.0
    assert statistics.quantiles(lead + lag, n=100)[98] <= 50.0
