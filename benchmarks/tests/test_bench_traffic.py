"""The generator: one seed gives the same inputs, every seed the same
work; the cells counted per call; the roofline and metric arithmetic."""

import statistics

import numpy as np
import pytest

import swtpu_torch
from benchmarks.harness import bench, roofline, trace, traffic

import small

SPEC = bench.load_json(small.ROOT / "BENCHMARK.json")


def inputs(wl) -> list:
    if wl.mix["kind"] == "pairs":
        return [x for p in wl.pool for x in p]
    if wl.mix["kind"] == "database":
        return wl.queries + wl.entries
    return [wl.ref] + wl.batches


@pytest.mark.parametrize("name", sorted(small.CELLS))
def test_a_seed_gives_the_same_inputs_and_every_seed_the_same_work(name):
    cfg, mix = small.cell(name)
    one, two = (traffic.build(cfg, mix, 2**31 + 11, "cpu") for _ in range(2))
    other = traffic.build(cfg, mix, 5, "cpu")
    for x, y in zip(inputs(one), inputs(two)):
        assert np.array_equal(x, y)
    assert any(not np.array_equal(x, y)
               for x, y in zip(inputs(one), inputs(other)))
    for k in range(one.distinct):
        assert one.work(k) == other.work(k)
    if one.mix["kind"] == "database":
        assert sorted(one.lens) == sorted(other.lens)


def test_cells_are_counted_as_asked_for():
    cfg, mix = small.cell("dna-readsearch")
    wl = traffic.build(cfg, mix, 1, "cpu")
    w = wl.work(0)
    assert w.cells_by_bits == {16: 8 * 60 * 3000 * 2}
    cfg, mix = small.cell("protein-dbsearch")
    wl = traffic.build(cfg, mix, 1, "cpu")
    q = len(wl.queries[wl.order[1]])
    assert wl.work(1).cells == q * sum(len(e) for e in wl.entries)
    assert wl.work(1).cells_by_bits == {16: wl.work(1).cells}
    cfg, mix = small.cell("dna-score-25632", size=[25632, 25632], pool=2)
    wl = traffic.build(cfg, mix, 1, "cpu")
    assert wl.work(0).cells_by_bits == {16: 25632 * 25632}
    assert wl.work(0).instructions == 2
    assert [len(b) for _, b in wl.pool] == [25632, 25632]
    wl = traffic.build(dict(cfg, precision="int32"), mix, 1, "cpu")
    assert wl.work(1).cells_by_bits == {32: 25632 * 25632}


def test_database_lengths_follow_the_configuration():
    cfg = small.load("benchmarks/configs/swissprot-blosum62.json")
    wl = traffic.build(cfg, small.mix("dbsearch-cycle"), 3, "cpu")
    assert len(wl.entries) == cfg["database_entries"]
    n_rand = cfg["database_entries"] - 60
    rand = sorted(wl.lens)
    for h in wl.homolog_idx:
        assert len(wl.entries[h]) in [ln for _, ln in cfg["queries"]]
    assert 300 < statistics.mean(rand) < 420
    assert len(wl.homolog_idx) == 60 and n_rand > 8000


def test_roofline_arithmetic():
    peak = roofline.Peak("card", sms=132, max_sm_mhz=1980.0,
                         power_limit_w=700.0)
    assert peak.issue_per_s() == 132 * 128 * 1980e6
    assert peak.cells_per_s(32, 2) == peak.issue_per_s() / 2
    assert peak.cells_per_s(16, 2) == peak.issue_per_s()
    assert peak.cells_per_s(16, 4) == peak.issue_per_s() / 2
    w = roofline.Work({32: 10**9, 16: 10**9}, 4, 1000)
    s, by = peak.least_s(w)
    assert by == "operations"
    assert s == pytest.approx(4e9 / peak.issue_per_s()
                              + 2e9 / peak.issue_per_s())
    s, by = peak.least_s(roofline.Work({32: 1}, 2, 3.35e12))
    assert by == "bytes" and s == pytest.approx(1.0)
    assert roofline.instructions_per_cell(False) == 2
    assert roofline.instructions_per_cell(True) == 4
    assert roofline.BITS == {"int32": 32, "int16": 16}


def test_the_precision_each_configuration_states_holds():
    """Every answer either configuration can give fits its precision:
    the protein queries' and the reads' ceilings, from the letters."""
    cfg = small.load("benchmarks/configs/swissprot-blosum62.json")
    mix = small.mix("dbsearch-cycle")
    for seed in (1, 2**31 + 5, 4_000_000_007):
        wl = traffic.build(dict(cfg, database_entries=80), mix, seed, "cpu")
        assert 27_000 < wl.highest_possible() < (1 << 15) - 1
    dna = small.load("benchmarks/configs/upstream-dna.json")
    wl = traffic.build(dict(dna, reference_length=3000),
                       small.load("benchmarks/traffic/"
                                  "readsearch-1024x150.json"), 1, "cpu")
    assert wl.highest_possible() == 450
    assert cfg["precision"] == dna["precision"] == "int16"


def test_a_kind_is_found_by_its_name(tmp_path, monkeypatch):
    (tmp_path / "echo.py").write_text(
        "from benchmarks.harness.traffic import Workload\n"
        "class Kind(Workload):\n"
        "    distinct = 1\n"
        "    def cells(self, k):\n"
        "        return self.mix['cells']\n"
        "    def nbytes(self, k):\n"
        "        return 0\n")
    monkeypatch.setattr(traffic, "KINDS", tmp_path)
    cfg = small.load("benchmarks/configs/upstream-dna.json")
    wl = traffic.build(cfg, {"kind": "echo", "cells": 7}, 1, "cpu")
    assert wl.work(0).cells_by_bits == {16: 7}
    with pytest.raises(ValueError):
        traffic.build(cfg, {"kind": "nothing"}, 1, "cpu")


def test_pairs_take_the_configurations_letters_and_table():
    """A pairs mix on the protein configuration draws its 20 letters at
    their composition and scores with BLOSUM62, as the program does."""
    cfg = small.load("benchmarks/configs/swissprot-blosum62.json")
    mix = dict(small.mix("score-25632"), pool=2, size=[300, 200])
    wl = traffic.build(cfg, mix, 3, "cpu")
    a, b = wl.pool[0]
    assert a.max() > 3 and len(set(a.tolist())) > 10 and len(b) == 200
    r = bench.run_cell(SPEC, "dna-score-25632", 9, 0.2, False, 0.0,
                       device="cpu", api=swtpu_torch, config=cfg, mix=mix,
                       log=lambda *x, **k: None)
    assert r["correct"] and r["attempted"] >= 1


def test_a_roofline_needs_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        roofline.card_peak()


def test_metric_arithmetic():
    w = roofline.Work({32: 10**9}, 2, 0)
    calls = [bench.Call(0.0, 0.25, w, True), bench.Call(0.25, 0.5, w, True),
             bench.Call(0.5, 1.0, w, False)]
    t = trace.Trace(
        spans=[(0.0, 100.0), (100.0, 200.0)],
        device=[(10.0, 50.0, "void stripe_rb_kernel<8, 4, false, false, "
                 "false, false, false, false, false, false, false>(int)",
                 "kernel"),
                (40.0, 60.0, "Memcpy HtoD (Pageable -> Device)",
                 "gpu_memcpy"),
                (120.0, 150.0, "k", "kernel")],
        host=[(60.0, 100.0, "aten::copy_")])
    peak = roofline.Peak("card", 132, 1980.0, 700.0)
    run = bench.Run(setup_s=3.5, calls=calls, trace=t, peak=peak)
    val = {m: bench.reader(m)(run) for m in
           ("gcups", "setup_s", "call_p95_ms", "fill_roofline_pct",
            "device_idle_pct", "host_ms_per_call", "launches_per_call")}
    assert val["gcups"] == pytest.approx(2.0)
    assert val["setup_s"] == 3.5
    assert val["call_p95_ms"] is None               # under 20 calls
    least = 2 * 1e9 / peak.cells_per_s(32, 2)
    assert val["fill_roofline_pct"] == pytest.approx(100 * least / 70e-6)
    assert val["device_idle_pct"] == pytest.approx(100 * (1 - 80 / 200))
    assert val["host_ms_per_call"] == pytest.approx((50 + 70) / 2 / 1e3)
    assert val["launches_per_call"] == 1.0
    many = [bench.Call(0.0, k / 1000, w, True) for k in range(1, 101)]
    assert bench.reader("call_p95_ms")(bench.Run(0.0, many)) == \
        pytest.approx(statistics.quantiles([k for k in range(1, 101)],
                                           n=20)[18])
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] == "sw_stripe_rb_linear"
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"host code in a call": 10e-6 + 50e-6, "aten::copy_": 60e-6})
