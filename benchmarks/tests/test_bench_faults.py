"""A run's comparison, driven end to end on the CPU (the look for a card
skipped) at small sizes: sound, it comes out correct; with the timed path
broken underneath, or with the control in the program's place, it comes
out not correct."""

import dataclasses
import time

import pytest
import torch

import swtpu_torch
from benchmarks.harness import bench
from benchmarks.harness.traffic import build
from benchmarks.reference.sw import BELOW, CAPS

import small


class Broken:
    """The program's package with one fault planted where answers are
    made: 'altered' (an answer changed where it is produced) or 'half'
    (half of the batch left out, the rest answered)."""

    def __init__(self, fault: str):
        self.fault = fault
        self.Scoring = swtpu_torch.Scoring

    def align(self, *args, **kw):
        r = swtpu_torch.align(*args, **kw)
        return dataclasses.replace(r, max_score=r.max_score + 1) \
            if self.fault == "altered" else r

    def score_many(self, a_list, b_list, *args, **kw):
        if self.fault == "half":
            h = len(a_list) // 2
            got = swtpu_torch.score_many(a_list[:h], b_list[:h], *args, **kw)
            return tuple(torch.cat([x, torch.zeros(len(a_list) - h,
                                                   dtype=x.dtype)])
                         for x in got)
        got = swtpu_torch.score_many(a_list, b_list, *args, **kw)
        got[1][-1] += 1
        return got

    def search(self, queries, *args, **kw):
        if self.fault == "half":
            h = len(queries) // 2
            got = swtpu_torch.search(queries[:h], *args, **kw)
            return tuple(torch.cat([x, torch.zeros(len(queries) - h,
                                                   dtype=x.dtype)])
                         for x in got)
        got = swtpu_torch.search(queries, *args, **kw)
        got[1][got[0] > 0] += 1
        return got


SPEC = bench.load_json(small.ROOT / "BENCHMARK.json")
FAULTS = [(c, "altered") for c in sorted(small.CELLS)] + [
    ("protein-dbsearch", "half"), ("dna-readsearch", "half")]


def run(name: str, api=None) -> dict:
    cfg, mix = small.cell(name)
    return bench.run_cell(SPEC, name, 2**31 + 3, 0.3, False,
                          time.perf_counter(), device="cpu", api=api,
                          config=cfg, mix=mix, log=lambda *a, **k: None)


@pytest.mark.parametrize("name", sorted(small.CELLS))
def test_a_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_path_is_not_correct(name, fault):
    r = run(name, Broken(fault))
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_a_call_that_raises_is_not_correct():
    class Raises(Broken):
        calls = 0

        def align(self, *args, **kw):
            self.calls += 1
            if self.calls > 4:          # after the warm calls of the pool
                raise RuntimeError("no answer")
            return super().align(*args, **kw)
    r = run("dna-score-25632", Raises("none"))
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1


@pytest.mark.parametrize("name", sorted(small.CELLS))
def test_the_control_in_the_programs_place_is_not_correct(name):
    cfg, mix = small.cell(name)
    if mix["kind"] == "pairs":
        # uniform pairs of 400 letters score above 8 bits
        mix = dict(mix, pool=2, size=[400, 400])
    wl = build(cfg, mix, 7, "cpu")
    ks = list(range(wl.distinct))
    got = wl.check(wl.control(ks, "cpu", CAPS[BELOW[cfg["precision"]]]),
                   "cpu")
    assert any(v > lim for _, v, lim in got)
    # at full width the same answers pass (the control makes no strings)
    assert not any(v > lim for n, v, lim in
                   wl.check(wl.control(ks, "cpu", None), "cpu")
                   if n != "strings_wrong")


def test_the_run_refuses_jax(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(bench.Refused):
        run("dna-score-25632")
