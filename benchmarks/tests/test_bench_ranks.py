"""The runner on several ranks (``harness/ranks.py``), on the CPU: four
gloo ranks in lock step, the answer and the device count of rank 0, a
worker that raises or dies, the forbidden modules on a worker, the
one-chip path as it was, and the call of the coming four-card cell (the
pipeline over four ranks, ``kinds/mesh_pair.py``) held to the reference,
with its control. Each run spawns its three workers once and is made
once for the module; each test reads one. On a card: the same call at
16384^2 on four gloo ranks sharing it, and a worker killed there (on four
cards with NCCL where the machine has them)."""

import json
import multiprocessing
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from benchmarks.harness import bench, roofline, traffic
from benchmarks.reference.sw import CAPS

import rehearse
import small

SEED = 2**31 + 17
QUIET = lambda *a, **k: None       # noqa: E731
# CUDAlign's scores times a thousand: a pair of a few hundred letters
# scores above int16, so the int16 control saturates where it is wrong
SCALED = dict(rehearse.CUDALIGN, scoring=dict(
    mode="affine", match=1000, mismatch=-3000, gap_open=-5000,
    gap_extend=-2000))
MESH = {"kind": "mesh_pair", "size": [203, 190], "substitutions": 0.05,
        "plan": "pipeline", "reference": True}   # m not divisible by 4


def lockstep(tmp, fault=None, limit_s=60.0, traced=False) -> tuple:
    """A lockstep run on four CPU ranks: (the result or the exception it
    raised, its seconds, each rank's logged tags)."""
    mix = {"kind": "lockstep", "warm": 3, "cells": 1000, "log": str(tmp),
           "fault": fault}
    t = time.perf_counter()
    try:
        r = rehearse.run(mix, ["cpu"] * 4, "rank_faults", 0.5,
                         config=small.dna(), limit_s=limit_s, seed=SEED,
                         log=QUIET, traced=traced)
    except bench.Refused as e:
        r = e
    logs = [[int(x) for x in (tmp / f"rank{k}.log").read_text().split()]
            for k in range(4)]
    return r, time.perf_counter() - t, logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every lockstep run of the module, by name."""
    out = {}
    for name, fault, limit in [
            ("sound", None, 60.0),
            ("traced", None, 60.0),
            ("raise_after", ["raise_after", 2, 3], 60.0),
            # its peers wait in the call's exchange until the world's limit
            ("raise", ["raise", 2, 3], 8.0),
            ("die", ["die", 2, 3], 60.0),
            ("jax", ["jax", 1, 0], 60.0)]:
        out[name] = lockstep(tmp_path_factory.mktemp(name), fault, limit,
                             traced=name == "traced")
    return out


def test_every_rank_makes_the_same_calls_in_the_same_order(runs):
    r, _, logs = runs["sound"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 10
    assert all(c["value"] == 0 for c in r["checks"].values())
    want = [-1, -2, -3] + list(range(r["attempted"]))
    assert logs == [want] * 4


def test_the_answer_is_rank_0s_and_the_count_is_the_ranks(runs):
    r = runs["sound"][0]
    assert r["checks"]["not_rank_0"]["value"] == 0
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 4,
                           "memory_peak_bytes": 0}
    assert {"setup_s", "gcups"} <= set(r["metrics"])
    assert list(r)[-1] == "checks"


def test_a_traced_run_is_rank_0s_trace(runs):
    """The window traced on rank 0: one bench.call span a call, and on
    the CPU no device to read (no roofline, no idle share)."""
    r, _, logs = runs["traced"]
    assert r["correct"] and r["device"]["count"] == 4
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "fill_roofline_pct" not in r["metrics"]
    assert logs == [logs[0]] * 4 and len(logs[0]) == 3 + r["attempted"]


@pytest.mark.parametrize("name", ["raise_after", "raise"])
def test_a_worker_that_raises_is_counted_and_ends_the_run(runs, name):
    r, seconds, logs = runs[name]
    assert not r["correct"] and r["failed"] == 1 and r["attempted"] == 4
    assert seconds < 30.0
    assert all(log[-1] == 3 for log in logs)     # no rank went past call 3


def test_a_worker_killed_mid_window_ends_the_run(runs):
    r, seconds, logs = runs["die"]
    assert not r["correct"] and r["failed"] >= 1
    assert seconds < 30.0
    assert logs[2][-1] == 3 and all(log[-1] <= 4 for log in logs)
    assert not multiprocessing.active_children()
    assert not dist.is_initialized()


def test_a_worker_that_loads_jax_refuses_the_run(runs):
    e = runs["jax"][0]
    assert isinstance(e, bench.Refused) and "jax (rank 1)" in str(e)


def test_the_one_chip_path_is_as_it_was():
    before = threading.active_count()
    cfg, mix = small.cell("dna-score-25632")
    r = bench.run_cell(bench.load_json(small.ROOT / "BENCHMARK.json"),
                       "dna-score-25632", SEED, 0.3, False,
                       time.perf_counter(), device="cpu", config=cfg,
                       mix=mix, log=QUIET)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] and r["failed"] == 0
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": 0}
    assert {"gcups.score", "setup_s"} <= set(r["metrics"]) <= {
        "gcups.score", "call_p95_ms.score", "setup_s"}
    assert r["checks"] == {n: {"value": 0, "limit": 0}
                           for n in ("score_wrong", "end_wrong", "last_wrong")}
    # no process, no world, no thread of its own
    assert not multiprocessing.active_children() and not dist.is_initialized()
    assert threading.active_count() == before


def test_a_roofline_on_n_cards_is_the_work_spread_over_them():
    one = roofline.Peak("card", 132, 1980.0, 700.0)
    four = roofline.Peak("card", 132, 1980.0, 700.0, cards=4)
    for w in (roofline.Work({32: 10**12}, 4, 10**6),
              roofline.Work({32: 1}, 2, 10**12)):
        s1, by1 = one.least_s(w)
        s4, by4 = four.least_s(w)
        assert s4 == pytest.approx(s1 / 4) and by1 == by4


@pytest.fixture(scope="module")
def mesh_runs():
    """The pipeline's call over four CPU ranks, at CUDAlign's scores and
    at a thousand times them."""
    return {name: rehearse.run(MESH, ["cpu"] * 4, "swtpu_torch", 0.3,
                               config=cfg, seed=SEED, log=QUIET)
            for name, cfg in (("cudalign", rehearse.CUDALIGN),
                              ("scaled", SCALED))}


@pytest.mark.parametrize("name", ["cudalign", "scaled"])
def test_the_pipeline_over_four_ranks_equals_the_reference(mesh_runs, name):
    r = mesh_runs[name]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["count"] == 4
    assert set(r["checks"]) == {"score_wrong", "end_wrong", "last_wrong",
                                "plan_not_pipeline"}
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.fixture
def kinds(monkeypatch):
    """The test kinds found by name, as a rehearsal finds them."""
    monkeypatch.setattr(traffic, "KINDS", rehearse.HERE / "kinds")


def test_the_int16_control_fails_where_the_scores_overflow_it(kinds):
    wl = traffic.build(SCALED, MESH, SEED, "cpu")
    full = wl.control([0], "cpu", None)
    assert int(wl.scores(full[0][1]).max()) > CAPS["int16"]
    assert not any(v > lim for _, v, lim in wl.check(full, "cpu"))
    got = wl.check(wl.control([0], "cpu", CAPS["int16"]), "cpu")
    assert any(v > lim for _, v, lim in got)
    # at CUDAlign's own scores this pair stays far under int16
    wl = traffic.build(rehearse.CUDALIGN, MESH, SEED, "cpu")
    assert not any(v > lim for _, v, lim in
                   wl.check(wl.control([0], "cpu", CAPS["int16"]), "cpu"))


def test_the_mesh_pair_is_a_mutated_copy(kinds):
    """b is a with letters deleted and substituted: it aligns to a over
    most of its length, where a pair drawn apart scores little."""
    mix = dict(MESH, size=[2000, 1900])
    wl = traffic.build(rehearse.CUDALIGN, mix, SEED, "cpu")
    assert (len(wl.a), len(wl.b)) == (2000, 1900)
    again = traffic.build(rehearse.CUDALIGN, mix, SEED, "cpu")
    assert np.array_equal(wl.b, again.b)
    apart = traffic.build(rehearse.CUDALIGN, mix, SEED + 1, "cpu")
    apart.b = wl.b
    assert wl._reference("cpu")[0] > 10 * apart._reference("cpu")[0]


def _rehearse(*args, timeout=900) -> tuple:
    out = subprocess.run([sys.executable, "benchmarks/tests/rehearse.py",
                          *args], cwd=small.ROOT, capture_output=True,
                         text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    return out.returncode, (json.loads(lines[-1]) if lines else None), \
        out.stderr


@pytest.mark.gpu
def test_the_pipeline_over_four_ranks_on_one_card(card):
    """4 gloo ranks sharing card 0 at 16384^2, against the reference there;
    the plan and the block rows are on standard error."""
    rc, r, err = _rehearse("mesh", "--size", "16384", "16384", "--plan",
                           "pipeline", "--devices", *["cuda:0"] * 4)
    print(err[-3000:])
    assert rc == 0, err[-3000:]
    assert r["correct"] and r["device"]["count"] == 4
    assert r["device"]["platform"] == "gpu"
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert "plan pipeline" in err


@pytest.mark.gpu
def test_a_worker_killed_on_the_card_ends_the_run(card):
    """Four gloo ranks sharing card 0, and four NCCL ranks a card each
    where the machine has four cards: the run ends within the world's
    limit with a result not correct, or with no result."""
    import torch
    worlds = [["cuda:0"] * 4]
    if torch.cuda.device_count() >= 4:
        worlds.append([f"cuda:{k}" for k in range(4)])
    for devices in worlds:
        t = time.perf_counter()
        rc, r, err = _rehearse("fault", "--fault", "die", "2", "3",
                               "--limit", "60", "--devices", *devices,
                               timeout=300)
        seconds = time.perf_counter() - t
        print(devices, rc, seconds, err[-1500:])
        assert seconds < 60 + 10 + 60          # the limit, its margin, start
        assert (rc == 0 and not r["correct"]) or (rc != 0 and r is None)
