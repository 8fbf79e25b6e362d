"""The port's pipeline cost model on the CPU (``swtpu_torch.dispatch.cost``
and the profit gate of ``dispatch.plan``), against the committed record
fitted on an H100 (``dispatch/pipe_h100.json``).

The record loads only on its own card, so ``as_the_card`` stamps this
process with the record's stamp; the gate's card count is monkeypatched
where a test needs D cards. The counterpart of the JAX package's
``tests/test_dispatch.py`` profit-gate and fit-record tests: exact
equality of plans and rows; the model against every launch the record
was fitted on within the tolerance the record states."""

import json
import math

import numpy as np
import pytest
import torch

from swtpu_torch.core.config import EngineConfig, Scoring
from swtpu_torch.core.substitution import BLOSUM62
from swtpu_torch.dispatch import autotune, cost
from swtpu_torch.dispatch import plan as dp
from swtpu_torch.dist.mesh import Mesh
from swtpu_torch.engine import align as ealign
from swtpu_torch.kernels.stripe_fill import RB_BLOCK_DEFAULTS, RB_DEFAULTS

RECORD = json.loads(cost.DEFAULT_PIPE_RECORD.read_text())
CUDA = torch.device("cuda")
CPU = torch.device("cpu")
SCORINGS = {"linear": (Scoring(), None),
            "affine": (Scoring(mode="affine"), None),
            "sub": (Scoring(mode="affine", gap_open=-11, gap_extend=-1),
                    BLOSUM62)}
BIG = 1 << 20
HEADLINE = 25632


def _reset():
    cost._record_cache.clear()


@pytest.fixture
def as_the_card(monkeypatch):
    """This process stamped as the record's card, the committed record
    the one loaded."""
    monkeypatch.setattr(autotune, "device_stamp",
                        lambda: dict(RECORD["device"]))
    monkeypatch.delenv(cost.PIPE_RECORD_ENV, raising=False)
    _reset()
    yield
    _reset()


def _with_record(monkeypatch, tmp_path, rec) -> None:
    """Load ``rec`` (a dict, or raw text) as the record."""
    path = tmp_path / "pipe.json"
    path.write_text(rec if isinstance(rec, str) else json.dumps(rec))
    monkeypatch.setenv(cost.PIPE_RECORD_ENV, str(path))
    _reset()


def _cards(monkeypatch, D: int) -> None:
    monkeypatch.setattr(dp, "pipeline_devices", lambda *a, **kw: D)


def _mesh(D: int, backend: str, device=CUDA) -> Mesh:
    """A mesh of D ranks along 'seq' as rank 0 sees it (no process group
    is needed to count its cards)."""
    return Mesh(("seq",), (D,), (0,), (tuple(range(D)),), (None,), device,
                backend)


# ---- the record ----

def test_record_is_stamped_and_whole():
    dev = RECORD["device"]
    assert dev["name"] and dev["capability"] and dev["power_limit"]
    assert cost.valid_record(RECORD)
    assert "halo" in RECORD["method"]
    for kind in cost.KINDS:
        for form in cost.FORMS:
            assert {"floor_s", "step_s", "rate_cps", "rate_measured"} <= \
                set(RECORD["model"][kind][form])
    assert {r["form"] for r in RECORD["stage_rows"]} == set(cost.FORMS)
    # every score() size from 4096^2 to one whose stripes outnumber the
    # card's SMs, in each form
    for form in cost.FORMS:
        sizes = sorted(r["m"] for r in RECORD["fit_rows"]
                       if r["kind"] == "score" and r["form"] == form)
        assert len(sizes) >= 5 and sizes[0] == 4096
        assert max(r["stripes"] for r in RECORD["fit_rows"]
                   if r["kind"] == "score" and r["form"] == form) > 132


@pytest.mark.parametrize("row", range(len(RECORD["fit_rows"])))
def test_model_reproduces_every_fit_row(row):
    r = RECORD["fit_rows"][row]
    sc, sub = SCORINGS[r["form"]]
    g = cost.geometry(r["m"], r["n"], sc, sub, r["kind"])
    # the geometry the fit used is the port's
    assert {k: g[k] for k in ("T", "R", "C", "stripes", "steps", "cells")} \
        == {k: r[k] for k in ("T", "R", "C", "stripes", "steps", "cells")}
    got = cost.stripe_cost_s(r["m"], r["n"], sc, sub, r["kind"],
                             record=RECORD)
    assert got == pytest.approx(r["model_s"], rel=1e-12)
    tol = RECORD["tolerance"]
    assert r["s"] / tol <= got <= r["s"] * tol, (r, got)


@pytest.mark.parametrize("row", range(len(RECORD["stage_rows"])))
def test_model_reproduces_every_stage_row(row):
    r = RECORD["stage_rows"][row]
    sc, sub = SCORINGS[r["form"]]
    got = cost.stripe_cost_s(r["mc"], r["rows"], sc, sub, "block",
                             record=RECORD) + RECORD["overhead_s"][r["form"]]
    assert got == pytest.approx(r["model_s"], rel=1e-12)
    tol = RECORD["tolerance"]
    assert r["stage_s"] / tol <= got <= r["stage_s"] * tol, (r, got)
    assert r["overhead_s"] == pytest.approx(r["stage_s"] - r["k5_s"])


def test_overhead_is_the_median_of_the_stage_rows():
    for form in cost.FORMS:
        over = sorted(r["overhead_s"] for r in RECORD["stage_rows"]
                      if r["form"] == form)
        assert RECORD["overhead_s"][form] == max(0.0, over[len(over) // 2])


# ---- the step model ----

@pytest.mark.parametrize("m, n, T, R, C, want", [
    (25632, 25632, 128, 8, 4, 6408 + 127 + 25 * 144),
    (65536, 4096, 128, 8, 4, 16384 + 127 + 3 * 144),
    (1000, 1000, 128, 8, 4, 250 + 127),            # one stripe
    (64, 2048, 64, 4, 4, 16 + 63 + 7 * 80),
    (100, 5000, 128, 8, 1, 100 + 127 + 4 * 192),
    (100, 5000, 128, 8, 8, 13 + 127 + 4 * 136)])
def test_stripe_steps(m, n, T, R, C, want):
    assert cost.stripe_steps(m, n, T, R, C) == want


def test_geometry_follows_rb_shape():
    g = cost.geometry(HEADLINE, HEADLINE)
    assert (g["T"], g["R"], g["C"]) == RB_DEFAULTS["linear"]
    assert g["stripes"] == 26 and g["cells"] == HEADLINE ** 2
    g = cost.geometry(65536, 4096, kind="block")
    assert (g["T"], g["R"], g["C"]) == RB_BLOCK_DEFAULTS["linear"]
    # a short block launches fewer threads: one warp's rows suffice
    assert cost.geometry(4096, 100, kind="block")["T"] == 32
    with pytest.raises(ValueError):
        cost.geometry(10, 10, kind="fill_p")


def test_model_is_the_larger_term_plus_the_floor():
    c = {"floor_s": 1e-4, "step_s": 1e-6, "rate_cps": 1e12}
    assert cost.model_s(c, 1000, 10 ** 6) == pytest.approx(1e-4 + 1e-3)
    assert cost.model_s(c, 1000, 10 ** 10) == pytest.approx(1e-4 + 1e-2)
    assert not cost.rate_bound(c, 1000, 10 ** 6)
    assert cost.rate_bound(c, 1000, 10 ** 10)


def _points(c: dict, sizes) -> list:
    out = []
    for s in sizes:
        g = cost.geometry(s, s)
        out.append({"steps": g["steps"], "cells": g["cells"],
                    "s": cost.model_s(c, g["steps"], g["cells"])})
    return out


def test_fit_recovers_its_constants():
    c = {"floor_s": 2e-4, "step_s": 8e-7, "rate_cps": 1.1e12}
    got = cost.fit(_points(c, (4096, 8192, 16384, 25632, 65536, 131072,
                               262144, 524288, BIG)))
    for k in c:
        assert got[k] == pytest.approx(c[k], rel=1e-9)
    assert got["rate_measured"] and got["worst"] == pytest.approx(1.0)


def test_fit_without_a_rate_bound_launch_keeps_a_lower_bound():
    c = {"floor_s": 2e-4, "step_s": 8e-7, "rate_cps": 1e20}
    pts = _points(c, (4096, 8192, 16384, 25632))
    got = cost.fit(pts)
    assert not got["rate_measured"]
    assert got["rate_cps"] == pytest.approx(
        max(p["cells"] / (p["s"] - got["floor_s"]) for p in pts))
    with pytest.raises(ValueError):
        cost.fit(pts[:1])


def test_fit_holds_the_floor_at_zero():
    # times below the chain's line through the origin: the free fit's
    # floor would be negative
    pts = [{"steps": s, "cells": 1, "s": 1e-6 * s - 1e-5}
           for s in (1000, 2000, 4000)]
    got = cost.fit(pts)
    assert got["floor_s"] == 0.0 and got["step_s"] > 0


# ---- loading ----

def test_the_committed_record_loads_only_on_its_card(as_the_card,
                                                     monkeypatch):
    assert cost.load_record() is not None
    other = dict(RECORD["device"], name="another card")
    assert cost.load_record(stamp=other) is None
    monkeypatch.setattr(autotune, "device_stamp", lambda: None)
    assert cost.load_record() is None
    assert dp.pipe_stage_overhead() is None
    assert dp.pipeline_projection(BIG, BIG, 8) == (0.0, 0)


@pytest.mark.parametrize("bad", [
    None,                                   # no file
    "not json",
    {"oops": 1},
    "other card",
    "negative step",
    "no overhead",
    "string rate"])
def test_no_usable_record_projects_nothing(as_the_card, monkeypatch,
                                           tmp_path, bad):
    rec = json.loads(json.dumps(RECORD))
    if bad is None:
        monkeypatch.setenv(cost.PIPE_RECORD_ENV, str(tmp_path / "no.json"))
        _reset()
    else:
        if bad == "other card":
            rec["device"]["name"] = "another card"
        elif bad == "negative step":
            rec["model"]["block"]["affine"]["step_s"] = -1e-6
        elif bad == "no overhead":
            del rec["overhead_s"]["sub"]
        elif bad == "string rate":
            rec["model"]["score"]["linear"]["rate_cps"] = "fast"
        else:
            rec = bad
        _with_record(monkeypatch, tmp_path, rec)
    assert cost.load_record() is None
    assert dp.pipe_stage_overhead() is None
    assert dp.pipeline_projection(BIG, BIG, 8) == (0.0, 0)
    with pytest.raises(LookupError):
        cost.stripe_cost_s(BIG, BIG)
    _cards(monkeypatch, 8)
    assert dp.choose_exec(BIG // 2, BIG // 2, device=CUDA).plan == "stripe"


def test_stripe_cost_matches_choose_params_cost(as_the_card):
    for form, (sc, sub) in SCORINGS.items():
        for kind in cost.KINDS:
            T, R, C, s = cost.choose_params_cost(HEADLINE, HEADLINE, sc, sub,
                                                 kind)
            defaults = (RB_DEFAULTS if kind == "score"
                        else RB_BLOCK_DEFAULTS)[form]
            assert (T, R, C) == defaults
            assert s == cost.stripe_cost_s(HEADLINE, HEADLINE, sc, sub,
                                           kind) > 0


# ---- the projection ----

def test_projection_off_below_two_cards(as_the_card):
    for D in (0, 1):
        assert dp.pipeline_projection(BIG, BIG, D) == (0.0, 0)


@pytest.mark.parametrize("form", list(SCORINGS))
def test_projection_wins_only_for_mega_matrices(as_the_card, form):
    sc, sub = SCORINGS[form]
    sp_big, br_big = dp.pipeline_projection(BIG, BIG, 8, sc, sub)
    sp_small, _ = dp.pipeline_projection(HEADLINE, HEADLINE, 8, sc, sub)
    assert sp_big > dp.PIPE_MIN_SPEEDUP > sp_small
    assert br_big >= 16384
    assert dp.pipeline_projection(65536, 65536, 4, sc, sub)[0] < 1


def test_projection_is_its_own_formula(as_the_card):
    m = n = BIG
    D = 8
    single = cost.stripe_cost_s(m, n)
    over = dp.pipe_stage_overhead()
    assert over == RECORD["overhead_s"]["linear"]
    best = max(
        (single / ((-(-n // br) + D - 1)
                   * (cost.stripe_cost_s(m // D, br, kind="block") + over)),
         br) for br in (1024 << k for k in range(8)))
    assert dp.pipeline_projection(m, n, D) == best
    # one height asked for: that height alone
    sp, br = dp.pipeline_projection(m, n, D, block_rows=4096)
    assert br == 4096 and sp == single / (
        (n // 4096 + D - 1)
        * (cost.stripe_cost_s(m // D, 4096, kind="block") + over))
    # a short pair: one block of all its rows
    assert dp.pipeline_projection(600, 500, 2)[1] == 500


def test_a_huge_overhead_kills_the_win(as_the_card, monkeypatch, tmp_path):
    assert dp.pipeline_projection(BIG, BIG, 8)[0] > dp.PIPE_MIN_SPEEDUP
    rec = json.loads(json.dumps(RECORD))
    rec["overhead_s"] = dict.fromkeys(cost.FORMS, 10.0)
    _with_record(monkeypatch, tmp_path, rec)
    assert dp.pipe_stage_overhead() == 10.0
    assert dp.pipeline_projection(BIG, BIG, 8)[0] < dp.PIPE_MIN_SPEEDUP
    _cards(monkeypatch, 8)
    assert dp.choose_exec(BIG // 2, BIG // 2, device=CUDA).plan != \
        "pipeline"


# ---- the gate ----

def _gate_side() -> int:
    """The smallest power-of-two square (up to MAX_WIDTH) the linear
    projection at D = 8 sends to the mesh."""
    for k in range(12, 21):
        if dp.pipeline_projection(1 << k, 1 << k, 8)[0] \
                >= dp.PIPE_MIN_SPEEDUP:
            return 1 << k
    raise AssertionError("no square up to 2^20 takes the mesh at D = 8")


def test_choose_exec_takes_the_projected_pipeline(as_the_card, monkeypatch):
    _cards(monkeypatch, 8)
    side = _gate_side()
    ep = dp.choose_exec(side, side, device=CUDA)
    assert ep == dp.ExecPlan("pipeline", source="projected")
    assert dp.choose_exec(side, side, EngineConfig(), Scoring(), True,
                          CUDA).source == "projected"
    # the headline pair stays on one card, and so does the half side
    assert dp.choose_exec(HEADLINE, HEADLINE, device=CUDA).plan == "stripe"
    assert dp.choose_exec(side // 2, side // 2, device=CUDA).plan == \
        "stripe"
    # a band, a refused scoring, a small pair: the gate is not asked
    assert dp.choose_exec(side, side, EngineConfig(band=64),
                          device=CUDA).plan == "stripe"
    assert dp.choose_exec(side, side, EngineConfig(), Scoring(mismatch=0),
                          device=CUDA).plan == "scan"
    assert dp.choose_exec(64, 64, device=CUDA).plan == "host"


def test_choose_exec_never_projects_on_one_card(as_the_card, monkeypatch):
    side = _gate_side()
    # no mesh: one card
    assert dp.pipeline_devices() == 1
    assert dp.choose_exec(side, side, device=CUDA).plan == "stripe"
    _cards(monkeypatch, 1)
    assert dp.choose_exec(side, side, device=CUDA).plan == "stripe"
    # the CPU keeps its plain versions, whatever the count
    _cards(monkeypatch, 8)
    assert dp.choose_exec(side, side, device=CPU).plan == "scan"


def test_pipeline_devices_counts_cards_not_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dp.pipeline_devices(_mesh(8, "nccl")) == 8
    # gloo ranks sharing the one card: one card
    assert dp.pipeline_devices(_mesh(8, "gloo")) == 1
    # gloo ranks on the CPU, and a mesh of one
    assert dp.pipeline_devices(_mesh(4, "gloo", CPU)) == 1
    assert dp.pipeline_devices(_mesh(1, "nccl")) == 1
    # gloo ranks each on a card of their own
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dp.pipeline_devices(_mesh(4, "gloo")) == 4
    assert dp.pipeline_devices(_mesh(8, "gloo")) == 4


def test_one_card_projects_no_rows_and_asks_no_rank(as_the_card,
                                                   monkeypatch):
    """On a mesh of fewer than two cards the block rows are the default
    rule's, found without a collective (the meshes here have no group)."""
    from swtpu_torch.dist import pipeline as pl
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for mesh in (_mesh(8, "gloo"), _mesh(4, "gloo", CPU), _mesh(1, "nccl")):
        assert pl.projected_rows(BIG, BIG, mesh, "seq") is None
        assert pl.block_rows_for(BIG, BIG, mesh, "seq") == \
            pl.default_block_rows(BIG, BIG, mesh.shape["seq"])


def test_choose_exec_counts_the_mesh_it_is_given(as_the_card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    side = _gate_side()
    assert dp.choose_exec(side, side, device=CUDA,
                          mesh=_mesh(8, "nccl")).source == "projected"
    assert dp.choose_exec(side, side, device=CUDA,
                          mesh=_mesh(8, "gloo")).plan == "stripe"
    assert dp.choose_exec(side, side, device=CUDA,
                          mesh=_mesh(1, "nccl")).plan == "stripe"


def test_a_projected_plan_without_a_mesh_runs_on_one_device(monkeypatch):
    """align()'s route for the projected tier when no mesh can be had
    (no process group) or the matrices are asked for: the single-device
    plans, the answer unchanged."""
    from swtpu_torch.core.encode import random_pair
    monkeypatch.setattr(ealign, "choose_exec", lambda *a, **kw: dp.ExecPlan(
        "pipeline", source="projected"))
    a, b = random_pair(120, 90, seed=3)
    want = ealign.align(a, b, plan="scan", device="cpu")
    got = ealign.align(a, b, device="cpu")
    assert got.plan == "scan"
    assert (got.max_score, got.max_i, got.max_j, got.last_cell,
            got.aligned_a) == (want.max_score, want.max_i, want.max_j,
                               want.last_cell, want.aligned_a)
    got = ealign.align(a, b, device="cpu", return_matrices=True)
    assert got.plan == "scan" and got.H is not None
    np.testing.assert_array_equal(got.H, ealign.align(
        a, b, plan="scan", device="cpu", return_matrices=True).H)
    assert math.isfinite(float(got.max_score))
