"""The port's sweep harness (``swtpu_torch.bench_sweep``) against the JAX
package's (``swtpu.bench_sweep``), on the CPU.

The grids must be the JAX package's, the records its fields, and every
plan's answer the JAX ``scan_fill`` score of the same seeded pair. Times
on the CPU are host clock and carry ``backend: "cpu"``. Tolerance: exact
equality of grids, fields and scores.
"""

import json

import jax.numpy as jnp
import pytest
import torch

import swtpu.bench_sweep as jbs
from swtpu.core.encode import random_pair as j_random_pair
from swtpu.kernels.scan_fill import scan_fill as j_scan_fill
import swtpu_torch.bench_sweep as bs

PLANS = ("stripe", "scan", "host", "host-simd", "auto")
SIZES = [(32, 32), (300, 200)]


def _strict(const):
    raise ValueError(f"not strict JSON: {const}")


def _records(text: str) -> list:
    return [json.loads(ln, parse_constant=_strict)
            for ln in text.strip().splitlines()]


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("grid", ["square", "rect"])
def test_grid_is_the_jax_grid(grid, quick):
    assert bs._grid(grid, quick) == jbs._grid(grid, quick)


def test_unknown_grid_raises():
    with pytest.raises(ValueError):
        bs._grid("diagonal", True)


def test_sweep_emits_backend_init_record_first(monkeypatch, capsys):
    """The first line is the device's bring-up, its own record with gcups
    0.0 (not Infinity); every line is strict JSON, as the JAX sweep's
    (tests/test_instrument.py:59-78)."""
    monkeypatch.setattr(bs, "_grid", lambda name, quick: [(32, 32)])
    assert bs.main(["--grid", "square", "--quick", "--device", "cpu"]) == 0
    lines = _records(capsys.readouterr().out)
    assert lines[0]["name"] == "backend-init-square"
    assert "init_s" in lines[0]["extra"]
    assert lines[0]["gcups"] == 0.0
    assert lines[0]["backend"] == "cpu"
    assert lines[1]["name"] == "sweep-square"
    assert lines[1]["compile_s"] < 30
    assert len(lines) == 2


@pytest.mark.parametrize("plan", PLANS)
def test_each_plan_answers_the_jax_scan(monkeypatch, capsys, plan):
    monkeypatch.setattr(bs, "_grid", lambda name, quick: SIZES)
    assert bs.main(["--grid", "rect", "--plan", plan, "--device", "cpu",
                    "--repeats", "1"]) == 0
    recs = _records(capsys.readouterr().out)
    assert recs[0]["name"] == "backend-init-rect"
    assert [(r["m"], r["n"]) for r in recs[1:]] == SIZES
    for r in recs[1:]:
        a, b = j_random_pair(r["m"], r["n"], seed=0)
        want = int(j_scan_fill(jnp.asarray(a), jnp.asarray(b)).max_score)
        assert r["extra"]["score"] == want, r
        assert r["name"] == "sweep-rect" and r["repeats"] == 1
        assert r["fill_s"] > 0 and r["compile_s"] > 0
        assert r["backend"] == "cpu"
        # on the CPU auto runs the plain sweep, as score() reports it
        assert r["plan"] == ("scan" if plan == "auto" else plan)
        assert r["cells"] == r["m"] * r["n"]


def test_auto_records_the_plan_score_ran(monkeypatch):
    """``auto`` names the plan ``align(traceback=False)`` reports on the
    codes ``score()`` hands on (a thin pair transposed), not a routing of
    its own: every align() call, the sweep's and score()'s, sees the same
    operands."""
    import swtpu_torch.engine.align as ea
    seen = []
    real = ea.align

    def spy(a, b, *args, **kw):
        seen.append((len(a), len(b), kw.get("traceback")))
        return real(a, b, *args, **kw)
    monkeypatch.setattr(ea, "align", spy)
    for m, n in ((700, 60), (60, 700)):
        *_, plan = bs._time_plan("auto", m, n, 1, k=1, device="cpu")
        assert plan == "scan"
    # the plan's probe, the first call and one round, for each
    assert seen == [(60, 700, False)] * 6


def test_out_appends_jsonl(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bs, "_grid", lambda name, quick: [(16, 24)])
    out = tmp_path / "sweep.jsonl"
    for _ in range(2):
        assert bs.main(["--plan", "host", "--device", "cpu", "--out",
                        str(out), "--repeats", "1"]) == 0
    assert capsys.readouterr().out == ""
    recs = _records(out.read_text())
    assert [r["name"] for r in recs] == ["backend-init-square",
                                         "sweep-square"] * 2


def test_stripe_plan_takes_choose_exec_shape(monkeypatch):
    """``stripe`` launches at ``choose_exec``'s (T, R, C) on the device."""
    import swtpu_torch.dispatch.plan as dp
    import swtpu_torch.kernels.stripe_fill as sf
    got = []
    real = sf.stripe_score

    def spy(a, b, *args, **kw):
        got.append((kw.get("T"), kw.get("R"), kw.get("C")))
        return real(a, b)
    monkeypatch.setattr(sf, "stripe_score", spy)
    monkeypatch.setattr(dp, "choose_exec",
                        lambda m, n, **kw: dp.ExecPlan("stripe", 64, 4, 2,
                                                       "tuned"))
    bs._time_plan("stripe", 64, 48, 1, k=1, device="cpu")
    assert got == [(64, 4, 2)] * 2
    got.clear()
    monkeypatch.setattr(dp, "choose_exec",
                        lambda m, n, **kw: dp.ExecPlan("host"))
    bs._time_plan("stripe", 64, 48, 1, k=1, device="cpu")
    assert got == [(None, None, None)] * 2


def test_host_simd_refusal_raises():
    # the int16 lanes: a score above the saturation cap is refused
    with pytest.raises(ValueError, match="host-simd refuses"):
        bs._time_plan("host-simd", 40000, 8, 1, k=1, device="cpu")


def test_unknown_plan_raises():
    with pytest.raises(ValueError, match="unknown plan"):
        bs._time_plan("bogus", 8, 8, 1, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bs.main(["--plan", "host"])            # 'cuda' is the default
