"""The dispatch layer of the port on the CPU: ``choose_exec``'s tiers as a
pure function (for a CUDA device too: no card is needed to decide),
``_sanitize``, the tuned table's device stamp and its winners, which only
a sweep writes (a call never feeds it), and the host tiers behind the public calls
against the JAX package's same plans (``align(plan='host')``,
``batch_score``/``search(plan='host-simd')``, ``align_hits`` through the
host tier). Inputs are made from seeds with numpy and handed to both
packages. Tolerance: exact equality; the one pinned departure is the
rendering of an unknown base, 'N' in the port's strings where the JAX
package's native strings put a gap."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import swtpu
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.dist import batch as jbatch
from swtpu.dist import database as jdb
import swtpu_torch
from swtpu_torch import EngineConfig, Scoring
from swtpu_torch.core.config import HOST_MAX_CELLS
from swtpu_torch.core.encode import PROTEIN_ALPHABET
from swtpu_torch.core.substitution import BLOSUM62
from swtpu_torch.dispatch import autotune as at
from swtpu_torch.dispatch import plan as dp
from swtpu_torch.dist import batch as tbatch
from swtpu_torch.dist import database as tdb
from swtpu_torch.engine import align as ealign
from swtpu_torch.kernels.stripe_fill import MAX_WIDTH, RB_FORM_TILES

REPO = Path(__file__).resolve().parent.parent
CUDA = torch.device("cuda")
CPU = torch.device("cpu")
SCORINGS = {
    # name: (port scoring, table or None, letters)
    "linear": (Scoring(), None, 4),
    "dna_affine": (Scoring(mode="affine"), None, 4),
    "protein": (Scoring(mode="affine", gap_open=-11, gap_extend=-1),
                BLOSUM62, 20),
}
H100 = {"name": "NVIDIA H100 80GB HBM3", "capability": "9.0",
        "torch": "2.11.0+cu128", "cuda": "12.8"}


def _jax(sc: Scoring):
    return swtpu.Scoring(mode=sc.mode, match=sc.match, mismatch=sc.mismatch,
                         gap=sc.gap, gap_open=sc.gap_open,
                         gap_extend=sc.gap_extend)


def _jsub(sub):
    return None if sub is None else np.asarray(J_BLOSUM62)


def _pair(m: int, n: int, letters: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, letters, m).astype(np.int8)
    b = rng.integers(0, letters, n).astype(np.int8)
    k = min(m, n) // 2
    b[n // 4:n // 4 + k] = a[m // 5:m // 5 + k]
    return a, b


@pytest.fixture
def policy(monkeypatch):
    """A fresh session policy for the test, restored after it."""
    monkeypatch.setattr(dp, "_policy_cache", {"loaded": True,
                                              "policy": None})
    return dp


def _table(*rows) -> dict:
    """A table of (m, n, sig, T, R, C) best rows, stamped as an H100's."""
    return {"device": dict(H100), "entries": [
        {"m": m, "n": n, "sig": sig,
         "best": {"plan": "stripe", "T": T, "R": R, "C": C, "s": 1e-3,
                  "gcups": m * n / 1e6, "kind": "sweep"}, "all": []}
        for m, n, sig, T, R, C in rows]}


# ---- choose_exec ----

@pytest.mark.parametrize("m, n, kw, traceback, want", [
    (MAX_WIDTH + 1, 64, {}, False, "pipeline"),
    (64, 64, {}, True, "host"),
    (64, 64, {}, False, "host"),
    (192, 192, {}, True, "host"),                     # HOST_MAX_CELLS
    (193, 192, {}, True, "stripe"),
    (64, 64, dict(band=8), True, "stripe"),           # a band: no host
    (64, 64, dict(host_max_cells=0), True, "stripe"),
    (2000, 2000, dict(host_max_cells=1 << 22), True, "host"),
    (1, 1, {}, False, "host"),
])
def test_choose_exec_tiers_on_a_card(policy, m, n, kw, traceback, want):
    assert HOST_MAX_CELLS == 192 * 192
    got = dp.choose_exec(m, n, EngineConfig(**kw), Scoring(), traceback,
                         CUDA)
    assert (got.plan, got.source) == (want, "threshold")
    assert (got.T, got.R, got.C) == (None, None, None)


@pytest.mark.parametrize("m, n, kw", [(64, 64, {}), (1, 1, {}),
                                      (4000, 4000, {}),
                                      (64, 64, dict(host_max_cells=1 << 30))])
def test_choose_exec_keeps_the_cpu_on_its_plain_versions(policy, m, n, kw):
    """The port's departure from the JAX package on the CPU: 'auto' takes
    neither host tier there (the JAX package takes both off the TPU)."""
    for tb in (True, False):
        assert dp.choose_exec(m, n, EngineConfig(**kw), Scoring(), tb,
                              CPU).plan == "scan"


def test_choose_exec_refused_scoring_runs_scan(policy):
    for sc, sub in ((Scoring(mismatch=0), None), (Scoring(gap=0), None),
                    (Scoring(gap=1), BLOSUM62)):
        assert dp.choose_exec(2000, 2000, EngineConfig(), sc, False, CUDA,
                              sub).plan == "scan"
    # the host tier comes first: it takes any scoring
    assert dp.choose_exec(64, 64, EngineConfig(), Scoring(mismatch=0),
                          False, CUDA).plan == "host"


def test_choose_exec_takes_a_near_tuned_entry(policy):
    policy._policy_cache["policy"] = at.Policy(_table(
        (8192, 8192, "linear", 256, 8, 2),
        (8192, 8192, "affine", 64, 4, 4),
        (8192, 8192, "affine+sub21", 128, 8, 4)))
    cfg = EngineConfig()
    got = dp.choose_exec(8000, 9000, cfg, Scoring(), False, CUDA)
    assert got == dp.ExecPlan("stripe", 256, 8, 2, "tuned")
    got = dp.choose_exec(8192, 8192, cfg, Scoring(mode="affine"), False,
                         CUDA)
    assert got == dp.ExecPlan("stripe", 64, 4, 4, "tuned")
    got = dp.choose_exec(8192, 8192, cfg, Scoring(mode="affine"), False,
                         CUDA, BLOSUM62)
    assert got == dp.ExecPlan("stripe", 128, 8, 4, "tuned")
    # traceback, a band, a far size or another aspect: the defaults
    for m, n, tb, kw in ((8192, 8192, True, {}), (8192, 8192, False,
                                                  dict(band=64)),
                         (65536, 65536, False, {}), (30000, 2000, False, {})):
        got = dp.choose_exec(m, n, EngineConfig(**kw), Scoring(), tb, CUDA)
        assert got == dp.ExecPlan("stripe")


def test_choose_exec_never_emits_a_shape_the_kernels_refuse(policy):
    # (R, C) = (16, 4) is a linear tile, not an affine one; T = 1024 is
    # above the kernels' 512; T = 100 is no multiple of 32
    policy._policy_cache["policy"] = at.Policy(_table(
        (8192, 8192, "affine", 128, 16, 4),
        (8192, 8192, "linear", 1024, 8, 4),
        (2048, 2048, "linear", 100, 8, 4)))
    for sc, size in ((Scoring(mode="affine"), 8192), (Scoring(), 8192),
                     (Scoring(), 2048)):
        got = dp.choose_exec(size, size, EngineConfig(), sc, False, CUDA)
        assert got == dp.ExecPlan("stripe")


@pytest.mark.parametrize("row, mode, ok", [
    (dict(T=128, R=8, C=4), "linear", True),
    (dict(T=64, R=16, C=4), "linear", True),
    (dict(T=64, R=16, C=4), "affine", False),
    (dict(T=512, R=4, C=4), "affine", True),
    (dict(T=544, R=8, C=4), "linear", False),
    (dict(T=96, R=8, C=3), "linear", False),
    (dict(T=None, R=None, C=None), "linear", True),
    (dict(T="128", R=8, C=4), "linear", False),
    (dict(T=128, R=8, C=4, plan="scan"), "linear", False),
    (dict(T=128, R=8, C=4, plan="host"), "linear", False),
])
def test_sanitize(row, mode, ok):
    sc = Scoring(mode="affine") if mode == "affine" else Scoring()
    got = dp._sanitize({"plan": "stripe", **row}, 4096, sc)
    assert (got is not None) == ok
    if ok:
        assert (got.T, got.R, got.C, got.source) == (
            row["T"], row["R"], row["C"], "tuned")


def test_every_form_tile_passes_sanitize():
    for mode, tiles in RB_FORM_TILES.items():
        sc = Scoring(mode="affine") if mode == "affine" else Scoring()
        sub = BLOSUM62 if mode == "sub" else None
        for T in (32, 64, 128, 256, 512):
            for R, C in tiles:
                assert dp._sanitize(dict(T=T, R=R, C=C), 25632, sc, sub)


# ---- the table: stamp, load, policy ----

def test_load_refuses_a_table_of_another_card(tmp_path):
    path = tmp_path / "t.json"
    at.save(_table((512, 512, "linear", 64, 8, 4)), path)
    assert at.load(path, stamp=H100)["entries"]
    other = dict(H100, name="NVIDIA A100-SXM4-80GB", capability="8.0")
    assert at.load(path, stamp=other) is None
    assert at.load(path, stamp=dict(H100, capability="9.1")) is None
    # torch and CUDA versions are recorded, not compared
    assert at.load(path, stamp=dict(H100, torch="2.12", cuda="13.0"))
    unstamped = tmp_path / "u.json"
    unstamped.write_text(json.dumps({"entries": []}))
    assert at.load(unstamped, stamp=H100) is None
    assert at.load(tmp_path / "missing.json", stamp=H100) is None
    if not torch.cuda.is_available():
        # no card, no stamp: nothing loads
        assert at.device_stamp() is None
        assert at.load(path) is None


def test_the_committed_table_is_stamped_with_an_h100():
    table = json.loads(at.DEFAULT_TABLE.read_text())
    assert "H100" in table["device"]["name"]
    assert table["device"]["capability"] == "9.0"
    # score-only entries of the three scorings at the sweep's sizes, and
    # nothing else: the batch routes take their defaults
    assert sorted((e["sig"], e["m"], e["n"]) for e in table["entries"]) \
        == sorted((sig, s, s) for sig in ("linear", "affine", "affine+sub21")
                  for s in at.SIZES)
    for e in table["entries"]:
        sc = Scoring(mode="affine") if e["sig"].startswith("affine") \
            else Scoring()
        sub = BLOSUM62 if "+sub" in e["sig"] else None
        # a winner is a shape the kernels take, and beat the default by
        # more than the sweep's spread between its rounds
        assert dp._sanitize(e["default"], e["n"], sc, sub) is not None
        if e["best"] is not None:
            assert dp._sanitize(e["best"], e["n"], sc, sub) is not None
            assert e["default"]["s"] / e["best"]["s"] - 1 > e["spread"]


def test_the_policy_never_reads_the_jax_tables(monkeypatch):
    """Neither swtpu_tuned.json nor swtpu_tuned_v5e.json (at the repo root)
    is read, even from the repo root as the working directory."""
    seen = []
    real = at.load

    def spy(path, stamp=None):
        seen.append(Path(path).name)
        return real(path, stamp)

    monkeypatch.setattr(at, "load", spy)
    monkeypatch.setattr(dp, "_policy_cache", {"loaded": False,
                                              "policy": None})
    monkeypatch.delenv(dp.TABLE_ENV, raising=False)
    monkeypatch.chdir(REPO)
    assert (REPO / "swtpu_tuned_v5e.json").exists()
    dp._tuned_policy()
    assert seen == [at.DEFAULT_TABLE.name]
    monkeypatch.setattr(dp, "_policy_cache", {"loaded": False,
                                              "policy": None})
    monkeypatch.setenv(dp.TABLE_ENV, "elsewhere.json")
    dp._tuned_policy()
    assert seen[-1] == "elsewhere.json"
    assert not any(s.startswith("swtpu_tuned") for s in seen)


def test_policy_choose_near_gates():
    pol = at.Policy(_table((2048, 2048, "linear", 128, 8, 4),
                           (2000, 8000, "linear", 64, 4, 4)))
    assert pol.choose_near(2048, 2048)["T"] == 128
    assert pol.choose_near(2500, 2000)["T"] == 128     # near in both
    assert pol.choose_near(2000, 8000)["T"] == 64
    assert pol.choose_near(20000, 20000) is None       # cells 95x
    assert pol.choose_near(512, 512) is None            # 16x fewer
    assert pol.choose_near(2048, 2048, sig="affine") is None
    assert pol.choose(512, 512) == {"plan": "stripe", "T": None, "R": None,
                                    "C": None}
    assert at.Policy().choose_near(1, 1) is None
    # an entry without a winner keeps the defaults near it
    pol.table["entries"][0]["best"] = None
    assert pol.choose_near(2048, 2048) is None
    assert pol.choose(2500, 2000)["T"] is None


@pytest.fixture
def stripe_on_the_cpu(monkeypatch):
    """align()'s dispatch as it decides for a card, with the card's work
    (``stripe_call``) answered by the plain version; each call's kernel
    shape (T, R, C) is recorded."""
    real_choose = ealign.choose_exec
    shapes = []

    def choose(m, n, config, scoring, traceback, device, substitution=None):
        return real_choose(m, n, config, scoring, traceback, CUDA,
                           substitution)

    def call(a, b, scoring, sub, dev, want_tb=False, band=None, T=None,
             R=None, C=None):
        shapes.append((T, R, C))
        r = ealign.align(a, b, scoring, EngineConfig(traceback=want_tb),
                         plan="scan", device="cpu", substitution=sub)
        return [r.max_score, r.max_i, r.max_j, r.last_cell], None

    monkeypatch.setattr(ealign, "choose_exec", choose)
    monkeypatch.setattr(ealign, "stripe_call", call)
    return shapes


def test_explicit_shapes_never_steer_later_calls(policy, stripe_on_the_cpu):
    """A caller's stripe_rows runs that call's kernel shape and leaves the
    table and every later default call as they were."""
    policy._policy_cache["policy"] = at.Policy(_table(
        (1024, 1024, "linear", 256, 8, 2)))
    before = copy.deepcopy(dp._tuned_policy().table)
    a, b = _pair(1000, 1000, 4, 30)
    want = swtpu_torch.score(a, b, plan="scan", device="cpu")
    cfg = EngineConfig(stripe_rows=512, host_simd_max_cells=0)
    for _ in range(2):
        assert swtpu_torch.score(a, b, config=cfg, device="cpu") == want
    assert stripe_on_the_cpu == [(512, None, None)] * 2
    assert dp._tuned_policy().table == before
    # later default calls: the table's winner at this shape, and the
    # defaults where the table has none near
    assert swtpu_torch.score(a, b, config=EngineConfig(
        host_simd_max_cells=0), device="cpu") == want
    assert stripe_on_the_cpu[-1] == (256, 8, 2)
    c, d = _pair(3000, 300, 4, 31)
    swtpu_torch.score(c, d, config=EngineConfig(host_simd_max_cells=0),
                      device="cpu")
    assert stripe_on_the_cpu[-1] == (None, None, None)


@pytest.mark.parametrize("times, tuned", [
    # (default, other) seconds in each of two rounds
    (((1.00, 1.01), (0.90, 0.91)), True),     # 11 % faster, spread 1 %
    (((1.00, 1.01), (0.995, 0.999)), False),  # 0.5 % faster, spread 1 %
    (((1.00, 1.20), (0.90, 0.92)), False),    # 11 % faster, spread 20 %
    (((0.90, 0.91), (1.00, 1.01)), False),    # the default is fastest
])
def test_sweep_names_a_winner_only_beyond_its_spread(monkeypatch, times,
                                                     tuned):
    """``sweep`` keeps a shape other than the default only where it beat
    the default by more than the largest difference between the two
    rounds of any shape at that size; the timings are stubbed."""
    from swtpu_torch.kernels.stripe_fill import rb_shape
    default = rb_shape(4096, mode="linear")
    other = (64, 16, 4)
    assert other != default
    monkeypatch.setattr(at, "_require_card", lambda what: CPU)
    monkeypatch.setattr(at, "device_stamp", lambda: dict(H100))
    monkeypatch.setattr(at, "_grid", lambda *args: [default, other])
    seen = []
    monkeypatch.setattr(ealign, "stripe_call",
                        lambda *a, T=None, R=None, C=None, **kw:
                        seen.append((T, R, C)))
    clock = {default: list(times[0]), other: list(times[1])}

    def events(fn, k):
        fn()
        return clock[seen[-1]].pop(0)

    monkeypatch.setattr(at, "_events_s", events)
    table = at.sweep(sizes=(4096,), verbose=False)
    (e,) = table["entries"]
    assert (e["m"], e["n"], e["sig"]) == (4096, 4096, "linear")
    assert seen == [default, other, default, other]   # two rounds
    spread = max(max(t) / min(t) - 1 for t in times)
    assert e["spread"] == pytest.approx(spread)
    assert (e["default"]["T"], e["default"]["R"], e["default"]["C"]) == \
        default and e["default"]["s"] == min(times[0])
    if tuned:
        assert (e["best"]["T"], e["best"]["R"], e["best"]["C"]) == other
    else:
        assert e["best"] is None
    pol = at.Policy(table)
    assert (pol.choose_near(4096, 4096) is not None) == tuned


def test_sweeps_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for fn in (at.sweep, at.sweep_batch, at.host_crossover,
               lambda: at.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_scoring_sig():
    assert at.scoring_sig(Scoring()) == "linear"
    assert at.scoring_sig(Scoring(mode="affine")) == "affine"
    assert at.scoring_sig(Scoring(mode="affine"), BLOSUM62) == "affine+sub21"
    assert at.scoring_sig(None) == "linear"


# ---- the host tiers behind the public calls, against the JAX package ----

@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("m, n, seed", [(40, 90, 1), (150, 60, 2),
                                        (97, 97, 3), (1, 30, 4)])
def test_align_plan_host_matches_jax(name, m, n, seed):
    sc, sub, letters = SCORINGS[name]
    a, b = _pair(m, n, letters, seed)
    kw = {} if sub is None else {"alphabet": PROTEIN_ALPHABET}
    got = swtpu_torch.align(a, b, sc, plan="host", substitution=sub,
                            device="cpu", **kw)
    want = swtpu.align(a, b, _jax(sc), plan="host", substitution=_jsub(sub),
                       **kw)
    assert got.plan == "host"
    assert (got.max_score, got.max_i, got.max_j, got.last_cell,
            got.max_pos, got.path, got.aligned_a, got.aligned_b) == (
        want.max_score, want.max_i, want.max_j, want.last_cell,
        want.max_pos, want.path, want.aligned_a, want.aligned_b)
    # and with the matrices
    got = swtpu_torch.align(a, b, sc, plan="host", substitution=sub,
                            device="cpu", return_matrices=True,
                            traceback=False)
    want = swtpu.align(a, b, _jax(sc), plan="host", substitution=_jsub(sub),
                       return_matrices=True, traceback=False)
    np.testing.assert_array_equal(got.H, want.H)
    np.testing.assert_array_equal(got.P, want.P)
    assert got.path is None


def test_align_plan_host_renders_an_unknown_base():
    """The pinned departure: the JAX package's host tier renders code -1
    as a gap in linear mode (its native strings) and as the alphabet's
    last letter in affine mode (its oracle); the port as 'N' on both."""
    a = swtpu_torch.encode("ACGTTGCAACGTAC")
    b = a.copy()
    b[6] = -1
    for sc, jlet in ((Scoring(), "-"), (Scoring(mode="affine"), "T")):
        got = swtpu_torch.align(a, b, sc, plan="host", device="cpu")
        want = swtpu.align(a, b, _jax(sc), plan="host")
        assert (got.max_score, got.max_pos, got.last_cell, got.path) == (
            want.max_score, want.max_pos, want.last_cell, want.path)
        assert got.aligned_a == want.aligned_a
        k = got.aligned_b.index("N")
        assert want.aligned_b[k] == jlet
        assert got.aligned_b[:k] + got.aligned_b[k + 1:] == \
            want.aligned_b[:k] + want.aligned_b[k + 1:]


def test_align_plan_host_falls_back_for_a_band_or_sentinels():
    a, b = _pair(60, 50, 4, 5)
    got = swtpu_torch.align(a, b, plan="host", device="cpu",
                            config=EngineConfig(band=5))
    want = swtpu_torch.align(a, b, plan="scan", device="cpu",
                             config=EngineConfig(band=5))
    assert got.plan == "scan"
    assert (got.max_score, got.path) == (want.max_score, want.path)
    pa, pb = _pair(30, 30, 20, 6)
    pa[2] = -1
    got = swtpu_torch.align(pa, pb, SCORINGS["protein"][0], plan="host",
                            substitution=BLOSUM62, device="cpu",
                            alphabet=PROTEIN_ALPHABET)
    assert got.plan == "scan"


def test_auto_on_the_cpu_keeps_the_plain_versions():
    """device='cpu' with 'auto': no host tier, however small the pair or
    however large the caps (the JAX package takes them off the TPU)."""
    a, b = _pair(30, 30, 4, 7)
    cfg = EngineConfig(host_max_cells=1 << 30, host_simd_max_cells=1 << 30)
    assert swtpu_torch.align(a, b, config=cfg, device="cpu").plan == "scan"
    r = swtpu_torch.align(a, b, config=cfg, traceback=False, device="cpu")
    assert r.plan == "scan"
    assert swtpu.align(a, b).max_score == r.max_score


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("B, m, n", [(6, 40, 300), (5, 64, 64), (3, 1, 50)])
def test_batch_score_host_simd_matches_jax(name, B, m, n):
    sc, sub, letters = SCORINGS[name]
    pairs = [_pair(m, n, letters, 10 * B + k) for k in range(B)]
    aa = np.stack([p[0] for p in pairs])
    bb = np.stack([p[1] for p in pairs])
    got = swtpu_torch.batch_score(aa, bb, sc, plan="host-simd",
                                  substitution=sub, device="cpu")
    want = jbatch.batch_score(aa, bb, _jax(sc), plan="host-simd",
                              substitution=_jsub(sub))
    assert all(x.device == CPU and x.dtype == torch.int32 for x in got)
    assert [x.tolist() for x in got] == [np.asarray(x).tolist()
                                         for x in want]
    plain = swtpu_torch.batch_score(aa, bb, sc, plan="scan",
                                    substitution=sub, device="cpu")
    assert [x.tolist() for x in got] == [x.tolist() for x in plain]


def test_host_simd_raises_where_the_jax_package_raises():
    aa, bb = _pair(40, 40, 4, 8)
    aa, bb = aa[None], bb[None]
    bad = Scoring(mode="affine", gap_open=-1, gap_extend=-6)
    with pytest.raises(ValueError, match="band") as e:
        swtpu_torch.batch_score(aa, bb, band=4, plan="host-simd",
                                device="cpu")
    with pytest.raises(ValueError, match="band") as j:
        jbatch.batch_score(aa, bb, band=4, plan="host-simd")
    with pytest.raises(ValueError, match="device mesh"):
        tbatch._host_simd(aa, bb, Scoring(), None, object(), None, "cpu")
    with pytest.raises(ValueError) as e:
        swtpu_torch.batch_score(aa, bb, bad, plan="host-simd", device="cpu")
    with pytest.raises(ValueError) as j:
        jbatch.batch_score(aa, bb, _jax(bad), plan="host-simd")
    assert str(e.value) == str(j.value)
    big = Scoring(match=20)
    a2 = np.zeros((1, 2000), np.int8)
    with pytest.raises(ValueError) as e:
        swtpu_torch.batch_score(a2, a2, big, plan="host-simd", device="cpu")
    with pytest.raises(ValueError) as j:
        jbatch.batch_score(a2, a2, _jax(big), plan="host-simd")
    assert str(e.value) == str(j.value)
    assert "saturation" in str(e.value)


def test_host_simd_search_refusals():
    q = tdb.pad_queries([np.zeros(8, np.int8)], 8)
    ref = np.zeros(64, np.int8)
    with pytest.raises(ValueError, match="device mesh"):
        tdb._check_host_simd(object(), 8, 64, Scoring(), None)
    # reads too long for the int16 lanes
    with pytest.raises(ValueError, match="int16 lanes"):
        tdb._check_host_simd(None, 40000, 50000, Scoring(), None)
    # reference codes the window profile cannot take
    bad = ref.copy()
    bad[5] = 9
    with pytest.raises(ValueError, match="reference codes"):
        swtpu_torch.search(q, bad, plan="host-simd", device="cpu")
    hits = swtpu_torch.search(q, ref, plan="host-simd", device="cpu")
    assert [x.tolist() for x in hits] == [[8 * 3], [7], [8]]


def _search_case(name: str, B: int, qlen: int, L: int, seed: int):
    sc, sub, letters = SCORINGS[name]
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, letters, L).astype(np.int8)
    reads = []
    for k in range(B):
        ln = int(rng.integers(qlen // 2, qlen + 1))
        at_ = int(rng.integers(0, L - ln))
        r = ref[at_:at_ + ln].copy()
        r[rng.integers(0, ln, 2)] = rng.integers(0, letters, 2)
        reads.append(r)
    if sub is None:
        reads[0][len(reads[0]) // 2] = -1        # an unknown base
    return sc, sub, tdb.pad_queries(reads, qlen), ref


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("window, n_best", [(500, 1), (40000, 1),
                                            (700, 2)])
def test_search_host_simd_matches_jax(name, window, n_best):
    sc, sub, q, ref = _search_case(name, 9, 40, 3000, 11)
    got = swtpu_torch.search(q, ref, window=window, scoring=sc,
                             substitution=sub, n_best=n_best,
                             plan="host-simd", device="cpu")
    want = jdb.search(q, ref, window=window, scoring=_jax(sc),
                      substitution=_jsub(sub), n_best=n_best,
                      plan="host-simd")
    assert type(got).__name__ == type(want).__name__
    assert [x.tolist() for x in got] == [np.asarray(x).tolist()
                                         for x in want]
    plain = swtpu_torch.search(q, ref, window=window, scoring=sc,
                               substitution=sub, n_best=n_best,
                               plan="scan", device="cpu")
    assert [x.tolist() for x in got] == [x.tolist() for x in plain]


def test_search_host_simd_both_strands_matches_jax():
    sc, sub, q, ref = _search_case("linear", 6, 36, 2000, 12)
    got = swtpu_torch.search(q, ref, window=400, strand="both",
                             plan="host-simd", device="cpu")
    want = jdb.search(q, ref, window=400, strand="both", plan="host-simd")
    assert [x.tolist() for x in got] == [np.asarray(x).tolist()
                                         for x in want]


@pytest.fixture
def host_tier_on_the_cpu(monkeypatch):
    """align()'s dispatch as it decides for a card, on CPU tensors: the
    host tier for a pair up to host_max_cells, else the kernels' plain
    versions; the host tier's calls are counted."""
    real_choose, real_host = ealign.choose_exec, ealign._host_path
    calls = []

    def choose(m, n, config, scoring, traceback, device, substitution=None):
        return real_choose(m, n, config, scoring, traceback, CUDA,
                           substitution)

    def host(*args, **kw):
        calls.append(1)
        return real_host(*args, **kw)

    monkeypatch.setattr(ealign, "choose_exec", choose)
    monkeypatch.setattr(ealign, "_host_path", host)
    return calls


@pytest.mark.parametrize("name", ["linear", "dna_affine"])
def test_align_hits_through_the_host_tier_matches_jax(host_tier_on_the_cpu,
                                                      name):
    sc, sub, q, ref = _search_case(name, 8, 40, 4000, 13)
    hits = swtpu_torch.search(q, ref, window=600, scoring=sc, device="cpu")
    got = tdb.align_hits(hits, q, ref, sc, device="cpu")
    jh = jdb.search(q, ref, window=600, scoring=_jax(sc))
    want = jdb.align_hits(jh, q, ref, _jax(sc))
    assert len(got) == len(want) == len(host_tier_on_the_cpu) > 0
    for g, w in zip(got, want):
        assert (g.read, g.score, g.ref_start, g.ref_end, g.read_end,
                g.aligned_ref, g.strand) == (
            w.read, w.score, w.ref_start, w.ref_end, w.read_end,
            w.aligned_ref, w.strand)
        if g.read == 0:
            # read 0 carries an unknown base: 'N' here, where the JAX
            # package's native strings (linear) put a gap, so that its
            # read start and CIGAR count the base as one, and its oracle
            # (affine) the alphabet's last letter
            k = g.aligned_read.index("N")
            assert w.aligned_read[k] == ("-" if name == "linear" else "T")
            assert g.cigar == f"{len(g.aligned_read)}M"
            assert g.read_start == w.read_start - (name == "linear")
        else:
            assert (g.read_start, g.aligned_read, g.cigar) == (
                w.read_start, w.aligned_read, w.cigar)


def test_align_hits_protein_through_the_host_tier(host_tier_on_the_cpu):
    sc, sub, q, ref = _search_case("protein", 5, 30, 3000, 14)
    hits = swtpu_torch.search(q, ref, window=500, scoring=sc,
                              substitution=sub, device="cpu")
    got = tdb.align_hits(hits, q, ref, sc, substitution=sub, device="cpu")
    jh = jdb.search(q, ref, window=500, scoring=_jax(sc),
                    substitution=_jsub(sub))
    want = jdb.align_hits(jh, q, ref, _jax(sc), substitution=_jsub(sub))
    assert len(host_tier_on_the_cpu) == len(got) > 0
    assert [(g.read, g.score, g.ref_start, g.cigar, g.aligned_read,
             g.aligned_ref) for g in got] == [
        (w.read, w.score, w.ref_start, w.cigar, w.aligned_read,
         w.aligned_ref) for w in want]


def test_batch_align_realigns_through_the_host_tier(host_tier_on_the_cpu):
    aa, bb = swtpu_torch.random_batch(5, 60, 80, seed=3)
    got = swtpu_torch.batch_align(aa, bb, top=3, device="cpu")
    want = jbatch.batch_align(aa, bb, top=3)
    assert len(host_tier_on_the_cpu) == 3
    assert [(i, r.max_score, r.max_pos, r.aligned_a, r.aligned_b, r.plan)
            for i, r in got] == [
        (i, r.max_score, r.max_pos, r.aligned_a, r.aligned_b, "host")
        for i, r in want]
    # the card machine's crossover, not the JAX package's 2^20: pairs
    # above HOST_MAX_CELLS leave the host tier
    assert HOST_MAX_CELLS < 200 * 200
    aa, bb = swtpu_torch.random_batch(3, 200, 200, seed=4)
    got = swtpu_torch.batch_align(aa, bb, top=2, device="cpu")
    assert len(host_tier_on_the_cpu) == 3 and [r.plan for _, r in got] == [
        "stripe", "stripe"]


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CUDA


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SCORINGS))
def test_host_tiers_serve_auto_on_the_card(cuda, name):
    from swtpu_torch.kernels import stripe_fill as sf
    sc, sub, letters = SCORINGS[name]
    kw = dict(substitution=sub, alphabet=PROTEIN_ALPHABET if sub is not None
              else "ACGT")
    a, b = _pair(64, 64, letters, 21)
    sf.reset_counts()
    r = swtpu_torch.align(a, b, sc, device=cuda, **kw)
    assert r.plan == "host" and not any(sf.launches.values())
    k = swtpu_torch.align(a, b, sc, plan="stripe", device=cuda, **kw)
    assert k.plan == "stripe" and sf.launches[sf.fill_kernel_name(sc, sub)]
    assert (r.max_score, r.max_pos, r.last_cell, r.path, r.aligned_a,
            r.aligned_b) == (k.max_score, k.max_pos, k.last_cell, k.path,
                             k.aligned_a, k.aligned_b)
    side = min(512, int(EngineConfig().simd_cells_cap() ** 0.5))
    a, b = _pair(side, side, letters, 22)
    r = swtpu_torch.align(a, b, sc, traceback=False, device=cuda, **kw)
    k = swtpu_torch.align(a, b, sc, traceback=False, plan="stripe",
                          device=cuda, **kw)
    assert r.plan == "host-simd"
    assert (r.max_score, r.max_i, r.max_j, r.last_cell) == (
        k.max_score, k.max_i, k.max_j, k.last_cell)


@pytest.mark.gpu
def test_the_committed_table_decides_on_the_h100(cuda, monkeypatch):
    if at.device_stamp()["capability"] != "9.0":
        pytest.skip("the committed table is an H100's")
    monkeypatch.setattr(dp, "_policy_cache", {"loaded": False,
                                              "policy": None})
    monkeypatch.delenv(dp.TABLE_ENV, raising=False)
    table = at.load()
    assert table is not None
    for e in table["entries"]:
        sc = Scoring(mode="affine") if e["sig"].startswith("affine") \
            else Scoring()
        sub = BLOSUM62 if "+sub" in e["sig"] else None
        got = dp.choose_exec(e["m"], e["n"], EngineConfig(), sc, False,
                             cuda, sub)
        want = dp.ExecPlan("stripe") if e["best"] is None else dp.ExecPlan(
            "stripe", e["best"]["T"], e["best"]["R"], e["best"]["C"],
            "tuned")
        assert got == want, e["sig"]
    a, b = _pair(8192, 8192, 4, 23)
    assert swtpu_torch.score(a, b, device=cuda) == swtpu_torch.score(
        a, b, plan="stripe", device=cuda)


@pytest.mark.gpu
def test_host_simd_answers_on_the_card(cuda):
    aa, bb = swtpu_torch.random_batch(16, 300, 400, seed=5)
    got = swtpu_torch.batch_score(aa, bb, plan="host-simd", device=cuda)
    assert all(x.device.type == "cuda" for x in got)
    want = swtpu_torch.batch_score(aa, bb, plan="stripe", device=cuda)
    assert [x.tolist() for x in got] == [x.tolist() for x in want]
    sc, sub, q, ref = _search_case("linear", 20, 60, 40000, 25)
    got = swtpu_torch.search(q, ref, plan="host-simd", device=cuda)
    want = swtpu_torch.search(q, ref, plan="stripe", device=cuda)
    assert [x.tolist() for x in got] == [x.tolist() for x in want]
