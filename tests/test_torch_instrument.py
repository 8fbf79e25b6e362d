"""The port's instrument layer (``instrument.metrics``' ``block`` and
``BenchRecord``, ``instrument.profiling``, ``instrument.access``) and
``dispatch.plan.choose_plan``, against the JAX package's where both
compute the same thing, on the CPU; on a card (the ``gpu`` tests) the
traffic model against the caching allocator and ptxas, and the trace.

Tolerances: exact equality of records, grids, plans and kernel names; the
traffic model within the JAX package's bounds (tests/test_instrument.py:
P within 0.8-1.25x of its model) and within 2x for the stripe's scratch
and on-chip working set.
"""

import dataclasses
import json
import os
import subprocess

import pytest
import torch

from swtpu.instrument.metrics import BenchRecord as JBenchRecord
from swtpu_torch import EngineConfig
from swtpu_torch.core.config import HOST_MAX_CELLS
from swtpu_torch.dispatch.plan import choose_exec, choose_plan
from swtpu_torch.instrument import access, profiling
from swtpu_torch.instrument.metrics import BenchRecord, block, gcups
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import stripe_fill as sf

CPU = torch.device("cpu")
CUDA = torch.device("cuda")


# ---- metrics ----

RECORDS = [
    dict(name="x", m=100, n=200, fill_s=0.5, plan="scan"),
    dict(name="sweep-square", m=25632, n=25632, repeats=3, fill_s=0.0085,
         compile_s=1.5, plan="stripe", extra={"score": 18276}),
    dict(name="batch", m=1056, n=1056, batch=64, fill_s=0.001,
         traceback_s=0.2, devices=4, plan="packed", extra={"t": [1, 2]}),
    dict(name="backend-init-rect", m=0, n=0, fill_s=0.25, plan="-",
         extra={"init_s": 0.25}),
]


@pytest.mark.parametrize("fields", RECORDS)
def test_bench_record_json_matches_jax(fields):
    ours = json.loads(BenchRecord(backend="NVIDIA H100", **fields).to_json())
    theirs = json.loads(JBenchRecord(backend="tpu", **fields).to_json())
    assert ours.pop("backend") == "NVIDIA H100"
    theirs.pop("backend")
    assert ours == theirs
    # the same keys in the same order
    assert list(json.loads(BenchRecord(**fields).to_json())) == \
        list(json.loads(JBenchRecord(**fields).to_json()))


def test_bench_record_properties():
    r = BenchRecord(name="x", m=100, n=200, batch=3, fill_s=0.5)
    assert r.cells == 60000 and r.gcups == gcups(60000, 0.5)
    assert json.loads(BenchRecord(name="i", m=0, n=0, fill_s=0.1)
                      .to_json())["gcups"] == 0.0
    assert [f.name for f in dataclasses.fields(BenchRecord)] == \
        [f.name for f in dataclasses.fields(JBenchRecord)]


@dataclasses.dataclass
class _Holder:
    x: torch.Tensor
    rest: tuple


@pytest.mark.parametrize("x", [
    torch.arange(4), (torch.ones(2), [torch.zeros(3)]),
    {"a": torch.ones(1)}, _Holder(torch.ones(2), (torch.zeros(1),)), None,
    3.5])
def test_block_returns_its_argument_on_the_cpu(x):
    assert block(x) is x


# ---- profiling ----

@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace("unused"):
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        access.validate_model(64, 64)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "t"), device="cpu") as prof:
        torch.ones(64).cumsum(0)
    data = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
    assert data["traceEvents"]
    assert prof.key_averages()
    assert not profiling.trace_kernels(str(tmp_path / "t"))


def _rb(R, C, *flags):
    bits = ", ".join("true" if f else "false" for f in flags)
    return (f"void (anonymous namespace)::stripe_rb_kernel<{R}, {C}, "
            f"{bits}>(signed char const*, int)")


# kAffine, kSub, kP, kBlock, kBand, kDebugH, kPairs, kShared, kPacked
ENTRIES = [
    (_rb(8, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0), "sw_stripe_rb_linear"),
    (_rb(8, 4, 1, 0, 0, 0, 0, 0, 0, 0, 0), "sw_stripe_rb_affine"),
    (_rb(8, 4, 1, 1, 0, 0, 0, 0, 0, 0, 0), "sw_stripe_rb_sub"),
    (_rb(4, 4, 0, 0, 1, 0, 0, 0, 0, 0, 0), "sw_stripe_rb_fill_p_linear"),
    (_rb(4, 4, 0, 1, 1, 0, 1, 0, 0, 0, 0), "sw_stripe_rb_fill_p_band_sub"),
    (_rb(8, 4, 1, 0, 0, 1, 0, 0, 0, 0, 0), "sw_stripe_rb_block_affine"),
    (_rb(8, 4, 0, 0, 0, 0, 1, 0, 0, 0, 0), "sw_stripe_rb_band_linear"),
    (_rb(8, 4, 0, 0, 0, 0, 0, 1, 0, 0, 0), "sw_sanitize_rb_linear"),
    (_rb(8, 4, 0, 1, 0, 0, 0, 1, 0, 0, 1), "sw_sanitize_packed_rb_sub"),
    (_rb(8, 4, 0, 0, 0, 0, 0, 0, 1, 0, 0), "sw_pairs_rb_linear"),
    (_rb(8, 4, 1, 0, 0, 0, 1, 0, 1, 0, 0), "sw_pairs_rb_band_affine"),
    (_rb(8, 4, 0, 0, 0, 0, 0, 0, 1, 1, 0), "sw_window_rb_linear"),
    (_rb(8, 4, 1, 0, 0, 0, 0, 0, 0, 0, 1), "sw_packed_rb_affine"),
    ("void (anonymous namespace)::window_warp_kernel<5, false, true>(x)",
     "sw_window_warp_sub"),
    ("void (anonymous namespace)::window_warp_kernel<16, true, false>(x)",
     "sw_window_warp_affine"),
    ("void (anonymous namespace)::walk_p_tiled_kernel(x)",
     "sw_walk_p_tiled"),
    ("void (anonymous namespace)::walk_p_kernel(x)", "sw_walk_p"),
    ("void at::native::vectorized_elementwise_kernel<4>(x)",
     "void at::native::vectorized_elementwise_kernel<4>(x)"),
]


@pytest.mark.parametrize("kernel, entry", ENTRIES,
                         ids=[e for _, e in ENTRIES][:-1] + ["other"])
def test_trace_names_the_c_entry(kernel, entry):
    assert profiling.entry_of(kernel) == entry


MODES = ("linear", "affine", "sub")
RB_ENTRIES = [form.format(mode=mode) for form in sf.RB_ENTRY_FLAGS
              for mode in MODES]


def test_every_rb_entry_is_a_counted_kernel():
    """entry_of names only C entries the wrappers count, and the table of
    entries holds every counted register-blocked entry."""
    from swtpu_torch.kernels import debug_fill as df
    from swtpu_torch.kernels import pairs_fill as pf
    from swtpu_torch.kernels import window_fill as wf
    counted = {*sf.launches, *pf.launches, *wf.launches, *df.rb_launches,
               *df.packed_rb_launches}
    assert {e for _, e in ENTRIES[:-1]} <= counted
    assert set(RB_ENTRIES) <= counted
    assert {e for e in counted if "_rb_" in e} == set(RB_ENTRIES)


@pytest.mark.parametrize("affine", [False, True], ids=["linear_gaps",
                                                       "affine_gaps"])
@pytest.mark.parametrize("entry", RB_ENTRIES)
def test_rb_entry_and_flags_agree(entry, affine):
    """entry_of, rb_symbol's flags and rb_entry all read the one table:
    an entry's instantiation, named as a trace names it, maps back to the
    entry."""
    flags = sf.rb_flags(entry, affine)
    assert sf.rb_entry(flags) == entry
    assert profiling.entry_of(_rb(8, 4, *flags)) == entry
    if entry in (*sf.RB_KERNELS.values(), *sf.RB_P_KERNELS.values()):
        mode = entry.rsplit("_", 1)[1]
        sym = access.rb_symbol(mode, 8, 4, "fill_p" in entry, affine)
        assert sym.endswith("".join(f"Lb{int(f)}E" for f in flags))


def _source_flags(path) -> dict:
    """{C entry: the set of flag tuples after (R, C, kAffine, kSub) of the
    launch<...> calls of its source}, read from the text: a source's
    entries share its launch macro, whose P_ is the P-capture entries'
    true."""
    import re
    text = path.read_text().replace("\\\n", " ")
    launches = [[a.strip() for a in args.split(",")][4:]
                for args in re.findall(r"launch<([^>]*)>\(", text)]
    out = {}
    for entry in re.findall(r'extern "C" int (sw_\w+)\(', text):
        if entry.rsplit("_", 1)[1] not in MODES:
            continue
        got = set()
        for args in launches:
            vals = [("fill_p" in entry) if a == "P_" else a in ("true", "1")
                    for a in args]
            got.add(tuple(vals + [False] * (7 - len(vals))))
        out[entry] = got
    return out


RB_SOURCES = sorted(p.name for p in _cuda.SOURCES
                    if p.name.startswith("stripe_rb"))


@pytest.mark.parametrize("src", RB_SOURCES)
def test_rb_entry_flags_are_the_sources(src):
    """The table of entries against csrc/: each register-blocked entry's
    launch<> template arguments are its row's flags."""
    got = _source_flags(_cuda.SOURCES[0].parent / src)
    assert got
    for entry, flags in got.items():
        assert entry in RB_ENTRIES, entry
        assert flags == {sf.rb_flags(entry)[2:]}, (entry, flags)


def test_every_rb_entry_has_a_source():
    found = set()
    for src in RB_SOURCES:
        found |= set(_source_flags(_cuda.SOURCES[0].parent / src))
    assert found == set(RB_ENTRIES)


def test_trace_kernels_reads_kernel_events(tmp_path):
    events = [{"cat": "kernel", "name": ENTRIES[0][0]},
              {"cat": "kernel", "name": ENTRIES[0][0]},
              {"cat": "kernel", "name": ENTRIES[13][0]},
              {"cat": "cpu_op", "name": ENTRIES[1][0]}]
    (tmp_path / profiling.TRACE_FILE).write_text(
        json.dumps({"traceEvents": events}))
    got = profiling.trace_kernels(str(tmp_path))
    assert got == {"sw_stripe_rb_linear": 2, "sw_window_warp_sub": 1}


# ---- access: the traffic model ----

def test_traffic_model_orders():
    """tests/test_instrument.py:14-28's orders, for the stripe the port
    launches: score-only traffic far below 0.01 B/cell at the benchmark
    size, the reference's pathology above 100."""
    m = n = 25632
    ours = access.stripe_traffic(m, n)
    theirs = access.reference_v61_traffic(m, n)
    assert ours.bytes_per_cell < 0.01
    assert theirs.bytes_per_cell > 100
    assert "eliminates" in theirs.notes
    assert len(access.report(m, n).splitlines()) == 5


@pytest.mark.parametrize("mn", [(64, 64), (4096, 4096), (25632, 25632),
                                (145002, 2000)])
def test_report_gives_five_lines(mn):
    lines = access.report(*mn).splitlines()
    assert len(lines) == 5
    assert lines[0].startswith("[scan(score)]")
    assert lines[1].startswith("[scan(P)]")
    assert lines[2].startswith("[stripe(") and "score" in lines[2]
    assert lines[3].startswith("[stripe(") and "K4 P" in lines[3]
    assert lines[4].startswith("[reference-v6.1")


def test_reference_v61_is_the_jax_arithmetic():
    from swtpu.instrument.access import reference_v61_traffic as j
    for m, n in ((512, 512), (4128, 4128), (25632, 2000)):
        a, b = access.reference_v61_traffic(m, n), j(m, n)
        assert (a.hbm_read_bytes, a.hbm_write_bytes, a.resident_bytes,
                a.bytes_per_cell) == (b.hbm_read_bytes, b.hbm_write_bytes,
                                      b.resident_bytes, b.bytes_per_cell)


def test_scan_traffic_traceback_dominates_writes():
    t0 = access.scan_traffic(4096, 4096, traceback=False)
    t1 = access.scan_traffic(4096, 4096, traceback=True)
    assert t1.p_bytes == (4096 + 4096 - 1) * 4096
    assert t1.hbm_write_bytes > t0.hbm_write_bytes + t1.p_bytes
    assert t0.p_bytes == 0


def test_stripe_p_dominates():
    t0 = access.stripe_traffic(4096, 4096)
    t1 = access.stripe_traffic(4096, 4096, traceback=True)
    assert t1.hbm_write_bytes > 100 * t0.hbm_write_bytes
    assert t1.p_bytes == 3 + 4097 * 4112         # the padded pitch
    assert t0.p_bytes == 0


@pytest.mark.parametrize("mode", ["linear", "affine", "sub"])
@pytest.mark.parametrize("n", [20, 1000, 1024, 1025, 25632])
def test_stripe_traffic_reads_the_wrapper(mode, n):
    """The hand-off rows, sync and best of ``_rb_scratch`` at the shape
    ``rb_shape`` gives, and the right column, on the meta device."""
    from swtpu_torch import Scoring
    from swtpu_torch.core.substitution import BLOSUM62
    sc = Scoring(mode="affine") if mode == "affine" else Scoring()
    sub = BLOSUM62 if mode == "sub" else None
    m = 777
    rep = access.stripe_traffic(m, n, scoring=sc, substitution=sub)
    T, R, C = sf.rb_shape(n, None, None, None, mode,
                          0 if sub is None else len(sub))
    meta = torch.device("meta")
    a = torch.empty(m, dtype=torch.int8, device=meta)
    b = torch.empty(n, dtype=torch.int8, device=meta)
    *_, sync, bnd, bnd_f, best = sf._rb_scratch(a, b, sc, None, T, R)
    stripes = -(-n // (T * R))
    assert rep.plan.startswith(f"stripe(T={T},R={R},C={C},")
    assert f"{stripes} stripes" in rep.notes
    handed = (stripes - 1) * (m + 1) * 4 * (2 if bnd_f is not None else 1)
    assert handed <= bnd.nbytes * (2 if bnd_f is not None else 1)
    # written once, read once
    assert rep.hbm_write_bytes >= handed + sync.nbytes + best.nbytes \
        + 8 * (n + 1)
    assert rep.hbm_read_bytes >= handed + stripes * m + n
    assert rep.scratch_bytes >= sync.nbytes + bnd.nbytes + best.nbytes \
        + (0 if bnd_f is None else bnd_f.nbytes)


def test_stripe_traffic_takes_a_tile():
    rep = access.stripe_traffic(4096, 4096, T=64, R=8, C=2)
    assert rep.plan.startswith("stripe(T=64,R=8,C=2,")
    with pytest.raises(ValueError):
        access.stripe_traffic(4096, 4096, R=3, C=3)


def test_measured_memory_is_none_on_the_cpu():
    assert access.measured_memory(lambda x: x + 1, torch.ones(4)) is None
    assert access.validate_model(64, 64, device="cpu") == {}
    mm = access.MeasuredMemory(100, 60, 8, 0)
    assert mm.bytes_per_cell(40) == 4.0


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116stripe_rb_kernelILi8ELi4ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELb0EEEvPKa' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 87 registers, used 1 barriers, 9100 bytes smem, 500 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116stripe_rb_kernelILi4ELi4ELb0ELb0ELb1ELb0ELb0ELb0ELb0ELb0ELb0EEEvPKa' for 'sm_90a'
ptxas info    : Used 79 registers, used 1 barriers, 9100 bytes smem, 500 bytes cmem[0]
"""


def test_ptxas_usage_and_launched_resident(monkeypatch):
    # the launcher's dynamic shared memory comes from the kernel library,
    # which needs nvcc: zero, as linear K1 and K4 ask for none
    monkeypatch.setattr(access, "launch_smem", lambda *a: 0)
    usage = access.ptxas_usage(PTXAS_LOG)
    assert sorted(usage.values()) == [(79, 9100), (87, 9100)]
    # K1 at 4096^2: T = 128 threads, 4 stripes in flight
    assert access.launched_resident(usage, 4096, 4096) == \
        (4 * 87 * 128 + 9100) * 4
    # K4 at its (64, 4, 4): 16 stripes
    assert access.launched_resident(usage, 4096, 4096, traceback=True) == \
        (4 * 79 * 64 + 9100) * 16
    with pytest.raises(KeyError):
        access.launched_resident(usage, 4096, 4096, R=8, C=2)


# a ptxas log of three entries: K1 (8, 4) linear with its frame line, K5
# (8, 4) DNA affine with a spill, and K4 (4, 4) without a frame line
COST_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116stripe_rb_kernelILi8ELi4ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELb0EEEvPKa' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116stripe_rb_kernelILi8ELi4ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELb0ELb0EEEvPKa
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 87 registers, used 1 barriers, 9100 bytes smem, 500 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116stripe_rb_kernelILi8ELi4ELb1ELb0ELb0ELb1ELb0ELb0ELb0ELb0ELb0EEEvPKa' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116stripe_rb_kernelILi8ELi4ELb1ELb0ELb0ELb1ELb0ELb0ELb0ELb0ELb0EEEvPKa
    24 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 9612 bytes smem, 520 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116stripe_rb_kernelILi4ELi4ELb0ELb0ELb1ELb0ELb0ELb0ELb0ELb0ELb0EEEvPKa' for 'sm_90a'
ptxas info    : Used 79 registers, used 1 barriers, 9100 bytes smem, 500 bytes cmem[0]
"""


def test_compiled_cost_reads_the_build_log(monkeypatch):
    k1 = access.compiled_cost("sw_stripe_rb_linear", log=COST_LOG)
    assert k1["entry"] == "sw_stripe_rb_linear"
    assert "stripe_rb_kernelILi8ELi4E" in k1["symbol"]
    assert {k: v for k, v in k1.items() if k not in ("entry", "symbol")} == {
        "registers": 87, "smem_bytes": 9100, "stack_bytes": 0,
        "spill_store_bytes": 0, "spill_load_bytes": 0}
    k5 = access.compiled_cost("sw_stripe_rb_block_affine", log=COST_LOG)
    assert (k5["registers"], k5["smem_bytes"], k5["stack_bytes"],
            k5["spill_store_bytes"], k5["spill_load_bytes"]) == (
        168, 9612, 24, 16, 12)
    # K4 at its (4, 4): ptxas printed no frame line, so none is invented
    k4 = access.compiled_cost("sw_stripe_rb_fill_p_linear", log=COST_LOG)
    assert (k4["registers"], k4["stack_bytes"]) == (79, None)
    # instantiations the log does not hold
    assert access.compiled_cost("sw_stripe_rb_band_linear",
                                log=COST_LOG) is None
    assert access.compiled_cost("sw_pairs_rb_sub", log=COST_LOG) is None
    assert len(access.ptxas_facts(COST_LOG)) == 3
    # a library this process never built: no log, no facts
    monkeypatch.setattr(_cuda.BUILD, "log", "")
    assert access.compiled_cost("sw_stripe_rb_linear") is None
    for bad in ("sw_walk_p", "sw_stripe_score_linear", "sw_stripe_rb_dna"):
        with pytest.raises(ValueError):
            access.compiled_cost(bad, log=COST_LOG)



@pytest.mark.parametrize("entry", RB_ENTRIES)
def test_rb_kind_is_a_launch_rb_shape_takes(entry):
    """Each register-blocked entry's kind, read off its flags, is the
    launch its name says, and one that ``rb_shape`` resolves."""
    kind = sf.rb_kind(entry)
    want = {"sw_stripe_rb": "score", "sw_stripe_rb_fill_p": "fill_p",
            "sw_stripe_rb_block": "block", "sw_stripe_rb_band": "band",
            "sw_stripe_rb_fill_p_band": "fill_p_band",
            "sw_sanitize_rb": "debug",
            "sw_sanitize_packed_rb": "packed_debug",
            "sw_pairs_rb": "pairs", "sw_pairs_rb_band": "pairs_band",
            "sw_window_rb": "window", "sw_packed_rb": "packed"}
    assert kind == want[entry.rsplit("_", 1)[0]]
    mode = entry.rsplit("_", 1)[1]
    T, R, C = sf.rb_shape(1 << 20, mode=mode, kind=kind)
    assert T >= 32 and R >= 1 and C >= 1

# ---- choose_plan ----

EDGE = int(HOST_MAX_CELLS ** 0.5)


@pytest.mark.parametrize("device", [CPU, CUDA], ids=["cpu", "cuda"])
@pytest.mark.parametrize("m, n", [
    (1, 1), (8, 6), (EDGE, EDGE), (EDGE + 1, EDGE), (EDGE, HOST_MAX_CELLS
                                                      // EDGE + 1),
    (4096, 4096), (25632, 25632), (sf.MAX_WIDTH, 8),
    (sf.MAX_WIDTH + 1, 8)])
def test_choose_plan_is_choose_exec_plan(device, m, n):
    assert choose_plan(m, n, device=device) == \
        choose_exec(m, n, device=device).plan
    band = EngineConfig(band=4)
    assert choose_plan(m, n, band, device=device) == \
        choose_exec(m, n, band, device=device).plan


def test_choose_plan_tiers():
    assert choose_plan(64, 64) == "host"
    assert choose_plan(EDGE + 1, EDGE + 1) == "stripe"
    assert choose_plan(64, 64, device=CPU) == "scan"
    assert choose_plan(sf.MAX_WIDTH + 1, 8) == "pipeline"
    assert choose_plan(64, 64, EngineConfig(band=4)) == "stripe"


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CUDA


def _ptxas_log() -> str:
    """ptxas's figures of the register-blocked K1-K4: the build's log, or
    where this process loaded a built library, a build of their two
    sources alone."""
    _cuda.library()
    if _cuda.BUILD.log:
        return _cuda.BUILD.log
    import tempfile
    nvcc = _cuda.find_nvcc()
    out = []
    with tempfile.TemporaryDirectory() as d:
        for src in ("stripe_rb.cu", "stripe_rb_p.cu"):
            path = _cuda.SOURCES[0].parent / src
            proc = subprocess.run([nvcc, *_cuda.NVCC_FLAGS, "-c", "-o",
                                   os.path.join(d, src + ".o"), str(path)],
                                  capture_output=True, text=True,
                                  timeout=600)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            out.append(proc.stdout + proc.stderr)
    return "".join(out)


SCORINGS = ["linear", "dna_affine", "protein"]


def _scoring(name):
    from swtpu_torch import Scoring
    from swtpu_torch.core.substitution import BLOSUM62
    return {"linear": (Scoring(), None),
            "dna_affine": (Scoring(mode="affine"), None),
            "protein": (Scoring(mode="affine", gap_open=-11, gap_extend=-1),
                        BLOSUM62)}[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", SCORINGS)
@pytest.mark.parametrize("side", [512, 4096])
def test_model_agrees_with_the_card(cuda, side, name):
    """The traffic model against the caching allocator and ptxas: the P
    capture's output within 0.8-1.25x of the model's P (the JAX bound),
    each stripe plan's scratch within 2x of the modelled hand-off rows,
    sync and best, its on-chip working set within 2x of ptxas' registers
    x threads plus its shared memory."""
    sc, sub = _scoring(name)
    got = access.validate_model(side, side, sc, cuda, substitution=sub)
    assert set(got) == {"scan", "scan+P", "stripe", "stripe+P"}
    usage = access.ptxas_usage(_ptxas_log())
    for plan in ("scan+P", "stripe+P"):
        rep, meas = got[plan]
        assert 0.8 * rep.p_bytes <= meas.output_bytes <= 1.25 * rep.p_bytes
    for plan in ("stripe", "stripe+P"):
        rep, meas = got[plan]
        assert rep.scratch_bytes / 2 <= meas.temp_bytes \
            <= 2 * rep.scratch_bytes, (plan, rep.scratch_bytes, meas)
        res = access.launched_resident(usage, side, side,
                                       traceback=plan == "stripe+P",
                                       scoring=sc, substitution=sub)
        assert res / 2 <= rep.resident_bytes <= 2 * res, (plan, res)
        assert meas.bytes_per_cell(side * side) < (
            2 if plan == "stripe+P" else 0.05)
    # P capture moves orders of magnitude more than score-only
    assert got["stripe+P"][1].output_bytes > \
        100 * got["stripe"][1].output_bytes
    # each measured call's answer: the kernels' the plain sweep's
    scan = got["scan"][1].result
    want = sf._pack(scan).tolist()
    assert sf._pack(got["scan+P"][1].result).tolist() == want
    for plan in ("stripe", "stripe+P"):
        out = got[plan][1].result
        assert out.best.tolist() == want, plan
        assert torch.equal(out.right_col, scan.right_col), plan
    p_want = sf.diag_to_rowmajor(got["scan+P"][1].result.p_diag, side, side)
    assert torch.equal(got["stripe+P"][1].result.P, p_want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["linear", "affine", "sub_linear_gaps",
                                  "sub_affine_gaps"])
def test_model_smem_is_the_launchers(cuda, mode):
    """The model's dynamic shared memory of a block against the
    launcher's own figure, at every tile of the form and two T."""
    form = mode.split("_")[0]
    affine = mode != "sub_linear_gaps" and form != "linear"
    A = 24 if form == "sub" else 0
    for R, C in sf.RB_FORM_TILES[form]:
        for T in (64, 128):
            want = access.rb_shared_bytes(form, R, C, T, A, affine) - (
                access._STATIC_SMEM + access._EDGE_INTS_PER_COL * C * 4)
            assert access.launch_smem(form, R, C, T, A, affine) == want, \
                (R, C, T)


@pytest.mark.gpu
def test_measured_memory_counts_storages(cuda):
    x = torch.zeros(1000, dtype=torch.int32, device=cuda)
    mm = access.measured_memory(lambda t: (t + 1, t[:10]), x)
    assert mm.argument_bytes == 4000
    assert mm.output_bytes == 4000           # the view shares x's storage
    assert mm.code_bytes == 0


@pytest.mark.gpu
def test_trace_names_the_kernel(cuda, tmp_path):
    import swtpu_torch
    a, b = swtpu_torch.random_pair(4096, 4096, seed=0)
    with profiling.trace(str(tmp_path), device=cuda):
        swtpu_torch.score(a, b, device=cuda)
    assert profiling.trace_kernels(str(tmp_path))[sf.RB_KERNEL] >= 1


@pytest.mark.gpu
def test_block_waits_for_the_card(cuda):
    x = torch.ones(1 << 20, device=cuda)
    y = block((x * 2, [x + 1]))
    assert float(y[0][0]) == 2.0 and float(y[1][0][0]) == 2.0
