"""The port's native host tiers (``swtpu_torch.runtime_native``) against the
JAX package's (``swtpu.runtime_native``, built from ``csrc/`` by its own
make) and against the port's numpy oracle, on the CPU.

The port builds its own copy, ``swtpu_torch/csrc/swtpu_native.cpp``, with
g++ into ``swtpu_torch/build/``. Inputs are made from seeds with numpy and
handed to both packages. Tolerance: exact equality, of H, P, the end cell,
the score, the last cell, the walked path, and the SIMD fills' positions.
"""

import time

import numpy as np
import pytest

import swtpu
from swtpu import runtime_native as jrn
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu_torch import Scoring
from swtpu_torch import runtime_native as rn
from swtpu_torch.core import oracle
from swtpu_torch.core.substitution import BLOSUM62, embed_sentinels
from swtpu_torch.kernels import _native

SCORINGS = {
    # name: (port scoring, table or None, letters)
    "linear": (Scoring(), None, 4),
    "dna_affine": (Scoring(mode="affine"), None, 4),
    "protein": (Scoring(mode="affine", gap_open=-11, gap_extend=-1),
                BLOSUM62, 21),
    "protein_linear": (Scoring(gap=-6), BLOSUM62, 21),
}


def _jax(sc: Scoring):
    return swtpu.Scoring(mode=sc.mode, match=sc.match, mismatch=sc.mismatch,
                         gap=sc.gap, gap_open=sc.gap_open,
                         gap_extend=sc.gap_extend)


def _jsub(sub):
    return None if sub is None else np.asarray(J_BLOSUM62)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's library, built by its make; a build that another
    test process is writing at this moment is waited for."""
    for _ in range(5):
        if jrn.available():
            return jrn
        jrn._tried = False
        time.sleep(2)
    pytest.fail("the JAX package's native library did not build")


def _oracle(a, b, sc: Scoring, sub):
    """The numpy oracle; with a table, on codes + 3 against the table with
    the sentinel rows and columns (``embed_sentinels``), so that a -3..-1
    code scores as the fills score it."""
    if sub is None:
        return oracle.fill(a, b, sc)
    return oracle.fill(a.astype(np.int16) + 3, b.astype(np.int16) + 3, sc,
                       embed_sentinels(sub))


def _pair(m: int, n: int, letters: int, seed: int, sentinels: bool = False):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, letters, m).astype(np.int8)
    b = rng.integers(0, letters, n).astype(np.int8)
    if m > 10 and n > 10:
        b[n // 3: n // 3 + min(m, n) // 3] = a[:min(m, n) // 3]
    if sentinels:
        a[rng.integers(0, m, max(1, m // 10))] = -1
        b[rng.integers(0, n, max(1, n // 10))] = rng.integers(-3, 0)
    return a, b


SHAPES = [(1, 1), (1, 37), (37, 1), (40, 90), (150, 60), (97, 97)]


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("m, n", SHAPES)
def test_fill_matches_jax_and_oracle(jax_native, name, m, n):
    sc, sub, letters = SCORINGS[name]
    a, b = _pair(m, n, letters, seed=m * 7 + n)
    got = rn.fill(a, b, sc, sub)
    want = jax_native.fill(a, b, _jax(sc), _jsub(sub))
    ref = oracle.fill(a, b, sc, sub)
    for other in (want, ref):
        np.testing.assert_array_equal(got.H, other.H)
        np.testing.assert_array_equal(got.P, other.P)
        assert (got.max_pos, got.max_score) == (other.max_pos,
                                               other.max_score)


@pytest.mark.parametrize("name", ["linear", "dna_affine"])
def test_fill_sentinels_compare_raw(jax_native, name):
    """-1 meets -1 as a match, -1 meets -2 or -3 as a mismatch, as the
    oracle scores them."""
    sc = SCORINGS[name][0]
    a = np.array([-1, 0, 1, -1, -3, 2, 3, -2], np.int8)
    b = np.array([-1, 0, -2, -1, -3, 2, 3, -1, -1], np.int8)
    got = rn.fill(a, b, sc)
    want = jax_native.fill(a, b, _jax(sc))
    ref = oracle.fill(a, b, sc)
    for other in (want, ref):
        np.testing.assert_array_equal(got.H, other.H)
        np.testing.assert_array_equal(got.P, other.P)
        assert got.max_pos == other.max_pos


def test_fill_with_a_table_refuses_sentinels():
    a, b = _pair(30, 30, 21, seed=1)
    a[3] = -1
    with pytest.raises(ValueError, match=r"codes in \[0, 21\)"):
        rn.fill(a, b, SCORINGS["protein"][0], BLOSUM62)
    with pytest.raises(ValueError, match="square"):
        rn.fill(a, b, Scoring(), np.zeros((3, 4), np.int32))


@pytest.mark.parametrize("m, n, seed", [(50, 40, 3), (1, 30, 4),
                                        (200, 150, 5)])
def test_traceback_matches(jax_native, m, n, seed):
    a, b = _pair(m, n, 4, seed)
    f = oracle.fill(a, b)
    got = rn.traceback(f.P, f.max_pos)
    assert got == oracle.backtrack(f.P, f.max_pos)
    assert got == jax_native.traceback(f.P, f.max_pos)


def test_traceback_refuses_a_malformed_p():
    P = np.full((4, 4), 3, np.int8)          # DIAG off the matrix's edge
    with pytest.raises(ValueError, match="malformed"):
        rn.traceback(P, 5)


SIMD_SHAPES = [(1, 1), (5, 300), (300, 5), (64, 64), (127, 257), (600, 450),
               (1056, 1056)]


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("m, n", SIMD_SHAPES)
def test_score_simd_pos_matches(jax_native, name, m, n):
    sc, sub, letters = SCORINGS[name]
    a, b = _pair(m, n, letters, seed=m + 3 * n, sentinels=sub is None)
    got = rn.score_simd_pos(a, b, sc, sub)
    assert got == jax_native.score_simd_pos(a, b, _jax(sc), _jsub(sub))
    ref = _oracle(a, b, sc, sub)
    assert got == (ref.max_score, *ref.max_ij, int(ref.H[n, m]))
    assert rn.score_simd(a, b, sc, sub) == ref.max_score == \
        jax_native.score_simd(a, b, _jax(sc), _jsub(sub))


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("B, m, n", [(1, 30, 40), (5, 64, 100), (9, 200, 7)])
def test_score_simd_batch_matches(jax_native, name, B, m, n):
    sc, sub, letters = SCORINGS[name]
    pairs = [_pair(m, n, letters, seed=100 * B + k) for k in range(B)]
    aa = np.stack([p[0] for p in pairs])
    bb = np.stack([p[1] for p in pairs])
    got = rn.score_simd_batch(aa, bb, sc, sub)
    want = jax_native.score_simd_batch(aa, bb, _jax(sc), _jsub(sub))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    for k, (a, b) in enumerate(pairs):
        ref = _oracle(a, b, sc, sub)
        assert (got[0][k], got[1][k], got[2][k]) == (ref.max_score,
                                                     *ref.max_ij)


# B of 1-3 takes the striped fill a read, B >= 4 the inter-sequence groups
@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("B, qlen, W", [(3, 40, 300), (4, 40, 300),
                                        (37, 152, 700), (5, 20, 1)])
def test_score_simd_window_matches(jax_native, name, B, qlen, W):
    sc, sub, letters = SCORINGS[name]
    rng = np.random.default_rng(B * qlen + W)
    window = rng.integers(0, letters, W).astype(np.int8)
    reads = rng.integers(0, letters, (B, qlen)).astype(np.int8)
    for r in range(B):
        cut = int(rng.integers(1, qlen + 1))
        reads[r, cut:] = -3                 # padding after the read's end
        if W > qlen:
            off = int(rng.integers(0, W - cut + 1))
            reads[r, :cut] = window[off:off + cut]
    if sub is None:
        reads[0, 0] = -1                    # an unknown base
    got = rn.score_simd_window(window, reads, sc, sub)
    want = jax_native.score_simd_window(window, reads, _jax(sc), _jsub(sub))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    for r in range(B):
        ref = _oracle(window, reads[r], sc, sub)
        assert (got[0][r], got[1][r], got[2][r]) == (ref.max_score,
                                                     *ref.max_ij)


# (m, n, scoring kwargs, table) at the gates' edges
GATES = [
    (6400, 6400, dict(match=5), None),          # 5 * 6400 = 32000: in
    (6401, 6500, dict(match=5), None),          # 32005: out
    (10666, 20000, {}, None),                   # 3 * 10666 = 31998: in
    (20000, 10667, {}, None),                   # 32001: out
    (2909, 2909, dict(mode="affine", gap_open=-11, gap_extend=-1),
     "blosum"),                                 # 11 * 2909 = 31999: in
    (2910, 3000, dict(mode="affine", gap_open=-11, gap_extend=-1),
     "blosum"),                                 # 32010: out
    (100, 100, dict(mode="affine", gap_open=-4, gap_extend=-4), None),
    (100, 100, dict(mode="affine", gap_open=-1, gap_extend=-6), None),
    (100, 100, dict(mode="affine", gap_open=-6, gap_extend=-1), None),
    (100, 100, dict(gap=0), None),
    (100, 100, dict(gap=2), None),
    (100, 100, dict(mode="affine", gap_open=-3, gap_extend=0), None),
    (100, 100, dict(mismatch=-32001), None),
    (0, 10, {}, None),
    (32767, 5, {}, None),
    (32768, 5, {}, None),
    (5, 32768, {}, None),
]


@pytest.mark.parametrize("m, n, kw, table", GATES)
def test_gates_match_jax(jax_native, m, n, kw, table):
    sc = Scoring(**kw)
    sub = BLOSUM62 if table else None
    got = rn.simd_shape_ok(m, n, sc, sub)
    assert got == (jax_native.simd_shape_ok(m, n, _jax(sc), _jsub(sub))
                   and m <= 32767 and n <= 32767)
    assert rn.simd_eligible(m, n, sc, sub) == got
    if not got:
        assert rn.simd_reject_reason(m, n, sc, sub) == \
            jax_native.simd_reject_reason(m, n, _jax(sc), _jsub(sub))


def test_gate_edges_by_value():
    assert rn.simd_shape_ok(6400, 6400, Scoring(match=5))
    assert not rn.simd_shape_ok(6401, 6401, Scoring(match=5))
    assert rn.simd_shape_ok(10, 10, Scoring(mode="affine", gap_open=-4,
                                            gap_extend=-4))   # ge == go
    assert not rn.simd_shape_ok(10, 10, Scoring(mode="affine", gap_open=-1,
                                                gap_extend=-2))  # ge < go
    assert not rn.simd_shape_ok(10, 10, Scoring(gap=0))
    assert "lazy-F" in rn.simd_reject_reason(10, 10, Scoring(
        mode="affine", gap_open=-1, gap_extend=-2))
    assert "int16 saturation" in rn.simd_reject_reason(6401, 6401,
                                                       Scoring(match=5))
    assert "must be negative" in rn.simd_reject_reason(10, 10,
                                                       Scoring(gap=0))
    assert "int16 lanes" in rn.simd_reject_reason(32768, 5)


def test_simd_fills_refuse_what_they_cannot_take(jax_native):
    a, b = _pair(40, 40, 4, seed=9)
    bad = Scoring(mode="affine", gap_open=-1, gap_extend=-6)
    for sc, sub in ((bad, None), (Scoring(gap=0), None)):
        assert rn.score_simd(a, b, sc, sub) is None
        assert rn.score_simd_pos(a, b, sc, sub) is None
        assert jax_native.score_simd_pos(a, b, _jax(sc), None) is None
    # a-codes (the window's) outside [-3, A) with a table
    pa, pb = _pair(40, 40, 21, seed=10)
    pa[0] = 21
    sc = SCORINGS["protein"][0]
    assert rn.score_simd_pos(pa, pb, sc, BLOSUM62) is None
    assert rn.score_simd_window(pa, pb[None], sc, BLOSUM62) is None
    assert rn.score_simd_batch(pa[None], pb[None], sc, BLOSUM62) is None
    assert jax_native.score_simd_pos(pa, pb, _jax(sc), _jsub(1)) is None
    assert "codes outside" in rn.simd_reject_reason(40, 40, sc, BLOSUM62)
    # empty operands: score 0, and no position
    assert rn.score_simd(a[:0], b) == 0
    assert rn.score_simd_pos(a[:0], b) is None


def test_measured_rate_is_positive():
    rate = rn.measured_simd_gcups()
    assert rn.simd_supported() and rate > 0
    assert rn.measured_simd_gcups() == rate        # once a process


def test_library_is_named_by_the_host_cpu(monkeypatch):
    flags = _native.CXX_FLAGS
    here = _native._digest(flags)
    monkeypatch.setattr(_native, "_cpuinfo", lambda: [
        ("model name", "another CPU"), ("flags", "fpu")])
    assert _native._digest(flags) != here
    assert _native._digest(flags + ("-fopenmp",)) != _native._digest(flags)
    assert _native._digest(flags, "/usr/bin/g++") != _native._digest(
        flags, "/opt/gcc/bin/g++")
    assert _native.BUILD.path is None or \
        _native.BUILD.path.name.startswith("libswtpu_native_")


def test_openmp_probe_picks_a_compiler_that_has_it(monkeypatch, recwarn):
    """$CXX first; where its -fopenmp probe fails and g++'s passes (a
    wrapper without the OpenMP runtime's spec file), g++ builds with
    OpenMP, and nothing warns."""
    monkeypatch.setattr(_native, "compilers",
                        lambda: ["/opt/wrap/g++", "/usr/bin/g++"])
    monkeypatch.setattr(_native, "_openmp", lambda cxx: (
        "g++: fatal error: cannot read spec file 'libgomp.spec'"
        if cxx.startswith("/opt") else None))
    assert _native.choose_compiler() == (
        "/usr/bin/g++", _native.CXX_FLAGS + ("-fopenmp",))
    monkeypatch.setattr(_native, "_openmp", lambda cxx: None)
    assert _native.choose_compiler()[0] == "/opt/wrap/g++"
    assert not [w for w in recwarn if w.category is RuntimeWarning]


def test_no_openmp_builds_on_one_core_and_warns(monkeypatch):
    monkeypatch.setattr(_native, "BUILD", _native.BuildInfo())
    monkeypatch.setattr(_native, "compilers",
                        lambda: ["/opt/wrap/g++", "/usr/bin/g++"])
    monkeypatch.setattr(_native, "_openmp", lambda cxx: f"{cxx} has none")
    with pytest.warns(RuntimeWarning, match="one core"):
        got = _native.choose_compiler()
    assert got == ("/opt/wrap/g++", _native.CXX_FLAGS)
    assert _native.BUILD.openmp_log.splitlines() == [
        "/opt/wrap/g++: /opt/wrap/g++ has none",
        "/usr/bin/g++: /usr/bin/g++ has none"]


def test_omp_threads():
    threads = rn.omp_threads()
    assert threads >= 1
    if "-fopenmp" not in _native.BUILD.flags:
        assert threads == 1


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "swtpu_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ build"):
        _native.library()
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _native.library()
    assert not (tmp_path / "build").exists()
    assert rn.available() is False
