"""swtpu_torch.align / score against swtpu.align / score on the CPU.

Both packages are configured from the same numpy-held state, carried into
the port with ``swtpu_torch.convert``; every comparison is exact."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import swtpu
import swtpu_torch
from swtpu.core.encode import random_pair
from swtpu_torch.convert import (TPU_ONLY_FIELDS, config_from_jax,
                                 scoring_from_jax)
from swtpu_torch.core.config import HOST_MAX_CELLS, HOST_SIMD_MAX_CELLS

REPO = Path(__file__).resolve().parent.parent

# the run state as plain numpy values, fed to both packages
STATE = {"match": np.int64(3), "mismatch": np.int64(-3), "gap": np.int32(-2)}


def _pair_of_configs(**cfg):
    jax_scoring = swtpu.Scoring(**{k: int(v) for k, v in STATE.items()})
    jax_config = swtpu.EngineConfig(**cfg)
    return (jax_scoring, jax_config,
            scoring_from_jax(STATE), config_from_jax(jax_config))


def _fields(r):
    return (r.max_score, r.max_i, r.max_j, r.last_cell, r.max_pos,
            r.aligned_a, r.aligned_b, r.path)


def test_golden():
    r = swtpu_torch.align(swtpu_torch.BUILTIN_A, swtpu_torch.BUILTIN_B,
                          device="cpu")
    assert (r.max_score, r.max_pos, r.last_cell) == (13, 69, 7)
    assert (r.aligned_a, r.aligned_b) == ("GTT-AC", "GTTGAC")
    j = swtpu.align(swtpu.BUILTIN_A, swtpu.BUILTIN_B)
    assert _fields(r) == _fields(j)


@pytest.mark.parametrize("plan", [None, "scan", "stripe"])
@pytest.mark.parametrize("m, n, seed", [(40, 90, 21), (150, 60, 22),
                                        (200, 200, 23)])
def test_align_traceback_matches_jax(plan, m, n, seed):
    a, b = random_pair(m, n, seed=seed)
    js, jc, ps, pc = _pair_of_configs()
    want = swtpu.align(a, b, js, jc)
    got = swtpu_torch.align(a, b, ps, pc, plan=plan, device="cpu")
    assert _fields(got) == _fields(want)
    assert got.aligned_a is not None and len(got.path) > 0


@pytest.mark.parametrize("plan", ["scan", "stripe"])
def test_align_score_only_matches_jax(plan):
    a, b = random_pair(120, 170, seed=24)
    js, jc, ps, pc = _pair_of_configs(traceback=False)
    want = swtpu.align(a, b, js, jc)
    got = swtpu_torch.align(a, b, ps, pc, plan=plan, device="cpu")
    assert _fields(got) == _fields(want)
    assert got.aligned_a is None and got.path is None


@pytest.mark.parametrize("m, n", [(300, 40), (40, 300)])
def test_score_thin_pairs_match_jax(m, n):
    # m > 2n takes the transposed route in both packages
    a, b = random_pair(m, n, seed=25)
    js, jc, ps, pc = _pair_of_configs()
    want = swtpu.score(a, b, js, jc)
    assert swtpu_torch.score(a, b, ps, pc, device="cpu") == want
    assert swtpu_torch.score(a, b, ps, pc, plan="stripe",
                             device="cpu") == want


@pytest.mark.parametrize("a, b", [("", "ACGT"), ("ACGT", ""), ("", "")])
@pytest.mark.parametrize("matrices", [False, True])
def test_empty_inputs_match_jax(a, b, matrices):
    want = swtpu.align(a, b, return_matrices=matrices)
    got = swtpu_torch.align(a, b, return_matrices=matrices, device="cpu")
    assert _fields(got) == _fields(want)
    if matrices:
        np.testing.assert_array_equal(got.H, want.H)
        np.testing.assert_array_equal(got.P, want.P)
    assert swtpu_torch.score(a, b, device="cpu") == swtpu.score(a, b) == 0


@pytest.mark.parametrize("plan", [None, "stripe"])
def test_return_matrices_matches_jax(plan):
    a, b = random_pair(70, 50, seed=26)
    want = swtpu.align(a, b, return_matrices=True)
    got = swtpu_torch.align(a, b, return_matrices=True, plan=plan,
                            device="cpu")
    assert _fields(got) == _fields(want)
    np.testing.assert_array_equal(got.H, want.H)
    np.testing.assert_array_equal(got.P, want.P)


def test_traceback_above_full_p_cap_raises():
    # above the cap the lean route (locate + windowed refill) runs, as in
    # the JAX package (whose CPU host tier, which answers before the lean
    # route there, plan='scan' skips): the same score, end cell and
    # strings, no path
    a, b = random_pair(64, 64, seed=27)
    js, jc, ps, pc = _pair_of_configs(full_p_max_cells=64 * 64 - 1)
    want = swtpu.align(a, b, js, jc, plan="scan")
    got = swtpu_torch.align(a, b, ps, pc, device="cpu")
    assert _fields(got) == _fields(want)
    assert got.path is None and got.aligned_a
    # at the cap the full-P route runs
    _, _, ps, pc = _pair_of_configs(full_p_max_cells=64 * 64)
    assert swtpu_torch.align(a, b, ps, pc, device="cpu").path


def test_convert_reads_dataclasses_and_mappings():
    jc = swtpu.EngineConfig(full_p_max_cells=1 << 20, stripe_rows=512,
                            traceback=False)
    pc = config_from_jax(jc)
    assert pc == swtpu_torch.EngineConfig(full_p_max_cells=1 << 20,
                                          stripe_rows=512, traceback=False,
                                          host_max_cells=jc.host_max_cells,
                                          host_simd_max_cells=None)
    assert not hasattr(pc, "tpu_full_p_fetch_max_cells")
    assert TPU_ONLY_FIELDS == {"tpu_full_p_fetch_max_cells"}
    # every other field of the JAX config has a counterpart with its
    # default, but the host tiers' caps: the port's defaults are the
    # crossovers measured on a card machine (core.config.HOST_MAX_CELLS,
    # HOST_SIMD_MAX_CELLS), and the JAX package's None, "derive the SIMD
    # crossover", carries over as the measured one
    carried = config_from_jax(swtpu.EngineConfig())
    assert carried == dataclasses.replace(
        swtpu_torch.EngineConfig(),
        host_max_cells=swtpu.EngineConfig().host_max_cells,
        host_simd_max_cells=None)
    assert swtpu_torch.EngineConfig().host_max_cells == HOST_MAX_CELLS
    assert carried.simd_cells_cap() == HOST_SIMD_MAX_CELLS == \
        swtpu_torch.EngineConfig().simd_cells_cap()
    assert scoring_from_jax(swtpu.Scoring(mode="affine", gap_open=-5)) == \
        swtpu_torch.Scoring(mode="affine", gap_open=-5)
    s = scoring_from_jax(STATE)
    assert (s.match, s.mismatch, s.gap) == (3, -3, -2)
    assert type(s.match) is int


def test_convert_rejects_unknown_fields():
    with pytest.raises(ValueError, match="no field"):
        scoring_from_jax({"match": 3, "gap_penalty": -2})
    with pytest.raises(TypeError):
        config_from_jax([("match", 3)])


def test_cli_builtin_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "swtpu_torch", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "Verifying correctness using builtin data = 1" in proc.stdout
