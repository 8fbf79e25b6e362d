"""The port's PyTorch scan_fill against the JAX scan_fill and the numpy
oracle, on the CPU. The DP is integer: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swtpu
from swtpu.core import oracle
from swtpu.core.encode import encode, random_pair
from swtpu.kernels.scan_fill import scan_fill as jax_scan_fill
from swtpu_torch import Scoring
from swtpu_torch.kernels.scan_fill import diag_to_rowmajor, scan_fill


def _two_letter(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, m).astype(np.int8),
            rng.integers(0, 2, n).astype(np.int8))


def _runs():
    # runs of one letter: many equal maxima along each row and column
    a = np.repeat(np.array([0, 1, 0, 2], np.int8), [9, 3, 12, 5])
    return a, a[3:].copy()


CASES = {
    "golden": lambda: (encode(swtpu.BUILTIN_A), encode(swtpu.BUILTIN_B)),
    "single_column": lambda: random_pair(1, 37, seed=1),
    "single_row": lambda: random_pair(41, 1, seed=2),
    "m_lt_n": lambda: random_pair(30, 77, seed=3),
    "m_gt_n": lambda: random_pair(90, 25, seed=4),
    "square": lambda: random_pair(64, 64, seed=5),
    "two_letter_ties": lambda: _two_letter(70, 55, seed=6),
    "equal_sequences": lambda: (np.zeros(40, np.int8), np.zeros(40, np.int8)),
    "letter_runs": _runs,
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_fill_matches_jax_and_oracle(case):
    a, b = CASES[case]()
    m, n = len(a), len(b)
    ref = oracle.fill(a, b)
    jx = jax_scan_fill(jnp.asarray(a), jnp.asarray(b), return_p=True,
                       return_h=True)
    pt = scan_fill(torch.from_numpy(a), torch.from_numpy(b), return_p=True,
                   return_h=True)

    for name in ("max_score", "max_i", "max_j", "last_cell"):
        assert int(getattr(pt, name)) == int(getattr(jx, name)), name
    assert (int(pt.max_score), int(pt.max_i), int(pt.max_j)) == \
        (ref.max_score, *ref.max_ij)
    assert int(pt.last_cell) == int(ref.H[n, m])
    for name in ("right_col", "bottom_row", "p_diag", "h_diag"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jx, name)), name)
    np.testing.assert_array_equal(pt.right_col.numpy(), ref.H[:, m])
    np.testing.assert_array_equal(pt.bottom_row.numpy(), ref.H[n])
    np.testing.assert_array_equal(
        diag_to_rowmajor(pt.p_diag, n, m).numpy(), ref.P)
    np.testing.assert_array_equal(
        diag_to_rowmajor(pt.h_diag, n, m).numpy(), ref.H)


def test_scan_fill_without_captures_returns_none():
    a, b = random_pair(20, 30, seed=7)
    out = scan_fill(torch.from_numpy(a), torch.from_numpy(b))
    assert out.p_diag is None and out.h_diag is None
    assert int(out.max_score) == oracle.fill(a, b).max_score


@pytest.mark.parametrize("kwargs", [
    # modes that raised before boundary injection, band and NW were ported;
    # each now equals the JAX scan
    {"scoring": Scoring(mode="affine"),
     "top_f": torch.zeros(21, dtype=torch.int32)},
    {"band": 4},
    {"top_row": torch.zeros(21, dtype=torch.int32)},
    {"left_col": torch.zeros(31, dtype=torch.int32)},
    {"local": False},
    {"scoring": Scoring(mode="affine"),
     "sub_table": torch.zeros((7, 7), dtype=torch.int32),
     "left_e": torch.zeros(31, dtype=torch.int32)},
], ids=["affine", "band", "top_row", "left_col", "global", "sub_table"])
def test_unported_modes_raise(kwargs):
    a, b = random_pair(20, 30, seed=8)
    pt = scan_fill(torch.from_numpy(a), torch.from_numpy(b), return_p=True,
                   return_h=True, **kwargs)
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kwargs.items()}
    if "scoring" in kwargs:
        jkw["scoring"] = swtpu.Scoring(mode="affine")
    jx = jax_scan_fill(jnp.asarray(a), jnp.asarray(b), return_p=True,
                       return_h=True, **jkw)
    for name in ("max_score", "max_i", "max_j", "last_cell", "bottom_row",
                 "right_col", "p_diag", "h_diag", "bottom_f", "right_e"):
        got, want = getattr(pt, name), getattr(jx, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          name)
