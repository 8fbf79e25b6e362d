"""The port's stripe kernels' wrappers against the JAX Pallas stripe kernel.

On the CPU the wrappers run their plain versions; the JAX side runs the
Pallas kernel in interpret mode (T=128, so n > 128 spans several stripes).
The CUDA kernels themselves run only on a card: the ``gpu`` tests hold them
against their plain versions there and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swtpu
from swtpu.core import oracle
from swtpu.core.encode import encode, random_pair
from swtpu.kernels.pallas_fill import (p_stripes_to_rowmajor,
                                       stripe_fill_raw, stripe_score_fn)
from swtpu_torch import Scoring
from swtpu_torch.kernels import stripe_fill as sf


def _two_letter(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, m).astype(np.int8),
            rng.integers(0, 2, n).astype(np.int8))


def _equal_pair(n, seed):
    a = np.random.default_rng(seed).integers(0, 4, n).astype(np.int8)
    return a, a.copy()


CASES = {
    "golden": lambda: (encode(swtpu.BUILTIN_A), encode(swtpu.BUILTIN_B)),
    "one_stripe": lambda: random_pair(60, 100, seed=11),
    "three_stripes_ragged": lambda: random_pair(50, 300, seed=12),
    "n_is_T_plus_1": lambda: random_pair(100, 129, seed=13),
    "m_is_2": lambda: random_pair(2, 140, seed=14),
    "m_gt_n": lambda: random_pair(170, 40, seed=15),
    "two_letter_ties": lambda: _two_letter(90, 260, seed=16),
    "equal_across_stripes": lambda: (np.zeros(40, np.int8),
                                     np.zeros(270, np.int8)),
    "a_equals_b": lambda: _equal_pair(200, seed=20),
}


def _torch(a, b, device="cpu"):
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


@pytest.mark.parametrize("case", list(CASES))
def test_stripe_wrappers_match_pallas(case):
    a, b = CASES[case]()
    m, n = len(a), len(b)
    jx = stripe_fill_raw(a, b, T=128, C=128, return_p=True)
    want = [int(jx.max_score), int(jx.max_i), int(jx.max_j),
            int(jx.last_cell)]
    score = sf.stripe_score(*_torch(a, b))
    fill = sf.stripe_fill(*_torch(a, b))
    assert score.best.tolist() == want
    assert fill.best.tolist() == want
    assert score.P is None
    np.testing.assert_array_equal(score.right_col.numpy(), jx.right_col)
    np.testing.assert_array_equal(fill.right_col.numpy(), jx.right_col)
    np.testing.assert_array_equal(
        fill.P.numpy(), p_stripes_to_rowmajor(np.asarray(jx.p_stripes), n, m))
    # and against the oracle the Pallas kernel is held to
    ref = oracle.fill(a, b)
    assert want == [ref.max_score, *ref.max_ij, int(ref.H[n, m])]


@pytest.mark.parametrize("shape", [(96, 260), (130, 300)])
def test_stripe_score_matches_pallas_device_reduce(shape):
    m, n = shape
    a, b = random_pair(m, n, seed=m + n)
    fn = stripe_score_fn(m, n, T=128, C=128, want_last=True)
    want = [int(v) for v in fn(jnp.asarray(a), jnp.asarray(b))]
    assert sf.stripe_score(*_torch(a, b)).best.tolist() == want


def test_cpu_tensors_run_the_plain_versions():
    a, b = random_pair(30, 40, seed=17)
    sf.reset_counts()
    sf.stripe_score(*_torch(a, b))
    sf.stripe_fill(*_torch(a, b))
    assert sf.plain_calls == {"stripe_score_plain": 1,
                              "stripe_fill_plain": 1,
                              "stripe_block_plain": 0, "walk_p_plain": 0}
    assert sf.launches == dict.fromkeys(sf.launches, 0)
    assert {sf.SCORE_KERNEL, sf.FILL_P_KERNEL, sf.SCORE_AFFINE_KERNEL,
            sf.FILL_P_AFFINE_KERNEL, sf.SCORE_SUB_KERNEL,
            sf.FILL_P_SUB_KERNEL} < set(sf.launches)
    sf.reset_counts()
    assert sf.plain_calls == {"stripe_score_plain": 0,
                              "stripe_fill_plain": 0,
                              "stripe_block_plain": 0, "walk_p_plain": 0}


def test_stripe_reduce_takes_first_stripe_of_the_max():
    best = torch.tensor([[5, 3, 9, 0], [7, 200, 4, 0], [7, 300, 1, 0],
                         [0, 0, 0, 0]], dtype=torch.int32)
    right = torch.arange(11, dtype=torch.int32)
    assert sf._reduce(best, right, 10).tolist() == [7, 200, 4, 10]
    zero = torch.zeros((3, 4), dtype=torch.int32)
    assert sf._reduce(zero, right, 4).tolist() == [0, 0, 0, 4]


@pytest.mark.parametrize("args, err", [
    ((np.zeros(5, np.int32), np.zeros(6, np.int8)), TypeError),
    # a width of 1 is taken: the kernels mask their edges, and the JAX
    # package's m >= 2 only picks the plan (stripe_fill_supported)
    ((np.zeros(1, np.int8), np.zeros(6, np.int8)), None),
    ((np.zeros(0, np.int8), np.zeros(6, np.int8)), ValueError),
    ((np.zeros(5, np.int8), np.zeros(0, np.int8)), ValueError),
    ((np.zeros((2, 5), np.int8), np.zeros(6, np.int8)), ValueError),
], ids=["dtype", "m_is_1", "m_is_0", "n_is_0", "2d"])
def test_wrappers_reject_bad_inputs(args, err):
    a, b = (torch.from_numpy(x) for x in args)
    for fn in (sf.stripe_score, sf.stripe_fill):
        if err is None:
            # one column of matches: 3 in every row, first at (1, 1)
            assert fn(a, b).best.tolist() == [3, 1, 1, 3]
            assert not sf.stripe_fill_supported(1, 6, False)
            continue
        with pytest.raises(err):
            fn(a, b)


@pytest.mark.parametrize("scoring", [
    Scoring(mismatch=0), Scoring(gap=0), Scoring(mode="affine", gap_open=0),
], ids=["mismatch_0", "gap_0", "affine"])
def test_gate_rejects_scorings_the_kernel_does_not_take(scoring):
    assert not sf.stripe_fill_supported(50, 50, True, scoring)
    a, b = _torch(*random_pair(50, 50, seed=18))
    with pytest.raises(ValueError, match="stripe kernel"):
        sf.stripe_score(a, b, scoring)


def test_stripe_rows_are_validated():
    assert sf._stripe_rows(9, None) == 32
    assert sf._stripe_rows(5000, None) == sf.DEFAULT_STRIPE_ROWS
    assert sf._stripe_rows(5000, 1024) == 1024
    for bad in (16, 100, 2048):
        with pytest.raises(ValueError):
            sf._stripe_rows(5000, bad)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, T", [(60, 100, None), (300, 9 * 256 + 7, 256),
                                     (2, 700, 64), (500, 90, 32)])
def test_kernels_match_plain_on_card(cuda, m, n, T):
    a, b = _torch(*random_pair(m, n, seed=m * 7 + n), device=cuda)
    plain_s = sf.stripe_score_plain(a, b)
    plain_f = sf.stripe_fill_plain(a, b)
    for _ in range(3):          # ordering races show as run-to-run changes
        got_s = sf.stripe_score(a, b, T=T)
        got_f = sf.stripe_fill(a, b, T=T)
        torch.cuda.synchronize()
        assert torch.equal(got_s.best, plain_s.best)
        assert torch.equal(got_s.right_col, plain_s.right_col)
        assert torch.equal(got_f.best, plain_s.best)
        assert torch.equal(got_f.P, plain_f.P)


@pytest.mark.gpu
def test_more_stripes_than_resident_blocks(cuda):
    # 4401 stripes of 32 rows: more blocks than an H100 holds at once
    # (132 SMs x 32 blocks), so late blocks start only as early ones finish;
    # the stripe ticket keeps every wait on a resident block
    m, n = 48, 32 * 4400 + 5
    a, b = random_pair(m, n, seed=19)
    ref = oracle.fill(a, b)
    want = [ref.max_score, *ref.max_ij, int(ref.H[n, m])]
    got_s = sf.stripe_score(*_torch(a, b, device=cuda), T=32)
    got_f = sf.stripe_fill(*_torch(a, b, device=cuda), T=32)
    assert got_s.best.tolist() == want
    assert got_f.best.tolist() == want
    np.testing.assert_array_equal(got_s.right_col.cpu().numpy(), ref.H[:, m])
    np.testing.assert_array_equal(got_f.P.cpu().numpy(), ref.P)
