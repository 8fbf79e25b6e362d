"""The register-blocked single-pair stripe (K1 on the card) against the JAX
package, on the CPU.

The CUDA kernel ``stripe_rb_kernel`` (``swtpu_torch/csrc/stripe_rb.cu``)
runs only on a card. Here a pure-Python model of its schedule walks the
stripes in ticket order and, within a stripe, the threads, their R rows,
the C columns of a step and the steps exactly as the kernel indexes them:
thread k owns rows s*T*R + k*R + 1 .. + R and visits the tile of columns
(t - k)*C + 1 .. + C at step t; UP comes from thread k - 1 of the step
before (a shuffle in a warp, the last lane's shared slot across warps,
the boundary chunk for thread 0); warp 0 stages the query ring and the
boundary row by chunks of 32 columns, waiting only for columns the
stripe above publishes; the last warp stores its row by chunks; the
block takes the smallest row holding its max and ``stripe_fill._reduce``
the first stripe holding the global max. The model's answer and right
column must equal the port's plain version ``stripe_score_plain``, the
JAX package's ``stripe_score_fn`` (its Pallas kernel in interpret mode)
and its numpy oracle. Tolerance: exact equality (integer DP). The ``gpu``
tests hold the kernel against its plain version on a card and skip
elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.core import oracle
from swtpu.core.encode import random_pair
from swtpu.kernels.pallas_fill import stripe_score_fn
import swtpu_torch
from swtpu_torch import Scoring
from swtpu_torch.kernels import stripe_fill as sf

KPUBLISH, KAHEAD, KRING = 32, 64, 8192     # the kernel's constants
LINEAR = Scoring()


def rb_model(a: np.ndarray, b: np.ndarray, sc: Scoring, T: int, R: int,
             C: int) -> tuple:
    """The kernel's schedule in Python: ((4,) best, (n+1,) right) as the
    wrapper returns them."""
    m, n = len(a), len(b)
    k_steps = KPUBLISH // C
    S = -(-n // (T * R))
    bnd = {}                      # (stripe, column): H of its last row
    released = [set() for _ in range(S)]
    right = [0] * (n + 1)
    stripe_best = []
    for s in range(S):
        kt = (min(T * R, n - s * T * R) + R - 1) // R
        steps = -(-m // C) + kt - 1
        first = [s * T * R + k * R for k in range(T)]
        code = [[int(b[first[k] + r]) & 0xff if first[k] + r < n else 0x100
                 for r in range(R)] for k in range(T)]
        publish = (s + 1) * T * R < n
        ring = {c: c for c in range(min(KAHEAD, m))}   # slot -> column held
        a_next = [KAHEAD + x for x in range(32)]       # warp 0's register

        def fetch(lo):
            """A chunk from column lo, after waiting for the progress of
            the stripe above to reach its end: a column it releases."""
            want = min(lo + KPUBLISH - 1, m)
            assert want % KPUBLISH == 0 or want == m
            assert want in released[s - 1]
            return [bnd[s - 1, lo + x] if lo + x <= m else 0
                    for x in range(32)]

        cur = nxt = [0] * 32
        if s > 0:
            cur = fetch(1)
            if m > KPUBLISH:
                nxt = fetch(KPUBLISH + 1)
        H = [[0] * R for _ in range(T)]
        best = [[0] * R for _ in range(T)]
        best_j = [[0] * R for _ in range(T)]
        Bv = [[0] * C for _ in range(T)]
        u_last = [0] * T
        s_edge = [[[0] * C for _ in range(T // 32)] for _ in range(2)]
        s_bnd = [[0] * 32, [0] * 32]
        s_pub = [0] * 32
        flushed = 0
        for t in range(steps):
            if t % k_steps == 0:              # warp 0: thread 0 starts a chunk
                c0 = t * C
                for x in range(32):
                    col = c0 + KAHEAD + x
                    assert a_next[x] == col
                    if col < m:
                        ring[col % KRING] = col
                    a_next[x] = col + KPUBLISH
                if s > 0:
                    if t > 0:
                        cur = nxt
                        if c0 + KPUBLISH + 1 <= m:
                            nxt = fetch(c0 + KPUBLISH + 1)
                    s_bnd[(t // k_steps) & 1] = list(cur)
            U = []
            for k in range(T):
                lane, warp = k % 32, k // 32
                if lane:
                    U.append(list(Bv[k - 1]))      # the shuffle
                elif k:
                    U.append(list(s_edge[(t + 1) & 1][warp - 1]))
                elif s:
                    U.append([s_bnd[(t // k_steps) & 1][(t * C + c) % 32]
                              for c in range(C)])
                else:
                    U.append([0] * C)              # the zero row
            for k in range(T):
                q = t - k
                j0 = q * C + 1
                if not (k < kt and q >= 0 and j0 <= m):
                    continue
                nc = min(C, m - j0 + 1)
                for c in range(nc):
                    col = q * C + c
                    assert ring[col % KRING] == col    # staged, not evicted
                    aj = int(a[col]) & 0xff
                    diag = u_last[k] if c == 0 else U[k][c - 1]
                    up = U[k][c]
                    for r in range(R):
                        left = H[k][r]
                        sub = sc.match if aj == code[k][r] else sc.mismatch
                        h = max(diag + sub, left + sc.gap, up + sc.gap, 0)
                        if h > best[k][r]:
                            best[k][r], best_j[k][r] = h, j0 + c
                        diag, up, H[k][r] = left, h, h
                    Bv[k][c] = H[k][R - 1]
                if j0 + C - 1 >= m:               # the tile holding column m
                    for r in range(R):
                        if first[k] + r < n:
                            right[first[k] + r + 1] = H[k][r]
                if publish and k == T - 1:
                    for c in range(nc):
                        s_pub[(j0 - 1 + c) % 32] = Bv[k][c]
            if publish:
                if flushed:
                    released[s].add(flushed)
                flushed = 0
                ql = t - (T - 1)
                jl = min(ql * C + C, m)
                if ql >= 0 and ql * C < m and (jl % KPUBLISH == 0
                                                or jl == m):
                    for x in range(32):
                        col = ((jl - 1) & ~(KPUBLISH - 1)) + 1 + x
                        if col <= jl:
                            assert (s, col) not in bnd
                            bnd[s, col] = s_pub[x]
                    flushed = jl
            for k in range(T):
                u_last[k] = U[k][C - 1]
            for w in range(T // 32):
                s_edge[t & 1][w] = list(Bv[32 * w + 31])
        if flushed:
            released[s].add(flushed)
        if publish:
            assert all((s, j) in bnd for j in range(1, m + 1))
        # the block's first max: score desc, then row asc
        tops = []
        for k in range(T):
            tb = ti = tj = 0
            for r in range(R):
                if first[k] + r < n and best[k][r] > tb:
                    tb, ti, tj = best[k][r], first[k] + r + 1, best_j[k][r]
            tops.append((tb, ti, tj))
        top = max(x[0] for x in tops)
        stripe_best.append([*next(x for x in tops if x[0] == top), 0]
                           if top > 0 else [0, 0, 0, 0])
    right_t = torch.tensor(right, dtype=torch.int32)
    best_t = sf._reduce(torch.tensor(stripe_best, dtype=torch.int32),
                        right_t, n)
    return best_t.tolist(), right


def _two_letter(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, m).astype(np.int8),
            rng.integers(0, 2, n).astype(np.int8))


# (pair, T, R, C): n past one stripe and not a multiple of T*R, m = 1,
# n < 32, m not a multiple of C or of a chunk, two warps a block, ties
CASES = {
    "n_below_32": (lambda: random_pair(40, 20, seed=1), 32, 4, 4),
    "m_is_1": (lambda: random_pair(1, 70, seed=2), 32, 8, 2),
    "three_stripes_ragged": (lambda: random_pair(100, 300, seed=3), 32, 4, 4),
    "m_not_a_chunk_C8": (lambda: random_pair(75, 300, seed=4), 32, 8, 8),
    "one_column_a_step": (lambda: random_pair(70, 340, seed=5), 32, 8, 1),
    "two_warps_R8": (lambda: random_pair(97, 600, seed=6), 64, 8, 2),
    "R16_thin": (lambda: random_pair(33, 700, seed=7), 32, 16, 4),
    "ties_two_letters": (lambda: _two_letter(90, 260, seed=8), 32, 4, 4),
    "ties_one_letter": (lambda: (np.zeros(40, np.int8),
                                 np.zeros(270, np.int8)), 32, 8, 8),
    "m_gt_n": (lambda: random_pair(170, 40, seed=9), 32, 8, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rb_model_matches_plain_and_jax(case):
    pair, T, R, C = CASES[case]
    a, b = pair()
    m, n = len(a), len(b)
    got, right = rb_model(a, b, LINEAR, T, R, C)
    plain = sf.stripe_score_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got == plain.best.tolist()
    assert right == plain.right_col.tolist()
    fn = stripe_score_fn(m, n, T=128, C=128, want_last=True)
    assert got == [int(v) for v in fn(jnp.asarray(a), jnp.asarray(b))]
    ref = oracle.fill(a, b)
    assert got == [ref.max_score, *ref.max_ij, int(ref.H[n, m])]
    np.testing.assert_array_equal(right, ref.H[:, m])


# ---- the route and the shape, as pure Python ----

def test_rb_takes_linear_unbanded_match_mismatch_only():
    assert sf.rb_takes(Scoring(), None, None)
    assert sf.rb_takes(Scoring(match=2, mismatch=-1, gap=-3), None, None)
    assert not sf.rb_takes(Scoring(), None, 8)
    assert not sf.rb_takes(Scoring(), None, 0)
    assert not sf.rb_takes(Scoring(mode="affine"), None, None)
    table = torch.zeros((4, 4), dtype=torch.int32)
    assert not sf.rb_takes(Scoring(), table, None)


def test_score_kernel_names_follow_the_route():
    table = torch.zeros((4, 4), dtype=torch.int32)
    assert sf.score_kernel_name(Scoring(), None) == sf.RB_KERNEL
    assert sf.score_kernel_name(Scoring(), None, True) == \
        "sw_stripe_score_linear[band]"
    assert sf.score_kernel_name(Scoring(mode="affine"), None) == \
        sf.SCORE_AFFINE_KERNEL
    assert sf.score_kernel_name(Scoring(), table) == sf.SCORE_SUB_KERNEL
    assert sf.RB_KERNEL in sf.launches


def test_rb_shape_clamps_threads_to_the_rows():
    assert sf.rb_shape(25632) == (sf.RB_THREADS, sf.RB_ROWS, sf.RB_COLS)
    assert sf.rb_shape(5) == (32, sf.RB_ROWS, sf.RB_COLS)
    assert sf.rb_shape(1000, 256, 16, 4) == (64, 16, 4)     # 63 threads
    assert sf.rb_shape(10 ** 6, 512) == (sf.RB_MAX_THREADS, sf.RB_ROWS,
                                         sf.RB_COLS)
    assert (sf.RB_ROWS, sf.RB_COLS) in sf.RB_TILES
    for n in (1, 31, 32, 33, 255, 257, 4097):
        for R, C in sf.RB_TILES:
            T, _, _ = sf.rb_shape(n, 512, R, C)
            assert T % 32 == 0 and T * R >= min(n, 512 * R)
            assert T - 32 < -(-n // R) or T == 32
    # T counts threads, as on the template's kernels, but this kernel
    # takes at most RB_MAX_THREADS: a larger T raises, it is not clamped
    for bad in (dict(T=16), dict(T=100), dict(T=544), dict(T=1024),
                dict(T=2048), dict(R=5), dict(C=3), dict(C=16),
                dict(R=4, C=8), dict(R=16, C=1)):
        with pytest.raises(ValueError):
            sf.rb_shape(1000, **bad)


@pytest.mark.parametrize("stripe_rows", [None, 64, 512, 1024])
def test_stripe_rows_counts_threads_on_the_rb_route(stripe_rows, monkeypatch):
    """EngineConfig.stripe_rows reaches the register-blocked K1 as its
    threads per block (each holding RB_ROWS rows), as it reaches the
    template's kernels; above RB_MAX_THREADS the route raises rather than
    clamp."""
    a, b = random_pair(60, 5000, seed=14)
    cfg = swtpu_torch.EngineConfig(stripe_rows=stripe_rows)
    seen = []

    def call(name, dev, args, *rest):
        seen.append((name, *args[7:10]))       # T, R, C as launched

    # the route of a card, the launch recorded instead of run
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call", call)

    def run():
        return swtpu_torch.align(a, b, config=cfg, traceback=False,
                                 plan="stripe", device="cpu")

    if stripe_rows is not None and stripe_rows > sf.RB_MAX_THREADS:
        with pytest.raises(ValueError, match="register-blocked"):
            run()
        assert not seen
        return
    run()
    assert seen == [(sf.RB_KERNEL, stripe_rows or sf.RB_THREADS, sf.RB_ROWS,
                     sf.RB_COLS)]


def test_cpu_score_runs_the_plain_version():
    a, b = random_pair(50, 90, seed=12)
    sf.reset_counts()
    out = sf.stripe_score(torch.from_numpy(a), torch.from_numpy(b))
    assert out.best.tolist() == rb_model(a, b, LINEAR, 32, 4, 4)[0]
    assert sf.plain_calls["stripe_score_plain"] == 1
    assert not any(sf.launches.values())


# ---- the CUDA kernel on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_rb_kernel_matches_plain_on_card(card, case):
    pair, T, R, C = CASES[case]
    a, b = pair()
    at, bt = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    plain = sf.stripe_score_plain(at, bt)
    for shape in ((T, R, C), (None, sf.RB_ROWS, sf.RB_COLS), (512, 16, 4)):
        got = sf._launch_rb(at, bt, LINEAR, *shape)
        torch.cuda.synchronize()
        assert torch.equal(got.best, plain.best), shape
        assert torch.equal(got.right_col, plain.right_col), shape


@pytest.mark.gpu
def test_score_routes_to_the_rb_kernel_on_card(card):
    a, b = random_pair(300, 2000, seed=13)
    at, bt = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    sf.reset_counts()
    got = sf.stripe_score(at, bt)
    banded = sf.stripe_score(at, bt, band=16)
    assert torch.equal(got.best, sf.stripe_score_plain(at, bt).best)
    assert torch.equal(banded.best,
                       sf.stripe_score_plain(at, bt, band=16).best)
    assert sf.launches[sf.RB_KERNEL] == 1
    assert sf.launches[sf.SCORE_KERNEL] == 0
    assert sf.launches[sf.SCORE_KERNEL + sf.BAND_SUFFIX] == 1
