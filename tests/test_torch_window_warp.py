"""The warp-per-read window scorer (K6 on the card) against the JAX
package, on the CPU.

The CUDA kernel ``window_warp_kernel`` (``swtpu_torch/csrc/window_warp.cu``)
runs only on a card. Here a pure-Python model of its schedule walks the
lanes, the R = ceil(rlen / 32) rows of each lane and the steps exactly as
the kernel indexes them: lane l owns rows l*R + 1 .. l*R + R and visits
column t - l + 1 at step t; the shuffle hands the lane's last row's H (and
F) to lane l + 1 one step later, lane 0 taking the read's zero row; each
lane keeps (best, first column) per row and the warp takes the max and
then the lowest lane holding it. The same seeded numpy inputs go through
the model, the port's plain version ``window_score_plain``, the JAX
package's Pallas ``batch_score_fn`` in interpret mode and its batched scan
(``swtpu.dist.database._window_scorer``). Tolerance: exact equality
(integer DP). The ``gpu`` tests hold the kernel against its plain version
on a card and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.core.config import Scoring as JScoring
from swtpu.core.substitution import BLOSUM62 as J_BLOSUM62
from swtpu.dist import database as jdb
from swtpu.kernels.pallas_fill import batch_score_fn
from swtpu_torch.convert import scoring_from_jax, substitution_from_jax
from swtpu_torch.kernels import pairs_fill
from swtpu_torch.kernels import stripe_fill as sf
from swtpu_torch.kernels import window_fill as wf

NEG = -(1 << 30)
NEG_SUB = -(1 << 20)

SCORINGS = {
    "linear": (JScoring(), None),
    "dna_affine": (JScoring(mode="affine", gap_open=-4, gap_extend=-1), None),
    "blosum62": (JScoring(mode="affine", gap_open=-11, gap_extend=-1),
                 J_BLOSUM62),
}


def _port(name):
    jsc, jsub = SCORINGS[name]
    return scoring_from_jax(jsc), (None if jsub is None
                                   else substitution_from_jax(jsub))


def warp_model(reads: np.ndarray, win: np.ndarray, sc, S=None) -> list:
    """The warp kernel's schedule in Python: [(score, row, col)] per read."""
    B, rlen = reads.shape
    W = len(win)
    R = -(-rlen // 32)
    A = 0 if S is None else S.shape[0]
    out = []
    for g in range(B):
        code = [[int(reads[g, lane * R + r]) if lane * R + r < rlen else -3
                 for r in range(R)] for lane in range(32)]
        if S is not None:       # each lane's column of the profile
            prof = [[[NEG_SUB if q == A or code[lane][r] < 0
                      else int(S[q, code[lane][r]]) for r in range(R)]
                     for q in range(A + 1)] for lane in range(32)]
        H = [[0] * R for _ in range(32)]
        E = [[NEG] * R for _ in range(32)]
        best = [[0] * R for _ in range(32)]
        best_j = [[0] * R for _ in range(32)]
        f_last = [NEG] * 32
        up_prev = [0] * 32
        for t in range(W + (rlen - 1) // R):
            # __shfl_up_sync: every lane reads lane - 1's registers of the
            # step before; lane 0 gets its own, overwritten by row 0
            ups = [0] + [H[lane - 1][R - 1] for lane in range(1, 32)]
            fups = [NEG] + [f_last[lane - 1] for lane in range(1, 32)]
            for lane in range(32):
                j = t - lane + 1
                up, f_up = ups[lane], fups[lane]
                if 1 <= j <= W:
                    aj = int(win[j - 1])
                    diag = up_prev[lane]
                    for r in range(R):
                        left = H[lane][r]
                        if S is not None:
                            s = prof[lane][A if aj < 0 else aj][r]
                        else:
                            s = sc.match if aj == code[lane][r] \
                                else sc.mismatch
                        if sc.is_affine:
                            E[lane][r] = max(E[lane][r] + sc.gap_extend,
                                             left + sc.gap_open)
                            f_up = max(f_up + sc.gap_extend,
                                       up + sc.gap_open)
                            h = max(diag + s, E[lane][r], f_up, 0)
                        else:
                            h = max(diag + s, left + sc.gap, up + sc.gap, 0)
                        if h > best[lane][r]:
                            best[lane][r], best_j[lane][r] = h, j
                        diag, up, H[lane][r] = left, h, h
                    f_last[lane] = f_up
                up_prev[lane] = ups[lane]
        # the lane's first max over its rows within the read, then the warp's
        lane_best = []
        for lane in range(32):
            lb = li = lj = 0
            for r in range(R):
                if lane * R + r < rlen and best[lane][r] > lb:
                    lb, li, lj = best[lane][r], lane * R + r + 1, \
                        best_j[lane][r]
            lane_best.append((lb, li, lj))
        wmax = max(lb for lb, _, _ in lane_best)
        out.append(next(x for x in lane_best if x[0] == wmax))
    return out


def _case(name, B, rlen, W, seed, ties=False):
    """Seeded reads and window with a planted read, the sentinels of a
    search (-1 unknown, -3 after a short read, -2 in a shard's tail) and,
    ``ties``, one read planted twice in the window."""
    rng = np.random.default_rng(seed)
    A = 20 if name == "blosum62" else 4
    win = rng.integers(0, A, W).astype(np.int8)
    reads = rng.integers(0, A, (B, rlen)).astype(np.int8)
    k = min(rlen - 2, W - 4)
    if k > 0:
        reads[0, 1:1 + k] = win[3:3 + k]
    if ties and W >= 2 * rlen + 10:
        win[W - rlen - 2:W - 2] = win[3:3 + rlen]
        reads[-1] = win[3:3 + rlen]
    if rlen > 10 and W > 10:
        reads[0, rlen // 2] = -1
        reads[-1, rlen - 5:] = -3
        win[1], win[-1] = -1, -2
    return reads, win


def _fields(hits) -> list:
    return [(x.cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x)).astype(np.int64).tolist() for x in hits]


def _triples(hits) -> list:
    return [tuple(x) for x in zip(*_fields(hits))]


SHAPES = [(rlen, W) for rlen in (1, 5, 32, 33, 70) for W in (1, 31, 200)]


@pytest.mark.parametrize("rlen, W", SHAPES)
@pytest.mark.parametrize("name", list(SCORINGS))
def test_warp_model_matches_plain_and_jax(name, rlen, W):
    reads, win = _case(name, 3, rlen, W, seed=rlen * 7 + W)
    jsc, jsub = SCORINGS[name]
    sc, sub = _port(name)
    got = warp_model(reads, win, sc, sub)
    rt, wt = torch.from_numpy(reads), torch.from_numpy(win)
    plain = wf.window_score_plain(rt, wt, sc,
                                  None if sub is None
                                  else torch.from_numpy(sub))
    assert got == _triples(plain)
    scan = jdb._window_scorer(jsc, jsub)(jnp.asarray(reads),
                                         jnp.asarray(win))
    assert got == _triples(scan)
    fn = batch_score_fn(3, rlen, W, scoring=jsc, interpret=True,
                        substitution=jsub)
    assert got == _triples(fn(jnp.asarray(reads), jnp.asarray(win)))


EDGES = {
    "ties": (4, 24, 90, dict(ties=True)),
    "rlen_is_32_R_max": (1, 32 * wf.WARP_MAX_ROWS, 40, {}),
    "all_sentinel_read": (3, 20, 60, {}),
}


@pytest.mark.parametrize("case", list(EDGES))
@pytest.mark.parametrize("name", list(SCORINGS))
def test_warp_model_edges_match_plain_and_jax(name, case):
    B, rlen, W, kw = EDGES[case]
    reads, win = _case(name, B, rlen, W, seed=len(case), **kw)
    if case == "all_sentinel_read":
        reads[1] = -3
    jsc, jsub = SCORINGS[name]
    sc, sub = _port(name)
    got = warp_model(reads, win, sc, sub)
    plain = wf.window_score_plain(torch.from_numpy(reads),
                                  torch.from_numpy(win), sc,
                                  None if sub is None
                                  else torch.from_numpy(sub))
    assert got == _triples(plain)
    scan = jdb._window_scorer(jsc, jsub)(jnp.asarray(reads),
                                         jnp.asarray(win))
    assert got == _triples(scan)
    if case == "all_sentinel_read":
        assert got[1] == (0, 0, 0)


# ---- the route, as pure Python ----

def test_warp_rows_from_the_read_length():
    assert [wf.warp_rows(r) for r in (1, 31, 32, 33, 64, 65, 150, 152)] == \
        [1, 1, 1, 2, 2, 3, 5, 5]
    assert wf.warp_rows(32 * wf.WARP_MAX_ROWS) == wf.WARP_MAX_ROWS
    assert wf.warp_rows(32 * wf.WARP_MAX_ROWS + 1) is None
    for rlen in range(1, 32 * wf.WARP_MAX_ROWS + 1, 13):
        R = wf.warp_rows(rlen)
        assert 32 * (R - 1) < rlen <= 32 * R       # pads by fewer than 32


def test_warp_rows_with_a_table_fit_shared_memory():
    # BLOSUM62's 21 codes fit at every R; a profile past the opt-in
    # shared memory takes the stripe route
    assert wf.warp_rows(512, A=21) == 16
    per_warp = lambda A, R: (A + 1) * R * 32 * 4       # noqa: E731
    for A in (21, 60, 127):
        for rlen in (1, 150, 300, 512):
            R = wf.warp_rows(rlen, A)
            fits = wf.WARPS_PER_BLOCK * per_warp(A, -(-rlen // 32)) \
                <= sf.SUB_PROFILE_BYTES
            assert (R is not None) == fits
    assert wf.warp_rows(512, A=127) is None and wf.warp_rows(32, A=127) == 1


def test_route_names_by_length_and_scoring():
    for name, mode in (("linear", "linear"), ("dna_affine", "affine"),
                       ("blosum62", "sub")):
        sc, sub = _port(name)
        S = None if sub is None else torch.from_numpy(sub)
        assert wf.warp_kernel_name(sc, S) == f"sw_window_warp_{mode}"
        for rlen in (1, 150, 512):
            assert wf.window_route_name(rlen, sc, S) == \
                f"sw_window_warp_{mode}"
        assert wf.window_route_name(513, sc, S) == f"sw_window_score_{mode}"


def test_warp_counters_reset_with_the_others():
    assert set(wf.WARP_KERNELS.values()) < set(wf.launches)
    assert set(wf.WINDOW_KERNELS.values()) < set(wf.launches)
    wf.launches["sw_window_warp_linear"] = 2
    pairs_fill.reset_counts()
    assert not any(wf.launches.values())


def test_cpu_scorer_runs_the_plain_version():
    sc, _ = _port("linear")
    reads, win = _case("linear", 3, 40, 100, seed=4)
    pairs_fill.reset_counts()
    scorer = wf.WindowScorer(torch.from_numpy(reads), 100, sc)
    got = scorer(torch.from_numpy(win))
    assert _triples(got) == warp_model(reads, win, sc)
    assert wf.plain_calls["window_score_plain"] == 1
    assert not any(wf.launches.values())


# ---- the CUDA kernel on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rlen, W", SHAPES + [(24, 90), (512, 40)])
@pytest.mark.parametrize("name", list(SCORINGS))
def test_warp_kernel_matches_plain_on_card(card, name, rlen, W):
    reads, win = _case(name, 3, rlen, W, seed=rlen * 7 + W, ties=True)
    sc, sub = _port(name)
    S = None if sub is None else torch.from_numpy(sub).to(card)
    rt, wt = torch.from_numpy(reads).to(card), torch.from_numpy(win).to(card)
    pairs_fill.reset_counts()
    got = wf.window_score(rt, wt, sc, substitution=S)
    assert _fields(got) == _fields(wf.window_score_plain(rt, wt, sc, S))
    assert wf.launches[wf.warp_kernel_name(sc, S)] == 1
    assert wf.launches[wf.window_kernel_name(sc, S)] == 0


@pytest.mark.gpu
def test_long_reads_take_the_stripe_route_on_card(card):
    sc, _ = _port("linear")
    reads, win = _case("linear", 2, 32 * wf.WARP_MAX_ROWS + 1, 300, seed=9)
    rt, wt = torch.from_numpy(reads).to(card), torch.from_numpy(win).to(card)
    pairs_fill.reset_counts()
    got = wf.window_score(rt, wt, sc)
    assert _fields(got) == _fields(wf.window_score_plain(rt, wt, sc))
    assert wf.launches["sw_window_score_linear"] == 1
    assert wf.launches["sw_window_warp_linear"] == 0
