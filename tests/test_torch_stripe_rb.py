"""The register-blocked single-pair stripe (K1-K3 on the card) against the
JAX package, on the CPU.

The CUDA kernel ``stripe_rb_kernel`` (``swtpu_torch/csrc/stripe_rb.cu``)
runs only on a card. Here a pure-Python model of its schedule walks the
stripes in ticket order and, within a stripe, the threads, their R rows,
the C columns of a step and the steps exactly as the kernel indexes them:
thread k owns rows s*T*R + k*R + 1 .. + R and visits the tile of columns
(t - k)*C + 1 .. + C at step t; UP (and, affine, F) comes from thread
k - 1 of the step before (a shuffle in a warp, the last lane's shared
slot across warps, the boundary chunk for thread 0); E runs along each
row in its register; warp 0 stages the query ring and the boundary row
(and F's) by chunks of 32 columns, waiting only for columns the stripe
above publishes; the last warp stores its row (and F's) by chunks; with
a table each thread reads its own column of the int4 profile, a
sentinel row at q = min(A, 128) and kNegSub in the rows of sentinel or
pad codes; the block takes the smallest row holding its max and
``stripe_fill._reduce`` the first stripe holding the global max. The
model's answer and right column must equal the port's plain version
``stripe_score_plain``, the JAX package's ``stripe_score_fn`` (its Pallas
kernel in interpret mode) and its numpy oracle (given sentinel codes as
rows and columns of kNegSub in the table it indexes). Tolerance: exact
equality (integer DP). The ``gpu`` tests hold each kernel against its
plain version on a card and skip elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu import Scoring as JaxScoring
from swtpu.core import oracle
from swtpu.core.encode import random_pair
from swtpu.kernels.pallas_fill import stripe_score_fn
import swtpu_torch
from swtpu_torch import Scoring
from swtpu_torch.core.substitution import BLOSUM62
from swtpu_torch.kernels import pairs_fill as pf
from swtpu_torch.kernels import stripe_fill as sf

KPUBLISH, KAHEAD, KRING = 32, 64, 8192     # the kernel's constants
KMAXSYM = 128
NEG, NEG_SUB = -(1 << 30), -(1 << 20)
UNSCHEDULED = -(1 << 31)    # what a capture slot no step writes keeps
NONE, UP, LEFT, DIAGONAL, E_EXT, F_EXT = 0, 1, 2, 3, 4, 8   # P's codes
GUARD = 0x5A                # a byte the model's P stores never write
LINEAR = Scoring()
DNA_AFFINE = Scoring(mode="affine")                       # 3/-3, -4/-1
PROTEIN = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
PROTEIN_LINEAR = Scoring(gap=-6)


def rb_window(s: int, T: int, R: int, C: int, m: int, n: int,
              band: int = None) -> tuple:
    """(col0, tiles, end) of stripe s: it visits the tiles of columns col0
    + 1 .. end, ``tiles`` of them. With no band every column; with one the
    columns max(1, r0 - band) .. min(m, r1 + band) of its rows r0 .. r1,
    the first rounded down to a chunk of kPublish, so a tile starts at 1 +
    C*q and a chunk at 1 + 32*c; none when band < 0 or the band has left
    the matrix (tiles 0, end = col0)."""
    if band is None:
        return 0, -(-m // C), m
    r0, r1 = s * T * R + 1, min(n, (s + 1) * T * R)
    lo, hi = max(1, r0 - band), min(m, r1 + band)
    if band < 0 or lo > hi:
        col0 = min(m, lo - 1) // KPUBLISH * KPUBLISH
        return col0, 0, col0
    col0 = (lo - 1) // KPUBLISH * KPUBLISH
    q1 = (hi - 1) // C
    return col0, q1 - col0 // C + 1, min(m, (q1 + 1) * C)


def rb_model(a: np.ndarray, b: np.ndarray, sc: Scoring, T: int, R: int,
             C: int, table: np.ndarray = None, capture_p: bool = False,
             block: dict = None, extra: dict = None,
             band: int = None, capture: dict = None,
             pairs: bool = False) -> tuple:
    """The kernel's schedule in Python: ((4,) best, (n+1,) right) as the
    wrapper returns them. ``table``: the (A, A) S[a_code, b_code] of the
    substitution form. ``capture_p``: the K4 form, storing each cell's
    code into P (a row's codes of a whole tile at once, the tile holding
    column m a byte a cell), rows 0 and column 0 NONE (banded: P cleared
    first, as the wrapper does, and only the windows' tiles stored).
    ``block``: the K5 form, a
    dict of the injected ``top``, ``left`` (affine ``top_f``, ``left_e``),
    ``local`` and ``want_bottom``. ``extra``, a dict, gets ``P`` (the
    (n+1, m+1) codes), ``right_e``, ``bottom`` and ``bottom_f`` as the
    forms write them. ``band``: the band form (K4b), each stripe visiting
    only its ``rb_window``, cells with |i - j| > band masked to H = 0, E =
    F = NEG and P = NONE, the row above read only where the stripe above
    stored it (H = 0, F = NEG past its window), each stripe releasing m at
    its end. ``capture``: the K9 form, a dict taking ``skew`` (default 0;
    boundary column j read from column j - skew, 0 and NEG left of column
    1) and getting ``h``, (stripes, ceil(m / C) + T - 1, T, R, C), each
    thread's R x C slots after every step it runs (the cell's H inside the
    matrix, 0 outside it, rows past n included; steps the stripe never
    runs keep UNSCHEDULED), and ``seen``, (stripes, m + 1), the progress a
    boundary read saw (-1 where none). ``pairs``: the K8 batch form, a (B,
    m) against b (B, n), each pair's stripes in ticket order (pair-major)
    with its own counters and rows: returns ``pairs_fill._reduce_stripes``
    of the (B, S, 4) stripe firsts as three lists, and no right column."""
    if pairs:
        firsts = []
        for g in range(len(a)):
            got = {}
            rb_model(a[g], b[g], sc, T, R, C, table, extra=got)
            firsts.append(got["stripe_best"])
        return [x.tolist() for x in pf._reduce_stripes(
            torch.tensor(firsts, dtype=torch.int32))]
    m, n = len(a), len(b)
    affine = sc.is_affine
    k_steps = KPUBLISH // C
    S = -(-n // (T * R))
    bnd = {}                      # (stripe, column): H of its last row
    bnd_f = {}                    # and F, affine
    released = [set() for _ in range(S)]
    right = [0] * (n + 1)
    stripe_best = []
    # P with a guard row and column: cells never stored keep GUARD
    P = np.full((n + 2, m + 2), GUARD, np.int16) if capture_p else None
    if capture_p and band is not None:
        P[:n + 1, :m + 1] = NONE          # the wrapper's one clear of P
        stored = np.zeros((n + 1, m + 1), bool)
    if block is not None:
        top, left = block["top"], block["left"]
        top_f = block.get("top_f") if affine else None
        left_e = block.get("left_e") if affine else None
        floor = 0 if block["local"] else None
        right_e = [NEG] * (n + 1)
        bottom = [None] * (m + 1) if block["want_bottom"] else None
        bottom_f = [None] * (m + 1) if block["want_bottom"] else None
    skew = capture.get("skew", 0) if capture is not None else 0
    if capture is not None:
        cap_h = np.full((S, -(-m // C) + T - 1, T, R, C), UNSCHEDULED,
                        np.int64)
        cap_seen = np.full((S, m + 1), -1, np.int64)

    def store(i, j, move):
        """One code into P: each cell of the windows once."""
        if band is None:
            assert P[i, j] == GUARD
        else:
            assert not stored[i, j]
            stored[i, j] = True
        P[i, j] = move

    for s in range(S):
        kt = (min(T * R, n - s * T * R) + R - 1) // R
        col0, tiles, end = rb_window(s, T, R, C, m, n, band)
        steps = tiles + kt - 1 if tiles else 0
        # the columns the stripe above stored: pcol0 + 1 .. pend
        pcol0, _, pend = (rb_window(s - 1, T, R, C, m, n, band) if s
                          else (0, 0, m))
        first = [s * T * R + k * R for k in range(T)]
        code = [[int(b[first[k] + r]) & 0xff if first[k] + r < n else 0x100
                 for r in range(R)] for k in range(T)]
        prof, rows = None, 0
        if table is not None:             # each thread's profile column
            A = table.shape[0]
            rows = min(A, KMAXSYM)
            prof = [None] * ((rows + 1) * (R // 4) * T)
            for k in range(T):
                cb = [int(b[first[k] + r]) if first[k] + r < n else -1
                      for r in range(R)]
                for q in range(rows + 1):
                    for r4 in range(R // 4):
                        prof[(q * (R // 4) + r4) * T + k] = tuple(
                            int(table[q, cb[4 * r4 + x]])
                            if q < rows and cb[4 * r4 + x] >= 0 else NEG_SUB
                            for x in range(4))
        if capture_p and band is None:    # row 0 (stripe 0) and column 0
            if s == 0:
                P[0, :m + 1] = NONE
            for k in range(T):
                for r in range(R):
                    if first[k] + r < n:
                        P[first[k] + r + 1, 0] = NONE
        publish = (s + 1) * T * R < n
        ring = {(col0 + c) % KRING: col0 + c          # slot -> column held
                for c in range(KAHEAD) if col0 + c < m}
        a_next = [col0 + KAHEAD + x for x in range(32)]  # warp 0's register

        def fetch(lo):
            """A chunk from column lo (H's and F's), after waiting for the
            progress of the stripe above to reach its end: a column it
            releases; stripe 0 of the block form reads the injected row
            0, with no wait."""
            if s == 0:
                return ([int(top[lo + x]) if lo + x <= m else 0
                         for x in range(32)],
                        [int(top_f[lo + x]) if affine and lo + x <= m
                         else NEG for x in range(32)])
            if lo > pend:                 # past the stripe above's window
                return [0] * 32, [NEG] * 32
            want = min(lo + KPUBLISH - 1, pend)
            assert want % KPUBLISH == 0 or want == pend
            assert want in released[s - 1]
            if capture is not None:       # the progress each lane saw
                for x in range(32):
                    if lo + x <= m:
                        cap_seen[s, lo + x] = max(released[s - 1])
                        assert cap_seen[s, lo + x] >= lo + x
            cols = [lo + x - skew for x in range(32)]
            return ([bnd[s - 1, j] if 1 <= j <= pend and lo + x <= pend
                     else 0 for x, j in enumerate(cols)],
                    [bnd_f[s - 1, j] if affine and 1 <= j <= pend
                     and lo + x <= pend else NEG
                     for x, j in enumerate(cols)])

        reads_row = s > 0 or block is not None
        cur = nxt = ([0] * 32, [NEG] * 32)
        u0 = 0                    # thread 0's first DIAG: H(r0 - 1, col0)
        if reads_row and tiles:
            cur = fetch(col0 + 1)
            if col0 + KPUBLISH < end:
                nxt = fetch(col0 + KPUBLISH + 1)
            if s > 0 and pcol0 < col0 <= pend:
                # the first fetch's wait covered the column
                assert min(col0 + KPUBLISH, pend) >= col0
                u0 = bnd[s - 1, col0]
        H = [[0] * R for _ in range(T)]
        E = [[NEG] * R for _ in range(T)]
        best = [[0] * R for _ in range(T)]
        best_j = [[0] * R for _ in range(T)]
        Bv = [[0] * C for _ in range(T)]
        BFv = [[NEG] * C for _ in range(T)]
        u_last = [u0] + [0] * (T - 1)
        if block is not None:             # column 0: the rows' H and E
            for k in range(T):
                for r in range(R):
                    if first[k] + r < n:
                        H[k][r] = int(left[first[k] + r + 1])
                        if affine:
                            E[k][r] = int(left_e[first[k] + r + 1])
                if first[k] <= n:
                    u_last[k] = int(left[first[k]])
                h_last = (int(left[first[k] + R]) if first[k] + R <= n
                          else 0)
                Bv[k] = [h_last] * C
        s_edge = [[[0] * C for _ in range(T // 32)] for _ in range(2)]
        s_fedge = [[[NEG] * C for _ in range(T // 32)] for _ in range(2)]
        s_bnd = [([0] * 32, [NEG] * 32), ([0] * 32, [NEG] * 32)]
        s_pub = [0] * 32
        s_pubf = [NEG] * 32
        flushed = 0
        for t in range(steps):
            if t % k_steps == 0:              # warp 0: thread 0 starts a chunk
                c0 = col0 + t * C
                for x in range(32):
                    col = c0 + KAHEAD + x
                    assert a_next[x] == col
                    if col < m:
                        ring[col % KRING] = col
                    a_next[x] = col + KPUBLISH
                if reads_row:
                    if t > 0:
                        cur = nxt
                        if c0 + KPUBLISH + 1 <= end:
                            nxt = fetch(c0 + KPUBLISH + 1)
                    s_bnd[(t // k_steps) & 1] = (list(cur[0]), list(cur[1]))
            U, UF = [], []
            for k in range(T):
                lane, warp = k % 32, k // 32
                if lane:
                    U.append(list(Bv[k - 1]))      # the shuffles
                    UF.append(list(BFv[k - 1]))
                elif k:
                    U.append(list(s_edge[(t + 1) & 1][warp - 1]))
                    UF.append(list(s_fedge[(t + 1) & 1][warp - 1]))
                elif reads_row:
                    slot = s_bnd[(t // k_steps) & 1]
                    U.append([slot[0][(t * C + c) % 32] for c in range(C)])
                    UF.append([slot[1][(t * C + c) % 32] for c in range(C)])
                else:
                    U.append([0] * C)              # the zero row
                    UF.append([NEG] * C)
            for k in range(T):
                q = col0 // C + t - k
                j0 = q * C + 1
                if capture is not None:
                    cap_h[s, t, k] = 0    # every slot a step, 0 unless set
                if not (k < kt and 0 <= t - k < tiles):
                    continue
                nc = min(C, m - j0 + 1)
                whole = j0 + C - 1 < m
                tile_codes = {}          # a whole tile's: (row, column)
                for c in range(nc):
                    col = q * C + c
                    assert ring[col % KRING] == col    # staged, not evicted
                    aj = int(a[col]) & 0xff            # the ring's byte
                    diag = u_last[k] if c == 0 else U[k][c - 1]
                    up, f = U[k][c], UF[k][c]
                    if prof is not None:               # the profile column
                        p = min(aj, rows) * (R // 4) * T + k
                        score = [prof[p + (r // 4) * T][r % 4]
                                 for r in range(R)]
                    else:
                        score = [sc.match if aj == code[k][r]
                                 else sc.mismatch for r in range(R)]
                    fr = []
                    for r in range(R):
                        left_h = H[k][r]
                        d = diag + score[r]
                        # the band form's mask: DIAG and (linear) the gap
                        # to NEG, E and F to NEG, so H = 0 and P = NONE
                        inb = (band is None
                               or abs(first[k] + r + 1 - (j0 + c)) <= band)
                        if not inb:
                            d = NEG
                        if block is not None and floor is None:
                            x = d                      # the global form
                        else:
                            x = max(d, 0)
                        if affine:
                            e_ext = E[k][r] + sc.gap_extend
                            f_ext = f + sc.gap_extend
                            E[k][r] = (max(e_ext, left_h + sc.gap_open)
                                       if inb else NEG)
                            f = max(f_ext, up + sc.gap_open) if inb else NEG
                            up_v, left_v = f, E[k][r]
                        else:
                            gap = sc.gap if inb else NEG
                            up_v = up + gap
                            left_v = left_h + gap
                        h = max(x, up_v, left_v)
                        if capture_p:
                            # the template's order: from 0 and NONE a
                            # strictly greater DIAG, then UP, then LEFT
                            h1 = max(d, 0)
                            move = (LEFT if left_v > max(h1, up_v)
                                    else UP if up_v > h1
                                    else DIAGONAL if d > 0 else NONE)
                            if affine:
                                move += ((E_EXT if E[k][r] == e_ext else 0)
                                         + (F_EXT if f == f_ext else 0))
                                move = move if inb else NONE
                            if first[k] + r < n:
                                if whole:
                                    tile_codes[r, c] = move
                                elif inb:    # banded: NONE outside
                                    store(first[k] + r + 1, j0 + c, move)
                        fr.append(f)
                        if capture is not None and first[k] + r < n:
                            cap_h[s, t, k, r, c] = h
                        if h > best[k][r]:
                            best[k][r], best_j[k][r] = h, j0 + c
                        diag, up, H[k][r] = left_h, h, h
                    if block is not None and bottom is not None \
                            and first[k] < n <= first[k] + R:
                        bottom[j0 + c] = H[k][n - 1 - first[k]]
                        bottom_f[j0 + c] = fr[n - 1 - first[k]]
                    Bv[k][c] = H[k][R - 1]
                    BFv[k][c] = f
                for (r, c), move in tile_codes.items():   # once a tile
                    # banded: a row wholly outside the band stays NONE
                    reach = band is None or any(
                        abs(first[k] + r + 1 - (j0 + x)) <= band
                        for x in range(C))
                    if reach:
                        store(first[k] + r + 1, j0 + c, move)
                if not whole:                     # the tile holding column m
                    for r in range(R):
                        if first[k] + r < n:
                            right[first[k] + r + 1] = H[k][r]
                            if block is not None:
                                right_e[first[k] + r + 1] = E[k][r]
                if publish and k == T - 1:
                    for c in range(nc):
                        s_pub[(j0 - 1 + c) % 32] = Bv[k][c]
                        s_pubf[(j0 - 1 + c) % 32] = BFv[k][c]
            if publish:
                if flushed:
                    released[s].add(flushed)
                flushed = 0
                ql = t - (T - 1)
                jl = min(col0 + ql * C + C, m)
                if 0 <= ql < tiles and (jl % KPUBLISH == 0 or jl == end):
                    for x in range(32):
                        col = ((jl - 1) & ~(KPUBLISH - 1)) + 1 + x
                        if col <= jl:
                            assert (s, col) not in bnd
                            bnd[s, col] = s_pub[x]
                            bnd_f[s, col] = s_pubf[x]
                    flushed = jl
            for k in range(T):
                u_last[k] = U[k][C - 1]
            for w in range(T // 32):
                s_edge[t & 1][w] = list(Bv[32 * w + 31])
                s_fedge[t & 1][w] = list(BFv[32 * w + 31])
        if flushed:
            released[s].add(flushed)
        if band is not None:
            released[s].add(m)            # a stripe ends by releasing m
        if publish:
            assert all((s, j) in bnd for j in range(col0 + 1, end + 1))
            assert len([j for (x, j) in bnd if x == s]) == end - col0
        # the block's first max: score desc, then row asc
        tops = []
        for k in range(T):
            tb = ti = tj = 0
            for r in range(R):
                if first[k] + r < n and best[k][r] > tb:
                    tb, ti, tj = best[k][r], first[k] + r + 1, best_j[k][r]
            tops.append((tb, ti, tj))
        top_s = max(x[0] for x in tops)
        stripe_best.append([*next(x for x in tops if x[0] == top_s), 0]
                           if top_s > 0 else [0, 0, 0, 0])
    right_t = torch.tensor(right, dtype=torch.int32)
    if block is not None:
        right_t[0] = right[0] = int(top[m])
    best_t = sf._reduce(torch.tensor(stripe_best, dtype=torch.int32),
                        right_t, n)
    if capture is not None:
        capture["h"], capture["seen"] = cap_h, cap_seen
    if extra is not None:
        extra["stripe_best"] = stripe_best
        if capture_p:
            # every cell of rows 0..n, columns 0..m stored, and no other
            assert (P[:n + 1, :m + 1] != GUARD).all()
            assert (P[n + 1] == GUARD).all() and (P[:, m + 1] == GUARD).all()
            extra["P"] = P[:n + 1, :m + 1].astype(np.int8)
        if block is not None:
            extra["right_e"] = right_e if affine else None
            if bottom is not None:
                bottom[0] = int(left[n])
                bottom_f[0] = NEG
                assert None not in bottom
                extra["bottom"] = bottom
                extra["bottom_f"] = bottom_f if affine else None
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


def _protein(m, n, seed, letters=21):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, letters, m).astype(np.int8),
            rng.integers(0, letters, n).astype(np.int8))


def _sentinels(pair, seed):
    """The pair with a shared segment planted, sentinel codes -1, -2, -3
    in a and in b, and a -1 in both at one aligned spot of the segment
    (N against N)."""
    a, b = (x.copy() for x in pair)
    rng = np.random.default_rng(seed)
    L = min(len(a), len(b)) // 2
    i0, j0 = len(b) // 3, len(a) // 4
    b[i0:i0 + L] = a[j0:j0 + L]
    a[j0 + L // 2] = b[i0 + L // 2] = -1
    a[rng.choice(len(a), 3, replace=False)] = [-1, -2, -3]
    b[rng.choice(len(b), 3, replace=False)] = [-3, -2, -1]
    return a, b


def _gapped(letters, seed):
    """a, and b holding a's segments with 15-row insertions across rows
    128 | 129 and 256 | 257: at T = 64, R = 4 the best path's vertical
    gaps (F chains) cross a warp and a stripe."""
    rng = np.random.default_rng(seed)

    def junk(k):
        return rng.integers(0, letters, k).astype(np.int8)

    a = junk(200)
    b = np.concatenate([junk(80), a[:40], junk(15), a[40:154], junk(15),
                        a[154:], junk(100)])
    assert b[120:135].size == 15 and b[249:264].size == 15
    return a, b


# (pair, scoring, table, T, R, C) of the affine (K2) and table (K3) forms:
# n < 32, m = 1, m = 33, n past one stripe and not a multiple of T*R,
# two warps a block, sentinels in both (and N against N), ties, each tile
GOTOH_CASES = {
    "dna_affine_n_below_32": (lambda: random_pair(40, 20, seed=21),
                              DNA_AFFINE, None, 32, 4, 4),
    "dna_affine_m_is_1": (lambda: random_pair(1, 70, seed=22), DNA_AFFINE,
                          None, 32, 8, 2),
    "dna_affine_three_stripes_ragged": (lambda: random_pair(100, 300,
                                                            seed=23),
                                        DNA_AFFINE, None, 32, 4, 4),
    "dna_affine_m_33_two_warps": (lambda: random_pair(33, 600, seed=24),
                                  DNA_AFFINE, None, 64, 8, 2),
    "dna_affine_sentinels_n_vs_n": (
        lambda: _sentinels(random_pair(90, 260, seed=25), 25), DNA_AFFINE,
        None, 32, 8, 4),
    "dna_affine_ties": (lambda: _two_letter(90, 260, seed=26), DNA_AFFINE,
                        None, 32, 4, 4),
    "dna_affine_gaps_across_warps_and_stripes": (lambda: _gapped(4, 35),
                                                 DNA_AFFINE, None, 64, 4, 4),
    "blosum62_affine_gaps_across_warps_and_stripes": (
        lambda: _gapped(20, 36), PROTEIN, BLOSUM62, 64, 4, 4),
    "blosum62_affine": (lambda: _protein(75, 300, 27), PROTEIN, BLOSUM62,
                        32, 8, 4),
    "blosum62_affine_sentinels": (
        lambda: _sentinels(_protein(60, 280, 28), 28), PROTEIN, BLOSUM62, 32,
        4, 4),
    "blosum62_affine_m_33_two_warps": (lambda: _protein(33, 700, 29),
                                       PROTEIN, BLOSUM62, 64, 4, 4),
    "blosum62_affine_m_is_1": (lambda: _protein(1, 70, 30), PROTEIN,
                               BLOSUM62, 32, 8, 2),
    "blosum62_affine_ties": (lambda: _two_letter(70, 200, seed=31), PROTEIN,
                             BLOSUM62, 32, 8, 2),
    "blosum62_linear": (lambda: _protein(97, 300, 32), PROTEIN_LINEAR,
                        BLOSUM62, 32, 8, 2),
    "blosum62_linear_sentinels_n_below_32": (
        lambda: _sentinels(_protein(50, 24, 33), 33), PROTEIN_LINEAR,
        BLOSUM62, 32, 8, 4),
    "blosum62_linear_three_stripes": (lambda: _protein(40, 270, 34),
                                      PROTEIN_LINEAR, BLOSUM62, 32, 4, 4),
}


def _jax_scoring(sc: Scoring) -> JaxScoring:
    return JaxScoring(match=sc.match, mismatch=sc.mismatch, gap=sc.gap,
                      gap_open=sc.gap_open, gap_extend=sc.gap_extend,
                      mode=sc.mode)


def _oracle_table(S: np.ndarray) -> np.ndarray:
    """S with three rows and columns of kNegSub after it: the numpy
    oracle indexes it with the raw codes, so -1, -2 and -3 read them."""
    A = S.shape[0]
    out = np.full((A + 3, A + 3), NEG_SUB, np.int32)
    out[:A, :A] = S
    return out


@pytest.mark.parametrize("case", list(GOTOH_CASES))
def test_rb_gotoh_model_matches_plain_and_jax(case):
    pair, sc, S, T, R, C = GOTOH_CASES[case]
    a, b = pair()
    m, n = len(a), len(b)
    got, right = rb_model(a, b, sc, T, R, C, S)
    plain = sf.stripe_score_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  sc, None if S is None
                                  else torch.from_numpy(S))
    assert got == plain.best.tolist()
    assert right == plain.right_col.tolist()
    fn = stripe_score_fn(m, n, _jax_scoring(sc), T=128, C=128,
                         want_last=True, substitution=S)
    assert got == [int(v) for v in fn(jnp.asarray(a), jnp.asarray(b))]
    ref = oracle.fill(a, b, _jax_scoring(sc),
                      None if S is None else _oracle_table(S))
    assert got == [ref.max_score, *ref.max_ij, int(ref.H[n, m])]
    np.testing.assert_array_equal(right, ref.H[:, m])
    assert got[0] > 0


# ---- the route and the shape, as pure Python ----

def test_rb_takes_linear_unbanded_match_mismatch_only(monkeypatch):
    """Every scoring takes the register-blocked route on a card (the
    launch recorded instead of run): K1 for linear match/mismatch, K2
    affine, K3 a table (both gap models), and, banded, their band form;
    the template's entries launch on no route."""
    table = torch.zeros((4, 4), dtype=torch.int32)
    seen = []
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call",
                        lambda name, dev, args, *rest: seen.append(name))
    a, b = random_pair(40, 300, seed=15)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for sc, sub in ((Scoring(), None),
                    (Scoring(match=2, mismatch=-1, gap=-3), None),
                    (DNA_AFFINE, None), (Scoring(), table),
                    (PROTEIN, table)):
        mode = sf._mode(sc, sub)
        for band in (None, -1, 0, 8, 10 ** 6):
            seen.clear()
            sf.stripe_score(at, bt, sc, substitution=sub, band=band)
            assert seen == [(sf.RB_KERNELS if band is None
                             else sf.RB_BAND_KERNELS)[mode]]


def test_score_kernel_names_follow_the_route():
    table = torch.zeros((4, 4), dtype=torch.int32)
    assert sf.score_kernel_name(Scoring(), None) == sf.RB_KERNEL
    assert sf.score_kernel_name(Scoring(), None, True) == \
        "sw_stripe_rb_band_linear"
    assert sf.score_kernel_name(DNA_AFFINE, None) == sf.RB_AFFINE_KERNEL
    assert sf.score_kernel_name(DNA_AFFINE, None, True) == \
        sf.RB_BAND_KERNELS["affine"]
    assert sf.score_kernel_name(Scoring(), table) == sf.RB_SUB_KERNEL
    assert sf.score_kernel_name(PROTEIN, table) == sf.RB_SUB_KERNEL
    assert sf.score_kernel_name(PROTEIN, table, True) == \
        "sw_stripe_rb_band_sub"
    assert set(sf.RB_KERNELS.values()) <= set(sf.launches)
    assert set(sf.RB_BAND_KERNELS.values()) <= set(sf.launches)


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


def test_rb_shape_of_each_form():
    for mode in ("linear", "affine", "sub"):
        T, R, C = sf.RB_DEFAULTS[mode]
        assert (R, C) in sf.RB_FORM_TILES[mode]
        assert sf.rb_shape(25632, mode=mode, A=21) == (T, R, C)
        for R, C in sf.RB_FORM_TILES[mode]:
            assert sf.rb_shape(40, None, R, C, mode, 21) == (32, R, C)
    for mode in ("affine", "sub"):
        for R, C in ((16, 4), (8, 1), (8, 8), (5, 4)):
            with pytest.raises(ValueError, match="tiles"):
                sf.rb_shape(1000, None, R, C, mode, 21)
        with pytest.raises(ValueError, match="multiple of 32"):
            sf.rb_shape(1000, 544, mode=mode, A=21)
    # a table's profile, (min(A, 128) + 1) * R * T int32, caps T
    for A, R, want in ((21, 8, 288), (21, 4, 512), (127, 8, 32)):
        T, _, _ = sf.rb_shape(10 ** 6, 512, R, 4, "sub", A)
        assert T == want
        assert (min(A, sf.RB_MAX_SYMBOLS) + 1) * R * T * 4 <= \
            sf.RB_PROFILE_BYTES
    assert sf.rb_shape(10 ** 6, 512, 8, 4, "affine") == (512, 8, 4)


# (scoring, table) of each form; the C entry's arguments as _launch_rb
# lays them out: its scoring, then T, R, C, sync, bnd, [bnd_f,] best, right
FORMS = {"linear": (LINEAR, None), "affine": (DNA_AFFINE, None),
         "sub_affine": (PROTEIN, BLOSUM62),
         "sub_linear": (PROTEIN_LINEAR, BLOSUM62)}


@pytest.mark.parametrize("form", list(FORMS))
def test_score_launches_the_form_entry(form, monkeypatch):
    """stripe_score on a card (the launch recorded instead of run): an
    unbanded call launches the form's register-blocked entry with the
    arguments its ctypes signature declares, at rb_shape's (T, R, C); a
    banded one the template's K4b."""
    from swtpu_torch.kernels import _cuda
    sc, S = FORMS[form]
    a, b = (_protein(70, 900, 40) if S is not None
            else random_pair(70, 900, seed=40))
    St = None if S is None else torch.from_numpy(S)
    seen = []
    monkeypatch.setattr(sf, "_route", lambda *args, **kw: "cuda")
    monkeypatch.setattr(sf, "_call",
                        lambda name, dev, args, *rest: seen.append(
                            (name, rest[0] if rest else name, args)))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    sf.stripe_score(at, bt, sc, substitution=St)
    sf.stripe_score(at, bt, sc, substitution=St, band=8)
    (name, _, args), (_, band_counter, _) = seen
    mode = sf._mode(sc, St)
    assert name == sf.RB_KERNELS[mode] == sf.score_kernel_name(sc, St)
    assert band_counter == sf.score_kernel_name(sc, St, True)
    assert len(args) + 1 == len(_cuda.ARGTYPES[name])        # + the stream
    shape = sf.rb_shape(900, mode=mode, A=21)
    tail = 4 if mode == "linear" else 5      # sync, bnd, [bnd_f,] best, right
    assert tuple(args[-tail - 3:-tail]) == shape
    if mode != "linear":
        assert (args[-3] is not None) == sc.is_affine           # bnd_f


def test_cpu_score_runs_the_plain_version():
    a, b = random_pair(50, 90, seed=12)
    sf.reset_counts()
    out = sf.stripe_score(torch.from_numpy(a), torch.from_numpy(b))
    assert out.best.tolist() == rb_model(a, b, LINEAR, 32, 4, 4)[0]
    assert sf.plain_calls["stripe_score_plain"] == 1
    assert not any(sf.launches.values())


@pytest.mark.parametrize("case", ["dna_affine_ties",
                                  "blosum62_affine_sentinels",
                                  "blosum62_linear"])
def test_cpu_score_runs_the_plain_version_each_form(case):
    pair, sc, S, T, R, C = GOTOH_CASES[case]
    a, b = pair()
    sf.reset_counts()
    out = sf.stripe_score(torch.from_numpy(a), torch.from_numpy(b), sc,
                          substitution=None if S is None
                          else torch.from_numpy(S))
    assert out.best.tolist() == rb_model(a, b, sc, T, R, C, S)[0]
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
@pytest.mark.parametrize("case", list(GOTOH_CASES))
def test_rb_gotoh_kernel_matches_plain_on_card(card, case):
    pair, sc, S, T, R, C = GOTOH_CASES[case]
    a, b = pair()
    at, bt = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    St = None if S is None else torch.from_numpy(S).to(card)
    plain = sf.stripe_score_plain(at, bt, sc, St)
    mode = sf._mode(sc, St)
    for shape in ((T, R, C), (None, None, None),
                  *((256, R_, C_) for R_, C_ in sf.RB_FORM_TILES[mode])):
        got = sf._launch_rb(at, bt, sc, *shape, sub=St)
        torch.cuda.synchronize()
        assert torch.equal(got.best, plain.best), shape
        assert torch.equal(got.right_col, plain.right_col), shape


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["affine", "sub_affine", "sub_linear"])
def test_score_routes_each_form_to_its_rb_kernel_on_card(card, form):
    sc, S = FORMS[form]
    a, b = (_protein(300, 2000, 41) if S is not None
            else random_pair(300, 2000, seed=41))
    at, bt = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    St = None if S is None else torch.from_numpy(S).to(card)
    sf.reset_counts()
    got = sf.stripe_score(at, bt, sc, substitution=St)
    banded = sf.stripe_score(at, bt, sc, substitution=St, band=16)
    assert torch.equal(got.best, sf.stripe_score_plain(at, bt, sc, St).best)
    assert torch.equal(banded.best,
                       sf.stripe_score_plain(at, bt, sc, St, band=16).best)
    assert sf.launches[sf.score_kernel_name(sc, St)] == 1
    assert sf.launches[sf.kernel_name(sc, St, False)] == 0
    assert sf.launches[sf.score_kernel_name(sc, St, True)] == 1
    assert sf.launches[sf.kernel_name(sc, St, False, True)] == 0


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
    assert sf.launches[sf.RB_BAND_KERNELS["linear"]] == 1
    assert sf.launches[sf.SCORE_KERNEL + sf.BAND_SUFFIX] == 0
