#!/usr/bin/env python3
"""Smoke run of the swtpu_torch main path on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Builds the CUDA kernels from ``swtpu_torch/csrc``, holds each against its
plain PyTorch version on the card, then drives the public ``align()`` and
``score()`` at the benchmark sizes, in three scorings (DNA linear 3/-3/-2,
DNA affine 3/-3 -4/-1, BLOSUM62 protein affine -11/-1), and checks the
answers against independent numpy row scans and the known values for those
seeded pairs. Each phase prints one line; any failure raises, so the exit
code is not 0. The line before the last is a JSON object describing each
kernel of the path (launches in the main-path run, exactness, kernel and
plain times); the last line is a JSON object naming the device.

Without a CUDA device it fails before printing any result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import swtpu_torch
from swtpu_torch import Scoring, random_pair
from swtpu_torch.core.encode import DNA_ALPHABET, PROTEIN_ALPHABET, decode
from swtpu_torch.core.substitution import BLOSUM62
from swtpu_torch.instrument.metrics import gcups
from swtpu_torch.kernels import _cuda
from swtpu_torch.kernels import stripe_fill as sf

SCORING = Scoring()               # linear 3/-3/-2, the benchmark's scoring
DNA_AFFINE = Scoring(mode="affine")                     # 3/-3, -4/-1
PROTEIN = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
PROTEIN_LINEAR = Scoring(gap=-6)
SCORE_N = 25632                   # the benchmark pair, score-only
ALIGN_N = 16384                   # full-P traceback: exactly 2^28 cells
THIN = (25632, 8192)              # score() swaps this pair (m > 2n)
# (max, i, j, last) of the seed-0 pairs: random_pair(m, n, seed=0) for DNA,
# protein_pair(n) for BLOSUM62
KNOWN = {("linear", SCORE_N, SCORE_N): (18276, 25632, 25624, 18273),
         ("linear", ALIGN_N, ALIGN_N): (11743, 16369, 16384, 11723),
         ("linear", *THIN): (6376, 8191, 25455, 6300),
         ("dna_affine", SCORE_N, SCORE_N): (12335, 25535, 25630, 12311),
         ("dna_affine", ALIGN_N, ALIGN_N): (7783, 16369, 16384, 7773),
         ("protein", SCORE_N, SCORE_N): (94, 24948, 18296, 2),
         ("protein", ALIGN_N, ALIGN_N): (77, 8114, 8809, 0)}
KERNEL_SOURCE = "swtpu_torch/csrc/stripe_fill.cu"
REPLACES = "swtpu/kernels/pallas_fill.py:1008"   # _stripe_call's pallas_call


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def protein_pair(n: int) -> tuple:
    """The JAX bench's protein pair: 20 letters from default_rng(0)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 20, n).astype(np.int8)
    b = rng.integers(0, 20, n).astype(np.int8)
    return a, b


# scoring name -> (Scoring, table, alphabet, pair maker)
MODELS = {
    "linear": (SCORING, None, DNA_ALPHABET,
               lambda m, n: random_pair(m, n, seed=0)),
    "dna_affine": (DNA_AFFINE, None, DNA_ALPHABET,
                   lambda m, n: random_pair(m, n, seed=0)),
    "protein": (PROTEIN, BLOSUM62, PROTEIN_ALPHABET,
                lambda m, n: protein_pair(n)),
}


def row_scan(a: np.ndarray, b: np.ndarray, sc: Scoring, S=None) -> tuple:
    """(max, i, j, last) by an independent numpy scan, one row at a time.

    Linear: X = max(0, DIAG, UP), then H[j] = max over k <= j of
    X[k] + gap*(j-k), a prefix max of X - gap*k. Affine: F from the row
    above, X = max(0, DIAG, F), then E[j] = open + ext*(j-1) + max over
    k < j of X[k] - ext*k (exact for gap_open <= gap_extend) and
    H = max(X, E). First row-major max by strict '>' over rows and
    argmax's first index within a row."""
    m = len(a)
    a64 = a.astype(np.int64)
    step = sc.gap_extend if sc.is_affine else sc.gap
    ramp = step * np.arange(m + 1, dtype=np.int64)
    prev = np.zeros(m + 1, np.int64)
    f = np.full(m + 1, -(1 << 30), np.int64)
    x = np.zeros(m + 1, np.int64)
    best = bi = bj = 0
    for i in range(1, len(b) + 1):
        s = (S[a64, b[i - 1]] if S is not None
             else np.where(a == b[i - 1], sc.match, sc.mismatch))
        if sc.is_affine:
            f = np.maximum(prev + sc.gap_open, f + sc.gap_extend)
            x[1:] = np.maximum(np.maximum(prev[:-1] + s, f[1:]), 0)
            h = x.copy()
            h[1:] = np.maximum(x[1:], np.maximum.accumulate(x - ramp)[:-1]
                               + sc.gap_open + ramp[:-1])
        else:
            x[1:] = np.maximum(np.maximum(prev[:-1] + s, prev[1:] + sc.gap), 0)
            h = np.maximum.accumulate(x - ramp) + ramp
        top = int(h.max())
        if top > best:
            best, bi, bj = top, i, int(h.argmax())
        prev = h
    return best, bi, bj, int(prev[m])


def rescore(sa: str, sb: str, sc: Scoring, S=None,
            alphabet: str = DNA_ALPHABET) -> int:
    """Re-score aligned strings under the model. A gap run continues only
    while the gap stays in the same sequence: gap_open for its first
    column, gap_extend for each further one (linear: gap for each)."""
    total, run = 0, None
    for x, y in zip(sa, sb):
        side = "a" if x == "-" else "b" if y == "-" else None
        if side is None:
            total += (int(S[alphabet.index(x), alphabet.index(y)])
                      if S is not None else
                      sc.match if x == y else sc.mismatch)
        elif not sc.is_affine:
            total += sc.gap
        else:
            total += sc.gap_extend if run == side else sc.gap_open
        run = side
    return total


def timed_ms(fn, reps: int) -> tuple:
    """(min ms over reps, last result) by CUDA events; one warm-up first
    when reps > 1."""
    if reps > 1:
        fn()
    best, out = float("inf"), None
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best, out


def diff(x: torch.Tensor, y: torch.Tensor) -> int:
    require(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
    return int((x.to(torch.int32) - y.to(torch.int32)).abs().max())


def on_card(*arrays, dev) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in arrays)


def build_line() -> str:
    """ptxas's registers and spills for each instantiation of the kernel
    template <kCaptureP, kAffine, kSub>."""
    out, name = [], None
    for ln in _cuda.BUILD.log.splitlines():
        got = re.search(r"stripe_kernelILb(\d)ELb(\d)ELb(\d)E", ln)
        if "Compiling entry function" in ln and got:
            p, aff, sub = (int(v) for v in got.groups())
            name = (f"{'fill_p' if p else 'score'}_"
                    f"{'sub_' if sub else ''}"
                    f"{'affine' if aff else 'linear'}")
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name} {regs} regs, {spill}")
            name = None
    return "; ".join(out)


def _small_cases() -> list:
    """(label, a, b, T, reps, protein) of the kernel-vs-plain phase."""
    rng = np.random.default_rng(7)
    two = rng.integers(0, 2, 2600).astype(np.int8)
    zeros = np.zeros(700, np.int8)
    pa, pb = protein_pair(2500)
    # sentinel codes in both sequences, around a shared segment
    sent_a, sent_b = pa[:400].copy(), pb[:1300].copy()
    sent_b[200:300] = sent_a[100:200]
    sent_a[[0, 55, 101]], sent_b[[3, 250, 1299]] = -1, -3
    sent_b[[10, 999]] = -2
    return [
        ("one stripe", *random_pair(60, 100, seed=1), None, 1, False),
        ("ragged, 10 stripes x3", *random_pair(300, 9 * 256 + 7, seed=2),
         256, 3, False),
        ("m<n", *random_pair(200, 1500, seed=3), 128, 1, False),
        ("m>n", *random_pair(1500, 200, seed=4), 64, 1, False),
        ("m=2", *random_pair(2, 700, seed=5), 64, 1, False),
        ("ties: two letters", two[:1200], two[1200:], 128, 1, False),
        ("ties: one letter", zeros, zeros[:650].copy(), 32, 1, False),
        ("ties: a = b", two[:900], two[:900].copy(), 256, 1, False),
        ("protein ragged, 10 stripes x3", pa[:300], pb[:9 * 256 + 7], 256,
         3, True),
        ("protein ties: two letters", two[:700], two[700:2000].copy(), 32,
         1, True),
        ("protein sentinels", sent_a, sent_b, 128, 1, True),
        ("protein T=1024", pa[:900], pb, 1024, 1, True),
        ("protein a = b", pa[:900], pa[:900].copy(), 1024, 1, True),
    ]


# kernel mode -> (score kernel, fill_p kernel, scorings, table)
MODES = {
    "linear": (sf.SCORE_KERNEL, sf.FILL_P_KERNEL, [SCORING], None),
    "dna_affine": (sf.SCORE_AFFINE_KERNEL, sf.FILL_P_AFFINE_KERNEL,
                   [DNA_AFFINE], None),
    # one kernel entry, both gap models
    "protein": (sf.SCORE_SUB_KERNEL, sf.FILL_P_SUB_KERNEL,
                [PROTEIN, PROTEIN_LINEAR], BLOSUM62),
}


def kernels_vs_plain(dev) -> dict:
    """Each kernel against its plain version; returns per-kernel records."""
    err = {k: 0 for k in sf.launches}
    table = on_card(BLOSUM62, dev=dev)[0]
    for label, a, b, T, reps, protein in _small_cases():
        at, bt = on_card(a, b, dev=dev)
        # DNA shapes run through the DNA kernels, protein shapes through
        # the substitution kernels (both gap models)
        for mode, (ks_name, kf_name, scorings, S) in MODES.items():
            if (S is not None) != protein:
                continue
            sub = None if S is None else table
            for sc in scorings:
                ps = sf.stripe_score_plain(at, bt, sc, sub)
                pf = sf.stripe_fill_plain(at, bt, sc, sub)
                runs = []
                for _ in range(reps):
                    ks = sf.stripe_score(at, bt, sc, T=T, substitution=sub)
                    kf = sf.stripe_fill(at, bt, sc, T=T, substitution=sub)
                    torch.cuda.synchronize()
                    e1 = max(diff(ks.best, ps.best),
                             diff(ks.right_col, ps.right_col))
                    e4 = max(diff(kf.best, pf.best),
                             diff(kf.right_col, pf.right_col),
                             diff(kf.P, pf.P))
                    err[ks_name] = max(err[ks_name], e1)
                    err[kf_name] = max(err[kf_name], e4)
                    require(e1 == 0 and e4 == 0,
                            f"{label} {mode} {sc.mode}: kernel != plain")
                    runs.append((ks.best.tolist(), kf.P.sum().item()))
                require(all(r == runs[0] for r in runs),
                        f"{label} {mode}: runs differ")
                phase("kernels", f"{label} [{mode} {sc.mode}] m={len(a)} "
                      f"n={len(b)} T={T}: {ps.best.tolist()} equal x{reps}")

    # the main path's shapes: kernel min of 3 after a warm-up, plain once
    recs = {}
    for mode, (ks_name, kf_name, scorings, S) in MODES.items():
        sc, sub = scorings[0], (None if S is None else table)
        make = MODELS[mode][3]
        at, bt = on_card(*make(SCORE_N, SCORE_N), dev=dev)
        k_ms, ks = timed_ms(
            lambda: sf.stripe_score(at, bt, sc, substitution=sub), 3)
        p_ms, ps = timed_ms(
            lambda: sf.stripe_score_plain(at, bt, sc, sub), 1)
        e = max(diff(ks.best, ps.best), diff(ks.right_col, ps.right_col))
        require(e == 0, f"{ks_name} != plain at the benchmark size")
        recs[ks_name] = dict(ms=k_ms, plain_ms=p_ms,
                             max_abs_err=max(e, err[ks_name]))
        phase("kernels", f"{ks_name} {SCORE_N}^2 [{mode}]: "
              f"{ks.best.tolist()} kernel {k_ms:.3f} ms "
              f"({gcups(SCORE_N ** 2, k_ms / 1e3):.2f} GCUPS), "
              f"plain {p_ms:.1f} ms, equal")
        del at, bt, ks, ps
        at, bt = on_card(*make(ALIGN_N, ALIGN_N), dev=dev)
        k_ms, kf = timed_ms(
            lambda: sf.stripe_fill(at, bt, sc, substitution=sub), 3)
        p_ms, pf = timed_ms(
            lambda: sf.stripe_fill_plain(at, bt, sc, sub), 1)
        e = max(diff(kf.best, pf.best), diff(kf.right_col, pf.right_col),
                diff(kf.P, pf.P))
        require(e == 0, f"{kf_name} != plain at the align size")
        recs[kf_name] = dict(ms=k_ms, plain_ms=p_ms,
                             max_abs_err=max(e, err[kf_name]))
        phase("kernels", f"{kf_name} {ALIGN_N}^2 [{mode}]: "
              f"{kf.best.tolist()} kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms, P bit-equal")
        del at, bt, kf, pf
        torch.cuda.empty_cache()
    return recs


def check_alignment(r, a, b, mode: str) -> None:
    """The walked strings re-score to the max and are substrings of the
    inputs ending at the max cell."""
    sc, S, alphabet, _ = MODELS[mode]
    require(rescore(r.aligned_a, r.aligned_b, sc, S, alphabet)
            == r.max_score,
            f"{mode}: aligned strings do not re-score to {r.max_score}")
    ua, ub = r.aligned_a.replace("-", ""), r.aligned_b.replace("-", "")
    require(decode(a[r.max_j - len(ua):r.max_j], alphabet) == ua
            and decode(b[r.max_i - len(ub):r.max_i], alphabet) == ub,
            f"{mode}: aligned strings are not the inputs' substrings")


def drive(mode: str, refs: dict) -> str:
    """The public calls at the main path's sizes in one scoring; returns
    the phase line."""
    sc, S, alphabet, make = MODELS[mode]
    kw = dict(substitution=S, alphabet=alphabet, device="cuda")
    a, b = make(SCORE_N, SCORE_N)
    ms, s = timed_ms(lambda: swtpu_torch.score(a, b, sc, **kw), 3)
    full = swtpu_torch.align(a, b, sc, traceback=False, **kw)
    got = (full.max_score, full.max_i, full.max_j, full.last_cell)
    want = refs[mode, SCORE_N, SCORE_N]
    require(s == got[0] and got == want,
            f"{mode} score {SCORE_N}^2: {s}, {got} != {want}")
    msg = (f"score {SCORE_N}^2 -> {got}; score() {ms / 1e3:.6f} s = "
           f"{gcups(SCORE_N ** 2, ms / 1e3):.2f} GCUPS (min of 3, CUDA "
           "events, host conversion and fetch included)")

    a, b = make(ALIGN_N, ALIGN_N)
    t0 = time.perf_counter()
    r = swtpu_torch.align(a, b, sc, **kw)
    wall = time.perf_counter() - t0
    got = (r.max_score, r.max_i, r.max_j, r.last_cell)
    want = refs[mode, ALIGN_N, ALIGN_N]
    require(got == want, f"{mode} align {ALIGN_N}^2: {got} != {want}")
    check_alignment(r, a, b, mode)
    return (f"{msg}; align {ALIGN_N}^2 full-P -> {got}, "
            f"{len(r.aligned_a)} columns re-score to {r.max_score}, "
            f"wall {wall:.3f} s")


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    phase("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    _cuda.library()
    phase("build", f"{_cuda.BUILD.path.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_cuda.BUILD.seconds:.2f} s;"
          f" {build_line()})")

    recs = kernels_vs_plain(dev)

    # independent references for the main path, on the host
    t0 = time.perf_counter()
    refs = {}
    for (mode, m, n), known in KNOWN.items():
        sc, S, _, make = MODELS[mode]
        refs[mode, m, n] = row_scan(*make(m, n), sc, S)
        require(refs[mode, m, n] == known, f"row scan {mode} {m}x{n} "
                f"{refs[mode, m, n]} != known {known}")
    phase("reference", f"numpy row scans of {len(refs)} pairs in "
          f"{time.perf_counter() - t0:.1f} s, equal to the known values "
          f"{refs}")

    # ---- the main path: public calls only, counted from zero ----
    sf.reset_counts()
    r = swtpu_torch.align(swtpu_torch.BUILTIN_A, swtpu_torch.BUILTIN_B,
                          device="cuda")
    require((r.max_score, r.max_pos, r.last_cell) == (13, 69, 7)
            and (r.aligned_a, r.aligned_b) == ("GTT-AC", "GTTGAC"),
            f"golden: {r}")
    require(sf.launches[sf.FILL_P_KERNEL] == 1, "golden did not run K4")
    phase("golden", f"13 @ 69, last 7, {r.aligned_a}/{r.aligned_b} via "
          f"{sf.FILL_P_KERNEL}")

    line = drive("linear", refs)
    m, n = THIN
    thin = swtpu_torch.score(*random_pair(m, n, seed=0), device="cuda")
    require(thin == refs["linear", *THIN][0], f"score {m}x{n}: {thin}")
    phase("linear", f"{line}; {m}x{n} transposed -> {thin}")
    for mode in ("dna_affine", "protein"):
        phase(mode, drive(mode, refs))

    launches = dict(sf.launches)
    plain = dict(sf.plain_calls)
    # ---- end of the main path ----
    require(all(v > 0 for v in launches.values()), f"launches {launches}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    phase("path", f"kernel launches {launches}, plain calls {plain}")

    kernels = [dict(name=k, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES, launches=launches[k], **recs[k])
               for k in sf.launches]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
