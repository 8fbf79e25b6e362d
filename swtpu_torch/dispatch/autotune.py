"""Autotuning on the card: sweeps of the kernels' shapes and of the host
tiers' crossovers, a table of the score-only winners stamped with the
device, and the ``Policy`` that reads it.

Counterpart of ``swtpu.dispatch.autotune`` over the port's own grid:

* ``sweep`` times the score-only path of ``score()`` on the card (the
  codes to the card, one launch of the register-blocked K1-K3, one fetch,
  ``engine.align.stripe_call``) at each threads-per-block T times each
  (R, C) tile the scoring's form instantiates (``RB_FORM_TILES``), and at
  the kernels' default shape, by CUDA events, the fastest of k after a
  warm-up, in two rounds over the whole grid. An entry names a winner
  only where the fastest shape beat the default by more than the largest
  difference between the two rounds of any shape at that size (the
  sweep's own spread); else its ``best`` is None and the defaults stand;
* ``sweep_batch`` times the batch kernels the same way and returns the
  rows, which the table does not keep (no route reads them): K8 (the
  register-blocked pair grid, B pairs of m x n) over T x its form's tiles,
  and K6 (B reads of qlen against one window of W) on the route a card
  takes for those reads and on the register-blocked shared-window form
  over T x its tiles;
* ``host_crossover`` times the host tiers against the card per square:
  ``align(plan='host')`` (the native fill, the host walk and the strings)
  against ``align(plan='stripe')`` (K4, the copy of P, the same walk),
  and the SIMD fill against score-only ``score(plan='stripe')``; its
  readings are where ``core.config.HOST_MAX_CELLS`` and
  ``HOST_SIMD_MAX_CELLS`` come from;
* ``card_floor_s`` is the card's per-call floor, printed beside the
  host's one-core SIMD rate as a check on those crossovers;
* ``save``/``load`` keep a table as JSON, stamped with the card's name,
  compute capability and the torch and CUDA versions; ``load`` refuses a
  table whose card is not this process's (``stamp_matches``), so a table
  tuned on one card never steers another, and the defaults then apply;
* ``Policy`` picks the nearest entry of the same scoring signature.

``python -m swtpu_torch.dispatch.autotune`` runs the sweeps on the card
and writes the table (default ``dispatch/tuned_h100.json``, the one
``dispatch.plan`` loads).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.config import EngineConfig, Scoring
from ..instrument.metrics import gcups

# the committed table of this package, the one dispatch.plan loads
DEFAULT_TABLE = Path(__file__).resolve().parent / "tuned_h100.json"
# the sweeps' grids: sizes (squares), threads per block, and the batch
# shapes (B pairs of m x n; B reads of qlen against one window of W)
SIZES = (512, 2048, 8192, 25632)
THREADS = (64, 128, 256, 512)
PAIR_SHAPES = ((64, 1056, 1056),)
WINDOW_SHAPES = ((2048, 152, 32768),)
# host_crossover's squares: the serial fill's, and the SIMD fill's
HOST_SIZES = (32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
SIMD_SIZES = (64, 128, 256, 512, 768, 1024, 1536, 2048, 2560, 2880, 3072,
              4096)
# the card's per-call floor: the fastest of this many warm score-only
# score() calls of this square on the card
FLOOR_PROBE_N = 64
FLOOR_PROBE_CALLS = 5


def scoring_sig(scoring: Optional[Scoring] = None, substitution=None) -> str:
    """The scoring signature that keys a table's entries: 'linear' or
    'affine', plus '+sub<A>' for an A-letter table. Winners differ by
    form, so an entry serves only calls of its own signature."""
    base = "affine" if scoring is not None and scoring.is_affine \
        else "linear"
    if substitution is None:
        return base
    return f"{base}+sub{np.asarray(substitution).shape[0]}"


def device_stamp() -> Optional[dict]:
    """The card this process runs on, as a table is stamped with it, or
    None without a card."""
    if not torch.cuda.is_available():
        return None
    major, minor = torch.cuda.get_device_capability(0)
    return {"name": torch.cuda.get_device_name(0),
            "capability": f"{major}.{minor}", "torch": torch.__version__,
            "cuda": torch.version.cuda}


def stamp_matches(table: Optional[dict],
                  stamp: Optional[dict] = None) -> bool:
    """Was ``table`` tuned on the card of ``stamp`` (default: this
    process's)? Its name and compute capability must be equal; a table
    with no stamp, or a process with no card, matches nothing."""
    stamp = device_stamp() if stamp is None else stamp
    got = (table or {}).get("device") or {}
    return bool(stamp) and all(
        got.get(k) == stamp.get(k) for k in ("name", "capability"))


def _require_card(what: str) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(f"autotune.{what} measures the card, and there "
                           "is no CUDA device")
    return torch.device("cuda")


def _events_s(fn, k: int) -> float:
    """The fastest of k runs of ``fn`` in seconds, by CUDA events, after
    one warm-up run."""
    fn()
    best = float("inf")
    for _ in range(k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / 1e3)
    return best


def _wall_s(fn, k: int) -> float:
    """The fastest of k runs of ``fn`` by the host clock, after a warm-up;
    ``fn`` ends in a fetch or a host result."""
    fn()
    best = float("inf")
    for _ in range(k):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _inputs(m: int, n: int, substitution, seed: int = 0) -> tuple:
    """A seeded pair of codes: DNA, or over the table's alphabet."""
    A = 4 if substitution is None else np.asarray(substitution).shape[0]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, A, m).astype(np.int8),
            rng.integers(0, A, n).astype(np.int8))


def _row(plan: str, T, R, C, seconds: float, cells: int, kind: str,
         **extra) -> dict:
    return {"plan": plan, "T": T, "R": R, "C": C, "s": seconds,
            "gcups": gcups(cells, seconds), "kind": kind, **extra}


def _grid(n: int, mode: str, A: int, kind: str, threads) -> list:
    """The distinct (T, R, C) that ``rb_shape`` launches over n rows for
    each T of ``threads`` and each tile of the form."""
    from ..kernels.stripe_fill import RB_FORM_TILES, rb_shape
    out = []
    for T, (R, C) in itertools.product(threads, RB_FORM_TILES[mode]):
        shape = rb_shape(n, T, R, C, mode, A, kind)
        if shape not in out:
            out.append(shape)
    return out


def sweep(sizes=SIZES, threads=THREADS, scoring: Scoring = Scoring(),
          substitution=None, k: int = 5, rounds: int = 2,
          verbose: bool = True) -> dict:
    """Time score-only ``score()``'s card path at every (T, R, C) of the
    grid and at the default shape for each size (a square side, or an (m,
    n) pair), the fastest of k in each of ``rounds`` rounds over the grid;
    returns a table of one entry per size in ``scoring``'s signature: the
    default's row, the spread (the largest relative difference between
    the rounds of one shape), every row, and ``best``, the fastest row
    where it beat the default by more than the spread, else None. Raises
    RuntimeError without a card."""
    from ..engine.align import stripe_call
    from ..kernels.stripe_fill import _mode, rb_shape
    dev = _require_card("sweep")
    sig = scoring_sig(scoring, substitution)
    mode = _mode(scoring, substitution)
    A = 0 if substitution is None else np.asarray(substitution).shape[0]
    sub = None if substitution is None else np.asarray(substitution,
                                                       np.int32)
    table = {"device": device_stamp(), "entries": []}
    for s in sizes:
        m, n = (s, s) if isinstance(s, int) else (int(s[0]), int(s[1]))
        a, b = _inputs(m, n, substitution)
        default = rb_shape(n, None, None, None, mode, A, "score")
        grid = _grid(n, mode, A, "score", threads)
        if default not in grid:
            grid.append(default)
        times = {shape: [] for shape in grid}
        for _ in range(rounds):
            for T, R, C in grid:
                times[(T, R, C)].append(_events_s(
                    lambda: stripe_call(a, b, scoring, sub, dev, T=T, R=R,
                                        C=C), k))
        rows = [_row("stripe", T, R, C, min(ts), m * n, "sweep",
                     rounds=ts) for (T, R, C), ts in times.items()]
        spread = max(max(ts) / min(ts) - 1 for ts in times.values())
        fastest = min(rows, key=lambda r: r["s"])
        base = rows[grid.index(default)]
        won = base["s"] / fastest["s"] - 1 > spread
        table["entries"].append({"m": m, "n": n, "sig": sig,
                                 "best": fastest if won else None,
                                 "default": base, "spread": spread,
                                 "all": rows})
        if verbose:
            print(f"score {m}x{n} [{sig}]: fastest T={fastest['T']} "
                  f"R={fastest['R']} C={fastest['C']} "
                  f"{fastest['s'] * 1e3:.3f} ms, the default "
                  f"({base['T']}, {base['R']}, {base['C']}) "
                  f"{base['s'] * 1e3:.3f} ms, spread {spread * 100:.1f} % "
                  f"over {len(rows)} shapes x {rounds} rounds: "
                  + ("tuned" if won else "the default stands"), flush=True)
    return table


def sweep_batch(pairs=PAIR_SHAPES, windows=WINDOW_SHAPES, threads=THREADS,
                scoring: Scoring = Scoring(), substitution=None, k: int = 5,
                verbose: bool = True) -> list:
    """Time K8 at ``pairs`` (B, m, n) over T x its form's tiles, and K6 at
    ``windows`` (B, qlen, W) on the card's route for those reads and on
    the register-blocked form over T x its tiles; returns one record a
    shape, {'kernel', 'B', 'm', 'n', 'sig', 'best', 'all'} (for K6 m is
    qlen and n is W). The table keeps none of it: the batch routes take
    their defaults. Raises RuntimeError without a card."""
    from ..kernels import pairs_fill as pf
    from ..kernels import window_fill as wf
    from ..kernels.stripe_fill import _mode
    dev = _require_card("sweep_batch")
    sig = scoring_sig(scoring, substitution)
    mode = _mode(scoring, substitution)
    A = 0 if substitution is None else np.asarray(substitution).shape[0]
    sub = (None if substitution is None else
           torch.from_numpy(np.asarray(substitution, np.int32)).to(dev))
    out = []
    for B, m, n in pairs:
        aa = torch.from_numpy(np.stack([_inputs(m, n, substitution, s)[0]
                                        for s in range(B)])).to(dev)
        bb = torch.from_numpy(np.stack([_inputs(m, n, substitution, s)[1]
                                        for s in range(B)])).to(dev)
        rows = []
        for T, R, C in _grid(n, mode, A, "pairs", threads):
            dt = _events_s(lambda: pf._launch_pairs_rb(
                aa, bb, scoring, T, R, C, sub), k)
            rows.append(_row("stripe", T, R, C, dt, B * m * n,
                             "sweep-pairs", B=B))
        best = min(rows, key=lambda r: r["s"])
        out.append({"kernel": "K8", "B": B, "m": m, "n": n, "sig": sig,
                    "best": best, "all": rows})
        if verbose:
            print(f"K8 {B}x{m}x{n} [{sig}]: best T={best['T']} "
                  f"R={best['R']} C={best['C']} {best['s'] * 1e3:.3f} ms of "
                  f"{len(rows)}", flush=True)
    for B, qlen, W in windows:
        rng = np.random.default_rng(1)
        A_ = 4 if substitution is None else A
        reads = torch.from_numpy(rng.integers(0, A_, (B, qlen)).astype(
            np.int8)).to(dev)
        win = torch.from_numpy(rng.integers(0, A_, W).astype(np.int8)).to(dev)
        route = wf.WindowScorer(reads, W, scoring, substitution=sub)
        dt = _events_s(lambda: route(win), k)
        rows = [_row(route.form, None, None, None, dt, B * qlen * W,
                     "sweep-window", B=B)]
        for T, R, C in _grid(qlen, mode, A, "window", threads):
            scorer = wf._RbWindow(reads, W, scoring, sub, T, R, C)
            dt = _events_s(lambda: scorer(win), k)
            rows.append(_row("rb", T, R, C, dt, B * qlen * W,
                             "sweep-window", B=B))
        best = min(rows, key=lambda r: r["s"])
        out.append({"kernel": "K6", "B": B, "m": qlen, "n": W, "sig": sig,
                    "best": best, "all": rows})
        if verbose:
            print(f"K6 {B}x{qlen} W={W} [{sig}]: best {best['plan']} "
                  f"T={best['T']} R={best['R']} C={best['C']} "
                  f"{best['s'] * 1e3:.3f} ms (the {route.form} route "
                  f"{rows[0]['s'] * 1e3:.3f} ms) of {len(rows)}", flush=True)
    return out


def host_crossover(host_sizes=HOST_SIZES, simd_sizes=SIMD_SIZES,
                   scoring: Scoring = Scoring(), substitution=None,
                   k: int = 5, verbose: bool = True) -> dict:
    """The host tiers against the card per square, the fastest of k host
    walls after a warm-up: ``align(plan='host')`` against
    ``align(plan='stripe')`` with traceback, and the SIMD fill
    (``runtime_native.score_simd_pos``) against score-only
    ``score(plan='stripe')``. Returns {'host': rows, 'simd': rows,
    'host_max_side', 'simd_max_side'}: the largest square below the first
    one where the host tier lost, 0 where it lost at the smallest. Raises
    RuntimeError without a card."""
    from .. import runtime_native as rn
    from ..engine.align import align
    dev = _require_card("host_crossover")
    sub = None if substitution is None else np.asarray(substitution,
                                                       np.int32)
    kw = dict(substitution=sub, device=dev)
    if substitution is not None:
        from ..core.encode import PROTEIN_ALPHABET
        kw["alphabet"] = PROTEIN_ALPHABET
    out = {"sig": scoring_sig(scoring, substitution), "host": [],
           "simd": []}
    for s in host_sizes:
        a, b = _inputs(s, s, substitution, s)
        host = _wall_s(lambda: align(a, b, scoring, plan="host", **kw), k)
        card = _wall_s(lambda: align(a, b, scoring, plan="stripe", **kw), k)
        out["host"].append({"side": s, "host_s": host, "card_s": card})
    if rn.simd_supported():
        cfg = EngineConfig(host_simd_max_cells=0)
        for s in simd_sizes:
            if not rn.simd_shape_ok(s, s, scoring, sub):
                continue
            a, b = _inputs(s, s, substitution, s)
            host = _wall_s(lambda: rn.score_simd_pos(a, b, scoring, sub), k)
            card = _wall_s(lambda: align(a, b, scoring, cfg, plan="stripe",
                                         traceback=False, **kw), k)
            out["simd"].append({"side": s, "host_s": host, "card_s": card})
    for tier in ("host", "simd"):
        side = 0
        for r in out[tier]:
            if r["host_s"] >= r["card_s"]:
                break
            side = r["side"]
        out[f"{tier}_max_side"] = side
        if verbose:
            print(f"{tier} tier [{out['sig']}] wins up to "
                  f"{out[f'{tier}_max_side']}^2: " + ", ".join(
                      f"{r['side']}^2 {r['host_s'] * 1e3:.3f}/"
                      f"{r['card_s'] * 1e3:.3f} ms" for r in out[tier]),
                  flush=True)
    return out


def card_floor_s(k: int = FLOOR_PROBE_CALLS) -> float:
    """The card's per-call floor in seconds: the fastest of k warm
    score-only ``score(plan='stripe')`` calls of a FLOOR_PROBE_N square,
    each with its one fetch, by the host clock. Raises RuntimeError
    without a card."""
    from ..engine.align import score
    dev = _require_card("card_floor_s")
    a, b = _inputs(FLOOR_PROBE_N, FLOOR_PROBE_N, None)
    return _wall_s(lambda: score(a, b, plan="stripe", device=dev), k)


def save(table: dict, path=DEFAULT_TABLE) -> None:
    Path(path).write_text(json.dumps(table, indent=1) + "\n")


def load(path=DEFAULT_TABLE, stamp: Optional[dict] = None) -> Optional[dict]:
    """The table at ``path``, or None when there is none or it was tuned
    on another card than ``stamp``'s (default: this process's)."""
    p = Path(path)
    if not p.exists():
        return None
    table = json.loads(p.read_text())
    return table if stamp_matches(table, stamp) else None


@dataclasses.dataclass
class Policy:
    """The table's reader: the winner of the nearest entry of a scoring
    signature."""

    table: Optional[dict] = None

    def choose_near(self, m: int, n: int, max_cells_ratio: float = 6.0,
                    max_aspect_ratio: float = 4.0,
                    sig: str = "linear") -> Optional[dict]:
        """The winner of the nearest entry of signature ``sig`` in (log
        cells, log aspect), or None when that entry has none (the defaults
        stand there) or no entry is within ``max_cells_ratio`` in cells
        and ``max_aspect_ratio`` in aspect: a T tuned at one size does not
        carry to a far one."""
        if not self.table or not self.table.get("entries"):
            return None
        cands = [e for e in self.table["entries"]
                 if e.get("sig", "linear") == sig]
        if not cands:
            return None
        cells, aspect = m * n, m / n

        def dist(e):
            return (abs(math.log(max(e["m"] * e["n"], 1) / cells)),
                    abs(math.log((e["m"] / e["n"]) / aspect)))

        entry = min(cands, key=lambda e: sum(dist(e)))
        dc, da = dist(entry)
        if dc > math.log(max_cells_ratio) or da > math.log(max_aspect_ratio):
            return None
        return None if entry.get("best") is None else dict(entry["best"])

    def choose(self, m: int, n: int, sig: str = "linear") -> dict:
        """``choose_near``'s row, else the kernels' defaults ('stripe',
        T, R and C None)."""
        got = self.choose_near(m, n, sig=sig)
        if got is not None:
            return got
        return {"plan": "stripe", "T": None, "R": None, "C": None}


# the scorings the table holds: DNA linear, DNA affine, BLOSUM62 protein
def _scorings() -> list:
    from ..core.substitution import BLOSUM62
    return [("linear", Scoring(), None),
            ("dna_affine", Scoring(mode="affine"), None),
            ("protein", Scoring(mode="affine", gap_open=-11, gap_extend=-1),
             BLOSUM62)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m swtpu_torch.dispatch.autotune",
        description="sweep the kernels' (T, R, C) and the host tiers' "
                    "crossovers on the card; write the stamped table")
    ap.add_argument("--out", default=str(DEFAULT_TABLE),
                    help="where to write the table (default: the one "
                         "dispatch.plan loads)")
    ap.add_argument("-k", type=int, default=5,
                    help="timed runs a point in each round, the fastest "
                         "kept")
    args = ap.parse_args(argv)
    _require_card("main")
    from .. import runtime_native as rn
    from ..kernels._native import cpu_model
    table = {"device": device_stamp(), "entries": []}
    cross = []
    for label, scoring, sub in _scorings():
        print(f"[{label}]", flush=True)
        # the table keeps each entry's decision and the default's row; the
        # rows of every shape are in the sweep's printed lines
        table["entries"] += [
            {k: v for k, v in e.items() if k != "all"}
            for e in sweep(scoring=scoring, substitution=sub,
                           k=args.k)["entries"]]
        sweep_batch(scoring=scoring, substitution=sub, k=args.k)
        cross.append(host_crossover(scoring=scoring, substitution=sub,
                                    k=args.k))
    rate, floor = rn.measured_simd_gcups() or 0.0, card_floor_s()
    host = min(c["host_max_side"] for c in cross)
    simd = min(c["simd_max_side"] for c in cross)
    print(f"host {cpu_model()}, {os.cpu_count()} cores: host tier wins up "
          f"to {host}^2 and the SIMD tier up to {simd}^2 in every scoring; "
          f"check: SIMD {rate:.3f} GCUPS a core x card floor "
          f"{floor * 1e6:.1f} us = {int(rate * 1e9 * floor)} cells",
          flush=True)
    save(table, args.out)
    won = sum(e["best"] is not None for e in table["entries"])
    print(f"wrote {len(table['entries'])} entries ({won} with a winner "
          f"over the defaults) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
