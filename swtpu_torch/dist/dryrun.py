"""Run the multi-device layer on ranks of this machine.

Counterpart of ``swtpu.dist.pipeline.dryrun``, of
``__graft_entry__.dryrun_multichip`` and of the launcher of
``scripts/multihost_dryrun.py``:

    python -m swtpu_torch.dist.dryrun --nproc 1                 # NCCL, card
    python -m swtpu_torch.dist.dryrun --nproc 4 --backend gloo  # one card
    python -m swtpu_torch.dist.dryrun --nproc 4 --device cpu    # gloo, CPU

``launch`` spawns N ranks (``torch.multiprocessing``'s spawn method, a
``file://`` store in a temporary directory), each of which joins the
process group, runs a function and hands back its picklable result; the
ranks are killed when the time limit runs out. ``dryrun`` is the tiny
end-to-end step: the sharded batch scorer and the best-hit reducer, the
pipeline in linear, DNA affine and BLOSUM62 affine with its traceback and
its batch form, the checkpointed pipeline, and the sharded search, each
held against the port's numpy oracle. ``run_calls`` runs a list of
public calls on meshes of the given sizes and returns their results as
numpy, for tests that compare the ranks' answers with another
implementation's.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.config import Scoring
from . import mesh as mesh_mod

_STATE: dict = {}


def _rank_main(rank: int, world: int, init: str, device: str,
               backend: Optional[str], target, args: tuple, out: str,
               threads: int) -> None:
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        mesh_mod.initialize(init, world, rank, device, backend)
        _STATE.update(device=device, meshes={})
        result = ("ok", target(*args))
    except BaseException:                       # handed to the launcher
        result = ("error", traceback.format_exc())
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(nproc: int, target, args: tuple = (), device: str = "cuda",
           backend: Optional[str] = None, timeout: float = 120.0,
           threads: int = 1) -> list:
    """Run ``target(*args)`` on ``nproc`` new ranks of one process group
    (NCCL for 'cuda', gloo for 'cpu', unless ``backend`` names one) and
    return each rank's result, in rank order. ``target`` is a module-level
    function. Raises RuntimeError with a rank's traceback if one failed,
    and TimeoutError, after killing every rank, past ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="swtpu_torch_ranks_") as tmp:
        init = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nproc, init, device, backend, target,
                                   args, tmp, threads))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            if any(p.is_alive() for p in procs):
                raise TimeoutError(f"{nproc} ranks of {target.__name__} ran "
                                   f"past {timeout} s and were killed")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(nproc):
            path = Path(tmp) / f"rank{r}.pkl"
            if not path.exists():
                raise RuntimeError(f"rank {r} of {target.__name__} exited "
                                   f"with code {procs[r].exitcode} and no "
                                   "result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                raise RuntimeError(f"rank {r} of {target.__name__} failed:\n"
                                   f"{value}")
            results.append(value)
    return results


def rank_mesh(kind: str, n: int):
    """This rank's mesh of ``n`` ranks, built once a process: 'seq' a
    ``pipeline_mesh``, 'data' a ``data_mesh``, on the launch's device."""
    key = (kind, n)
    meshes = _STATE["meshes"]
    if key not in meshes:
        build = mesh_mod.pipeline_mesh if kind == "seq" \
            else mesh_mod.data_mesh
        meshes[key] = build(n, device=_STATE["device"])
    return meshes[key]


def to_numpy(x):
    """Tensors as numpy arrays, through named tuples, tuples, lists and
    dicts; dataclass records as dicts of their fields; anything else as
    it is."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x).__name__, {k: to_numpy(v)
                                  for k, v in zip(x._fields, x)}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return {k: to_numpy(getattr(x, k)) for k in x.__dataclass_fields__}
    return x


# ---------------------------------------------------------------------------
# the calls ``run_calls`` knows: name -> fn(mesh, **kw)

def _call_pipeline_align(mesh, a, b, **kw):
    from .pipeline import pipeline_align
    return pipeline_align(a, b, mesh, **kw)


def _call_nw_argmax(mesh, a, b, block_rows, scoring, substitution=None):
    from .pipeline import _pipeline_nw_argmax
    return _pipeline_nw_argmax(np.asarray(a, np.int8),
                               np.asarray(b, np.int8), mesh, block_rows,
                               scoring, mesh.axis_names[0], substitution)


def _call_pipeline_traceback(mesh, a, b, **kw):
    from .pipeline import pipeline_traceback
    got = pipeline_traceback(a, b, mesh, **kw)
    if got is None:
        return None
    score, loc, ra, rb = got
    return score, tuple(loc), ra, rb


def _call_pipeline_align_batch(mesh, aa, bb, **kw):
    from .pipeline import pipeline_align_batch
    return pipeline_align_batch(aa, bb, mesh, **kw)


def _call_checkpoint(mesh, a, b, block_rows, scoring, substitution=None,
                     stages_per_segment=2, path=None, stop_after=1):
    """The checkpointed pipeline: ``stop_after`` + 1 segments, a save, a
    fresh pipeline that loads the save and finishes; and the live
    pipeline on the same mesh. Returns (resumed, live)."""
    from .checkpoint import ResumablePipeline
    from .pipeline import make_pipeline
    m, n = len(a), len(b)
    kw = dict(scoring=scoring, stages_per_segment=stages_per_segment,
              substitution=substitution)
    rp = ResumablePipeline(mesh, m, n, block_rows, **kw)
    carry = rp.init()
    for seg in range(min(stop_after + 1, rp.num_segments)):
        carry = rp.segment(a, b, carry, seg)
    rp.save(carry, seg, path)
    rp2 = ResumablePipeline(mesh, m, n, block_rows, **kw)
    carry, seg = rp2.load(path)
    for seg in range(seg + 1, rp2.num_segments):
        carry = rp2.segment(a, b, carry, seg)
    resumed = rp2.finish(carry)
    live = make_pipeline(mesh, m, n, block_rows, scoring,
                         substitution=substitution)(a, b)
    return resumed, live


def _call_sharded_scorer(mesh, aa, bb, **kw):
    from .batch import make_sharded_batch_scorer
    return make_sharded_batch_scorer(mesh, **kw)(aa, bb)


def _call_best_hit(mesh, aa, bb, **kw):
    from .batch import make_best_hit_reducer
    return make_best_hit_reducer(mesh, **kw)(aa, bb)


def _call_batch_score(mesh, aa, bb, **kw):
    from .batch import batch_score
    return batch_score(aa, bb, mesh=mesh, **kw)


def _call_search(mesh, queries, reference, **kw):
    from .database import search
    return search(queries, reference, mesh=mesh, **kw)


def _call_map_reads(mesh, ref, reads, **kw):
    from .mapping import map_reads
    res = map_reads(ref, reads, mesh=mesh, **kw)
    return [tuple(r) for r in res.records]


def _call_align(mesh, a, b, **kw):
    from ..engine.align import align
    return align(a, b, mesh=mesh, **kw)


def _call_score(mesh, a, b, **kw):
    from ..engine.align import score
    return score(a, b, mesh=mesh, **kw)


def _call_align_world(mesh, a, b, **kw):
    """``align`` with no mesh on the mesh's device: the pipeline over the
    whole initialized group (``mesh.default_mesh``)."""
    from ..engine.align import align
    return align(a, b, device=mesh.device, **kw)


CALLS = {
    "pipeline_align": _call_pipeline_align,
    "nw_argmax": _call_nw_argmax,
    "pipeline_traceback": _call_pipeline_traceback,
    "pipeline_align_batch": _call_pipeline_align_batch,
    "checkpoint": _call_checkpoint,
    "sharded_scorer": _call_sharded_scorer,
    "best_hit": _call_best_hit,
    "batch_score": _call_batch_score,
    "search": _call_search,
    "map_reads": _call_map_reads,
    "align": _call_align,
    "score": _call_score,
    "align_world": _call_align_world,
}


def run_calls(calls: list) -> list:
    """Run each (mesh kind, ranks, call name, kwargs) of ``calls`` on this
    rank, every rank in the same order; a rank outside a call's mesh
    records None. Returns the results as numpy (``to_numpy``)."""
    out = []
    for kind, n, name, kw in calls:
        mesh = rank_mesh(kind, n)
        out.append(to_numpy(CALLS[name](mesh, **kw)) if mesh.member
                   else None)
    return out


# ---------------------------------------------------------------------------
# the dry run

def _check(got, want, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got} != {want}")


def dryrun() -> str:
    """The tiny multi-device step on this rank's meshes, each answer held
    against the numpy oracle; returns this rank's summary line."""
    from ..core import oracle
    from ..core.encode import random_batch, random_pair
    from ..core.substitution import BLOSUM62
    from .batch import make_best_hit_reducer, make_sharded_batch_scorer
    from .checkpoint import ResumablePipeline
    from .database import pad_queries, search
    from .pipeline import (pipeline_align, pipeline_align_batch,
                           pipeline_traceback)
    D = dist.get_world_size()
    data, seq = rank_mesh("data", D), rank_mesh("seq", D)

    B, m, n = 2 * D, 64, 48
    aa, bb = random_batch(B, m, n, seed=0)
    hits = make_sharded_batch_scorer(data)(aa, bb)
    want = [oracle.fill(aa[k], bb[k]) for k in range(B)]
    _check(hits.scores.tolist(), [w.max_score for w in want],
           "sharded scores")
    _check([list(x) for x in zip(hits.max_i.tolist(), hits.max_j.tolist())],
           [list(w.max_ij) for w in want], "sharded ends")
    best = make_best_hit_reducer(data)(aa, bb)
    k = int(np.argmax([w.max_score for w in want]))
    _check((int(best.score), int(best.pair), int(best.max_i),
            int(best.max_j)), (want[k].max_score, k, *want[k].max_ij),
           "best hit")

    m, n = 16 * max(D, 2), 32
    a, b = random_pair(m, n, seed=0)
    aff = Scoring(mode="affine", gap_open=-5, gap_extend=-1)
    prot = Scoring(gap=-4)
    rng = np.random.default_rng(7)
    pa = rng.integers(0, 20, m).astype(np.int8)
    pb = rng.integers(0, 20, 32).astype(np.int8)
    pb[4:20] = pa[8:24]
    for what, x, y, sc, sub in (("linear", a, b, Scoring(), None),
                                ("affine", a, b, aff, None),
                                ("blosum62", pa, pb, prot, BLOSUM62)):
        ref = oracle.fill(x, y, sc, sub=sub)
        res = pipeline_align(x, y, seq, block_rows=16, scoring=sc,
                             substitution=sub)
        _check((int(res.max_score), int(res.max_i), int(res.max_j),
                int(res.last_cell)),
               (ref.max_score, *ref.max_ij, int(ref.H[-1, -1])),
               f"pipeline {what}")
    got = pipeline_traceback(a, b, seq, block_rows=16)
    ref = oracle.fill(a, b)
    score, _, ra, rb = got
    s = sum(-2 if "-" in (x, y) else (3 if x == y else -3)
            for x, y in zip(ra, rb))
    _check((score, s), (ref.max_score, ref.max_score), "traceback")
    ab, bb2 = random_batch(2, m, 32, seed=5)
    resb = pipeline_align_batch(ab, bb2, seq, block_rows=16)
    _check(resb.scores.tolist(),
           [oracle.fill(ab[p], bb2[p]).max_score for p in range(2)],
           "batch pipeline")
    rp = ResumablePipeline(seq, m, n, 16, stages_per_segment=1)
    _check(int(rp.run(a, b).max_score), ref.max_score, "checkpointed")

    ref_codes = np.random.default_rng(0).integers(0, 4, 64 * D
                                                  ).astype(np.int8)
    reads = [ref_codes[5:21].copy(), ref_codes[40:56].copy()]
    for n_best in (1, 2):
        h = search(pad_queries(reads, 16), ref_codes, mesh=data, window=64,
                   n_best=n_best)
        _check(int(h.scores[0]), 48, f"search n_best={n_best}")
    return (f"rank {dist.get_rank()} of {D} on {data.device} "
            f"({data.backend}): DRYRUN_OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    for line in launch(args.nproc, dryrun, device=args.device,
                       backend=args.backend, timeout=args.timeout):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
