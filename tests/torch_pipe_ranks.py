"""Rank-side helper of ``tests/test_torch_pipeline.py``'s projected cases:
each spawned gloo rank on the CPU runs as if it held its own card of the
committed pipeline cost record, so that the pipeline's block rows come
from ``dispatch.plan.pipeline_projection`` (on the CPU the gate counts one
card and projects nothing). Imports nothing of JAX."""

from swtpu_torch.dispatch import autotune, cost
from swtpu_torch.dispatch import plan as dp
from swtpu_torch.dist import dryrun
from swtpu_torch.dist import pipeline as pl
from swtpu_torch.kernels import stripe_fill as sf


def _own_cards(mesh=None, axis=None) -> int:
    """Every rank of the mesh its own card: the axis' size."""
    return mesh.shape[axis or mesh.axis_names[0]] if mesh is not None else 1


def _as_cards(stamp: dict) -> None:
    """This process stamped as the record's card (``stamp``), each rank of
    a mesh counted as a card of its own."""
    autotune.device_stamp = lambda: dict(stamp)
    dp.pipeline_devices = pl.pipeline_devices = _own_cards
    cost._record_cache.clear()


def _projected(*a, **kw):
    return dp.ExecPlan("pipeline", source="projected")


def run_projected(calls: list, stamp: dict) -> list:
    """``dryrun.run_calls`` of each (forced, call) of ``calls`` with this
    process stamped as the record's card (``stamp``) and each rank
    counted as a card of its own; where ``forced``, ``choose_exec``
    answers the projected pipeline, so an 'auto' call takes the route the
    profit gate opens on cards. Each result is (the call's answer, the
    plain block fills this rank ran)."""
    from swtpu_torch.engine import align as ealign
    _as_cards(stamp)
    real = ealign.choose_exec
    out = []
    for forced, call in calls:
        ealign.choose_exec = _projected if forced else real
        before = sf.plain_calls["stripe_block_plain"]
        got = dryrun.run_calls([call])[0]
        out.append((got, sf.plain_calls["stripe_block_plain"] - before))
    ealign.choose_exec = real
    return out


def run_disagreeing(stamp: dict, pairs: list, other_rows: int) -> list:
    """Three calls on a mesh of every rank, each rank a card of the record
    (``stamp``), where the ranks' inputs or records differ; each result
    is (the answer, the plain block fills this rank ran):

    * 'sizes': ``align(mesh=)`` 'auto', rank r on ``pairs[r]`` (sizes
      differ, one may be empty), ``choose_exec`` answering the projected
      pipeline on every rank;
    * 'verdicts': ``align(mesh=)`` 'auto', every rank on ``pairs[0]``,
      ``choose_exec`` answering the projected pipeline on every rank but
      rank 1, whose gate stays shut;
    * 'rows': ``align(mesh=, plan='pipeline')``, every rank on
      ``pairs[0]``, rank 1 projecting ``other_rows`` rows a block where
      the others project the record's."""
    import torch.distributed as dist
    from swtpu_torch.engine import align as ealign
    _as_cards(stamp)
    r = dist.get_rank()
    real, real_proj = ealign.choose_exec, pl.pipeline_projection
    mesh = dryrun.rank_mesh("seq", dist.get_world_size())
    out = []
    for what in ("sizes", "verdicts", "rows"):
        a, b = pairs[r] if what == "sizes" else pairs[0]
        ealign.choose_exec = real if what == "verdicts" and r == 1 \
            else _projected
        if what == "rows" and r == 1:
            pl.pipeline_projection = lambda *a, **kw: (2.0, other_rows)
        kw = dict(plan="pipeline") if what == "rows" else {}
        before = sf.plain_calls["stripe_block_plain"]
        got = ealign.align(a, b, traceback=False, mesh=mesh, **kw)
        out.append((dryrun.to_numpy(got),
                    sf.plain_calls["stripe_block_plain"] - before))
        ealign.choose_exec, pl.pipeline_projection = real, real_proj
    return out
