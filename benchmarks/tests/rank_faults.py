"""A stand-in for the program in the runner's tests on several ranks, with
faults planted by rank and call. Its one call, ``exchange``, is an
all_gather over the world of the call's tag and the rank."""

import os
import signal
import sys
import types

import torch
import torch.distributed as dist

from swtpu_torch import Scoring  # noqa: F401  the harness's Workload asks a program for it


def exchange(tag: int, rank: int, device, fault=None) -> list:
    """Every rank's [tag, rank], in rank order. ``fault`` [what, rank,
    tag] plants, on that rank at that call: 'raise' (raises before the
    exchange, so that its peers wait in it), 'raise_after' (raises after
    it), 'die' (the process killed before it) or 'jax' (a module named
    jax loaded)."""
    what = fault[0] if fault and fault[1:] == [rank, tag] else None
    if what == "raise":
        raise RuntimeError(f"planted: rank {rank} raises at call {tag}")
    if what == "die":
        os.kill(os.getpid(), signal.SIGKILL)
    if what == "jax":
        sys.modules["jax"] = types.ModuleType("jax")
    on = device if dist.get_backend() == "nccl" else "cpu"
    mine = torch.tensor([tag, rank], device=on)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    if what == "raise_after":
        raise RuntimeError(f"planted: rank {rank} raises after call {tag}")
    return [x.tolist() for x in out]
