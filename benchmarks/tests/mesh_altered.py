"""A stand-in program for the ``mesh_pair`` kind's fault test: the port
itself, except that every answer of ``align`` is altered where it is made
(its score one higher), on every rank. Its ``dist`` is the port's own,
found under this module's name as the kind looks it up."""

import dataclasses
import sys

import swtpu_torch
from swtpu_torch import Scoring  # noqa: F401
from swtpu_torch.dist import mesh, pipeline

sys.modules[__name__ + ".dist"] = swtpu_torch.dist
sys.modules[__name__ + ".dist.mesh"] = mesh
sys.modules[__name__ + ".dist.pipeline"] = pipeline


def align(*args, **kw):
    r = swtpu_torch.align(*args, **kw)
    return dataclasses.replace(r, max_score=r.max_score + 1)
