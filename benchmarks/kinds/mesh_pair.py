"""Traffic kind ``mesh_pair``: ``align(a, b, traceback=False, mesh=)`` of
one pair on a pipeline mesh over every rank of the world (the program's
``dist.mesh.pipeline_mesh``, built while warming), every rank making the
same call; rank 0's answer is the call's.

``a`` (m letters, the columns) is drawn from the seed; ``b`` (n letters,
the rows) is a copy of it with m - n letters deleted at places drawn from
the seed and a share ``substitutions`` of the rest substituted: a
stand-in for two related genomes. Mix keys: ``size`` [m, n],
``substitutions``, ``plan`` (``align``'s; null lets the program choose),
``reference`` (false: the answers are not checked).

The check runs the plain reference for one long pair
(``reference/rows.py``) once over the whole pair, on rank 0's device after
the other ranks have ended, and counts the calls whose score, end cell or
last cell differ from it, and those whose plan was not ``pipeline``.
Rank 0 writes the mesh, the block rows the program chooses and the first
warm call's plan and answer to standard error.
"""

import importlib
import sys

import numpy as np

from benchmarks.harness.traffic import Workload, count
from benchmarks.reference import rows


class Kind(Workload):
    distinct = 1

    def __init__(self, config, mix, seed, device, api):
        super().__init__(config, mix, seed, device, api)
        m, n = mix["size"]
        self.a = self.letters(m)
        b = self.a[np.sort(self.rng.choice(m, size=n, replace=False))]
        sub = np.flatnonzero(self.rng.random(n) < mix["substitutions"])
        A = len(config["alphabet"])
        b[sub] = (b[sub] + self.rng.integers(1, A, len(sub))) % A
        self.b = b
        self._ref: dict = {}

    def warm(self):
        prog = self.api.__name__
        mesh_mod = importlib.import_module(prog + ".dist.mesh")
        pl = importlib.import_module(prog + ".dist.pipeline")
        self.mesh = mesh_mod.pipeline_mesh(self.ranks, device=self.device)
        block_rows = pl.block_rows_for(len(self.a), len(self.b), self.mesh,
                                       "seq", self.prog_scoring)
        ans = self.call(0)
        if self.rank == 0:
            print(f"mesh_pair: {len(self.a)} x {len(self.b)} on "
                  f"{self.ranks} ranks ({self.mesh.backend}, "
                  f"{self.mesh.device}): block rows {block_rows}, plan "
                  f"{ans[4]}, score {ans[0]} at ({ans[1]}, {ans[2]}), last "
                  f"{ans[3]}", file=sys.stderr)

    def call(self, k):
        r = self.api.align(self.a, self.b, self.prog_scoring, traceback=False,
                           plan=self.mix["plan"], mesh=self.mesh)
        return (r.max_score, r.max_i, r.max_j, r.last_cell, r.plan)

    def cells(self, k):
        return len(self.a) * len(self.b)

    def nbytes(self, k):
        return len(self.a) + len(self.b) + 16

    def scores(self, ans):
        return np.array([ans[0]])

    def highest_possible(self):
        return self.ceiling(self.a, self.b)

    def _reference(self, device, cap=None) -> tuple:
        """The reference's (score, i, j, last), once for each ``cap``."""
        if cap not in self._ref:
            self._ref[cap] = rows.pair(self.a, self.b, self.scoring, cap,
                                       device)
        return self._ref[cap]

    def check(self, done, device):
        if not self.mix["reference"]:
            return []
        r = self._reference(device)
        return [("score_wrong", count(a[0] != r[0] for _, a in done), 0),
                ("end_wrong", count(a[1:3] != r[1:3] for _, a in done), 0),
                ("last_wrong", count(a[3] != r[3] for _, a in done), 0),
                ("plan_not_pipeline", count(a[4] != "pipeline"
                                            for _, a in done), 0)]

    def control(self, ks, device, cap):
        return [(k, self._reference(device, cap) + ("pipeline",)) for k in ks]
