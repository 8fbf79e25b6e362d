"""Traffic kind ``pairs``: ``align()`` on a pool of pairs made from the
seed, call k the pool's pair k mod the mix's ``pool``.

Mix keys: ``size`` [m, n] (a's and b's letters), ``pool``, ``traceback``
(false: the score-only path that ``score()`` wraps, which also returns
the end cell and the last cell). Letters come from the configuration's
alphabet (``Workload.letters``); a configuration with a ``substitution``
table scores with it.
"""

from __future__ import annotations

import numpy as np

from benchmarks.harness.traffic import Workload, count
from benchmarks.reference import alignment, sw


class Kind(Workload):

    def __init__(self, config, mix, seed, device, api):
        super().__init__(config, mix, seed, device, api)
        m, n = mix["size"]
        self.pool = [(self.letters(m), self.letters(n))
                     for _ in range(mix["pool"])]
        self.tb = bool(mix["traceback"])

    @property
    def distinct(self):
        return len(self.pool)

    def warm(self):
        for k in range(len(self.pool)):
            self.call(k)

    def call(self, k):
        a, b = self.pool[k % len(self.pool)]
        r = self.api.align(a, b, self.prog_scoring, traceback=self.tb,
                           substitution=self.table,
                           alphabet=self.config["alphabet"],
                           device=self.device)
        return (r.max_score, r.max_i, r.max_j, r.last_cell,
                r.aligned_a, r.aligned_b)

    def cells(self, k):
        a, b = self.pool[k % len(self.pool)]
        return len(a) * len(b)

    def nbytes(self, k):
        a, b = self.pool[k % len(self.pool)]
        return len(a) + len(b) + 16

    def scores(self, ans):
        return np.array([ans[0]])

    def highest_possible(self):
        return max(self.ceiling(a, b) for a, b in self.pool)

    def _reference(self, ps: list, device, cap=None) -> dict:
        """{pool index: (score, i, j, last)}, pairs of one shape at once."""
        out = {}
        by_shape: dict = {}
        for p in ps:
            a, b = self.pool[p]
            by_shape.setdefault((len(a), len(b)), []).append(p)
        for idx in by_shape.values():
            got = sw.pairs(np.stack([self.pool[p][0] for p in idx]),
                           np.stack([self.pool[p][1] for p in idx]),
                           self.scoring, self.table, cap, device)
            out.update({p: tuple(int(x) for x in g) for p, g in zip(idx, got)})
        return out

    def check(self, done, device):
        P = len(self.pool)
        ref = self._reference(sorted({k % P for k, _ in done}), device)
        rows = [(ans, ref[k % P], k % P) for k, ans in done]
        checks = [
            ("score_wrong", count(a[0] != r[0] for a, r, _ in rows), 0),
            ("end_wrong", count((a[1], a[2]) != (r[1], r[2])
                                for a, r, _ in rows), 0),
            ("last_wrong", count(a[3] != r[3] for a, r, _ in rows), 0)]
        if self.tb:
            seen: dict = {}
            bad = 0
            for ans, r, p in rows:
                key = (p, ans)
                if key not in seen:
                    a, b = self.pool[p]
                    seen[key] = alignment.check(
                        a, b, self.config["alphabet"], self.scoring, r[0],
                        r[1], r[2], ans[4], ans[5], self.table)
                bad += not seen[key]
            checks.append(("strings_wrong", bad, 0))
        return checks

    def control(self, ks, device, cap):
        P = len(self.pool)
        ref = self._reference(sorted({k % P for k in ks}), device, cap)
        return [(k, ref[k % P] + (None, None)) for k in ks]
