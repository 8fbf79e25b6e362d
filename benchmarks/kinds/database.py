"""Traffic kind ``database``: ``score_many([query] * N, entries)``, call k
searching the query k mod Q of a fixed order against every entry of the
configuration's database.

Configuration keys: ``queries`` [[name, length], ...], ``database_entries``,
``length_model`` (a lognormal's ``mean`` and ``sigma``, clipped to
[``min``, ``max``]), ``homologs`` (``identity``: the planted copies of each
query), ``composition_percent``. Mix key: ``sample_entries`` (how many
entries the check draws from the seed, besides every homolog).

The order takes the queries by length from both ends in turn (longest,
shortest, second longest, ...), so that the part of a cycle a window ends
in asks about as much a call as a whole cycle. The entries' lengths are
the length model's quantiles (k + 0.5) / N, the same for every seed, in a
seeded order.
"""

from __future__ import annotations

import statistics

import numpy as np

from benchmarks.harness.traffic import Workload
from benchmarks.reference import sw


class Kind(Workload):

    def __init__(self, config, mix, seed, device, api):
        super().__init__(config, mix, seed, device, api)
        self.queries = [self.letters(ln) for _, ln in config["queries"]]
        by_len = sorted(range(len(self.queries)),
                        key=lambda q: len(self.queries[q]))
        self.order = [by_len[-1 - i // 2] if i % 2 == 0 else by_len[i // 2]
                      for i in range(len(by_len))]
        lm = config["length_model"]
        ident = config["homologs"]["identity"]
        n_hom = len(ident) * len(self.queries)
        n_rand = config["database_entries"] - n_hom
        nd = statistics.NormalDist(0.0, lm["sigma"])
        mu = np.log(lm["mean"]) - lm["sigma"] ** 2 / 2
        lens = [int(np.clip(round(np.exp(mu + nd.inv_cdf((k + 0.5) / n_rand))),
                            lm["min"], lm["max"])) for k in range(n_rand)]
        entries = np.split(self.letters(sum(lens)), np.cumsum(lens)[:-1])
        homologs = []
        for q in range(len(self.queries)):
            for idt in ident:
                h = self.queries[q].copy()
                sub = self.rng.random(len(h)) >= idt
                h[sub] = self.letters(int(sub.sum()))
                homologs.append(h)
        entries += homologs
        order = self.rng.permutation(len(entries))
        self.entries = [entries[i] for i in order]
        where = np.argsort(order)
        self.homolog_idx = sorted(int(where[n_rand + h]) for h in range(n_hom))
        N = len(self.entries)
        pick = self.rng.choice(N, size=min(N, mix["sample_entries"]),
                               replace=False)
        self.sample = np.array(sorted(set(pick.tolist())
                                      | set(self.homolog_idx)))
        self.lens = np.array([len(e) for e in self.entries])
        self.pairs = [[q] * N for q in self.queries]

    @property
    def distinct(self):
        return len(self.queries)

    def warm(self):
        for k in range(len(self.queries)):
            self.call(k)

    def call(self, k):
        q = self.order[k % len(self.queries)]
        hits = self.api.score_many(self.pairs[q], self.entries,
                                   self.prog_scoring,
                                   substitution=self.table,
                                   device=self.device)
        return np.stack([x.cpu().numpy() for x in hits], 1)

    def cells(self, k):
        return len(self.queries[self.order[k % len(self.queries)]]) \
            * int(self.lens.sum())

    def nbytes(self, k):
        q = len(self.queries[self.order[k % len(self.queries)]])
        return q + int(self.lens.sum()) + 12 * len(self.entries)

    def scores(self, ans):
        return ans[:, 0]

    def highest_possible(self):
        """A query's score against any entry at all, Swiss-Prot's own copy
        of the query included, is at most its letters' best scores."""
        return max(self.ceiling(q) for q in self.queries)

    def _reference(self, qs: list, device, cap=None) -> dict:
        got = sw.database([self.queries[q] for q in qs],
                          [self.entries[e] for e in self.sample],
                          self.scoring, self.table, cap, device)
        return dict(zip(qs, got))

    def check(self, done, device):
        Q = len(self.queries)
        ref = self._reference(sorted({self.order[k % Q] for k, _ in done}),
                              device)
        score = end = 0
        for k, ans in done:
            a, r = ans[self.sample], ref[self.order[k % Q]]
            score += int((a[:, 0] != r[:, 0]).sum())
            end += int((a[:, 1:] != r[:, 1:]).any(1).sum())
        return [("score_wrong", score, 0), ("end_wrong", end, 0)]

    def control(self, ks, device, cap):
        Q = len(self.queries)
        ref = self._reference(sorted({self.order[k % Q] for k in ks}),
                              device, cap)
        out = []
        for k in ks:
            ans = np.zeros((len(self.entries), 3), np.int64)
            ans[self.sample] = ref[self.order[k % Q]]
            out.append((k, ans))
        return out
