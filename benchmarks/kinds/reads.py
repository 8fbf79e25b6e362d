"""Traffic kind ``reads``: ``search()`` of a batch of reads against the
configuration's reference, call k the pool's batch k mod ``batches``.

Configuration key: ``reference_length`` (its letters drawn from the
seed). Mix keys: ``reads`` a call, ``read_length``, ``pad_to`` (the row
length the reads are passed in, padded with a code that matches nothing),
``substitutions`` a read, ``reverse_share`` (the reads taken from the
reverse strand), ``strand``, ``n_best`` and ``window`` (``search()``'s),
``batches`` and ``sample_reads`` (how many reads the check draws from the
seed). Reads are made as ``examples/read_mapping.py`` makes them: a
uniform start and substitutions to another letter; the reverse strand is
the DNA complement (code 3 - c) read backwards.
"""

from __future__ import annotations

import numpy as np

from benchmarks.harness.traffic import Workload
from benchmarks.reference import sw


class Kind(Workload):

    def __init__(self, config, mix, seed, device, api):
        super().__init__(config, mix, seed, device, api)
        L = config["reference_length"]
        A = len(config["alphabet"])
        self.ref = self.letters(L)
        R, ln = mix["reads"], mix["read_length"]
        self.batches = []
        for _ in range(mix["batches"]):
            pos = self.rng.integers(0, L - ln, R)
            r = self.ref[pos[:, None] + np.arange(ln)[None, :]]
            muts = self.rng.integers(0, ln, (R, mix["substitutions"]))
            rows = np.arange(R)[:, None]
            r[rows, muts] = (r[rows, muts] + self.rng.integers(
                1, A, muts.shape)) % A
            rev = self.rng.random(R) < mix["reverse_share"]
            r[rev] = (A - 1 - r[rev])[:, ::-1]
            q = np.full((R, mix["pad_to"]), -3, np.int8)
            q[:, :ln] = r
            self.batches.append(q)
        S = mix["sample_reads"]
        flat = self.rng.choice(len(self.batches) * R, size=S, replace=False)
        self.sample = sorted((int(f) // R, int(f) % R) for f in flat)

    @property
    def distinct(self):
        return len(self.batches)

    def warm(self):
        self.call(0)

    def call(self, k):
        mix = self.mix
        hits = self.api.search(self.batches[k % len(self.batches)], self.ref,
                               window=mix["window"], scoring=self.prog_scoring,
                               strand=mix["strand"], n_best=mix["n_best"],
                               device=self.device)
        return np.stack([x.cpu().numpy().astype(np.int64) for x in hits], 1)

    def cells(self, k):
        mix = self.mix
        strands = 2 if mix["strand"] == "both" else 1
        return mix["reads"] * mix["read_length"] * len(self.ref) * strands

    def nbytes(self, k):
        mix = self.mix
        return (mix["reads"] * mix["read_length"] + len(self.ref)
                + 13 * mix["reads"])

    def scores(self, ans):
        return ans[:, 0]

    def highest_possible(self):
        return max(self.ceiling(b[b >= 0]) for b in self.batches[0])

    def _reference(self, batches: set, device, cap=None) -> dict:
        """{(batch, read): (score, pos, read end, strand)} of the sample's
        reads in ``batches``."""
        keys = [(b, r) for b, r in self.sample if b in batches]
        if not keys:
            return {}
        reads = np.stack([self.batches[b][r] for b, r in keys])
        got = sw.search(reads, self.ref, self.scoring, self.mix["window"],
                        cap, device)
        return {key: g for key, g in zip(keys, got)}

    def check(self, done, device):
        nb = len(self.batches)
        ref = self._reference({k % nb for k, _ in done}, device)
        score = pos = strand = 0
        for k, ans in done:
            for (b, r), g in ref.items():
                if b != k % nb:
                    continue
                score += int(ans[r, 0] != g[0])
                pos += int((ans[r, 1], ans[r, 2]) != (g[1], g[2]))
                strand += int(ans[r, 3] != g[3])
        return [("score_wrong", score, 0), ("end_wrong", pos, 0),
                ("strand_wrong", strand, 0)]

    def control(self, ks, device, cap):
        nb = len(self.batches)
        ref = self._reference({k % nb for k in ks}, device, cap)
        out = []
        for k in ks:
            ans = np.zeros((self.mix["reads"], 4), np.int64)
            for (b, r), g in ref.items():
                if b == k % nb:
                    ans[r] = g
            out.append((k, ans))
        return out
