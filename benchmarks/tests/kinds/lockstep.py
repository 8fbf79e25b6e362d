"""Test kind ``lockstep``: each call, the warm calls included, is one
``exchange`` of the program that the run names (the tests'
``rank_faults``): an all_gather of (tag, rank) over the world. Every rank
first logs the tag to ``<log>/rank<r>.log``. Warm call w has tag -1 - w,
call k tag k. Mix keys: ``warm`` (how many warm calls), ``cells`` (a
call's, for ``gcups``), ``log``, ``fault`` (``exchange``'s)."""

from pathlib import Path

from benchmarks.harness.traffic import Workload, count


class Kind(Workload):
    distinct = 1

    def warm(self):
        for w in range(self.mix["warm"]):
            self._step(-1 - w)

    def call(self, k):
        return self.rank, self._step(k)

    def _step(self, tag: int) -> list:
        with open(Path(self.mix["log"]) / f"rank{self.rank}.log", "a") as f:
            f.write(f"{tag}\n")
        return self.api.exchange(tag, self.rank, self.device,
                                 self.mix.get("fault"))

    def cells(self, k):
        return self.mix["cells"]

    def nbytes(self, k):
        return 0

    def check(self, done, device):
        want = [[[k, r] for r in range(self.ranks)] for k, _ in done]
        return [("out_of_step", count(ans[1] != w
                                      for (_, ans), w in zip(done, want)), 0),
                ("not_rank_0", count(ans[0] != 0 for _, ans in done), 0)]
