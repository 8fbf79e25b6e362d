"""The benchmark's one general generator of traffic.

A traffic mix is a data file, ``benchmarks/traffic/<name>.json``. Its
``kind`` names the workload that reads it, ``benchmarks/kinds/<kind>.py``
(its class ``Kind``), found by that name as a metric's reader is; its
other keys and the configuration's (``benchmarks/configs/<name>.json``)
are the workload's parameters. Every input is made from the seed, and
the sizes come from the mix and the configuration alone, so every seed
asks the same work of the card, in other letters and another order.

A workload makes its inputs, warms every shape its calls use, makes call
k (one public call of the program, the answer fetched to the host), says
what call k asks of the card (``work``), and after the window compares the
answers with the plain reference (``check``), which it runs itself on the
same inputs. ``control`` gives, for the same calls, the answers of the
reference at a saturating width in the program's place: the comparison
has to find them wrong at the width just below the configuration's
``precision``.

In a cell on several ranks every rank builds the same workload from the
seed on its own device; ``build`` tells it its ``rank`` and every rank's
device (``devices``; ``ranks`` their number) before it warms. A kind that
runs on one rank ignores them.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

from ..reference import sw
from .roofline import BITS, Work, instructions_per_cell

KINDS = Path(__file__).resolve().parents[1] / "kinds"


class Workload:
    """One cell's inputs and calls; see the module's docstring."""

    rank = 0
    devices: tuple = ()

    def __init__(self, config: dict, mix: dict, seed: int, device, api):
        self.config, self.mix, self.device, self.api = config, mix, device, api
        self.rng = np.random.default_rng(seed)
        self.scoring = sw.Scoring.of(config["scoring"])
        table = config.get("substitution")
        self.table = None if table is None else np.asarray(table, np.int32)
        self.bits = BITS[config["precision"]]
        self.instructions = instructions_per_cell(self.scoring.affine)
        comp = config.get("composition_percent")
        self.p = None if comp is None else np.array(
            [comp[c] for c in config["alphabet"]], float)
        if self.p is not None:
            self.p /= self.p.sum()
        if api is not None:
            self.prog_scoring = api.Scoring(**config["scoring"])

    def letters(self, n: int) -> np.ndarray:
        """``n`` letter codes from the seed: at the configuration's
        ``composition_percent`` where it gives one, else uniform over its
        alphabet."""
        if self.p is None:
            return self.rng.integers(0, len(self.config["alphabet"]),
                                     n).astype(np.int8)
        return self.rng.choice(len(self.p), size=n, p=self.p).astype(np.int8)

    def ceiling(self, a: np.ndarray, b: np.ndarray = None) -> int:
        """The highest score a local alignment of ``a`` (along the
        columns) can reach against ``b``, or against any sequence where
        ``b`` is None: each letter at its best score."""
        if self.table is None:
            top = max(self.scoring.match, 0)
            return top * (len(a) if b is None else min(len(a), len(b)))
        top_a = self.table.max(1)[a[a >= 0]].clip(0).sum()
        if b is None:
            return int(top_a)
        return int(min(top_a, self.table.max(0)[b[b >= 0]].clip(0).sum()))

    @property
    def ranks(self) -> int:
        return len(self.devices)

    def work(self, k: int) -> Work:
        """What call k asks of the card: its real cells at the
        configuration's width, and its bytes in and out."""
        return Work({self.bits: self.cells(k)}, self.instructions,
                    self.nbytes(k))

    # what a kind gives

    @property
    def distinct(self) -> int:
        """How many distinct inputs the calls cycle through."""
        raise NotImplementedError

    def warm(self) -> None:
        raise NotImplementedError

    def call(self, k: int):
        raise NotImplementedError

    def cells(self, k: int) -> int:
        """The DP cells call k asks for, as the user counts them."""
        raise NotImplementedError

    def nbytes(self, k: int) -> int:
        """Call k's inputs read once and outputs written once."""
        raise NotImplementedError

    def scores(self, ans) -> np.ndarray:
        """The scores in an answer."""
        raise NotImplementedError

    def highest_possible(self) -> int:
        """The highest score any call of the cell could answer."""
        raise NotImplementedError

    def check(self, done: list, device) -> list:
        """[(name, value, limit)] for the answers of ``done`` [(k,
        answer)], against the reference run on ``device``."""
        raise NotImplementedError

    def control(self, ks: list, device, cap) -> list:
        """[(k, answer)]: the reference at saturating width ``cap`` (None:
        the full width) in the program's place, for calls ``ks``."""
        raise NotImplementedError


def count(pred) -> int:
    """How many of ``pred`` are true."""
    return int(sum(1 for p in pred if p))


def kind(name: str) -> type:
    """The ``Kind`` of ``benchmarks/kinds/<name>.py``."""
    path = KINDS / f"{name}.py"
    if not path.exists():
        raise ValueError(f"no traffic kind {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        "benchmark_kind_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Kind


def build(config: dict, mix: dict, seed: int, device, api=None, rank: int = 0,
          devices: list = None) -> Workload:
    """The workload of a mix's ``kind`` on this configuration; ``api`` is
    the program's package (None: the inputs and the reference alone);
    ``rank`` and ``devices``: where it runs in a cell on several ranks
    (default: alone, on ``device``)."""
    wl = kind(mix["kind"])(config, mix, seed, device, api)
    wl.rank, wl.devices = rank, tuple(devices or (device,))
    return wl
