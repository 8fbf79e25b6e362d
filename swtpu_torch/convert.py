"""Carry the JAX package's run state into the port.

Smith-Waterman has no weights: the state a run depends on is the scoring
model, its substitution table, and the engine configuration.
``scoring_from_jax`` and ``config_from_jax`` read the first and the last
by field name, from the JAX package's dataclasses or from a plain mapping
of Python or numpy values, and return the port's dataclasses;
``substitution_from_jax`` takes a table as numpy. None of them imports JAX
or ``swtpu``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np

from .core.config import EngineConfig, Scoring
from .core.substitution import check_table

# EngineConfig fields of the JAX package that describe the TPU and its host
# link, not the problem; dropped on the way in.
TPU_ONLY_FIELDS = frozenset({"tpu_full_p_fetch_max_cells"})


def _fields(obj: Any) -> dict:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, Mapping):
        return dict(obj)
    raise TypeError(f"expected a dataclass or a mapping, got {type(obj)!r}")


def _plain(v: Any) -> Any:
    return v.item() if isinstance(v, (np.generic, np.ndarray)) else v


def _convert(obj: Any, cls: type, dropped: frozenset):
    got = _fields(obj)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(got) - names - dropped
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    return cls(**{k: _plain(v) for k, v in got.items() if k in names})


def scoring_from_jax(obj: Any) -> Scoring:
    """The port's ``Scoring`` from ``swtpu.Scoring`` or a mapping."""
    return _convert(obj, Scoring, frozenset())


def config_from_jax(obj: Any) -> EngineConfig:
    """The port's ``EngineConfig`` from ``swtpu.EngineConfig`` or a
    mapping; the fields in ``TPU_ONLY_FIELDS`` are dropped."""
    return _convert(obj, EngineConfig, TPU_ONLY_FIELDS)


def substitution_from_jax(table: Any) -> np.ndarray:
    """The port's (A, A) int32 table from the JAX package's substitution
    table (such as ``swtpu.core.substitution.BLOSUM62``) given as numpy.
    Raises ValueError unless it is square, integer and within +-2^20."""
    return check_table(table)
