"""Sequence encoding and input generation.

Sequences are int8 code arrays (A,C,G,T -> 0..3). Inputs are made with
numpy's ``default_rng(seed)``, the same generator and draw order as
``swtpu.core.encode``, so both packages see identical pairs for a seed.
"""

from __future__ import annotations

import numpy as np

DNA_ALPHABET = "ACGT"
# 20 amino acids + X, for the protein/BLOSUM path.
PROTEIN_ALPHABET = "ARNDCQEGHILKMFPSTWYVX"


def encode(seq: str, alphabet: str = DNA_ALPHABET) -> np.ndarray:
    """String -> int8 codes. Unknown characters raise."""
    lut = {c: i for i, c in enumerate(alphabet)}
    try:
        return np.array([lut[c] for c in seq], dtype=np.int8)
    except KeyError as e:
        raise ValueError(f"character {e} not in alphabet {alphabet!r}") from None


def unknown_letter(alphabet: str = DNA_ALPHABET) -> str:
    """The letter of a negative code (the unknown-base and padding
    sentinels): 'X' for an alphabet that carries one, else 'N'."""
    return "X" if "X" in alphabet else "N"


def decode(codes: np.ndarray, alphabet: str = DNA_ALPHABET) -> str:
    """Codes -> text. Negative codes (unknown-base and padding sentinels)
    render as ``unknown_letter`` ('N', or 'X' for protein alphabets that
    carry one)."""
    unk = unknown_letter(alphabet)
    return "".join(alphabet[int(c)] if c >= 0 else unk for c in codes)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of UNPADDED DNA codes (``3 - code``); negative
    sentinel codes keep their value but move with the reversal."""
    codes = np.asarray(codes, np.int8)
    out = np.where(codes >= 0, 3 - codes, codes).astype(np.int8)
    return out[..., ::-1]


def random_pair(m: int, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Random ACGT pair: a has length m (columns), b length n (rows)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=m, dtype=np.int8)
    b = rng.integers(0, 4, size=n, dtype=np.int8)
    return a, b


def random_batch(batch: int, m: int, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Batch of random pairs, shapes (batch, m) and (batch, n)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=(batch, m), dtype=np.int8)
    b = rng.integers(0, 4, size=(batch, n), dtype=np.int8)
    return a, b
