"""Sequence encoding and input generation.

Sequences are int8 code arrays (A,C,G,T -> 0..3). Inputs are made with
numpy's ``default_rng(seed)``, the same generator and draw order as
``swtpu.core.encode``, so both packages see identical pairs for a seed.
``GlibcRand`` is glibc's ``rand()`` stream, for the sequences a reference
C binary generates (``runtime_native.reference_random`` is its native
twin).
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


class GlibcRand:
    """Bit-exact emulation of glibc's TYPE_3 additive-feedback ``rand()``.

    The reference's serial generator never calls ``srand``, so glibc uses
    seed 1 and its input stream is fully deterministic. Emulating it lets
    tests reproduce the exact byte streams a reference binary would align.

    Seed 0 is taken as 1, as glibc's ``srandom`` takes it. (The JAX
    package's Python class stores 0 and then yields only zeros, so its
    ``GlibcRand(0)`` differs from its own native ``reference_random(n,
    0)``, which follows glibc; this class and the port's native twin both
    follow glibc.)
    """

    def __init__(self, seed: int = 1):
        # glibc srandom for TYPE_3: r[0] = seed (0 -> 1); r[i] = 16807 *
        # r[i-1] % (2^31 - 1) by Schrage's method; r[i] = r[i-31] for the
        # next 3; then 310 outputs discarded, each r[i] = r[i-31] + r[i-3]
        seed &= 0xFFFFFFFF
        r = [0] * 344
        r[0] = seed or 1
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self._r = r
        self._idx = 344

    def rand(self) -> int:
        r = self._r
        i = self._idx
        val = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        r.append(val)
        self._idx = i + 1
        return val >> 1

    def reference_sequence(self, length: int) -> np.ndarray:
        """int8 codes of the reference's generate() letter mapping:
        rand % 4 -> 0:'A' 2:'C' 3:'G' else (1):'T'."""
        remap = (0, 3, 1, 2)               # rand % 4 -> our ACGT code
        return np.array([remap[self.rand() % 4] for _ in range(length)],
                        dtype=np.int8)
