"""FASTA/FASTQ reading: sequences as int8 codes, record names, qualities.

Counterpart of ``swtpu.runtime_native``'s ``read_seqfile`` (the JAX
package decodes bases in its native library, ``csrc/swtpu_native.cpp``
``scan_or_read``), ``seq_names`` and ``seq_quals``, in numpy and Python
with the same rules:

* a case-insensitive lookup table from the alphabet (ACGT by default);
  an unknown character encodes as -1, a sentinel code: the kernels
  compare raw codes (``csrc/sw_cell.cuh``), so under match/mismatch
  scoring -1 matches -1 (N against N) and mismatches every base, and
  with a substitution table it scores NEG_SUB against any code;
* the file is read in chunks of at most 65535 bytes, each ending at a
  newline where one comes first, as the native reader's ``fgets`` reads
  it, and each chunk loses one trailing ``\\n`` and then one ``\\r``;
* FASTQ is detected by a first non-blank line starting with ``@`` before
  any record; a FASTQ record is read by line count (header, sequence,
  separator, quality), so a quality line may start with ``@`` or ``>``,
  and blank lines inside a record are content (an empty read, its empty
  quality), while blank lines between records are skipped;
* FASTA records start at ``>`` lines and take every later line until the
  next one.

``seq_names`` and ``seq_quals`` are plain text handling, as in the JAX
package, whose own state machine (``_scan_records``) this module copies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .encode import DNA_ALPHABET

# the native reader's fgets buffer holds 65536 bytes, one for the NUL
_CHUNK = (1 << 16) - 1


def _lut(alphabet: Optional[str]) -> np.ndarray:
    """256-entry code table: the alphabet's letters in either case -> their
    index, every other byte -> -1."""
    lut = np.full(256, -1, np.int8)
    for i, c in enumerate(alphabet or DNA_ALPHABET):
        u = ord(c) & 0xFF
        lut[u] = i
        if ord("A") <= u <= ord("Z"):
            lut[u + 32] = i
        elif ord("a") <= u <= ord("z"):
            lut[u - 32] = i
    return lut


def _chunks(data: bytes):
    """The logical lines the native reader sees: fgets chunks of at most
    _CHUNK bytes, each stripped of one '\\n' and then one '\\r'."""
    lines = data.split(b"\n")
    for idx, line in enumerate(lines):
        if idx < len(lines) - 1:
            line += b"\n"                  # only '\n' ends a line
        for k in range(0, len(line), _CHUNK):
            chunk = line[k:k + _CHUNK]
            if chunk.endswith(b"\n"):
                chunk = chunk[:-1]
            if chunk.endswith(b"\r"):
                chunk = chunk[:-1]
            yield chunk


def read_seqfile(path: str, alphabet: Optional[str] = None
                 ) -> list[np.ndarray]:
    """Parse FASTA/FASTQ into a list of int8 code arrays, one per record.
    ``alphabet`` maps characters to code indices (default ACGT); unknown
    characters encode as -1. Raises FileNotFoundError for a missing
    file."""
    with open(path, "rb") as f:
        data = f.read()
    lut = _lut(alphabet)
    seqs: list[list[bytes]] = []
    fastq = in_seq = False
    fastq_line = 0
    for line in _chunks(data):
        if not line:
            # blank lines inside a FASTQ record are content
            if fastq and fastq_line in (1, 2):
                fastq_line += 1
            elif fastq and fastq_line == 3:
                fastq_line = 0
            continue
        c0 = line[:1]
        if not fastq and c0 == b"@" and not seqs and not in_seq:
            fastq = True
        if fastq:
            if fastq_line == 0 and c0 == b"@":
                fastq_line = 1
                seqs.append([])
            elif fastq_line == 1:           # sequence line
                seqs[-1].append(line)
                fastq_line = 2
            elif fastq_line == 2:           # '+' line
                fastq_line = 3
            elif fastq_line == 3:           # quality line
                fastq_line = 0
            continue
        if c0 == b">":
            seqs.append([])
            in_seq = True
        elif in_seq:
            seqs[-1].append(line)
    return [lut[np.frombuffer(b"".join(parts), np.uint8)].astype(np.int8)
            for parts in seqs]


def _scan_records(path: str):
    """Yield (name, qual) per FASTA/FASTQ record, in file order; qual is
    None for FASTA records. FASTQ records are consumed by line count, and
    blank lines count as content inside a record while they are skipped
    between records, as ``read_seqfile`` does."""
    with open(path, "rb") as f:
        fastq_state = 0
        name = ""
        for line in f:
            line = line.strip()
            if fastq_state:              # seq / '+' / qual of one record
                fastq_state -= 1
                if fastq_state == 0:
                    yield name, line.decode(errors="replace")
                continue
            if not line:
                continue
            if line[:1] == b">":
                yield (line[1:].split()[0].decode(errors="replace")
                       if len(line) > 1 else ""), None
            elif line[:1] == b"@":
                name = (line[1:].split()[0].decode(errors="replace")
                        if len(line) > 1 else "")
                fastq_state = 3
        if fastq_state:
            # a truncated final record counts at its header, as in
            # read_seqfile, so the per-record lists stay aligned
            yield name, ""


def seq_names(path: str) -> list[str]:
    """Record names (the first whitespace-delimited token of each FASTA
    '>' / FASTQ '@' header), in file order."""
    return [n for n, _ in _scan_records(path)]


def seq_quals(path: str) -> list:
    """Per-record Phred quality strings for FASTQ records, None for FASTA
    records, in file order."""
    return [q for _, q in _scan_records(path)]
