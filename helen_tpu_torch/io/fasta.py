"""Polished-FASTA output.

Matches the reference's output format byte for byte: ``>`` + contig name +
newline + the full sequence on a single line (reference StitchInterface.py:104-106).
"""
from __future__ import annotations

from typing import Iterable, Tuple


def write_fasta(path: str, records: Iterable[Tuple[str, str]]) -> int:
    """Write (name, sequence) records; empty sequences are skipped
    (reference StitchInterface.py:104). Returns records written."""
    n = 0
    with open(path, "w") as f:
        for name, seq in records:
            if not seq:
                continue
            f.write(">" + name + "\n")
            f.write(seq + "\n")
            n += 1
    return n


def write_fastq(path: str, records: Iterable[Tuple[str, str, str]]) -> int:
    """Write (name, sequence, phred+33 quality) records; empty sequences are
    skipped like write_fasta. FASTQ output is a helen_tpu_torch extension (the
    reference discards the vote probabilities, predict_gpu.py:155-159)."""
    n = 0
    with open(path, "w") as f:
        for name, seq, qual in records:
            if not seq:
                continue
            if len(qual) != len(seq):
                raise ValueError(
                    f"{name}: quality length {len(qual)} != sequence length {len(seq)}"
                )
            f.write("@" + name + "\n" + seq + "\n+\n" + qual + "\n")
            n += 1
    return n


def read_fastq(path: str):
    """Minimal 4-line-record FASTQ reader (tests and eval tooling)."""
    with open(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip("\r\n")
            f.readline()  # '+'
            qual = f.readline().rstrip("\r\n")
            yield header[1:].strip().split()[0], seq, qual


def read_fasta(path: str):
    """Minimal FASTA reader (for tests and eval tooling)."""
    name = None
    chunks = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\r\n")  # tolerate CRLF files
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                fields = line[1:].split()
                name = fields[0] if fields else ""  # tolerate a bare '>'
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)
