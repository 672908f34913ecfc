"""FASTA/FASTQ reading with the reference's exact quirks.

Behavioral reference: rs-vgaligner src/io.rs:20-162.
Quirks preserved:
  * file type sniffed from the extension only (fa/fasta/fq/fastq,
    anything else is an error — io.rs:83-87);
  * FASTA: every non-empty non-header line is its own record; repeated
    lines under one header get the header name with a numeric suffix
    appended starting at "1" (io.rs:97-122) — i.e. multi-line FASTA is
    *not* concatenated;
  * FASTQ: rigid 4-line records, separator/quality ignored
    (io.rs:123-131).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List


@dataclass
class QuerySequence:
    """A named read (io.rs:26-71)."""

    name: str = ""
    seq: str = ""

    def split_into_kmers(self, kmer_size: int) -> List[str]:
        if kmer_size > len(self.seq):
            return []
        return [self.seq[i : i + kmer_size] for i in range(len(self.seq) - kmer_size + 1)]

    @classmethod
    def from_string(cls, seq: str) -> "QuerySequence":
        return cls(name="", seq=seq)

    @classmethod
    def from_name_and_string(cls, name: str, seq: str) -> "QuerySequence":
        return cls(name=name, seq=seq)


def read_seqs_from_file(filename: str) -> List[QuerySequence]:
    ext = os.path.splitext(filename)[1].lstrip(".")
    if ext in ("fasta", "fa"):
        is_fasta = True
    elif ext in ("fastq", "fq"):
        is_fasta = False
    else:
        raise ValueError("Unrecognized file type")

    seqs: List[QuerySequence] = []
    with open(filename) as fh:
        lines = [ln.rstrip("\n") for ln in fh]

    if is_fasta:
        last_name = ""
        same_name_count = 0
        for line in lines:
            if line.startswith(">"):
                last_name = line[1:]
                same_name_count = 0
            elif line != "":
                name = last_name if same_name_count == 0 else last_name + str(same_name_count)
                seqs.append(QuerySequence(name=name, seq=line))
                same_name_count += 1
    else:
        it = iter(lines)
        while True:
            try:
                name_long = next(it)
                seq = next(it)
                next(it)
                next(it)
            except StopIteration:
                break
            seqs.append(QuerySequence(name=name_long[1:], seq=seq))
    return seqs
