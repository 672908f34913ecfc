"""DNA utilities: reverse complement and 2-bit base encoding.

Behavioral reference: rs-vgaligner src/dna.rs:5-40 (reverse_complement,
switch_base, is_dna). The reference panics on non-DNA characters; we raise
ValueError with the same trigger set.

The 2-bit encoding (A=0, C=1, G=2, T=3) is the TPU-native replacement for
string k-mers: because ASCII order A < C < G < T matches code order, sorting
k-mer strings lexicographically (kmer.rs:295-298) is equivalent to sorting
fixed-width 2k-bit integer codes, which is what the device-side index relies
on. Code 4 marks N/invalid bases.
"""

from __future__ import annotations

import numpy as np

_DNA_CHARS = set("AaCcGgTtUuNn")

_SWITCH = {
    "a": "t", "c": "g", "t": "a", "g": "c", "u": "a",
    "A": "T", "C": "G", "T": "A", "G": "C", "U": "A",
}

# char -> 2-bit code; 4 = invalid/N. Upper+lowercase accepted (the reference
# operates on raw GFA/FASTA bytes; HLA-zoo graphs are uppercase).
BASE_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    BASE_CODE[ord(_b)] = _i
    BASE_CODE[ord(_b.lower())] = _i

_CODE_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# code complement: A<->T, C<->G; N stays invalid
CODE_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def is_dna(base: str) -> bool:
    """dna.rs:35-40 — accepted DNA alphabet (incl. U and N)."""
    return base in _DNA_CHARS


# str.translate table: complement for the DNA alphabet, every other
# character mapped to a sentinel so one scan both converts and detects
# non-DNA input (the char-wise Python loop was ~10s/build on MICB-class
# graphs, called once per embedded-path window)
_RC_SENTINEL = "\x00"
_RC_TABLE = str.maketrans(
    {c: _SWITCH.get(c, "N" if c in "Nn" else _RC_SENTINEL)
     for c in map(chr, range(128))}
)


def reverse_complement(sequence: str) -> str:
    """Reverse-complement of a sequence (dna.rs:5-17).

    Raises ValueError on non-DNA input (reference panics). N maps to N
    (switch_base's fallthrough arm, dna.rs:31).
    """
    out = sequence.translate(_RC_TABLE)[::-1]
    if _RC_SENTINEL in out:
        bad = sequence[len(sequence) - 1 - out.index(_RC_SENTINEL)]
        raise ValueError(f"Input sequence base is not DNA: {bad}")
    if not out.isascii():  # non-ASCII passes translate untouched
        bad = next(c for c in sequence if not c.isascii())
        raise ValueError(f"Input sequence base is not DNA: {bad}")
    return out


def encode_seq(sequence: str) -> np.ndarray:
    """Encode an ASCII DNA string to int8 codes (A=0 C=1 G=2 T=3, else 4)."""
    raw = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
    return BASE_CODE[raw]


def decode_seq(codes: np.ndarray) -> str:
    """Inverse of encode_seq (code 4 -> 'N')."""
    codes = np.asarray(codes)
    return _CODE_BASE[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def kmer_code(seq: str) -> int:
    """Pack a k-mer string into a 2k-bit integer (first base most significant).

    Requires pure ACGT input; returns -1 if the k-mer contains any other
    base (such k-mers are never indexed: kmer.rs:400-403).
    """
    codes = encode_seq(seq)
    if (codes >= 4).any():
        return -1
    value = 0
    for c in codes:
        value = (value << 2) | int(c)
    return value
