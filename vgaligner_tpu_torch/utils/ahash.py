"""ahash 0.7.6 zero-seed hash, reconstructed for modimizer parity.

The reference samples k-mers with ``generate_hash(seq) % r == 0``
(rs-vgaligner src/kmer.rs:409,465,931-934), where generate_hash is
ahash 0.7.6 via ``RandomState::with_seeds(0, 0, 0, 0)`` +
``u64::get_hash(&seq, ..)``.  A plain ``cargo build`` does not enable
the ``aes`` target feature or the ``specialize`` crate feature, so the
reference runs ahash's FALLBACK hasher through the generic CallHasher
path: build hasher, ``String::hash`` (write(bytes) + write_u8(0xff)),
finish.

This module reconstructs that algorithm:

  * ``RandomState::with_seeds(k0..k3)`` XORs the seeds with the PI2
    constants; the fallback ``AHasher::from_random_state`` maps them to
    (buffer, pad, extra_keys[2]) directly;
  * ``write(input)``: buffer = (buffer + len) * MULTIPLE (wrapping);
    then one ``large_update`` per 16-byte block — for 9..=16 bytes the
    (possibly overlapping) first and last little-endian u64; for
    17+ bytes the last 16 bytes first, then each 16-byte prefix block;
    shorter inputs use the 4/2/1-byte overlap scheme;
  * ``large_update(lo, hi)``: buffer = rotl((buffer + pad) ^
    folded_multiply(lo ^ xk0, hi ^ xk1), 23);
  * ``write_u8(0xff)``: buffer = folded_multiply(0xff ^ buffer,
    MULTIPLE);
  * ``finish``: rotl(folded_multiply(buffer, pad), buffer & 63).

CAVEAT: ahash's crate source is not present in this image and there is
no network access, so this is a from-memory reconstruction of
ahash-0.7.6/src/fallback_hash.rs; it is pinned by hand-derived
known-answer vectors (tests/test_ahash.py KNOWN_ANSWERS — each value
computed step by step from the algorithm spec with independent
arithmetic, so drift in either twin is a test failure) and mirrored
bit-for-bit by the native runtime (host_kernels.cpp ahash07_*), but
equality against the actual Rust crate could not be machine-verified
here.  The sampled set it induces
is deterministic and documented; ``--modimizer code`` selects the
splitmix64-of-code sampler instead (the r2/r3 behavior).
"""

from __future__ import annotations

M64 = (1 << 64) - 1

MULTIPLE = 6364136223846793005
ROT = 23

# second 256 bits of pi (ahash src/random_state.rs PI2)
PI2 = (
    0x452821E638D01377,
    0xBE5466CF34E90C6C,
    0xC0AC29B7C97C50DD,
    0x3F84D5B5B5470917,
)


def _folded_multiply(s: int, by: int) -> int:
    r = (s & M64) * (by & M64)
    return ((r & M64) ^ (r >> 64)) & M64


def _rotl(x: int, n: int) -> int:
    n &= 63
    return ((x << n) | (x >> (64 - n))) & M64


class _Fallback:
    __slots__ = ("buffer", "pad", "xk0", "xk1")

    def __init__(self, k0: int, k1: int, k2: int, k3: int) -> None:
        self.buffer = k0
        self.pad = k1
        self.xk0 = k2
        self.xk1 = k3

    def _update(self, v: int) -> None:
        self.buffer = _folded_multiply(v ^ self.buffer, MULTIPLE)

    def _large_update(self, lo: int, hi: int) -> None:
        combined = _folded_multiply(lo ^ self.xk0, hi ^ self.xk1)
        self.buffer = _rotl(
            ((self.buffer + self.pad) & M64) ^ combined, ROT
        )

    def write(self, data: bytes) -> None:
        n = len(data)
        self.buffer = ((self.buffer + n) & M64) * MULTIPLE & M64
        if n > 8:
            if n > 16:
                tail = data[-16:]
                self._large_update(
                    int.from_bytes(tail[:8], "little"),
                    int.from_bytes(tail[8:], "little"),
                )
                while len(data) > 16:
                    block, data = data[:16], data[16:]
                    self._large_update(
                        int.from_bytes(block[:8], "little"),
                        int.from_bytes(block[8:], "little"),
                    )
            else:
                self._large_update(
                    int.from_bytes(data[:8], "little"),
                    int.from_bytes(data[-8:], "little"),
                )
        elif n >= 2:
            if n >= 4:
                self._large_update(
                    int.from_bytes(data[:4], "little"),
                    int.from_bytes(data[-4:], "little"),
                )
            else:
                self._large_update(
                    int.from_bytes(data[:2], "little"), data[-1]
                )
        elif n == 1:
            self._large_update(data[0], data[0])
        else:
            self._large_update(0, 0)

    def write_u8(self, v: int) -> None:
        self._update(v)

    def finish(self) -> int:
        rot = self.buffer & 63
        return _rotl(_folded_multiply(self.buffer, self.pad), rot)


def ahash07_str(seq: str, seeds=(0, 0, 0, 0)) -> int:
    """ahash 0.7.6 fallback hash of a Rust String with
    RandomState::with_seeds(*seeds) — the reference's generate_hash for
    seeds (0,0,0,0) (kmer.rs:931-934)."""
    k = [seeds[i] ^ PI2[i] for i in range(4)]
    h = _Fallback(*k)
    h.write(seq.encode("ascii"))
    h.write_u8(0xFF)  # str::hash's length-prefix-free terminator
    return h.finish()
