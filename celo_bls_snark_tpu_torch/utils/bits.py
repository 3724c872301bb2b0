"""Bit/byte conversion utilities.

Bit-exact parity with crates/bls-gadgets/src/utils.rs:2-54 — the reference's
nonstandard BE-bits <-> LE-bytes conventions are the highest corruption risk
in the epoch encodings (SURVEY.md section 7 hard part (c)), so these mirror
the Rust functions exactly and are pinned by the epoch-encoding golden
vectors in tests/test_epoch_block.py.
"""


def bits_be_to_bytes_le(bits):
    """Big-endian bits -> LE bytes (utils.rs:2-21)."""
    reversed_bits = list(bits)[::-1]
    out = bytearray()
    for i in range(0, len(reversed_bits), 8):
        chunk = reversed_bits[i : i + 8]
        byte = 0
        twoi = 1
        for c in chunk:
            byte = (byte + twoi * int(bool(c))) & 0xFF
            twoi *= 2
        out.append(byte)
    return bytes(out)


def bits_le_to_bytes_le(bits):
    return bits_be_to_bytes_le(list(bits)[::-1])


def bytes_le_to_bits_be(data: bytes, bits_to_take: int):
    """LE bytes -> bits in descending order (utils.rs:27-44)."""
    bits = []
    for b in data:
        for _ in range(8):
            bits.append((b & 1) == 1)
            b >>= 1
    return bits[:bits_to_take][::-1]


def bytes_le_to_bits_le(data: bytes, bits_to_take: int):
    return bytes_le_to_bits_be(data, bits_to_take)[::-1]
