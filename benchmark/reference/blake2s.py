"""Pure-Python Blake2s with full parameter-block control.

Needed because the reference's Blake2Xs XOF instances use fanout=0 and
max_depth=0 (crates/bls-crypto/src/hashers/direct.rs:59-69), and Python's
hashlib rejects depth=0. This module is the host-side single-message path
and the bit-exactness oracle for the batched device kernel (ops/blake2s.py).
"""

MASK32 = 0xFFFFFFFF

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & MASK32


def _compress(h, block, t, last):
    m = [int.from_bytes(block[i * 4 : i * 4 + 4], "little") for i in range(16)]
    v = list(h) + list(IV)
    v[12] ^= t & MASK32
    v[13] ^= (t >> 32) & MASK32
    if last:
        v[14] ^= MASK32

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & MASK32
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & MASK32
        v[b] = _rotr(v[b] ^ v[c], 12)
        v[a] = (v[a] + v[b] + y) & MASK32
        v[d] = _rotr(v[d] ^ v[a], 8)
        v[c] = (v[c] + v[d]) & MASK32
        v[b] = _rotr(v[b] ^ v[c], 7)

    for r in range(10):
        s = SIGMA[r]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake2s(
    data: bytes,
    digest_size: int = 32,
    key: bytes = b"",
    fanout: int = 1,
    depth: int = 1,
    leaf_size: int = 0,
    node_offset: int = 0,
    node_depth: int = 0,
    inner_size: int = 0,
    salt: bytes = b"",
    person: bytes = b"",
) -> bytes:
    """Blake2s with an explicit parameter block (no range policing beyond
    struct layout — depth/fanout 0 are allowed, as Blake2Xs requires)."""
    assert 0 < digest_size <= 32
    assert len(key) <= 32 and len(salt) <= 8 and len(person) <= 8
    param = bytearray(32)
    param[0] = digest_size
    param[1] = len(key)
    param[2] = fanout & 0xFF
    param[3] = depth & 0xFF
    param[4:8] = leaf_size.to_bytes(4, "little")
    param[8:14] = node_offset.to_bytes(6, "little")  # 48-bit for blake2s
    param[14] = node_depth & 0xFF
    param[15] = inner_size & 0xFF
    param[16:24] = salt.ljust(8, b"\x00")
    param[24:32] = person.ljust(8, b"\x00")

    h = [IV[i] ^ int.from_bytes(param[i * 4 : i * 4 + 4], "little") for i in range(8)]

    buf = b""
    if key:
        buf = key.ljust(64, b"\x00")
    buf += data

    t = 0
    if len(buf) == 0:
        h = _compress(h, b"\x00" * 64, 0, True)
    else:
        blocks = [buf[i : i + 64] for i in range(0, len(buf), 64)]
        for blk in blocks[:-1]:
            t += 64
            h = _compress(h, blk, t, False)
        last = blocks[-1]
        t += len(last)
        h = _compress(h, last.ljust(64, b"\x00"), t, True)

    out = b"".join(x.to_bytes(4, "little") for x in h)
    return out[:digest_size]
