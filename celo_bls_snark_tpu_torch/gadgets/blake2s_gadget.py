"""In-circuit Blake2s with full parameter-block control.

The ark-crypto-primitives blake2s-gadget equivalent, with the Blake2Xs
parameter plumbing the reference needs for in-circuit XOF hashing
(crates/bls-gadgets/src/hash_to_group.rs:49-75 `blake2xs_params` +
 crates/epoch-snark/src/gadgets/hash_to_bits.rs).

Mirrors utils/blake2s.py structurally (same IV/SIGMA/compression); all
message lengths and parameter blocks are compile-time constants, so the
control flow is static.
"""

from ..utils.blake2s import IV, SIGMA
from .vars import Boolean
from .uint32 import UInt32


def _g(cs, v, a, b, c, d, x, y):
    v[a] = UInt32.addmany(cs, [v[a], v[b], x])
    v[d] = v[d].xor(v[a]).rotr(16)
    v[c] = UInt32.addmany(cs, [v[c], v[d]])
    v[b] = v[b].xor(v[c]).rotr(12)
    v[a] = UInt32.addmany(cs, [v[a], v[b], y])
    v[d] = v[d].xor(v[a]).rotr(8)
    v[c] = UInt32.addmany(cs, [v[c], v[d]])
    v[b] = v[b].xor(v[c]).rotr(7)


def _compress(cs, h, msg_words, t: int, last: bool):
    v = list(h) + [UInt32.constant(cs, x) for x in IV]
    v[12] = v[12].xor(UInt32.constant(cs, t & 0xFFFFFFFF))
    v[13] = v[13].xor(UInt32.constant(cs, (t >> 32) & 0xFFFFFFFF))
    if last:
        v[14] = v[14].xor(UInt32.constant(cs, 0xFFFFFFFF))
    for r in range(10):
        s = SIGMA[r]
        _g(cs, v, 0, 4, 8, 12, msg_words[s[0]], msg_words[s[1]])
        _g(cs, v, 1, 5, 9, 13, msg_words[s[2]], msg_words[s[3]])
        _g(cs, v, 2, 6, 10, 14, msg_words[s[4]], msg_words[s[5]])
        _g(cs, v, 3, 7, 11, 15, msg_words[s[6]], msg_words[s[7]])
        _g(cs, v, 0, 5, 10, 15, msg_words[s[8]], msg_words[s[9]])
        _g(cs, v, 1, 6, 11, 12, msg_words[s[10]], msg_words[s[11]])
        _g(cs, v, 2, 7, 8, 13, msg_words[s[12]], msg_words[s[13]])
        _g(cs, v, 3, 4, 9, 14, msg_words[s[14]], msg_words[s[15]])
    return [h[i].xor(v[i]).xor(v[i + 8]) for i in range(8)]


def blake2s_param_words(
    digest_size=32,
    key_len=0,
    fanout=1,
    depth=1,
    leaf_size=0,
    node_offset=0,
    node_depth=0,
    inner_size=0,
    salt=b"",
    person=b"",
):
    """The 8 u32 parameter words (utils/blake2s.py parameter block)."""
    param = bytearray(32)
    param[0] = digest_size
    param[1] = key_len
    param[2] = fanout & 0xFF
    param[3] = depth & 0xFF
    param[4:8] = leaf_size.to_bytes(4, "little")
    param[8:14] = node_offset.to_bytes(6, "little")
    param[14] = node_depth & 0xFF
    param[15] = inner_size & 0xFF
    param[16:24] = salt.ljust(8, b"\x00")
    param[24:32] = person.ljust(8, b"\x00")
    return [int.from_bytes(param[i * 4 : i * 4 + 4], "little") for i in range(8)]


def blake2xs_params(i: int, xof_digest_length: int, hash_length: int, person: bytes):
    """Blake2Xs per-block parameter words (DirectHasher.xof semantics,
    crates/bls-crypto/src/hashers/direct.rs:59-69)."""
    node_offset = i | ((xof_digest_length & 0xFF) << 32) | (((xof_digest_length >> 8) & 0xFF) << 40)
    return blake2s_param_words(
        digest_size=hash_length,
        fanout=0,
        depth=0,
        leaf_size=32,
        inner_size=32,
        node_offset=node_offset,
        person=person,
    )


def blake2s_gadget(cs, message_bits, param_words):
    """message_bits: list[Boolean], length a multiple of 8 (LSB-first per
    byte, matching the reference's byte streams). Returns 256 output bits
    (LSB-first per word). The message length is static."""
    assert len(message_bits) % 8 == 0
    nbytes = len(message_bits) // 8
    with cs.ns("blake2s"):
        h = [
            UInt32.constant(cs, IV[i]).xor(UInt32.constant(cs, param_words[i]))
            for i in range(8)
        ]
        # pad to 64-byte blocks with zero bits
        zero = Boolean.false(cs)
        padded = list(message_bits) + [zero] * ((-len(message_bits)) % 512)
        if nbytes == 0:
            padded = [zero] * 512
        blocks = [padded[i : i + 512] for i in range(0, len(padded), 512)]
        t = 0
        for bi, blk in enumerate(blocks):
            words = [UInt32.from_bits_le(blk[w * 32 : (w + 1) * 32]) for w in range(16)]
            is_last = bi == len(blocks) - 1
            t = min(nbytes, (bi + 1) * 64) if not is_last else nbytes
            h = _compress(cs, h, words, t, is_last)
        out = []
        for word in h:
            out.extend(word.bits)
        return out
