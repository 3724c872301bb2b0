"""Batched Blake2s / Blake2Xs on the card (the PyTorch counterpart of the
JAX package's ops/blake2s.py).

The hashing leg of the hashing-included verification (DirectHasher,
crates/bls-crypto/src/hashers/direct.rs:23-79): a batch of B equal-length
messages is hashed as one vectorized program. The Blake2s state is eight
rows of 32-bit words over B lanes, and the 10 rounds x 8 G-functions run as
a Python loop over statically permuted message rows.

Blake2Xs (the XOF) runs one Blake2s instance per 32-byte output block over
the same message with a different node offset, each one more vectorized
call over the batch.

Words are int64 tensors holding values in [0, 2^32): torch.uint32 lacks
most arithmetic kernels, and >> on int32 is an arithmetic shift. Every add
is masked back to 32 bits, so every right shift is a logical one.

Bit-exactness oracle: utils/blake2s.py.
"""

import numpy as np
import torch

from ..utils import aotcache
from ..utils.blake2s import IV, SIGMA

MASK32 = 0xFFFFFFFF


def _rotr(x, n):
    return (x >> n) | ((x << (32 - n)) & MASK32)


def _compress(h, m, t: int, last: bool):
    """h: [8, B] words; m: [16, B] words; t: the byte counter; last: the
    final-block flag. Returns the new [8, B] h."""
    # IV rows stay Python ints until the first column step has touched them
    v = [h[i] for i in range(8)] + list(IV)
    v[12] ^= t & MASK32
    v[13] ^= (t >> 32) & MASK32
    if last:
        v[14] ^= MASK32

    def g(a, b, c, d, x, y):
        va = (v[a] + v[b] + x) & MASK32
        vd = _rotr(v[d] ^ va, 16)
        vc = (v[c] + vd) & MASK32
        vb = _rotr(v[b] ^ vc, 12)
        va = (va + vb + y) & MASK32
        vd = _rotr(vd ^ va, 8)
        vc = (vc + vd) & MASK32
        vb = _rotr(vb ^ vc, 7)
        v[a], v[b], v[c], v[d] = va, vb, vc, vd

    for r in range(10):
        ms = [m[j] for j in SIGMA[r]]
        g(0, 4, 8, 12, ms[0], ms[1])
        g(1, 5, 9, 13, ms[2], ms[3])
        g(2, 6, 10, 14, ms[4], ms[5])
        g(3, 7, 11, 15, ms[6], ms[7])
        g(0, 5, 10, 15, ms[8], ms[9])
        g(1, 6, 11, 12, ms[10], ms[11])
        g(2, 7, 8, 13, ms[12], ms[13])
        g(3, 4, 9, 14, ms[14], ms[15])
    return h ^ torch.stack(v[:8]) ^ torch.stack(v[8:])


def _param_h0(digest_size, fanout, depth, leaf_size, node_offset, person):
    """Initial state words from the parameter block (host-side constants;
    layout identical to utils/blake2s.py::blake2s)."""
    param = bytearray(32)
    param[0] = digest_size
    param[2] = fanout & 0xFF
    param[3] = depth & 0xFF
    param[4:8] = leaf_size.to_bytes(4, "little")
    param[8:14] = node_offset.to_bytes(6, "little")
    param[15] = 32 if (fanout == 0 and depth == 0) else 0  # inner_size
    param[24:32] = person.ljust(8, b"\x00")
    return [
        IV[i] ^ int.from_bytes(param[i * 4 : i * 4 + 4], "little")
        for i in range(8)
    ]


_H0 = {}


def _h0_column(words, device) -> torch.Tensor:
    """Initial state words as an int64 [8, 1] tensor on `device`, cached
    per parameter block: a CUDA graph takes no host data, so the state is
    copied to the card once, outside any capture."""
    key = (tuple(words), torch.device(device))
    h0 = _H0.get(key)
    if h0 is None:
        h0 = _H0[key] = torch.tensor(words, dtype=torch.int64, device=device)[:, None]
    return h0


def pack_messages(messages) -> np.ndarray:
    """Equal-length byte strings -> uint32 word array [16 * nblocks, B]
    (zero-padded to whole 64-byte blocks)."""
    L = len(messages[0])
    if any(len(m) != L for m in messages):
        raise ValueError("pack_messages takes messages of one length")
    nblocks = max(1, (L + 63) // 64)
    buf = np.zeros((len(messages), nblocks * 64), dtype=np.uint8)
    if L:
        buf[:, :L] = np.frombuffer(b"".join(messages), dtype=np.uint8).reshape(
            len(messages), L
        )
    return buf.view("<u4").T.copy()


def words_to_device(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words (pack_messages) -> the int64 word tensor on `device`."""
    return torch.from_numpy(words.astype(np.int64)).to(device)


def blake2s_batch(words, msg_len, digest_size=32, fanout=1, depth=1,
                  leaf_size=0, node_offset=0, person=b""):
    """Batched Blake2s over equal-length unkeyed messages.

    words: [16 * nblocks, B] int64 word tensor (words_to_device of
    pack_messages); msg_len: the real byte length. Returns the [8, B] state
    words; the digest is the first `digest_size` bytes of their
    little-endian concatenation."""
    B = words.shape[1]
    h0 = _param_h0(digest_size, fanout, depth, leaf_size, node_offset, person)
    h = _h0_column(h0, words.device).expand(8, B)
    nblocks = max(1, (msg_len + 63) // 64)
    if words.shape[0] != 16 * nblocks:
        raise ValueError(f"{words.shape[0]} words for {nblocks} blocks")
    t = 0
    for blk in range(nblocks):
        last = blk == nblocks - 1
        t = msg_len if last else t + 64
        h = _compress(h, words[16 * blk : 16 * (blk + 1)], t, last)
    return h


def blake2xs_batch(words, msg_len, xof_digest_length, person=b""):
    """Batched Blake2Xs XOF (direct.rs:41-79): one Blake2s instance per
    32-byte output block, fanout=0/depth=0/leaf=32/inner=32, node_offset =
    block_index | xof_digest_length << 32. Returns [n_hashes, 8, B] words;
    the digest bytes of a lane are the LE words truncated to
    xof_digest_length bytes in all."""
    num_hashes = (xof_digest_length + 31) // 32
    outs = []
    for i in range(num_hashes):
        if i == num_hashes - 1 and xof_digest_length % 32 != 0:
            hash_length = xof_digest_length % 32
        else:
            hash_length = 32
        outs.append(
            blake2s_batch(
                words, msg_len, digest_size=hash_length, fanout=0, depth=0,
                leaf_size=32, node_offset=i | _xof_node_offset(xof_digest_length),
                person=person,
            )
        )
    return torch.stack(outs)


def _direct_hash_words(words, msg_len, output_size_in_bytes, domain):
    crh = blake2s_batch(
        words, msg_len, digest_size=32,
        node_offset=_xof_node_offset(output_size_in_bytes), person=domain,
    )
    # the CRH digests (32 bytes = 8 words) are the XOF message: one 64-byte
    # block, upper half zero
    xof_words = torch.cat([crh, torch.zeros_like(crh)])
    return blake2xs_batch(xof_words, 32, output_size_in_bytes, domain)


def direct_hash_batch(messages, output_size_in_bytes, domain, device):
    """DirectHasher.hash over a batch of equal-length messages
    (direct.rs: crh then xof). Returns a list of digest byte strings. The
    CRH and the XOF run as one program of utils/aotcache.py per message
    length, output size and domain (the JAX package's jitted `run`); the
    bytes are assembled on the host."""
    words = words_to_device(pack_messages(messages), device)
    msg_len = len(messages[0])
    run = aotcache.jit(
        f"direct_hash_{msg_len}_{output_size_in_bytes}_{domain.hex()}",
        lambda w: _direct_hash_words(w, msg_len, output_size_in_bytes, domain))
    out = run(words)
    # [B, n_hashes * 32] little-endian bytes, truncated per lane
    buf = out.cpu().numpy().astype("<u4").transpose(2, 0, 1).copy().view(np.uint8)
    buf = buf.reshape(out.shape[2], -1)[:, :output_size_in_bytes]
    return [row.tobytes() for row in buf]


def _xof_node_offset(xof_digest_length):
    return ((xof_digest_length & 0xFF) << 32) | (
        ((xof_digest_length >> 8) & 0xFF) << 40
    )
