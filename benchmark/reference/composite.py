"""Bowe-Hopwood Pedersen CRH (over Edwards-on-BW6-761) + Blake2Xs XOF.

Bit-exact with crates/bls-crypto/src/hashers/composite.rs:
  - CRH parameters (560 windows x 93 chunks) generated from a ChaCha20 RNG
    seeded with Blake2s(person=b"UL_prngs", msg=b"ULTRALIGHT PRNG SEED")
    (composite.rs:54-72), reproducing arkworks' sampling order exactly.
  - crh output = serialized x-coordinate of the TE point (composite.rs:80-86).
  - xof delegates to the DirectHasher's Blake2Xs (composite.rs:88-95).

Bowe-Hopwood evaluation (ark-crypto-primitives bowe_hopwood, CHUNK_SIZE=3):
per 3-bit chunk (b0,b1,b2) of the LSB-first input bits, accumulate
(1 + b0 + 2*b1) * (-1)^b2 * G_{segment,chunk}, with G_{s,j} = 16^j * B_s and
B_s a fresh random TE point per segment.
"""

import hashlib
from functools import lru_cache

from .params import P, FQ_MONT_R, ED_COFACTOR
from . import curves
from .rngs import ChaChaRng, fq_rand
from .direct import DirectHasher

WINDOW_SIZE = 93
NUM_WINDOWS = 560
CHUNK_SIZE = 3


def _prng() -> ChaChaRng:
    seed = hashlib.blake2s(
        b"ULTRALIGHT PRNG SEED", digest_size=32, person=b"UL_prngs"
    ).digest()
    return ChaChaRng(seed)


def _te_rand(rng):
    """arkworks TE GroupProjective sampling: random x + `greatest` bool,
    decompress, scale by cofactor; retry until on-curve."""
    while True:
        x = fq_rand(rng, P, 6, 7, FQ_MONT_R)
        greatest = rng.gen_bool()
        pt = curves.ed_get_point_from_x(x, greatest)
        if pt is not None:
            ext = curves.ed_from_affine(pt)
            return curves.ed_mul(ED_COFACTOR, ext)


@lru_cache(maxsize=1)
def crh_parameters():
    """560 segments x 93 generators, as affine (x, y) pairs.

    Matches ark bowe_hopwood create_generators: per segment, sample a base
    point then push base, 16*base, 16^2*base, ... (4 doublings apart).
    """
    rng = _prng()
    segments = []
    for _ in range(NUM_WINDOWS):
        base = _te_rand(rng)
        seg = []
        for _ in range(WINDOW_SIZE):
            seg.append(base)
            for _ in range(4):
                base = curves.ed_double(base)
        segments.append(seg)
    return segments


def bytes_to_bits_le(data: bytes):
    """LSB-first bits per byte (ark crypto-primitives bytes_to_bits)."""
    bits = []
    for byte in data:
        for i in range(8):
            bits.append((byte >> i) & 1)
    return bits


def bh_pedersen_crh(message: bytes):
    """Evaluate the Bowe-Hopwood CRH; returns a TE extended point."""
    capacity_bits = WINDOW_SIZE * NUM_WINDOWS * CHUNK_SIZE
    if len(message) * 8 > capacity_bits:
        raise ValueError(
            f"incorrect input length {len(message)} bytes > {capacity_bits // 8}"
        )
    bits = bytes_to_bits_le(message)
    while len(bits) % CHUNK_SIZE != 0:
        bits.append(0)
    params = crh_parameters()
    acc = curves.ED_IDENTITY
    for ci in range(len(bits) // CHUNK_SIZE):
        b0, b1, b2 = bits[3 * ci : 3 * ci + 3]
        seg, j = divmod(ci, WINDOW_SIZE)
        g = params[seg][j]
        enc = g
        if b0:
            enc = curves.ed_add(enc, g)
        if b1:
            enc = curves.ed_add(enc, curves.ed_double(g))
        if b2:
            enc = curves.ed_neg(enc)
        acc = curves.ed_add(acc, enc)
    return acc


class CompositeHasher:
    def crh(self, domain: bytes, message: bytes, xof_digest_length: int) -> bytes:
        pt = bh_pedersen_crh(message)
        x, _y = curves.ed_to_affine(pt)
        return int(x).to_bytes(48, "little")

    def xof(self, domain: bytes, hashed_message: bytes, xof_digest_length: int) -> bytes:
        return DirectHasher().xof(domain, hashed_message, xof_digest_length)

    def hash(self, domain: bytes, message: bytes, output_size_in_bytes: int) -> bytes:
        prepared = self.crh(domain, message, output_size_in_bytes)
        return self.xof(domain, prepared, output_size_in_bytes)


_composite_singleton = None


def composite_hasher() -> CompositeHasher:
    """Lazily instantiated singleton, mirroring COMPOSITE_HASHER
    (composite.rs:36-37)."""
    global _composite_singleton
    if _composite_singleton is None:
        _composite_singleton = CompositeHasher()
    return _composite_singleton
