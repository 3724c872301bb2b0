"""Bit-faithful replicas of the Rust RNGs the reference depends on.

 - ChaCha20Rng (rand_chacha 0.2.2 + rand_core 0.5 BlockRng): used to derive
   the Bowe-Hopwood CRH generators from a Blake2s-seeded PRNG
   (crates/bls-crypto/src/hashers/composite.rs:54-72).

It exposes rand 0.7 `Rng::gen` semantics for u8/u32/u64/bool.
"""

MASK32 = 0xFFFFFFFF


def _chacha_block(key_words, counter, nonce_words):
    """One 64-byte ChaCha20 block -> list of 16 u32 (state + initial state)."""
    state = (
        [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
        + list(key_words)
        + [counter & MASK32, (counter >> 32) & MASK32]
        + list(nonce_words)
    )
    x = state[:]

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & MASK32
        x[d] ^= x[a]
        x[d] = ((x[d] << 16) | (x[d] >> 16)) & MASK32
        x[c] = (x[c] + x[d]) & MASK32
        x[b] ^= x[c]
        x[b] = ((x[b] << 12) | (x[b] >> 20)) & MASK32
        x[a] = (x[a] + x[b]) & MASK32
        x[d] ^= x[a]
        x[d] = ((x[d] << 8) | (x[d] >> 24)) & MASK32
        x[c] = (x[c] + x[d]) & MASK32
        x[b] ^= x[c]
        x[b] = ((x[b] << 7) | (x[b] >> 25)) & MASK32

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(a + b) & MASK32 for a, b in zip(x, state)]


class ChaChaRng:
    """rand_chacha 0.2.2 ChaCha20Rng with rand_core 0.5 BlockRng buffering.

    The Rust impl generates 4 ChaCha blocks per refill (a 64-word results
    buffer) and serves next_u32/next_u64 from it; next_u64 straddling the
    buffer end has special-case semantics which we reproduce exactly.
    """

    BUF_WORDS = 64  # 4 blocks x 16 words

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[i * 4 : i * 4 + 4], "little") for i in range(8)]
        self.block_counter = 0  # 64-bit block counter into the keystream
        self.results = []
        self.index = self.BUF_WORDS  # force refill on first use

    def _refill(self):
        out = []
        for _ in range(4):
            out.extend(_chacha_block(self.key, self.block_counter, [0, 0]))
            self.block_counter += 1
        self.results = out
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= self.BUF_WORDS:
            self._refill()
        v = self.results[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        # Faithful rand_core 0.5 BlockRng::next_u64
        len_ = self.BUF_WORDS
        index = self.index
        if index < len_ - 1:
            self.index += 2
            return self.results[index] | (self.results[index + 1] << 32)
        elif index >= len_:
            self._refill()
            self.index = 2
            return self.results[0] | (self.results[1] << 32)
        else:  # index == len-1: one word left
            lo = self.results[len_ - 1]
            self._refill()
            self.index = 1
            return lo | (self.results[0] << 32)

    # rand 0.7 Rng::gen semantics ------------------------------------------
    def gen_u8(self) -> int:
        return self.next_u32() & 0xFF

    def gen_u32(self) -> int:
        return self.next_u32()

    def gen_u64(self) -> int:
        return self.next_u64()

    def gen_bool(self) -> bool:
        # rand 0.7 Standard for bool: sign bit of next_u32
        return (self.next_u32() & 0x8000_0000) != 0

    def fill_bytes(self, n: int) -> bytes:
        # rand_core BlockRng::fill_bytes: consume whole words (LE)
        out = bytearray()
        while len(out) < n:
            out += self.next_u32().to_bytes(4, "little")
        return bytes(out[:n])


# ---------------------------------------------------------------------------
# arkworks sampling on top of a raw RNG
# ---------------------------------------------------------------------------

def fq_rand(rng, p: int, n_limbs: int, shave_bits: int, mont_r: int) -> int:
    """ark-ff `Fp::rand`: sample n_limbs u64s (LSB limb first), mask the top
    `shave_bits` of the last limb, retry until < p. The raw limbs are the
    MONTGOMERY representation, so the value is limbs * R^-1 mod p."""
    while True:
        limbs = [rng.gen_u64() for _ in range(n_limbs)]
        limbs[-1] &= (1 << (64 - shave_bits)) - 1
        v = 0
        for i, l in enumerate(limbs):
            v |= l << (64 * i)
        if v < p:
            return v * pow(mont_r, -1, p) % p
