"""The key operations the input builder needs (the counterpart of the
JAX package's bls/keys.py, reduced to key generation, public keys and
aggregation; reference: crates/bls-crypto/src/bls/{secret,public}.rs)."""

from .hostmath import curves
from .hostmath.params import FR_MONT_R, G2_GENERATOR, R
from .utils.rngs import fq_rand

SIG_DOMAIN = b"ULforxof"


class PrivateKey:
    """An Fr scalar (crates/bls-crypto/src/bls/secret.rs:12)."""

    __slots__ = ("sk",)

    def __init__(self, sk: int):
        self.sk = sk % R

    @classmethod
    def generate(cls, rng) -> "PrivateKey":
        """Fr::rand on `rng` (secret.rs:28-30): raw-Montgomery-limb sampling
        like arkworks, so seeded runs match the reference."""
        return cls(fq_rand(rng, R, 4, 3, FR_MONT_R))

    def to_public(self) -> "PublicKey":
        return PublicKey(curves.G2.mul(self.sk, G2_GENERATOR))


class PublicKey:
    """A G2 point (crates/bls-crypto/src/bls/public.rs:16)."""

    __slots__ = ("pt",)

    def __init__(self, pt):
        self.pt = pt

    @staticmethod
    def aggregate(public_keys) -> "PublicKey":
        """Sum of G2 points (public.rs:38-44)."""
        return PublicKey(curves.G2.msum([pk.pt for pk in public_keys]))
