"""Private and public keys.

Reference parity:
  - PrivateKey: crates/bls-crypto/src/bls/secret.rs (Fr newtype; sign =
    hash-to-G1 then scalar mul; sign_pop in POP_DOMAIN; to_public = g2 * sk).
  - PublicKey: crates/bls-crypto/src/bls/public.rs (G2 point; aggregate = sum;
    batch = MSM with small exponents; verify via 2-pairing product check).
"""

from ..hostmath.params import R, G2_GENERATOR, FR_BYTES
from ..hostmath import curves, pairing
from ..utils import serialization as ser


class PrivateKey:
    """An Fr scalar (crates/bls-crypto/src/bls/secret.rs:12)."""

    __slots__ = ("sk",)

    def __init__(self, sk: int):
        self.sk = sk % R

    @classmethod
    def generate(cls, rng) -> "PrivateKey":
        """Fr::rand on the provided RNG (secret.rs:28-30). The rng must expose
        gen_u64 (our replica RNGs) — uniform via raw-Montgomery-limb sampling
        like arkworks, so seeded runs match the reference."""
        from ..hostmath.params import FR_MONT_R
        from ..utils.rngs import fq_rand

        return cls(fq_rand(rng, R, 4, 3, FR_MONT_R))

    @classmethod
    def from_bytes(cls, data: bytes) -> "PrivateKey":
        return cls(ser.fr_from_bytes(data))

    def to_bytes(self) -> bytes:
        return ser.fr_to_bytes(self.sk)

    def sign(self, message: bytes, extra_data: bytes, hash_to_g1) -> "Signature":
        from . import SIG_DOMAIN

        return self.sign_message(SIG_DOMAIN, message, extra_data, hash_to_g1)

    def sign_pop(self, message: bytes, hash_to_g1) -> "Signature":
        from . import POP_DOMAIN

        return self.sign_message(POP_DOMAIN, message, b"", hash_to_g1)

    def sign_message(self, domain, message, extra_data, hash_to_g1) -> "Signature":
        from .signature import Signature

        h = hash_to_g1.hash(domain, message, extra_data)
        return Signature(curves.G1.mul(self.sk, h))

    def to_public(self) -> "PublicKey":
        return PublicKey(curves.G2.mul(self.sk, G2_GENERATOR))


class PublicKey:
    """A G2 point (crates/bls-crypto/src/bls/public.rs:16)."""

    __slots__ = ("pt",)

    def __init__(self, pt):
        self.pt = pt

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self.pt == other.pt

    def __hash__(self):
        return hash(("PublicKey", self.pt))

    # --- aggregation ------------------------------------------------------
    @staticmethod
    def aggregate(public_keys) -> "PublicKey":
        """Sum of G2 points (public.rs:38-44)."""
        return PublicKey(curves.G2.msum([pk.pt for pk in public_keys]))

    @staticmethod
    def batch(exponents, public_keys):
        """MSM of pubkeys with (small) exponents (public.rs:47-65).
        Returns None on length mismatch, like the reference."""
        pks = list(public_keys)
        if len(pks) != len(exponents):
            return None
        acc = None
        for e, pk in zip(exponents, pks):
            term = curves.G2.mul(e % R, pk.pt) if e % R != 0 else None
            acc = curves.G2.add(acc, term)
        return PublicKey(acc)

    # --- verification -----------------------------------------------------
    def verify(self, message: bytes, extra_data: bytes, signature, hash_to_g1):
        from . import SIG_DOMAIN

        return self.verify_sig(SIG_DOMAIN, message, extra_data, signature, hash_to_g1)

    def verify_pop(self, message: bytes, signature, hash_to_g1):
        from . import POP_DOMAIN

        return self.verify_sig(POP_DOMAIN, message, b"", signature, hash_to_g1)

    def verify_sig(self, domain, message, extra_data, signature, hash_to_g1):
        """e(sigma, -g2) * e(H(m), pk) == 1 (public.rs:94-120). Raises
        VerificationFailed on failure (mirrors BlsResult)."""
        from . import VerificationFailed

        h = hash_to_g1.hash(domain, message, extra_data)
        ok = pairing.pairing_check(
            [
                (signature.pt, curves.G2.neg(G2_GENERATOR)),
                (h, self.pt),
            ]
        )
        if not ok:
            raise VerificationFailed()

    # --- serialization ----------------------------------------------------
    def to_bytes(self, compressed=True) -> bytes:
        return ser.g2_to_bytes(self.pt, compressed)

    @classmethod
    def from_bytes(cls, data: bytes, compressed=True, validate=True) -> "PublicKey":
        return cls(ser.g2_from_bytes(data, compressed, validate))
