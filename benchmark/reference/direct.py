"""Blake2s CRH + Blake2Xs XOF ("direct" hasher).

Bit-exact with crates/bls-crypto/src/hashers/direct.rs:
  - crh: Blake2s-256 with node_offset carrying the XOF digest length in its
    upper 16 bits (direct.rs:23-39).
  - xof: Blake2Xs — one Blake2s instance per 32-byte output block with
    fanout=0, max_depth=0, max_leaf_length=32, inner_hash_length=32,
    node_offset = block_index | xof_digest_length << 32 (direct.rs:41-79).
  - 8-byte personalization = domain.
"""

from .blake2s import blake2s


class DomainTooLarge(ValueError):
    pass


def xof_digest_length_to_node_offset(node_offset: int, xof_digest_length: int) -> int:
    lo = xof_digest_length & 0xFF
    hi = (xof_digest_length >> 8) & 0xFF
    return node_offset | (lo << 32) | (hi << 40)


class DirectHasher:
    def crh(self, domain: bytes, message: bytes, xof_digest_length: int) -> bytes:
        return blake2s(
            message,
            digest_size=32,
            node_offset=xof_digest_length_to_node_offset(0, xof_digest_length),
            person=domain,
        )

    def xof(self, domain: bytes, hashed_message: bytes, xof_digest_length: int) -> bytes:
        if len(domain) > 8:
            raise DomainTooLarge(len(domain))
        num_hashes = (xof_digest_length + 31) // 32
        out = b""
        for i in range(num_hashes):
            if i == num_hashes - 1 and xof_digest_length % 32 != 0:
                hash_length = xof_digest_length % 32
            else:
                hash_length = 32
            out += blake2s(
                hashed_message,
                digest_size=hash_length,
                leaf_size=32,
                inner_size=32,
                fanout=0,
                depth=0,
                person=domain,
                node_offset=xof_digest_length_to_node_offset(i, xof_digest_length),
            )
        return out

    def hash(self, domain: bytes, message: bytes, output_size_in_bytes: int) -> bytes:
        prepared = self.crh(domain, message, output_size_in_bytes)
        return self.xof(domain, prepared, output_size_in_bytes)
