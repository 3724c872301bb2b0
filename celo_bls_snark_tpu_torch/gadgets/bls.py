"""In-circuit BLS signature verification gadget.

Parity with crates/bls-gadgets/src/bls.rs (BlsVerifyGadget):
  - verify: bitmap-gated aggregate public key + 2-pairing product check
    (bls.rs:42-77)
  - batch_verify_prepared: (n+1)-pairing in-circuit equation
    e(sigma, -g2) * prod e(H(m_i), apk_i) == 1 (bls.rs:85-129)
  - enforce_aggregated_pubkeys: conditional adds gated on bitmap bits with
    padding-pk exclusion (bls.rs:137-155)
  - enforce_bitmap: at most max_non_signers zeros (bls.rs:179-192)
  - enforce_bls_equation via the pairing gadget (bls.rs:222-231)

Aggregation uses affine incomplete additions behind an independent offset
base (sum starts from a nothing-up-my-sleeve point and subtracts it at the
end) so the conditional-add chain never hits the equal-x degenerate case
for honest witnesses.
"""

from ..hostmath import curves as hc
from ..hostmath.params import P, G2_GENERATOR
from .vars import Boolean, FpVar
from .bitmap import enforce_maximum_occurrences_in_bitmap
from .curve_vars import G1Var, G2Var
from .pairing_gadget import enforce_pairing_product_is_one


def _offset_base_g2():
    """Deterministic G2 point independent of the generator: hash-to-curve of
    a fixed tag (computed once, host-side)."""
    from ..hash_to_curve import TryAndIncrement
    from ..hashers.composite import composite_hasher

    h = TryAndIncrement(composite_hasher(), "g2", compat=False)
    return h.hash(b"UL_aggr_", b"offset base", b"")


_OFFSET_G2 = None


def offset_base_g2():
    global _OFFSET_G2
    if _OFFSET_G2 is None:
        _OFFSET_G2 = _offset_base_g2()
    return _OFFSET_G2


def enforce_bitmap(cs, bitmap, maximum_non_signers: FpVar):
    """At most `maximum_non_signers` zeros in the bitmap (bls.rs:179-192)."""
    with cs.ns("enforce_bitmap"):
        enforce_maximum_occurrences_in_bitmap(cs, bitmap, maximum_non_signers, False)


def enforce_aggregated_pubkeys(cs, pub_keys, bitmap):
    """Sum of the bitmap-selected public keys (bls.rs:137-155).

    pub_keys: list[G2Var]; bitmap: list[Boolean]. Returns G2Var.
    """
    assert len(pub_keys) == len(bitmap)
    with cs.ns("enforce_aggregated_pubkeys"):
        base = offset_base_g2()
        acc = G2Var.constant(cs, base)
        for bit, pk in zip(bitmap, pub_keys):
            added = acc.add_unchecked(pk)
            acc = added.select(bit, acc)
        return acc.add_unchecked(G2Var.constant(cs, hc.G2.neg(base)))


def enforce_bitmap_with_aggregate(cs, pub_keys, signed_bitmap, message_hash,
                                  maximum_non_signers, padding_pk):
    """The reference's `enforce_bitmap` (bls.rs:179-231 caller shape):
    threshold-check the bitmap, aggregate the selected keys while
    disallowing the padding pk where bit = 1, and hand back the
    (message_hash, aggregate_pk) pair for batch verification."""
    with cs.ns("enforce_bitmap"):
        enforce_maximum_occurrences_in_bitmap(
            cs, signed_bitmap, maximum_non_signers, False
        )
        base = offset_base_g2()
        acc = G2Var.constant(cs, base)
        for bit, pk in zip(signed_bitmap, pub_keys):
            pk.conditional_enforce_not_equal(padding_pk, bit)
            added = acc.add_unchecked(pk)
            acc = added.select(bit, acc)
        apk = acc.add_unchecked(G2Var.constant(cs, hc.G2.neg(base)))
        return message_hash, apk


def enforce_aggregated_all_pubkeys(cs, pub_keys):
    """Unconditional sum of all pubkeys (bls.rs:160-171)."""
    with cs.ns("enforce_aggregated_all_pubkeys"):
        base = offset_base_g2()
        acc = G2Var.constant(cs, base)
        for pk in pub_keys:
            acc = acc.add_unchecked(pk)
        return acc.add_unchecked(G2Var.constant(cs, hc.G2.neg(base)))


def enforce_bls_equation(cs, message_hashes, signature, aggregated_pks):
    """e(sigma, -g2) * prod_i e(H_i, apk_i) == 1 (bls.rs:222-231)."""
    with cs.ns("enforce_bls_equation"):
        neg_g2 = G2Var.constant(cs, hc.G2.neg(G2_GENERATOR))
        pairs = [(signature, neg_g2)]
        pairs += list(zip(message_hashes, aggregated_pks))
        enforce_pairing_product_is_one(cs, pairs)


def verify(cs, pub_keys, signed_bitmap, message_hash, signature, maximum_non_signers):
    """Single-message BLS verification (bls.rs:42-77): enforce the bitmap
    threshold, aggregate the signers' keys, check the pairing equation."""
    with cs.ns("bls_verify"):
        enforce_bitmap(cs, signed_bitmap, maximum_non_signers)
        apk = enforce_aggregated_pubkeys(cs, pub_keys, signed_bitmap)
        enforce_bls_equation(cs, [message_hash], signature, [apk])
        return apk


def batch_verify_prepared(cs, prepared, signature):
    """(n+1)-pairing batch check over prepared (apk, message_hash) pairs
    (bls.rs:85-129)."""
    with cs.ns("batch_verify"):
        hashes = [h for (_, h) in prepared]
        apks = [a for (a, _) in prepared]
        enforce_bls_equation(cs, hashes, signature, apks)
