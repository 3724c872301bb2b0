"""Boundary-layer API mirroring the reference's C FFI function-for-function
(crates/bls-snark-sys/src/{signatures,serialization,snark}.rs), with bytes
in place of raw pointers (the port's copy of the JAX package's ffi/api.py).
The C ABI shim (ffi/c_abi) exposes these over a real `extern "C"` surface
for the blockchain client. Everything here runs on the host: the
signature calls on hostmath, `verify` through snark/api.py's host pairing.

Conventions preserved from the reference:
  - hash_* functions return the UNCOMPRESSED affine encoding (x||y LE,
    ToBytes semantics — signatures.rs:93-241).
  - verify/batch-verify return booleans instead of raising
    (convert_result_to_bool, lib.rs:21-27).
  - a process-global PublicKeyCache backs cached deserialization and
    incremental aggregation (cache.rs:5-6, signatures.rs:428-482).
"""

from ..bls import (
    Batch,
    PrivateKey,
    PublicKey,
    PublicKeyCache,
    Signature,
    BLSError,
    SIG_DOMAIN,
    POP_DOMAIN,
)
from ..hash_to_curve import (
    composite_hash_to_g1,
    composite_hash_to_g1_cip22,
    direct_hash_to_g1,
)
from ..hashers import DirectHasher
from ..hashers.composite import composite_hasher
from ..hostmath import curves
from ..utils import serialization as ser

# process-global state (mirrors bls-snark-sys/src/cache.rs)
PUBLIC_KEY_CACHE = PublicKeyCache()

_hashers = {}


def init():
    """Force the lazy hashers (lib.rs:29-34): generates the Bowe-Hopwood CRH
    parameter table."""
    _hashers["direct"] = direct_hash_to_g1()
    _hashers["composite"] = composite_hash_to_g1()
    _hashers["composite_cip22"] = composite_hash_to_g1_cip22()


def _get_hasher(composite: bool, cip22: bool):
    if not _hashers:
        init()
    if composite and cip22:
        return _hashers["composite_cip22"]
    if composite:
        return _hashers["composite"]
    if cip22:
        raise BLSError("direct CIP22 hasher is not a supported combination")
    return _hashers["direct"]


# --------------------------------------------------------------------------
# signatures.rs surface
# --------------------------------------------------------------------------

def generate_private_key(rng) -> bytes:
    """signatures.rs:19-25 (caller provides entropy via an RNG object)."""
    return PrivateKey.generate(rng).to_bytes()


def private_key_to_public_key(sk_bytes: bytes) -> bytes:
    return PrivateKey.from_bytes(sk_bytes).to_public().to_bytes()


def sign_message(
    sk_bytes: bytes, message: bytes, extra_data: bytes, composite: bool, cip22: bool
) -> bytes:
    sk = PrivateKey.from_bytes(sk_bytes)
    return sk.sign(message, extra_data, _get_hasher(composite, cip22)).to_bytes()


def sign_pop(sk_bytes: bytes, message: bytes, composite: bool = False, cip22: bool = False) -> bytes:
    sk = PrivateKey.from_bytes(sk_bytes)
    return sk.sign_pop(message, _get_hasher(composite, cip22)).to_bytes()


def _uncompressed(pt) -> bytes:
    return ser.g1_to_bytes(pt, compressed=False)


def hash_direct(message: bytes, use_pop: bool) -> bytes:
    domain = POP_DOMAIN if use_pop else SIG_DOMAIN
    pt = _get_hasher(False, False).hash(domain, message, b"")
    return _uncompressed(pt)


def hash_direct_with_attempt(message: bytes, use_pop: bool):
    domain = POP_DOMAIN if use_pop else SIG_DOMAIN
    pt, attempt = _get_hasher(False, False).hash_with_attempt(domain, message, b"")
    return _uncompressed(pt), attempt


def hash_composite(message: bytes, extra_data: bytes) -> bytes:
    pt = _get_hasher(True, False).hash(SIG_DOMAIN, message, extra_data)
    return _uncompressed(pt)


def hash_composite_cip22(message: bytes, extra_data: bytes):
    pt, counter = _get_hasher(True, True).hash_with_attempt_cip22(
        SIG_DOMAIN, message, extra_data
    )
    return _uncompressed(pt), counter


def hash_crh(message: bytes, hash_bytes: int) -> bytes:
    return composite_hasher().crh(SIG_DOMAIN, message, hash_bytes)


def hash_direct_first_step(message: bytes, hash_bytes: int) -> bytes:
    return DirectHasher().hash(SIG_DOMAIN, message, hash_bytes)


def verify_signature(
    pk_bytes: bytes,
    message: bytes,
    extra_data: bytes,
    sig_bytes: bytes,
    composite: bool,
    cip22: bool,
) -> bool:
    try:
        pk = PUBLIC_KEY_CACHE.deserialize(pk_bytes)
        sig = Signature.from_bytes(sig_bytes)
        pk.verify(message, extra_data, sig, _get_hasher(composite, cip22))
        return True
    except (BLSError, ser.SerializationError):
        return False


def batch_verify_signature(messages, composite: bool, cip22: bool) -> bool:
    """messages: list of (data, extra, [pk_bytes...], [sig_bytes...]) — one
    entry per epoch block, aggregate-then-batch-verify across all blocks
    (signatures.rs:280-333)."""
    try:
        hasher = _get_hasher(composite, cip22)
        agg_sigs = []
        apks = []
        msgs = []
        for data, extra, pk_list, sig_list in messages:
            sigs = [Signature.from_bytes(s) for s in sig_list]
            pks = [PUBLIC_KEY_CACHE.deserialize(p) for p in pk_list]
            agg_sigs.append(Signature.aggregate(sigs))
            apks.append(PublicKey.aggregate(pks))
            msgs.append((data, extra))
        asig = Signature.aggregate(agg_sigs)
        asig.batch_verify(apks, SIG_DOMAIN, msgs, hasher)
        return True
    except (BLSError, ser.SerializationError):
        return False


def batch_verify_strict(batches, composite: bool, cip22: bool, rng=None):
    """batches: list of (message, extra, [(pk_bytes, sig_bytes)...]); returns
    a per-batch list of booleans (signatures.rs:336-404)."""
    hasher = _get_hasher(composite, cip22)
    results = []
    for message, extra, entries in batches:
        try:
            batch = Batch(message, extra)
            for pk_b, sig_b in entries:
                batch.add(
                    PUBLIC_KEY_CACHE.deserialize(pk_b), Signature.from_bytes(sig_b)
                )
            batch.verify(hasher, rng=rng)
            results.append(True)
        except (BLSError, ser.SerializationError):
            results.append(False)
    return results


def verify_pop(
    pk_bytes: bytes, message: bytes, sig_bytes: bytes, composite: bool, cip22: bool
) -> bool:
    try:
        pk = PUBLIC_KEY_CACHE.deserialize(pk_bytes)
        sig = Signature.from_bytes(sig_bytes)
        pk.verify_pop(message, sig, _get_hasher(composite, cip22))
        return True
    except (BLSError, ser.SerializationError):
        return False


def aggregate_public_keys(pk_bytes_list) -> bytes:
    """Via the global incremental cache (signatures.rs:428-457)."""
    pks = [PUBLIC_KEY_CACHE.deserialize(b) for b in pk_bytes_list]
    return PUBLIC_KEY_CACHE.aggregate(pks).to_bytes()


def aggregate_public_keys_subtract(apk_bytes: bytes, pk_bytes_list) -> bytes:
    """apk - sum(pks) (signatures.rs:460-482)."""
    apk = PublicKey.from_bytes(apk_bytes)
    to_sub = [PUBLIC_KEY_CACHE.deserialize(b) for b in pk_bytes_list]
    acc = apk.pt
    for pk in to_sub:
        acc = curves.G2.add(acc, curves.G2.neg(pk.pt))
    return PublicKey(acc).to_bytes()


def aggregate_signatures(sig_bytes_list) -> bytes:
    sigs = [Signature.from_bytes(b) for b in sig_bytes_list]
    return Signature.aggregate(sigs).to_bytes()


# --------------------------------------------------------------------------
# serialization.rs surface
# --------------------------------------------------------------------------

def serialize_private_key(sk: PrivateKey) -> bytes:
    return sk.to_bytes()


def deserialize_private_key(data: bytes) -> PrivateKey:
    return PrivateKey.from_bytes(data)


def serialize_public_key(pk: PublicKey, compressed=True) -> bytes:
    return pk.to_bytes(compressed)


def deserialize_public_key(data: bytes, compressed=True) -> PublicKey:
    return PublicKey.from_bytes(data, compressed)


def deserialize_public_key_cached(data: bytes) -> PublicKey:
    return PUBLIC_KEY_CACHE.deserialize(data)


def serialize_signature(sig: Signature, compressed=True) -> bytes:
    return sig.to_bytes(compressed)


def deserialize_signature(data: bytes, compressed=True) -> Signature:
    return Signature.from_bytes(data, compressed)


def compress_signature(uncompressed: bytes) -> bytes:
    """96-byte uncompressed G1 -> 48-byte compressed (serialization.rs:166+)."""
    pt = ser.g1_from_bytes(uncompressed, compressed=False)
    return ser.g1_to_bytes(pt, compressed=True)


def compress_pubkey(uncompressed: bytes) -> bytes:
    """192-byte uncompressed G2 -> 96-byte compressed."""
    pt = ser.g2_from_bytes(uncompressed, compressed=False)
    return ser.g2_to_bytes(pt, compressed=True)


# --------------------------------------------------------------------------
# snark surface (snark/api.py)
# --------------------------------------------------------------------------

def verify(vk_bytes: bytes, proof_bytes: bytes, first_epoch, last_epoch) -> bool:
    """Constant-size epoch-SNARK verification (snark/mod.rs:23-45)."""
    from ..snark.api import verify as snark_verify

    return snark_verify(vk_bytes, proof_bytes, first_epoch, last_epoch)


def encode_epoch_block_to_bytes_cip22(epoch_block) -> bytes:
    from ..snark.epoch_block import EpochBlock

    assert isinstance(epoch_block, EpochBlock)
    return epoch_block.encode_inner_to_bytes_cip22()


def encode_epoch_block_to_bytes(epoch_block) -> bytes:
    """Pre-CIP22 encoding (snark/epoch_block.rs:69-105): round/entropy are
    unused before CIP22 and maximum_validators == len(pubkeys)."""
    from ..snark.epoch_block import EpochBlock

    assert isinstance(epoch_block, EpochBlock)
    return epoch_block.encode_to_bytes()


# --------------------------------------------------------------------------
# Object-level surface (the C ABI's opaque-handle calls: the reference FFI
# passes *const PrivateKey/PublicKey/Signature handles, not bytes —
# signatures.rs:19-90,244-277,407-505)
# --------------------------------------------------------------------------

def generate_private_key_obj() -> PrivateKey:
    from ..utils.rngs import OsRng

    return PrivateKey.generate(OsRng())


def private_key_to_public_key_obj(sk: PrivateKey) -> PublicKey:
    return sk.to_public()


def sign_message_obj(sk: PrivateKey, message: bytes, extra_data: bytes,
                     composite: bool, cip22: bool) -> Signature:
    return sk.sign(message, extra_data, _get_hasher(composite, cip22))


def sign_pop_obj(sk: PrivateKey, message: bytes) -> Signature:
    # the reference FFI always uses the direct hasher here (signatures.rs:86)
    return sk.sign_pop(message, _get_hasher(False, False))


def verify_signature_obj(pk: PublicKey, message: bytes, extra_data: bytes,
                         sig: Signature, composite: bool, cip22: bool) -> bool:
    try:
        pk.verify(message, extra_data, sig, _get_hasher(composite, cip22))
        return True
    except BLSError:
        return False


def verify_pop_obj(pk: PublicKey, message: bytes, sig: Signature) -> bool:
    try:
        pk.verify_pop(message, sig, _get_hasher(False, False))
        return True
    except BLSError:
        return False


def aggregate_public_keys_objs(pks) -> PublicKey:
    return PUBLIC_KEY_CACHE.aggregate(list(pks))


def aggregate_public_keys_subtract_objs(apk: PublicKey, pks) -> PublicKey:
    to_sub = PUBLIC_KEY_CACHE.aggregate(list(pks))
    return PublicKey(curves.G2.add(apk.pt, curves.G2.neg(to_sub.pt)))


def aggregate_signatures_objs(sigs) -> Signature:
    return Signature.aggregate(list(sigs))


def batch_verify_objs(messages, composite: bool, cip22: bool) -> bool:
    """messages: list of (data, extra, PublicKey, Signature) — the
    MessageFFI shape. Aggregates all signatures then batch-verifies
    (signatures.rs:280-333)."""
    if not composite and cip22:
        raise BLSError("direct CIP22 hasher is not a supported combination")
    hasher = _get_hasher(composite, cip22)
    asig = Signature.aggregate([m[3] for m in messages])
    pks = [m[2] for m in messages]
    msgs = [(m[0], m[1]) for m in messages]
    try:
        asig.batch_verify(pks, SIG_DOMAIN, msgs, hasher)
        return True
    except BLSError:
        return False


def batch_verify_strict_objs(batches, composite: bool, cip22: bool,
                             rng=None):
    """batches: list of (data, extra, [PublicKey...], [Signature...]) — the
    BatchMessageFFI shape. Returns per-batch booleans
    (signatures.rs:336-404)."""
    results = []
    for data, extra, pks, sigs in batches:
        if not composite and cip22:
            results.append(False)
            continue
        hasher = _get_hasher(composite, cip22)
        try:
            batch = Batch(data, extra)
            for pk, sig in zip(pks, sigs):
                batch.add(pk, sig)
            batch.verify(hasher, rng=rng)
            results.append(True)
        except BLSError:
            results.append(False)
    return results


def serialize_public_key_uncompressed(pk: PublicKey) -> bytes:
    return ser.g2_to_bytes(pk.pt, compressed=False)


def serialize_signature_uncompressed(sig: Signature) -> bytes:
    return ser.g1_to_bytes(sig.pt, compressed=False)
