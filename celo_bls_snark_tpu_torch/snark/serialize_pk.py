"""Groth16 ProvingKey (de)serialization — both curves.

The reference treats serialized Groth16 keys as the durable artifact
(crates/epoch-snark/tests/e2e.rs:46-52 writes them with arkworks
CanonicalSerialize); layout here mirrors ark-serialize 0.3:

  ProvingKey = vk || beta_g1 || delta_g1
               || vec(a_query) || vec(b_g1_query) || vec(b_g2_query)
               || vec(h_query) || vec(l_query)
  vec(xs)    = u64-LE length || entries

Two point encodings: compressed (x + flag bits — the wire format pinned by
the reference's vk/proof vectors) and uncompressed (x || y — the fast local
checkpoint format: loading skips the per-point sqrt). `validate=False`
additionally skips curve/subgroup checks for trusted local files.
"""

import struct

from .groth16 import ProvingKey, VerifyingKey


class _PointIO:
    """Per-curve point codecs: (to_bytes, from_bytes) x (g1, g2)."""

    def __init__(self, g1_to, g1_from, g2_to, g2_from):
        self.g1_to = g1_to
        self.g1_from = g1_from
        self.g2_to = g2_to
        self.g2_from = g2_from


def _bw6_io(compressed: bool, validate: bool) -> _PointIO:
    from ..hostmath import bw6
    from . import serialize_bw6 as sb

    if compressed:
        return _PointIO(
            sb.point_to_bytes,
            lambda b: sb.point_from_bytes(b, bw6.G1, validate),
            sb.point_to_bytes,
            lambda b: sb.point_from_bytes(b, bw6.G2, validate),
        )
    return _PointIO(
        sb.point_to_bytes_uncompressed,
        lambda b: sb.point_from_bytes_uncompressed(b, bw6.G1, validate),
        sb.point_to_bytes_uncompressed,
        lambda b: sb.point_from_bytes_uncompressed(b, bw6.G2, validate),
    )


def _bls_io(compressed: bool, validate: bool) -> _PointIO:
    from ..utils import serialization as us

    return _PointIO(
        lambda p: us.g1_to_bytes(p, compressed),
        lambda b: us.g1_from_bytes(b, compressed, validate),
        lambda p: us.g2_to_bytes(p, compressed),
        lambda b: us.g2_from_bytes(b, compressed, validate),
    )


def _io_for(engine_name: str, compressed: bool, validate: bool) -> _PointIO:
    if engine_name == "bw6_761":
        return _bw6_io(compressed, validate)
    if engine_name == "bls12_377":
        return _bls_io(compressed, validate)
    raise ValueError(engine_name)


def _point_size(engine_name: str, compressed: bool, g2: bool) -> int:
    if engine_name == "bw6_761":
        base = 96
        return base if compressed else 2 * base
    base = 96 if g2 else 48
    return base if compressed else 2 * base


def pk_to_bytes(pk: ProvingKey, engine_name: str, compressed: bool = False) -> bytes:
    io = _io_for(engine_name, compressed, True)
    out = [vk_to_bytes_generic(pk.vk, engine_name, compressed)]
    out.append(io.g1_to(pk.beta_g1))
    out.append(io.g1_to(pk.delta_g1))
    for vec, enc in (
        (pk.a_query, io.g1_to),
        (pk.b_g1_query, io.g1_to),
        (pk.b_g2_query, io.g2_to),
        (pk.h_query, io.g1_to),
        (pk.l_query, io.g1_to),
    ):
        out.append(struct.pack("<Q", len(vec)))
        out.extend(enc(p) for p in vec)
    return b"".join(out)


def pk_from_bytes(data: bytes, engine_name: str, compressed: bool = False,
                  validate: bool = False) -> ProvingKey:
    io = _io_for(engine_name, compressed, validate)
    vk, off = _vk_from_bytes_generic(data, engine_name, compressed, validate)
    sz1 = _point_size(engine_name, compressed, g2=False)
    sz2 = _point_size(engine_name, compressed, g2=True)

    def take(n):
        nonlocal off
        chunk = data[off : off + n]
        if len(chunk) != n:
            raise ValueError("truncated proving key")
        off += n
        return chunk

    beta_g1 = io.g1_from(take(sz1))
    delta_g1 = io.g1_from(take(sz1))

    def vec(dec, sz):
        (n,) = struct.unpack("<Q", take(8))
        return [dec(take(sz)) for _ in range(n)]

    a_query = vec(io.g1_from, sz1)
    b_g1_query = vec(io.g1_from, sz1)
    b_g2_query = vec(io.g2_from, sz2)
    h_query = vec(io.g1_from, sz1)
    l_query = vec(io.g1_from, sz1)
    if off != len(data):
        raise ValueError("trailing bytes in proving key")
    return ProvingKey(
        vk=vk,
        beta_g1=beta_g1,
        delta_g1=delta_g1,
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
    )


def vk_to_bytes_generic(vk: VerifyingKey, engine_name: str,
                        compressed: bool = True) -> bytes:
    io = _io_for(engine_name, compressed, True)
    out = [
        io.g1_to(vk.alpha_g1),
        io.g2_to(vk.beta_g2),
        io.g2_to(vk.gamma_g2),
        io.g2_to(vk.delta_g2),
        struct.pack("<Q", len(vk.gamma_abc_g1)),
    ]
    out.extend(io.g1_to(p) for p in vk.gamma_abc_g1)
    return b"".join(out)


def _vk_from_bytes_generic(data: bytes, engine_name: str, compressed: bool,
                           validate: bool):
    io = _io_for(engine_name, compressed, validate)
    sz1 = _point_size(engine_name, compressed, g2=False)
    sz2 = _point_size(engine_name, compressed, g2=True)
    off = 0

    def take(n):
        nonlocal off
        chunk = data[off : off + n]
        if len(chunk) != n:
            raise ValueError("truncated verifying key")
        off += n
        return chunk

    alpha_g1 = io.g1_from(take(sz1))
    beta_g2 = io.g2_from(take(sz2))
    gamma_g2 = io.g2_from(take(sz2))
    delta_g2 = io.g2_from(take(sz2))
    (n,) = struct.unpack("<Q", take(8))
    gamma_abc = [io.g1_from(take(sz1)) for _ in range(n)]
    vk = VerifyingKey(
        alpha_g1=alpha_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        gamma_abc_g1=gamma_abc,
    )
    return vk, off


def vk_from_bytes_generic(data: bytes, engine_name: str,
                          compressed: bool = True, validate: bool = True):
    vk, off = _vk_from_bytes_generic(data, engine_name, compressed, validate)
    if off != len(data):
        raise ValueError("trailing bytes in verifying key")
    return vk
