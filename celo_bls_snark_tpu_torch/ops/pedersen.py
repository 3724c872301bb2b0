"""Batched Bowe-Hopwood Pedersen CRH on the card (the PyTorch counterpart
of the JAX package's ops/pedersen.py).

The reference's production sign-path CRH (CompositeHasher,
crates/bls-crypto/src/hashers/composite.rs:16-32,80-86) is a fixed-base
MSM over Edwards-BW6-761: per 3-bit chunk (b0, b1, b2) of the LSB-first
message bits, accumulate (1 + b0 + 2*b1) * (-1)^b2 * G_{seg,j} with the
ChaCha-derived generator table of hashers/composite.py. Here the whole
batch runs as one program:

  - HOST plan: messages -> per-chunk table indices (the 1..4 multiple)
    and sign bits, numpy-vectorized (np.unpackbits);
  - HOST table (cached per chunk count and device): 4 multiples per chunk
    position, affine with td = d*x*y premultiplied (ops/edwards.py mixed-add
    form), plus one identity slot for chunk padding;
  - CARD: chunks laid out column-major [K steps x Lc lanes]; K steps of
    gather + conditional negate + mixed add over Lc*B flat lanes, then a
    log2(Lc) tree fold, as one CUDA graph per shape (bh_crh_<N>_<Lc>,
    utils/aotcache.py).

Output parity: crh bytes = serialized x-coordinate, 48 bytes LE
(composite.rs:80-86). Oracle: hashers/composite.py::bh_pedersen_crh.
"""

import numpy as np
import torch

from ..hashers.composite import (
    CHUNK_SIZE,
    NUM_WINDOWS,
    WINDOW_SIZE,
    crh_parameters,
)
from ..hostmath import curves as hcurves
from ..utils import aotcache
from ..utils.profiling import stage
from ..utils.tree import tree_map
from . import edwards as ed
from .field import fq

_CAPACITY_CHUNKS = NUM_WINDOWS * WINDOW_SIZE

# packed tables on the card, keyed by (chunk count, device)
_TABLE_CACHE = {}


def n_chunks_for(msg_len: int) -> int:
    return (msg_len * 8 + CHUNK_SIZE - 1) // CHUNK_SIZE


def bh_plan(messages):
    """Equal-length byte strings -> (idx [N, B] int32, sign [N, B] bool).
    idx[ci] = 4*ci + (b0 + 2*b1) indexes the multiples table; sign = b2
    selects negation. numpy-vectorized."""
    B = len(messages)
    L = len(messages[0])
    if any(len(m) != L for m in messages):
        raise ValueError("bh_plan takes messages of one length")
    N = n_chunks_for(L)
    buf = np.frombuffer(b"".join(messages), dtype=np.uint8).reshape(B, L)
    bits = np.unpackbits(buf, axis=1, bitorder="little")  # [B, 8L]
    pad = N * CHUNK_SIZE - bits.shape[1]
    if pad:
        bits = np.concatenate([bits, np.zeros((B, pad), np.uint8)], axis=1)
    bits = bits.reshape(B, N, CHUNK_SIZE)
    m = bits[:, :, 0].astype(np.int32) + 2 * bits[:, :, 1].astype(np.int32)
    idx = m.T + 4 * np.arange(N, dtype=np.int32)[:, None]  # [N, B]
    sign = bits[:, :, 2].T.astype(bool)  # [N, B]
    return idx, sign


def bh_table(n_chunks: int, device):
    """Packed table for the first n_chunks chunk positions: (x, y, td)
    tensors [n, 4*n_chunks + 1] on `device`; entry 4*ci + (m-1) holds
    m * G_ci for m in 1..4, the final slot is the identity (used by chunk
    padding). Built on the host once per message length and device."""
    if n_chunks > _CAPACITY_CHUNKS:
        raise ValueError(
            f"message needs {n_chunks} chunks > capacity {_CAPACITY_CHUNKS}"
        )
    key = (n_chunks, torch.device(device))
    tbl = _TABLE_CACHE.get(key)
    if tbl is not None:
        return tbl
    params = crh_parameters()
    pts = []
    for ci in range(n_chunks):
        g = params[ci // WINDOW_SIZE][ci % WINDOW_SIZE]
        acc = g
        for m in range(4):
            pts.append(hcurves.ed_to_affine(acc))
            if m < 3:
                acc = hcurves.ed_add(acc, g)
    pts.append((0, 1))  # identity slot
    tbl = _TABLE_CACHE[key] = ed.pack_affine_td(pts, device)
    return tbl


def _bh_device(table, idx, sign, Lc: int):
    """idx/sign [N_pad, B] tensors with N_pad = K*Lc; returns the extended
    batch [B]."""
    N_pad, B = idx.shape
    K = N_pad // Lc
    idx3 = idx.reshape(K, Lc * B)
    sign3 = sign.reshape(K, Lc * B)
    acc = ed.identity((Lc * B,), idx.device)
    for k in range(K):
        x2, y2, td2 = tree_map(lambda t: torch.index_select(t, -1, idx3[k]), table)
        x2 = fq.select(sign3[k], fq.neg(x2), x2)
        td2 = fq.select(sign3[k], fq.neg(td2), td2)
        acc = ed.madd(acc, (x2, y2, td2))
    # tree-fold the Lc chunk lanes
    w = Lc
    while w > 1:
        h = w // 2
        lo = tree_map(lambda t: t.reshape(t.shape[0], w, B)[:, :h].reshape(t.shape[0], h * B), acc)
        hi = tree_map(lambda t: t.reshape(t.shape[0], w, B)[:, h:].reshape(t.shape[0], h * B), acc)
        acc = ed.add(lo, hi)
        w = h
    return acc


def bh_crh_device(messages, device, Lc: int = 8):
    """Batched CRH evaluation: equal-length messages -> extended TE point
    batch [B] on `device`. Lc = chunk lanes processed per step. The plan
    and its copy to the card are the host stage h2g.crh.plan."""
    with stage("h2g.crh.plan"):
        idx, sign = bh_plan(messages)
        N, B = idx.shape
        pad = (-N) % Lc
        if pad:
            id_slot = 4 * N
            idx = np.concatenate([idx, np.full((pad, B), id_slot, np.int32)], axis=0)
            sign = np.concatenate([sign, np.zeros((pad, B), bool)], axis=0)
        idx = torch.from_numpy(idx.astype(np.int64)).to(device)
        sign = torch.from_numpy(sign).to(device)
    table = bh_table(N, device)
    fn = aotcache.jit(f"bh_crh_{N}_{Lc}", lambda t, i, s: _bh_device(t, i, s, Lc))
    return fn(table, idx, sign)


def bh_crh_digests(messages, device, Lc: int = 8):
    """Batched composite-CRH digests: the serialized x-coordinates,
    48 bytes LE each (composite.rs:80-86). Returns a list of bytes. Their
    making from the points read to the host is the host stage
    h2g.crh.digest."""
    points = tree_map(lambda t: t.cpu(), bh_crh_device(messages, device, Lc))
    with stage("h2g.crh.digest"):
        out = ed.unpack_extended(points)
        return [int(x).to_bytes(48, "little") for x, _y in out]
