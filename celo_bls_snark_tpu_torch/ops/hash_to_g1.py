"""Batched try-and-increment hash-to-G1 on the card (the PyTorch
counterpart of the JAX package's ops/hash_to_g1.py).

The whole CIP22 try-and-increment (crates/bls-crypto/src/hash_to_curve/
try_and_increment_cip22.rs:81-134, with the DirectHasher of direct.rs or
the composite Pedersen CRH) runs as vectorized PyTorch code on top of the
mont_mul and mont_redc kernels:

  1. one batched Blake2s CRH per message (ops/blake2s.py), unless the
     caller passes the CRH bytes (the composite hasher's Pedersen digests),
  2. the Blake2Xs XOF for the first C1 counters of every message at once,
  3. candidate parsing (377-bit x + compat/normal sign flags) from the XOF
     words into field limbs,
  4. validity = (x < p) AND (x^3 + 1 is a QR): one shared exponentiation
     t^((s-1)/2) feeds both the Legendre test (45 more squarings) and the
     Tonelli-Shanks start,
  5. first-valid-counter selection per message, then the table-based
     Tonelli-Shanks finish (110 squarings + 6 subgroup-table matches) on
     the selected lanes only,
  6. sign selection (the lexicographically greatest root iff the flag bit
     is set) and the G1 cofactor multiply.

The try-and-increment before CIP22 (try_and_increment.rs, over the
DirectHasher), as syncing nodes hash committed seals, shares steps 3-6 (the
round's back end, _round_back); its front end hashes every (counter,
message) lane whole, the CRH of c || extra || msg and then the XOF of the
digest, over lane messages formed on the card from the messages' words.

Messages with no valid counter in [0, C1) go through a second round over
the counters [C1, C) and are merged on the card; only the [B] `has` mask
crosses to the host. Where the JAX package caches one executable per shape
(h2g_crh, h2g_round, h2g_merge), this module caches one CUDA graph per
shape under the same tags (utils/aotcache.py; the rounds before CIP22,
which the JAX package lacks, under h2g_round_direct): the CRH, each round
and the merge take device words and indices, and their host reads come
after the replay. Data (the Tonelli-Shanks tables, the cofactor's bits,
the Blake2s state) is cached per device, outside any capture.

Bit-exactness oracles: hash_to_curve/try_and_increment_cip22.py and
try_and_increment.py.
"""

import os

import numpy as np
import torch

from ..hash_to_curve.common import G1_BYTES, hash_length
from ..hostmath.params import G1_COFACTOR, P
from ..utils import aotcache
from ..utils.devices import require_device
from ..utils.profiling import count, device_span, stage
from ..utils.tree import tree_map
from . import blake2s as db
from . import curve as dc
from .field import FQ, LIMB_BITS, LIMB_MASK, _sub_limbs_u32, fq, int_to_limbs

TWO_ADICITY = 46
_S = (P - 1) >> TWO_ADICITY  # odd
assert _S % 2 == 1
HASH_BYTES = hash_length(G1_BYTES)  # 64: two Blake2s blocks of XOF output
# round-1 counter width (CELO_H2G_ROUND1 overrides it, as in the JAX
# package): with miss probability 0.58 per counter the two-round lane cost
# C1 + 0.58^C1 (C - C1) is least near C1 = 5
ROUND1_COUNTERS = 5
# the counter (utils/profiling.py::count) of a call's round-2 lanes
ROUND2_LANES = "h2g.round2_lanes"


def _nonresidue_z() -> int:
    """z = g^s for a quadratic nonresidue g, the order-2^46 Tonelli-Shanks
    constant."""
    g = 2
    while pow(g, (P - 1) // 2, P) == 1:
        g += 1
    return pow(g, _S, P)


_Z = _nonresidue_z()
_HALF_P_LIMBS = int_to_limbs((P - 1) // 2, FQ.n)


def _parse_candidates(xof_words, compat: bool):
    """XOF words [2, 8, B] (two 32-byte Blake2s blocks, LE) ->
    (x_raw int32 limbs [n, B], greatest [B], infinity [B], x_lt_p [B],
     x_is_zero [B]), the last four bool.

    Candidate layout parity: 48 LE bytes; x keeps bits [0, 377)
    (REPR_SHAVE mask); sign bit 377 in compat mode (deployed Celo,
    try_and_increment.rs:106-120) or flag bit 383; infinity flag bit 382
    (hash_to_curve/common.py)."""
    w = torch.cat([xof_words[0], xof_words[1]])[:12]  # the first 48 bytes
    # [24, B] 16-bit limbs of the 384-bit candidate: word j gives limbs 2j, 2j+1
    limbs = torch.stack([w & LIMB_MASK, w >> LIMB_BITS], dim=1).reshape(24, -1)
    # flags (before masking): bit 377 = limb 23 bit 9; 382 -> bit 14; 383 -> 15
    top = limbs[23]
    greatest = ((top >> (9 if compat else 15)) & 1) != 0
    infinity = ((top >> 14) & 1) != 0
    # REPR_SHAVE: keep 377 = 16*23 + 9 bits; then the guard limb up to FQ.n
    x_raw = torch.cat([
        limbs[:23], (top & 0x1FF)[None],
        torch.zeros((FQ.n - 24, limbs.shape[1]), dtype=limbs.dtype, device=limbs.device),
    ])
    # x < p by the subtraction's borrow
    _, borrow = _sub_limbs_u32(x_raw, FQ.column(FQ.p_limbs, x_raw.device, torch.int64))
    x_lt_p = borrow != 0
    x_is_zero = (x_raw == 0).all(dim=0)
    return x_raw.to(torch.int32), greatest, infinity, x_lt_p, x_is_zero


def _sqrt_prep(t):
    """Shared exponentiation for Legendre + Tonelli-Shanks:
    w = t^((s-1)/2); tt0 = w^2 * t  (= t^s); legendre = tt0^(2^45) == 1.
    Returns (w, tt0, is_qr)."""
    w = fq.pow_const(t, (_S - 1) // 2)
    tt0 = fq.mul(fq.mul(w, t), w)
    e = tt0
    for _ in range(TWO_ADICITY - 1):
        e = fq.sq(e)
    is_qr = fq.eq(e, FQ.ones(tuple(t.shape[1:]), t.device))
    return w, tt0, is_qr


_TS_DIGIT = 8  # bits per extracted 2-adic dlog digit
_TS_NDIG = (TWO_ADICITY + _TS_DIGIT - 1) // _TS_DIGIT  # 6
_TS_HOST = None
_TS_DEVICE = {}


def _ts_tables_host():
    """Host tables for the table-based Tonelli-Shanks, as numpy int32
    limbs: the 2-Sylow dlog e of u = t^s (u = z^e, e < 2^46) is extracted
    8 bits at a time by matching u^(2^(38-8j)) against the order-2^8
    subgroup (Bernstein, "Faster square roots in annoying finite fields"),
    and the root correction z^(-e/2) is assembled from per-digit gathers.

    Returns (match38_raw [n, 256], match40_raw [n, 64],
             upd[j] Montgomery [n, 256] = zinv^(d*2^(8j)),
             half[j] Montgomery [n, 256] = zinv^(d*2^(8j-1)) with
             half[0][d] = zinv^(d>>1))."""
    global _TS_HOST
    if _TS_HOST is not None:
        return _TS_HOST
    zinv = pow(_Z, -1, P)
    n = FQ.n

    def raw(vals):
        return np.stack([int_to_limbs(v, n) for v in vals], axis=-1)

    def mont(vals):
        return raw([v * FQ.mont_r % P for v in vals])

    match38 = raw([pow(_Z, k << 38, P) for k in range(256)])
    match40 = raw([pow(_Z, k << 40, P) for k in range(64)])
    upd = [mont([pow(zinv, d << (8 * j), P) for d in range(256)])
           for j in range(_TS_NDIG)]
    half = [mont([pow(zinv, (d >> 1) if j == 0 else d << (8 * j - 1), P)
                  for d in range(256)])
            for j in range(_TS_NDIG)]
    _TS_HOST = (match38, match40, upd, half)
    return _TS_HOST


def _ts_tables(device):
    """_ts_tables_host's tables as int32 tensors on `device`, cached."""
    device = torch.device(device)
    tbl = _TS_DEVICE.get(device)
    if tbl is None:
        match38, match40, upd, half = _ts_tables_host()
        to = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)  # noqa: E731
        tbl = _TS_DEVICE[device] = (
            to(match38), to(match40), [to(a) for a in upd], [to(a) for a in half]
        )
    return tbl


def _ts_match(u_pow, table_raw):
    """u_pow (Montgomery, lazy) vs raw canonical table [n, K]: returns the
    index [B] of the matching entry (the digit); 0 where none matches."""
    u_raw = fq.to_raw(u_pow)  # [n, B] canonical
    hit = (table_raw[:, :, None] == u_raw[:, None, :]).all(dim=0)  # [K, B]
    # argmax returns the first maximal index; bool has no argmax kernel
    return torch.argmax(hit.to(torch.int32), dim=0)


def _tonelli_shanks_finish(t, w):
    """Table-based Tonelli-Shanks from the shared prefix (w = t^((s-1)/2)):
    returns r with r^2 == t for QR t, garbage (and no error) otherwise.

    r = t^((s+1)/2) * z^(-e/2) where t^s = z^e in the order-2^46 2-Sylow
    subgroup; e is recovered 8 bits at a time (110 squarings + 6 table
    matches)."""
    match38, match40, upd, half = _ts_tables(t.device)
    r = fq.mul(w, t)        # t^((s+1)/2)
    u = fq.mul(r, w)        # t^s = z^e
    c_acc = None
    for j in range(_TS_NDIG):
        nsq = TWO_ADICITY - _TS_DIGIT * (j + 1)  # 38, 30, 22, 14, 6, -2
        if nsq > 0:
            up = u
            for _ in range(nsq):
                up = fq.sq(up)
            d = _ts_match(up, match38)
        else:
            d = _ts_match(u, match40)  # the last 6 bits, order-2^6 subgroup
        if j < _TS_NDIG - 1:
            u = fq.mul(u, torch.index_select(upd[j], -1, d))
        hj = torch.index_select(half[j], -1, d)
        c_acc = hj if c_acc is None else fq.mul(c_acc, hj)
    return fq.mul(r, c_acc)


def _select_greatest(y, greatest):
    """Pick y or p-y so the result is the lexicographically greatest root
    iff `greatest` (get_point_from_x parity). The comparison is on the
    field value, so the Montgomery form is stripped first (to_raw)."""
    y_can = fq.to_raw(y)
    # y > (p-1)/2  <=>  (p-1)/2 - y borrows
    _, borrow = _sub_limbs_u32(FQ.column(_HALF_P_LIMBS, y.device, torch.int64), y_can)
    want_flip = (borrow != 0) != greatest
    return fq.select(want_flip, fq.neg(y), y)


def _candidate_points(xof_words, compat: bool):
    """Per (message, counter) lane: returns (x_mont, greatest, valid, w, t);
    y needs the Tonelli-Shanks finish, this stage only computes validity."""
    x_raw, greatest, infinity, x_lt_p, x_is_zero = _parse_candidates(
        xof_words, compat
    )
    x = fq.from_raw(x_raw)
    t = fq.add(fq.mul(fq.sq(x), x), FQ.ones(tuple(x.shape[1:]), x.device))  # x^3 + 1
    w, _tt0, is_qr = _sqrt_prep(t)
    valid = x_lt_p & is_qr & ~(x_is_zero & infinity)
    return x, greatest, valid, w, t


def _pow2ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _round_back(xof, compat: bool, nc: int, m: int):
    """The back end of a round, shared by both variants, on the XOF words
    [2, 8, nc m] of lane c * m + i (counter c_lo + c of message i):
    candidate parse, Legendre validity, first-valid-counter selection,
    Tonelli-Shanks finish, sign select and cofactor multiply. Returns
    (projective [m] tree, has [m] bool tensor)."""
    x, greatest, valid, w, t = _candidate_points(xof, compat)
    vmat = valid.reshape(nc, m)
    # the first valid counter (argmax: the first maximal index)
    first = torch.argmax(vmat.to(torch.int32), dim=0)
    has = vmat.any(dim=0)
    lanes = first * m + torch.arange(m, device=x.device)
    xs, ws, ts = (torch.index_select(a, -1, lanes) for a in (x, w, t))
    y = _tonelli_shanks_finish(ts, ws)
    y = _select_greatest(y, greatest[lanes])
    pt = dc.g1.from_affine((xs, y))
    return dc.g1.scalar_mul_const(G1_COFACTOR, pt), has


def _round_body(words, msg_len: int, domain: bytes, compat: bool, nc: int, m: int):
    """One CIP22 round's device program on its XOF message words [16
    nblocks, nc m]: the Blake2Xs XOF, then _round_back. Returns
    (projective [m] tree, has [m] bool tensor). On the card the device span
    gpu.h2g.round."""
    with device_span("gpu.h2g.round", words):
        xof = db.blake2xs_batch(words, msg_len, HASH_BYTES, person=domain)
        return _round_back(xof, compat, nc, m)


def _lane_words(words, c_lo: int, nc: int):
    """The pre-CIP22 lanes' message words [16 nblocks, nc m] from the
    messages' words [16 nblocks, m], whose first byte is left 0 for the
    counter: lane c * m + i is c_lo + c || extra_data_i || message_i."""
    m = words.shape[1]
    ctr = torch.arange(c_lo, c_lo + nc, dtype=words.dtype, device=words.device)
    first = (words[0][None, :] | ctr[:, None]).reshape(1, nc * m)
    rest = words[1:, None, :].expand(-1, nc, m).reshape(-1, nc * m)
    return torch.cat([first, rest])


def _direct_round_body(words, idx, msg_len: int, domain: bytes, compat: bool,
                       c_lo: int, nc: int, m: int):
    """One pre-CIP22 round's device program (try_and_increment.rs): on the
    messages' words [16 nblocks, B] (lane_message_words), of the lanes
    `idx` [m] when given, else of all B = m, the DirectHasher's whole hash
    of every (counter, message) lane (the Blake2s CRH of c || extra || msg,
    then the Blake2Xs XOF of its digest; the device span
    gpu.h2g.lane_hash), then _round_back. A first valid candidate whose
    cofactor multiple is the point at infinity is not a hash: the host
    path moves on to the next counter, so the message goes to the host.
    Returns (projective [m] tree, [2, m] bool tensor: found, to the host).
    On the card the device span gpu.h2g.round."""
    with device_span("gpu.h2g.round", words):
        if idx is not None:
            words = torch.index_select(words, 1, idx)
        lanes = _lane_words(words, c_lo, nc)
        with device_span("gpu.h2g.lane_hash", lanes):
            xof = db._direct_hash_words(lanes, msg_len, HASH_BYTES, domain)
        jac, has = _round_back(xof, compat, nc, m)
        host = has & dc.g1.is_infinity(jac)
        return jac, torch.stack([has & ~host, host])


def _fused_round(crh_u8, ed, c_lo: int, nc: int, domain: bytes,
                 compat: bool, device):
    """One round for counters [c_lo, c_lo + nc) over the messages whose CRH
    digests are the rows of crh_u8 [m, crh_len] (32 bytes for the
    DirectHasher, 48 for the composite Pedersen CRH): the XOF messages are
    built on the host and copied to `device`, then _round_body runs as the
    graph h2g_round_<msg_len>_<domain>_<compat>_<nc>_<m>.

    Returns (projective [m] tree on `device`, has [m] numpy bool); lanes
    with has=False hold garbage points."""
    m, crh_len = crh_u8.shape
    edlen = ed.shape[-1]
    msg_len = 1 + edlen + crh_len
    nblocks = max(1, (msg_len + 63) // 64)
    # lane c * m + i: the XOF message c || extra_data_i || crh_i
    buf = np.zeros((nc * m, nblocks * 64), dtype=np.uint8)
    buf[:, 0] = np.repeat(
        np.arange(c_lo, c_lo + nc, dtype=np.uint16).astype(np.uint8), m
    )
    if edlen:
        # ed: [edlen] (shared) or [m, edlen] (per-message extra_data)
        buf[:, 1 : 1 + edlen] = np.tile(ed, (nc, 1)) if ed.ndim == 2 else ed
    buf[:, 1 + edlen : msg_len] = np.tile(crh_u8, (nc, 1))
    words = db.words_to_device(buf.view("<u4").T.copy(), device)
    fn = aotcache.jit(f"h2g_round_{msg_len}_{domain.hex()}_{int(compat)}_{nc}_{m}",
                      lambda wds: _round_body(wds, msg_len, domain, compat, nc, m))
    jac, has = fn(words)
    # the one host read of the round (it waits for the round's work)
    return jac, has.cpu().numpy()


def lane_message_words(messages, ed: np.ndarray, device):
    """The pre-CIP22 round's message words on `device`: int64 [16 nblocks,
    B] of 0 || extra_data_i || message_i, zero-padded to whole 64-byte
    blocks; the first byte is the counter's, which the round sets on the
    card (_lane_words). The messages' bytes cross to the card as they are
    and the words are formed there. Returns (words, msg_len)."""
    B = len(messages)
    lengths = set(map(len, messages))
    if len(lengths) != 1:
        raise ValueError("the pre-CIP22 round takes messages of one length")
    L = lengths.pop()
    edlen = ed.shape[-1]
    msg_len = 1 + edlen + L
    buf = torch.zeros((B, max(1, (msg_len + 63) // 64) * 64), dtype=torch.uint8,
                      device=device)
    if edlen:
        buf[:, 1 : 1 + edlen] = torch.from_numpy(ed.copy()).to(device)
    if L:
        raw = torch.frombuffer(bytearray().join(messages), dtype=torch.uint8)
        buf[:, 1 + edlen : msg_len] = raw.to(device).view(B, L)
    # little-endian words, as int64 holding [0, 2^32)
    words = buf.view(torch.int32).T.to(torch.int64) & db.MASK32
    return words.contiguous(), msg_len


def _direct_round(words, idx, msg_len: int, domain: bytes, compat: bool,
                  c_lo: int, nc: int):
    """One pre-CIP22 round for counters [c_lo, c_lo + nc) over the messages
    whose words are the columns of `words` on the card, or over the columns
    `idx` (a device tensor) of them: _direct_round_body as the graph
    h2g_round_direct_<msg_len>_<domain>_<compat>_<c_lo>_<nc>_<m>.

    Returns (projective [m] tree on the card, found [m], to the host [m]),
    the last two numpy bool; lanes found False hold garbage points."""
    m = words.shape[1] if idx is None else idx.shape[0]
    fn = aotcache.jit(
        f"h2g_round_direct_{msg_len}_{domain.hex()}_{int(compat)}_{c_lo}_{nc}_{m}",
        lambda wds, *ix: _direct_round_body(wds, ix[0] if ix else None, msg_len, domain,
                                            compat, c_lo, nc, m))
    jac, status = fn(words) if idx is None else fn(words, idx)
    # the one host read of the round (it waits for the round's work)
    found, host = status.cpu().numpy()
    return jac, found, host


def _round2_chunks(pending, B: int, nc: int):
    """The round-2 chunks of the `pending` messages: (chunk, idx) with idx
    the chunk padded to the cap by repeating its first lane. Counts the
    round-2 lanes (cap x nc each chunk, padding included) under
    ROUND2_LANES."""
    cap = min(_pow2ceil(len(pending)), max(32, _pow2ceil(B // 16)))
    out = []
    for i in range(0, len(pending), cap):
        chunk = pending[i : i + cap]
        m = len(chunk)
        idx = (np.concatenate([chunk, np.full(cap - m, chunk[0])])
               if m < cap else chunk)
        out.append((chunk, idx))
    count(ROUND2_LANES, cap * nc * len(out))
    return out


def _merge(full, part, idx, ok):
    """Lanes idx of `full` take `part` where ok, else keep their value. The
    padding of a round-2 chunk repeats its first lane, so idx holds
    duplicates, but every copy of a lane carries the same value: the
    unordered write of index_copy is harmless."""
    return tree_map(
        lambda f, p: f.index_copy(
            -1, idx, torch.where(ok[None], p, torch.index_select(f, -1, idx))),
        full, part,
    )


def extra_data_rows(extra_data, B: int) -> np.ndarray:
    """extra_data as hash_to_g1_device takes it -> uint8 numpy: [edlen]
    when shared, [B, edlen] per message. Per-message entries must have one
    length; entries that are all empty are the shared b""."""
    if isinstance(extra_data, (bytes, bytearray)):
        return np.frombuffer(bytes(extra_data), dtype=np.uint8)
    if len(extra_data) != B:
        raise ValueError(f"{len(extra_data)} extra_data entries for {B} messages")
    lengths = {len(e) for e in extra_data}
    if len(lengths) != 1:
        raise ValueError(f"per-message extra_data of unequal lengths {sorted(lengths)}")
    if lengths == {0}:
        return np.zeros(0, dtype=np.uint8)
    return np.frombuffer(b"".join(extra_data), dtype=np.uint8).reshape(B, -1)


def extra_data_of(extra_data, i: int) -> bytes:
    """Message i's extra_data (shared bytes or a per-message list)."""
    if isinstance(extra_data, (bytes, bytearray)):
        return bytes(extra_data)
    return bytes(extra_data[i])


def hash_to_g1_device(domain: bytes, messages, extra_data=b"",
                      compat: bool = True, num_counters: int = 16,
                      crh_u8=None, device="cuda", cip22: bool = True):
    """The try-and-increment core on `device`: returns (jac_points,
    has_mask), the hashed points as a projective batch on `device` and a
    numpy bool mask of the messages whose first valid counter fell inside
    [0, num_counters). Lanes with has=False hold garbage: route them to the
    host fallback (hash_to_g1_direct_cip22_batch does).

    extra_data: shared bytes, or a list of B per-message byte strings of
    one length (all empty is the shared b"").
    crh_u8: optional precomputed CRH bytes [B, crh_len] uint8, the CIP22
    CRH step. When None, the DirectHasher CRH (batched Blake2s) runs here;
    pass the composite Pedersen digests (ops/pedersen.py::bh_crh_digests)
    for the CompositeHasher path.

    cip22=False: the try-and-increment before CIP22 (try_and_increment.rs)
    over the DirectHasher: every (counter, message) lane is hashed whole,
    c || extra_data || message through the CRH and the XOF, its lanes'
    messages formed on the card from the messages' bytes (the host stage
    h2g.pack copies them in). It takes no crh_u8.

    Two rounds: counters [0, C1) for every message, then the remaining
    counters for the unresolved messages only, padded to a fixed cap
    (their lanes counted under ROUND2_LANES). First-valid-counter
    semantics are kept exactly: a message reaches round 2 iff every
    round-1 counter was invalid, and the rounds' counter ranges are
    disjoint."""
    device = require_device(device)
    B = len(messages)
    C = num_counters
    ed = extra_data_rows(extra_data, B)
    C1 = min(int(os.environ.get("CELO_H2G_ROUND1", ROUND1_COUNTERS)), C)
    if not cip22:
        if crh_u8 is not None:
            raise ValueError("the pre-CIP22 round hashes each lane whole: no crh_u8")
        return _hash_direct(domain, messages, ed, compat, C, C1, device)

    if crh_u8 is None:
        with stage("h2g.crh"):
            words = db.words_to_device(db.pack_messages(messages), device)
            mlen = len(messages[0])
            crh = aotcache.jit(f"h2g_crh_{mlen}_{domain.hex()}",
                               lambda wds: db.blake2s_batch(
                                   wds, mlen, digest_size=32,
                                   node_offset=db._xof_node_offset(HASH_BYTES),
                                   person=domain))(words)
            # [B, 32] LE digest bytes
            crh_u8 = crh.cpu().numpy().T.astype("<u4").copy().view(np.uint8)
    else:
        crh_u8 = np.asarray(crh_u8, dtype=np.uint8)
        if crh_u8.shape[0] != B:
            raise ValueError(f"{crh_u8.shape[0]} CRH rows for {B} messages")

    with stage("h2g.round1"):
        jac, has = _fused_round(crh_u8, ed, 0, C1, domain, compat, device)
    return _round2(jac, has, ~has, C - C1, device, lambda idx, _idx_t: _fused_round(
        crh_u8[idx], ed[idx] if ed.ndim == 2 else ed, C1, C - C1, domain, compat, device))


def _hash_direct(domain, messages, ed, compat, C, C1, device):
    """hash_to_g1_device with cip22=False."""
    with stage("h2g.pack"):
        words, msg_len = lane_message_words(messages, ed, device)
    with stage("h2g.round1"):
        jac, has, host = _direct_round(words, None, msg_len, domain, compat, 0, C1)
    return _round2(jac, has, ~has & ~host, C - C1, device, lambda _idx, idx_t: _direct_round(
        words, idx_t, msg_len, domain, compat, C1, C - C1)[:2])


def _round2(jac, has, pending, nc: int, device, run_chunk):
    """Round 2 over the messages of the mask `pending` and the nc counters
    after round 1's, in chunks (_round2_chunks): run_chunk(idx, idx_t), idx
    the chunk's lanes in numpy and on the card, returns its (projective
    tree, found numpy bool); its found lanes are merged into `jac` on the
    card. Returns (jac, has), has a copy updated."""
    has = has.copy()
    chunks = _round2_chunks(np.nonzero(pending)[0] if nc > 0 else np.zeros(0, np.int64),
                            len(has), nc)
    if chunks:
        with stage("h2g.round2"):
            for chunk, idx in chunks:
                idx_t = torch.from_numpy(idx.astype(np.int64)).to(device)
                jac2, has2 = run_chunk(idx, idx_t)
                # merge on the card: lanes resolved in round 2 take the new
                # point
                merge = aotcache.jit(f"h2g_merge_{len(idx)}", _merge)
                jac = merge(jac, jac2, idx_t, torch.from_numpy(has2).to(device))
                has[chunk[has2[:len(chunk)]]] = True
    return jac, has


def host_fallback(hasher, domain, messages, extra_data, has, compat=True,
                  cip22=True):
    """The reference's semantics for the messages with no valid counter in
    [0, C): {lane: host affine point} from TryAndIncrementCIP22 over
    `hasher`, or with cip22=False from TryAndIncrement (255 tries)."""
    from ..hash_to_curve.try_and_increment import TryAndIncrement
    from ..hash_to_curve.try_and_increment_cip22 import TryAndIncrementCIP22

    if cip22:
        h2c = TryAndIncrementCIP22(hasher, "g1", compat)
        hash_one = h2c.hash_with_attempt_cip22
    else:
        hash_one = TryAndIncrement(hasher, "g1", compat).hash_with_attempt
    return {
        int(i): hash_one(domain, messages[i], extra_data_of(extra_data, i))[0]
        for i in np.nonzero(~has)[0]
    }


def _hash_batch(hasher, domain, messages, extra_data, compat, num_counters,
                crh_u8, device):
    out_jac, has = hash_to_g1_device(
        domain, messages, extra_data, compat, num_counters, crh_u8, device
    )
    pts = dc.g1_unpack(out_jac)
    for i, pt in host_fallback(hasher, domain, messages, extra_data, has,
                               compat).items():
        pts[i] = pt
    return pts


def hash_to_g1_direct_cip22_batch(domain: bytes, messages, extra_data=b"",
                                  compat: bool = True, num_counters: int = 16,
                                  device="cuda"):
    """Batched CIP22 try-and-increment over the DirectHasher on `device`.
    messages: equal-length byte strings. Returns a list of host affine G1
    points (the rare no-counter-found lanes fall back to the host path:
    the same semantics, probability ~0.58^num_counters a message).

    Reference semantics: TryAndIncrementCIP22(DirectHasher).hash
    (try_and_increment_cip22.rs:81-134, direct.rs:23-79)."""
    from ..hashers.direct import DirectHasher

    device = require_device(device)
    return _hash_batch(DirectHasher(), domain, messages, extra_data, compat,
                       num_counters, None, device)


def hash_to_g1_composite_cip22_batch(domain: bytes, messages, extra_data=b"",
                                     compat: bool = True,
                                     num_counters: int = 16, device="cuda"):
    """Batched CIP22 try-and-increment over the composite hasher, the
    reference's production sign-path hash, on `device`: the Bowe-Hopwood
    Pedersen CRH (ops/pedersen.py) feeds its 48-byte x-coordinate digests
    into the Blake2Xs counter scan.

    Reference semantics: TryAndIncrementCIP22(CompositeHasher).hash
    (try_and_increment_cip22.rs:81-134 with composite.rs:80-95)."""
    from ..hashers.composite import composite_hasher

    device = require_device(device)
    crh_u8 = composite_crh_bytes(messages, device)
    return _hash_batch(composite_hasher(), domain, messages, extra_data,
                       compat, num_counters, crh_u8, device)


def composite_crh_bytes(messages, device) -> np.ndarray:
    """The composite CRH digests of `messages` as a [B, 48] uint8 array."""
    from . import pedersen as ped

    crh = ped.bh_crh_digests(messages, device)
    return np.frombuffer(b"".join(crh), dtype=np.uint8).reshape(len(messages), -1)
