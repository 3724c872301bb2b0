"""The host work of the set-up and of the judgement, spread over worker
processes, and the per-checkout cache of reference hashes.

Workers are spawned (never forked: the parent holds CUDA and threads) and
import only this package. A job's arguments and result are Python ints, tuples
and numpy arrays.
"""

import hashlib
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from . import group, hashing, pack, verify
from .params import G2_GENERATOR, R

HERE = Path(__file__).resolve().parent
CACHE_DIR = HERE.parent / ".cache" / "hashes"
CHUNK = 256  # messages a cache file (and a worker job)


def pool(workers: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))


def default_workers() -> int:
    """All cores but the one that drives the card."""
    return max(1, (os.cpu_count() or 2) - 1)


# --- reference hashes, cached per checkout ----------------------------------

def _source_digest() -> str:
    """Digest of the reference's own sources: a cache entry made by other
    code is never read."""
    h = hashlib.sha256()
    for f in sorted(HERE.glob("*.py")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


HASH_KEYS = ("hasher", "cip22", "compat", "domain", "message_format", "message_digest",
             "message_suffix", "extra_format")
MISS_SECONDS = [0.0]  # seconds this process waited for hashes the cache lacked


def message(spec, i: int) -> bytes:
    """Message i: the configuration's message_format filled with i, or,
    where it names the digest sha256, that digest of it followed by
    message_suffix (hex)."""
    m = (spec["message_format"] % i).encode()
    if spec.get("message_digest") == "sha256":
        m = hashlib.sha256(m).digest() + bytes.fromhex(spec.get("message_suffix", ""))
    return m


def extra(spec, i: int) -> bytes:
    fmt = spec["extra_format"]
    return (fmt % i if "%" in fmt else fmt).encode()


def hash_spec(config):
    """The keys of a configuration that fix its message hashes."""
    return {k: config[k] for k in HASH_KEYS if k in config}


def hash_chunk(spec, start, count):
    """Affine hashes of messages start .. start+count-1 as bytes, 96 a point
    (x then y, 48 bytes little-endian each)."""
    out = bytearray()
    for i in range(start, start + count):
        pt = hashing.hash_to_g1(spec["hasher"], spec["domain"].encode(), message(spec, i),
                                extra(spec, i), spec["compat"], spec.get("cip22", True))
        out += pt[0].to_bytes(48, "little") + pt[1].to_bytes(48, "little")
    return bytes(out)


def _points(buf):
    a = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 96)
    return [(int.from_bytes(r[:48].tobytes(), "little"),
             int.from_bytes(r[48:].tobytes(), "little")) for r in a]


def message_hashes(ex, config, indices):
    """{index: affine hash} of the configuration's messages `indices`, from
    the cache where it has them, else computed on the pool `ex` and cached.
    The seconds spent waiting for the missing ones add to MISS_SECONDS."""
    spec = hash_spec(config)
    key = hashlib.sha256(repr((_source_digest(), sorted(spec.items()))).encode()).hexdigest()[:16]
    chunks = sorted({i // CHUNK for i in indices})
    paths = {c: CACHE_DIR / f"{key}_{c}.bin" for c in chunks}
    missing = [c for c in chunks if not paths[c].exists()]
    t = time.perf_counter()
    jobs = {c: ex.submit(hash_chunk, spec, c * CHUNK, CHUNK) for c in missing}
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    for c, job in jobs.items():
        tmp = paths[c].with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(job.result())
        os.replace(tmp, paths[c])
    if missing:
        MISS_SECONDS[0] += time.perf_counter() - t
    out = {}
    for c in chunks:
        for j, pt in enumerate(_points(paths[c].read_bytes())):
            out[c * CHUNK + j] = pt
    return {i: out[i] for i in indices}


# --- scalar multiplications --------------------------------------------------

def g1_muls(pairs):
    """[(k, P)] -> [k P]."""
    return [group.G1.mul(k, p) for k, p in pairs]


_G2_TABLE = []


def _g2_table():
    if not _G2_TABLE:
        _G2_TABLE.append(group.G2.fixed_base_table(G2_GENERATOR, 8, R.bit_length()))
    return _G2_TABLE[0]


def block_keys(h, sks):
    """One block's public keys sk G2 and signatures sk H."""
    table = group.G1.fixed_base_table(h, 4, R.bit_length())
    return ([group.G2.fixed_base_mul(_g2_table(), k) for k in sks],
            [group.G1.fixed_base_mul(table, k) for k in sks])


def seal_lanes(hashes, sks, multiples):
    """The seals sigma = sk H of hashes H under their committees' keys, and
    the points their lanes draw on: k H and k sigma for k = 1 .. multiples,
    base-major (flat index j * multiples + k - 1), packed as the card's limbs
    with x under each power of group.endo: ([x, OMEGA x, OMEGA^2 x], y).
    Returns (seals, hash lanes, seal lanes)."""
    sigs = [group.G1.mul(sk, h) for sk, h in zip(sks, hashes)]
    packed = []
    for pts in (hashes, sigs):
        rows = group.multiples(pts, multiples)
        flat = [rows[k][j] for j in range(len(pts)) for k in range(multiples)]
        packed.append(([pack.fq(group.endo(q, e)[0] for q in flat) for e in range(3)],
                       pack.fq(q[1] for q in flat)))
    return sigs, packed[0], packed[1]


def g2_mul(k):
    return group.G2.fixed_base_mul(_g2_table(), k)


# --- the judgement ------------------------------------------------------------

def block_ok(mode, form, h, sigs, pks, sks, exps, seed):
    """One block's verdict under `mode` (strict, screen or individual), in
    the pairing form or the discrete-logarithm form (verify.py)."""
    if form == "pairing":
        if mode == "strict":
            return verify.strict_block_ok(h, sigs, pks, exps)
        if mode == "screen":
            return verify.screen_block_ok(h, sigs, pks)
        if mode == "individual":
            return verify.individual_block_ok(h, sigs, pks, seed)
    elif form == "dl":
        if mode == "strict":
            return verify.strict_block_dl(h, sigs, sks, exps)
        if mode == "screen":
            return verify.screen_block_dl(h, sigs, sks)
        if mode == "individual":
            return verify.individual_block_dl(h, sigs, sks)
    raise ValueError(f"unknown block check {mode!r} in form {form!r}")
