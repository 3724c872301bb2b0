"""Multi-scalar multiplication on the device (the PyTorch counterpart of the
JAX package's ops/msm.py).

The Groth16 prover's MSM workload and the PublicKey/Signature::batch path
(crates/bls-crypto/src/bls/public.rs:47-65).

Three forms:

1. PIPPENGER (`msm_pippenger`) — the throughput path, scatter-free:
     - the HOST plans each c-bit window: sort permutation of the points by
       digit (numpy argsort) + the 2^c-1 bucket-boundary positions;
     - the DEVICE, per window, gathers points into sorted order, lays them
       out column-major [L lanes x K], computes per-lane suffix partial
       sums with K steps of mixed adds (this is the bucket accumulation:
       B adds), completes suffix sums T_j with a log(L) recursive-doubling
       pass over lane totals, and applies the telescoping identity
         sum_i d_i P_i = sum_{b=1}^{2^c-1} T_{pos(b)},
       pos(b) = first sorted index with digit >= b — so the whole bucket
       combine is ONE gather + one msum, no scatter anywhere;
     - windows combine MSB->LSB by Horner doubling.
   Total work ~ ceil(nbits/c) * B mixed adds + O(2^c) per window, robust
   to arbitrarily skewed digit distributions (0/1-heavy witness vectors
   put thousands of points in one bucket; the suffix formulation does not
   care).

2. BIT-PLANE (`msm_g1`/`msm_g2`) — the small-batch / no-host-plan form
   (~nbits adds per point): sum_b 2^b * (masked lane sum).

3. STRAUS (`straus_msm_groups`) — many small MSMs that share the Horner
   doubling.

Plus FIXED-BASE batch scalar multiplication (`fixed_base_batch_mul`) for
the Groth16 setup's millions of generator multiples: a host-precomputed
window table [W * 2^c] and W steps of gather + mixed add.

Where the JAX package scans (lax.scan, fori_loop) this module loops in
Python: every step is a handful of launches. msm_pippenger and
fixed_base_batch_mul run their device programs as one CUDA graph per shape
(utils/aotcache.py), as the JAX package runs one executable per shape.
"""

import numpy as np
import torch

from ..utils import aotcache
from ..utils.config import get_config
from ..utils.devices import require_device
from ..utils.profiling import device_sync, stage
from ..utils.tree import tree_leaves, tree_map
from . import curve as dc
from .field import FQ


def _take(tree, idx):
    """Per-lane gather on the last axis of every leaf."""
    return tree_map(lambda t: torch.index_select(t, -1, idx), tree)


def _device_of(tree):
    return tree_leaves(tree)[0].device


def _curve_name(curve) -> str:
    """The curve's name in ops/curve.py, for the graph tags."""
    for name in ("g1", "g2", "bw6_g1", "bw6_g2"):
        if getattr(dc, name) is curve:
            return name
    return f"curve{id(curve)}"


def _to_device(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


def _index_tensor(a, device) -> torch.Tensor:
    """Integer indices (numpy or a tensor) -> int64 on `device`, converted
    after the copy: half the bytes of int32 plans cross to the card."""
    return _to_device(a, device).long()


# ---------------------------------------------------------------------------
# Bit-plane MSM (small batches; no host planning)
# ---------------------------------------------------------------------------

def _bitplane_msm(curve, bits, pts_jac):
    """bits: [nbits, B] (MSB first); pts_jac: projective batch [B].
    Returns batch-1 projective point."""
    device = _device_of(pts_jac)
    inf = curve.infinity(bits.shape[1:], device)
    # accumulate MSB -> LSB with Horner doubling:
    #   acc = 2*acc + (masked lane sum of bit row b)
    acc = curve.infinity((1,), device)
    for bitrow in bits:
        masked = curve.tree_select(bitrow != 0, pts_jac, inf)
        acc = curve.add(curve.double(acc), curve.msum(masked))
    return acc


def msm_g1(bits, pts_jac):
    return _bitplane_msm(dc.g1, bits, pts_jac)


def msm_g2(bits, pts_jac):
    return _bitplane_msm(dc.g2, bits, pts_jac)


# ---------------------------------------------------------------------------
# Scalars and window digits (host)
# ---------------------------------------------------------------------------

class RawScalarVec:
    """B scalars carried as a canonical RAW (non-Montgomery) limb matrix
    [n, B] of 16-bit limbs — the zero-marshaling scalar representation
    between a device NTT output (field.to_raw) and MSM planning. Values
    MUST be canonical (< modulus); digit extraction reads the limb bytes
    directly, so nothing is ever converted to a python int."""

    def __init__(self, limbs, spec):
        self.limbs = np.asarray(limbs)
        self.spec = spec

    def __len__(self):
        return int(self.limbs.shape[-1])

    def __iter__(self):
        return iter(self.to_ints())

    def __eq__(self, other):
        if isinstance(other, RawScalarVec):
            other = other.to_ints()
        return self.to_ints() == other

    def byte_matrix(self, nb: int) -> np.ndarray:
        """[B, nb] uint8 little-endian bytes (zero-padded columns)."""
        a8 = (
            self.limbs.astype(np.uint16)
            .astype("<u2")
            .T.copy()
            .view(np.uint8)
        )
        if a8.shape[1] < nb:
            a8 = np.pad(a8, ((0, 0), (0, nb - a8.shape[1])))
        return a8[:, :nb]

    def to_ints(self) -> list:
        return self.spec.unpack_raw(self.limbs)


def _scalar_byte_matrix(scalars, nbits: int, pad_to=None) -> np.ndarray:
    """Scalars (python ints or RawScalarVec) -> [B, nb] uint8 LE byte
    matrix with nb = ceil(nbits/8) + 4 trailing zero bytes, so any
    window of c <= 24 bits can be read as one unaligned uint32."""
    nb = (nbits + 7) // 8 + 4
    B0 = len(scalars)
    B = pad_to or B0
    if isinstance(scalars, RawScalarVec):
        a8 = scalars.byte_matrix(nb)
    else:
        buf = b"".join(int(s).to_bytes(nb, "little") for s in scalars)
        a8 = np.frombuffer(buf, dtype=np.uint8).reshape(B0, nb)
    if B > B0:
        a8 = np.pad(a8, ((0, B - B0), (0, 0)))
    return a8


def _window_matrix(a8: np.ndarray, nbits: int, c: int,
                   dtype=np.int64) -> np.ndarray:
    """[W, B] window digits from a byte matrix, LSB-first window order
    (row w = bits [c*w, c*w+c)), fully vectorized for any c <= 24 (a
    window then fits one unaligned 32-bit read). Transposes the byte
    matrix once so each window reads 4 CONTIGUOUS rows."""
    assert 1 <= c <= 24, c
    B, nb = a8.shape
    W = -(-nbits // c)
    mask = np.uint32((1 << c) - 1)
    aT = np.ascontiguousarray(a8.T).astype(np.uint32)  # [nb, B]
    out = np.empty((W, B), dtype=dtype)
    for w in range(W):
        bit = c * w
        i0 = bit >> 3
        v = (
            aT[i0]
            | (aT[i0 + 1] << 8)
            | (aT[i0 + 2] << 16)
            | (aT[i0 + 3] << 24)
        )
        out[w] = (v >> np.uint32(bit & 7)) & mask
    return out


def window_digits(scalars, nbits: int, c: int):
    """[nw, B] int32 window digits, MSB-first (nw = ceil(nbits/c))."""
    a8 = _scalar_byte_matrix(scalars, nbits)
    return _window_matrix(a8, nbits, c)[::-1].astype(np.int32).copy()


# ---------------------------------------------------------------------------
# Straus grouped MSM (many small MSMs sharing the Horner doubling)
# ---------------------------------------------------------------------------

def straus_msm_groups(curve, digits, pts_jac, groups: int, c: int):
    """Many small MSMs in one program: out[g] = sum_i k_i * P_i over the
    lanes of group g (G equal contiguous groups).

    The strict-batch verifier's shape (crates/bls-crypto/src/bls/
    batch.rs:44-84: per-epoch random-linear combinations of ~20 points
    with ~136-bit exponents, hundreds of epochs at once). The Horner
    doubling runs at GROUP width and each window costs one per-lane table
    gather + a grouped lane-sum:

      - per-lane multiples table T[m] = m*P, m < 2^c (2^c - 2 adds, once),
      - windows MSB-first: acc = 2^c*acc (G lanes); acc += group-sums of
        T[digit] (one gather + msum_groups).

    digits: [nw, B] integer tensor in [0, 2^c) (window_digits). pts_jac:
    projective batch [B], B % groups == 0. Returns projective [groups].
    """
    nw, B = digits.shape
    assert B % groups == 0
    device = _device_of(pts_jac)
    table = [curve.infinity((B,), device), pts_jac]
    for _ in range(2, 1 << c):
        table.append(curve.add(table[-1], pts_jac))
    # leaves [2^c, n, B]
    T = tree_map(lambda *xs: torch.stack(xs), *table)
    digits = torch.as_tensor(digits, device=device).long()

    def gather(d):
        # per-lane table entry T[d[l], :, l]: exactly one entry per lane,
        # the same limbs as the JAX package's 2^c masked adds
        def sel(t):
            idx = d[None, None, :].expand(1, t.shape[1], B)
            return torch.gather(t, 0, idx)[0]

        return tree_map(sel, T)

    # small groups want a narrow fold: with V = B/groups ~ 20 lanes the
    # default fold_lanes=128 pads each group to 32 and runs 4 recursive-
    # doubling rounds; folding at 4 lanes costs a third of that
    fold = max(2, min(8, 1 << ((B // groups).bit_length() // 2)))
    acc = curve.infinity((groups,), device)
    for d in digits:
        for _ in range(c):
            acc = curve.double(acc)
        s = curve.msum_groups(gather(d), groups, fold_lanes=fold)
        acc = curve.add(acc, s)
    return acc


# ---------------------------------------------------------------------------
# Pippenger
# ---------------------------------------------------------------------------

def _auto_c(B: int, nbits: int = 253) -> int:
    """Window size minimizing W*(B + 2*2^c)."""
    best, best_cost = 4, None
    for c in range(4, 17):
        W = -(-nbits // c)
        cost = W * (B + 2 * (1 << c))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def _auto_lanes(B0: int) -> int:
    """Scan width L: about 16-32 madd steps (K = B/L) per window."""
    return 1 << max(3, min(15, B0.bit_length() - 5))


def plan_msm(scalars, nbits: int, c: int, L: int, fast_digits: bool = True):
    """Host-side window planning. Returns numpy arrays:
    perm [W, B], lin [W, 2^c-1], lane [W, 2^c-1], valid [W, 2^c-1]
    (B = len(scalars) padded to a multiple of L; pad scalars are 0).
    `scalars` is a list of python ints or a RawScalarVec (device NTT
    output — digits come straight off the limb bytes)."""
    # a window must fit one unaligned 32-bit read of the byte matrix
    assert 1 <= c <= 24, f"window of {c} bits: plan_msm takes c <= 24"
    B0 = len(scalars)
    B = B0 + ((-B0) % L)
    K = B // L
    W = -(-nbits // c)
    mask = (1 << c) - 1
    if fast_digits:
        # vectorized for every c: one byte matrix + W unaligned u32 reads;
        # uint16 digits make numpy's stable argsort a RADIX sort
        a8 = _scalar_byte_matrix(scalars, nbits, pad_to=B)
        dt = np.uint16 if c <= 16 else np.int64
        digits = _window_matrix(a8, nbits, c, dtype=dt)[::-1]
    else:
        sc = list(scalars) + [0] * (B - B0)
        digits = np.zeros((W, B), dtype=np.int64)
        for i, s in enumerate(sc):
            s = int(s)
            for w in range(W):
                digits[W - 1 - w, i] = (s >> (c * w)) & mask
        if c <= 16:
            digits = digits.astype(np.uint16)
    perm = np.zeros((W, B), dtype=np.int32)
    lin = np.zeros((W, (1 << c) - 1), dtype=np.int32)
    lane = np.zeros((W, (1 << c) - 1), dtype=np.int32)
    valid = np.zeros((W, (1 << c) - 1), dtype=bool)
    bvals = np.arange(1, 1 << c)

    def plan_window(w):
        order = np.argsort(digits[w], kind="stable").astype(np.int32)
        ds = digits[w][order]
        pos = np.searchsorted(ds, bvals, side="left")
        ok = pos < B
        posc = np.minimum(pos, B - 1)
        l = posc // K
        off = posc % K
        perm[w] = order
        lin[w] = (K - 1 - off) * L + l
        lane[w] = l
        valid[w] = ok

    if W >= 4 and B >= 1 << 16:
        # argsort releases the GIL
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(4) as ex:
            list(ex.map(plan_window, range(W)))
    else:
        for w in range(W):
            plan_window(w)
    return perm, lin, lane, valid, B


def plan_to_device(perm, lin, lane, valid, device):
    """plan_msm's arrays -> the tensors _pippenger_device reads on `device`
    (int64 indices, bool mask), the arguments of its graph."""
    idx = tuple(_index_tensor(a, device) for a in (perm, lin, lane))
    return (*idx, _to_device(valid, device))


def plan_msm_generic(scalars, nbits: int, c: int, L: int):
    """plan_msm with the per-scalar digit loop (oracle for the
    byte-slicing fast path)."""
    return plan_msm(scalars, nbits, c, L, fast_digits=False)


def _pippenger_device(curve, points_aff, perm, lin, lane, valid, c: int, L: int):
    """One projective batch-1 point = sum_i scalar_i * P_i (see module doc).
    points_aff: (x, y) affine leaves [n, B] on the device; plan arrays from
    plan_msm (numpy, or tensors as plan_to_device makes them: the graph
    takes those). One window's partial sums live at a time."""
    device = _device_of(points_aff)
    W, B = perm.shape
    K = B // L
    nb = lin.shape[1]  # 2^c - 1
    lanes_iota = torch.arange(L, device=device)
    inf_L = curve.infinity((L,), device)
    inf_nb = curve.infinity((nb,), device)

    def to_dev(a, dtype):  # a plan row: numpy, or a tensor already there
        return torch.as_tensor(a).to(device, dtype)

    acc = curve.infinity((1,), device)
    for w in range(W):
        pw, linw, lanew = (to_dev(a[w], torch.int64) for a in (perm, lin, lane))
        validw = to_dev(valid[w], torch.bool)
        # Horner shift of the running accumulator
        for _ in range(c):
            acc = curve.double(acc)
        # column-major: lane l owns sorted range [l*K, (l+1)*K); step t is
        # the original local offset K-1-t
        srt = tree_map(
            lambda t: torch.index_select(t, -1, pw).reshape(t.shape[0], L, K),
            points_aff,
        )
        a = inf_L
        partials = []
        for t in range(K):
            pt = tree_map(lambda s: s[:, :, K - 1 - t], srt)
            # bases are canonical limbs: cheap infinity test
            a = curve.madd(a, pt, canonical_bases=True)
            partials.append(a)
        del srt
        # inclusive suffix sums of lane totals via recursive doubling
        csuf = a
        for r in range(L.bit_length() - 1):
            shift = 1 << r
            rolled = tree_map(lambda x: torch.roll(x, -shift, dims=-1), csuf)
            rolled = curve.tree_select(lanes_iota >= L - shift, inf_L, rolled)
            csuf = curve.add(csuf, rolled)
        # csuf_next[l] = csuf[l+1], last lane -> infinity
        csuf_next = curve.tree_select(
            lanes_iota == L - 1,
            inf_L,
            tree_map(lambda x: torch.roll(x, -1, dims=-1), csuf),
        )
        # T at the 2^c-1 bucket boundaries: within-chunk partial + tail
        Wg = tree_map(
            lambda *ts: torch.index_select(torch.cat(ts, dim=-1), -1, linw),
            *partials,
        )
        del partials
        Cg = _take(csuf_next, lanew)
        T = curve.tree_select(validw, curve.add(Wg, Cg), inf_nb)
        acc = curve.add(acc, curve.msum(T, fold_lanes=1024))
    return acc


def _pippenger_jit(curve, c: int, L: int) -> aotcache.AotJit:
    """_pippenger_device as one CUDA graph per shape, one AotJit per (curve,
    c, L)."""
    return aotcache.jit(
        f"pip_{_curve_name(curve)}_c{c}_L{L}",
        lambda pts, perm, lin, lane, valid: _pippenger_device(
            curve, pts, perm, lin, lane, valid, c, L), curve)


_BASE_PACK_CACHE = {}


def msm_pippenger(points, scalars, curve=None, spec=None, nbits=None,
                  c=None, L=None, pack_fn=None, unpack_fn=None,
                  cache_key=None, device="cuda"):
    """Host entry: affine host points (None = infinity) x python-int
    scalars -> affine host point. Defaults to BLS12-377 G1; pass
    (curve=dc.bw6_g1, spec=FQ761, nbits=377) for BW6-761 G1/G2, or custom
    pack_fn/unpack_fn for tower-coordinate groups (BLS12-377 G2).

    cache_key: opaque hashable identifying a FIXED base-point set (e.g. a
    proving-key query array). When set, the packed device-resident bases
    are memoized so repeated proofs skip the host marshaling — the caller
    guarantees the same key is never reused with different points."""
    device = require_device(device)
    cfg = get_config()
    curve = curve or dc.g1
    spec = spec or FQ
    nbits = nbits or 253
    B0 = len(points)
    c = c or cfg.msm_window or _auto_c(B0, nbits)
    if L is None:
        L = cfg.msm_lanes or _auto_lanes(B0)
    with stage("msm.plan"):
        sc = scalars if isinstance(scalars, RawScalarVec) else list(scalars)
        perm, lin, lane, valid, B = plan_msm(sc, nbits, c, L)
    full_key = (cache_key, B0, B, device) if cache_key is not None else None
    pts_aff = _BASE_PACK_CACHE.get(full_key) if full_key else None
    if pts_aff is None:
        with stage("msm.pack_bases"):
            if isinstance(points, dc.PointVec):
                # raw uint16 limbs to the device + one from_raw multiply:
                # no host Montgomery mulmods
                pts_aff = points.device_montgomery(device, B)
            else:
                pts = list(points) + [None] * (B - B0)
                pts_aff = (pack_fn(pts, device) if pack_fn
                           else dc.pack_affine(spec, pts, device))
            device_sync(pts_aff)
        if full_key is not None and cfg.msm_cache_bases:
            _BASE_PACK_CACHE[full_key] = pts_aff
    with stage("msm.device"):
        plan = plan_to_device(perm, lin, lane, valid, device)
        out = _pippenger_jit(curve, c, L)(pts_aff, *plan)
        device_sync(out)
    if unpack_fn is not None:
        return unpack_fn(out)[0]
    return dc.unpack_jac(spec, out)[0]


# ---------------------------------------------------------------------------
# Fixed-base batch scalar multiplication (Groth16 setup workload)
# ---------------------------------------------------------------------------

def fixed_base_plan(scalars, nbits: int, c: int):
    """digits [W, B] int32: digits[w, i] = window w (LSB-first) of scalar i,
    offset into the window table (idx = w*2^c + digit)."""
    W = -(-nbits // c)
    a8 = _scalar_byte_matrix(scalars, nbits)
    digits = _window_matrix(a8, nbits, c).astype(np.int32)
    return digits + (np.arange(W, dtype=np.int32) << c)[:, None]


def fixed_base_table(curve_host, base, nbits: int, c: int):
    """Host table: T[w*2^c + m] = m * 2^(c*w) * base (affine, None=inf)."""
    W = -(-nbits // c)
    table = []
    g = base
    for w in range(W):
        acc = None
        for m in range(1 << c):
            table.append(acc)
            acc = curve_host.add(acc, g) if acc is not None else g
        # g <- 2^c * g
        for _ in range(c):
            g = curve_host.double(g)
    return table


def _fixed_base_device(curve, table_aff, digits):
    """digits [W, B] (table-offset encoded); returns projective batch [B]."""
    device = _device_of(table_aff)
    digits = torch.as_tensor(digits).to(device, torch.int64)
    acc = curve.infinity((digits.shape[1],), device)
    for dg in digits:
        acc = curve.madd(acc, _take(table_aff, dg), canonical_bases=True)
    return acc


def fixed_base_batch_mul(curve, table_aff, digits):
    """_fixed_base_device as one CUDA graph per shape; digits (numpy or a
    tensor) go to the table's device first."""
    fn = aotcache.jit(f"fb_{_curve_name(curve)}",
                      lambda t, d: _fixed_base_device(curve, t, d), curve)
    return fn(table_aff, _index_tensor(digits, _device_of(table_aff)))
