"""Rank-parallel BLS/SNARK pipelines on torch.distributed (the PyTorch
counterpart of the JAX package's parallel/mesh.py).

The reference's only parallelism is rayon data-parallelism inside arkworks
MSM/FFT (SURVEY.md section 2.5). Here a 1-D mesh is one process group with
one rank a device (the torch.distributed idiom in place of one process
holding every device), and every function keeps the JAX contract:

  - every rank passes the GLOBAL inputs (the same values on every rank);
  - each rank computes on its own shard of the lane axis, on its own
    device, through ops/ (on the mont_mul and mont_redc kernels);
  - every rank gets the replicated result back.

Collectives ride NCCL between cards and gloo between CPU processes,
outside any kernel:
  - the per-rank [n, 1] partial points and Fq12 elements combine with ONE
    all-gather a tree (the coordinates stacked into one tensor), then the
    same local msum / f12_product as the JAX code;
  - the four-step NTT's transpose is ONE all_to_all_single, its output one
    all-gather.

A mesh without a process group (a single process that never called
init_distributed) has one rank, and its collectives are the identity.

Each function's device work is one program of utils/aotcache.py (a CUDA
graph per shape on the card, collectives included), as each of the JAX
package's is one jax.jit of a shard_map; the plan, the packing and the
fetch of the Pippenger MSM and the h-polynomial stay on the host. On CPU
tensors (gloo) a program calls its body.
"""

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import curve as dc
from ..ops import msm as dmsm
from ..ops import ntt as dntt
from ..ops import pairing as dp
from ..ops import tower as tw
from ..ops.field import FQ, _sub_limbs_u32
from ..utils import aotcache
from ..utils.config import get_config
from ..utils.devices import require_device, resolve_device
from ..utils.profiling import device_sync, stage
from ..utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the process group (None: a single
    process without one), this rank, the number of ranks and this rank's
    device. torch.distributed has no named axes: the JAX mesh's axis name
    has no counterpart here."""

    group: Optional[Any]
    rank: int
    size: int
    device: torch.device


def make_mesh(group=None, device="cuda"):
    """The mesh of `group` (a torch.distributed process group; None is the
    default group when one is initialized, else a one-rank mesh) with this
    rank's computation on `device`."""
    device = resolve_device(require_device(device))
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, device)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), device)


# --- collectives ------------------------------------------------------------

def _all_gather(mesh, flat):
    """[k] on every rank -> [size, k], rank order."""
    if mesh.group is None:
        return flat[None]
    out = torch.empty(mesh.size * flat.numel(), dtype=flat.dtype, device=flat.device)
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, flat.contiguous(), group=mesh.group)
    return out.reshape(mesh.size, -1)


def _all_to_all(mesh, send):
    """[size, ...] -> [size, ...]: chunk j goes to rank j; chunk j of the
    result came from rank j."""
    if mesh.group is None:
        return send
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    return recv


def _gather_lanes(mesh, tree):
    """A tree of [n, 1] leaves on each rank -> the same tree with [n, size]
    leaves (rank order on the lane axis, as jax.lax.all_gather(x[..., 0],
    axis=-1) gives): the coordinates stacked into ONE collective."""
    leaves = tree_leaves(tree)
    flat = torch.cat([l[..., 0].reshape(-1) for l in leaves])
    g = _all_gather(mesh, flat)  # [size, sum of leaf sizes]
    parts, off = [], 0
    for l in leaves:
        k = l[..., 0].numel()
        parts.append(g[:, off:off + k].reshape(mesh.size, *l.shape[:-1])
                     .movedim(0, -1).contiguous())
        off += k
    it = iter(parts)
    return tree_map(lambda _: next(it), tree)


def shard_batch(mesh, tree):
    """This rank's shard of a tree of [..., B] arrays on its device: lanes
    [rank B/D, (rank + 1) B/D). B must split evenly, as under shard_map."""
    B = tree_leaves(tree)[0].shape[-1]
    if B % mesh.size:
        raise ValueError(f"{B} lanes do not split evenly over {mesh.size} ranks")
    k = B // mesh.size
    lo = mesh.rank * k
    return tree_map(lambda x: x[..., lo:lo + k].to(mesh.device), tree)


def _program(mesh, name, fn, *owners) -> aotcache.AotJit:
    """fn as one program of utils/aotcache.py: the tag names the mesh's
    static values (its size, this rank and its device) after `name`, which
    names the program's own; the owners are the process group and the
    objects fn closes over besides the mesh."""
    return aotcache.jit(f"mesh_{name}_D{mesh.size}_r{mesh.rank}_{mesh.device}",
                        fn, mesh.group, *owners)


# --- pairing ------------------------------------------------------------------

def _miller_product(mesh, p_aff, q_aff):
    f = dp.miller_loop_batch(shard_batch(mesh, p_aff), shard_batch(mesh, q_aff))
    f = dp.f12_product(f)  # [.., 1] per rank
    return dp.f12_product(_gather_lanes(mesh, f))


def sharded_miller_product(mesh, p_aff, q_aff):
    """Batch-sharded Miller loops + cross-rank GT product: local Miller
    loops and tree product per rank, an all-gather of the per-rank partial
    Fq12 elements, and a final local product."""
    return _program(mesh, "miller_product",
                    lambda p, q: _miller_product(mesh, p, q))(p_aff, q_aff)


def sharded_pairing_check(mesh, p_aff, q_aff):
    """Full sharded product-of-pairings check: sharded Miller + product,
    then the (replicated, single-element) final exponentiation, as one
    program."""
    return _program(mesh, "pairing_check", lambda p, q: tw.f12_is_one(
        dp.final_exponentiation(_miller_product(mesh, p, q))))(p_aff, q_aff)


# --- sums and MSMs ------------------------------------------------------------

def _sharded_msum(mesh, pts_jac, curve):
    def body(pts):
        s = curve.msum(shard_batch(mesh, pts))
        return curve.msum(_gather_lanes(mesh, s))

    return _program(mesh, f"msum_{dmsm._curve_name(curve)}", body, curve)(pts_jac)


def sharded_msum_g1(mesh, pts_jac):
    """Sharded G1 sum: local tree-sum per rank, then all-gather + final sum."""
    return _sharded_msum(mesh, pts_jac, dc.g1)


def sharded_msum_g2(mesh, pts_jac):
    return _sharded_msum(mesh, pts_jac, dc.g2)


def sharded_msm_g1(mesh, bits, pts_jac):
    """Sharded dense MSM: batch-sharded scalar-muls, per-rank partial sums,
    the all-gathered total (bits: [nbits, B] MSB first)."""
    def body(b, pts):
        prods = dc.g1.scalar_mul_bits(shard_batch(mesh, b), shard_batch(mesh, pts))
        return dc.g1.msum(_gather_lanes(mesh, dc.g1.msum(prods)))

    return _program(mesh, "msm_g1_dense", body)(bits, pts_jac)


def _scalar_shard(scalars, lo, hi, width):
    """Scalars [lo, hi) padded with zeros to `width`: python ints, or a
    RawScalarVec sliced on its limbs (no conversion to ints)."""
    if isinstance(scalars, dmsm.RawScalarVec):
        limbs = scalars.limbs[:, lo:hi]
        return dmsm.RawScalarVec(
            np.pad(limbs, ((0, 0), (0, width - limbs.shape[1]))), scalars.spec)
    sc = [int(s) for s in scalars[lo:hi]]
    return sc + [0] * (width - len(sc))


def sharded_msm_pippenger(mesh, points, scalars, c=None, L=None,
                          curve=None, spec=None, nbits=None,
                          pack_fn=None, unpack_fn=None, cache_key=None):
    """Mesh-sharded Pippenger MSM (host points/scalars -> host point).

    The MSM is additive, so the points are partitioned across ranks: rank d
    takes points [d Bc0, (d + 1) Bc0), Bc0 = ceil(B0 / D), padded with
    infinities and zero scalars; it plans and runs the whole Pippenger
    pipeline (ops/msm.py) on its shard alone, and the per-rank partial sums
    combine with one all-gather and a local fold.

    points: host affine points (None = infinity) or a PointVec; scalars:
    python ints or a RawScalarVec. pack_fn(points, device) packs host
    points (tower-coordinate groups). cache_key memoizes this rank's packed
    bases, as msm_pippenger does."""
    cfg = get_config()
    curve = curve or dc.g1
    spec = spec or (points.spec if isinstance(points, dc.PointVec) else FQ)
    nbits = nbits or 253
    D, rank, device = mesh.size, mesh.rank, mesh.device
    B0 = len(points)
    Bc0 = -(-B0 // D)  # points per rank before padding
    c = c or dmsm._auto_c(Bc0, nbits)
    if L is None:
        L = 1 << max(2, min(15, Bc0.bit_length() - 5))
    lo, hi = min(rank * Bc0, B0), min((rank + 1) * Bc0, B0)
    with stage("msm.plan"):
        perm, lin, lane, valid, Bc = dmsm.plan_msm(
            _scalar_shard(scalars, lo, hi, Bc0), nbits, c, L)
    full_key = ((cache_key, D, rank, B0, Bc, device)
                if cache_key is not None else None)
    pts_aff = dmsm._BASE_PACK_CACHE.get(full_key) if full_key else None
    if pts_aff is None:
        with stage("msm.pack_bases"):
            if isinstance(points, dc.PointVec):
                shard = dc.PointVec([l[:, lo:hi] for l in points.leaves],
                                    points.spec, points.template)
                pts_aff = shard.device_montgomery(device, Bc)
            else:
                pc = list(points[lo:hi]) + [None] * (Bc - (hi - lo))
                pts_aff = (pack_fn(pc, device) if pack_fn
                           else dc.pack_affine(spec, pc, device))
            device_sync(pts_aff)
        if full_key is not None and cfg.msm_cache_bases:
            dmsm._BASE_PACK_CACHE[full_key] = pts_aff
    with stage("msm.device"):
        plan = dmsm.plan_to_device(perm, lin, lane, valid, device)
        out = _program(mesh, f"pip_{dmsm._curve_name(curve)}_c{c}_L{L}",
                       lambda pts, *pl: curve.msum(_gather_lanes(
                           mesh, dmsm._pippenger_device(curve, pts, *pl, c, L))),
                       curve)(pts_aff, *plan)
        device_sync(out)
    if unpack_fn is not None:
        return unpack_fn(out)[0]
    return dc.unpack_jac(spec, out)[0]


# --- four-step NTT --------------------------------------------------------------

_FOUR_STEP_TW = {}


def _four_step_twiddles(nttops, N, N1, inverse, device):
    """Montgomery T[k1, i2] = w_N^{±k1 i2}, [n, N1, N2] on `device`, with
    the canonical limbs of the host-packed table. Gathered from the
    length-N master table of powers w^0..w^(N/2 - 1) (w^(N/2 + j) =
    -w^j), so no host loop over the N entries."""
    device = torch.device(device)
    key = (nttops.r, N, N1, inverse, device)
    if key not in _FOUR_STEP_TW:
        half = nttops.master_table(N, inverse, device)  # canonical, nonzero
        p = nttops.spec.column(nttops.spec.p_limbs, device)
        neg, _ = _sub_limbs_u32(p, half)  # p - w^j
        full = torch.cat([half, neg.to(torch.int32)], dim=-1)
        N2 = N // N1
        e = (torch.arange(N1, device=device)[:, None]
             * torch.arange(N2, device=device)[None, :]) % N
        _FOUR_STEP_TW[key] = full[:, e.reshape(-1)].reshape(-1, N1, N2)
    return _FOUR_STEP_TW[key]


def _four_step_split(N, D, N1=None):
    if N1 is None:
        N1 = 1 << ((N.bit_length() - 1) // 2)  # ~sqrt(N)
        while N1 % D and N1 < N:  # N1 stays a power of two: D = 3 never divides it
            N1 <<= 1
    N2 = N // N1
    if N1 * N2 != N or N1 % D or N2 % D:
        raise ValueError(f"four-step NTT: N = {N} as {N1} x {N2} does not "
                         f"split over {D} ranks")
    return N1, N2


class _FourStep:
    """One rank's four-step NTT of length N = N1 N2 and the two layouts it
    reads and writes: the input A[i1, i2] (j = i1 N2 + i2) sharded on i2,
    the output X[k2, k1] (j = k2 N1 + k1) sharded on k1."""

    def __init__(self, mesh, nttops, N, N1=None):
        self.mesh, self.nttops, self.N = mesh, nttops, N
        self.N1, self.N2 = _four_step_split(N, mesh.size, N1)

    def shard_in(self, x):
        """Global [n, N] -> this rank's [n, N1, N2/D] (i2 slice)."""
        k = self.N2 // self.mesh.size
        lo = self.mesh.rank * k
        return x.reshape(x.shape[0], self.N1, self.N2)[:, :, lo:lo + k].to(self.mesh.device)

    def shard_out(self, x):
        """Global [n, N] -> this rank's [n, N2, N1/D] (k1 slice)."""
        k = self.N1 // self.mesh.size
        lo = self.mesh.rank * k
        return x.reshape(x.shape[0], self.N2, self.N1)[:, :, lo:lo + k].to(self.mesh.device)

    def gather_out(self, y):
        """This rank's [n, N2, N1/D] -> the global [n, N] on every rank."""
        n = y.shape[0]
        g = _all_gather(self.mesh, y.reshape(-1))
        g = g.reshape(self.mesh.size, n, self.N2, self.N1 // self.mesh.size)
        return g.permute(1, 2, 0, 3).reshape(n, self.N)

    def __call__(self, x, inverse=False):
        """[n, N1, N2/D] (shard_in layout) -> [n, N2, N1/D] (shard_out
        layout): (1) length-N1 NTTs along columns, local; (2) twiddles
        w_N^{k1 i2}, local; (3) ONE all_to_all from i2-sharded to
        k1-sharded, the only traffic (N elements in all); (4) length-N2
        NTTs along rows, local."""
        mesh, nttops, f = self.mesh, self.nttops, self.nttops.f
        D, N1, N2 = mesh.size, self.N1, self.N2
        n = x.shape[0]
        k = N2 // D
        tw_ = _four_step_twiddles(nttops, self.N, N1, inverse, mesh.device)
        tw_ = tw_[:, :, mesh.rank * k:(mesh.rank + 1) * k]
        b = nttops.ntt(x.movedim(-1, 1), inverse=inverse)  # [n, N2/D, N1]
        c = f.mul(b.reshape(n, -1), tw_.movedim(-1, 1).reshape(n, -1))
        # split k1 into D chunks (chunk j to rank j), gather every i2
        send = c.reshape(n, N2 // D, D, N1 // D).permute(2, 0, 1, 3)
        d = _all_to_all(mesh, send)  # [D (source rank), n, N2/D, N1/D]
        d = d.permute(1, 0, 2, 3).reshape(n, N2, N1 // D)
        e = nttops.ntt(d.movedim(1, -1), inverse=inverse)  # [n, N1/D, N2]
        return e.movedim(1, -1)


def sharded_ntt(mesh, coeffs, nttops=None, inverse=False, N1=None):
    """Mesh-sharded radix-2 NTT: the four-step (Bailey) decomposition of
    N = N1 N2 (see _FourStep), the counterpart of arkworks' rayon-parallel
    domain FFT inside the Groth16 prover (SURVEY.md section 2.5).

    coeffs: [n_limbs, N] natural order -> [n_limbs, N] natural order on
    every rank (inverse=True gives the 1/N-scaled inverse NTT). Requires
    N1 % D == 0 and N2 % D == 0 (D = mesh size)."""
    nttops = nttops or dntt.ntt_fr
    _four_step_split(coeffs.shape[-1], mesh.size, N1)  # raises before any program

    def body(x):
        fs = _FourStep(mesh, nttops, x.shape[-1], N1)
        # out[:, k2, k1] = X[k2 N1 + k1]: flattening (k2, k1) IS natural order
        return fs.gather_out(fs(fs.shard_in(x), inverse))

    return _program(mesh, f"ntt_{nttops.spec.name}_{int(inverse)}_{N1}", body, nttops)(coeffs)


def _compute_h(mesh, nttops, g, a_raw, b_raw, c_raw):
    f, r, spec = nttops.f, nttops.r, nttops.spec
    dev, d = mesh.device, a_raw.shape[-1]
    fs = _FourStep(mesh, nttops, d)
    sc_g = fs.shard_in(nttops.coset_scale(d, g, dev))
    sc_ginv = fs.shard_out(nttops.coset_scale(d, pow(g, -1, r), dev))
    t_c_inv = pow((pow(g, d, r) - 1) % r, -1, r)
    evs = []
    for raw in (a_raw, b_raw, c_raw):
        x = f.from_raw(fs.shard_in(raw))
        coeffs = fs.gather_out(fs(x, inverse=True))
        evs.append(fs(f.mul(fs.shard_in(coeffs), sc_g)))  # coset NTT
    ae, be, ce = evs
    hc = f.mul(f.sub(f.mul(ae, be), ce), spec.const(t_c_inv, ae.shape[1:], dev))
    h = f.mul(fs(fs.shard_in(fs.gather_out(hc)), inverse=True), sc_ginv)
    raw = f.to_raw(h.reshape(h.shape[0], -1)).reshape(h.shape)
    return fs.gather_out(raw)


def sharded_compute_h(mesh, nttops, a_raw, b_raw, c_raw, d: int, g: int):
    """Mesh-sharded Groth16 h-polynomial: the coset-NTT pipeline of
    snark/accel.py::compute_h_evals with every length-d transform a
    four-step sharded NTT and the pointwise products on each rank's shard.
    Between transforms the data is gathered and re-sharded into the next
    transform's input layout. One program from the raw limbs on this
    rank's device to the gathered raw h limbs (the JAX package's from_raw,
    mul, combine, ntt, to_raw and replicate programs).

    a_raw/b_raw/c_raw: RAW (non-Montgomery) [n, d] limbs of the domain
    evaluations. Returns the RAW canonical h coefficient limbs [n, d] as a
    numpy int32 array on every rank (truncate to d - 1 on the host)."""
    raws = [torch.as_tensor(x).to(mesh.device) for x in (a_raw, b_raw, c_raw)]
    if raws[0].shape[-1] != d:
        raise ValueError(f"{raws[0].shape[-1]} evaluations for a domain of {d}")
    _four_step_split(d, mesh.size)
    h = _program(mesh, f"compute_h_{nttops.spec.name}_{g}",
                 lambda a, b, c: _compute_h(mesh, nttops, g, a, b, c), nttops)(*raws)
    return h.cpu().numpy()
