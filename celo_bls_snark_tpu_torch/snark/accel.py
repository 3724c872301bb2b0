"""Device backends for the Groth16 hot paths (the PyTorch counterpart of the
JAX package's snark/accel.py).

The Rust reference gets its prover/setup throughput from arkworks' rayon
MSM + FFT (invoked at crates/epoch-snark/src/api/prover.rs:78,
setup.rs:87-99); here the same stages run on the card:

  - _Group.msm               -> Pippenger (ops/msm.py), the prover MSMs
  - _Group.fixed_base_batch  -> window-table batch scalar-mul, the setup's
                                millions of generator multiples
  - compute_h_evals          -> the h(X) = (A(X)B(X) - C(X))/t(X) coset
                                NTT pipeline on the device (ops/ntt.py)

set_mesh routes the MSM and the h-polynomial over a multi-rank mesh
(parallel/mesh.py), under the JAX package's conditions. On one card the
MSM, the fixed-base batch, its affine conversion and the h-polynomial run as
CUDA graphs, one per shape (utils/aotcache.py), and prewarm_prove(block=True)
captures the prover's graphs for a proving key's shapes ahead of a proof.

One DeviceAccel instance per pairing engine ("bls12_377", "bw6_761" — for
BW6-761 both G1 and G2 live over Fq761; ops/curve.py::bw6_g1/bw6_g2 differ
in the curve constant b). Passed as the optional `accel` argument of
snark/groth16.py entry points. It runs on the card unless the caller asks
for device="cpu", where every kernel's plain version runs.
"""

import warnings

import numpy as np
import torch

from ..hostmath import bw6 as hbw6
from ..hostmath import curves as hcurves
from ..hostmath import fp2 as hfp2
from ..hostmath.params import BW6_P, G1_GENERATOR, G2_GENERATOR
from ..hostmath.params import P as BLS_P
from ..hostmath.params import R as BLS_R
from ..ops import bls as dbls
from ..ops import curve as dc
from ..ops import kernels
from ..ops import msm as dmsm
from ..ops import ntt as dntt
from ..ops.field import FQ, FQ761, FR, fq, fq761, fr
from ..parallel import mesh as pmesh
from ..utils import aotcache
from ..utils.config import get_config
from ..utils.devices import require_device, resolve_device
from ..utils.profiling import device_sync, stage
from ..utils.tree import tree_map
from .api import BW6_761_ENGINE
from .groth16 import BLS12_377_ENGINE


class _Group:
    """One group's device plumbing: curve ops + pack/unpack + fixed-base."""

    def __init__(self, key, curve, host_curve, generator, nbits,
                 pack_fn, unpack_fn, owner, fops, host_inv, template):
        self.key = key
        self.curve = curve
        self.host_curve = host_curve
        self.generator = generator
        self.nbits = nbits
        self.pack_fn = pack_fn      # (host points, device) -> affine tree
        self.unpack_fn = unpack_fn  # projective tree -> host points
        self.owner = owner          # DeviceAccel (device, mesh)
        self.fops = fops            # coordinate field ops (fq/fq761)
        self.host_inv = host_inv    # host field inverse for batch inversion
        self.template = template    # host affine structure, e.g. (0, 0)
        self._table = None

    def msm(self, bases, scalars, c=None, L=None, cache_key=None):
        """sum_i scalars[i] bases[i] as a host point: sharded over the
        owner's mesh when it has more than one rank and at least 4 points a
        rank (the JAX package's condition), else on this card alone."""
        key = (self.key, cache_key) if cache_key is not None else None
        bases = bases if isinstance(bases, dc.PointVec) else list(bases)
        if not isinstance(scalars, dmsm.RawScalarVec):
            scalars = [int(s) for s in scalars]
        kw = dict(curve=self.curve, nbits=self.nbits, c=c, L=L,
                  pack_fn=self.pack_fn, unpack_fn=self.unpack_fn, cache_key=key)
        if self.owner._routes(len(bases) >= 4 * self.owner.mesh_size, "msm"):
            return pmesh.sharded_msm_pippenger(self.owner.mesh, bases, scalars, **kw)
        return dmsm.msm_pippenger(bases, scalars, device=self.owner.device, **kw)

    def table(self):
        """The fixed-base window table on the device, built once."""
        if self._table is None:
            c = get_config().fixed_base_window
            with stage(f"fixed_base.table.{self.key}"):
                tbl = dmsm.fixed_base_table(
                    self.host_curve, self.generator, self.nbits, c
                )
                self._table = self.pack_fn(tbl, self.owner.device)
        return self._table

    def fixed_base_batch(self, scalars):
        """[k_i] -> [k_i * generator] as a PointVec (acts as a list of
        host affine points; stays packed for MSM/serialization)."""
        table = self.table()
        digits = dmsm.fixed_base_plan(
            [int(s) for s in scalars], self.nbits, get_config().fixed_base_window
        )
        with stage(f"fixed_base.device.{self.key}"):
            out = dmsm.fixed_base_batch_mul(self.curve, table, digits)
            device_sync(out)
        with stage(f"fixed_base.affine.{self.key}"):
            # device batch inversion + raw uint16 fetch
            fn = dc.affine_raw_fn(
                self.curve, self.fops, self.host_inv, self.template,
                f"aff_{self.key}",
            )
            return fn(out)


class DeviceAccel:
    def __init__(self, engine_name: str, device="cuda"):
        self.name = engine_name
        self.device = require_device(device)
        self.mesh = None
        if engine_name == "bls12_377":
            self.r, self.engine = BLS_R, BLS12_377_ENGINE
            self.fspec, self.fops, self.nttops = FR, fr, dntt.ntt_fr
            self.g1 = _Group(
                "bls-g1", dc.g1, hcurves.G1, G1_GENERATOR, 253,
                lambda pts, dev: dc.pack_affine(FQ, pts, dev),
                lambda pt: dc.unpack_jac(FQ, pt),
                owner=self, fops=fq,
                host_inv=lambda t: (pow(t[0], -1, BLS_P),),
                template=(0, 0),
            )
            self.g2 = _Group(
                "bls-g2", dc.g2, hcurves.G2, G2_GENERATOR, 253,
                dbls.pack_g2_affine, dc.g2_unpack,
                owner=self, fops=fq,
                host_inv=lambda t: hfp2.inv((t[0], t[1])),
                template=((0, 0), (0, 0)),
            )
        elif engine_name == "bw6_761":
            self.r, self.engine = BLS_P, BW6_761_ENGINE  # BW6-Fr == BLS12-377 Fq
            self.fspec, self.fops, self.nttops = FQ, fq, dntt.ntt_bw6
            for name, curve, host, gen in (
                ("g1", dc.bw6_g1, hbw6.G1, hbw6.G1_GENERATOR),
                ("g2", dc.bw6_g2, hbw6.G2, hbw6.G2_GENERATOR),
            ):
                setattr(self, name, _Group(
                    f"bw6-{name}", curve, host, gen, 377,
                    lambda pts, dev: dc.pack_affine(FQ761, pts, dev),
                    lambda pt: dc.unpack_jac(FQ761, pt),
                    owner=self, fops=fq761,
                    host_inv=lambda t: (pow(t[0], -1, BW6_P),),
                    template=(0, 0),
                ))
        else:
            raise ValueError(engine_name)

    def prewarm_prove(self, pk, block=False):
        """Get ready what the prover needs that depends only on the proving
        key's sizes: the kernel library (built and loaded) and the twiddle
        and coset tables for d = len(h_query) + 1. With `block`, also
        capture the prover's CUDA graphs for the key's shapes, as the JAX
        package's prewarm compiles the prover's programs: the h-polynomial
        and the Pippenger MSM at the widths of a_query, b_g2_query, l_query
        and h_query, each on zero inputs (a graph's kernels do not depend
        on the data), so that even a first proof replays them. Without it
        the graphs are captured at their second use. Nothing runs in a
        background thread: on an H100 a capture there ran 4-8 times slower
        beside the witness synthesis and delayed the first proof (PERF.md).
        Returns the started threads, always [] (the JAX signature)."""
        d = len(pk.h_query) + 1
        assert d & (d - 1) == 0, d
        if self.device.type == "cuda":
            kernels.library()
        consts = self._h_consts(d, self.engine.fr_generator)
        if not block or self.device.type != "cuda":
            return []
        zero = torch.zeros((self.fspec.n, d), dtype=torch.int32, device=self.device)
        self._h_program().prepare(zero, zero, zero, *consts)
        cfg = get_config()
        for grp, B0 in ((self.g1, len(pk.a_query)), (self.g2, len(pk.b_g2_query)),
                        (self.g1, len(pk.l_query)), (self.g1, d - 1)):
            if B0 < 1:
                continue
            c = cfg.msm_window or dmsm._auto_c(B0, grp.nbits)
            L = cfg.msm_lanes or dmsm._auto_lanes(B0)
            perm, lin, lane, valid, B = dmsm.plan_msm([0] * B0, grp.nbits, c, L)
            pts = tree_map(lambda t: torch.zeros((t.shape[0], B), dtype=torch.int32,
                                                 device=self.device),
                           grp.pack_fn([None], self.device))
            plan = dmsm.plan_to_device(perm, lin, lane, valid, self.device)
            dmsm._pippenger_jit(grp.curve, c, L).prepare(pts, *plan)
        return []

    def set_mesh(self, mesh):
        """Route the prover's MSM and h-polynomial stages through the
        rank-sharded functions of parallel/mesh.py when `mesh` has more
        than one rank: the multi-card form of arkworks' rayon MSM/FFT
        parallelism (SURVEY.md section 2.5 row 4). None, or a mesh of one
        rank, keeps the single-card route. The mesh must compute on this
        accelerator's device."""
        if mesh is not None and resolve_device(mesh.device) != resolve_device(self.device):
            raise ValueError(f"set_mesh: the mesh computes on {mesh.device}, "
                             f"this accelerator on {self.device}")
        self.mesh = mesh

    @property
    def mesh_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _routes(self, fits: bool, what: str) -> bool:
        """Whether a stage goes through the mesh: more than one rank and a
        problem that `fits` the sharding. A multi-rank mesh that cannot
        take the stage says so, and every rank runs it whole."""
        if self.mesh_size == 1:
            return False
        if not fits:
            warnings.warn(f"{what}: this size does not shard over "
                          f"{self.mesh_size} ranks; every rank runs it whole")
        return fits

    def _h_tables(self, d: int, g: int):
        nttops, dev, r = self.nttops, self.device, self.r
        return (
            nttops.master_table(d, False, dev),
            nttops.master_table(d, True, dev),
            nttops.coset_scale(d, g, dev),
            nttops.coset_scale(d, pow(g, -1, r), dev),
        )

    # --- Groth16 prover stage: h = (AB - C)/t on the coset ----------------
    def compute_h_evals(self, a_evals, b_evals, c_evals, d: int, g: int):
        """Domain evaluations (lists of ints mod r) -> h coefficients
        [0, d-1) — the coset-NTT pipeline of groth16._compute_h on the
        device: 3 iNTT + 3 coset NTT + pointwise + 1 coset iNTT. Returns a
        RawScalarVec (raw canonical uint16 limbs, straight into MSM
        planning)."""
        spec, nttops, dev = self.fspec, self.nttops, self.device
        # four-step split: N1 % D == 0 and N2 % D == 0
        if self._routes(d % (self.mesh_size ** 2) == 0, "h_poly"):
            with stage("h_poly.pack"):
                raws = tuple(spec.pack_raw(e, dev) for e in (a_evals, b_evals, c_evals))
            with stage("h_poly.sharded"):
                h_raw = pmesh.sharded_compute_h(self.mesh, nttops, *raws, d, g)
            return dmsm.RawScalarVec(h_raw.astype(np.uint16)[..., : d - 1], spec)
        with stage("h_poly.tables"):
            consts = self._h_consts(d, g)
        with stage("h_poly.pack"):
            args = tuple(spec.pack_raw(e, dev) for e in (a_evals, b_evals, c_evals))
        with stage("h_poly.device"):
            out = self._h_program()(*args, *consts)
            device_sync(out)
        with stage("h_poly.fetch"):
            raw16 = out.cpu().numpy().view(np.uint16)
        return dmsm.RawScalarVec(raw16[..., : d - 1], spec)

    def _h_consts(self, d: int, g: int):
        """The h-polynomial's constant arguments on the device: the twiddle
        and coset tables and 1 / t(c) in Montgomery form."""
        r = self.r
        t_c_inv = pow((pow(g, d, r) - 1) % r, -1, r)
        return (*self._h_tables(d, g), self.fspec.const(t_c_inv, (1,), self.device))

    def _h_program(self) -> aotcache.AotJit:
        """The h_poly.device region as one CUDA graph per shape: raw limbs
        of the three evaluation vectors and _h_consts -> h's raw limbs as
        int16 (the uint16 bit pattern: half the copy). The JAX package
        splits this region into six executables (hp_fromraw, hp_mul,
        ntt_f, ntt_i, hp_toraw16, hp_combine) only to cut XLA's compile
        time; a capture costs about one eager run, so the port captures the
        region whole."""
        f, nttops = self.fops, self.nttops  # the engine's, shared by its instances

        def h_region(a_raw, b_raw, c_raw, m_fwd, m_inv, sc_g, sc_ginv, tinv_c):
            evs = []
            for raw in (a_raw, b_raw, c_raw):
                coeffs = nttops.ntt(f.from_raw(raw), inverse=True, master=m_inv)
                evs.append(nttops.ntt(f.mul(coeffs, sc_g), master=m_fwd))
            ae, be, ce = evs
            hc_ = f.mul(f.sub(f.mul(ae, be), ce), tinv_c.expand(ae.shape))
            h = f.mul(nttops.ntt(hc_, inverse=True, master=m_inv), sc_ginv)
            return f.to_raw(h).to(torch.int16)

        return aotcache.jit(f"hp_{self.name}", h_region, f, nttops)


_ACCEL_CACHE = {}


def get_accel(engine_name: str, device="cuda") -> DeviceAccel:
    key = (engine_name, str(torch.device(device)))
    if key not in _ACCEL_CACHE:
        _ACCEL_CACHE[key] = DeviceAccel(engine_name, device)
    return _ACCEL_CACHE[key]
