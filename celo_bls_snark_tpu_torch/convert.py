"""State between numpy (as the JAX package holds it) and the port.

The JAX package holds points and tower elements as pytrees (nested tuples)
of numpy/JAX [n, B] int32 arrays; the port holds the same structure as
torch tensors. BW6-761 points are such trees over 49 limbs, twiddle and
coset tables are single [n, N] leaves. The prover's carriers are numpy on
both sides: PointVec (raw uint16 limb leaves), RawScalarVec (raw limbs) and
the MSM plan arrays (perm, lin, lane, valid). These functions carry each
across in either direction, keeping structure, so that tests feed both
packages the same arrays."""

import numpy as np
import torch

from .ops.curve import PointVec
from .ops.msm import RawScalarVec, plan_to_device
from .utils.tree import tree_map


def tree_from_numpy(tree, device):
    """Pytree of array-likes -> the same tree of int32 tensors on `device`."""
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, dtype=np.int32)).to(device), tree
    )


def tree_to_numpy(tree):
    """Pytree of tensors -> the same tree of numpy int32 arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(np.int32), tree)


def point_vec_from_numpy(leaves, spec, template) -> PointVec:
    """Raw canonical limb leaves (one [n, B] array per affine component,
    any integer type) -> the port's PointVec over `spec`."""
    return PointVec([np.asarray(l).astype(np.uint16) for l in leaves], spec, template)


def point_vec_to_numpy(pv: PointVec) -> list:
    """The PointVec's raw uint16 limb leaves, as the JAX package's PointVec
    constructor takes them."""
    return [np.array(l, dtype=np.uint16) for l in pv.leaves]


def raw_scalars_from_numpy(limbs, spec) -> RawScalarVec:
    return RawScalarVec(np.asarray(limbs).astype(np.uint16), spec)


def raw_scalars_to_numpy(sv: RawScalarVec) -> np.ndarray:
    return np.array(sv.limbs, dtype=np.uint16)


def plan_from_numpy(perm, lin, lane, valid, device):
    """plan_msm's arrays -> index tensors on `device` as ops/msm.py's
    device code reads them (int64 indices, bool mask)."""
    return plan_to_device(perm, lin, lane, valid, device)


def plan_to_numpy(perm, lin, lane, valid):
    """Index tensors -> plan_msm's numpy arrays (int32 indices, bool mask)."""
    idx = tuple(t.cpu().numpy().astype(np.int32) for t in (perm, lin, lane))
    return (*idx, valid.cpu().numpy().astype(bool))
