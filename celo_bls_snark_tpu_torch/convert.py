"""Trees of field arrays between numpy and the port's tensors.

The JAX package holds points and tower elements as pytrees (nested
tuples) of numpy/JAX [n, B] int32 arrays; the port holds the same
structure as torch tensors. These two functions carry state across in
either direction, leaf by leaf, keeping the tree structure."""

import numpy as np
import torch

from .utils.tree import tree_map


def tree_from_numpy(tree, device):
    """Pytree of array-likes -> the same tree of int32 tensors on `device`."""
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, dtype=np.int32)).to(device), tree
    )


def tree_to_numpy(tree):
    """Pytree of tensors -> the same tree of numpy int32 arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(np.int32), tree)
