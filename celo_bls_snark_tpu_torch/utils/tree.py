"""Pytrees of tensors: nested tuples/lists with tensors at the leaves (the
counterpart of jax.tree.map / jax.tree.leaves for the point and tower
element structures, in the same depth-first leaf order)."""


def tree_map(fn, tree, *rest):
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, t, *[r[i] for r in rest]) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        out = []
        for t in tree:
            out += tree_leaves(t)
        return out
    return [tree]
