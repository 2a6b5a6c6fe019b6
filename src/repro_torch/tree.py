"""Nested dict/tuple trees of tensors (the port's params, LoRA adapters,
optimizer moments): leaves with their key paths, and a map over one or
more trees of the same structure. Paths are tuples of dict keys and tuple
indices, in the tree's own order."""
from __future__ import annotations


def leaves_with_path(tree, prefix=()):
    """[(path, leaf)] in the tree's order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in leaves_with_path(v, prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree)
                for item in leaves_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree):
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn, tree, *rest, prefix=()):
    """``fn(path, leaf, *leaves_of_rest)`` over every leaf; same structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 prefix=prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        prefix=prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def tree_map(fn, tree, *rest):
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def unflatten(tree, new_leaves):
    """A tree of ``tree``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)


def key_path(path) -> str:
    """The "/"-joined spelling of the JAX package's checkpoint and LoRA
    keys: tuple indices as numbers ("slots/0/attn/wq")."""
    return "/".join(str(k) for k in path)
