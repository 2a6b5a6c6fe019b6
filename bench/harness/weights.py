"""The weights, drawn on the device from the seed.

One flat buffer in the served dtype is filled by ``normal_`` from a
``torch.Generator`` on the device, in a few calls of ``CHUNK`` elements,
then cut into the leaves of the tree the program takes (views of the
buffer, no copy) and each leaf scaled to its distribution. The program
and the plain reference read the same tensors; neither makes them.

The leaves come from the configuration's reference module
(``bench/reference/<name>.py::layout``): ``(path, shape, kind, scale)``,
``path`` the keys into the program's tree (an int key makes a tuple),
``kind`` "normal" (std ``scale``), "norm" (1 + ``scale`` z) or "head"
(normal, with the mask token's row zero, as in a trained model, where
the mask is never a candidate). The leaves are drawn in the layout's
order, so a layout that keeps its order keeps every seed's weights.
"""
from __future__ import annotations

import math

CHUNK = 1 << 30


def n_params(layout) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in layout)


def _tuples(node):
    """Dicts keyed by 0..n-1 as tuples, all the way down."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return tuple(node[i] for i in range(len(node)))
    return node


def draw(layout, model: dict, seed: int, device, dtype):
    """The param tree of ``layout``, drawn on ``device`` in ``dtype`` from
    ``seed``; ``model`` (the configuration file's ``model``) gives the
    mask token."""
    import torch

    total = n_params(layout)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    with torch.no_grad():
        for i in range(0, total, CHUNK):
            flat[i:i + CHUNK].normal_(generator=gen)
        off = 0
        for path, shape, kind, scale in layout:
            leaf = flat[off:off + math.prod(shape)].view(shape)
            off += math.prod(shape)
            leaf.mul_(scale)
            if kind == "norm":
                leaf.add_(1.0)
            elif kind == "head":
                leaf[model["mask_token_id"]] = 0
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
    return _tuples(tree)
