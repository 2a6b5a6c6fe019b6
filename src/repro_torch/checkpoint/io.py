"""Checkpoints in the JAX package's format (``checkpoint/io.py``): a tree's
leaves in an ``.npz`` keyed by their "/"-joined paths ("embed/tok",
"slots/0/attn/wq", "slots/0/attn/wq/a" for a LoRA tree). The port stores
an untied head (V, d); its key "embed/head" is written in the JAX (d, V)
layout, so the JAX ``restore`` reads the port's files and
``bridge.params_from_jax`` (or :func:`restore`) reads the JAX package's.
bf16 leaves are written as fp32 (numpy has no bf16; the JAX ``restore``
casts them back exactly)."""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import tree as T

_HEAD = "embed/head"


def _flatten(tree) -> dict:
    out = {}
    for path, leaf in T.leaves_with_path(tree):
        key = T.key_path(path)
        x = leaf.detach()
        if key == _HEAD:
            x = x.t()
        if x.dtype == torch.bfloat16:
            x = x.float()
        out[key] = x.cpu().contiguous().numpy()
    return out


def save(tree, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":      # numpy cannot hand bf16 to torch
        arr = arr.astype(np.float32)
    elif arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # bf16 read without ml_dtypes: the raw 16 bits are fp32's high half
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def restore(template, path: str):
    """A tree of ``template``'s structure, each leaf read from its key and
    placed at the template leaf's dtype and device."""
    with np.load(path) as data:
        def read(p, leaf):
            key = T.key_path(p)
            x = _to_tensor(data[key])
            if key == _HEAD:
                x = x.t()
            if tuple(x.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(x.shape)} "
                                 f"!= template {tuple(leaf.shape)}")
            return x.to(device=leaf.device, dtype=leaf.dtype).contiguous()

        return T.map_with_path(read, template)
