"""The JAX package's PRNG, threefry2x32, as integer tensor ops.

Sampled decoding draws from ``jax.random`` streams in the JAX package
(``PRNGKey(seed)``, ``split``, ``categorical`` with Gumbel noise), and a
sampled token is reproduced only if every bit of those streams is. This
module computes them with int32 tensor ops on the tensors' device: no host
read, so a CUDA graph can capture a draw.

The functions and the JAX functions they follow (``jax/_src/prng.py`` and
``jax/_src/random.py``):

- :func:`key`: ``threefry_seed`` as ``PRNGKey(seed)`` calls it with 64-bit
  types off (JAX's default): ``[0, seed mod 2**32]``;
- :func:`threefry2x32`: the hash, 20 rounds (``_threefry2x32_lowering``);
- :func:`split`: ``_threefry_split``, the fold-like layout
  (``partitionable=True``, JAX's default since 0.5) or the original one;
- :func:`bits`: ``threefry_random_bits`` at 32 bits, both layouts. The
  counters of the partitionable layout are the element's flat index, its
  high and low words; the original layout hashes the flat counter array
  split in two halves (padded by one 0 when its size is odd), so element
  ``i`` is the first output of the pair ``(i, i + h)`` for ``i < h`` and
  the second of ``(i - h, i)`` otherwise, ``h = ceil(n / 2)``;
- :func:`uniform`: ``_uniform`` in fp32 (the top 23 bits as a mantissa);
- :func:`gumbel`: ``_gumbel`` in its default ``"low"`` mode;
- :func:`categorical`: ``categorical`` with ``replace=True``, the argmax of
  the logits plus Gumbel noise drawn at the logits' shape.

Keys are ``(..., 2)`` int64 tensors holding uint32 values. A key with
leading dimensions ``K`` draws one stream per key, as ``jax.vmap`` over
the keys does: the noise of :func:`bits` has shape ``K + shape``.

``index`` (int32 or int64 flat counters into ``shape``) computes the
stream at those elements only: the values equal those of the whole draw
at the same places, so a caller that reads a slice of a large draw (the
active block of a canvas-shaped draw) hashes that slice alone.

The layout is an argument, ``partitionable``, since the port cannot ask
JAX's config; every caller in the port takes the default, JAX's.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = 1.1754943508222875e-38       # numpy.finfo(float32).tiny


def _signed(x: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    """uint32 values in an integer tensor -> int32 bit patterns."""
    t = t.to(torch.int64) & M32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def _as_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> uint32 values in an int64 tensor."""
    return t.to(torch.int64) & M32


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: a (2,) key ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter pairs ``(x0, x1)`` under the key
    ``(k0, k1)``, on int32 bit patterns (broadcast together; additions
    wrap, right shifts are masked to be logical). Returns the output pair
    in the broadcast shape."""
    shape = torch.broadcast_shapes(*(t.shape if torch.is_tensor(t) else ()
                                     for t in (k0, k1, x0, x1)))
    dev = next(t.device for t in (k0, k1, x0, x1) if torch.is_tensor(t))
    k2 = k0 ^ k1 ^ _signed(_KS_PARITY)
    ks = (k0, k1, k2)
    # a Python counter is filled, not copied: no host-to-device copy (a
    # CUDA graph captures this)
    y0, y1 = ((torch.empty(shape, dtype=torch.int32, device=dev).copy_(x)
               if torch.is_tensor(x)
               else torch.full(shape, x, dtype=torch.int32, device=dev)
               ).add_(kw) for x, kw in ((x0, k0), (x1, k1)))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0.add_(y1)
            t = y1 << r
            y1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            y1.bitwise_or_(t).bitwise_xor_(y0)
        y0.add_(ks[(i + 1) % 3])
        y1.add_(ks[(i + 2) % 3]).add_(i + 1)
    return y0, y1


def _key_words(k: torch.Tensor, n_dims: int):
    """The key's two words as int32 patterns, shaped to broadcast over
    ``n_dims`` trailing counter dimensions."""
    w = _as_i32(k)
    lead = w.shape[:-1]
    view = lead + (1,) * n_dims
    return w[..., 0].reshape(view), w[..., 1].reshape(view)


def _counters(shape: Sequence[int], index: Optional[torch.Tensor], dev):
    """The flat counters of the draw (int32 if they fit, else int64)."""
    n = math.prod(shape)
    if index is not None:
        return index.to(dev)
    dt = torch.int32 if n <= 1 << 31 else torch.int64
    return torch.arange(n, dtype=dt, device=dev).reshape(tuple(shape))


def _hash_pairs(k: torch.Tensor, shape, index, partitionable: bool):
    """Both threefry outputs at the draw's counters, and a selector for
    the original layout (None for the partitionable one)."""
    n = math.prod(shape)
    c = _counters(shape, index, k.device)
    k0, k1 = _key_words(k, c.ndim)
    if partitionable:
        if c.dtype == torch.int32:
            hi, lo = 0, c
        else:
            hi, lo = _as_i32(c >> 32), _as_i32(c)
        return threefry2x32(k0, k1, hi, lo), None
    if n > M32:
        raise ValueError(f"a draw of {n} elements: the original threefry "
                         "layout is ported for fewer than 2**32")
    h = -(-n // 2)
    c = c.to(torch.int64)
    first = c < h
    a = torch.where(first, c, c - h)
    b = torch.where(first, c + h, c)
    b = torch.where(b == n, torch.zeros_like(b), b)   # the odd size's pad
    return threefry2x32(k0, k1, _as_i32(a), _as_i32(b)), first


def _bits32(k, shape, *, partitionable=True, index=None) -> torch.Tensor:
    """32 random bits per element as int32 patterns: ``K + shape``, or
    ``K + index.shape`` at the counters ``index``."""
    (y0, y1), first = _hash_pairs(k, tuple(shape), index, partitionable)
    if first is None:
        return y0.bitwise_xor_(y1)
    return torch.where(first, y0, y1)


def bits(k, shape, *, partitionable: bool = True,
         index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as int64 values."""
    return _as_u32(_bits32(k, shape, partitionable=partitionable,
                           index=index))


def split(k, num: int = 2, *, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split(k, num)``: ``(..., num, 2)`` keys."""
    if partitionable:
        (y0, y1), _ = _hash_pairs(k, (num,), None, True)
        return torch.stack([_as_u32(y0), _as_u32(y1)], -1)
    flat = bits(k, (2 * num,), partitionable=False)
    return flat.reshape(*flat.shape[:-1], num, 2)


def uniform(k, shape, minval: float = 0.0, maxval: float = 1.0, *,
            partitionable: bool = True,
            index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.uniform`` in fp32 on ``[minval, maxval)``."""
    b = _bits32(k, shape, partitionable=partitionable, index=index)
    b = b.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF).bitwise_or_(
        0x3F800000)
    floats = b.view(torch.float32) - 1.0
    # the bounds as fp32, on the host (a Python scalar is a kernel argument)
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min_(floats.mul_(scale).add_(lo), lo)


def gumbel(k, shape, *, partitionable: bool = True,
           index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.gumbel`` (mode ``"low"``) in fp32:
    ``-log(-log(u))``, u uniform on ``[tiny, 1)``."""
    u = uniform(k, shape, _F32_TINY, 1.0, partitionable=partitionable,
                index=index)
    return u.log_().neg_().log_().neg_()


def categorical(k, logits: torch.Tensor, *, partitionable: bool = True,
                shape: Optional[Sequence[int]] = None,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` over the last axis: the argmax
    of ``logits + gumbel`` (first occurrence, as ``jnp.argmax``), int64.

    ``k`` is ``(..., 2)`` with leading dimensions ``K``; ``logits`` is
    ``K + S`` and each key draws its noise at shape ``S`` (vmapped over
    ``K``). A caller holding a slice of a larger draw passes the draw's
    ``shape`` and the slice's flat counters ``index`` (``S``-shaped)."""
    nk = k.dim() - 1
    draw = tuple(logits.shape[nk:]) if shape is None else tuple(shape)
    g = gumbel(k, draw, partitionable=partitionable, index=index)
    return torch.argmax(g.add_(logits), dim=-1)
