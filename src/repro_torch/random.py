"""JAX's threefry2x32 PRNG in torch integer ops, bit for bit.

The partitioner's restart draw (``boundary_reseed``) consumes
``jax.random.uniform`` bits, and every partition restarts in round 0, so
bit-identity with the reference needs JAX's own bits, not a
``torch.Generator``.  This reproduces the default
``jax_threefry_partitionable=True`` mode:

* ``PRNGKey(s)`` is ``(s >> 32, s & 0xFFFFFFFF)``;
* ``split(k, num)`` is threefry of the counters ``(0, i)``, ``i < num``;
* ``fold_in(k, d)`` is threefry of ``(0, d)``;
* ``uniform(k, shape)`` takes ``x0 ^ x1`` of threefry over ``(0, iota)``,
  keeps the top 23 bits as a float32 mantissa in [1, 2) and subtracts 1.

A key is a plain (2,) int64 tensor holding two uint32 words; a batch of
keys is (..., 2).  torch's ``uint32`` lacks basic ops (``arange`` raises
for it), so the words live in int64 masked to 32 bits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.graph import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32 words.

    All four arguments broadcast against each other; returns ``(y0, y1)``.
    """
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Key of an integer seed, as ``jax.random.PRNGKey`` makes it.
    ``device=None`` means the card, as for every entry point of the port."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=resolve_device(device))


def _words(key: torch.Tensor):
    if key.dtype != torch.int64 or key.shape[-1] != 2:
        raise TypeError(f"a key is an int64 (..., 2) tensor, got "
                        f"{key.dtype} {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) new keys from one (2,) key."""
    k0, k1 = _words(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Key folded with ``data``: a scalar, or an int tensor of data that
    gives a batch of keys of its shape (JAX's ``vmap`` of ``fold_in``)."""
    k0, k1 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 uniform in [0, 1), ``jax.random.uniform(key, shape)``, for
    one (2,) key or each key of a batch (..., 2): (..., *shape)."""
    shape = tuple(shape)
    k0, k1 = _words(key)
    numel = math.prod(shape)
    batch = k0.shape
    k0 = k0.reshape(*batch, 1)
    k1 = k1.reshape(*batch, 1)
    ctr = torch.arange(numel, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000        # 23 mantissa bits in [1, 2)
    out = bits.to(torch.int32).view(torch.float32) - 1.0
    return out.reshape(*batch, *shape)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 Gumbel noise, ``jax.random.gumbel(key, shape)`` in its
    default "low" mode: -log(-log(u)) of a uniform u in [tiny, 1).  The
    uniform bits are JAX's exactly; XLA's float32 ``log`` is not always
    correctly rounded, so a value may differ from JAX's in the last bit."""
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, device=key.device)
    one = torch.tensor(1.0, device=key.device)
    u = torch.maximum(tiny, uniform(key, shape) * (one - tiny) + tiny)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """Samples of softmax(logits) along ``axis`` by the Gumbel-max trick,
    ``jax.random.categorical(key, logits, axis)`` (sampling with
    replacement, no ``shape``): argmax of logits + ``gumbel(key,
    logits.shape)``, the first index on a tie.  The draws equal JAX's
    unless two perturbed logits lie within the last bit of each other.
    Takes float32 logits (JAX draws the noise in the logits' type)."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got "
                        f"{logits.dtype}")
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits, dim=axis)
