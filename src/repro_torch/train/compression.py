"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (the reference's ``train/compression.py`` on tensors).

Each worker quantizes its gradient contribution to int8 with a per-tensor
scale, all-reduces the int8 payload (summed as int32), dequantizes, and
keeps the quantization residual locally — adding it back into the next
step's gradient (error feedback [Karimireddy et al. '19] keeps SGD/Adam
convergence unbiased in the limit).  ``psum_compressed`` runs over a
``torch.distributed`` group: the reference's ``pmax`` is an all-reduce
MAX, its ``psum`` an all-reduce SUM.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _div(x, y: float):
    """x / y by IEEE division on x's device: a Python number would be a
    CPU scalar, which the CUDA kernels multiply by its reciprocal (one ulp
    from the quotient now and then)."""
    return x / torch.full((), y, dtype=x.dtype, device=x.device)


def _quantize(pre, scale):
    return torch.clamp(torch.round(pre / scale), -127, 127).to(torch.int8)


def quantize(g, residual):
    """→ (int8 payload, scale, new residual pre-state)."""
    g = g.float() + residual
    scale = _div(torch.clamp(g.abs().max(), min=1e-12), 127.0)
    return _quantize(g, scale), scale, g


def dequantize(q, scale):
    return q.float() * scale


def compress_tree(grads, residuals):
    """Returns (payload tree of (q, scale), new residual tree)."""
    qs, new_r = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        q, s, pre = quantize(g, r)
        qs.append((q, s))
        new_r.append(pre - dequantize(q, s))
    return tree_unflatten(grads, qs), tree_unflatten(grads, new_r)


def decompress_tree(payload):
    """The payload tree of (q, scale) pairs as float32 gradients."""
    if isinstance(payload, tuple) and len(payload) == 2 \
            and torch.is_tensor(payload[0]):
        return dequantize(*payload)
    if isinstance(payload, dict):
        return {k: decompress_tree(v) for k, v in payload.items()}
    return type(payload)(decompress_tree(v) for v in payload)


def psum_compressed(grads, residuals, group=None):
    """All-reduce grads over ``group`` in int8 with error feedback.

    The int8 payloads must share one scale across workers, so the
    per-tensor max is all-reduced (MAX) first (a scalar per tensor —
    negligible traffic).  Returns (mean grads float32, new residuals).
    """
    n = dist.get_world_size(group)

    def one(g, r):
        pre = g.float() + r
        gmax = pre.abs().max()
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        scale = _div(torch.clamp(gmax, min=1e-12), 127.0)
        q = _quantize(pre, scale)
        # pre - q·scale rounded once, as the fused multiply-add that XLA
        # makes of the reference's jitted body: q·scale (8 × 24 bits) and
        # the difference are exact in float64
        new_r = (pre.double() - q.double() * scale.double()).float()
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return _div(total.float() * scale, float(n)), new_r

    outs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(residuals))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
