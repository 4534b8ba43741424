"""Nested dicts and lists of tensors (the reference's pytrees), walked in
``jax.tree`` order: dict keys sorted, lists in order; and their carry to
and from numpy arrays in the reference's layout."""
from __future__ import annotations

import numpy as np


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); returns the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order:
    dict keys sorted) in place of its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = dict.fromkeys(t)
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def to_tensor(a, dtype, device=None):
    """Array ``a`` as a tensor of ``dtype``; a bfloat16 numpy array (the
    reference's, an ml_dtypes type numpy and torch do not know) is read
    through its 16-bit words, exactly."""
    import torch

    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype)
    return torch.tensor(a, dtype=dtype, device=device)


def tree_from_numpy(tree, like, device=None):
    """A pytree of arrays (the reference's layout) as tensors with the
    dtypes of the matching leaves of ``like`` (a tensor tree of the same
    structure, e.g. a step's meta-device args), on ``device`` (default:
    like's, the CPU for a meta leaf)."""
    import torch

    def put(a, t):
        dev = device if device is not None else (
            "cpu" if t.device.type == "meta" else t.device)
        return to_tensor(a, t.dtype, dev)

    return tree_map(put, tree, like)


def tree_to_numpy(tree):
    """A tensor tree as numpy arrays on the host (bfloat16 widened to
    float32, which numpy holds exactly)."""
    import torch

    def get(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return tree_map(get, tree)
