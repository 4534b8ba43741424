"""Sparse embedding lookups for recsys, on one device.

``embedding_bag_dense`` has torch.nn.EmbeddingBag's semantics: with one
bag per row of a (B, K) id array it goes through the embedding-bag kernel
(``kernels.embedding_bag.ops``); the CSR ``offsets`` form stays plain
torch.  ``sharded_lookup`` is the reference's lookup without a mesh: the
gather ``table[ids]``.  The row-sharded lookup over a model axis waits for
a multi-card cell.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import ops


def embedding_bag_dense(table: torch.Tensor, ids: torch.Tensor,
                        offsets: torch.Tensor | None = None,
                        weights: torch.Tensor | None = None,
                        mode: str = "sum") -> torch.Tensor:
    """table (V, D).  ``offsets=None``: ids (B, K), one bag per row, and
    ``mean`` divides by K.  Else ids (K,) flat and offsets (B + 1,) bag
    boundaries (ids[offsets[i]:offsets[i + 1]] form bag i), and ``mean``
    divides by the bag's size (at least 1)."""
    if offsets is None:
        out = ops.embedding_bag(table, ids, weights, mode="sum")
        if mode == "mean":
            out = out / ids.shape[1]
        return out
    k = ids.shape[0]
    b = offsets.shape[0] - 1
    seg = torch.searchsorted(offsets[1:], torch.arange(k, device=ids.device),
                             right=True)
    emb = table[ids.long()]
    if weights is not None:
        emb = emb * weights[:, None]
    # ids past offsets[-1] fall in segment b, which is dropped
    out = torch.zeros((b + 1,) + tuple(emb.shape[1:]), dtype=emb.dtype,
                      device=emb.device).index_add_(0, seg, emb)[:b]
    if mode == "mean":
        cnt = torch.bincount(seg, minlength=b + 1)[:b].to(out.dtype)
        out = out / torch.clamp(cnt[:, None], min=1.0)
    return out


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, D) table × (...) ids → (..., D): the plain gather (the
    reference's lookup without a mesh)."""
    return table[ids.long()]
