"""Sparse embedding lookups for recsys.

``embedding_bag_dense`` has torch.nn.EmbeddingBag's semantics: with one
bag per row of a (B, K) id array it goes through the embedding-bag kernel
(``kernels.embedding_bag.ops``); the CSR ``offsets`` form stays plain
torch.

Two paths, as the reference's: without a mesh context ``sharded_lookup``
is the gather ``table[ids]``; under ``dist.context.mesh_context`` the
table is row-sharded over the model axis — rank r holds rows
[r·V/tp, (r+1)·V/tp) — each rank gathers the ids in its row range (a
miss is zero) and the partial results are summed over the model axis.
:func:`sharded_bag` is the same cut for a bag: slots off the shard get
weight 0 and a clamped id, each rank sums its hits through the
embedding-bag kernel, and the partial bags are summed over the model
axis.  Wire bytes a lookup batch: B·F·dim, the row-sharded embedding
exchange.
"""
from __future__ import annotations

import torch

from repro_torch.dist.context import get_mesh_ctx
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


def _local_rows(table: torch.Tensor, ids: torch.Tensor, ctx):
    """(clamped local row, hit mask) of ``ids`` on this rank's shard."""
    v_local = table.shape[0]
    local = ids.long() - ctx.index((ctx.model_axis,)) * v_local
    hit = (local >= 0) & (local < v_local)
    return torch.clamp(local, 0, v_local - 1), hit


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, D) table × (...) ids → (..., D).  Under a mesh context
    ``table`` is this rank's row shard (V / tp rows) and ``ids`` its rows
    of the batch (the batch axes cut the batch only where they divide
    it); the result is the full lookup of those rows on every rank of the
    model axis.  Without one, the plain gather."""
    ctx = get_mesh_ctx()
    if ctx is None:
        return table[ids.long()]
    local, hit = _local_rows(table, ids, ctx)
    emb = torch.where(hit[..., None], table[local],
                      torch.zeros((), dtype=table.dtype,
                                  device=table.device))
    return ctx.psum(emb, (ctx.model_axis,))


def sharded_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Σ_k table[ids[:, k]] of a (B, K) id array through the embedding-bag
    kernel, ``table`` row-sharded as in :func:`sharded_lookup` under a
    mesh context: each rank sums its hits (a miss: weight 0 at a clamped
    id) and the partial bags are summed over the model axis.  Where the
    model axis is 1 every slot hits, and the call is the plain bag."""
    ctx = get_mesh_ctx()
    if ctx is None or ctx.tp == 1:
        return ops.embedding_bag(table, ids)
    local, hit = _local_rows(table, ids, ctx)
    part = ops.embedding_bag(table, local.to(torch.int32),
                             hit.to(table.dtype))
    return ctx.psum(part, (ctx.model_axis,))
