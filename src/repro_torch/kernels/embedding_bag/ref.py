"""Plain PyTorch versions of the embedding bag and its gradient: a gather
and a weighted sum (the system's own lookup path), and its scatter."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """(B, D) = Σ_k weights[b, k] · table[ids[b, k]], summed in float32
    (a bf16 table times float32 weights promotes) and cast to the table's
    type.  A slot of weight 0 still reads its row: 0 · NaN is NaN."""
    emb = table[ids.long()]                             # (B, K, D)
    return (emb * weights[..., None]).sum(1).to(table.dtype)


def embedding_bag_inorder_ref(table: torch.Tensor, ids: torch.Tensor,
                              weights: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """(B, D): the slot-by-slot float32 sum ``acc = acc + row_k · w_k``
    over k = 0..K-1 in order from 0, rounded once to the table's type.
    Without weights each step is ``acc + row_k``, which is what the
    kernel's ``fmaf(row_k, 1, acc)`` gives, so the two agree bit for bit;
    with weights the product is rounded before the add (the kernel's fmaf
    rounds once), equal where every product is exact (0/1 weights)."""
    acc = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for k in range(ids.shape[1]):
        row = table[ids[:, k].long()].float()
        acc = acc + (row if weights is None else row * weights[:, k, None])
    return acc.to(table.dtype)


def embedding_bag_backward_ref(table: torch.Tensor, ids: torch.Tensor,
                               weights: torch.Tensor | None,
                               grad_out: torch.Tensor,
                               need_table: bool = True,
                               need_weights: bool = False):
    """The gradient of :func:`embedding_bag_ref` (sum) for an upstream
    ``grad_out`` (B, D): (grad_table, grad_weights), each None where not
    asked for.  grad_table (V, D) in the table's type, dense:
    grad_table[ids[b, k]] += w[b, k] · grad_out[b] in float32 (an
    ``index_add_`` over the slots), rounded once.  grad_weights (B, K)
    float32: ⟨table[ids[b, k]], grad_out[b]⟩."""
    (b, k), d = ids.shape, table.shape[1]
    g = grad_out.float()
    gt = gw = None
    if need_table:
        contrib = g[:, None, :].expand(b, k, d)
        if weights is not None:
            contrib = contrib * weights[..., None]
        gt = torch.zeros(table.shape, dtype=torch.float32,
                         device=table.device).index_add_(
            0, ids.reshape(-1).long(), contrib.reshape(-1, d))
        gt = gt.to(table.dtype)
    if need_weights:
        gw = (table[ids.long()].float() * g[:, None, :]).sum(-1)
    return gt, gw
