"""Plain PyTorch version of the embedding bag: a gather and a weighted
sum (the system's own lookup path)."""
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
