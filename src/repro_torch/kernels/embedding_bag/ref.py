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
