"""DeepFM [Guo et al., IJCAI'17]: FM interaction branch ∥ deep MLP branch
over shared field embeddings, summed logits.

FM second-order term uses the standard identity
  Σ_{i<j} ⟨v_i, v_j⟩ = ½ (‖Σ_i v_i‖² − Σ_i ‖v_i‖²).

The two field sums of ``forward``, Σ_f w1[id_f] (first order) and
Σ_f v_f (the FM sum), are embedding bags of weight 1, computed by the
embedding-bag kernel (``kernels.embedding_bag.ops``): two launches a
forward on the card.  The (B, F, D) gather for the deep branch and
Σ‖v‖² stay plain torch.  Under a mesh context ``table``, ``w1`` and
``item_tower`` are this rank's row shards over the model axis
(``models.recsys.embedding``): the gather and both bags read the shard
and sum their partial results over the model axis, the bags still
through the kernel, and retrieval scores this rank's candidate rows.  ``retrieval_cand`` scores one query against the
whole candidate tower with one matmul.  Training (``loss_fn`` under
autograd) takes the table's gradient through the gather and both bags:
on the card each bag's backward is one ``embedding_bag_backward`` launch,
a dense (V, D) gradient as in the reference, which AdamW applies to
every row.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.common import (MLP, normal_init,
                                      params_from_numpy,  # noqa: F401
                                      params_to_numpy)
from repro_torch.models.recsys.embedding import (sharded_bag,
                                                 sharded_lookup)


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_fields: int = 39
    rows_per_field: int = 1_000_000
    embed_dim: int = 10
    mlp_dims: tuple[int, ...] = (400, 400, 400)
    n_candidates: int = 1_000_000       # retrieval_cand item-tower rows


def _field_ids(x: torch.Tensor, cfg: DeepFMConfig) -> torch.Tensor:
    """(B, F) per-field raw ids → int32 global rows of the concatenated
    table (field f row r ↦ f · rows + r)."""
    offs = torch.arange(cfg.n_fields, dtype=torch.int32,
                        device=x.device) * cfg.rows_per_field
    return (x.to(torch.int32) % cfg.rows_per_field + offs[None, :]
            ).to(torch.int32)


class DeepFM(nn.Module):
    """The reference's parameters: ``table`` (F · rows, D) and ``w1``
    (F · rows, 1) over the concatenated fields, ``bias``, the deep
    ``mlp`` (F · D → mlp_dims → 1), ``item_tower`` (C, D) and
    ``query_proj`` (F · D, D).  Drawn from ``gen`` (by default seed 0 on
    the model's device, so a full-size table is made on the card)."""

    def __init__(self, cfg: DeepFMConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        if gen is None and dev.type != "meta":
            gen = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        v = cfg.n_fields * cfg.rows_per_field
        fd = cfg.n_fields * cfg.embed_dim
        self.table = nn.Parameter(
            normal_init(gen, (v, cfg.embed_dim), 0.01, dev))
        self.w1 = nn.Parameter(normal_init(gen, (v, 1), 0.01, dev))
        self.bias = nn.Parameter(torch.zeros((), device=dev))
        self.mlp = MLP([fd, *cfg.mlp_dims, 1], gen, dev)
        self.item_tower = nn.Parameter(
            normal_init(gen, (cfg.n_candidates, cfg.embed_dim), 0.01, dev))
        self.query_proj = nn.Parameter(
            normal_init(gen, (fd, cfg.embed_dim), 0.02, dev))

    def param_tree(self) -> dict:
        return {"table": self.table, "w1": self.w1, "bias": self.bias,
                "mlp": self.mlp.param_tree(), "item_tower": self.item_tower,
                "query_proj": self.query_proj}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, F) int categorical ids → (B,) logits."""
        ids = _field_ids(x, self.cfg)
        emb = sharded_lookup(self.table, ids)                  # (B, F, D)
        first = sharded_bag(self.w1, ids)[:, 0]                # (B,)
        s = sharded_bag(self.table, ids)                       # (B, D)
        fm2 = 0.5 * ((s * s).sum(-1) - (emb * emb).sum((1, 2)))
        deep = self.mlp(emb.reshape(x.shape[0], -1))[:, 0]
        return self.bias + first + fm2 + deep

    def retrieval_scores(self, x_query: torch.Tensor) -> torch.Tensor:
        """One query (1, F) against the full candidate tower →
        (n_candidates,), one matmul."""
        ids = _field_ids(x_query, self.cfg)
        emb = sharded_lookup(self.table, ids)                  # (1, F, D)
        q = emb.reshape(1, -1) @ self.query_proj               # (1, D)
        return self.item_tower @ q[0]


def loss_fn(model: DeepFM, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on click labels y ∈ {0, 1}."""
    logits = model(x)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
