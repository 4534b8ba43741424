"""Mixture-of-Experts FFN with top-k routing and expert parallelism (the
reference's ``models/lm/moe.py``).

Each token picks its ``top_k`` experts by router probability; every
expert has a capacity of C = ceil(tokens · K / E · capacity_factor) slots
(GShard), and a token that finds its expert full is dropped from it (its
combine weight is 0).  The tokens are scattered into one (E, C, d)
buffer, every expert runs its SwiGLU FFN over its C slots as one batched
product, and each token sums its experts' outputs weighted by its
renormalised router probabilities.  Plain PyTorch on the inputs' device;
no host sync, so a decode step never waits on the card.

Two paths, as the reference's: without a mesh context all B · T tokens
at once (the dense dispatch); under ``dist.context.mesh_context`` the
expert-parallel branch.  Rank r of the model axis holds experts
[r·E/ep, (r+1)·E/ep), their weights cut on dim 1 (d of ``wi``/``wg``, f
of ``wo``) over the batch axes (FSDP) where the step sharded them so,
and gathered a layer (backward: a reduce-scatter).  It routes its rows
of the batch (the batch axes cut the batch only where they divide it),
with the capacity of its local token count, runs the choices that fall
on its experts and sums the partial outputs over the model axis.  The
positions and capacity are per shard, as the reference's: where a
capacity drops tokens the result differs from the dense dispatch by
design.  The load-balance loss is each batch shard's own, averaged over
the batch shards (not the dense block's loss over all tokens); its
gradient on a rank is its own shard's, so that the mean of the ranks'
gradients is the mean loss's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.dist.context import get_mesh_ctx
from repro_torch.models.common import normal_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    router_dtype: Any = torch.float32


def init_moe(gen: torch.Generator | None, n_layers: int, d_model: int,
             cfg: MoEConfig, dtype, device=None) -> dict:
    """The experts of ``n_layers`` layers, stacked over the layers: the
    router (L, d, E) in float32 whatever the model's type (the
    reference's ``init_moe``), ``wi`` and ``wg`` (L, E, d, f) and ``wo``
    (L, E, f, d) in ``dtype``; normal weights scaled by 1 / sqrt(fan-in)
    drawn from ``gen``."""
    n, d, e, f = n_layers, d_model, cfg.n_experts, cfg.d_expert
    return {
        "router": normal_init(gen, (n, d, e), 1.0 / math.sqrt(d), device,
                              torch.float32),
        "wi": normal_init(gen, (n, e, d, f), 1.0 / math.sqrt(d), device,
                          dtype),
        "wg": normal_init(gen, (n, e, d, f), 1.0 / math.sqrt(d), device,
                          dtype),
        "wo": normal_init(gen, (n, e, f, d), 1.0 / math.sqrt(f), device,
                          dtype),
    }


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, equal
    values lowest index first as ``jax.lax.top_k`` returns them: the
    first k of a stable descending sort (``torch.topk``'s order at ties
    is unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w: torch.Tensor, x2d: torch.Tensor, cfg: MoEConfig):
    """x2d (N, d) → weights (N, K) in x's type, experts (N, K) and the
    Switch load-balance loss E · Σ_e fraction_e · mean-prob_e (float32)."""
    n = x2d.shape[0]
    logits = x2d.to(cfg.router_dtype) @ router_w.to(cfg.router_dtype)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    # the fraction of first choices, as the reference's repeated addition
    # of 1/N (a bincount times 1/N rounds otherwise)
    ce = torch.zeros(cfg.n_experts, dtype=torch.float32, device=x2d.device)
    ce.index_add_(0, idx[:, 0], torch.full((n,), 1.0 / n,
                                           dtype=torch.float32,
                                           device=x2d.device))
    aux = cfg.n_experts * torch.sum(me * ce)
    return w.to(x2d.dtype), idx, aux


def _positions(experts: torch.Tensor, n_experts: int, capacity: int):
    """GShard's k-pass positions: each (token, choice)'s slot in its
    expert, counted over the tokens in order for choice 0, then choice 1
    after them, ...; and the mask of slots under ``capacity``.  The
    reference's k cumulative sums, each offset by the counts before it,
    are one cumulative sum over the choices laid out choice-major (the
    same integers, in one pass), taken along each expert's row of an
    (E, K · N) one-hot: a scan along the inner dimension (the outer one
    took 100 ms a layer at prefill_32k on the card)."""
    n, k = experts.shape
    col = experts.t().reshape(-1).long()                 # choice-major
    onehot = col[None, :] == torch.arange(n_experts, device=col.device
                                          )[:, None]
    pos = torch.cumsum(onehot, dim=1).gather(0, col[None, :])[0] - 1
    pos = pos.reshape(k, n).t()                          # (N, K)
    return pos, pos < capacity


def _expert_ffn(wi, wg, wo, buf):
    """buf (E, C, d) → (E, C, d): each expert's SwiGLU over its slots."""
    up = torch.bmm(buf, wi)
    gate = torch.bmm(buf, wg)
    return torch.bmm(nn.functional.silu(gate) * up, wo)


def _dispatch_compute_combine(p: dict, x2d, w, idx, pos, keep,
                              capacity: int, e_lo: int = 0):
    """Scatter the tokens into the (E_local, C, d) buffer of experts
    [e_lo, e_lo + E_local) (``p``'s), run the experts and combine.
    Slots are unique, so the scatter is a copy; a dropped choice, or one
    for another rank's expert, goes to a dump row past the buffer that is
    sliced away (the reference's out-of-range ``mode="drop"``)."""
    n, d = x2d.shape
    e = p["wi"].shape[0]
    dump = e * capacity
    keep = keep & (idx >= e_lo) & (idx < e_lo + e)
    flat_slot = torch.where(keep, (idx.long() - e_lo) * capacity + pos,
                            torch.full_like(pos, dump))
    buf = torch.zeros((dump + 1, d), dtype=x2d.dtype, device=x2d.device)
    for kk in range(idx.shape[1]):
        buf.index_copy_(0, flat_slot[:, kk], x2d)
    out = _expert_ffn(p["wi"], p["wg"], p["wo"],
                      buf[:dump].reshape(e, capacity, d)).reshape(dump, d)
    y = torch.zeros((n, d), dtype=x2d.dtype, device=x2d.device)
    for kk in range(idx.shape[1]):
        got = torch.where(keep[:, kk, None],
                          out[torch.clamp(flat_slot[:, kk], max=dump - 1)],
                          0.0)
        y = y + got * w[:, kk, None]             # x's type, in k order
    return y


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert: the reference's own float expression."""
    return int(np.ceil(tokens * cfg.top_k / cfg.n_experts
                       * cfg.capacity_factor))


def moe_block(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """x (B, T, d) → (y (B, T, d), aux loss).  Without a mesh context the
    reference's single-device branch over all B · T tokens at once; under
    one its expert-parallel branch on this rank's rows and experts (see
    the module's docstring).  At a mesh of one rank both give the same
    bits."""
    ctx = get_mesh_ctx()
    b, t, d = x.shape
    x2d = x.reshape(b * t, d)
    w, idx, aux = _route(p["router"], x2d, cfg)
    cap = capacity(b * t, cfg)
    pos, keep = _positions(idx, cfg.n_experts, cap)
    if ctx is None:
        y = _dispatch_compute_combine(p, x2d, w, idx, pos, keep, cap)
        return y.reshape(b, t, d), aux

    # --- expert parallelism ----------------------------------------------
    ep, model = ctx.tp, (ctx.model_axis,)
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts do not divide the EP "
                         f"axis of {ep}")
    e_local = cfg.n_experts // ep
    if p["wi"].shape[0] != e_local:
        raise ValueError(f"the rank holds {p['wi'].shape[0]} experts, "
                         f"expert parallelism over {ep} gives it {e_local}")
    ew = {}
    for k, full in (("wi", d), ("wg", d), ("wo", cfg.d_expert)):
        wk = p[k]
        if wk.shape[1] != full:        # FSDP-cut on dim 1: gather a layer
            if wk.shape[1] * ctx.dp != full:
                raise ValueError(f"{k} dim 1 is {wk.shape[1]} of {full}, "
                                 f"not cut over the batch axes' {ctx.dp}")
            wk = ctx.all_gather(wk, ctx.batch_axes, 1)
        ew[k] = wk
    r = ctx.index(model)
    y = _dispatch_compute_combine(ew, ctx.copy_to(x2d, model),
                                  ctx.copy_to(w, model), idx, pos, keep,
                                  cap, e_lo=r * e_local)
    y = ctx.psum(y, model)
    if ctx.dp > 1:
        # the mean over the batch shards; its gradient is this shard's own
        mean = ctx.psum(aux.detach(), ctx.batch_axes) / ctx.dp
        aux = mean + (aux - aux.detach())
    return y.reshape(b, t, d), aux
