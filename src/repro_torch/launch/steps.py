"""Serve-side step bodies of the LM and recsys cells (the serving half of
the reference's ``launch/steps.py``), with its useful-compute estimates.

Each body runs its model as one serving call under ``torch.no_grad``, on
the model's device.  Train steps and sharded steps wait for later slices.
"""
from __future__ import annotations

import torch


def lm_model_flops(cfg, shape: dict) -> float:
    s, b = shape["seq_len"], shape["global_batch"]
    n_act = cfg.active_param_count()
    l, h, hd = cfg.n_layers, cfg.n_heads, cfg.hd
    if shape["kind"] == "train":
        t = b * s
        # 6·N·T matmul + causal attention 2 matmuls fwd (×3 with bwd),
        # averaged causal span S/2
        return 6.0 * n_act * t + 3.0 * 2.0 * 2.0 * l * h * hd * t * (s / 2)
    if shape["kind"] == "prefill":
        t = b * s
        return 2.0 * n_act * t + 2.0 * 2.0 * l * h * hd * t * (s / 2)
    # decode: 1 token/row against an s-long cache
    t = b
    return 2.0 * n_act * t + 2.0 * 2.0 * l * h * hd * t * s


def recsys_model_flops(cfg, shape: dict) -> float:
    d_in = cfg.n_fields * cfg.embed_dim
    mlp = 0
    dims = [d_in, *cfg.mlp_dims, 1]
    for a, b_ in zip(dims[:-1], dims[1:]):
        mlp += 2 * a * b_
    per_row = mlp + cfg.n_fields * cfg.embed_dim * 4
    if shape["kind"] == "train":
        return 3.0 * shape["batch"] * per_row
    if shape["kind"] == "serve":
        return 1.0 * shape["batch"] * per_row
    return per_row + 2.0 * shape["n_candidates"] * cfg.embed_dim


@torch.no_grad()
def prefill_fn(model, tokens):
    """The prefill cell: (last position's logits (B, V), the (k, v)
    caches) of a full-sequence forward."""
    logits, caches, _ = model(tokens, return_cache=True)
    return logits[:, -1, :].clone(), caches


@torch.no_grad()
def lm_serve_fn(model, token, k_cache, v_cache, cache_len: int):
    """The decode cell: one decode step, the caches written in place."""
    logits, (k2, v2), new_len = model.decode(token, (k_cache, v_cache),
                                             cache_len)
    return logits, k2, v2, new_len


@torch.no_grad()
def recsys_serve_fn(model, xb):
    """The recsys serve cells: DeepFM's logits of a batch."""
    return model(xb)


@torch.no_grad()
def retrieval_fn(model, xb):
    """The retrieval cell: one query against every candidate."""
    return model.retrieval_scores(xb)
