"""Hand-rolled optimizers: AdamW + SGD, global-norm clipping, linear-warmup
cosine schedule — the reference's ``train/optimizer.py`` on tensors.

Functions of trees of tensors (``repro_torch.tree``) with the reference's
arithmetic, step by step in the same order and in float32; not
``torch.optim``.  The state is a tree too: ``{"m", "v", "step"}`` for
AdamW, ``{"step"}`` for SGD; ``state_to_numpy`` / ``state_from_numpy``
carry it to and from the reference's layout (``m`` and ``v`` trees in
``state_dtype``, an int32 ``step``), so that a step of either package
can start from the other's state.  ``state_dtype`` bfloat16 halves the
moments' memory (the trillion-parameter models): they are stored in it
and widened to float32 for each update's arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import (tree_from_numpy, tree_leaves, tree_map,
                              tree_to_numpy)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    kind: str = "adamw"          # adamw | sgd
    state_dtype: Any = torch.float32     # bf16 halves m/v (trillion-param)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The float32 learning rate at int32 ``step``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params, cfg: OptConfig):
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.kind == "sgd":
        return {"step": step}
    zeros = tree_map(lambda p: torch.zeros_like(p.detach(),
                                                dtype=cfg.state_dtype),
                     params)
    return {"m": zeros, "v": tree_map(torch.clone, zeros), "step": step}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, gn=None):
    """Gradients times min(1, max_norm / |g|), in the type JAX promotes a
    gradient and the float32 scale to (a bfloat16 gradient's product is
    float32, not rounded back), and the global norm (``gn`` where the
    caller has it: a sharded step's norm over every rank's shards)."""
    if gn is None:
        gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                    * scale, grads), gn


@torch.no_grad()
def update(grads, state, params, cfg: OptConfig, grad_norm=None):
    """Returns (new_params, new_state, stats); inputs are not changed.
    ``grad_norm``: the gradients' global norm where the caller computed
    it (a sharded step: the trees are a rank's shards); else it is the
    norm of ``grads``."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    if cfg.clip_norm > 0:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm, grad_norm)
    else:
        gn = global_norm(grads) if grad_norm is None else grad_norm
    if cfg.kind == "sgd":
        new_params = tree_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
            params, grads)
        return new_params, {"step": step}, {"lr": lr, "grad_norm": gn}

    b1, b2, sd = cfg.b1, cfg.b2, cfg.state_dtype
    m = tree_map(lambda m_, g: (b1 * m_.float() + (1 - b1) * g.float()
                                ).to(sd), state["m"], grads)
    v = tree_map(lambda v_, g: (b2 * v_.float() + (1 - b2)
                                * torch.square(g.float())).to(sd),
                 state["v"], grads)
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()

    def upd(p, m_, v_):
        u = (m_.float() / c1) / (torch.sqrt(v_.float() / c2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "step": step}, \
        {"lr": lr, "grad_norm": gn}


def state_to_numpy(state) -> dict:
    """The optimizer state as the reference's layout of numpy arrays."""
    return tree_to_numpy(state)


def state_from_numpy(tree, params, cfg: OptConfig, device=None):
    """The reference's optimizer state (numpy arrays) as the port's, for
    ``params`` (a tensor tree; meta tensors give shapes only): ``m`` and
    ``v`` in params' layout and ``cfg.state_dtype``, an int32 ``step``, on
    ``device`` (default: params', the CPU for meta params)."""
    dev = torch.device(device) if device is not None else \
        tree_leaves(params)[0].device
    like = init(tree_map(lambda p: p.detach().to("meta"), params), cfg)
    return tree_from_numpy(tree, like, "cpu" if dev.type == "meta" else dev)
