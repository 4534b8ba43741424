"""Shared building blocks with the reference package's parameter layout
(an MLP is a ``w`` list and a ``b`` list), as ``nn.Module``\\ s.

Initial values come from an explicit ``torch.Generator``; they are not the
reference's numbers (its ``jax.random`` bits), so tests carry parameters
across with ``params_from_numpy``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.tree import to_tensor, tree_map, tree_to_numpy


def _meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device=None) -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by 1 / sqrt(d_in), drawn on the
    generator's device (on the meta device: shape and type only, nothing
    drawn)."""
    if _meta(device):
        return torch.empty((d_in, d_out), device="meta")
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w / math.sqrt(d_in)).to(device)


def normal_init(gen: torch.Generator, shape, std: float, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """Normal values times ``std``, drawn in float32 on the generator's
    device (a full-size table is made where it will live; on the meta
    device nothing is drawn)."""
    if _meta(device):
        return torch.empty(shape, device="meta", dtype=dtype)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(std).to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """(vocab, d) normal embeddings scaled by 0.02."""
    return normal_init(gen, (vocab, d), 0.02, device, dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) · scale over the last axis, computed in float32 and cast
    back to x's type."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


class MLP(nn.Module):
    """``x @ w[i] + b[i]`` layer by layer, ``act`` between layers and
    ``final_act`` (if any) after the last."""

    def __init__(self, dims: list[int], gen: torch.Generator, device=None):
        super().__init__()
        self.w = nn.ParameterList(
            nn.Parameter(dense_init(gen, a, b, device=device))
            for a, b in zip(dims[:-1], dims[1:]))
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(b, device=device)) for b in dims[1:])

    def forward(self, x, act=torch.relu, final_act=None):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = act(x)
            elif final_act is not None:
                x = final_act(x)
        return x

    def param_tree(self) -> dict:
        return {"w": list(self.w), "b": list(self.b)}


def cross_entropy(logits, labels, mask=None):
    """Mean cross-entropy in float32 over the rows where ``mask`` holds
    (all rows without one).  The label's logit is gathered: the
    reference's one-hot contraction adds exact zeros to it, so the values
    and gradients are the same, without a (rows, V) one-hot (12.9 GB as
    int64 at smollm-135m's vocabulary, batch 8, 4,096 positions)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits.gather(-1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def params_to_numpy(model: nn.Module) -> dict:
    """The model's parameters as the reference's pytree of numpy arrays
    (bfloat16 ones widened to float32, which numpy holds exactly)."""
    return tree_to_numpy(model.param_tree())


@torch.no_grad()
def params_from_numpy(model: nn.Module, tree) -> nn.Module:
    """Copy a pytree of arrays (the reference's layout, bfloat16 ones
    included) into the model's parameters, in place, each cast to its
    parameter's type (an MoE router stays float32 in a bf16 model);
    shapes must match."""
    def put(p, a):
        a = to_tensor(a, p.dtype)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"shape {tuple(a.shape)} for a parameter of "
                             f"shape {tuple(p.shape)}")
        p.copy_(a)

    tree_map(put, model.param_tree(), tree)
    return model

