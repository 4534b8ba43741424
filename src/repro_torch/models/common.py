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


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device=None) -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by 1 / sqrt(d_in)."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32)
    return (w / math.sqrt(d_in)).to(device)


class MLP(nn.Module):
    """``x @ w[i] + b[i]`` layer by layer, ``act`` between layers."""

    def __init__(self, dims: list[int], gen: torch.Generator, device=None):
        super().__init__()
        self.w = nn.ParameterList(
            nn.Parameter(dense_init(gen, a, b, device=device))
            for a, b in zip(dims[:-1], dims[1:]))
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(b, device=device)) for b in dims[1:])

    def forward(self, x, act=torch.relu):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = act(x)
        return x

    def param_tree(self) -> dict:
        return {"w": list(self.w), "b": list(self.b)}


def cross_entropy(logits, labels, mask=None):
    """Mean cross-entropy in float32 over the rows where ``mask`` holds
    (all rows without one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    onehot = nn.functional.one_hot(labels.long(), logits.shape[-1])
    nll = logz - (logits * onehot).sum(-1)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
