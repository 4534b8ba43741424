"""Batched LM serving loop: aligned-batch KV-cache decode.

All rows share the cache position, the layout the decode cells use: the
prompt goes into the cache token by token through the decode step, then
``max_new_tokens`` steps pick the next token greedily or, with a
temperature, by ``random.categorical`` on JAX's threefry bits.  The cache
is written in place (the reference donates it through its jitted step),
so memory stays constant across steps; the position stays a host int and
the tokens stay on the device until the end, so no step waits on the
card.  An MoE model routes each step's B tokens together (capacity
ceil(B · K / E · 1.25) a step), as the reference's decode step does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.models.lm.transformer import Transformer


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    cache_len: int = 256
    temperature: float = 0.0
    seed: int = 0


def next_token(logits: torch.Tensor, key: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """(B, 1) int32 next tokens from (B, S, V) logits' last position:
    argmax, or with ``temperature`` > 0 a draw from softmax(logits / T)."""
    lg = logits[:, -1, :].float()
    if temperature > 0:
        # a tensor, not a Python scalar: true division on every device
        t = torch.tensor(max(temperature, 1e-6), dtype=torch.float32,
                         device=lg.device)
        return trandom.categorical(key, lg / t).to(torch.int32)[:, None]
    return lg.argmax(-1).to(torch.int32)[:, None]


@torch.no_grad()
def serve_batch(model: Transformer, prompts: np.ndarray,
                scfg: ServeConfig) -> np.ndarray:
    """prompts: (B, S0) int32 (aligned).  Returns (B, S0 + new) on the
    host; the model's device runs every step."""
    cfg = model.cfg
    b, s0 = prompts.shape
    smax = scfg.cache_len
    if s0 + scfg.max_new_tokens > smax:
        raise ValueError(f"{s0} prompt + {scfg.max_new_tokens} new tokens "
                         f"exceed the cache of {smax}")
    dev = model.embed.device
    shape = (cfg.n_layers, b, smax, cfg.n_kv_heads, cfg.hd)
    caches = (torch.zeros(shape, dtype=cfg.dtype, device=dev),
              torch.zeros(shape, dtype=cfg.dtype, device=dev))
    toks = torch.from_numpy(np.asarray(prompts, np.int32)).to(dev)
    pos = 0
    for i in range(s0 - 1):                 # the prompt into the cache
        _, caches, pos = model.decode(toks[:, i:i + 1], caches, pos)
    key = trandom.PRNGKey(scfg.seed, device=dev)
    out = [toks]
    tok = toks[:, -1:]
    for _ in range(scfg.max_new_tokens):
        key, sub = trandom.split(key)
        logits, caches, pos = model.decode(tok, caches, pos)
        tok = next_token(logits, sub, scfg.temperature)
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy()
