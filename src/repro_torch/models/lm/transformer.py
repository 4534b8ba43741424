"""LM-family transformer: GQA + RoPE + optional qk-norm + SwiGLU or MoE
(``models.lm.moe``), with the reference's stacked (L, ...) parameters.

Two lowerings, as the reference's serve cells use them: ``forward`` (the
full sequence, with ``return_cache=True`` the prefill that builds the KV
cache) and ``decode`` (one token against the cache).  Attention takes the
tensors' device as its route: on the card both go through the flash
kernel (``kernels.flash_attention.ops``) — prefill causal with the kv
heads read in place (no repeated copy), decode over the first
cache_len + 1 cache rows; on the CPU they run ``full_attention`` /
``chunked_attention`` / ``decode_attention``, the reference's plain
versions.  The card's kernel keeps the probabilities in float32 where the
reference's short-sequence and decode branches round them to the model's
type before the product with v.  An MoE layer adds the reference's
load-balance loss: ``forward`` returns its sum over the layers, which
``loss_fn`` weighs in; decode ignores it, as the reference does.

Training: ``loss_fn`` is the next-token cross-entropy; with gradients on,
each layer of ``forward`` runs under ``cfg.remat`` as the reference's
``_maybe_remat``: ``"none"`` keeps every activation, ``"full"``
recomputes the layer in the backward (``torch.utils.checkpoint``), and
``"dots"`` saves only the products without batch dimensions (the
projections, einsum's ``bmm`` with a batch of 1, and ``mm``) and
recomputes the rest, the attention included, as
``dots_with_no_batch_dims_saveable`` does: an MoE layer's router product
is an ``mm`` and saved, its per-expert products are ``bmm`` over E > 1
experts and recomputed, as JAX's policy treats the einsums' expert
dimension as a batch dimension.  Remat changes memory, not
values: the three give the same gradients bit for bit.  On the card the
prefill attention then carries a gradient through the flash kernel's
backward (``FlashAttentionFn``).

Sharded (under ``dist.context.mesh_context``): an MoE layer takes the
expert-parallel branch, and ``decode(..., seq_axes=...)`` reads a
sequence-sharded KV cache (split-KV across ranks): rank r of the
``seq_axes`` holds cache rows [r·S/n, (r+1)·S/n), the owning rank writes
the new token's k and v at ``cache_len``, each rank takes its rows'
partial attention (o in float32 and each row's log-sum-exp: the flash
kernel on the card, :func:`decode_attention_partials` on the CPU; a
rank whose rows all lie past ``cache_len`` gives o = 0, lse = -inf), and
the ranks' partials, gathered over ``seq_axes``, merge by the flash
family's merge (``flash.merge_partials``).  With one rank on the axes the
merge gives the single-device decode's bits.  ``shard_params_rules``
gives the parameters' spec tree for a rule table (``dist.sharding``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.graph import resolve_device
from repro_torch.dist.context import get_mesh_ctx
from repro_torch.dist.sharding import P, Rules
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.common import (cross_entropy, embed_init,
                                      normal_init,
                                      params_from_numpy,  # noqa: F401
                                      params_to_numpy, rms_norm)
from repro_torch.models.lm.moe import MoEConfig, init_moe, moe_block


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    moe: MoEConfig | None = None
    dtype: Any = torch.bfloat16
    remat: str = "dots"          # none | dots | full
    attn_chunk: int = 2048       # kv-block size for chunked attention
    use_chunked_attn_from: int = 8192  # seq length threshold

    def __post_init__(self):
        if self.remat not in ("none", "dots", "full"):
            raise ValueError(f"remat {self.remat!r}: none, dots or full")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        d, v, hd = self.d_model, self.vocab, self.hd
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * d
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_expert
        else:
            ffn = 3 * d * self.d_ff
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb

    def active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() \
            - self.n_layers * self.moe.n_experts * 3 * d * self.moe.d_expert
        return dense + self.n_layers * self.moe.top_k * 3 * d \
            * self.moe.d_expert


def shard_params_rules(cfg: LMConfig, rules: Rules) -> dict:
    """The :class:`P` tree of the parameters (``Transformer.param_tree``'s
    layout) under ``rules``: the reference's ``shard_params_rules``."""
    def stk(spec):  # stacked layer params get a leading None (layer axis)
        return P(None, *spec)

    layer = {
        "ln1": stk(()), "ln2": stk(()),
        "wq": stk(rules.get("w_q", P())),
        "wk": stk(rules.get("w_kv", P())),
        "wv": stk(rules.get("w_kv", P())),
        "wo": stk(rules.get("w_o", P())),
    }
    if cfg.qk_norm:
        layer["qnorm"] = stk(())
        layer["knorm"] = stk(())
    if cfg.moe is not None:
        # stacked expert tensors are (L, E, d, f): E on TP/EP, dim-2 FSDP
        we = rules.get("w_expert", P(None, None, None, None))
        layer["moe"] = {"router": P(None, None, None),
                        "wi": we, "wg": we, "wo": we}
    else:
        layer["wi"] = stk(rules.get("w_ffn_in", P()))
        layer["wg"] = stk(rules.get("w_ffn_in", P()))
        layer["wo_ffn"] = stk(rules.get("w_ffn_out", P()))
    out = {"embed": rules.get("w_embed", P()), "layers": layer,
           "final_norm": P()}
    if not cfg.tie_embeddings:
        out["lm_head"] = rules.get("w_embed", P())
    return out


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def full_attention(q, k, v, causal: bool = True):
    """Plain attention; q (B, S, H, hd), k and v (B, T, H, hd).  Scores in
    float32, probabilities cast to q's type before the product with v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    s, t = q.shape[1], k.shape[1]
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None] + (t - s))
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def chunked_attention(q, k, v, chunk: int, causal: bool = True):
    """Online-softmax attention over kv chunks of ``chunk``, all in
    float32: peak memory O(S · chunk) instead of O(S²)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    acc = torch.zeros((b, h, s, hd), device=q.device)
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    for c0 in range(0, t, chunk):
        kc, vc = k[:, c0:c0 + chunk].float(), v[:, c0:c0 + chunk].float()
        logits = torch.einsum("bshd,bthd->bhst", qf, kc) * scale
        if causal:
            kpos = torch.arange(c0, c0 + kc.shape[1], device=q.device)
            logits = logits.masked_fill(~(kpos[None, :] <= qpos),
                                        float("-inf"))
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                   # (B, S, H, hd)


def decode_attention(q, k_cache, v_cache, cache_len: int):
    """q (B, 1, H, hd); caches (B, Smax, HK, hd): single-token attention
    over the first ``cache_len`` cache rows, the query heads grouped over
    the kv heads (no repeated copy).  Probabilities cast to q's type."""
    b, smax, hkv = k_cache.shape[:3]
    g = q.shape[2] // hkv
    scale = 1.0 / math.sqrt(q.shape[-1])
    qg = q.reshape(b, q.shape[1], hkv, g, q.shape[-1])
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k_cache.float()) * scale
    mask = torch.arange(smax, device=q.device) < cache_len
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
    return out.reshape(b, q.shape[1], hkv * g, q.shape[-1])


# --------------------------------------------------------------------------
# transformer blocks
# --------------------------------------------------------------------------

def _prefill_attention(q, k, v, cfg: LMConfig):
    if q.is_cuda:
        return flash.flash_attention(q, k, v, causal=True)
    kf = _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    vf = _repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)
    if q.shape[1] >= cfg.use_chunked_attn_from:
        return chunked_attention(q, kf, vf, cfg.attn_chunk)
    return full_attention(q, kf, vf)


def decode_attention_partials(q, k_cache, v_cache, cache_len: int):
    """:func:`decode_attention` as a partial result: (o (B, 1, H, hd)
    float32, each row's natural-log log-sum-exp of its scaled, masked
    scores (B, H, 1) float32).  o is the same product (probabilities cast
    to q's type) widened to float32, so that one partial merged alone
    gives :func:`decode_attention`'s bits."""
    b, smax, hkv = k_cache.shape[:3]
    g = q.shape[2] // hkv
    scale = 1.0 / math.sqrt(q.shape[-1])
    qg = q.reshape(b, q.shape[1], hkv, g, q.shape[-1])
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k_cache.float()) * scale
    mask = torch.arange(smax, device=q.device) < cache_len
    logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)                 # (B, HK, G, S)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
    return (out.reshape(b, q.shape[1], hkv * g, q.shape[-1]).float(),
            lse.reshape(b, hkv * g, q.shape[1]))


def _decode_attention(q, k_cache, v_cache, kv_len: int):
    if q.is_cuda:
        return flash.flash_attention(q, k_cache, v_cache, causal=False,
                                     kv_len=kv_len)
    return decode_attention(q, k_cache, v_cache, kv_len)


def _split_kv_attention(q, k_cache, v_cache, kv_len: int, seq_axes):
    """Decode attention over a cache whose rows are cut over ``seq_axes``:
    this rank's ``kv_len`` kept rows give a partial (o, lse), the ranks'
    partials are gathered over the axes and merged."""
    ctx = get_mesh_ctx()
    if kv_len > 0:
        if q.is_cuda:
            o, lse = flash.flash_attention_partials(q, k_cache, v_cache,
                                                    kv_len)
        else:
            o, lse = decode_attention_partials(q, k_cache, v_cache, kv_len)
    else:                       # every row of this shard lies past the end
        b, s, h, d = q.shape
        o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, s), float("-inf"), device=q.device)
    o = ctx.all_gather(o[None], seq_axes, 0)
    lse = ctx.all_gather(lse[None], seq_axes, 0)
    return flash.merge_partials(o, lse, q.dtype)


def _attn_block(p: dict, x, positions, cfg: LMConfig, kv_cache=None,
                cache_len: int | None = None, seq_axes=None):
    """Returns (out, (k, v)): this call's new cache entries, or with
    ``kv_cache`` the caches with this token written at ``cache_len``
    (with ``seq_axes``, this rank's rows of a sequence-sharded cache)."""
    h = rms_norm(x, p["ln1"])
    q = torch.einsum("btd,dhk->bthk", h, p["wq"])
    k = torch.einsum("btd,dhk->bthk", h, p["wk"])
    v = torch.einsum("btd,dhk->bthk", h, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_cache is not None and seq_axes is not None:   # split-KV decode
        k_c, v_c = kv_cache
        rows = k_c.shape[1]
        lo = get_mesh_ctx().index(seq_axes) * rows
        if lo <= cache_len < lo + rows:             # this rank's row
            k_c[:, cache_len - lo] = k[:, 0].to(k_c.dtype)
            v_c[:, cache_len - lo] = v[:, 0].to(v_c.dtype)
        o = _split_kv_attention(q, k_c, v_c,
                                min(max(cache_len + 1 - lo, 0), rows),
                                seq_axes)
        new_kv = (k_c, v_c)
    elif kv_cache is not None:                      # decode: 1 new token
        k_c, v_c = kv_cache
        # In place: the reference writes the row with a one-hot ``where``
        # over its donated cache; the same row is written here.
        k_c[:, cache_len] = k[:, 0].to(k_c.dtype)
        v_c[:, cache_len] = v[:, 0].to(v_c.dtype)
        o = _decode_attention(q, k_c, v_c, cache_len + 1)
        new_kv = (k_c, v_c)
    else:
        o = _prefill_attention(q, k, v, cfg)
        new_kv = (k, v)
    return torch.einsum("bthk,hkd->btd", o, p["wo"]), new_kv


def _ffn_block(p: dict, x, cfg: LMConfig):
    """Returns (out, aux): the MoE layer's load-balance loss, or None in a
    dense layer (the reference's constant 0, left out of the sum)."""
    h = rms_norm(x, p["ln2"])
    if cfg.moe is not None:
        return moe_block(p["moe"], h, cfg.moe)
    gate = torch.einsum("btd,df->btf", h, p["wg"])
    up = torch.einsum("btd,df->btf", h, p["wi"])
    return torch.einsum("btf,fd->btd", nn.functional.silu(gate) * up,
                        p["wo_ffn"]), None


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products without batch dimensions (``mm``, and einsum's
    ``bmm`` over a batch of 1), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(mode: str, fn, *args):
    """``fn(*args)`` under the remat mode (only where gradients are on)."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if mode == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.
                      partial(create_selective_checkpoint_contexts,
                              _dots_policy))


def _stacked(gen, n: int, d_in: int, d_out: int, device, dtype):
    """(n, d_in, d_out): n layers of (d_in, d_out) normal weights scaled
    by 1 / sqrt(d_in)."""
    return normal_init(gen, (n, d_in, d_out), 1.0 / math.sqrt(d_in), device,
                       dtype)


class Transformer(nn.Module):
    """The reference's parameters: ``embed`` (V, d), ``layers`` (each
    leaf stacked over the L layers: ``ln1``, ``ln2`` (L, d); ``wq``
    (L, d, H, hd); ``wk``, ``wv`` (L, d, HK, hd); ``wo`` (L, H, hd, d);
    ``wi``, ``wg`` (L, d, d_ff); ``wo_ffn`` (L, d_ff, d), or in an MoE
    model ``moe`` (``router`` (L, d, E) in float32, ``wi``, ``wg``
    (L, E, d, f), ``wo`` (L, E, f, d)); with qk-norm ``qnorm``, ``knorm``
    (L, hd)), ``final_norm`` (d,) and, untied, ``lm_head`` (V, d), in
    ``cfg.dtype`` but the router.  Drawn from ``gen`` (by default seed 0
    on the model's device)."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        if gen is None and dev.type != "meta":
            gen = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        n, d, hd, dt = cfg.n_layers, cfg.d_model, cfg.hd, cfg.dtype
        h, hk = cfg.n_heads, cfg.n_kv_heads
        self.embed = nn.Parameter(embed_init(gen, cfg.vocab, d, dev, dt))
        layers = {
            "ln1": torch.ones((n, d), device=dev, dtype=dt),
            "ln2": torch.ones((n, d), device=dev, dtype=dt),
            "wq": _stacked(gen, n, d, h * hd, dev, dt).reshape(n, d, h, hd),
            "wk": _stacked(gen, n, d, hk * hd, dev, dt).reshape(n, d, hk, hd),
            "wv": _stacked(gen, n, d, hk * hd, dev, dt).reshape(n, d, hk, hd),
            "wo": _stacked(gen, n, h * hd, d, dev, dt).reshape(n, h, hd, d),
        }
        if cfg.moe is None:
            layers["wi"] = _stacked(gen, n, d, cfg.d_ff, dev, dt)
            layers["wg"] = _stacked(gen, n, d, cfg.d_ff, dev, dt)
            layers["wo_ffn"] = _stacked(gen, n, cfg.d_ff, d, dev, dt)
        if cfg.qk_norm:
            layers["qnorm"] = torch.ones((n, hd), device=dev, dtype=dt)
            layers["knorm"] = torch.ones((n, hd), device=dev, dtype=dt)
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(w) for k, w in layers.items()})
        if cfg.moe is not None:
            self.moe = nn.ParameterDict(
                {k: nn.Parameter(w) for k, w in init_moe(
                    gen, n, d, cfg.moe, dt, dev).items()})
        self.final_norm = nn.Parameter(torch.ones(d, device=dev, dtype=dt))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                embed_init(gen, cfg.vocab, d, dev, dt))

    def param_tree(self) -> dict:
        tree = {"embed": self.embed, "layers": dict(self.layers),
                "final_norm": self.final_norm}
        if self.cfg.moe is not None:
            tree["layers"]["moe"] = dict(self.moe)
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        return tree

    def _layer(self, i: int, x, positions, kv_cache=None, cache_len=None,
               seq_axes=None):
        """Returns (x, new_kv, aux)."""
        p = {k: w[i] for k, w in self.layers.items()}
        if self.cfg.moe is not None:
            p["moe"] = {k: w[i] for k, w in self.moe.items()}
        a, new_kv = _attn_block(p, x, positions, self.cfg, kv_cache,
                                cache_len, seq_axes)
        x = x + a
        f, aux = _ffn_block(p, x, self.cfg)
        return x + f, new_kv, aux

    def _layer_out(self, i: int, x, positions):
        x, _, aux = self._layer(i, x, positions)
        return x, aux

    def _logits(self, x):
        x = rms_norm(x, self.final_norm)
        head = self.embed if self.cfg.tie_embeddings else self.lm_head
        return torch.einsum("btd,vd->btv", x, head.to(self.cfg.dtype))

    def forward(self, tokens: torch.Tensor, return_cache: bool = False):
        """Full-sequence forward (prefill).  tokens: (B, S) →
        (logits (B, S, V), aux) or, with ``return_cache``, (logits,
        (k, v) each (L, B, S, HK, hd), aux); aux is the reference's MoE
        loss, 0 for a dense model."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self.embed.to(cfg.dtype)[tokens.long()]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        if return_cache:
            shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd)
            caches = (torch.empty(shape, dtype=cfg.dtype, device=x.device),
                      torch.empty(shape, dtype=cfg.dtype, device=x.device))
        aux = torch.zeros((), device=x.device)
        for i in range(cfg.n_layers):
            if return_cache:
                x, (k, v), a = self._layer(i, x, positions)
                caches[0][i] = k
                caches[1][i] = v
            else:
                x, a = _remat(cfg.remat, self._layer_out, i, x, positions)
            if a is not None:
                aux = aux + a
        logits = self._logits(x)
        return (logits, caches, aux) if return_cache else (logits, aux)

    def decode(self, token: torch.Tensor, kv_caches, cache_len: int,
               seq_axes=None):
        """One decode step.  token (B, 1); kv_caches (k, v) each
        (L, B, Smax, HK, hd), written in place at row ``cache_len`` (a
        host int); returns (logits (B, 1, V), kv_caches, cache_len + 1).
        With ``seq_axes`` (a tuple of mesh axes, under a mesh context) the
        caches are this rank's Smax / n rows of the sequence, and
        attention is split-KV across the axes' ranks."""
        if seq_axes is not None and get_mesh_ctx() is None:
            raise ValueError("a sequence-sharded cache needs a mesh context")
        cache_len = int(cache_len)
        b = token.shape[0]
        x = self.embed.to(self.cfg.dtype)[token.long()]
        positions = torch.full((b, 1), cache_len, device=x.device)
        k_all, v_all = kv_caches
        for i in range(self.cfg.n_layers):
            x, _, _ = self._layer(i, x, positions, (k_all[i], v_all[i]),
                                  cache_len, seq_axes)
        return self._logits(x), kv_caches, cache_len + 1


def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy (float32) of tokens (B, S + 1): the model
    reads tokens[:, :-1] and predicts tokens[:, 1:]; an MoE model adds
    ``aux_weight`` times its load-balance loss."""
    logits, aux = model(tokens[:, :-1])
    ce = cross_entropy(logits, tokens[:, 1:])
    if model.cfg.moe is not None:
        return ce + model.cfg.moe.aux_weight * aux
    return ce
