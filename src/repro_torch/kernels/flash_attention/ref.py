"""Plain PyTorch versions of the attention that the flash kernel computes.

The kernel's function, on q (B, S, H, D) and k, v (B, T, HK, D) with HK
dividing H (query head h reads kv head h // (H // HK)): float32 scores
scaled by 1 / sqrt(D), the keys j < kv_len kept (and j <= i when causal),
a softmax and the product with v in float32, cast to q's type.
:func:`attention_ref` forms the whole (S, T) score matrix;
:func:`attention_chunked_ref` walks the keys in chunks with an online
softmax, for lengths where that matrix does not fit.  Both need
kv_len >= 1 (no row has every key masked).  :func:`attention_lse_ref`
adds each row's log-sum-exp, and :func:`attention_backward_ref` is the
gradient from the formulas (P from the LSE, D = rowsum(dO ∘ O)), one
batch row at a time so that a (H, S, T) score block is the most it holds.
:func:`attention_partials_ref` is a rank's partial result of split-KV
across ranks (float32 rows and their LSE over its keys) and
:func:`merge_partials_ref` the merge of R ranks' partials.
"""
from __future__ import annotations

import math

import torch


def _mask(s: int, t0: int, t1: int, kv_len: int, causal: bool, device):
    """(S, t1 - t0) bool: key t0 + j is kept for query i."""
    kj = torch.arange(t0, t1, device=device)
    keep = (kj < kv_len)[None, :].expand(s, -1)
    if causal:
        keep = keep & (kj[None, :] <= torch.arange(s, device=device)[:, None])
    return keep


def _grouped(q, k):
    b, s, h, d = q.shape
    hk = k.shape[2]
    if h % hk:
        raise ValueError(f"{hk} kv heads do not divide {h} query heads")
    return q.float().reshape(b, s, hk, h // hk, d)


def attention_ref(q, k, v, causal: bool = True, kv_len: int | None = None):
    """q (B, S, H, D), k and v (B, T, HK, D) → (B, S, H, D) in q's type."""
    b, s, h, d = q.shape
    t = k.shape[1]
    kv_len = t if kv_len is None else int(kv_len)
    qg = _grouped(q, k)
    scale = 1.0 / math.sqrt(d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    sc = sc.masked_fill(~_mask(s, 0, t, kv_len, causal, q.device),
                        float("-inf"))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(b, s, h, d).to(q.dtype)


def attention_chunked_ref(q, k, v, causal: bool = True,
                          kv_len: int | None = None, chunk: int = 2048):
    """:func:`attention_ref` by an online softmax over key chunks of
    ``chunk``: peak memory O(S · chunk) instead of O(S · T)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    kv_len = t if kv_len is None else int(kv_len)
    qg = _grouped(q, k)
    hk, g = qg.shape[2], qg.shape[3]
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, hk, g, s), float("-inf"), device=q.device)
    l = torch.zeros((b, hk, g, s), device=q.device)
    acc = torch.zeros((b, hk, g, s, d), device=q.device)
    for t0 in range(0, kv_len, chunk):
        t1 = min(t0 + chunk, kv_len)
        sc = torch.einsum("bskgd,btkd->bkgst", qg,
                          k[:, t0:t1].float()) * scale
        sc = sc.masked_fill(~_mask(s, t0, t1, kv_len, causal, q.device),
                            float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, v[:, t0:t1].float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]       # (B, HK, G, S, D)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def attention_lse_ref(q, k, v, causal: bool = True):
    """(out, lse): :func:`attention_ref` and each row's natural-log
    log-sum-exp of its scaled, masked scores, (B, H, S) float32."""
    b, s, h, d = q.shape
    t = k.shape[1]
    qg = _grouped(q, k)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    sc = sc.masked_fill(~_mask(s, 0, t, t, causal, q.device), float("-inf"))
    lse = torch.logsumexp(sc, dim=-1)                    # (B, HK, G, S)
    o = torch.einsum("bkgst,btkd->bskgd", torch.softmax(sc, dim=-1),
                     v.float())
    return o.reshape(b, s, h, d).to(q.dtype), lse.reshape(b, h, s)


def attention_backward_ref(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) of attention (every key kept, and j <= i when causal)
    for the upstream ``do``, in float32 from the formulas and cast to each
    input's type: P = exp(S·scale - lse), dV = Pᵀ dO, dP = dO Vᵀ,
    D = rowsum(dO ∘ O), dS = P ∘ (dP - D), dQ = scale · dS K,
    dK = scale · dSᵀ Q; the query heads of a kv head summed into its dK and
    dV."""
    b, s, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(d)
    keep = _mask(s, 0, t, t, causal, q.device)
    outs = ([], [], [])
    for i in range(b):
        qg = _grouped(q[i:i + 1], k)[0]                  # (S, HK, G, D)
        dog = do[i].float().reshape(s, hk, g, d)
        kf, vf = k[i].float(), v[i].float()              # (T, HK, D)
        sc = torch.einsum("skgd,tkd->kgst", qg, kf) * scale
        p = torch.exp(sc - lse[i].reshape(hk, g, s)[..., None])
        p = p.masked_fill(~keep, 0.0)
        dd = (dog * o[i].float().reshape(s, hk, g, d)).sum(-1)   # (S, HK, G)
        dp = torch.einsum("skgd,tkd->kgst", dog, vf)
        ds = p * (dp - dd.permute(1, 2, 0)[..., None])
        outs[0].append(torch.einsum("kgst,tkd->skgd", ds, kf)
                       .reshape(s, h, d) * scale)
        outs[1].append(torch.einsum("kgst,skgd->tkd", ds, qg) * scale)
        outs[2].append(torch.einsum("kgst,skgd->tkd", p, dog))
    return tuple(torch.stack(x).to(y.dtype) for x, y in zip(outs, (q, k, v)))


def attention_partials_ref(q, k, v, kv_len: int):
    """(o (B, S, H, D) float32, lse (B, H, S) float32): unmasked attention
    over the keys j < kv_len (>= 1), unrounded, and each row's
    natural-log log-sum-exp of its scaled, kept scores."""
    b, s, h, d = q.shape
    t = k.shape[1]
    qg = _grouped(q, k)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    sc = sc.masked_fill(~_mask(s, 0, t, kv_len, False, q.device),
                        float("-inf"))
    lse = torch.logsumexp(sc, dim=-1)                    # (B, HK, G, S)
    o = torch.einsum("bkgst,btkd->bskgd", torch.softmax(sc, dim=-1),
                     v.float())
    return o.reshape(b, s, h, d), lse.reshape(b, h, s)


def merge_partials_ref(o, lse, dtype):
    """o (R, B, S, H, D), lse (R, B, H, S) float32 → (B, S, H, D) in
    ``dtype``: Σ_r w_r·o_r / Σ_r w_r with w_r = e^(lse_r - max_r lse_r),
    summed in rank order (a row no rank kept a key of is 0)."""
    lse = lse.transpose(2, 3)                            # (R, B, S, H)
    m = lse.amax(0)
    w = torch.exp(lse - torch.where(torch.isinf(m), 0.0, m))
    acc = torch.zeros(o.shape[1:], dtype=torch.float32, device=o.device)
    den = torch.zeros(lse.shape[1:], dtype=torch.float32, device=o.device)
    for r in range(o.shape[0]):
        acc = acc + w[r][..., None] * o[r]
        den = den + w[r]
    out = torch.where(den[..., None] > 0, acc / den[..., None], 0.0)
    return out.to(dtype)
