"""EquiformerV2 [Liao et al., 2023] — equivariant graph attention with the
eSCN SO(2) trick.

Per edge: rotate source irreps into the edge frame (Wigner-D, edge → +z),
where an SO(3) tensor-product convolution reduces to dense per-m linear
maps restricted to |m| ≤ m_max; mix, rotate back, aggregate with
invariant multi-head attention weights.

Features are real-SH irreps: (N, K, C), K = (l_max+1)², flattened (l, m)
with m ∈ [−l, l].  ``EquiformerV2.forward`` is the plain single-device
model, the oracle twin of the vertex-cut engine's ``eqv2_forward`` in
``repro_torch.launch.gnn_engine``, which reuses the pieces below.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.common import MLP, dense_init
from repro_torch.models.gnn.common import (GraphData, graph_readout,
                                           segment_agg, segment_softmax)
from repro_torch.models.gnn.wigner import (apply_blocks,
                                           rotation_to_edge_frame,
                                           sh_offsets, wigner_d_blocks)


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_feat: int = 32
    n_classes: int = 2
    n_rbf: int = 16
    rbf_cutoff: float = 5.0
    graph_level: bool = False

    @property
    def n_coeff(self) -> int:
        return (self.l_max + 1) ** 2


@lru_cache(maxsize=8)
def _m_groups(l_max: int, m_max: int):
    """index arrays into the flattened K per m-group.

    m=0 → (L0,) indices; m≥1 → (Lm,) index pairs for (+m, −m), Lm=l_max+1−m.
    """
    offs = sh_offsets(l_max)
    g0 = np.array([s + l for l, (s, d) in enumerate(offs)])  # m=0 slot: s+l
    pairs = []
    for m in range(1, m_max + 1):
        plus = np.array([offs[l][0] + l + m for l in range(m, l_max + 1)])
        minus = np.array([offs[l][0] + l - m for l in range(m, l_max + 1)])
        pairs.append((plus, minus))
    return g0, pairs


@lru_cache(maxsize=8)
def _m_group_index(l_max: int, m_max: int, device: torch.device):
    """:func:`_m_groups` as index tensors on ``device``, and the rows
    :func:`_so2_conv` writes (m = 0, then each m's (+m, −m) pair), made
    once: a copy from host memory would wait for the device each call."""
    g0, pairs = _m_groups(l_max, m_max)
    flat = [g0] + [x for pair in pairs for x in pair]
    g0_t, *pm = (torch.as_tensor(a, device=device)
                 for a in flat + [np.concatenate(flat)])
    rows = pm.pop()
    return g0_t, list(zip(pm[::2], pm[1::2])), rows


class EquiformerV2Layer(nn.Module):
    """One layer's parameters, named as the reference's pytree: ``w0``,
    ``score``, ``wout``, ``gate``, ``ffn0``, ``norm_scale`` and, for each
    m in 1..m_max, ``wr{m}`` and ``wi{m}``."""

    def __init__(self, cfg: EquiformerV2Config, gen: torch.Generator,
                 device=None):
        super().__init__()
        c, h = cfg.d_hidden, cfg.n_heads
        l0 = cfg.l_max + 1
        par = nn.Parameter
        self.w0 = par(dense_init(gen, l0 * c + cfg.n_rbf, l0 * c, device))
        self.score = par(dense_init(gen, c, h, device))
        self.wout = par(dense_init(gen, c, c, device) / math.sqrt(l0))
        self.gate = par(dense_init(gen, c, cfg.l_max * c, device)
                        .reshape(c, cfg.l_max, c))
        self.ffn0 = MLP([c, 2 * c, c], gen, device)
        self.norm_scale = par(torch.ones((cfg.l_max + 1, c), device=device))
        self.m_max = cfg.m_max
        for m in range(1, cfg.m_max + 1):
            lm = cfg.l_max + 1 - m
            setattr(self, f"wr{m}", par(dense_init(gen, lm * c, lm * c,
                                                   device)))
            setattr(self, f"wi{m}", par(dense_init(gen, lm * c, lm * c,
                                                   device)))

    def param_tree(self) -> dict:
        out = {k: getattr(self, k) for k in ("w0", "score", "wout", "gate",
                                             "norm_scale")}
        out["ffn0"] = self.ffn0.param_tree()
        for m in range(1, self.m_max + 1):
            out[f"wr{m}"] = getattr(self, f"wr{m}")
            out[f"wi{m}"] = getattr(self, f"wi{m}")
        return out


class EquiformerV2(nn.Module):
    MODEL = "equiformer_v2"

    def __init__(self, cfg: EquiformerV2Config,
                 gen: torch.Generator | None = None, device=None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.embed = nn.Parameter(dense_init(gen, cfg.d_feat, cfg.d_hidden,
                                             device))
        self.layers = nn.ModuleList(EquiformerV2Layer(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.head = MLP([cfg.d_hidden, cfg.d_hidden, cfg.n_classes], gen,
                        device)

    def param_tree(self) -> dict:
        return {"embed": self.embed,
                "layers": [lp.param_tree() for lp in self.layers],
                "head": self.head.param_tree()}

    def forward(self, g: GraphData):
        cfg = self.cfg
        n = g.node_feats.shape[0]
        blocks, rbf = edge_geometry(g.positions, g.edge_index[0].long(),
                                    g.edge_index[1].long(), cfg)
        f = embed_features(g.node_feats, self.embed, cfg)
        for lp in self.layers:
            f = _layer(lp, f, blocks, rbf, g.edge_index, g.edge_mask, cfg)
        s0 = f[:, 0, :]                                   # invariant readout
        if cfg.graph_level:
            s0 = graph_readout(s0, g.graph_ids, g.n_graphs, "mean")
        return self.head(s0, act=F.silu)


def embed_features(feats, embed, cfg: EquiformerV2Config):
    """(N, K, C) irreps: the embedded features in the l = 0 slot, 0
    elsewhere."""
    s0 = feats @ embed
    rest = torch.zeros((s0.shape[0], cfg.n_coeff - 1, cfg.d_hidden),
                       dtype=s0.dtype, device=s0.device)
    return torch.cat([s0[:, None, :], rest], dim=1)


def edge_geometry(positions, src, dst, cfg: EquiformerV2Config):
    """The Wigner-D blocks of each edge's frame rotation and its radial
    basis (E, n_rbf), from the (N, 3) positions."""
    rel = positions[dst] - positions[src]
    dist = torch.linalg.norm(rel, dim=-1, keepdim=True)
    r_hat = rel / torch.clamp(dist, min=1e-6)
    blocks = wigner_d_blocks(rotation_to_edge_frame(r_hat), cfg.l_max)
    # float32 (cutoff / (n_rbf - 1)) times 0..n_rbf-1, made on the device
    step = float(np.float32(cfg.rbf_cutoff) / np.float32(cfg.n_rbf - 1))
    centers = torch.arange(cfg.n_rbf, dtype=torch.float32,
                           device=positions.device) * step
    rbf = torch.exp(-((dist - centers[None, :]) ** 2)
                    * (cfg.n_rbf / cfg.rbf_cutoff) ** 2 * 0.5)
    return blocks, rbf


def _eq_norm(f, scale, l_max: int):
    """Equivariant RMS norm: per-l norm over m, per channel."""
    outs = []
    for l, (s, d) in enumerate(sh_offsets(l_max)):
        fl = f[..., s:s + d, :]
        rms = torch.sqrt((fl * fl).mean(dim=(-2, -1), keepdim=True) + 1e-6)
        outs.append(fl / rms * scale[l][None, None, :])
    return torch.cat(outs, dim=-2)


def _so2_conv(p, f_rot, rbf, cfg: EquiformerV2Config):
    """SO(2)-restricted mixing in the edge frame.  f_rot: (E, K, C).
    ``p`` is a layer (its ``w0``, ``wr{m}``, ``wi{m}``)."""
    e, k, c = f_rot.shape
    g0, pairs, rows = _m_group_index(cfg.l_max, cfg.m_max, f_rot.device)
    # m = 0: real linear over stacked (l, channel), fused with edge RBF
    x0 = f_rot[:, g0, :].reshape(e, -1)
    y0 = torch.cat([x0, rbf], dim=-1) @ p.w0                  # (E, L0·C)
    vals = [y0.reshape(e, -1, c)]
    # m ≥ 1: complex-pair linear maps (SO(2) equivariance)
    for m, (plus, minus) in enumerate(pairs, start=1):
        wr, wi = getattr(p, f"wr{m}"), getattr(p, f"wi{m}")
        zr = f_rot[:, plus, :].reshape(e, -1)
        zi = f_rot[:, minus, :].reshape(e, -1)
        yr = zr @ wr - zi @ wi
        yi = zr @ wi + zi @ wr
        vals += [yr.reshape(e, -1, c), yi.reshape(e, -1, c)]
    out = torch.zeros_like(f_rot)
    return out.index_copy(1, rows, torch.cat(vals, dim=1))


def invariant_scores(p, f_src, blocks, rbf, cfg: EquiformerV2Config):
    """The attention scores (E, H) of the messages' invariant row,
    ``leaky_relu(_so2_conv(p, apply_blocks(blocks, f_src), rbf)[:, 0]
    @ p.score)``, from that row's inputs alone: the m = 0 row of each
    rotated block and w0's first C columns."""
    x0 = torch.cat([blocks[l][:, l:l + 1, :] @ f_src[:, s:s + d, :]
                    for l, (s, d) in enumerate(sh_offsets(cfg.l_max))],
                   dim=1)
    y00 = torch.cat([x0.reshape(x0.shape[0], -1), rbf], -1) \
        @ p.w0[:, :cfg.d_hidden]
    return F.leaky_relu(y00 @ p.score, 0.2)


def gated_ffn(lp, f, cfg: EquiformerV2Config):
    """f + the gated FFN of f: a SiLU MLP on l = 0, sigmoid gates (from
    l = 0) on l > 0, after the equivariant norm."""
    fn2 = _eq_norm(f, lp.norm_scale, cfg.l_max)
    s0 = fn2[:, 0, :]                                     # l=0 scalars (N,C)
    upd0 = lp.ffn0(s0, act=F.silu)
    gates = torch.sigmoid(torch.einsum("nc,cld->nld", s0, lp.gate))
    outs = [upd0[:, None, :]]
    for l, (s, d) in enumerate(sh_offsets(cfg.l_max)):
        if l == 0:
            continue
        outs.append(fn2[:, s:s + d, :] * gates[:, None, l - 1, :])
    return f + torch.cat(outs, dim=-2)


def _layer(lp, f, blocks, rbf, edge_index, edge_mask, cfg):
    n, k, c = f.shape
    h = cfg.n_heads
    src, dst = edge_index[0].long(), edge_index[1]
    fn = _eq_norm(f, lp.norm_scale, cfg.l_max)
    # --- eSCN attention conv ---
    f_rot = apply_blocks(blocks, fn[src])                 # to edge frame
    msg = _so2_conv(lp, f_rot, rbf, cfg)
    g0, _ = _m_groups(cfg.l_max, cfg.m_max)
    inv = msg[:, int(g0[0]), :]                           # l=0 invariant (E,C)
    scores = F.leaky_relu(inv @ lp.score, 0.2)            # (E, H)
    alpha = segment_softmax(scores, dst, n, edge_mask)
    msg_back = apply_blocks(blocks, msg, transpose=True)  # back to global
    msg_h = msg_back.reshape(msg_back.shape[0], k, h, c // h)
    weighted = (msg_h * alpha[:, None, :, None]).reshape(-1, k, c)
    agg = segment_agg(weighted.reshape(-1, k * c), dst, n, "sum",
                      edge_mask).reshape(n, k, c)
    f = f + torch.einsum("nkc,cd->nkd", agg, lp.wout)
    return gated_ffn(lp, f, cfg)
