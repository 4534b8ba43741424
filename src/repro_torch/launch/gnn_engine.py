"""Engine-based full-graph GNN training (vertex-cut, NE-partitioned).

Rank d owns partition d's edges (mirror-local indices) and runs, every
layer,

  master→mirror broadcast (all-to-all) → local edge compute → mirror
  aggregation → mirror→master reduce (all-to-all) → apply on masters.

GIN aggregates with the block-sparse SpMM kernel: A_local, the rank's
mirror-local adjacency in both directions as a block-CSR built once on
the host, times h_m is exactly ``scatter_edges(h_m[src], h_m[dst])`` of
the reference, and its gradient goes back through the same kernel (A_local
is symmetric).  PNA (sum, max, min and sums of squares), EGNN and
EquiformerV2 (a chunked edge loop with an exact distributed segment
softmax) compute per-edge messages with their MLPs and reduce them with
``scatter_edges`` and ``mirror_to_master``.  Gradients flow back through
the reverse all-to-alls; the ranks then sum their parameter gradients.

Each rank holds only its own slice of the engine arrays, on its own
device; the ranks form a ``torch.distributed`` group (a world-1 group on
one card).  :func:`synth_caps` and :func:`engine_array_specs` give a
cell's capacities from an assumed replication factor and the engine
arrays' global shapes (the step builder's shapes, as the reference's
dry run reads them).  The mirror↔master exchange sends values in their
own type (float32 in every cell).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.apps import engine as eng
from repro_torch.core.graph import resolve_device
from repro_torch.dist import compat
from repro_torch.kernels.block_spmm import ops as spmm
from repro_torch.models.gnn import equiformer_v2 as eqv2
from repro_torch.models.gnn.pna import scalers
from repro_torch.models.gnn.wigner import apply_blocks
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_map

BLOCK = 128      # bm = bn of the mirror block-CSR
EDGE_CHUNK = 16384   # EquiformerV2's directed edges a chunk


@dataclasses.dataclass(frozen=True)
class EngineCaps:
    """Static per-rank capacities (padded)."""
    n_dev: int
    n_vertices: int
    c_edges: int        # local undirected edges
    r_mirrors: int
    o_owned: int
    l_lane: int         # per-(src,dst) all-to-all lane
    feat: int
    n_classes: int


def synth_caps(shape: dict, n_dev: int, rf: float = 4.0,
               alpha: float = 1.1) -> EngineCaps:
    """Capacities of a full-graph cell over ``n_dev`` ranks, from an
    assumed replication factor ``rf`` and edge imbalance ``alpha`` (the
    reference's own expressions)."""
    n, e = shape["n_nodes"], shape["n_edges"]
    o = int(np.ceil(n / n_dev))
    r = int(np.ceil(rf * n / n_dev))
    return EngineCaps(
        n_dev=n_dev, n_vertices=n,
        c_edges=int(np.ceil(alpha * e / n_dev)),
        r_mirrors=r, o_owned=o,
        l_lane=int(np.ceil(r / n_dev * 1.3)) + 1,
        feat=shape["d_feat"], n_classes=shape["n_classes"])


def engine_array_specs(caps: EngineCaps, positions: bool) -> dict:
    """The engine arrays' global shapes and types, stacked over the ranks
    (rank d holds row d), as meta-device tensors: the reference's
    ``engine_array_specs``.  A rank's own arrays (:func:`engine_arrays`)
    add its mirror block-CSR."""
    d = caps.n_dev
    i32, bool_, f32 = torch.int32, torch.bool, torch.float32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = dict(
        edges_ml=meta((d, caps.c_edges, 2), i32),
        emask=meta((d, caps.c_edges), bool_),
        send_idx=meta((d, d, caps.l_lane), i32),
        send_mask=meta((d, d, caps.l_lane), bool_),
        recv_owned=meta((d, d, caps.l_lane), i32),
        owned_mask=meta((d, caps.o_owned), bool_),
        feats=meta((d, caps.o_owned, caps.feat), f32),
        labels=meta((d, caps.o_owned), i32),
        label_mask=meta((d, caps.o_owned), bool_),
        positions=meta((d, caps.o_owned, 3), f32),
    )
    if not positions:
        out.pop("positions")
    return out


def caps_from_sharded_graph(sg: eng.ShardedGraph, d_feat: int,
                            n_classes: int) -> EngineCaps:
    c = sg.caps
    return EngineCaps(n_dev=sg.num_devices, n_vertices=sg.num_vertices,
                      c_edges=c["C"], r_mirrors=c["R"], o_owned=c["O"],
                      l_lane=c["L"], feat=d_feat, n_classes=n_classes)


def engine_arrays(sg: eng.ShardedGraph, feats: np.ndarray,
                  labels: np.ndarray, label_mask: np.ndarray, rank: int,
                  device, positions: np.ndarray | None = None) -> dict:
    """Rank ``rank``'s engine arrays as tensors on ``device``: its slice
    of the ShardedGraph, its masters' features, labels, label mask and
    (where given) (N, 3) positions, and its mirror block-CSR (``cols``,
    ``blocks``) over R mirrors padded to a multiple of :data:`BLOCK`, with
    ``symmetric``, the block-CSR's record that its gradient may reuse it
    (a bool, not a tensor)."""
    o = sg.caps["O"]
    sel = sg.owned_mask[rank]
    ids = sg.owned_glob[rank][sel]
    f_o = np.zeros((o, feats.shape[1]), np.float32)
    y_o = np.zeros((o,), np.int32)
    m_o = np.zeros((o,), bool)
    f_o[sel] = feats[ids]
    y_o[sel] = labels[ids]
    m_o[sel] = label_mask[ids]
    local = sg.edges_ml[rank][sg.emask[rank]]
    csr = spmm.build_block_csr(local, sg.caps["R"], BLOCK, BLOCK)
    cols, blocks, _ = csr
    out = dict(edges_ml=sg.edges_ml[rank], emask=sg.emask[rank],
               send_idx=sg.send_idx[rank], send_mask=sg.send_mask[rank],
               recv_owned=sg.recv_owned[rank],
               owned_mask=sg.owned_mask[rank], feats=f_o, labels=y_o,
               label_mask=m_o, cols=cols, blocks=blocks)
    if positions is not None:
        p_o = np.zeros((o, 3), np.float32)
        p_o[sel] = positions[ids]
        out["positions"] = p_o
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in out.items()}
    arrays["symmetric"] = csr.symmetric
    return arrays


def _bcast(x_o, a, caps, group):
    return eng.master_to_mirror(x_o, a["send_idx"], a["send_mask"],
                                a["recv_owned"], caps.r_mirrors, group)


def _reduce(x_m, a, caps, group, op="sum", identity=0.0):
    return eng.mirror_to_master(x_m, a["send_idx"], a["send_mask"],
                                a["recv_owned"], caps.o_owned, op, identity,
                                group)


def _scatter(to_dst, to_src, a, caps, op="sum", identity=0.0):
    return eng.scatter_edges(to_dst, to_src, a["edges_ml"], a["emask"],
                             caps.r_mirrors, op, identity)


def _degrees(a, caps, group):
    """(O, 1) degrees of this rank's masters, in the features' dtype."""
    ones = a["emask"].to(a["feats"].dtype)[:, None]
    return _reduce(_scatter(ones, ones, a, caps), a, caps, group)


def _finite_or_0(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def gin_forward(model, a, caps: EngineCaps, group=None):
    """(O, n_classes) logits of this rank's masters."""
    h = a["feats"]
    r = caps.r_mirrors
    n_pad = a["cols"].shape[0] * a["blocks"].shape[2]
    for lp in model.layers:
        h_m = _bcast(h, a, caps, group)
        xp = torch.nn.functional.pad(h_m, (0, 0, 0, n_pad - r))
        agg_m = spmm.block_spmm(a["cols"], a["blocks"], xp,
                                a["symmetric"])[:r]
        agg = _reduce(agg_m, a, caps, group)
        h = torch.relu(lp.mlp((1.0 + lp.eps) * h + agg, act=torch.relu))
    return model.head(h)


def pna_forward(model, a, caps: EngineCaps, group=None):
    """(O, n_classes) logits of this rank's masters.  Each edge sends a
    message both ways; the max and min reduce in two stages (the rank's
    mirrors, then the masters), whose gradient splits ties as
    ``jax.grad`` of the reference's does, stage by stage."""
    cfg = model.cfg
    h = a["feats"]
    deg = _degrees(a, caps, group)[:, 0]
    sc = scalers(deg, cfg.avg_log_deg)
    cnt = torch.clamp(deg, min=1.0)[:, None]
    src, dst = a["edges_ml"][:, 0].long(), a["edges_ml"][:, 1].long()
    inf = float("inf")
    for lp in model.layers:
        h_m = _bcast(h, a, caps, group)
        msg_d = lp.pre(torch.cat([h_m[src], h_m[dst]], -1))   # src→dst
        msg_s = lp.pre(torch.cat([h_m[dst], h_m[src]], -1))   # dst→src
        s_ = _reduce(_scatter(msg_d, msg_s, a, caps), a, caps, group)
        sq = _reduce(_scatter(msg_d ** 2, msg_s ** 2, a, caps), a, caps,
                     group)
        mx = _reduce(_scatter(msg_d, msg_s, a, caps, "max", -inf), a, caps,
                     group, "max", -inf)
        mn = _reduce(_scatter(msg_d, msg_s, a, caps, "min", inf), a, caps,
                     group, "min", inf)
        mean = s_ / cnt
        std = torch.sqrt(torch.clamp(sq / cnt - mean * mean, min=0.0)
                         + 1e-6)
        aggs = [mean, _finite_or_0(mx), _finite_or_0(mn), std]
        stacked = [x * s for x in aggs for s in sc]
        h = torch.relu(lp.post(torch.cat(stacked + [h], -1)))
    return model.head(h)


def egnn_forward(model, a, caps: EngineCaps, group=None):
    """(O, n_classes) logits of this rank's masters; positions move with
    the layers, broadcast beside the features."""
    h, x = a["feats"], a["positions"]
    deg = torch.clamp(_degrees(a, caps, group)[:, 0], min=1.0)
    src, dst = a["edges_ml"][:, 0].long(), a["edges_ml"][:, 1].long()
    for lp in model.layers:
        hx_m = _bcast(torch.cat([h, x], -1), a, caps, group)
        h_m, x_m = hx_m[:, :-3], hx_m[:, -3:]
        rel_d = x_m[dst] - x_m[src]                      # message src→dst
        d2 = (rel_d * rel_d).sum(-1, keepdim=True)
        m_d = lp.phi_e(torch.cat([h_m[dst], h_m[src], d2], -1), act=F.silu,
                       final_act=F.silu)
        m_s = lp.phi_e(torch.cat([h_m[src], h_m[dst], d2], -1), act=F.silu,
                       final_act=F.silu)
        coef_d = lp.phi_x(m_d, act=F.silu)
        coef_s = lp.phi_x(m_s, act=F.silu)
        xupd = _reduce(_scatter(rel_d * coef_d, -rel_d * coef_s, a, caps),
                       a, caps, group)
        x = x + xupd / deg[:, None]
        magg = _reduce(_scatter(m_d, m_s, a, caps), a, caps, group)
        h = lp.phi_h(torch.cat([h, magg], -1), act=F.silu)
    return model.head(h)


def eqv2_forward(model, a, caps: EngineCaps, group=None,
                 edge_chunk: int = EDGE_CHUNK):
    """EquiformerV2 over the engine: each layer's eSCN convolution over
    the rank's directed edges (both directions of each local edge) in
    chunks of ``edge_chunk``, with the exact distributed segment softmax
    in two passes: the scores' max-reduce, then the weighted sums and
    the weights' sum-reduce.  Each pass builds a chunk's Wigner-D blocks
    and radial basis from the positions where it needs them, so a chunk's
    edges bound what the forward's edge loop holds (the backward's
    recompute of a layer keeps every chunk's residuals, as the
    reference's does).  The first pass computes
    only the messages' invariant row, which is all the scores read
    (``invariant_scores``), the second the whole messages.  Each layer is
    recomputed in the backward pass (``torch.utils.checkpoint``) instead
    of keeping the chunks' activations."""
    cfg = model.cfg
    k, c, hh = cfg.n_coeff, cfg.d_hidden, cfg.n_heads
    o, r = caps.o_owned, caps.r_mirrors
    f = eqv2.embed_features(a["feats"], model.embed, cfg)
    pos_m = _bcast(a["positions"], a, caps, group)           # (R, 3)
    src_u, dst_u = a["edges_ml"][:, 0].long(), a["edges_ml"][:, 1].long()
    src = torch.cat([src_u, dst_u])
    dst = torch.cat([dst_u, src_u])
    emask = torch.cat([a["emask"], a["emask"]])
    chunks = [(src[lo:lo + edge_chunk], dst[lo:lo + edge_chunk],
               emask[lo:lo + edge_chunk])
              for lo in range(0, max(1, src.shape[0]), edge_chunk)]
    inf = float("inf")

    def layer(lp, f):
        fn = eqv2._eq_norm(f, lp.norm_scale, cfg.l_max)
        fn_m = _bcast(fn.reshape(o, k * c), a, caps, group).reshape(r, k, c)
        smax = torch.full((r, hh), -inf, device=f.device)
        for s_, d_, m_ in chunks:
            blocks, rbf = eqv2.edge_geometry(pos_m, s_, d_, cfg)
            sc = eqv2.invariant_scores(lp, fn_m[s_], blocks, rbf, cfg)
            sc = torch.where(m_[:, None], sc, torch.full_like(sc, -inf))
            smax = smax.scatter_reduce(0, d_[:, None].expand_as(sc), sc,
                                       reduce="amax")
        smax_o = _finite_or_0(_reduce(smax, a, caps, group, "max", -inf))
        smax_back = _bcast(smax_o, a, caps, group)            # (R, H)
        acc = torch.zeros((r, k * c), device=f.device)
        wsum = torch.zeros((r, hh), device=f.device)
        for s_, d_, m_ in chunks:
            blocks, rbf = eqv2.edge_geometry(pos_m, s_, d_, cfg)
            msg = eqv2._so2_conv(lp, apply_blocks(blocks, fn_m[s_]), rbf,
                                 cfg)
            sc = F.leaky_relu(msg[:, 0, :] @ lp.score, 0.2)
            # masked before exp: an unselected exp(inf) would send NaN back
            z = torch.where(m_[:, None], sc - smax_back[d_],
                            torch.full_like(sc, -inf))
            w = torch.exp(z)
            back = apply_blocks(blocks, msg, transpose=True)
            wh = back.reshape(-1, k, hh, c // hh) * w[:, None, :, None]
            acc = acc.index_add(0, d_, wh.reshape(-1, k * c))
            wsum = wsum.index_add(0, d_, w)
        agg = _reduce(acc, a, caps, group).reshape(o, k, hh, c // hh)
        wsum = _reduce(wsum, a, caps, group)                   # (O, H)
        agg = (agg / torch.clamp(wsum[:, None, :, None], min=1e-16)
               ).reshape(o, k, c)
        f = f + torch.einsum("nkc,cd->nkd", agg, lp.wout)
        return eqv2.gated_ffn(lp, f, cfg)

    for lp in model.layers:
        f = checkpoint(layer, lp, f, use_reentrant=False)
    return model.head(f[:, 0, :], act=F.silu)


ENGINE_FWD = {"gin": gin_forward, "pna": pna_forward, "egnn": egnn_forward,
              "equiformer_v2": eqv2_forward}


def engine_loss(model, a, caps: EngineCaps, group=None):
    """Masked cross-entropy over every rank's masters, the same scalar on
    every rank: Σ_ranks loss_sum / max(Σ_ranks count, 1), in float32 or
    wider (a float64 model's stays float64).  The forward is the model's
    family's (``ENGINE_FWD[model.MODEL]``)."""
    logits = ENGINE_FWD[model.MODEL](model, a, caps, group)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lm = a["label_mask"]
    logz = torch.logsumexp(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(a["labels"].long(),
                                         logits.shape[-1])
    nll = logz - (logits * onehot).sum(-1)
    loss_sum = torch.where(lm, nll, torch.zeros_like(nll)).sum()
    cnt = compat.all_reduce_sum(lm.sum(), group)
    return compat.all_reduce_sum(loss_sum, group) / torch.clamp(cnt, min=1)


def loss_and_grads(model, a, caps: EngineCaps, group=None):
    """The loss; leaves in every parameter's ``.grad`` the gradient of the
    loss, summed over the ranks (the same on every rank).  A parameter
    the loss does not reach (EGNN's last ``phi_x``) gets zeros."""
    model.zero_grad(set_to_none=True)
    loss = engine_loss(model, a, caps, group)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad, group=group)
    return loss.detach()


def train_step(model, a, caps: EngineCaps, state, ocfg: opt.OptConfig,
               group=None):
    """One step: loss, backward, gradient sum over the ranks, and the
    optimizer's update of the model's parameters in place.  Returns
    (loss, the optimizer's new state); the loss stays on the device."""
    loss = loss_and_grads(model, a, caps, group)
    params = model.param_tree()
    grads = tree_map(lambda p: p.grad, params)
    new, state, _ = opt.update(grads, state, params, ocfg)
    with torch.no_grad():
        tree_map(lambda p, q: p.copy_(q), params, new)
    return loss, state


def train_engine_gin(edges: np.ndarray, edge_part: np.ndarray,
                     num_vertices: int, feats: np.ndarray,
                     labels: np.ndarray, label_mask: np.ndarray, model,
                     ocfg: opt.OptConfig, steps: int, device=None,
                     group=None) -> list[float]:
    """Full-graph GIN training over the vertex-cut engine: build this
    rank's engine arrays from the edge partition (rank d owns the edges of
    part d, one part per rank of ``group``), then ``steps`` times loss,
    backward, gradient sum over the ranks, ``ocfg``'s optimizer update.

    ``model`` (a ``GIN`` whose ``d_feat`` is ``feats``' width) is moved to
    the device and trained in place; every rank must start from the same
    parameters.  Returns the loss of each step.  ``device=None`` means
    the card.
    """
    dev = resolve_device(device)
    rank = dist.get_rank(group)
    sg = eng.build_sharded_graph(edges, edge_part, num_vertices,
                                 dist.get_world_size(group))
    caps = caps_from_sharded_graph(sg, feats.shape[1], model.cfg.n_classes)
    a = engine_arrays(sg, feats, labels, label_mask, rank, dev)
    model.to(dev)
    state = opt.init(model.param_tree(), ocfg)
    losses = []
    for _ in range(steps):
        loss, state = train_step(model, a, caps, state, ocfg, group)
        losses.append(loss)
    return [float(x) for x in losses]
