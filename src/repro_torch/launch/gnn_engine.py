"""Engine-based full-graph GIN training (vertex-cut, NE-partitioned).

Rank d owns partition d's edges (mirror-local indices) and runs, every
layer,

  master→mirror broadcast (all-to-all) → mirror aggregation A_local @ h_m
  (the block-sparse SpMM kernel) → mirror→master reduce (all-to-all) →
  apply (the layer's MLP on masters).

A_local is the rank's mirror-local adjacency in both directions, as a
block-CSR built once on the host: ``scatter_edges(h_m[src], h_m[dst])``
of the reference is exactly that product.  Gradients flow back through
the same kernel (A_local is symmetric) and through the reverse
all-to-alls; the ranks then sum their parameter gradients.

Each rank holds only its own slice of the engine arrays, on its own
device; the ranks form a ``torch.distributed`` group (a world-1 group on
one card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.apps import engine as eng
from repro_torch.core.graph import resolve_device
from repro_torch.dist import compat
from repro_torch.kernels.block_spmm import ops as spmm
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_map

BLOCK = 128      # bm = bn of the mirror block-CSR


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


def caps_from_sharded_graph(sg: eng.ShardedGraph, d_feat: int,
                            n_classes: int) -> EngineCaps:
    c = sg.caps
    return EngineCaps(n_dev=sg.num_devices, n_vertices=sg.num_vertices,
                      c_edges=c["C"], r_mirrors=c["R"], o_owned=c["O"],
                      l_lane=c["L"], feat=d_feat, n_classes=n_classes)


def engine_arrays(sg: eng.ShardedGraph, feats: np.ndarray,
                  labels: np.ndarray, label_mask: np.ndarray, rank: int,
                  device) -> dict:
    """Rank ``rank``'s engine arrays as tensors on ``device``: its slice
    of the ShardedGraph, its masters' features, labels and label mask,
    and its mirror block-CSR (``cols``, ``blocks``) over R mirrors padded
    to a multiple of :data:`BLOCK`, with ``symmetric``, the block-CSR's
    record that its gradient may reuse it (a bool, not a tensor)."""
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
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in out.items()}
    arrays["symmetric"] = csr.symmetric
    return arrays


def _bcast(x_o, a, caps, group):
    return eng.master_to_mirror(x_o, a["send_idx"], a["send_mask"],
                                a["recv_owned"], caps.r_mirrors, group)


def _reduce(x_m, a, caps, group):
    return eng.mirror_to_master(x_m, a["send_idx"], a["send_mask"],
                                a["recv_owned"], caps.o_owned, "sum", 0.0,
                                group)


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


def engine_loss(model, a, caps: EngineCaps, group=None):
    """Masked cross-entropy over every rank's masters, the same scalar on
    every rank: Σ_ranks loss_sum / max(Σ_ranks count, 1)."""
    logits = gin_forward(model, a, caps, group).float()
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
    loss, summed over the ranks (the same on every rank)."""
    model.zero_grad(set_to_none=True)
    loss = engine_loss(model, a, caps, group)
    loss.backward()
    for p in model.parameters():
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
