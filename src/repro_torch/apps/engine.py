"""Vertex-cut (edge-partitioned) graph engine — PowerGraph-style GAS.

Consumes an edge partition (from Distributed NE or any baseline): rank d
owns partition d's edges; every vertex has a hash-assigned *master* rank
and *mirror* replicas on each rank whose partition touches it.  One
superstep:

  scatter:  local edge messages accumulate into mirror slots,
  sync:     mirror→master all-to-all + masked segment-reduce,
  apply:    vertex program on masters,
  bcast:    master→mirror all-to-all back.

Wire bytes per superstep = 2·Σ_p |V(E_p)|·F·sizeof, i.e. replication
factor × |V| × F.  :class:`ShardedGraph` is built on the host (numpy), with
every array identical to the reference package's, leading axis = rank;
the primitives take one rank's slice of it, as tensors on that rank's
device, and exchange rows over a ``torch.distributed`` group.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist import compat
from repro_torch.io.csr import hash_u32_host


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Host-built GAS structure (leading axis = rank)."""

    num_vertices: int
    num_devices: int
    edges_ml: np.ndarray       # (D, C, 2) int32 mirror-local endpoints
    emask: np.ndarray          # (D, C) bool
    mirror_glob: np.ndarray    # (D, R) int32 global id of each mirror slot
    mirror_mask: np.ndarray    # (D, R) bool
    send_idx: np.ndarray       # (D, D, L) int32 mirror-local → target master
    send_mask: np.ndarray      # (D, D, L) bool
    recv_owned: np.ndarray     # (D, D, L) int32 owned-local of received slot
    owned_glob: np.ndarray     # (D, O) int32
    owned_mask: np.ndarray     # (D, O) bool
    comm_slots: int            # Σ actual mirror slots (= Σ_p |V(E_p)|)

    @property
    def caps(self):
        return dict(C=self.edges_ml.shape[1], R=self.mirror_glob.shape[1],
                    L=self.send_idx.shape[2], O=self.owned_glob.shape[1])


def build_sharded_graph(edges: np.ndarray, edge_part: np.ndarray,
                        num_vertices: int, num_devices: int) -> ShardedGraph:
    edges = np.asarray(edges)
    edge_part = np.asarray(edge_part)
    d_num = num_devices
    master = hash_u32_host(np.arange(num_vertices)) % d_num

    globs, sends, per_dev_edges, comm_slots = [], [], [], 0
    for d in range(d_num):
        e = edges[edge_part == d]
        # the sorted distinct endpoints and each endpoint's index among
        # them (the reference's np.unique and searchsorted) from a
        # presence table over the N ids: no sort of the 2|E_p| endpoints
        present = np.zeros(num_vertices, bool)
        present[e.ravel()] = True
        glob = np.flatnonzero(present)
        comm_slots += glob.size
        ml = (np.cumsum(present) - 1)[e]
        per_dev_edges.append(ml)
        globs.append(glob)
        sends.append([np.nonzero(master[glob] == t)[0] for t in range(d_num)])
    owned_sets = [[] for _ in range(d_num)]
    for d in range(d_num):
        for t in range(d_num):
            owned_sets[t].append(globs[d][sends[d][t]])
    owned = [np.unique(np.concatenate(s)) if s and sum(x.size for x in s)
             else np.zeros((0,), np.int64) for s in owned_sets]

    cap_c = max(1, max(e.shape[0] for e in per_dev_edges))
    cap_r = max(1, max(g.size for g in globs))
    cap_l = max(1, max(sends[d][t].size for d in range(d_num)
                       for t in range(d_num)))
    cap_o = max(1, max(o.size for o in owned))

    edges_ml = np.zeros((d_num, cap_c, 2), np.int32)
    emask = np.zeros((d_num, cap_c), bool)
    mirror_glob = np.zeros((d_num, cap_r), np.int32)
    mirror_mask = np.zeros((d_num, cap_r), bool)
    send_idx = np.zeros((d_num, d_num, cap_l), np.int32)
    send_mask = np.zeros((d_num, d_num, cap_l), bool)
    recv_owned = np.zeros((d_num, d_num, cap_l), np.int32)
    owned_glob = np.zeros((d_num, cap_o), np.int32)
    owned_mask = np.zeros((d_num, cap_o), bool)

    for d in range(d_num):
        ne, ng, no = per_dev_edges[d].shape[0], globs[d].size, owned[d].size
        edges_ml[d, :ne] = per_dev_edges[d]
        emask[d, :ne] = True
        mirror_glob[d, :ng] = globs[d]
        mirror_mask[d, :ng] = True
        owned_glob[d, :no] = owned[d]
        owned_mask[d, :no] = True
        for t in range(d_num):
            s = sends[d][t]
            send_idx[d, t, : s.size] = s
            send_mask[d, t, : s.size] = True
            # rank t receives globs[d][s] from d, in this order
            recv_owned[t, d, : s.size] = np.searchsorted(owned[t],
                                                         globs[d][s])
    return ShardedGraph(num_vertices, d_num, edges_ml, emask, mirror_glob,
                        mirror_mask, send_idx, send_mask, recv_owned,
                        owned_glob, owned_mask, comm_slots)


# ---------------------------------------------------------------------------
# Per-rank primitives: each takes this rank's (unbatched) tensors.
# ---------------------------------------------------------------------------

def _reduce_into(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 op: str) -> torch.Tensor:
    """``out[idx[i]] (op)= vals[i]`` for every row i (sum, min or max)."""
    if op == "sum":
        return out.index_add(0, idx, vals)
    if op in ("min", "max"):
        return out.scatter_reduce(
            0, idx[:, None].expand_as(vals), vals, reduce="a" + op)
    raise ValueError(op)


def mirror_to_master(vals, send_idx, send_mask, recv_owned, num_owned,
                     op: str = "sum", identity=0.0, group=None):
    """(R, F) mirror values → (O, F) master reduction across ranks."""
    f = vals.shape[-1]
    buf = vals[send_idx.long()]                            # (D, L, F)
    # padded send slots carry the reduction identity: they land on
    # recv_owned = 0 and contribute nothing
    buf = torch.where(send_mask[..., None], buf, identity)
    got = compat.all_to_all_rows(buf.reshape(-1, f), group)  # (D·L, F)
    out = torch.full((num_owned, f), identity, dtype=vals.dtype,
                     device=vals.device)
    return _reduce_into(out, recv_owned.reshape(-1).long(), got, op)


def master_to_mirror(owned_vals, send_idx, send_mask, recv_owned,
                     num_mirrors, group=None):
    """(O, F) master values → (R, F) mirror copies across ranks."""
    f = owned_vals.shape[-1]
    buf = owned_vals[recv_owned.reshape(-1).long()]        # (D·L, F)
    got = compat.all_to_all_rows(buf, group)
    idx = torch.where(send_mask, send_idx,
                      torch.full_like(send_idx, num_mirrors)).reshape(-1)
    out = torch.zeros((num_mirrors + 1, f), dtype=owned_vals.dtype,
                      device=owned_vals.device)
    # the unmasked slots of a rank's send lists are distinct mirrors, so
    # the scatter sets each mirror once; padded slots land on row R
    out = out.index_put((idx.long(),), got)
    return out[:num_mirrors]


def scatter_edges(edge_vals_to_dst, edge_vals_to_src, edges_ml, emask,
                  num_mirrors, op: str = "sum", identity=0.0):
    """Per-edge messages → (R, F) mirror accumulators (both directions)."""
    f = edge_vals_to_dst.shape[-1]
    acc = torch.full((num_mirrors + 1, f), identity,
                     dtype=edge_vals_to_dst.dtype,
                     device=edge_vals_to_dst.device)
    pad = torch.full_like(edges_ml[:, 0], num_mirrors)
    src = torch.where(emask, edges_ml[:, 0], pad).long()
    dst = torch.where(emask, edges_ml[:, 1], pad).long()
    acc = _reduce_into(acc, dst, edge_vals_to_dst, op)
    acc = _reduce_into(acc, src, edge_vals_to_src, op)
    return acc[:num_mirrors]
