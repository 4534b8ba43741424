"""Plain PyTorch versions of the NE-round kernels.

Each function computes exactly what its CUDA kernel in
``csrc/ne_round.cu`` computes, in torch ops, bit for bit (all-integer math
apart from the float32 ``ceil(lam * |B|)``).  The front door in ``ops.py``
runs these for tensors on the CPU; the tests hold them against the
reference package, and ``chip_smoke.py`` holds the kernels against them
on the card.  ``_enc`` is the claim priority rule; the partitioner uses
it as ``core.partitioner.priority_enc``.
"""
from __future__ import annotations

import torch

I32_INF = 2**31 - 1
_LOW32 = 0xFFFFFFFF


def _enc(count, p, num_partitions: int):
    """Priority key: smaller edge count wins, then smaller partition id."""
    cap = (I32_INF - num_partitions) // num_partitions - 1
    return torch.clamp(count, max=cap) * num_partitions + p


def one_hop_ref(vclaim, u, v, edge_part, num_partitions: int, mask=None):
    """Per edge ``k = min(vclaim[u], vclaim[v])``; an unallocated edge
    joins partition ``k % P`` when some endpoint was claimed.  Returns
    ``(part, counts)``: (M,) int32 with ``-1`` for untouched edges and the
    (P,) int32 histogram of new allocations."""
    k_uv = torch.minimum(vclaim[u.long()], vclaim[v.long()])
    new = (edge_part < 0) & (k_uv < I32_INF)
    if mask is not None:
        new &= mask
    part = torch.where(new, k_uv % num_partitions,
                       torch.full_like(k_uv, -1))
    counts = torch.zeros(num_partitions, dtype=torch.int32,
                         device=vclaim.device)
    counts.index_add_(0, part.clamp(min=0).long(), new.to(torch.int32))
    return part, counts


def select_ref(vparts_c, active_c, degree_rest, lam: float, k_sel: int,
               remaining_c, rnd_v, any_ok):
    """Boundary selection for one (C, N) chunk of partitions, with the
    restart draw made outside (``rnd_v`` (C,) restart vertices, ``any_ok``
    the () flag ``(degree_rest > 0).any()``).  Returns ``(idx, valid)`` of
    shape (C, k_sel), int32 and bool.

    The top-k runs on the composite int64 key ``(score << 32) | index``,
    which is unique, so ties go to the lowest index as in the reference.
    """
    dev = degree_rest.device
    bnd = vparts_c & (degree_rest > 0)[None, :] & active_c[:, None]
    bsize = bnd.sum(dim=1, dtype=torch.int32)
    lam32 = torch.tensor(lam, dtype=torch.float32, device=dev)
    k_eff = torch.ceil(lam32 * bsize.to(torch.float32)).to(torch.int32)
    k_eff = k_eff.clamp(1, k_sel)
    scores = torch.where(bnd, degree_rest[None, :],
                         torch.full_like(degree_rest, I32_INF)[None, :])
    n = degree_rest.shape[0]
    vid = torch.arange(n, dtype=torch.int64, device=dev)
    comp = (scores.to(torch.int64) << 32) | vid[None, :]
    top = torch.topk(comp, k_sel, dim=1, largest=False, sorted=True).values
    score = (top >> 32).to(torch.int32)
    idx = (top & _LOW32).to(torch.int32)
    col = torch.arange(k_sel, device=dev)[None, :]
    valid = (score < I32_INF) & (col < k_eff[:, None])
    cost = torch.where(valid, score, torch.zeros_like(score))
    fits = torch.cumsum(cost, dim=1, dtype=torch.int32) <= remaining_c[:, None]
    valid &= fits | (col == 0)
    restart = (bsize == 0) & active_c & any_ok
    idx[:, 0] = torch.where(restart, rnd_v.to(torch.int32), idx[:, 0])
    valid[:, 0] = valid[:, 0] | restart
    valid &= active_c[:, None]
    return idx, valid


def claim_scatter_ref(sel_idx, sel_valid, edges_per_part,
                      num_vertices: int, num_partitions: int):
    """``vclaim[v] = min over claiming partitions of enc(|E_p|, p)``,
    ``I32_INF`` where nobody claimed ``v``; invalid slots are dropped."""
    rows = torch.arange(sel_idx.shape[0], dtype=torch.int32,
                        device=sel_idx.device)[:, None].expand_as(sel_idx)
    keys = _enc(edges_per_part[:, None], rows, num_partitions)
    flat_v = torch.where(sel_valid, sel_idx,
                         torch.full_like(sel_idx, num_vertices)).reshape(-1)
    vclaim = torch.full((num_vertices + 1,), I32_INF, dtype=torch.int32,
                        device=sel_idx.device)
    vclaim.scatter_reduce_(0, flat_v.long(), keys.reshape(-1), reduce="amin")
    return vclaim[:num_vertices]
