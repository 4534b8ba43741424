"""Plain PyTorch versions of the two streaming scans: a per-edge loop of
torch ops on the edges' device, with the kernels' float32 steps.

Each step depends on the one before, so this is slow (a few dozen small
ops and one host read of the chosen partition an edge); it is the
yardstick the kernels are held to, bit for bit.
"""
from __future__ import annotations

import torch


def hdrf_scan_ref(edges: torch.Tensor, p: int, n: int,
                  lam: float) -> torch.Tensor:
    """(M,) int32 HDRF partitions of the edge stream ``edges`` (M, 2), in
    order: per edge the partial degrees, then the float32 score
    ``(g_u + g_v) + lam * c_bal`` with ``g_u = 2 - theta_u`` and
    ``g_v = 2 - (1 - theta_u)`` where the endpoint is already in the
    partition (XLA folds the reference's ``1 + (1 - theta)`` so), and the
    first maximum."""
    dev = edges.device
    f32 = torch.float32
    pdeg = torch.zeros(n, dtype=torch.int64, device=dev)
    vpart = torch.zeros((n, p), dtype=torch.bool, device=dev)
    sizes = torch.zeros(p, dtype=torch.int64, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    two = torch.full((), 2.0, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    lam32 = torch.full((), lam, dtype=f32, device=dev)
    out = []
    for u, v in edges.tolist():
        pdeg[u] += 1
        pdeg[v] += 1
        du, dv = pdeg[u], pdeg[v]
        tu = du.to(f32) / (du + dv).to(f32)
        g_u = torch.where(vpart[u], two - tu, zero)
        g_v = torch.where(vpart[v], two - (one - tu), zero)
        mins, maxs = torch.aminmax(sizes)
        spread = (maxs - mins).to(f32)
        c_bal = torch.where(spread > 0,
                            (maxs - sizes).to(f32) / spread.clamp(min=1.0),
                            one)
        tgt = int(torch.argmax((g_u + g_v) + lam32 * c_bal))
        out.append(tgt)
        vpart[u, tgt] = True
        vpart[v, tgt] = True
        sizes[tgt] += 1
    return torch.tensor(out, dtype=torch.int32, device=dev)


def oblivious_scan_ref(edges: torch.Tensor, p: int, n: int,
                       limit: int) -> torch.Tensor:
    """(M,) int32 Oblivious partitions of the edge stream ``edges``: among
    the partitions with room the first of least |E_p| holding both
    endpoints, else one, else any; with no room anywhere, the first of
    least |E_p|.  |E_p| is compared as float32."""
    dev = edges.device
    vpart = torch.zeros((n, p), dtype=torch.bool, device=dev)
    sizes = torch.zeros(p, dtype=torch.int64, device=dev)
    ninf = torch.full((p,), float("-inf"), device=dev)
    every = torch.ones(p, dtype=torch.bool, device=dev)
    out = []
    for u, v in edges.tolist():
        room = sizes < limit
        in_u, in_v = vpart[u] & room, vpart[v] & room
        both, either = in_u & in_v, in_u | in_v
        cand = torch.where(both.any(), both,
                           torch.where(either.any(), either, room))
        cand = torch.where(room.any(), cand, every)
        tgt = int(torch.argmax(torch.where(cand, -sizes.to(torch.float32),
                                           ninf)))
        out.append(tgt)
        vpart[u, tgt] = True
        vpart[v, tgt] = True
        sizes[tgt] += 1
    return torch.tensor(out, dtype=torch.int32, device=dev)
