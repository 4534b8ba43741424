"""Plain PyTorch versions of the block-sparse SpMM.

:func:`spmm_ref` is the system's own GNN aggregation primitive over an
edge list; :func:`block_spmm_ref` is the kernel's function on its own
inputs (the block-CSR), padded slots included.
"""
from __future__ import annotations

import numpy as np
import torch


def spmm_ref(edges: np.ndarray, x: torch.Tensor, num_nodes: int,
             directed_both: bool = True) -> torch.Tensor:
    """out[v] = Σ_{(u,v)∈E} x[u] with ``index_add_`` (in both directions
    of each edge when ``directed_both``)."""
    e = torch.from_numpy(np.array(edges, dtype=np.int64)).to(x.device)
    if directed_both:
        src = torch.cat([e[:, 0], e[:, 1]])
        dst = torch.cat([e[:, 1], e[:, 0]])
    else:
        src, dst = e[:, 0], e[:, 1]
    out = torch.zeros((num_nodes,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, dst, x[src])


def block_spmm_ref(cols: torch.Tensor, blocks: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """out = A @ x for block-CSR A: gathers the (bn, F) column block of
    ``x`` of every slot and sums the slots' (bm, bn) @ (bn, F) products of
    a row tile in float32.  cols (R, NB) int32, blocks (R, NB, bm, bn),
    x (C·bn, F); returns (R·bm, F)."""
    r, nb, bm, bn = blocks.shape
    xb = x.reshape(-1, bn, x.shape[-1])[cols.long()]        # (R, NB, bn, F)
    out = torch.einsum("rjab,rjbf->raf", blocks.float(), xb.float())
    return out.reshape(r * bm, x.shape[-1]).to(x.dtype)
