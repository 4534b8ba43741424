"""Plain PyTorch versions of the NE-round kernels.

Each function computes exactly what its CUDA kernel in
``csrc/ne_round.cu`` computes, in torch ops, bit for bit (all-integer math
apart from the float32 ``ceil(lam * |B|)``).  The front door in ``ops.py``
runs these for tensors on the CPU; the tests hold them against the
reference package, and ``chip_smoke.py`` holds the kernels against them
on the card.  ``_enc`` is the claim priority rule; the partitioner uses
it as ``core.partitioner.priority_enc``.  ``pack_bits_np`` and
``unpack_bits_np`` are numpy twins of the bit packing for host arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as trandom

I32_INF = 2**31 - 1
_LOW32 = 0xFFFFFFFF
# rows of the plain selection at a time: bounds its (rows, N) threefry
# and key intermediates, as the reference's default selection chunk does
REF_ROWS = 8


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


def boundary_reseed(degree_rest, keys_c):
    """Random re-seed draw for empty boundaries (paper Alg. 1 line 6).

    Returns ``(rnd_v, any_ok)``: (C,) random vertices with unallocated
    edges, drawn from the (C, 2) keys exactly as the reference draws them
    (the argmax of JAX's uniform bits over D_rest > 0, ties to the lowest
    index), and the () any-rest flag.
    """
    any_rest = degree_rest > 0
    gumb = trandom.uniform(keys_c, (degree_rest.shape[0],))
    gumb = torch.where(any_rest[None, :], gumb,
                       torch.full_like(gumb, -1.0))
    return torch.argmax(gumb, dim=1), any_rest.any()


def select_chunk_ref(vparts_c, active_c, degree_rest, lam: float,
                     k_sel: int, keys_c, remaining_c):
    """Selection of C rows with the restart draw: :func:`boundary_reseed`
    from the rows' (C, 2) keys, then :func:`select_ref`, ``REF_ROWS`` rows
    at a time (rows are independent).  Returns ``(idx, valid)`` of shape
    (C, k_sel)."""
    idx, valid = [], []
    for j in range(0, vparts_c.shape[0], REF_ROWS):
        rows = slice(j, j + REF_ROWS)
        rnd_v, any_ok = boundary_reseed(degree_rest, keys_c[rows])
        i, v = select_ref(vparts_c[rows], active_c[rows], degree_rest, lam,
                          k_sel, remaining_c[rows], rnd_v, any_ok)
        idx.append(i)
        valid.append(v)
    return torch.cat(idx), torch.cat(valid)


def claim_scatter_ref(sel_idx, sel_valid, edges_per_part,
                      num_vertices: int, num_partitions: int):
    """``vclaim[v] = min over claiming partitions of enc(|E_p|, p)``,
    ``I32_INF`` where nobody claimed ``v``; invalid slots and slots whose
    vertex lies outside [0, N) are dropped (the reference drops v >= N
    and wraps v < 0; ``select`` gives neither)."""
    rows = torch.arange(sel_idx.shape[0], dtype=torch.int32,
                        device=sel_idx.device)[:, None].expand_as(sel_idx)
    keys = _enc(edges_per_part[:, None], rows, num_partitions)
    keep = sel_valid & (sel_idx >= 0) & (sel_idx < num_vertices)
    flat_v = torch.where(keep, sel_idx,
                         torch.full_like(sel_idx, num_vertices)).reshape(-1)
    vclaim = torch.full((num_vertices + 1,), I32_INF, dtype=torch.int32,
                        device=sel_idx.device)
    vclaim.scatter_reduce_(0, flat_v.long(), keys.reshape(-1), reduce="amin")
    return vclaim[:num_vertices]


# ---------------------------------------------------------------------------
# bit-packed replica sets: partition p is bit p % 32 of word p // 32,
# LSB-first, pad bits 0.  A word is the int32 bit pattern of the
# reference's uint32 word (torch uint32 lacks basic ops).
# ---------------------------------------------------------------------------

def replica_words(num_partitions: int) -> int:
    """Words per vertex of the packed replica set: ``ceil(P / 32)``."""
    return (num_partitions + 31) // 32


def pack_bits_ref(bools):
    """(N, P) bool → (N, ceil(P/32)) int32 words.  The word is summed in
    int64 (an int32 sum would overflow at bit 31) and narrowed to its
    int32 bit pattern."""
    n, p = bools.shape
    w = replica_words(p)
    bp = torch.nn.functional.pad(bools, (0, w * 32 - p)).reshape(n, w, 32)
    bits = torch.arange(32, dtype=torch.int64, device=bools.device)
    word = (bp.to(torch.int64) << bits).sum(dim=-1)
    return torch.where(word > I32_INF, word - (1 << 32), word).to(torch.int32)


def unpack_bits_ref(words, num_partitions: int):
    """(N, W) int32 words → (N, P) bool, contiguous: the inverse of
    :func:`pack_bits_ref`.  ``>>`` on int32 is arithmetic, hence ``& 1``."""
    n, w = words.shape
    bits = torch.arange(32, dtype=torch.int32, device=words.device)
    b = (words[:, :, None] >> bits) & 1
    return b.reshape(n, w * 32)[:, :num_partitions].to(torch.bool).contiguous()


def two_hop_best_ref(vparts, uu, vv, un, enc_vec, num_partitions: int):
    """Condition (5) candidate key of each edge of a two-hop chunk: the
    minimum of ``enc_vec[p]`` over the partitions p in replicas(u) &
    replicas(v) of an unallocated edge (``un``), ``I32_INF`` otherwise.
    ``vparts`` is the (N, P) bool map or the (N, W) int32 packed words;
    returns (ce,) int32."""
    inter = vparts[uu.long()] & vparts[vv.long()]
    if vparts.dtype == torch.int32:
        inter = unpack_bits_ref(inter, num_partitions)
    inf = torch.tensor(I32_INF, dtype=torch.int32, device=enc_vec.device)
    return torch.where(inter & un[:, None], enc_vec[None, :], inf).amin(dim=1)


def or_words_ref(a, b):
    """Element-wise OR-merge of two packed replica maps."""
    return a | b


# numpy twins for the host side of a run (the words come back from the
# device as int32); same bit layout as the reference's ``pack_bits_np``
def pack_bits_np(bools: np.ndarray) -> np.ndarray:
    """(N, P) bool → (N, ceil(P/32)) int32 words."""
    n, p = bools.shape
    w = replica_words(p)
    bp = np.zeros((n, w * 32), np.uint32)
    bp[:, :p] = bools
    return (bp.reshape(n, w, 32)
            << np.arange(32, dtype=np.uint32)[None, None, :]).sum(
        axis=-1, dtype=np.uint32).view(np.int32)


def unpack_bits_np(words: np.ndarray, num_partitions: int) -> np.ndarray:
    """(N, W) int32 (or uint32) words → (N, P) bool."""
    words = np.ascontiguousarray(words)
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    n, w = words.shape
    bits = np.arange(32, dtype=np.uint32)
    b = (words[:, :, None] >> bits[None, None, :]) & np.uint32(1)
    return b.reshape(n, w * 32)[:, :num_partitions].astype(bool)
