"""Real spherical-harmonic rotation matrices via the Ivanic–Ruedenberg
recursion (J. Phys. Chem. 1996, with the published errata).

Builds D^l (2l+1 × 2l+1) for l = 0..l_max directly from a batch of 3×3
rotation matrices: no Euler angles, no precomputed e3nn constants.
Real-SH m-ordering is (-l..l); the l=1 block equals the cartesian
rotation in the (y, z, x) basis.  Each entry takes the reference
package's products and sums, but a whole block is built in a few dozen
tensor operations instead of a few per entry.

Used by EquiformerV2's eSCN convolution: rotate features into the edge
frame (edge direction → +z), do SO(2)-restricted mixing over |m| ≤ m_max,
rotate back.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def rotation_to_edge_frame(r_hat: torch.Tensor) -> torch.Tensor:
    """Batch of unit vectors (E,3) → rotations (E,3,3) with R @ r_hat = +z."""
    e = r_hat
    eye = torch.eye(3, dtype=e.dtype, device=e.device)   # no host copy
    ref = torch.where(torch.abs(e[..., 0:1]) < 0.9, eye[0], eye[1])
    x = ref - (ref * e).sum(-1, keepdim=True) * e
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(e, x, dim=-1)
    return torch.stack([x, y, e], dim=-2)   # rows = image axes: R @ e = z


def _sh1_from_rot(rot: torch.Tensor) -> torch.Tensor:
    """l=1 real-SH block (m=-1,0,1 ↔ y,z,x):  D¹_{ij} = R_{p(i),p(j)}
    with p = (1, 2, 0), a cyclic shift of both axes."""
    return torch.roll(rot, shifts=(-1, -1), dims=(-2, -1))


@lru_cache(maxsize=32)
def _coefficients(l: int, device: torch.device):
    """The recursion's (2l+1, 2l+1) float32 weights u, v, w of D^l[m, m']
    and the (l, 1) factors of its V terms for m > 0 and m < 0, on
    ``device``, made once (a copy from host memory waits for the
    device)."""
    ms = np.arange(-l, l + 1)
    m, mp = ms[:, None], ms[None, :]
    denom = np.where(np.abs(mp) < l, (l + mp) * (l - mp),
                     (2 * l) * (2 * l - 1)).astype(np.float64)
    am = np.abs(m)
    u = np.sqrt((l + m) * (l - m) / denom)
    v = (0.5 * np.sqrt((1.0 + (m == 0)) * (l + am - 1) * (l + am) / denom)
         * (1 - 2 * (m == 0)))
    w = -0.5 * np.sqrt(np.maximum((l - am - 1) * (l - am), 0) / denom) \
        * (1 - (m == 0))
    pos = np.arange(1, l + 1)[:, None]            # m = 1..l
    neg = -np.arange(l, 0, -1)[:, None]           # m = -l..-1
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (u, v, w, np.sqrt(1.0 + (pos == 1)), 1.0 - (pos == 1),
                           1.0 - (neg == -1), np.sqrt(1.0 + (neg == -1))))


def _next_block(r1: torch.Tensor, prev: torch.Tensor, l: int) -> torch.Tensor:
    """D^l from D^1 and D^(l-1), all (m, m') entries at once.

    ``p[:, i + 1, a + l - 1, m' + l]`` is the recursion's P(i, a, m') for
    i in (-1, 0, 1), a in [-(l-1), l-1], m' in [-l, l]; then each entry
    is u·P(0, m) + v·V(m) + w·W(m) with the same products and sums as the
    entry-by-entry form (a zero weight's term adds an exact 0)."""
    c = prev[:, None]                                   # (E, 1, 2l-1, 2l-1)
    ri = [r1[:, :, k, None, None] for k in range(3)]    # (E, 3, 1, 1)
    first, last = c[..., :1], c[..., 2 * l - 2:]
    p = torch.cat([ri[2] * first + ri[0] * last,        # m' = -l
                   ri[1] * c,                           # |m'| < l
                   ri[2] * last - ri[0] * first],       # m' = l
                  dim=-1)                               # (E, 3, 2l-1, 2l+1)
    pm1, p0, pp1 = p[:, 0], p[:, 1], p[:, 2]            # i = -1, 0, 1
    u, v, w, cp1, cp2, cn1, cn2 = _coefficients(l, prev.device)
    zero = torch.zeros_like(p0[:, :1])
    rev = pm1.flip(1)                  # rev[:, k] = P(-1, l - 1 - k, ·)
    # V: m < 0, m = 0, m > 0
    vv = torch.cat([
        pp1[:, :l] * cn1 + rev[:, :l] * cn2,
        pp1[:, l:l + 1] + pm1[:, l - 2:l - 1],
        pp1[:, l - 1:] * cp1 - rev[:, l - 1:] * cp2], dim=1)
    # W: nonzero only where 0 < |m| <= l - 2
    mid = [pp1[:, :l - 2] - rev[:, :l - 2], zero,
           pp1[:, l + 1:] + rev[:, l + 1:]] if l > 2 else [zero]
    ww = torch.cat([zero, zero] + mid + [zero, zero], dim=1)
    p0 = torch.cat([zero, p0, zero], dim=1)
    return (u * p0 + v * vv) + w * ww


def wigner_d_blocks(rot: torch.Tensor, l_max: int) -> list[torch.Tensor]:
    """Rotation matrices (E, 3, 3) → [D^0, D^1, …, D^l_max]."""
    blocks = [torch.ones(rot.shape[:-2] + (1, 1), dtype=rot.dtype,
                         device=rot.device)]
    if l_max == 0:
        return blocks
    r1 = _sh1_from_rot(rot)                # index offset +1: r1[m+1, m'+1]
    blocks.append(r1)
    for l in range(2, l_max + 1):
        blocks.append(_next_block(r1, blocks[l - 1], l))
    return blocks


@lru_cache(maxsize=8)
def sh_offsets(l_max: int) -> tuple[tuple[int, int], ...]:
    """(start, dim) per l in the flattened (l_max+1)² coefficient layout."""
    out, s = [], 0
    for l in range(l_max + 1):
        out.append((s, 2 * l + 1))
        s += 2 * l + 1
    return tuple(out)


def apply_blocks(blocks: list[torch.Tensor], feats: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
    """Block-diagonal apply: feats (..., K, C) with K = (l_max+1)²."""
    offs = sh_offsets(len(blocks) - 1)
    outs = []
    for l, (s, d) in enumerate(offs):
        b = blocks[l].transpose(-1, -2) if transpose else blocks[l]
        outs.append(b @ feats[..., s:s + d, :])
    return torch.cat(outs, dim=-2)
