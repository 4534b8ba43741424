"""How large the block-CSR of a graph is, counted without building it.

    PYTHONPATH=src python -m repro_torch.tools.block_csr_tiles

prints, for graphs with ``ogb_products``' mean degree and unclustered
(uniformly random) vertex ids at growing N, the nonzero 128 x 128 tiles
that ``build_block_csr`` would make, NB (the most any row tile has) and
the bytes of its (R, NB, bm, bn) float32 blocks; then the same counts at
``ogb_products``' full size from the expectation for uniform ids.
"""
from __future__ import annotations

import math

import numpy as np


def tile_stats(edges: np.ndarray, num_nodes: int, bm: int = 128,
               bn: int = 128, directed_both: bool = True) -> dict:
    """R, C, the nonzero tiles, NB and the bytes of ``blocks`` and
    ``cols`` that ``build_block_csr`` would give for these edges."""
    e = np.asarray(edges)
    src, dst = e[:, 0], e[:, 1]
    if directed_both:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    n_pad = -(-num_nodes // max(bm, bn)) * max(bm, bn)
    r, c = n_pad // bm, n_pad // bn
    uniq = np.unique((dst // bm).astype(np.int64) * c + src // bn)
    nb = int(np.bincount(uniq // c, minlength=r).max()) if uniq.size else 1
    return {"R": r, "C": c, "tiles": int(uniq.size), "NB": nb,
            "blocks_bytes": 4 * r * nb * bm * bn, "cols_bytes": 4 * r * nb}


def expected_tiles(num_nodes: int, num_edges: int, b: int = 128) -> float:
    """Nonzero b x b tiles of ``directed_both`` with uniform random ids:
    each of the R^2 tiles is hit by each of 2E directed edges with
    probability 1 / R^2."""
    r = math.ceil(num_nodes / b)
    return r * r * -math.expm1(-2 * num_edges / (r * r))


def main() -> None:
    n_full, e_full = 2_449_029, 61_859_140        # ogb_products
    deg = e_full / n_full
    rng = np.random.default_rng(0)
    print(f"ogb_products mean degree {2 * deg:.2f} (E/N = {deg:.4f}); "
          "uniform random ids; 128 x 128 tiles")
    for scale in range(14, 21):
        n = 1 << scale
        m = round(deg * n)
        edges = rng.integers(0, n, size=(m, 2), dtype=np.int64)
        st = tile_stats(edges, n)
        print(f"N=2^{scale} E={m}: R={st['R']} tiles={st['tiles']} "
              f"(expected {expected_tiles(n, m):.0f}) NB={st['NB']} "
              f"blocks={st['blocks_bytes']} B")
    r = math.ceil(n_full / 128)
    tiles = expected_tiles(n_full, e_full)
    per_row = tiles / r
    print(f"ogb_products N={n_full} E={e_full}: R={r}, expected tiles "
          f"{tiles:.4g} ({per_row:.0f} a row tile), nonzero tile bytes "
          f"{tiles * 4 * 128 * 128:.4g} B; padded to NB >= {per_row:.0f}: "
          f"blocks >= {r * per_row * 4 * 128 * 128:.4g} B")


if __name__ == "__main__":
    main()
