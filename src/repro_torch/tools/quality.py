"""The fast quality matrix of ``benchmarks/bench_quality.py`` on the port.

    PYTHONPATH=src python -m repro_torch.tools.quality [--device cpu]

runs its 32 rows — two graphs (RMAT scale 14 with edge factor 16, and
the bundled power-law ``real`` graph dumped as SNAP text and ingested) ×
P ∈ {4, 16} × Distributed NE, the hybrid at τ = 0.5 and 0.25, and the
five baselines — and prints each row's RF, EB and VB beside
:data:`EXPECTED`, exiting non-zero on any difference.  Values compare as
``bench_quality`` records them, to 6 significant digits
(``benchmarks/common.py::fmt_metrics``).

:data:`EXPECTED` is ``BENCH_QUALITY.json``'s value for 24 rows.  The 8
rows of :data:`STALE` no longer come out of the reference package itself:
under jax 0.9.0 the reference gives the value in :data:`EXPECTED`, and
the JSON (written at commit 92a9bbe, no file of the reference changed
since) holds the value in :data:`STALE`.  Only runs that draw random
restarts differ, so the likeliest cause is an older jax's random bits.
The port is held to the reference as it runs now.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

PARTS = (4, 16)
HYBRID_BUDGETS = (0.5, 0.25)
METHODS = ("ne", "hybrid_t50", "hybrid_t25", "random", "grid", "dbh",
           "hdrf", "oblivious")
GRAPHS = ("rmat_s14_ef16", "real")

# (rf, eb, vb) of each row, as bench_quality records them
EXPECTED = {
    "quality_rmat_s14_ef16_p4_ne": (1.17389, 1.08619, 1.45562),
    "quality_rmat_s14_ef16_p4_hybrid_t50": (1.19897, 1.10002, 1.41478),
    "quality_rmat_s14_ef16_p4_hybrid_t25": (1.21765, 1.00062, 1.04742),
    "quality_rmat_s14_ef16_p4_random": (2.24585, 1.00606, 1.01109),
    "quality_rmat_s14_ef16_p4_grid": (1.69971, 1.02567, 1.00934),
    "quality_rmat_s14_ef16_p4_dbh": (1.3717, 1.02493, 1.02661),
    "quality_rmat_s14_ef16_p4_hdrf": (1.32959, 1.00001, 1.03985),
    "quality_rmat_s14_ef16_p4_oblivious": (1.37903, 1.00001, 1.01124),
    "quality_rmat_s14_ef16_p16_ne": (1.93335, 1.10003, 1.54717),
    "quality_rmat_s14_ef16_p16_hybrid_t50": (2.02722, 1.10003, 1.28524),
    "quality_rmat_s14_ef16_p16_hybrid_t25": (2.13153, 1.09282, 1.05695),
    "quality_rmat_s14_ef16_p16_random": (5.5188, 1.01335, 1.01659),
    "quality_rmat_s14_ef16_p16_grid": (3.04449, 1.08666, 1.03959),
    "quality_rmat_s14_ef16_p16_dbh": (2.62036, 1.0911, 1.03308),
    "quality_rmat_s14_ef16_p16_hdrf": (2.24695, 1.00005, 1.0822),
    "quality_rmat_s14_ef16_p16_oblivious": (2.39404, 1.00013, 1.02672),
    "quality_real_p4_ne": (1.0717, 1.10004, 1.45302),
    "quality_real_p4_hybrid_t50": (1.08887, 1.02852, 1.05443),
    "quality_real_p4_hybrid_t25": (1.30473, 1.02342, 1.06832),
    "quality_real_p4_random": (1.54127, 1.01227, 1.01164),
    "quality_real_p4_grid": (1.355, 1.08074, 1.05417),
    "quality_real_p4_dbh": (1.30207, 1.013, 1.02002),
    "quality_real_p4_hdrf": (1.15347, 1.00004, 1.01838),
    "quality_real_p4_oblivious": (1.1668, 1.00004, 1.01097),
    "quality_real_p16_ne": (1.30227, 1.1747, 1.23354),
    "quality_real_p16_hybrid_t50": (1.25817, 1.11847, 1.14919),
    "quality_real_p16_hybrid_t25": (1.5855, 1.13158, 1.16119),
    "quality_real_p16_random": (2.10317, 1.03019, 1.0288),
    "quality_real_p16_grid": (1.68537, 1.30405, 1.17814),
    "quality_real_p16_dbh": (1.60803, 1.08933, 1.03215),
    "quality_real_p16_hdrf": (1.29687, 1.00076, 1.05238),
    "quality_real_p16_oblivious": (1.36493, 1.00047, 1.0339),
}

# the rows whose BENCH_QUALITY.json value the reference no longer gives:
# the JSON's (rf, eb, vb); EXPECTED has the reference's present value
STALE_REASON = ("the reference package gives another value under jax "
                "0.9.0 than BENCH_QUALITY.json (commit 92a9bbe) holds; "
                "only runs that draw random restarts differ")
STALE = {
    "quality_rmat_s14_ef16_p4_ne": (1.13782, 1.10002, 1.51443),
    "quality_rmat_s14_ef16_p16_ne": (1.9223, 1.10003, 1.58044),
    "quality_real_p4_ne": (1.06427, 1.10783, 1.22902),
    "quality_real_p16_ne": (1.28343, 1.10011, 1.2853),
    "quality_real_p4_hybrid_t50": (1.08887, 1.0283, 1.05394),
    "quality_real_p4_hybrid_t25": (1.3048, 1.02364, 1.06847),
    "quality_real_p16_hybrid_t50": (1.25827, 1.11847, 1.14909),
    "quality_real_p16_hybrid_t25": (1.58547, 1.13216, 1.16121),
}


def row_name(graph: str, p: int, method: str) -> str:
    return f"quality_{graph}_p{p}_{method}"


def fmt6(x: float) -> float:
    """A metric as ``fmt_metrics`` records it: 6 significant digits."""
    return float(f"{float(x):.6g}")


def rmat_graph(device=None):
    """The matrix's RMAT graph: scale 14, edge factor 16, seed 1."""
    from repro_torch.graphs.rmat import rmat

    return rmat(14, 16, seed=1, device=device)


def real_graph(workdir: str, device=None):
    """The bundled ``real`` graph as ``bench_quality._real_graph`` makes it
    without ``$REPRO_REAL_GRAPH``: a power-law configuration graph
    (30,000 vertices, α = 2.1, seed 4) dumped as SNAP text, ingested into a
    canonical EdgeFile and built from it.  Returns (graph, EdgeFile)."""
    from repro_torch.graphs.generators import powerlaw_configuration
    from repro_torch.io import dump_text, graph_from_edgefile, ingest_text

    g0 = powerlaw_configuration(30_000, 2.1, seed=4, device="cpu")
    src = os.path.join(workdir, "real.txt.gz")
    dump_text(g0.edges.numpy(), src,
              header="bundled power-law fallback — set "
                     "REPRO_REAL_GRAPH to a downloaded edge list")
    ef = ingest_text(src, os.path.join(workdir, "real.edges"),
                     tmpdir=workdir)
    return graph_from_edgefile(ef, device=device), ef


def run_cell(g, p: int, method: str):
    """(edge_part, PartitionResult or None) of one method at P = p on
    ``g``'s device, with the matrix's settings (seed 0, other fields
    default); the baselines return an assignment only."""
    from repro_torch.core.baselines import PARTITIONERS
    from repro_torch.core.hybrid import HybridConfig, partition_hybrid
    from repro_torch.core.partitioner import NEConfig, partition

    if method == "ne":
        res = partition(g, NEConfig(num_partitions=p, seed=0))
    elif method.startswith("hybrid_t"):
        tau = int(method[len("hybrid_t"):]) / 100
        res = partition_hybrid(g, HybridConfig(num_partitions=p,
                                               budget_frac=tau, seed=0))
    else:
        return PARTITIONERS[method](g, p), None
    return res.edge_part, res


def metrics(g, edge_part: np.ndarray, p: int) -> tuple:
    """(rf, eb, vb) of an assignment, each to 6 significant digits."""
    from repro_torch.core.metrics import evaluate

    st = evaluate(g.edges.cpu().numpy(), edge_part, g.num_vertices, p)
    return (fmt6(st.replication_factor), fmt6(st.edge_balance),
            fmt6(st.vertex_balance))


def run_matrix(graphs: dict, methods=METHODS, parts=PARTS, log=print):
    """Every row of ``graphs`` (name → Graph) × ``parts`` × ``methods``:
    a list of dicts with the row's name, (rf, eb, vb), the run's result
    and rounds (NE and hybrid rows), seconds and whether it equals
    :data:`EXPECTED`."""
    rows = []
    for gname, g in graphs.items():
        for p in parts:
            for method in methods:
                name = row_name(gname, p, method)
                t0 = time.perf_counter()
                ep, res = run_cell(g, p, method)
                secs = time.perf_counter() - t0
                got = metrics(g, ep, p)
                rounds = None if res is None else res.rounds
                row = {"name": name, "got": got, "expected": EXPECTED[name],
                       "result": res, "rounds": rounds, "seconds": secs,
                       "ok": got == EXPECTED[name]}
                rows.append(row)
                if log is not None:
                    stale = " (the JSON's is stale)" if name in STALE else ""
                    log(f"{name}: rf, eb, vb = {got}, expected "
                        f"{EXPECTED[name]}{stale}; rounds={rounds} "
                        f"{secs:.3f} s {'ok' if row['ok'] else 'DIFFERENT'}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="quality_") as td:
        graphs = {"rmat_s14_ef16": rmat_graph(args.device),
                  "real": real_graph(td, args.device)[0]}
        rows = run_matrix(graphs)
    bad = [r["name"] for r in rows if not r["ok"]]
    print(f"{len(rows) - len(bad)} of {len(rows)} rows equal EXPECTED"
          + (f"; different: {bad}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
