"""``repro_torch.tools.quality``'s expected table against
``BENCH_QUALITY.json`` and against the reference package's present run.

The table must equal the JSON on 24 rows and differ on exactly the 8
rows it names stale, so the list cannot drift.  On the cells that are
cheap on the CPU the table must equal the reference package run now
(the hash baselines at all four cells, ``hdrf`` and ``oblivious`` on
``real`` at P = 4, ``hybrid_t25`` on ``rmat_s14_ef16`` at P = 4), and the
port's run of the same cells.  ``chip_smoke.py`` phase 10 runs all 32
rows on the card.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core.baselines import PARTITIONERS as J_PARTITIONERS
from repro.core.hybrid import HybridConfig as JHybridConfig
from repro.core.hybrid import partition_hybrid as j_partition_hybrid
from repro.core.metrics import evaluate as j_evaluate
from repro.graphs.generators import powerlaw_configuration as j_powerlaw
from repro.graphs.rmat import rmat as j_rmat
from repro.io.ingest import dump_text as j_dump_text
from repro.io.ingest import ingest_text as j_ingest_text
from repro.io.stream import graph_from_edgefile as j_graph_from_edgefile
from repro_torch.tools import quality

ROOT = Path(__file__).resolve().parent.parent
HASH = ("random", "grid", "dbh")
CELLS = ([(gname, p, m) for gname in quality.GRAPHS for p in quality.PARTS
          for m in HASH]
         + [("real", 4, "hdrf"), ("real", 4, "oblivious"),
            ("rmat_s14_ef16", 4, "hybrid_t25")])


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name → (port Graph on the CPU, reference Graph)."""
    td = tmp_path_factory.mktemp("quality")
    pd, jd = td / "port", td / "ref"
    pd.mkdir()
    jd.mkdir()
    real, _ = quality.real_graph(str(pd), device="cpu")
    g0 = j_powerlaw(30_000, 2.1, seed=4)
    j_dump_text(np.asarray(g0.edges), str(jd / "real.txt.gz"),
                header="bundled power-law fallback — set "
                       "REPRO_REAL_GRAPH to a downloaded edge list")
    j_real = j_graph_from_edgefile(j_ingest_text(
        str(jd / "real.txt.gz"), str(jd / "real.edges"), tmpdir=str(jd)))
    return {"rmat_s14_ef16": (quality.rmat_graph("cpu"), j_rmat(14, 16,
                                                                seed=1)),
            "real": (real, j_real)}


def test_table_against_the_json():
    rows = {r["name"]: tuple(r["metrics"][k] for k in ("rf", "eb", "vb"))
            for r in json.loads((ROOT / "BENCH_QUALITY.json").read_text())
            if r["name"] != "quality_summary"}
    assert sorted(rows) == sorted(quality.EXPECTED)
    assert sorted(quality.row_name(g, p, m) for g in quality.GRAPHS
                  for p in quality.PARTS for m in quality.METHODS) == \
        sorted(rows)
    differ = sorted(k for k in rows if rows[k] != quality.EXPECTED[k])
    assert differ == sorted(quality.STALE) and len(differ) == 8
    for name, stale in quality.STALE.items():
        assert rows[name] == stale


@pytest.mark.parametrize("gname", quality.GRAPHS)
def test_graphs_equal_the_reference(graphs, gname):
    got, want = graphs[gname]
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    assert got.num_vertices == want.num_vertices


def _reference_cell(jg, p: int, method: str) -> tuple:
    if method == "hybrid_t25":
        ep = j_partition_hybrid(jg, JHybridConfig(
            num_partitions=p, budget_frac=0.25, seed=0)).edge_part
    else:
        ep = J_PARTITIONERS[method](jg, p)
    st = j_evaluate(np.asarray(jg.edges), np.asarray(ep), jg.num_vertices,
                    p)
    return tuple(quality.fmt6(x) for x in (
        st.replication_factor, st.edge_balance, st.vertex_balance))


@pytest.mark.parametrize("gname,p,method", CELLS)
def test_table_against_the_reference_and_the_port(graphs, gname, p,
                                                  method):
    g, jg = graphs[gname]
    want = quality.EXPECTED[quality.row_name(gname, p, method)]
    assert _reference_cell(jg, p, method) == want
    if method != "hdrf":       # the plain HDRF scan takes ~11 s here
        ep, _ = quality.run_cell(g, p, method)
        assert quality.metrics(g, ep, p) == want
