"""``core.graph.from_edges`` for the card: the canonical form and the CSR
built there with torch ops (``graph_from_edges_tensor``), held against
the host build.  No JAX here: ``tests/test_torch_partitioner.py`` holds
the tensor build against the reference on the CPU, and the card cases
(marked ``gpu``) skip without a card."""
import pytest
import torch

from repro_torch.core import graph as tgraph
from repro_torch.graphs.rmat import rmat_edges

FIELDS = ("edges", "indptr", "adj_dst", "adj_eid", "slot_src", "degree")


@pytest.mark.parametrize("edges,n", [([[0, 4]], 4), ([[-1, 2]], 4),
                                     ([[1, 2], [2, 9]], 8)])
def test_tensor_graph_build_refuses_ids_out_of_range(edges, n):
    """Ids outside [0, n) raise ValueError (the host build fails on them
    too, in its CSR step)."""
    with pytest.raises(ValueError):
        tgraph.graph_from_edges_tensor(torch.tensor(edges), n)


@pytest.mark.parametrize("dedup", [True, False])
def test_tensor_graph_build_equals_host_build(dedup):
    """On CPU tensors the tensor build gives the host build's Graph."""
    e, n = rmat_edges(12, 16, 1), 1 << 12
    got = tgraph.graph_from_edges_tensor(torch.from_numpy(e), n, dedup)
    host = tgraph.from_edges(e, n, device="cpu", dedup=dedup)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(host, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("dedup", [True, False])
def test_from_edges_on_card_equals_host(dedup):
    """``from_edges`` for the card builds there; its Graph equals the
    host build bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    e, n = rmat_edges(14, 16, 1), 1 << 14
    got = tgraph.from_edges(e, n, device="cuda", dedup=dedup)
    host = tgraph.from_edges(e, n, device="cpu", dedup=dedup)
    for f in FIELDS:
        t = getattr(got, f)
        assert t.dtype == torch.int32 and t.device.type == "cuda", f
        assert torch.equal(t.cpu(), getattr(host, f)), f
