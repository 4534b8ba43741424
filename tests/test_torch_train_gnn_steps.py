"""One train step of the port's GNN cells against the reference's jitted
step: gin-tu, pna, egnn and equiformer-v2 at each of their four shapes
(full_graph_sm, minibatch_lg, ogb_products, molecule) at smoke size, with
the tolerances of ``test_torch_train_steps.py`` (whose helpers run it),
PNA's gradients within 1e-3 of each leaf's largest (see there).
"""
import pytest

from test_torch_train_steps import assert_step_close, run_pair

GNN_ARCHS = ("gin-tu", "pna", "egnn", "equiformer-v2")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


@pytest.mark.parametrize("shape_id", GNN_SHAPES)
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_train_step_matches_reference(arch, shape_id):
    assert_step_close(*run_pair(arch, shape_id),
                      grad_tol=1e-3 if arch == "pna" else 1e-4)
