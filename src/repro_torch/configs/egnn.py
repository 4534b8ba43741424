"""egnn [arXiv:2102.09844] — E(n)-equivariant GNN."""
from repro_torch.models.gnn.egnn import EGNNConfig

FAMILY = "gnn"
MODEL = "egnn"
CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64)
SMOKE = EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16)
