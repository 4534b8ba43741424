"""gin-tu [arXiv:1810.00826] — GIN with learnable ε, sum aggregation."""
from repro_torch.models.gnn.gin import GINConfig

FAMILY = "gnn"
MODEL = "gin"
CONFIG = GINConfig(name="gin-tu", n_layers=5, d_hidden=64)
SMOKE = GINConfig(name="gin-tu-smoke", n_layers=2, d_hidden=16)
