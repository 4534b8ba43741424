"""pna [arXiv:2004.05718] — principal neighbourhood aggregation."""
from repro_torch.models.gnn.pna import PNAConfig

FAMILY = "gnn"
MODEL = "pna"
CONFIG = PNAConfig(name="pna", n_layers=4, d_hidden=75)
SMOKE = PNAConfig(name="pna-smoke", n_layers=2, d_hidden=16)
