"""equiformer-v2 [arXiv:2306.12059] — eSCN SO(2) equivariant attention."""
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config

FAMILY = "gnn"
MODEL = "equiformer_v2"
CONFIG = EquiformerV2Config(name="equiformer-v2", n_layers=12, d_hidden=128,
                            l_max=6, m_max=2, n_heads=8)
SMOKE = EquiformerV2Config(name="equiformer-v2-smoke", n_layers=2,
                           d_hidden=16, l_max=3, m_max=2, n_heads=4)
