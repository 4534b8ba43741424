"""deepfm [arXiv:1703.04247] — FM + deep MLP over 39 sparse fields."""
from repro_torch.models.recsys.deepfm import DeepFMConfig

FAMILY = "recsys"
CONFIG = DeepFMConfig(name="deepfm", n_fields=39, rows_per_field=1_048_576,
                      embed_dim=10, mlp_dims=(400, 400, 400),
                      n_candidates=1_000_000)
SMOKE = DeepFMConfig(name="deepfm-smoke", n_fields=5, rows_per_field=128,
                     embed_dim=4, mlp_dims=(16, 16), n_candidates=64)
