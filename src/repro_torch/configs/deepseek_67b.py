"""deepseek-67b [arXiv:2401.02954] — llama-arch dense LM."""
import torch

from repro_torch.models.lm.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64,
                  n_kv_heads=8, d_ff=22016, vocab=102400, head_dim=128,
                  tie_embeddings=False, dtype=torch.bfloat16)
SMOKE = LMConfig(name="deepseek-67b-smoke", n_layers=2, d_model=64,
                 n_heads=8, n_kv_heads=2, d_ff=160, vocab=512, head_dim=16,
                 tie_embeddings=False, dtype=torch.float32, remat="none")
