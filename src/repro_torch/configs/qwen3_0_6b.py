"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B family] — qk_norm + GQA dense LM.

head_dim=128 per the HF config (q/k/v projections wider than d_model)."""
import torch

from repro_torch.models.lm.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
                  n_kv_heads=8, d_ff=3072, vocab=151936, head_dim=128,
                  qk_norm=True, rope_theta=1e6, tie_embeddings=True,
                  dtype=torch.bfloat16)
SMOKE = LMConfig(name="qwen3-0.6b-smoke", n_layers=2, d_model=48, n_heads=4,
                 n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
                 qk_norm=True, tie_embeddings=True, dtype=torch.float32,
                 remat="none")
