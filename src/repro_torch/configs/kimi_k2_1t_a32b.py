"""kimi-k2-1t-a32b [arXiv:2501.kimi2; paper-table] — trillion-param MoE."""
import torch

from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(name="kimi-k2-1t-a32b", n_layers=61, d_model=7168,
                  n_heads=64, n_kv_heads=8, d_ff=0, vocab=163840,
                  head_dim=112, tie_embeddings=False, dtype=torch.bfloat16,
                  moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048))
SMOKE = LMConfig(name="kimi-smoke", n_layers=2, d_model=64, n_heads=8,
                 n_kv_heads=2, d_ff=0, vocab=512, head_dim=16,
                 tie_embeddings=False, dtype=torch.float32, remat="none",
                 moe=MoEConfig(n_experts=8, top_k=2, d_expert=48))
