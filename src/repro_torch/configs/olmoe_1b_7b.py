"""olmoe-1b-7b [arXiv:2409.02060] — 64-expert top-8 MoE LM."""
import torch

from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
                  n_kv_heads=16, d_ff=0, vocab=50304, tie_embeddings=False,
                  dtype=torch.bfloat16,
                  moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024))
SMOKE = LMConfig(name="olmoe-smoke", n_layers=2, d_model=48, n_heads=4,
                 n_kv_heads=4, d_ff=0, vocab=512, head_dim=16,
                 tie_embeddings=False, dtype=torch.float32, remat="none",
                 moe=MoEConfig(n_experts=8, top_k=2, d_expert=32))
