"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense LM."""
import torch

from repro_torch.models.lm.transformer import LMConfig

FAMILY = "lm"
CONFIG = LMConfig(name="smollm-135m", n_layers=30, d_model=576, n_heads=9,
                  n_kv_heads=3, d_ff=1536, vocab=49152, head_dim=64,
                  tie_embeddings=True, dtype=torch.bfloat16)
SMOKE = LMConfig(name="smollm-135m-smoke", n_layers=2, d_model=48, n_heads=3,
                 n_kv_heads=1, d_ff=128, vocab=512, head_dim=16,
                 tie_embeddings=True, dtype=torch.float32, remat="none")
