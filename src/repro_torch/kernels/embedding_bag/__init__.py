"""EmbeddingBag gather-reduce: (B, D) = Σ_k w[b, k] · table[ids[b, k]]."""
