"""Language models: the decoder-only transformer (dense or MoE) and its
serving loop."""
