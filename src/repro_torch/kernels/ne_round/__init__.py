"""The NE expansion round's kernels: one_hop, select, claim_scatter."""
