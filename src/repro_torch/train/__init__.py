"""Training substrate: the optimizer."""
