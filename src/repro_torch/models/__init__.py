"""Models on the port's substrate (explicit parameter layouts as in the
reference package, as ``nn.Module``\\ s)."""
