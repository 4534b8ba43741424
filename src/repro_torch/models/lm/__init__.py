"""Language models: the dense decoder-only transformer and its serving
loop."""
