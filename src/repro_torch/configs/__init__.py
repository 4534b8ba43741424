"""Model configurations and input shapes, copied from the reference."""
