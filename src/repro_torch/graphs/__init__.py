"""Graph generators."""
