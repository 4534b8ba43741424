"""Graph applications over an edge partition: the vertex-cut GAS engine."""
