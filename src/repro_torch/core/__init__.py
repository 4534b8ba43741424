"""Graph container, the Distributed NE partitioner, epilogue and metrics."""
