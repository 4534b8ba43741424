"""The SPMD partitioner over torch.distributed and its process-group glue."""
