"""Rank bodies for tests/test_torch_spmd.py.

``repro_torch.dist.compat.spawn`` runs them in gloo processes, one per
rank.  This module imports nothing of jax or ``repro``, so a rank starts
quickly; it is not a test module itself.
"""
import numpy as np
import torch

from repro_torch.core.epilogue import alpha_limit
from repro_torch.core.graph import from_edges, shard_edges
from repro_torch.dist import compat
from repro_torch.dist import partitioner_sm as sm


def spmd_checks(edges, n, cfg, carried, steps, or_rows):
    """On this rank: ``partition_spmd`` of the graph; ``steps`` rounds of
    ``spmd_round_step`` from the reference's carried state; and
    ``or_all_reduce`` of row ``rank`` of ``or_rows`` (D, N, W) int32.
    Returns host arrays only."""
    rank, world = compat.process_env()
    res = sm.partition_spmd(from_edges(edges, n, device="cpu"), cfg,
                            device="cpu")

    cfg = cfg.clamped(n)
    limit = alpha_limit(cfg.alpha, edges.shape[0], cfg.num_partitions)
    shards, masks, _, _ = shard_edges(edges, world)
    u, v = (torch.from_numpy(np.ascontiguousarray(shards[rank, :, i]))
            for i in (0, 1))
    mask = torch.from_numpy(masks[rank])
    state = sm.spmd_state_from_numpy(carried, device="cpu")
    for _ in range(steps):
        state = sm.spmd_round_step(cfg, limit, n, u, v, mask, state)

    ored = compat.or_all_reduce(torch.from_numpy(or_rows[rank]))
    return {"result": res, "state": sm.spmd_state_to_numpy(state),
            "or": ored.numpy().copy()}


def fail_on_last_rank():
    """Rank ``world - 1`` raises; the others wait in a collective."""
    rank, world = compat.process_env()
    if rank == world - 1:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
