"""Rank bodies for tests/test_torch_spmd.py, tests/test_torch_gnn_engine.py
and tests/test_torch_runtime.py.

``repro_torch.dist.compat.spawn`` runs them in gloo processes, one per
rank.  This module imports nothing of jax or ``repro``, so a rank starts
quickly; it is not a test module itself.
"""
import numpy as np
import torch

from repro_torch.apps import engine as eng
from repro_torch.core.epilogue import alpha_limit
from repro_torch.core.graph import from_edges, shard_edges
from repro_torch.dist import compat
from repro_torch.dist import partitioner_sm as sm
from repro_torch.io.edgefile import EdgeFile
from repro_torch.launch import gnn_engine as ge
from repro_torch.models.gnn import gin
from repro_torch.runtime import PartitionDriver
from repro_torch.tree import tree_map


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


def driver_checks(ef_path, cfg, snap_dir, art_dir, resume_round):
    """On this rank: ``PartitionDriver`` in spmd mode from the EdgeFile at
    ``ef_path``, snapshotting every round into ``snap_dir``, run to the
    fixed point and saved as an artifact in ``art_dir``; then a fresh
    driver resumed from the round-``resume_round`` snapshot (the run
    killed after that round) and run to the end.  Returns both results
    and the resumed driver's first round."""
    ef = EdgeFile(ef_path)
    drv = PartitionDriver(ef, cfg, snapshot_dir=snap_dir, snapshot_every=1,
                          keep=1 << 20, device="cpu")
    res = drv.run()
    drv.save_artifact(art_dir)
    again = PartitionDriver.resume(ef, cfg, snap_dir, round_k=resume_round,
                                   device="cpu")
    start = again.rounds
    return {"result": res, "resumed": again.run(), "resumed_from": start}


def hybrid_driver_error(edges, cfg):
    """On this rank: build ``PartitionDriver`` in hybrid mode; returns the
    (type name, message) of what it raised, or None."""
    try:
        PartitionDriver(from_edges(edges, device="cpu"), cfg, mode="hybrid",
                        device="cpu")
    except Exception as exc:            # the caller checks which
        return type(exc).__name__, str(exc)
    return None


def fail_on_last_rank():
    """Rank ``world - 1`` raises; the others wait in a collective."""
    rank, world = compat.process_env()
    if rank == world - 1:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()


def engine_checks(edges, n, edge_part, feats, labels, label_mask, prim_vals,
                  models, ocfg, steps):
    """On this rank, over the vertex-cut engine of ``edge_part`` (one part
    per rank): the primitives on row ``rank`` of ``prim_vals`` (mirror
    values (R, F) and master values (O, F) per rank); for each
    ``(cfg, params)`` of ``models`` the loss and the rank-summed
    gradients; and ``steps`` optimizer steps of ``train_engine_gin`` from
    the last model's params.  Returns host arrays only."""
    rank, world = compat.process_env()
    sg = eng.build_sharded_graph(edges, edge_part, n, world)
    mirror_vals, owned_vals = (torch.from_numpy(v[rank]) for v in prim_vals)
    a = ge.engine_arrays(sg, feats, labels, label_mask, rank, "cpu")
    lanes = (a["send_idx"], a["send_mask"], a["recv_owned"])
    caps = sg.caps
    m2m = {op: eng.mirror_to_master(mirror_vals, *lanes, caps["O"], op,
                                    ident).numpy()
           for op, ident in (("sum", 0.0), ("min", np.inf),
                             ("max", -np.inf))}
    out = {"m2m": m2m,
           "bcast": eng.master_to_mirror(owned_vals, *lanes,
                                         caps["R"]).numpy(),
           "models": []}
    for cfg, params in models:
        model = gin.params_from_numpy(gin.GIN(cfg), params)
        tcaps = ge.caps_from_sharded_graph(sg, feats.shape[1], cfg.n_classes)
        loss = ge.loss_and_grads(model, a, tcaps)
        out["models"].append({
            "loss": float(loss),
            "grads": tree_map(lambda p: p.grad.numpy().copy(),
                              model.param_tree())})
    model = gin.params_from_numpy(gin.GIN(cfg), params)
    out["losses"] = ge.train_engine_gin(edges, edge_part, n, feats, labels,
                                        label_mask, model, ocfg, steps,
                                        device="cpu")
    out["params"] = gin.params_to_numpy(model)
    return out
