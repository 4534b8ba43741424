"""Time the vertex-cut engine's ``train_step`` of each GNN family.

    PYTHONPATH=src python -m repro_torch.tools.step_time [--family F ...]
        [--steps N]

builds the GNN cell's graph (Erdős–Rényi of Cora's size, ``full_graph_sm``
in ``configs/shapes.py``, with Cora's density of binary features and
seeded positions), puts it in a one-part ``ShardedGraph`` at world 1 on
the card, and trains each family's ``CONFIG`` (PNA 4 × 75, EGNN 4 × 64,
EquiformerV2 12 layers, d 128, l_max 6) from parameter seed 0.  It
prints one JSON
line a family: the mean ms of ``--steps`` steps after two warm-up steps
(host clock around work that ends in a device sync), the first and last
losses, and the peak device memory above what the arrays and the model
hold.  The script needs only the package on ``PYTHONPATH``, so that two
checkouts can be timed in one call, each with its own ``src``:

    PYTHONPATH=other/src python src/repro_torch/tools/step_time.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

FAMILIES = ("pna", "egnn", "equiformer_v2")
ER_DEGREE = 6.5            # |E| after dedup 10,545 (Cora's 10,556)
WARMUP = 2


def cell_data(seed: int = 0):
    """(edges, features, labels, label mask, positions) of the cell."""
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.graphs.generators import erdos_renyi

    shape = GNN_SHAPES["full_graph_sm"]
    n, d = shape["n_nodes"], shape["d_feat"]
    edges = erdos_renyi(n, ER_DEGREE, seed, device="cpu").edges.numpy()
    rng = np.random.default_rng(seed)
    feats = (rng.random((n, d)) < 18 / 1433).astype(np.float32)
    w_true = rng.normal(size=(d, shape["n_classes"]))
    labels = (feats @ w_true).argmax(1).astype(np.int32)
    label_mask = np.bincount(edges.ravel(), minlength=n) > 0
    pos = np.random.default_rng(seed + 1).normal(size=(n, 3)).astype(
        np.float32)
    return edges, feats, labels, label_mask, pos


def time_family(family: str, steps: int, device, data) -> dict:
    """``steps`` timed ``train_step``s of ``family`` on ``device`` (a CPU
    run gives no peak) over :func:`cell_data`'s ``data``."""
    import importlib

    from repro_torch.apps import engine as eng
    from repro_torch.dist import compat
    from repro_torch.launch import gnn_engine as ge
    from repro_torch.models.gnn import egnn, equiformer_v2, pna
    from repro_torch.train import optimizer as opt

    cls = {"pna": pna.PNA, "egnn": egnn.EGNN,
           "equiformer_v2": equiformer_v2.EquiformerV2}[family]
    conf = importlib.import_module(f"repro_torch.configs.{family}")
    edges, feats, labels, label_mask, pos = data
    n = feats.shape[0]
    cfg = dataclasses.replace(conf.CONFIG, d_feat=feats.shape[1],
                              n_classes=int(labels.max()) + 1)
    sg = eng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), n, 1)
    caps = ge.caps_from_sharded_graph(sg, feats.shape[1], cfg.n_classes)
    ocfg = opt.OptConfig(total_steps=WARMUP + steps, lr=3e-3,
                         weight_decay=0.0, warmup_steps=20)
    cuda = device.type == "cuda"
    with compat.world1("nccl" if cuda else "gloo"):
        a = ge.engine_arrays(sg, feats, labels, label_mask, 0, device, pos)
        model = cls(cfg, torch.Generator().manual_seed(0)).to(device)
        state = opt.init(model.param_tree(), ocfg)
        losses = []
        for _ in range(WARMUP):
            loss, state = ge.train_step(model, a, caps, state, ocfg)
            losses.append(loss)
        if cuda:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, state = ge.train_step(model, a, caps, state, ocfg)
            losses.append(loss)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
    losses = [float(x) for x in losses]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{family}: losses {losses}")
    return {"family": family, "layers": cfg.n_layers, "steps": steps,
            "ms_a_step": ms, "loss_first": losses[0], "loss_last": losses[-1],
            "peak_bytes": (torch.cuda.max_memory_allocated() - base
                           if cuda else None)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", nargs="+", choices=FAMILIES,
                    default=list(FAMILIES))
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    from repro_torch.core.graph import resolve_device

    device = resolve_device(None)
    data = cell_data()
    for family in args.family:
        print(json.dumps(time_family(family, args.steps, device, data)),
              flush=True)


if __name__ == "__main__":
    main()
