"""Rank bodies of tests/test_torch_sharded.py: the port's sharded paths on
a gloo group of CPU ranks (``repro_torch.dist.compat.spawn``), each
input cut to the rank's shards by ``dist.compat.shard_tree`` and each
result gathered back to full arrays by ``gather_tree``.  This module
imports no jax, so that the ranks start fast."""
from __future__ import annotations

import torch

from repro_torch.apps import engine as eng
from repro_torch.configs import registry as treg
from repro_torch.dist import compat
from repro_torch.dist.context import mesh_context
from repro_torch.dist.sharding import P
from repro_torch.launch import gnn_engine as ge
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import params_from_numpy
from repro_torch.models.lm import moe as tmoe
from repro_torch.models.lm import transformer as ttf
from repro_torch.models.recsys import deepfm
from repro_torch.models.recsys.embedding import sharded_lookup
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_from_numpy, tree_to_numpy

DEC_CFG = ttf.LMConfig(name="dec", n_layers=2, d_model=32, n_heads=8,
                       n_kv_heads=2, d_ff=64, vocab=64, head_dim=8,
                       dtype=torch.float32, remat="none")
EXPERT_SPEC = P("model", ("data",), None)         # wi, wg, wo of one layer
TRAIN_ARCHS = {"olmoe-1b-7b": "train_4k", "smollm-135m": "train_4k",
               "deepfm": "train_batch"}


def _np(x):
    return x.detach().numpy().copy()


def _moe(inp, cap, mesh):
    """y, aux and the gradients of Σy² + aux on mesh (2, 2): the rank's
    rows of x (over "data") and experts (over "model", FSDP-cut over
    "data").  F = Σ y_rank² + aux / dp on each rank, so that the sum of
    the data ranks' gradients is the total's."""
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_expert=16,
                         capacity_factor=cap)
    specs = {"router": P(), "wi": EXPERT_SPEC, "wg": EXPERT_SPEC,
             "wo": EXPERT_SPEC}
    full = {k: torch.from_numpy(v) for k, v in inp["p"].items()}
    p = {k: v.requires_grad_() for k, v in
         compat.shard_tree(full, specs, mesh).items()}
    x = compat.shard_tree(torch.from_numpy(inp["x"]), P("data"),
                          mesh).requires_grad_()
    with mesh_context(mesh, ("data",), "model") as ctx:
        y, aux = tmoe.moe_block(p, x, cfg)
        ((y * y).sum() + aux / ctx.dp).backward()
        grads = {k: v.grad for k, v in p.items()}
        grads["router"] = ctx.psum(grads["router"], ("data",))
    grads = compat.gather_tree(grads, specs, mesh)
    return {"y": _np(compat.gather_tree(y.detach(), P("data"), mesh)),
            "aux": float(aux),
            "x_grad": _np(compat.gather_tree(x.grad, P("data"), mesh)),
            **{f"{k}_grad": _np(v) for k, v in grads.items()}}


def _lookup(inp, mesh):
    """sharded_lookup, DeepFM's forward and its table gradient on mesh
    (2, 2): table rows over "model", batch rows over "data"."""
    out = {}
    table = compat.shard_tree(torch.from_numpy(inp["table"]),
                              P("model", None), mesh)
    ids = compat.shard_tree(torch.from_numpy(inp["ids"]), P("data"), mesh)
    with mesh_context(mesh, ("data",), "model"):
        got = sharded_lookup(table, ids)
    out["lookup"] = _np(compat.gather_tree(got, P("data"), mesh))

    cfg = treg.get_arch("deepfm").smoke_config
    model = params_from_numpy(deepfm.DeepFM(cfg, device="cpu"),
                              inp["deepfm_params"])
    rows = P("model", None)
    for k in ("table", "w1", "item_tower"):
        getattr(model, k).data = compat.shard_tree(getattr(model, k).data,
                                                   rows, mesh)
    x = compat.shard_tree(torch.from_numpy(inp["deepfm_x"]), P("data"),
                          mesh)
    y = compat.shard_tree(torch.from_numpy(inp["deepfm_y"]), P("data"),
                          mesh)
    with mesh_context(mesh, ("data",), "model") as ctx:
        logits = model(x)
        loss = deepfm.loss_fn(model, x, y)
        (loss / ctx.dp).backward()
        tg = ctx.psum(model.table.grad, ("data",))
    out["deepfm_logits"] = _np(compat.gather_tree(logits.detach(),
                                                  P("data"), mesh))
    out["deepfm_table_grad"] = _np(compat.gather_tree(tg, rows, mesh))
    return out


def _split_kv(inp, mesh, batch, seq_axes):
    """Decode logits and the gathered caches at each cache_len, the
    cache's rows cut over ``seq_axes``."""
    model = params_from_numpy(ttf.Transformer(DEC_CFG, device="cpu"),
                              inp["dec_params"])
    spec = P(None, None, seq_axes, None, None)
    out = []
    for clen in inp["cache_lens"]:
        kc = torch.from_numpy(inp["kc"][:, :batch].copy())
        vc = torch.from_numpy(inp["vc"][:, :batch].copy())
        kl, vl = (compat.shard_tree(c, spec, mesh) for c in (kc, vc))
        tok = torch.from_numpy(inp["tok"][:batch])
        with torch.no_grad(), mesh_context(mesh, (), "model"):
            logits, _, n = model.decode(tok, (kl, vl), clen, seq_axes)
        out.append({"logits": _np(logits), "len": n,
                    "k": _np(compat.gather_tree(kl, spec, mesh)),
                    "v": _np(compat.gather_tree(vl, spec, mesh))})
    return out


def _train(arch, inp, mesh, n_steps=2):
    """Two steps of the cell's mesh step from the carried params and
    state; the gathered params, state, losses and grad norms."""
    b = steps.make_step(treg.get_arch(arch), TRAIN_ARCHS[arch], mesh=mesh,
                        smoke=True)
    pl, ol, *bl = b.layout
    params = compat.shard_tree(tree_from_numpy(inp["params"], b.args[0]),
                               pl, mesh)
    full = tree_from_numpy(inp["params"], b.args[0])
    state = compat.shard_tree(opt.state_from_numpy(
        inp["state"], full, steps.OPT_CFG), ol, mesh)
    losses, norms = [], []
    for batch in inp["batches"][:n_steps]:
        args = [compat.shard_tree(tree_from_numpy(x, m), s, mesh)
                for x, m, s in zip(batch, b.args[2:], bl)]
        params, state, loss, gn = b.fn(params, state, *args)
        losses.append(float(loss))
        norms.append(float(gn))
    return {"params": tree_to_numpy(compat.gather_tree(params, pl, mesh)),
            "state": tree_to_numpy(compat.gather_tree(state, ol, mesh)),
            "loss": losses, "grad_norm": norms}


def gin_engine_run(inp, mesh, n_steps=2):
    """GIN's full-graph mesh step (make_gnn_step's engine branch) over a
    real edge partition, one part a rank."""
    g = inp["gin"]
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    sg = eng.build_sharded_graph(g["edges"], g["edge_part"], g["n"], world)
    shape = dict(kind="full", n_nodes=g["n"], n_edges=len(g["edges"]),
                 d_feat=g["feats"].shape[1], n_classes=g["n_classes"])
    caps = ge.caps_from_sharded_graph(sg, shape["d_feat"],
                                      shape["n_classes"])
    a = ge.engine_arrays(sg, g["feats"], g["labels"], g["label_mask"], rank,
                         "cpu", g["positions"])
    b = steps.make_gnn_step(treg.get_arch("gin-tu"),
                            treg.get_arch("gin-tu").smoke_config, shape,
                            mesh, caps=caps)
    params = tree_from_numpy(g["params"], b.args[0])
    state = opt.init(params, steps.OPT_CFG)
    losses, norms = [], []
    for _ in range(n_steps):
        params, state, loss, gn = b.fn(params, state, a)
        losses.append(float(loss))
        norms.append(float(gn))
    return {"params": tree_to_numpy(params), "state": tree_to_numpy(state),
            "loss": losses, "grad_norm": norms}


def sharded_checks(inp):
    """Every check at 4 ranks; the results of this rank."""
    torch.manual_seed(0)
    m22, m14 = make_host_mesh(2), make_host_mesh(4)
    out = {"moe": {cap: _moe(inp["moe"], cap, m22)
                   for cap in inp["moe"]["caps"]},
           "lookup": _lookup(inp["lookup"], m22),
           "split_kv": {"1x4": _split_kv(inp["split_kv"], m14, 2,
                                         ("model",)),
                        "2x2": _split_kv(inp["split_kv"], m22, 1,
                                         ("data", "model"))},
           "train": {a: _train(a, inp["train"][a], m22)
                     for a in TRAIN_ARCHS},
           "gin": gin_engine_run(inp, m22)}
    return out

