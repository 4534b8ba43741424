"""The cells' steps: (arch × shape) → a step function, the shapes and
types of its inputs, and its useful-compute estimate (the reference's
``launch/steps.py`` on one device), and the serve-side step bodies.

``make_step`` / ``make_lm_step`` / ``make_gnn_step`` / ``make_recsys_step``
return a :class:`StepBundle` whose ``fn`` works on the reference's
parameter pytree: a train ``fn(params, opt_state, batch...)`` returns
(new params, new optimizer state, loss, grad_norm) through
``train.optimizer.update``; the prefill, decode, serve and retrieval
steps take (params, inputs...).  The bundle's model is built on the meta device
(shapes and types only); ``fn`` runs it on the tensors it is given, on
their device, by ``torch.func.functional_call``.  ``args`` are meta-device
tensors that carry only shape and dtype (the global shapes).

With a ``mesh`` (``launch.mesh``; one process a device) the step is
sharded.  ``shardings`` holds the reference's ``in_shardings`` as spec
trees (``dist.sharding.P`` leaves), and ``layout`` what a rank of the
port holds: ``fn`` takes each input cut by ``layout``
(``dist.compat.shard_tree``) and returns the rank's shards.  The
reference's explicit collectives and sharded inputs are sharded here too:
data parallelism over the batch axes (a rank takes its rows; loss and
gradients are averaged over the batch axes before the update, the
global norm summed over every leaf's shards), expert parallelism with its
FSDP gather, the row-sharded recsys tables, split-KV decode over the
``kv_cache`` rule's sequence axes and the GNN engine's vertex-cut.  Its
layout-only rules (tensor parallelism of dense weights, Megatron-SP,
2-D FSDP of dense weights) are realised by replication: a rank computes
those layers whole, with the reference's values but not its memory, and
``meta["replicated"]`` names each logical name realised so.  At a mesh of
one rank every sharded step gives its mesh-free step's bits.

The serve bodies (``prefill_fn``, ``lm_serve_fn``, ``recsys_serve_fn``,
``retrieval_fn``) run a model as one serving call under
``torch.no_grad``, on the model's device.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.registry import ArchSpec
from repro_torch.dist import compat
from repro_torch.dist.context import axes_size, mesh_context
from repro_torch.dist.sharding import NO_RULES, P, Rules, lm_rules, spec_axes
from repro_torch.models.common import cross_entropy
from repro_torch.models.gnn.common import GraphData
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

OPT_CFG = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
_GNN_CLASSES = {"gin": ("gin", "GIN"), "pna": ("pna", "PNA"),
                "egnn": ("egnn", "EGNN"),
                "equiformer_v2": ("equiformer_v2", "EquiformerV2")}


@dataclasses.dataclass
class StepBundle:
    fn: Callable                 # the step
    args: tuple                  # meta-device tensors: shapes and dtypes
    model_flops: float           # 6·N·D-style useful-compute estimate
    meta: dict
    loop_scale: int = 1          # trip count of the dominant loop
    model: nn.Module | None = None   # the meta-device model fn runs
    shardings: tuple | None = None   # the reference's in_shardings (specs)
    layout: tuple | None = None      # what a rank of the port holds


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_axes(mesh) -> tuple[str, ...]:
    """The reference's batch axes: ("pod", "data") on a multi-pod mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _replicated_specs(tree):
    return tree_map(lambda _: P(), tree)


def _leaves_with_specs(tree, specs) -> list:
    """(leaf, spec) pairs in :func:`tree_leaves` order (a spec is a
    tuple, so the spec tree cannot be walked by itself)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _leaves_with_specs(t, specs[i])]
    return [(tree, specs)]


def _cut_axes(mesh, spec) -> tuple[str, ...]:
    """Every mesh axis that ``spec`` cuts some dimension over, in mesh
    order."""
    axes = {a for e in spec for a in spec_axes(e)}
    return tuple(a for a in mesh.mesh_dim_names if a in axes)


def _sharded_update(ctx, mesh, value, grads, layout, params, opt_state,
                    ocfg, ba):
    """Average the value and gradients over the batch axes ``ba`` (a leaf
    cut over them is already summed by its gather's backward), then the
    update with the global norm over every leaf's shards."""
    dp = axes_size(mesh, ba)
    if dp > 1:
        value = ctx.psum(value.detach(), ba) / dp

        def red(g, spec):
            if not set(ba) & set(_cut_axes(mesh, spec)):
                g = ctx.psum(g, ba)
            return g / dp

        grads = tree_map(red, grads, layout)
    gn = torch.sqrt(sum(ctx.psum(torch.sum(torch.square(g.float())),
                                 _cut_axes(mesh, spec))
                        for g, spec in _leaves_with_specs(grads, layout)))
    params, opt_state, stats = opt.update(grads, opt_state, params, ocfg,
                                          grad_norm=gn)
    return params, opt_state, value, stats["grad_norm"]


class _Call(nn.Module):
    """``fn(model, *args)`` as a module, so that ``functional_call`` can
    run it on the parameters it is given."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def bind(model: nn.Module, fn: Callable, grad: bool = False) -> Callable:
    """``call(params, *args)`` = ``fn(model, *args)`` with the model's
    parameters taken from ``params`` (the model's ``param_tree`` layout)
    instead of its own.  With ``grad``, ``call`` returns (value, the
    gradient tree of the value), a leaf the value does not reach getting
    zeros as ``jax.grad`` gives; the backward runs while the parameters
    are bound, so a layer that remat recomputes reads them too."""
    by_id = {id(p): f"model.{n}" for n, p in model.named_parameters()}
    names = [by_id[id(p)] for p in tree_leaves(model.param_tree())]

    def run(params, *args):
        leaves = [p.detach().requires_grad_() if grad else p
                  for p in tree_leaves(params)]

        def body(m, *a):
            if not grad:
                return fn(m, *a)
            with torch.enable_grad():
                value = fn(m, *a)
                grads = torch.autograd.grad(value, leaves, allow_unused=True)
            return value.detach(), tree_unflatten(params, [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, grads)])

        return functional_call(_Call(model, body), dict(zip(names, leaves)),
                               args, strict=True)

    return run


def _train_fn(value_and_grad: Callable, ocfg: opt.OptConfig) -> Callable:
    def train_fn(params, opt_state, *batch):
        value, grads = value_and_grad(params, *batch)
        params, opt_state, stats = opt.update(grads, opt_state, params, ocfg)
        return params, opt_state, value, stats["grad_norm"]

    return train_fn


def _specs(model: nn.Module, ocfg: opt.OptConfig | None = None):
    pspecs = tree_map(lambda p: p.detach(), model.param_tree())
    if ocfg is None:
        return pspecs
    return pspecs, opt.init(pspecs, ocfg)


# ===========================================================================
# LM family
# ===========================================================================

def lm_model_flops(cfg, shape: dict) -> float:
    s, b = shape["seq_len"], shape["global_batch"]
    n_act = cfg.active_param_count()
    l, h, hd = cfg.n_layers, cfg.n_heads, cfg.hd
    if shape["kind"] == "train":
        t = b * s
        # 6·N·T matmul + causal attention 2 matmuls fwd (×3 with bwd),
        # averaged causal span S/2
        return 6.0 * n_act * t + 3.0 * 2.0 * 2.0 * l * h * hd * t * (s / 2)
    if shape["kind"] == "prefill":
        t = b * s
        return 2.0 * n_act * t + 2.0 * 2.0 * l * h * hd * t * (s / 2)
    # decode: 1 token/row against an s-long cache
    t = b
    return 2.0 * n_act * t + 2.0 * 2.0 * l * h * hd * t * s


def lm_opt_config(cfg) -> opt.OptConfig:
    """The LM train step's optimizer: bf16 moments for models over 1e11
    parameters (their float32 state alone outgrows a pod), as the
    reference's ``make_lm_step``."""
    if cfg.param_count() > 1e11:
        return dataclasses.replace(OPT_CFG, state_dtype=torch.bfloat16)
    return OPT_CFG


def _lm_rules(cfg, shape: dict, mesh) -> Rules:
    """The cell's rule table on ``mesh`` (the reference's ``_lm_rules``;
    it reads only the mesh's axis names and sizes)."""
    if mesh is None:
        return NO_RULES
    size = dict(zip(mesh.mesh_dim_names, (int(x) for x in mesh.shape)))
    tp = size["model"]
    ba = _batch_axes(mesh)
    flags = dict(q_ok=cfg.n_heads % tp == 0,
                 kv_ok=cfg.n_kv_heads % tp == 0,
                 ffn_ok=(cfg.d_ff % tp == 0) and cfg.d_ff > 0,
                 vocab_ok=cfg.vocab % tp == 0)
    dp = axes_size(mesh, ba)
    if shape["global_batch"] % dp != 0:
        ba = ()   # batch doesn't divide DP → replicate batch dim
    if shape["kind"] == "decode":
        # split-KV axes: the model axis when kv heads can't shard; plus
        # the idle batch axes for batch=1 long-context cells.
        seq_axes = []
        w2d = ()
        if not ba:
            seq_axes += list(_batch_axes(mesh))
            # data axes idle for params too → 2D weight sharding
            if cfg.d_model % dp == 0:
                w2d = _batch_axes(mesh)
        if not flags["kv_ok"]:
            seq_axes.append("model")
        if shape["seq_len"] % max(1, axes_size(mesh, seq_axes)):
            seq_axes = []
        return lm_rules(batch_axes=ba, tp="model", seq_kv_axes=seq_axes,
                        w2d_axes=w2d, **flags)
    # sequence-parallel layout when attention heads can't use the TP axis;
    # Megatron-SP residual stream + FSDP (ZeRO-3) weights for large models
    sp = (not flags["q_ok"]) and shape["seq_len"] % tp == 0
    big = cfg.param_count() > 2e10
    resid_sp = big and shape["seq_len"] % tp == 0
    w2d = ba if (big and ba and cfg.d_model % dp == 0) else ()
    return lm_rules(batch_axes=ba, tp="model", sp=sp, resid_sp=resid_sp,
                    w2d_axes=w2d, **flags)


# the dimensions of each logical name that the port cuts as the rules
# say; every other cut of a rule is layout only and realised by
# replication
_REALISED = {"w_expert": (0, 1, 2, 3), "tok_bt": (0,), "act_btd": (0,),
             "act_bthh": (0,), "act_btf": (0,), "logits_btv": (0,),
             "kv_cache": (1, 2)}


def _realised(rules: Rules) -> tuple[Rules, list[str]]:
    """(the rules as the port realises them, the names realised by
    replication)."""
    out, replicated = {}, []
    for name, spec in rules.items():
        keep = _REALISED.get(name, ())
        real = P(*(e if i in keep else None for i, e in enumerate(spec)))
        if any(e is not None for e in spec) and real != spec:
            replicated.append(name)
        out[name] = real
    return Rules(out), sorted(replicated)


def make_lm_step(cfg, shape: dict, mesh=None,
                 mb_override: int | None = None,
                 remat_override: str | None = None) -> StepBundle:
    """The LM cell's step: train (with ``mb`` microbatches, 4 above 2e10
    parameters; gradients summed in microbatch order in float32, in bf16
    above 1e11 parameters, then loss and gradients divided by ``mb``;
    the optimizer of :func:`lm_opt_config`), prefill or decode.  With a
    mesh (see the module's docstring) the step runs under
    ``mesh_context`` on a rank's shards, with full remat above 2e10
    parameters as the reference's."""
    from repro_torch.models.lm import transformer as tf

    if mesh is not None and cfg.param_count() > 2e10 and \
            shape["kind"] == "train":
        cfg = dataclasses.replace(cfg, remat="full")
    if remat_override is not None:
        cfg = dataclasses.replace(cfg, remat=remat_override)
    model = tf.Transformer(cfg, device="meta")
    b, s = shape["global_batch"], shape["seq_len"]
    kind = shape["kind"]
    meta = dict(params=cfg.param_count(), active=cfg.active_param_count())
    rules = _lm_rules(cfg, shape, mesh)
    real, replicated = _realised(rules)
    if mesh is not None:
        meta["replicated"] = replicated
    pshard = tf.shard_params_rules(cfg, rules)
    pl = tf.shard_params_rules(cfg, real)
    ba = spec_axes(rules["tok_bt"][0]) if mesh is not None else ()

    def sharded(fn):
        """``fn`` under the mesh's context, batch axes ``ba``."""
        if mesh is None:
            return fn

        def run(*args):
            with mesh_context(mesh, ba, "model"):
                return fn(*args)
        return run

    if kind == "train":
        ocfg = lm_opt_config(cfg)
        pspecs, ospecs = _specs(model, ocfg)
        tok = _meta((b, s + 1), torch.int32)
        mb = 4 if (cfg.param_count() > 2e10 and b % 4 == 0) else 1
        if mb_override is not None:
            mb = mb_override
        acc_dt = torch.bfloat16 if cfg.param_count() > 1e11 \
            else torch.float32
        value_and_grad = bind(model, tf.loss_fn, grad=True)

        def grads_of(params, tokens):
            if mb == 1:
                return value_and_grad(params, tokens)
            rows = tokens.shape[0]
            value = torch.zeros((), device=tokens.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dt, device=p.device), params)
            for tok_mb in tokens.reshape(mb, rows // mb, s + 1):
                v, g = value_and_grad(params, tok_mb)
                value = value + v
                grads = tree_map(lambda a, x: a + x.to(acc_dt), grads, g)
            return value / mb, tree_map(lambda g: g / mb, grads)

        if mesh is None:
            def train_fn(params, opt_state, tokens):
                value, grads = grads_of(params, tokens)
                params, opt_state, stats = opt.update(grads, opt_state,
                                                      params, ocfg)
                return params, opt_state, value, stats["grad_norm"]
        else:
            def train_fn(params, opt_state, tokens):
                with mesh_context(mesh, ba, "model") as ctx:
                    value, grads = grads_of(params, tokens)
                    return _sharded_update(ctx, mesh, value, grads, pl,
                                           params, opt_state, ocfg, ba)

        oshard = {"m": pshard, "v": pshard, "step": P()}
        ol = {"m": pl, "v": pl, "step": P()}
        return StepBundle(train_fn, (pspecs, ospecs, tok),
                          model_flops=lm_model_flops(cfg, shape), meta=meta,
                          loop_scale=cfg.n_layers * mb, model=model,
                          **_shardings(mesh, (pshard, oshard,
                                              rules.get("tok_bt", P())),
                                       (pl, ol, real.get("tok_bt", P()))))

    pspecs = _specs(model)
    if kind == "prefill":
        return StepBundle(sharded(bind(model, prefill_fn)),
                          (pspecs, _meta((b, s), torch.int32)),
                          model_flops=lm_model_flops(cfg, shape), meta=meta,
                          loop_scale=cfg.n_layers, model=model,
                          **_shardings(mesh, (pshard,
                                              rules.get("tok_bt", P())),
                                       (pl, real.get("tok_bt", P()))))

    cache = _meta((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd), cfg.dtype)
    serve = bind(model, lm_serve_fn)
    if mesh is not None:
        # split-KV only where the rules cut the cache's sequence
        seq_axes, bound = spec_axes(rules["kv_cache"][2]) or None, serve
        serve = sharded(lambda params, token, k, v, n: bound(
            params, token, k, v, n, seq_axes))
    cs, cl = rules.get("kv_cache", P()), real.get("kv_cache", P())
    return StepBundle(serve,
                      (pspecs, _meta((b, 1), torch.int32), cache, cache,
                       _meta((), torch.int32)),
                      model_flops=lm_model_flops(cfg, shape), meta=meta,
                      loop_scale=cfg.n_layers, model=model,
                      **_shardings(mesh, (pshard, rules.get("tok_bt", P()),
                                          cs, cs, P()),
                                   (pl, real.get("tok_bt", P()), cl, cl,
                                    P())))


def _shardings(mesh, shardings, layout) -> dict:
    if mesh is None:
        return {}
    return dict(shardings=shardings, layout=layout)


# ===========================================================================
# GNN family
# ===========================================================================

def gnn_model_flops(cfg, shape: dict) -> float:
    """Rough per-layer message/update matmul count."""
    d = getattr(cfg, "d_hidden", 64)
    nl = cfg.n_layers
    if shape["kind"] == "full":
        n, e = shape["n_nodes"], 2 * shape["n_edges"]
    elif shape["kind"] == "minibatch":
        seeds = shape["batch_nodes"]
        f1, f2 = shape["fanout"]
        n = seeds * (1 + f1 + f1 * f2)
        e = 2 * seeds * (f1 + f1 * f2)
    else:
        n = shape["batch"] * shape["n_nodes"]
        e = 2 * shape["batch"] * shape["n_edges"]
    name = type(cfg).__name__
    if name == "GINConfig":          # gather-add per edge, 2-layer MLP/node
        per_edge, per_node = 2 * d, 2 * 2 * d * d
    elif name == "PNAConfig":        # pre-MLP per edge, wide post per node
        per_edge, per_node = 2 * (2 * d) * d, 2 * (13 * d) * d
    elif name == "EGNNConfig":       # phi_e per edge (2 layers), phi_h/node
        per_edge, per_node = 2 * 2 * d * d * 2, 2 * 2 * d * d
    else:                            # EquiformerV2: SO(2) conv per edge
        c = d
        l0 = cfg.l_max + 1
        so2 = 2 * (l0 * c) ** 2
        for m in range(1, cfg.m_max + 1):
            so2 += 4 * 2 * ((cfg.l_max + 1 - m) * c) ** 2
        wig = 2 * sum((2 * ll + 1) ** 2 for ll in range(cfg.l_max + 1)) * c
        per_edge, per_node = so2 + 2 * wig, 2 * 2 * c * c * (l0 ** 2)
    return 3.0 * nl * (e * per_edge + n * per_node)         # fwd+bwd ~ 3x


def _mk_graph_arrays(shape: dict, batch_lead: int | None):
    f = shape["d_feat"]
    i32, f32, bool_ = torch.int32, torch.float32, torch.bool
    if shape["kind"] == "minibatch":
        seeds = shape["batch_nodes"] // (batch_lead or 1)
        f1, f2 = shape["fanout"]
        n = seeds * (1 + f1 + f1 * f2)
        e = 2 * seeds * (f1 + f1 * f2)
        lead = (batch_lead,) if batch_lead else ()
    elif shape["kind"] == "batched":
        n, e = shape["n_nodes"], 2 * shape["n_edges"]
        lead = (shape["batch"],)
    else:
        n, e = shape["n_nodes"], 2 * shape["n_edges"]
        lead = ()
    per_graph = () if shape["kind"] == "batched" else (n,)
    return dict(
        feats=_meta((*lead, n, f), f32),
        edge_index=_meta((*lead, 2, e), i32),
        edge_mask=_meta((*lead, e), bool_),
        labels=_meta((*lead, *per_graph), i32),
        label_mask=_meta((*lead, *per_graph), bool_),
        positions=_meta((*lead, n, 3), f32),
    ), n


def make_gnn_step(spec: ArchSpec, cfg, shape: dict, mesh=None,
                  caps=None) -> StepBundle:
    """The GNN cell's train step.  Without a mesh, the plain model: the
    minibatch (a lead of 1) and batched kinds take the mean of each lead
    row's loss, a loop standing in for ``jax.vmap``.  Features go to
    float32 as in the reference (float64 ones stay float64, for a float64
    check).

    With a mesh, ``kind == "full"`` is the vertex-cut engine's step
    (``launch.gnn_engine``) over all the mesh's ranks: ``args`` hold the
    engine arrays' global shapes for :func:`gnn_engine.synth_caps`'s
    capacities (or ``caps``, a real partition's), and
    ``fn(params, opt_state, arrays)`` takes the rank's own arrays
    (``gnn_engine.engine_arrays``); the minibatch (a lead of dp) and
    batched kinds cut the lead axis over the batch axes."""
    from repro_torch.launch import gnn_engine as ge

    module, cls = _GNN_CLASSES[spec.model_module]
    graph_level = shape["kind"] == "batched"
    cfg = dataclasses.replace(cfg, d_feat=shape["d_feat"],
                              n_classes=shape["n_classes"],
                              graph_level=graph_level)
    model = getattr(importlib.import_module(
        f"repro_torch.models.gnn.{module}"), cls)(cfg, device="meta")
    pspecs, ospecs = _specs(model, OPT_CFG)
    pshard = _replicated_specs(pspecs)
    oshard = {"m": pshard, "v": pshard, "step": P()}
    ba = _batch_axes(mesh) if mesh is not None else ()
    all_axes = (*ba, "model") if mesh is not None else ()

    if shape["kind"] == "full" and mesh is not None:
        if caps is None:
            caps = ge.synth_caps(shape, axes_size(mesh, all_axes))
        arrays = ge.engine_array_specs(caps, positions=True)

        def loss(m, a):
            # every rank of the mesh is a rank of the engine (None: the
            # whole world, which is the mesh)
            return ge.engine_loss(m, a, caps, None)

        vg = bind(model, loss, grad=True)

        def train_fn(params, opt_state, a):
            value, grads = vg(params, a)
            if axes_size(mesh, all_axes) > 1:     # the ranks' sum
                grads = tree_map(compat.all_reduce_sum, grads)
            params, opt_state, stats = opt.update(grads, opt_state, params,
                                                  OPT_CFG)
            return params, opt_state, value, stats["grad_norm"]

        ashard = {k: P(all_axes, *([None] * (v.dim() - 1)))
                  for k, v in arrays.items()}
        nch = (cfg.n_layers * max(1, -(-2 * caps.c_edges // 16384))
               if spec.model_module == "equiformer_v2" else 1)
        return StepBundle(train_fn, (pspecs, ospecs, arrays),
                          model_flops=gnn_model_flops(cfg, shape),
                          meta=dict(engine_caps=dataclasses.asdict(caps),
                                    replicated=[]),
                          loop_scale=nch, model=model,
                          shardings=(pshard, oshard, ashard),
                          layout=(pshard, oshard, ashard))

    if shape["kind"] == "minibatch":
        lead = axes_size(mesh, ba) if mesh is not None else 1
    else:
        lead = None
    arrays, n_nodes = _mk_graph_arrays(shape, lead)
    looped = shape["kind"] in ("minibatch", "batched")

    def single_loss(m, feats, edge_index, edge_mask, labels, label_mask,
                    positions):
        gids = (torch.zeros((feats.shape[0],), dtype=torch.int32,
                            device=feats.device) if graph_level else None)
        g = GraphData(feats.to(torch.promote_types(feats.dtype,
                                                   torch.float32)),
                      edge_index, edge_mask,
                      graph_ids=gids, n_graphs=1, positions=positions)
        logits = m(g)
        if graph_level:           # one graph, scalar label
            return cross_entropy(logits[None], labels.reshape(1, 1),
                                 label_mask.reshape(1, 1).float())
        return cross_entropy(logits[None], labels[None],
                             label_mask[None].float())

    def loss_all(m, a):
        keys = ("feats", "edge_index", "edge_mask", "labels", "label_mask",
                "positions")
        if looped:
            n_lead = a["feats"].shape[0]
            return torch.stack([single_loss(m, *(a[k][i] for k in keys))
                                for i in range(n_lead)]).mean()
        return single_loss(m, *(a[k] for k in keys))

    vg = bind(model, loss_all, grad=True)
    meta = dict(n_nodes=n_nodes)
    if mesh is None:
        return StepBundle(_train_fn(vg, OPT_CFG), (pspecs, ospecs, arrays),
                          model_flops=gnn_model_flops(cfg, shape),
                          meta=meta, model=model)
    # the lead axis over the batch axes (the rank's rows where they divide
    # it); the full kind took the engine above
    ashard = {k: P(ba, *([None] * (v.dim() - 1))) for k, v in arrays.items()}
    bl = ba if arrays["feats"].shape[0] % axes_size(mesh, ba) == 0 else ()
    alay = {k: P(bl or None, *([None] * (v.dim() - 1)))
            for k, v in arrays.items()}
    meta["replicated"] = []

    def train_fn(params, opt_state, a):
        with mesh_context(mesh, bl, "model") as ctx:
            value, grads = vg(params, a)
            return _sharded_update(ctx, mesh, value, grads, pshard, params,
                                   opt_state, OPT_CFG, bl)

    return StepBundle(train_fn, (pspecs, ospecs, arrays),
                      model_flops=gnn_model_flops(cfg, shape), meta=meta,
                      model=model, shardings=(pshard, oshard, ashard),
                      layout=(pshard, oshard, alay))


# ===========================================================================
# recsys family
# ===========================================================================

def recsys_model_flops(cfg, shape: dict) -> float:
    d_in = cfg.n_fields * cfg.embed_dim
    mlp = 0
    dims = [d_in, *cfg.mlp_dims, 1]
    for a, b_ in zip(dims[:-1], dims[1:]):
        mlp += 2 * a * b_
    per_row = mlp + cfg.n_fields * cfg.embed_dim * 4
    if shape["kind"] == "train":
        return 3.0 * shape["batch"] * per_row
    if shape["kind"] == "serve":
        return 1.0 * shape["batch"] * per_row
    return per_row + 2.0 * shape["n_candidates"] * cfg.embed_dim


def make_recsys_step(cfg, shape: dict, mesh=None) -> StepBundle:
    """DeepFM's step: train (binary cross-entropy, AdamW over every
    parameter, the dense table gradient included), serve or retrieval.
    With a mesh ``table``, ``w1`` and ``item_tower`` are row-sharded over
    "model" and the batch over the batch axes (where they divide it); the
    serve step returns the rank's rows' logits, retrieval the scores of
    its candidate rows."""
    from repro_torch.models.recsys import deepfm

    model = deepfm.DeepFM(cfg, device="meta")
    b = shape["batch"]
    x = _meta((b, cfg.n_fields), torch.int32)
    kind = shape["kind"]
    mf = recsys_model_flops(cfg, shape)
    pspecs = _specs(model)
    pshard = _replicated_specs(pspecs)
    sh = {}
    if mesh is not None:
        for k in ("table", "w1", "item_tower"):
            pshard[k] = P("model", None)
        ba = _batch_axes(mesh)
        bl = ba if b % axes_size(mesh, ba) == 0 else ()
        xs, xl = P(ba, None), P(bl or None, None)
        meta = {"replicated": []}
    else:
        meta = {}
    if kind == "train":
        pspecs, ospecs = _specs(model, OPT_CFG)
        vg = bind(model, deepfm.loss_fn, grad=True)
        args = (pspecs, ospecs, x, _meta((b,), torch.float32))
        if mesh is None:
            return StepBundle(_train_fn(vg, OPT_CFG), args, model_flops=mf,
                              meta=meta, model=model)
        oshard = {"m": pshard, "v": dict(pshard), "step": P()}

        def train_fn(params, opt_state, xb, yb):
            with mesh_context(mesh, bl, "model") as ctx:
                value, grads = vg(params, xb, yb)
                return _sharded_update(ctx, mesh, value, grads, pshard,
                                       params, opt_state, OPT_CFG, bl)

        return StepBundle(train_fn, args, model_flops=mf, meta=meta,
                          model=model,
                          shardings=(pshard, oshard, xs, P(ba)),
                          layout=(pshard, oshard, xl, P(bl or None)))
    fn = bind(model, recsys_serve_fn if kind == "serve" else retrieval_fn)
    if mesh is None:
        return StepBundle(fn, (pspecs, x), model_flops=mf, meta=meta,
                          model=model)
    if kind == "retrieval":
        xs = xl = P(None, None)
        bl = ()

    def serve_fn(params, xb):
        with mesh_context(mesh, bl, "model"):
            return fn(params, xb)

    return StepBundle(serve_fn, (pspecs, x), model_flops=mf, meta=meta,
                      model=model, shardings=(pshard, xs),
                      layout=(pshard, xl))


# ===========================================================================

def make_step(spec: ArchSpec, shape_id: str, mesh=None, smoke: bool = False,
              shape_override: dict | None = None) -> StepBundle:
    """The (arch, shape) cell's step; ``smoke`` takes the reduced config
    and the reduced shape of the cell's kind."""
    from repro_torch.configs.shapes import FAMILY_SHAPES, SMOKE_SHAPES

    cfg = spec.smoke_config if smoke else spec.config
    if shape_override is not None:
        shape = shape_override
    elif smoke:
        kind = FAMILY_SHAPES[spec.family][shape_id]["kind"]
        shape = dict(SMOKE_SHAPES[spec.family][kind])
    else:
        shape = dict(FAMILY_SHAPES[spec.family][shape_id])

    if spec.family == "lm":
        return make_lm_step(cfg, shape, mesh)
    if spec.family == "gnn":
        return make_gnn_step(spec, cfg, shape, mesh)
    return make_recsys_step(cfg, shape, mesh)


@torch.no_grad()
def prefill_fn(model, tokens):
    """The prefill cell: (last position's logits (B, V), the (k, v)
    caches) of a full-sequence forward."""
    logits, caches, _ = model(tokens, return_cache=True)
    return logits[:, -1, :].clone(), caches


@torch.no_grad()
def lm_serve_fn(model, token, k_cache, v_cache, cache_len: int,
                seq_axes=None):
    """The decode cell: one decode step, the caches written in place
    (with ``seq_axes``, a rank's rows of a sequence-sharded cache)."""
    logits, (k2, v2), new_len = model.decode(token, (k_cache, v_cache),
                                             cache_len, seq_axes)
    return logits, k2, v2, new_len


@torch.no_grad()
def recsys_serve_fn(model, xb):
    """The recsys serve cells: DeepFM's logits of a batch."""
    return model(xb)


@torch.no_grad()
def retrieval_fn(model, xb):
    """The retrieval cell: one query against every candidate."""
    return model.retrieval_scores(xb)
