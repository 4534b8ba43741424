"""The port's vertex-cut engine and its GIN training against the reference.

``ShardedGraph`` must equal the reference's array for array (the edge
partition from the port's ``partition``).  The engine's primitives are
held to a numpy oracle that knows only each vertex's mirrors and master.
The engine GIN's loss, gradients and optimizer steps are held to the
reference: at one rank (in this process, a gloo group) to its
``make_engine_loss`` on a 1-device mesh, and at 2 and 4 ranks (spawned
gloo processes, rank bodies in ``torch_spmd_ranks``) to its plain
single-device ``gin.forward`` loss, which the engine computes exactly in
exact arithmetic.  Each at the smoke width and at the full gin-tu width.

Tolerances, float32 throughout: the aggregation sums the same terms in
another order (block products against segment sums, and across ranks),
so a loss agrees to 1e-5 relative and a gradient leaf to 1e-5 of its
largest entry.  An AdamW step moves a parameter by lr · m^/sqrt(v^),
which carries the gradients' relative error, so after 3 steps the
parameters agree to 1e-5 of the learning rates' sum, plus 1e-6.  These
hold unless a ReLU pre-activation lies within rounding of 0, where the
two sides may fall on different sides of its kink; with these fixed
inputs both take the same side of every kink.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_ranks
from repro.apps import engine as jeng
from repro.dist import compat as jcompat
from repro.graphs import generators as jgen
from repro.launch import gnn_engine as jge
from repro.models.common import cross_entropy as j_cross_entropy
from repro.models.gnn import gin as jgin
from repro.models.gnn.common import GraphData as JGraphData
from repro.models.gnn.common import segment_agg as j_segment_agg
from repro.models.gnn.common import to_directed_padded as j_to_directed
from repro.train import optimizer as jopt
from repro_torch.apps import engine as eng
from repro_torch.configs import gin_tu, shapes
from repro_torch.core import partitioner as tp
from repro_torch.core.graph import from_edges
from repro_torch.dist import compat
from repro_torch.graphs import generators
from repro_torch.launch import gnn_engine as ge
from repro_torch.models.common import cross_entropy
from repro_torch.models.gnn import gin
from repro_torch.models.gnn.common import (GraphData, segment_agg,
                                           to_directed_padded)
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_leaves, tree_map

N, ATTACH, D_FEAT, N_CLASSES = 200, 3, 12, 4
WIDTHS = {"smoke": gin_tu.SMOKE, "full": gin_tu.CONFIG}
OPT_KW = dict(lr=3e-3, weight_decay=0.0, warmup_steps=20, total_steps=20)
STEPS = 3
WORLDS = (2, 4)
SHARDED_FIELDS = ("edges_ml", "emask", "mirror_glob", "mirror_mask",
                  "send_idx", "send_mask", "recv_owned", "owned_glob",
                  "owned_mask")


@pytest.fixture(scope="module")
def graph():
    """BA(200, 3): every vertex has an edge, so the label mask may cover
    any of them; 80 % labelled."""
    edges = np.array(jgen.barabasi_albert(N, ATTACH, seed=0).edges)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N, D_FEAT)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, N).astype(np.int32)
    label_mask = rng.random(N) < 0.8
    return edges, feats, labels, label_mask


def _edge_part(edges, d):
    res = tp.partition(from_edges(edges, N, device="cpu"),
                       tp.NEConfig(num_partitions=d, seed=0))
    return res.edge_part


def _cfgs(name):
    """(the port's config, the reference's) at a width, for this graph."""
    kw = dict(d_feat=D_FEAT, n_classes=N_CLASSES)
    c = WIDTHS[name]
    jc = jgin.GINConfig(name=c.name, n_layers=c.n_layers,
                        d_hidden=c.d_hidden, **kw)
    return dataclasses.replace(c, **kw), jc


def _jax_params(jcfg, seed):
    return jax.tree.map(np.asarray,
                        jgin.init_params(jax.random.PRNGKey(seed), jcfg))


def _plain_loss_fn(graph, jcfg):
    edges, feats, labels, label_mask = graph
    ei, m = j_to_directed(edges, N)
    g = JGraphData(jnp.asarray(feats), jnp.asarray(ei), jnp.asarray(m))

    def loss_fn(params):
        return j_cross_entropy(jgin.forward(params, g, jcfg),
                               jnp.asarray(labels), jnp.asarray(label_mask))
    return loss_fn


def _jax_train(value_and_grad, params, steps):
    """The reference's (losses, params) of ``steps`` AdamW steps."""
    ocfg = jopt.OptConfig(**OPT_KW)
    state = jopt.init(params, ocfg)
    losses = []
    for _ in range(steps):
        loss, grads = value_and_grad(params)
        params, state, _ = jopt.update(grads, state, params, ocfg)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def _lr_sum(steps):
    ocfg = opt.OptConfig(**OPT_KW)
    return sum(float(opt.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))
               for s in range(1, steps + 1))


def _assert_grads_close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-12)


def _assert_trained_close(losses, params, want_losses, want_params):
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    atol = 1e-5 * _lr_sum(STEPS) + 1e-6
    for g, w in zip(tree_leaves(params), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# --------------------------------------------------------------------------
# host structures, configs and the plain model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,deg,seed", [(300, 4.0, 0), (2708, 6.5, 3)])
def test_erdos_renyi_matches_reference(n, deg, seed):
    want = jgen.erdos_renyi(n, deg, seed)
    got = generators.erdos_renyi(n, deg, seed, device="cpu")
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    assert got.num_vertices == want.num_vertices


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_graph_matches_reference(graph, d):
    edges = graph[0]
    ep = _edge_part(edges, d)
    want = jeng.build_sharded_graph(edges, ep, N, d)
    got = eng.build_sharded_graph(edges, ep, N, d)
    for f in SHARDED_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.num_vertices, got.num_devices, got.comm_slots) == \
        (want.num_vertices, want.num_devices, want.comm_slots)
    assert got.caps == want.caps
    caps = dataclasses.asdict(ge.caps_from_sharded_graph(got, D_FEAT,
                                                         N_CLASSES))
    want_caps = dataclasses.asdict(jge.caps_from_sharded_graph(
        want, D_FEAT, N_CLASSES))
    assert want_caps.pop("sync_dtype") == "float32"    # the port's wire
    assert caps == want_caps


def test_configs_are_the_references():
    from repro.configs import gin_tu as j_gin_tu
    from repro.configs import shapes as j_shapes

    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(gin_tu, name)) == \
            dataclasses.asdict(getattr(j_gin_tu, name))
    assert (gin_tu.FAMILY, gin_tu.MODEL) == (j_gin_tu.FAMILY, j_gin_tu.MODEL)
    assert shapes.GNN_SHAPES == j_shapes.GNN_SHAPES


@pytest.mark.parametrize("graph_level", [False, True])
def test_plain_gin_forward_matches_reference(graph, graph_level):
    edges, feats, labels, label_mask = graph
    cfg, jcfg = _cfgs("smoke")
    cfg = dataclasses.replace(cfg, graph_level=graph_level)
    jcfg = dataclasses.replace(jcfg, graph_level=graph_level)
    params = _jax_params(jcfg, 1)
    ei, m = to_directed_padded(edges, N, pad_to=2 * len(edges) + 5)
    jei, jm = j_to_directed(edges, N, pad_to=2 * len(edges) + 5)
    np.testing.assert_array_equal(ei, jei)
    np.testing.assert_array_equal(m, jm)
    gid = np.arange(N) % 3
    want = jgin.forward(params, JGraphData(
        jnp.asarray(feats), jnp.asarray(ei), jnp.asarray(m),
        graph_ids=jnp.asarray(gid), n_graphs=3), jcfg)
    model = gin.params_from_numpy(gin.GIN(cfg), params)
    got = model(GraphData(torch.from_numpy(feats), torch.from_numpy(ei),
                          torch.from_numpy(m),
                          graph_ids=torch.from_numpy(gid), n_graphs=3))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(tree_leaves(gin.params_to_numpy(model)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, w)
    # the masked segment sum on its own: the padding edges add nothing
    np.testing.assert_allclose(
        segment_agg(torch.from_numpy(feats[ei[0]]), torch.from_numpy(ei[1]),
                    N, "sum", torch.from_numpy(m)).numpy(),
        np.asarray(j_segment_agg(jnp.asarray(feats[ei[0]]),
                                 jnp.asarray(ei[1]), N, "sum",
                                 jnp.asarray(m))), rtol=1e-6, atol=1e-6)
    if not graph_level:
        lm = torch.from_numpy(label_mask)
        np.testing.assert_allclose(
            float(cross_entropy(got.detach(), torch.from_numpy(labels), lm)),
            float(j_cross_entropy(want, jnp.asarray(labels),
                                  jnp.asarray(label_mask))), rtol=1e-6)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_optimizer_update_matches_reference(kind):
    """Three updates of a random tree with large gradients (the clip is
    active: the global norm is far above 1)."""
    rng = np.random.default_rng(5)
    params = {"a": [rng.normal(size=(3, 4)), rng.normal(size=(4,))],
              "b": {"c": np.array(rng.normal()), "d": rng.normal(size=(2, 5))}}
    params = tree_map(lambda a: a.astype(np.float32), params)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, kind=kind)
    jcfg, cfg = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tpar = tree_map(lambda a: torch.tensor(np.asarray(a)), params)
    jstate, tstate = jopt.init(jp, jcfg), opt.init(tpar, cfg)
    for step in range(3):
        grads = tree_map(lambda a: (rng.normal(size=np.shape(a)) * 10)
                         .astype(np.float32), params)
        jp, jstate, jstats = jopt.update(
            jax.tree.map(jnp.asarray, grads), jstate, jp, jcfg)
        tpar, tstate, tstats = opt.update(
            tree_map(torch.tensor, grads), tstate, tpar, cfg)
        assert float(tstats["grad_norm"]) > 1.0
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6)
        for g, w in zip(tree_leaves((tpar, tstate)),
                        jax.tree.leaves((jp, jstate))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                       atol=1e-7)
    assert int(tstate["step"]) == 3 and tstate["step"].dtype == torch.int32


# --------------------------------------------------------------------------
# the engine at one rank, in this process
# --------------------------------------------------------------------------

def _oracle(sg, mirror_vals, owned_vals):
    """The primitives' results from each vertex's mirrors and master
    alone: reductions in rank order, as the engine receives them."""
    d_num, o = sg.owned_glob.shape
    f = mirror_vals.shape[-1]
    where = {int(g): (t, i) for t in range(d_num)
             for i, g in enumerate(sg.owned_glob[t]) if sg.owned_mask[t, i]}
    idents = {"sum": 0.0, "min": np.inf, "max": -np.inf}
    fns = {"sum": np.add, "min": np.minimum, "max": np.maximum}
    m2m = {op: np.full((d_num, o, f), x, np.float32)
           for op, x in idents.items()}
    bcast = np.zeros(mirror_vals.shape, np.float32)
    for d in range(d_num):
        for m in np.nonzero(sg.mirror_mask[d])[0]:
            t, i = where[int(sg.mirror_glob[d, m])]
            for op, fn in fns.items():
                m2m[op][t, i] = fn(m2m[op][t, i], mirror_vals[d, m])
            bcast[d, m] = owned_vals[t, i]
    return m2m, bcast


def _prim_vals(sg, seed):
    rng = np.random.default_rng(seed)
    d_num, r = sg.mirror_glob.shape
    return (rng.normal(size=(d_num, r, 5)).astype(np.float32),
            rng.normal(size=(d_num, sg.owned_glob.shape[1], 5))
            .astype(np.float32))


def _assert_prims(outs, sg, prim_vals):
    m2m, bcast = _oracle(sg, *prim_vals)
    for rank, out in enumerate(outs):
        for op in ("min", "max"):
            np.testing.assert_array_equal(out["m2m"][op], m2m[op][rank])
        np.testing.assert_allclose(out["m2m"]["sum"], m2m["sum"][rank],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["bcast"], bcast[rank])


def test_engine_primitives_world1(graph):
    edges = graph[0]
    sg = eng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), N, 1)
    prim_vals = _prim_vals(sg, 0)
    a = {k: torch.from_numpy(getattr(sg, k)[0])
         for k in ("send_idx", "send_mask", "recv_owned", "edges_ml",
                   "emask")}
    lanes = (a["send_idx"], a["send_mask"], a["recv_owned"])
    caps = sg.caps
    mv, ov = (torch.from_numpy(v[0]) for v in prim_vals)
    with compat.world1("gloo"):
        out = {"m2m": {op: eng.mirror_to_master(mv, *lanes, caps["O"], op, x)
                       .numpy() for op, x in (("sum", 0.0), ("min", np.inf),
                                              ("max", -np.inf))},
               "bcast": eng.master_to_mirror(ov, *lanes, caps["R"]).numpy()}
    _assert_prims([out], sg, prim_vals)
    # scatter_edges against the reference's, all three reductions
    msg = np.random.default_rng(1).normal(size=(2, caps["C"], 3)).astype(
        np.float32)
    for op, x in (("sum", 0.0), ("min", np.inf), ("max", -np.inf)):
        want = jeng.scatter_edges(msg[0], msg[1], sg.edges_ml[0], sg.emask[0],
                                  caps["R"], op, x)
        got = eng.scatter_edges(torch.from_numpy(msg[0]),
                                torch.from_numpy(msg[1]), a["edges_ml"],
                                a["emask"], caps["R"], op, x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def world1_reference(request, graph):
    """The reference's make_engine_loss on a 1-device mesh: loss and
    gradients, and the losses and params of STEPS AdamW steps."""
    edges, feats, labels, label_mask = graph
    cfg, jcfg = _cfgs(request.param)
    params = _jax_params(jcfg, 2)
    sg = jeng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), N,
                                  1)
    caps = jge.caps_from_sharded_graph(sg, D_FEAT, N_CLASSES)
    arrays = jge.engine_arrays(sg, feats, labels, label_mask, None)
    mesh = jcompat.make_mesh((1,), ("data",))
    loss_fn = jge.make_engine_loss("gin", jcfg, caps, mesh, ("data",),
                                   has_positions=False)
    vg = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, arrays)))
    loss, grads = vg(params)
    losses, trained = _jax_train(vg, params, STEPS)
    return cfg, params, float(loss), grads, losses, trained


def test_engine_gin_world1_matches_make_engine_loss(graph, world1_reference):
    edges, feats, labels, label_mask = graph
    cfg, params, loss, grads, losses, trained = world1_reference
    ep = np.zeros(len(edges), np.int32)
    sg = eng.build_sharded_graph(edges, ep, N, 1)
    caps = ge.caps_from_sharded_graph(sg, D_FEAT, N_CLASSES)
    model = gin.params_from_numpy(gin.GIN(cfg), params)
    with compat.world1("gloo"):
        a = ge.engine_arrays(sg, feats, labels, label_mask, 0, "cpu")
        got = ge.loss_and_grads(model, a, caps)
        np.testing.assert_allclose(float(got), loss, rtol=1e-5)
        _assert_grads_close(tree_map(lambda p: p.grad.numpy(),
                                     model.param_tree()), grads)
        model = gin.params_from_numpy(gin.GIN(cfg), params)
        got_losses = ge.train_engine_gin(edges, ep, N, feats, labels,
                                         label_mask, model,
                                         opt.OptConfig(**OPT_KW), STEPS,
                                         device="cpu")
    _assert_trained_close(got_losses, gin.params_to_numpy(model), losses,
                          trained)


def test_train_engine_gin_needs_a_group(graph):
    edges, feats, labels, label_mask = graph
    cfg, _ = _cfgs("smoke")
    with pytest.raises((RuntimeError, ValueError)):
        ge.train_engine_gin(edges, np.zeros(len(edges), np.int32), N, feats,
                            labels, label_mask, gin.GIN(cfg),
                            opt.OptConfig(**OPT_KW), 1, device="cpu")


# --------------------------------------------------------------------------
# 2 and 4 ranks: gloo processes against the plain reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plain_reference(graph):
    """Per width: params, the plain loss and gradients; and STEPS AdamW
    steps of the plain loss from the full width's params."""
    out = {}
    for name in sorted(WIDTHS):
        cfg, jcfg = _cfgs(name)
        params = _jax_params(jcfg, 3)
        vg = jax.jit(jax.value_and_grad(_plain_loss_fn(graph, jcfg)))
        loss, grads = vg(params)
        out[name] = (cfg, params, float(loss), grads)
    out["trained"] = _jax_train(vg, out["full"][1], STEPS)
    return out


@pytest.fixture(scope="module", params=WORLDS)
def engine_ranks(request, graph, plain_reference):
    d = request.param
    edges, feats, labels, label_mask = graph
    ep = _edge_part(edges, d)
    sg = eng.build_sharded_graph(edges, ep, N, d)
    prim_vals = _prim_vals(sg, d)
    models = [plain_reference[w][:2] for w in ("smoke", "full")]
    outs = compat.spawn(torch_spmd_ranks.engine_checks, d, "gloo", edges, N,
                        ep, feats, labels, label_mask, prim_vals, models,
                        opt.OptConfig(**OPT_KW), STEPS)
    return d, sg, prim_vals, outs


def test_engine_primitives_across_ranks(engine_ranks):
    d, sg, prim_vals, outs = engine_ranks
    assert len(outs) == d
    _assert_prims(outs, sg, prim_vals)


def test_engine_gin_across_ranks_matches_plain_model(engine_ranks,
                                                     plain_reference):
    _, _, _, outs = engine_ranks
    for out in outs:                # every rank holds the same numbers
        for got, name in zip(out["models"], ("smoke", "full")):
            _, _, loss, grads = plain_reference[name]
            np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
            _assert_grads_close(got["grads"], grads)
        _assert_trained_close(out["losses"], out["params"],
                              *plain_reference["trained"])
