"""The port's PNA, EGNN and EquiformerV2, plain and over the vertex-cut
engine, against the reference.

Configs equal the reference's.  The plain models' logits (smoke width,
node- and graph-level, and PNA and EGNN at full width, EquiformerV2 with 2
of its 12 layers at full width) and the segment reductions they use
(values and gradients, at ties too) are held to the reference's.  The
engine forwards' loss and gradients are held at one rank (in this
process, a gloo group) to ``jax.grad`` of the reference's
``make_engine_loss`` on a 1-device mesh, and at 2 and 4 ranks (spawned
gloo processes, rank bodies in ``torch_spmd_ranks``) to the plain model's
loss and gradients, as ``tests/spmd/run_spmd_checks.py`` holds the
reference's engine.  PNA's max and min are also checked on a graph whose
messages tie.

Tolerances, float32 throughout: the port's matrix products and sums run
in another order than XLA's (and across ranks), so logits agree to 1e-5
of the largest, a loss to 1e-5 relative (the reference holds its engine
to 1e-3 absolute) and a gradient leaf to 1e-5 of its largest entry, PNA's
at full width to 1e-4 (``PNA_FULL_GRAD``).  The
Wigner-D blocks come from a recursion whose rounding error grows with
l: they agree to 1e-5 absolute at l_max 3 and to 5e-5 at l_max 6 (XLA
contracts products and sums into FMAs, torch does not), and are
orthogonal to 1e-5 and 5e-5.
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
from repro.models.gnn import common as jcommon
from repro.models.gnn import egnn as jegnn
from repro.models.gnn import equiformer_v2 as jeq
from repro.models.gnn import pna as jpna
from repro.models.gnn import wigner as jwigner
from repro.models.gnn.common import GraphData as JGraphData
from repro_torch.apps import engine as eng
from repro_torch.configs import egnn as c_egnn
from repro_torch.configs import equiformer_v2 as c_eq
from repro_torch.configs import pna as c_pna
from repro_torch.core import partitioner as tp
from repro_torch.core.graph import from_edges
from repro_torch.dist import compat
from repro_torch.launch import gnn_engine as ge
from repro_torch.models.common import (cross_entropy, params_from_numpy,
                                       params_to_numpy)
from repro_torch.models.gnn import common
from repro_torch.models.gnn import equiformer_v2 as eq
from repro_torch.models.gnn import wigner
from repro_torch.models.gnn.common import GraphData, to_directed_padded
from repro_torch.tree import tree_leaves, tree_map

N, ATTACH, D_FEAT, N_CLASSES = 200, 3, 12, 4
WORLDS = (2, 4)
# PNA at full width: both packages' float32 gradients lie up to 4.1e-5 of
# a leaf's largest entry from the port's float64 run (its std aggregation
# takes sq/cnt - mean², which cancels), so they are held to each other at
# 1e-4 there
PNA_FULL_GRAD = 1e-4
# family → (the port's configs module, the reference's model module)
FAMILIES = {"pna": (c_pna, jpna), "egnn": (c_egnn, jegnn),
            "equiformer_v2": (c_eq, jeq)}
JCONFIGS = {"pna": jpna.PNAConfig, "egnn": jegnn.EGNNConfig,
            "equiformer_v2": jeq.EquiformerV2Config}


@pytest.fixture(scope="module")
def graph():
    """BA(200, 3): every vertex has an edge; seeded features, positions,
    labels, and an 80 % label mask."""
    edges = np.array(jgen.barabasi_albert(N, ATTACH, seed=0).edges)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N, D_FEAT)).astype(np.float32)
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, N).astype(np.int32)
    label_mask = rng.random(N) < 0.8
    return edges, feats, pos, labels, label_mask


def _cfgs(family, width="SMOKE", **kw):
    """(the port's config, the reference's) of a family at a width."""
    kw = dict(d_feat=D_FEAT, n_classes=N_CLASSES, **kw)
    cfg = dataclasses.replace(getattr(FAMILIES[family][0], width), **kw)
    return cfg, JCONFIGS[family](**dataclasses.asdict(cfg))


def _model(family, cfg, params):
    return params_from_numpy(torch_spmd_ranks.FAMILIES[family](cfg), params)


def _jax_params(family, jcfg, seed):
    mod = FAMILIES[family][1]
    return jax.tree.map(np.asarray,
                        mod.init_params(jax.random.PRNGKey(seed), jcfg))


def _graphs(edges, feats, pos, pad=5, graph_ids=None, n_graphs=1):
    """The same padded directed graph for both packages."""
    ei, m = to_directed_padded(edges, N, pad_to=2 * len(edges) + pad)
    jg = JGraphData(jnp.asarray(feats), jnp.asarray(ei), jnp.asarray(m),
                    positions=jnp.asarray(pos),
                    graph_ids=None if graph_ids is None
                    else jnp.asarray(graph_ids), n_graphs=n_graphs)
    tg = GraphData(torch.from_numpy(feats), torch.from_numpy(ei),
                   torch.from_numpy(m), positions=torch.from_numpy(pos),
                   graph_ids=None if graph_ids is None
                   else torch.from_numpy(graph_ids), n_graphs=n_graphs)
    return jg, tg


def _grads(model):
    """The parameters' gradients as numpy, zeros where the loss does not
    reach a parameter (EGNN's last phi_x), as jax.grad gives."""
    return tree_map(lambda p: np.zeros(p.shape, np.float32) if p.grad is None
                    else p.grad.numpy(), model.param_tree())


def _assert_grads_close(got, want, rel=1e-5):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-12)


def _plain_reference(family, jcfg, params, jg, labels, label_mask):
    """The reference's plain masked cross-entropy and its gradients."""
    mod = FAMILIES[family][1]

    def loss_fn(p):
        return j_cross_entropy(mod.forward(p, jg, jcfg), jnp.asarray(labels),
                               jnp.asarray(label_mask))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), grads


# --------------------------------------------------------------------------
# configs, segment ops, Wigner-D blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_configs_are_the_references(family):
    import importlib

    ref = importlib.import_module(f"repro.configs.{family}")
    port = FAMILIES[family][0]
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(port, name)) == \
            dataclasses.asdict(getattr(ref, name))
    assert (port.FAMILY, port.MODEL) == (ref.FAMILY, ref.MODEL)
    assert torch_spmd_ranks.FAMILIES[port.MODEL].MODEL == port.MODEL
    assert port.CONFIG.__class__.__name__ == ref.CONFIG.__class__.__name__


def _tied_messages(seed):
    """(E, 3) messages into 6 segments with exact ties: duplicated rows
    and zeros, and a masked row; a random cotangent."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(10, 3)).astype(np.float32)
    base[3] = 0.0
    msgs = np.concatenate([base, base[:4], np.zeros((2, 3), np.float32)])
    dst = np.concatenate([np.arange(10) % 5, np.arange(4) % 5, [4, 4]])
    mask = np.ones(len(dst), bool)
    mask[7] = False
    cot = rng.normal(size=(6, 3)).astype(np.float32)
    return msgs, dst.astype(np.int32), mask, cot


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_segment_agg_and_its_gradient_match_reference(op):
    """Values and the gradient of <out, cotangent>; the max and min split
    a tie's gradient evenly among the tied messages, as jax.grad does."""
    msgs, dst, mask, cot = _tied_messages(1)
    n = 6

    def jfn(x):
        return (jcommon.segment_agg(x, jnp.asarray(dst), n, op,
                                    jnp.asarray(mask)) * cot).sum()
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(msgs))
    x = torch.from_numpy(msgs).requires_grad_()
    out = common.segment_agg(x, torch.from_numpy(dst), n, op,
                             torch.from_numpy(mask))
    total = (out * torch.from_numpy(cot)).sum()
    total.backward()
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-7)
    if op in ("max", "min"):        # a two-way tie took half each
        assert np.isclose(np.asarray(want_g), cot[dst] / 2).any()


def test_segment_softmax_degrees_readout_match_reference():
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(30, 4)).astype(np.float32)
    dst = rng.integers(0, 8, 30).astype(np.int32)
    mask = rng.random(30) < 0.8
    cot = rng.normal(size=(30, 4)).astype(np.float32)

    def jfn(s):
        return (jcommon.segment_softmax(s, jnp.asarray(dst), 9,
                                        jnp.asarray(mask)) * cot).sum()
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(scores))
    x = torch.from_numpy(scores).requires_grad_()
    got = (common.segment_softmax(x, torch.from_numpy(dst), 9,
                                  torch.from_numpy(mask))
           * torch.from_numpy(cot)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)
    ei = np.stack([dst, dst[::-1]])
    np.testing.assert_array_equal(
        common.degrees(torch.from_numpy(ei), 9, torch.from_numpy(mask))
        .numpy(),
        np.asarray(jcommon.degrees(jnp.asarray(ei), 9, jnp.asarray(mask))))
    gid = rng.integers(0, 3, 30).astype(np.int32)
    for op in ("sum", "mean"):
        np.testing.assert_allclose(
            common.graph_readout(torch.from_numpy(scores),
                                 torch.from_numpy(gid), 3, op).numpy(),
            np.asarray(jcommon.graph_readout(jnp.asarray(scores),
                                             jnp.asarray(gid), 3, op)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("l_max,tol", [(3, 1e-5), (6, 5e-5)])
def test_wigner_blocks_match_reference(l_max, tol):
    """Random edge directions (and the axis-near ones that switch the
    frame's reference vector): the frame rotation, the blocks and their
    block-diagonal apply, forward and transposed."""
    rng = np.random.default_rng(l_max)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[:4] = [[1, 0, 0], [-1, 0, 0], [0.95, 0.1, 0.2], [0, 0, 1]]
    r_hat = v / np.linalg.norm(v, axis=-1, keepdims=True)
    want_rot = np.asarray(jwigner.rotation_to_edge_frame(jnp.asarray(r_hat)))
    rot = wigner.rotation_to_edge_frame(torch.from_numpy(r_hat))
    np.testing.assert_allclose(rot.numpy(), want_rot, rtol=0, atol=1e-6)
    want = jwigner.wigner_d_blocks(jnp.asarray(want_rot), l_max)
    got = wigner.wigner_d_blocks(torch.tensor(want_rot), l_max)
    assert len(got) == len(want) == l_max + 1
    for l, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape == (64, 2 * l + 1, 2 * l + 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol)
        eye = g @ g.transpose(-1, -2)
        np.testing.assert_allclose(eye.numpy(), np.broadcast_to(
            np.eye(2 * l + 1), eye.shape), rtol=0, atol=tol)
    assert wigner.sh_offsets(l_max) == jwigner.sh_offsets(l_max)
    feats = rng.normal(size=(64, (l_max + 1) ** 2, 5)).astype(np.float32)
    for transpose in (False, True):
        np.testing.assert_allclose(
            wigner.apply_blocks(got, torch.from_numpy(feats),
                                transpose).numpy(),
            np.asarray(jwigner.apply_blocks(want, jnp.asarray(feats),
                                            transpose)),
            rtol=0, atol=10 * tol)
    g0, pairs = eq._m_groups(l_max, 2)
    jg0, jpairs = jeq._m_groups(l_max, 2)
    np.testing.assert_array_equal(g0, jg0)
    for (p, m), (jp, jm) in zip(pairs, jpairs, strict=True):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(m, jm)


@pytest.mark.parametrize("l_max", [3, 6])
def test_invariant_scores_equal_the_messages_row0(l_max):
    """The engine's score pass (``invariant_scores``: the m = 0 rows and
    w0's first C columns) against the scores of the whole messages' row
    0, at d 128 and 8 heads: float32 sums over another split of the same
    products, to 1e-5 of the largest score."""
    cfg = dataclasses.replace(c_eq.CONFIG, l_max=l_max, n_layers=1)
    lp = eq.EquiformerV2(cfg, torch.Generator().manual_seed(l_max)).layers[0]
    rng = np.random.default_rng(l_max)
    pos = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 40, 300))
    dst = torch.from_numpy(rng.integers(0, 40, 300))
    f_src = torch.from_numpy(rng.normal(
        size=(300, cfg.n_coeff, cfg.d_hidden)).astype(np.float32))
    blocks, rbf = eq.edge_geometry(pos, src, dst, cfg)
    with torch.no_grad():
        got = eq.invariant_scores(lp, f_src, blocks, rbf, cfg)
        msg = eq._so2_conv(lp, wigner.apply_blocks(blocks, f_src), rbf, cfg)
        want = torch.nn.functional.leaky_relu(msg[:, 0, :] @ lp.score, 0.2)
    assert got.shape == want.shape == (300, cfg.n_heads)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# --------------------------------------------------------------------------
# the plain models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("graph_level", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_forward_matches_reference(graph, family, graph_level):
    edges, feats, pos, _, _ = graph
    cfg, jcfg = _cfgs(family, graph_level=graph_level)
    params = _jax_params(family, jcfg, 1)
    gid = np.arange(N, dtype=np.int32) % 3
    jg, tg = _graphs(edges, feats, pos, graph_ids=gid, n_graphs=3)
    want = np.asarray(FAMILIES[family][1].forward(params, jg, jcfg))
    model = _model(family, cfg, params)
    got = model(tg).detach().numpy()
    assert got.shape == want.shape == ((3 if graph_level else N), N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for g, w in zip(tree_leaves(params_to_numpy(model)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_forward_full_width_matches_reference(graph, family):
    """CONFIG's widths (EquiformerV2: d 128, l_max 6, m_max 2, 8 heads,
    with 2 of its 12 layers), logits and the loss's gradients."""
    edges, feats, pos, labels, label_mask = graph
    kw = {"n_layers": 2} if family == "equiformer_v2" else {}
    cfg, jcfg = _cfgs(family, "CONFIG", **kw)
    params = _jax_params(family, jcfg, 4)
    jg, tg = _graphs(edges, feats, pos)
    loss, grads = _plain_reference(family, jcfg, params, jg, labels,
                                   label_mask)
    model = _model(family, cfg, params)
    got = cross_entropy(model(tg), torch.from_numpy(labels),
                        torch.from_numpy(label_mask))
    got.backward()
    np.testing.assert_allclose(got.item(), loss, rtol=1e-5)
    _assert_grads_close(_grads(model), grads,
                        PNA_FULL_GRAD if family == "pna" else 1e-5)


# --------------------------------------------------------------------------
# the engine at one rank, in this process
# --------------------------------------------------------------------------

def _engine_reference(family, jcfg, params, sg, feats, pos, labels,
                      label_mask):
    """jax.value_and_grad of the reference's make_engine_loss on a
    1-device mesh."""
    caps = jge.caps_from_sharded_graph(sg, D_FEAT, N_CLASSES)
    arrays = jge.engine_arrays(sg, feats, labels, label_mask, pos)
    mesh = jcompat.make_mesh((1,), ("data",))
    loss_fn = jge.make_engine_loss(family, jcfg, caps, mesh, ("data",),
                                   has_positions=True)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, arrays)))(params)
    return float(loss), grads


def _engine_world1(family, cfg, params, edges, feats, pos, labels,
                   label_mask, **kw):
    sg = eng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), N, 1)
    caps = ge.caps_from_sharded_graph(sg, D_FEAT, N_CLASSES)
    model = _model(family, cfg, params)
    with compat.world1("gloo"):
        a = ge.engine_arrays(sg, feats, labels, label_mask, 0, "cpu", pos)
        if kw:            # another chunking: the forward, no gradients
            logits = ge.ENGINE_FWD[family](model, a, caps, **kw)
            return cross_entropy(logits, a["labels"], a["label_mask"]), None
        loss = ge.loss_and_grads(model, a, caps)
    return float(loss), tree_map(lambda p: p.grad.numpy(),
                                 model.param_tree())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_world1_matches_make_engine_loss(graph, family):
    edges, feats, pos, labels, label_mask = graph
    cfg, jcfg = _cfgs(family)
    params = _jax_params(family, jcfg, 2)
    jsg = jeng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), N,
                                   1)
    loss, grads = _engine_reference(family, jcfg, params, jsg, feats, pos,
                                    labels, label_mask)
    got, got_grads = _engine_world1(family, cfg, params, edges, feats, pos,
                                    labels, label_mask)
    np.testing.assert_allclose(got, loss, rtol=1e-5)
    _assert_grads_close(got_grads, grads)


def test_pna_ties_route_gradients_as_jax(graph):
    """Vertices in groups of 4 share their features, so messages from a
    group to a common neighbour tie exactly, in max and in min; every
    feature row is also 0 in a few columns.  The engine's two-stage max
    and min (mirrors, then masters) and the plain model's one-stage ones
    must route the tied gradient as jax.grad of the reference does."""
    edges, _, pos, labels, label_mask = graph
    rng = np.random.default_rng(9)
    feats = np.repeat(rng.normal(size=(N // 4, D_FEAT)), 4, axis=0)
    feats[:, :3] = 0.0
    feats = feats.astype(np.float32)
    cfg, jcfg = _cfgs("pna")
    params = _jax_params("pna", jcfg, 5)
    # ties exist: vertices with two neighbours in one group receive equal
    # first-layer messages from them
    (src, dst), _ = to_directed_padded(edges, N)
    _, counts = np.unique(dst * N + src // 4, return_counts=True)
    assert (counts > 1).sum() > 10
    jsg = jeng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), N,
                                   1)
    loss, grads = _engine_reference("pna", jcfg, params, jsg, feats, pos,
                                    labels, label_mask)
    got, got_grads = _engine_world1("pna", cfg, params, edges, feats, pos,
                                    labels, label_mask)
    np.testing.assert_allclose(got, loss, rtol=1e-5)
    _assert_grads_close(got_grads, grads)
    jg, tg = _graphs(edges, feats, pos)
    loss, grads = _plain_reference("pna", jcfg, params, jg, labels,
                                   label_mask)
    model = _model("pna", cfg, params)
    plain = cross_entropy(model(tg), torch.from_numpy(labels),
                          torch.from_numpy(label_mask))
    plain.backward()
    np.testing.assert_allclose(plain.item(), loss, rtol=1e-5)
    _assert_grads_close(_grads(model), grads)


def test_eqv2_engine_chunking_keeps_the_loss(graph):
    """Chunks of 64 directed edges (several, the last one short) against
    one chunk of all of them, and the plain model."""
    edges, feats, pos, labels, label_mask = graph
    cfg, jcfg = _cfgs("equiformer_v2")
    params = _jax_params("equiformer_v2", jcfg, 3)
    args = (params, edges, feats, pos, labels, label_mask)
    with torch.no_grad():
        small, _ = _engine_world1("equiformer_v2", cfg, *args, edge_chunk=64)
        whole, _ = _engine_world1("equiformer_v2", cfg, *args,
                                  edge_chunk=1 << 14)
        jg, tg = _graphs(edges, feats, pos)
        plain = cross_entropy(_model("equiformer_v2", cfg, params)(tg),
                              torch.from_numpy(labels),
                              torch.from_numpy(label_mask))
    np.testing.assert_allclose(float(small), float(whole), rtol=1e-6)
    np.testing.assert_allclose(float(small), float(plain), rtol=1e-5)


# --------------------------------------------------------------------------
# 2 and 4 ranks: gloo processes against the plain reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plain_references(graph):
    edges, feats, pos, labels, label_mask = graph
    jg, _ = _graphs(edges, feats, pos)
    out = {}
    for family in sorted(FAMILIES):
        cfg, jcfg = _cfgs(family)
        params = _jax_params(family, jcfg, 6)
        out[family] = (cfg, params) + _plain_reference(
            family, jcfg, params, jg, labels, label_mask)
    return out


@pytest.fixture(scope="module", params=WORLDS)
def family_ranks(request, graph, plain_references):
    d = request.param
    edges, feats, pos, labels, label_mask = graph
    ep = tp.partition(from_edges(edges, N, device="cpu"),
                      tp.NEConfig(num_partitions=d, seed=0)).edge_part
    models = [(f, cfg, params)
              for f, (cfg, params, _, _) in sorted(plain_references.items())]
    outs = compat.spawn(torch_spmd_ranks.gnn_family_checks, d, "gloo", edges,
                        N, ep, feats, labels, label_mask, pos, models)
    return d, outs


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_across_ranks_matches_plain_model(family_ranks,
                                                 plain_references, family):
    d, outs = family_ranks
    assert len(outs) == d
    i = sorted(FAMILIES).index(family)
    _, _, loss, grads = plain_references[family]
    for out in outs:                # every rank holds the same numbers
        np.testing.assert_allclose(out[i]["loss"], loss, rtol=1e-5)
        _assert_grads_close(out[i]["grads"], grads)


@pytest.mark.parametrize("family", ["pna", "egnn"])
def test_step_time_tool_trains_on_the_cpu(family):
    """``tools/step_time.py`` at the GNN cell's size, one step after its
    warm-up on the CPU: finite losses, the first the engine loss of the
    untrained model (the same as the plain model's)."""
    from repro_torch.tools import step_time

    data = step_time.cell_data()
    out = step_time.time_family(family, 1, torch.device("cpu"), data)
    assert out["family"] == family and out["steps"] == 1
    assert out["peak_bytes"] is None
    assert np.isfinite([out["ms_a_step"], out["loss_first"],
                        out["loss_last"]]).all()
    edges, feats, labels, label_mask, pos = data
    conf = FAMILIES[family][0]
    cfg = dataclasses.replace(conf.CONFIG, d_feat=feats.shape[1],
                              n_classes=int(labels.max()) + 1)
    model = torch_spmd_ranks.FAMILIES[family](
        cfg, torch.Generator().manual_seed(0))
    ei, em = to_directed_padded(edges, feats.shape[0])
    g = GraphData(torch.from_numpy(feats), torch.from_numpy(ei),
                  torch.from_numpy(em), positions=torch.from_numpy(pos))
    with torch.no_grad():
        plain = cross_entropy(model(g), torch.from_numpy(labels),
                              torch.from_numpy(label_mask))
    np.testing.assert_allclose(out["loss_first"], float(plain), rtol=1e-5)
