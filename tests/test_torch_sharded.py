"""The port's sharded paths at 4 gloo ranks against the reference package
at 4 host devices, and every mesh step at a mesh of one rank against its
mesh-free step.

The inputs are made here from seeds (the reference's initial parameters
and optimizer state, as numpy arrays) and pickled; one module fixture
runs the reference on them in a subprocess (this file run as a script,
``--xla_force_host_platform_device_count=4``, as
tests/spmd/run_spmd_checks.py does), while another runs the port's four
ranks (``dist.compat.spawn``, rank bodies in ``torch_sharded_ranks``).
Each check is a test of its own:

- the MoE's expert-parallel branch on mesh (2, 2) at capacity 4.0 and
  0.5: y, aux and the gradients of Σy² + aux against the reference's EP
  branch (whose aux is the mean of the batch shards' own, not the dense
  block's);
- the row-sharded ``sharded_lookup`` and DeepFM's forward and table
  gradient on mesh (2, 2);
- split-KV decode on mesh (1, 4) (2 kv heads: the sequence over "model")
  and on mesh (2, 2) at batch 1 (over both axes), cache_len inside the
  last slice, at slice boundaries and inside the first slice (the later
  slices empty): the logits and the gathered caches;
- two train steps of olmoe-smoke, smollm-smoke and DeepFM smoke through
  ``make_step`` on mesh (2, 2) against the reference's step jitted with
  its in_shardings under its mesh context; GIN's full-graph step through
  ``make_gnn_step``'s engine branch against the reference's engine.

Tolerances: 1e-5 (absolute, or of each leaf's largest value).

    python tests/test_torch_sharded.py IN.pkl OUT.pkl  # the reference
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharded_ranks as ranks_mod
from repro_torch.configs import registry as treg
from repro_torch.dist import compat
from repro_torch.dist.context import mesh_context
from repro_torch.launch import gnn_engine as ge
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import moe as tmoe
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_from_numpy, tree_leaves, tree_to_numpy

ROOT = Path(__file__).resolve().parent.parent
CAPS = (4.0, 0.5)
CACHE_LENS = (27, 15, 16, 3)       # S 32 in 4 slices of 8
TOL = 1e-5


# --------------------------------------------------------------------------
# inputs (numpy, from seeds; the reference's parameters)
# --------------------------------------------------------------------------

def _make_inputs() -> dict:
    import jax

    from repro.configs import registry as jreg
    from repro.launch import steps as jsteps
    from repro.models.lm import transformer as jtf
    from repro.models.recsys import deepfm as jdeepfm
    from repro.train import optimizer as jopt

    rng = np.random.default_rng(7)
    inp = {}
    e, d, f = 8, 24, 16
    inp["moe"] = {"caps": CAPS, "x": rng.normal(size=(4, 6, d)).astype(
        np.float32), "p": {
        "router": (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32),
        "wi": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
        "wg": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
        "wo": (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32)}}

    dcfg = jreg.get_arch("deepfm").smoke_config
    inp["lookup"] = {
        "table": rng.normal(size=(16, 8)).astype(np.float32),
        "ids": rng.integers(0, 16, (4, 5)).astype(np.int32),
        "deepfm_params": jax.tree.map(np.asarray, jdeepfm.init_params(
            jax.random.PRNGKey(3), dcfg)),
        "deepfm_x": rng.integers(0, 3 * dcfg.rows_per_field,
                                 (8, dcfg.n_fields)).astype(np.int32),
        "deepfm_y": (rng.random(8) < 0.3).astype(np.float32)}

    jdec = dataclasses.replace(_j_dec_cfg())
    inp["split_kv"] = {
        "dec_params": jax.tree.map(np.asarray, jtf.init_params(
            jax.random.PRNGKey(3), jdec)),
        "kc": (0.3 * rng.normal(size=(2, 2, 32, 2, 8))).astype(np.float32),
        "vc": (0.3 * rng.normal(size=(2, 2, 32, 2, 8))).astype(np.float32),
        "tok": np.array([[7], [11]], np.int32), "cache_lens": CACHE_LENS}

    inp["train"] = {}
    for arch, sid in ranks_mod.TRAIN_ARCHS.items():
        jspec = jreg.get_arch(arch)
        params = jax.tree.map(np.asarray, _j_init(jspec))
        state = jax.tree.map(np.asarray, jopt.init(params, jsteps.OPT_CFG))
        tb = steps.make_step(treg.get_arch(arch), sid, smoke=True)
        batches = [_batch(jspec.smoke_config, tb.args[2:], 10 + i)
                   for i in range(2)]
        inp["train"][arch] = {"params": params, "state": state,
                              "batches": batches}

    inp["gin"] = _gin_inputs(rng)
    return inp


def _j_dec_cfg():
    import jax.numpy as jnp

    from repro.models.lm import transformer as jtf

    return jtf.LMConfig(name="dec", n_layers=2, d_model=32, n_heads=8,
                        n_kv_heads=2, d_ff=64, vocab=64, head_dim=8,
                        dtype=jnp.float32, remat="none")


def _j_init(jspec):
    import jax

    if jspec.family == "lm":
        from repro.models.lm.transformer import init_params
    else:
        from repro.models.recsys.deepfm import init_params
    return jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jspec.smoke_config)


def _batch(cfg, args, seed):
    rng = np.random.default_rng(seed)
    if hasattr(cfg, "vocab"):
        return [rng.integers(0, cfg.vocab, tuple(args[0].shape)).astype(
            np.int32)]
    x, y = args
    return [rng.integers(0, 3 * cfg.rows_per_field, tuple(x.shape)).astype(
        np.int32), (rng.random(tuple(y.shape)) < 0.3).astype(np.float32)]


def _gin_inputs(rng) -> dict:
    import jax

    from repro.configs import registry as jreg
    from repro.models.gnn import gin as jgin

    n, m = 60, 200
    pairs = set()
    while len(pairs) < m:
        u, v = sorted(int(a) for a in rng.integers(0, n, 2))
        if u != v:
            pairs.add((u, v))
    edges = np.array(sorted(pairs), np.int32)
    ncls, dfeat = 4, 12
    jcfg = dataclasses.replace(jreg.get_arch("gin-tu").smoke_config,
                               d_feat=dfeat, n_classes=ncls)
    return {"edges": edges, "n": n, "n_classes": ncls,
            "edge_part": rng.integers(0, 4, m).astype(np.int32),
            "feats": rng.normal(size=(n, dfeat)).astype(np.float32),
            "labels": rng.integers(0, ncls, n).astype(np.int32),
            "label_mask": rng.random(n) < 0.8,
            "positions": rng.normal(size=(n, 3)).astype(np.float32),
            "params": jax.tree.map(np.asarray, jgin.init_params(
                jax.random.PRNGKey(2), jcfg))}


# --------------------------------------------------------------------------
# the reference at 4 host devices (this file run as a script)
# --------------------------------------------------------------------------

def _reference(inp) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.apps import engine as jeng
    from repro.configs import registry as jreg
    from repro.dist import compat as jc
    from repro.dist.context import mesh_context as jmc
    from repro.dist.sharding import lm_rules
    from repro.launch import gnn_engine as jge
    from repro.launch import steps as jsteps
    from repro.models.lm import moe as jmoe
    from repro.models.lm import transformer as jtf
    from repro.models.recsys import deepfm as jdeepfm
    from repro.models.recsys.embedding import sharded_lookup as jlookup
    from repro.train import optimizer as jopt

    m22 = jc.make_mesh((2, 2), ("data", "model"))
    m14 = jc.make_mesh((1, 4), ("data", "model"))
    out = {"moe": {}}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731

    mi = inp["moe"]
    for cap in mi["caps"]:
        cfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_expert=16,
                             capacity_factor=cap)

        def f(p, x):
            y, aux = jmoe.moe_block(p, x, cfg, None)
            return jnp.sum(y * y) + aux, (y, aux)

        with jmc(m22, batch_axes=("data",), model_axis="model"), \
                jc.set_mesh(m22):
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(mi["p"], mi["x"])
        y_d, aux_d = jmoe.moe_block(mi["p"], mi["x"], cfg, None)
        out["moe"][cap] = {"y": np.asarray(y), "aux": float(aux),
                           "aux_dense": float(aux_d),
                           "y_dense": np.asarray(y_d),
                           "x_grad": np.asarray(gx),
                           **{f"{k}_grad": np.asarray(v)
                              for k, v in gp.items()}}

    li = inp["lookup"]
    dcfg = jreg.get_arch("deepfm").smoke_config
    with jmc(m22, batch_axes=("data",), model_axis="model"), \
            jc.set_mesh(m22):
        lk = jax.jit(jlookup)(li["table"], li["ids"])
        logits = jax.jit(lambda p, x: jdeepfm.forward(p, x, dcfg))(
            li["deepfm_params"], li["deepfm_x"])
        tg = jax.jit(jax.grad(lambda p, x, y: jdeepfm.loss_fn(
            p, x, y, dcfg)))(li["deepfm_params"], li["deepfm_x"],
                             li["deepfm_y"])["table"]
    out["lookup"] = {"lookup": np.asarray(lk),
                     "deepfm_logits": np.asarray(logits),
                     "deepfm_table_grad": np.asarray(tg)}

    si = inp["split_kv"]
    dec = _j_dec_cfg()
    out["split_kv"] = {}
    for name, mesh, batch, seq in (("1x4", m14, 2, ("model",)),
                                   ("2x2", m22, 1, ("data", "model"))):
        rules = lm_rules(batch_axes=(), tp="model", q_ok=True, kv_ok=False,
                         seq_kv_axes=seq)
        sh = NamedSharding(mesh, rules["kv_cache"])
        res = []
        for clen in si["cache_lens"]:
            with jc.set_mesh(mesh):
                kc = jax.device_put(si["kc"][:, :batch], sh)
                vc = jax.device_put(si["vc"][:, :batch], sh)
                lg, (k2, v2), n = jax.jit(
                    lambda p, t, k, v, c: jtf.decode(p, t, (k, v), c, dec,
                                                     rules))(
                    si["dec_params"], si["tok"][:batch], kc, vc,
                    jnp.int32(clen))
            res.append({"logits": np.asarray(lg), "len": int(n),
                        "k": np.asarray(k2), "v": np.asarray(v2)})
        out["split_kv"][name] = res

    out["train"] = {}
    for arch, sid in ranks_mod.TRAIN_ARCHS.items():
        ti = inp["train"][arch]
        with jmc(m22, batch_axes=("data",), model_axis="model"), \
                jc.set_mesh(m22):
            jb = jsteps.make_step(jreg.get_arch(arch), sid, mesh=m22,
                                  smoke=True)
            fn = jax.jit(jb.fn, in_shardings=jb.in_shardings)
            params, state = ti["params"], ti["state"]
            losses, norms = [], []
            for batch in ti["batches"]:
                params, state, loss, gn = fn(params, state, *batch)
                losses.append(float(loss))
                norms.append(float(gn))
        out["train"][arch] = {"params": to_np(params),
                              "state": to_np(state), "loss": losses,
                              "grad_norm": norms}

    g = inp["gin"]
    jspec = jreg.get_arch("gin-tu")
    jcfg = dataclasses.replace(jspec.smoke_config,
                               d_feat=g["feats"].shape[1],
                               n_classes=g["n_classes"])
    sg = jeng.build_sharded_graph(g["edges"], g["edge_part"], g["n"], 4)
    caps = jge.caps_from_sharded_graph(sg, g["feats"].shape[1],
                                       g["n_classes"])
    arrays = jge.engine_arrays(sg, g["feats"], g["labels"],
                               g["label_mask"], g["positions"])
    loss_fn = jge.make_engine_loss("gin", jcfg, caps, m22,
                                   ("data", "model"), has_positions=True)

    def train_fn(params, state, a):
        loss, grads = jax.value_and_grad(loss_fn)(params, a)
        params, state, stats = jopt.update(grads, state, params,
                                           jsteps.OPT_CFG)
        return params, state, loss, stats["grad_norm"]

    params = g["params"]
    state = jopt.init(params, jsteps.OPT_CFG)
    losses, norms = [], []
    with jc.set_mesh(m22):
        for _ in range(2):
            params, state, loss, gn = jax.jit(train_fn)(params, state,
                                                        arrays)
            losses.append(float(loss))
            norms.append(float(gn))
    out["gin"] = {"params": to_np(params), "state": to_np(state),
                  "loss": losses, "grad_norm": norms}
    return out


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "inputs.pkl"
    inp = _make_inputs()
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return inp, path


@pytest.fixture(scope="module")
def both(inputs):
    """(the reference's results, the port's ranks' results): the
    reference's subprocess runs while the ranks do."""
    inp, path = inputs
    out = path.with_name("reference.pkl")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.Popen([sys.executable, __file__, str(path), str(out)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))
    try:
        got = compat.spawn(ranks_mod.sharded_checks, 4, "gloo", inp)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f), got


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _close_tree(got, want, what=""):
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (a, b) in enumerate(zip(gl, wl)):
        _close(a, b, what=f"{what} leaf {i}")


# --------------------------------------------------------------------------
# 4 ranks against 4 host devices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", CAPS)
def test_moe_expert_parallel_matches_reference_ep(both, cap):
    ref, outs = both
    want = ref["moe"][cap]
    for out in outs:
        got = out["moe"][cap]
        for k in ("y", "x_grad", "router_grad", "wi_grad", "wg_grad",
                  "wo_grad"):
            _close(got[k], want[k], what=k)
        _close(got["aux"], want["aux"], what="aux")


def test_moe_ep_aux_is_the_mean_of_shards_not_dense(both):
    """The EP branch's aux is the batch shards' mean, which the dense
    block's (one routing over all tokens) is not; at capacity 0.5 the
    per-shard capacity drops other tokens than the dense block's."""
    ref, outs = both
    for cap in CAPS:
        want = ref["moe"][cap]
        assert abs(want["aux"] - want["aux_dense"]) > 1e-3
        for out in outs:
            assert abs(out["moe"][cap]["aux"] - want["aux_dense"]) > 1e-3
    assert np.abs(ref["moe"][0.5]["y"] - ref["moe"][0.5]["y_dense"]
                  ).max() > 1e-2


@pytest.mark.parametrize("key", ["lookup", "deepfm_logits",
                                 "deepfm_table_grad"])
def test_row_sharded_tables_match_reference(both, key):
    ref, outs = both
    for out in outs:
        _close(out["lookup"][key], ref["lookup"][key], what=key)


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
@pytest.mark.parametrize("i", range(len(CACHE_LENS)))
def test_split_kv_decode_matches_reference(both, mesh_name, i):
    ref, outs = both
    want = ref["split_kv"][mesh_name][i]
    for out in outs:
        got = out["split_kv"][mesh_name][i]
        assert got["len"] == want["len"] == CACHE_LENS[i] + 1
        for k in ("logits", "k", "v"):
            _close(got[k], want[k], what=k)


@pytest.mark.parametrize("arch", list(ranks_mod.TRAIN_ARCHS))
def test_mesh_train_steps_match_reference(both, arch):
    ref, outs = both
    want = ref["train"][arch]
    for out in outs:
        got = out["train"][arch]
        _close(got["loss"], want["loss"], what="loss")
        _close(got["grad_norm"], want["grad_norm"], what="grad_norm")
        _close_tree(got["params"], want["params"], "params")
        _close_tree(got["state"]["m"], want["state"]["m"], "m")
        _close_tree(got["state"]["v"], want["state"]["v"], "v")
        assert int(got["state"]["step"]) == int(want["state"]["step"]) == 2


def test_gin_engine_mesh_step_matches_reference(both):
    ref, outs = both
    want = ref["gin"]
    for out in outs:
        got = out["gin"]
        _close(got["loss"], want["loss"], what="loss")
        _close(got["grad_norm"], want["grad_norm"], what="grad_norm")
        _close_tree(got["params"], want["params"], "params")
        _close_tree(got["state"]["m"], want["state"]["m"], "m")
        _close_tree(got["state"]["v"], want["state"]["v"], "v")


# --------------------------------------------------------------------------
# a mesh of one rank: the mesh-free step's bits
# --------------------------------------------------------------------------

def _equal_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = (t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
                for t in (x, y))
        assert x.dtype == y.dtype and torch.equal(x, y)


def _cell_inputs(spec, bundle, train, seed):
    """Inputs for a cell's meta ``args`` after the parameters (and, in a
    train cell, the optimizer state)."""
    cfg = bundle.model.cfg
    metas = bundle.args[2:] if train else bundle.args[1:]
    if spec.family == "gnn":
        from test_torch_train_steps import batch_for

        return [tree_from_numpy(batch_for(spec, cfg, metas, seed)[0],
                                metas[0])]
    rng = np.random.default_rng(seed)
    out = []
    for a in metas:
        shape = tuple(a.shape)
        if a.dtype == torch.int32 and shape == ():
            out.append(5)                        # decode's cache_len
        elif a.dtype == torch.int32:
            hi = getattr(cfg, "vocab", None) or 3 * cfg.rows_per_field
            out.append(torch.from_numpy(rng.integers(0, hi, shape).astype(
                np.int32)))
        else:
            out.append(torch.from_numpy(rng.random(shape).astype(
                np.float32)).to(a.dtype))
    return out


def _run(bundle, params, state, inputs, n_steps):
    """``n_steps`` train steps from (params, state), or one call; inputs
    are copied for each call (decode writes its caches in place)."""
    outs = []
    for _ in range(n_steps):
        args = [a.clone() if isinstance(a, torch.Tensor) else a
                for a in inputs]
        if state is None:
            outs.append(bundle.fn(params, *args))
        else:
            params, state, loss, gn = bundle.fn(params, state, *args)
            outs.append((params, state, loss, gn))
    return outs


WORLD1_CELLS = [("olmoe-1b-7b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"),
                ("olmoe-1b-7b", "decode_32k"), ("smollm-135m", "train_4k"),
                ("smollm-135m", "prefill_32k"), ("smollm-135m", "decode_32k"),
                ("deepfm", "train_batch"), ("deepfm", "serve_p99"),
                ("deepfm", "retrieval_cand"), ("gin-tu", "minibatch_lg"),
                ("gin-tu", "molecule")]


@pytest.mark.parametrize("arch,sid", WORLD1_CELLS)
def test_world1_mesh_step_equals_mesh_free_step(arch, sid):
    """Two train steps, or one serving call, through a mesh of one rank
    give the mesh-free step's bits: every collective, the capacity and
    the expert range are identities, and decode (whose rules cut no
    sequence at one rank) takes the single-device attention."""
    spec = treg.get_arch(arch)
    free = steps.make_step(spec, sid, smoke=True)
    from repro_torch.configs.shapes import FAMILY_SHAPES

    train = FAMILY_SHAPES[spec.family][sid]["kind"] == "train" \
        or spec.family == "gnn"
    model = type(free.model)(free.model.cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    params = _detached(model.param_tree())
    ocfg = steps.lm_opt_config(model.cfg) if spec.family == "lm" \
        else steps.OPT_CFG
    state = opt.init(params, ocfg) if train else None
    inputs = _cell_inputs(spec, free, train, 3)
    n = 2 if train else 1
    want = _run(free, params, state, inputs, n)
    with compat.world1("gloo"):
        mesh = make_host_mesh(1)
        bundle = steps.make_step(spec, sid, mesh=mesh, smoke=True)
        got = _run(bundle, compat.shard_tree(params, bundle.layout[0], mesh),
                   state, inputs, n)
    _equal_tree(got, want)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "smollm-135m"])
@pytest.mark.parametrize("seq", [("model",), ("data", "model")])
def test_world1_split_kv_decode_equals_decode(arch, seq, monkeypatch):
    """Split-KV decode at one rank (``Transformer.decode`` with the caches'
    sequence over ``seq`` under ``mesh_context``: one partial, merged
    alone, a merge a layer) gives the mesh-free decode's bits; the mesh
    decode step, whose rules cut no sequence at one rank, merges
    nothing."""
    from repro_torch.kernels.flash_attention import ops as fa

    merges = []
    merge = fa.merge_partials
    monkeypatch.setattr(fa, "merge_partials",
                        lambda *a, **k: merges.append(1) or merge(*a, **k))
    spec = treg.get_arch(arch)
    free = steps.make_step(spec, "decode_32k", smoke=True)
    model = type(free.model)(free.model.cfg, torch.Generator().manual_seed(2),
                             device="cpu")
    params = _detached(model.param_tree())
    inputs = _cell_inputs(spec, free, False, 4)
    want = _run(free, params, None, inputs, 1)
    split = steps.bind(free.model, steps.lm_serve_fn)
    with compat.world1("gloo"):
        mesh = make_host_mesh(1)
        meshed = steps.make_step(spec, "decode_32k", mesh=mesh, smoke=True)
        _equal_tree(_run(meshed, params, None, inputs, 1), want)
        assert merges == []
        with mesh_context(mesh, (), "model"):
            got = [split(params, *[a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in inputs], seq)]
    _equal_tree(got, want)
    assert len(merges) == model.cfg.n_layers


def _detached(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda p: p.detach().clone(), tree)


def test_world1_gin_engine_mesh_step_equals_engine_step(inputs):
    """The engine branch of make_gnn_step at one rank against the engine's
    own mesh-free step (``gnn_engine.train_step``) from the same state."""
    from repro_torch.apps import engine as eng
    from repro_torch.models.common import params_from_numpy
    from repro_torch.models.gnn import gin

    g = dict(inputs[0]["gin"], edge_part=np.zeros(200, np.int32))
    spec = treg.get_arch("gin-tu")
    cfg = dataclasses.replace(spec.smoke_config, d_feat=12, n_classes=4)
    with compat.world1("gloo"):
        sg = eng.build_sharded_graph(g["edges"], g["edge_part"], g["n"], 1)
        caps = ge.caps_from_sharded_graph(sg, 12, 4)
        a = ge.engine_arrays(sg, g["feats"], g["labels"], g["label_mask"],
                             0, "cpu", g["positions"])
        model = params_from_numpy(gin.GIN(cfg), g["params"])
        state = opt.init(model.param_tree(), steps.OPT_CFG)
        want = []
        for _ in range(2):
            loss, state = ge.train_step(model, a, caps, state, steps.OPT_CFG)
            want.append((tree_to_numpy(model.param_tree()), loss))
        got = ranks_mod.gin_engine_run(
            {"gin": dict(g, params=g["params"])}, make_host_mesh(1))
    _equal_tree(tree_from_numpy(got["params"], model.param_tree()),
                model.param_tree())
    assert [float(x) for _, x in want] == got["loss"]


def test_world1_moe_mesh_context_nests(inputs):
    """moe_block under a nested context with no batch axes (a serve path
    on the train mesh) still gives the dense bits at one rank."""
    mi = inputs[0]["moe"]
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_expert=16)
    p = {k: torch.from_numpy(v) for k, v in mi["p"].items()}
    x = torch.from_numpy(mi["x"])
    want = tmoe.moe_block(p, x, cfg)
    with compat.world1("gloo"):
        mesh = make_host_mesh(1)
        with mesh_context(mesh), mesh_context(mesh, ()):
            got = tmoe.moe_block(p, x, cfg)
    _equal_tree(list(got), list(want))


if __name__ == "__main__":
    with open(sys.argv[1], "rb") as f:
        _inp = pickle.load(f)
    _res = _reference(_inp)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(_res, f)
