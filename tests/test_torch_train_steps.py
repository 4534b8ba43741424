"""One train step of the port against the reference's jitted step, per cell.

For every train cell of the port's registry (smollm-135m, qwen3-0.6b,
deepseek-67b, olmoe-1b-7b and kimi-k2-1t-a32b at ``train_4k``; gin-tu, pna, egnn and equiformer-v2 at each
of their four shapes; deepfm at ``train_batch``),
``repro_torch.launch.steps.make_step(spec, shape, smoke=True).fn`` takes
one step from the reference's initial parameters and AdamW state (carried
over as numpy arrays) on the same batch as ``jax.jit(make_step(...).fn)``,
and the loss, grad_norm, every updated parameter and the new ``m`` and
``v`` agree within float32 tolerances:

- loss and grad_norm within 1e-5 relative;
- ``m`` (a tenth of the gradient) within 1e-4 of each leaf's largest;
- ``v`` within 1e-3 of each leaf's largest (squares of gradients);
- PNA's ``m`` and ``v`` within 1e-3 and 2e-3: its std aggregator is
  sqrt(max(E[x²] - E[x]², 0) + 1e-6), and at a node with one in-edge the
  variance is float32 noise around 0, which the sqrt's slope (up to 500)
  and the clamp (0 or that slope) carry into the gradient;
- parameters within 1e-5 + 1e-6|p|: at step 1 the update is lr · g /
  (|g| + 1e-8) (+ weight decay) with lr 1e-4, an entry in (-lr, lr) that
  two float32 gradients agreeing to 1e-5 give alike unless the entry's
  |g| is within a few orders of magnitude of eps (1e-8), where float32
  noise reaches; 1e-5 = lr / 10 bounds those entries.

The LM step is also held to the reference at ``mb_override=2`` (two
microbatches), and the three ``remat`` modes give equal results bit for
bit.  The bf16 optimizer state of the models over 1e11 parameters is
held to the reference's update, and kimi-k2's full train step to the
reference's shapes and types on the meta device.  The GNN cells run in
``test_torch_train_gnn_steps.py`` on these helpers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.launch import steps
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_from_numpy, tree_leaves, tree_to_numpy

LM_ARCHS = ("smollm-135m", "qwen3-0.6b", "deepseek-67b", "olmoe-1b-7b",
            "kimi-k2-1t-a32b")


def _j_params(spec, cfg):
    if spec.family == "lm":
        from repro.models.lm.transformer import init_params
    elif spec.family == "gnn":
        import importlib
        init_params = importlib.import_module(
            f"repro.models.gnn.{spec.model_module}").init_params
    else:
        from repro.models.recsys.deepfm import init_params
    return jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)


def batch_for(spec, cfg, args, seed):
    """Numpy inputs for a train step's meta ``args`` (after params and
    state), in valid ranges: tokens below the vocabulary, raw DeepFM ids
    up to three times a field's rows (the modulo is exercised), edge ids
    below the node count, labels below the class count."""
    rng = np.random.default_rng(seed)
    if spec.family == "lm":
        return [rng.integers(0, cfg.vocab, tuple(args[0].shape)).astype(
            np.int32)]
    if spec.family == "recsys":
        x, y = args
        return [rng.integers(0, 3 * cfg.rows_per_field,
                             tuple(x.shape)).astype(np.int32),
                (rng.random(tuple(y.shape)) < 0.3).astype(np.float32)]
    a = args[0]
    n = a["feats"].shape[-2]
    out = {
        "feats": rng.normal(size=tuple(a["feats"].shape)).astype(np.float32),
        "edge_index": rng.integers(0, n, tuple(a["edge_index"].shape)
                                   ).astype(np.int32),
        "edge_mask": rng.random(tuple(a["edge_mask"].shape)) < 0.8,
        "labels": rng.integers(0, cfg.n_classes, tuple(a["labels"].shape)
                               ).astype(np.int32),
        "label_mask": rng.random(tuple(a["label_mask"].shape)) < 0.8,
        "positions": rng.normal(size=tuple(a["positions"].shape)
                                ).astype(np.float32),
    }
    return [out]


def _to_torch(batch, like):
    return [tree_from_numpy(b, m) for b, m in zip(batch, like)]


def run_pair(arch, shape_id, seed=0, **lm_kw):
    """(reference outputs, port outputs) of one train step from equal
    params, state and batch, each as numpy trees."""
    jspec, tspec = jreg.get_arch(arch), treg.get_arch(arch)
    jb = jsteps.make_step(jspec, shape_id, smoke=True)
    tb = steps.make_step(tspec, shape_id, smoke=True)
    if lm_kw:
        from repro.configs.shapes import SMOKE_SHAPES as JS
        jb = jsteps.make_lm_step(jspec.smoke_config, dict(JS["lm"]["train"]),
                                 **lm_kw)
        tb = steps.make_lm_step(tspec.smoke_config,
                                dict(JS["lm"]["train"]), **lm_kw)
    jcfg = jspec.smoke_config
    if jspec.family == "gnn":
        from repro.configs.shapes import FAMILY_SHAPES, SMOKE_SHAPES
        kind = FAMILY_SHAPES["gnn"][shape_id]["kind"]
        sh = SMOKE_SHAPES["gnn"][kind]
        jcfg = dataclasses.replace(jcfg, d_feat=sh["d_feat"],
                                   n_classes=sh["n_classes"],
                                   graph_level=kind == "batched")
    params = jax.tree.map(np.asarray, _j_params(jspec, jcfg))
    state = jax.tree.map(np.asarray, jopt.init(params, jsteps.OPT_CFG))
    batch = batch_for(jspec, jcfg, tb.args[2:], seed)
    jout = jax.jit(jb.fn)(params, state, *batch)
    jout = jax.tree.map(np.asarray, jout)
    tparams = tree_from_numpy(params, tb.args[0])
    tstate = opt.state_from_numpy(state, tparams, steps.OPT_CFG)
    tout = tb.fn(tparams, tstate, *_to_torch(batch, tb.args[2:]))
    return jout, tree_to_numpy(tout)


def assert_step_close(jout, tout, grad_tol=1e-4):
    (jp, js, jl, jg), (tp, ts, tl, tg) = jout, tout
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 1
    for name, got, want, tol in (("m", ts["m"], js["m"], grad_tol),
                                 ("v", ts["v"], js["v"], 10 * grad_tol
                                  if grad_tol < 1e-3 else 2 * grad_tol)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(
                float(np.abs(b).max()), 1e-30), err_msg=name)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("arch,shape_id", [
    *((a, "train_4k") for a in LM_ARCHS), ("deepfm", "train_batch")])
def test_train_step_matches_reference(arch, shape_id):
    assert_step_close(*run_pair(arch, shape_id))


def test_lm_microbatches_match_reference():
    """mb_override=2: the loss and gradients averaged over two
    microbatches, as the reference's scan does."""
    assert_step_close(*run_pair("smollm-135m", "train_4k", seed=1,
                                mb_override=2))


def _remat_steps_equal(arch):
    spec = treg.get_arch(arch)
    from repro_torch.configs.shapes import SMOKE_SHAPES
    shape = dict(SMOKE_SHAPES["lm"]["train"])
    outs = []
    for mode in ("none", "dots", "full"):
        b = steps.make_lm_step(spec.smoke_config, shape,
                               remat_override=mode)
        model = b.model.__class__(b.model.cfg, device="cpu")
        params = steps._specs(model)
        tok = torch.from_numpy(batch_for(spec, spec.smoke_config,
                                         b.args[2:], 3)[0])
        outs.append(tree_leaves(b.fn(params, opt.init(params, steps.OPT_CFG),
                                     tok)))
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_remat_modes_equal_bit_for_bit():
    """none, dots and full give the same step bit for bit (qwen3's smoke
    config: qk-norm; none is held to the reference above)."""
    _remat_steps_equal("qwen3-0.6b")


def test_moe_remat_modes_equal_bit_for_bit():
    """The same for olmoe's smoke config: the MoE layer's scatter, its
    per-expert products (recomputed under dots) and the aux loss."""
    _remat_steps_equal("olmoe-1b-7b")


def test_registry_matches_reference():
    """The port's registry has the reference's ids, shapes and all 40
    cells, and every config field (the MoE configs' too) equals the
    reference's."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.all_cells() == jreg.all_cells()
    assert len(treg.all_cells()) == 40
    for a in treg.ARCH_IDS:
        t, j = treg.get_arch(a), jreg.get_arch(a)
        assert t.family == j.family and t.shape_ids == j.shape_ids
        assert t.model_module == j.model_module
        for tc, jc in ((t.config, j.config), (t.smoke_config,
                                              j.smoke_config)):
            for f in dataclasses.fields(jc):
                if f.name in ("dtype", "moe") or not hasattr(tc, f.name):
                    continue
                assert getattr(tc, f.name) == getattr(jc, f.name), (a,
                                                                    f.name)
            if hasattr(jc, "dtype"):
                assert str(tc.dtype).split(".")[-1] == jnp.dtype(
                    jc.dtype).name
            if getattr(jc, "moe", None) is not None:
                for f in dataclasses.fields(jc.moe):
                    want, got = getattr(jc.moe, f.name), getattr(tc.moe,
                                                                 f.name)
                    if f.name == "router_dtype":
                        assert str(got).split(".")[-1] == jnp.dtype(
                            want).name
                    else:
                        assert got == want, (a, f.name)
            else:
                assert getattr(tc, "moe", None) is None


def test_flops_and_step_meta_match_reference():
    """model_flops, meta and loop_scale of every ported cell's step equal
    the reference's (full configs; the port's built on the meta device),
    and the step's args carry the reference's shapes and dtypes."""
    for a, sid in treg.all_cells():
        jb = jsteps.make_step(jreg.get_arch(a), sid)
        tb = steps.make_step(treg.get_arch(a), sid)
        assert tb.model_flops == jb.model_flops, (a, sid)
        assert tb.loop_scale == jb.loop_scale, (a, sid)
        if "engine_caps" not in jb.meta:
            assert tb.meta == jb.meta, (a, sid)
        if "engine_caps" in jb.meta:
            continue
        for t, j in zip(tree_leaves(tb.args), jax.tree.leaves(jb.args)):
            assert tuple(t.shape) == tuple(j.shape), (a, sid)
            assert str(t.dtype).split(".")[-1] == jnp.dtype(
                j.dtype).name.replace("bool", "bool"), (a, sid)


def test_mesh_steps_build_every_kind():
    """No step builder refuses a mesh: every cell kind of the three
    families builds on a production-shaped mesh (the builders read its
    axis names and sizes), with the reference's shardings, the port's
    layout and the layout-only rules named."""
    from types import SimpleNamespace

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    cells = {"olmoe-1b-7b": ("train_4k", "prefill_32k", "decode_32k",
                             "long_500k"),
             "smollm-135m": ("train_4k", "decode_32k"),
             "deepfm": ("train_batch", "serve_p99", "retrieval_cand"),
             "gin-tu": ("full_graph_sm", "minibatch_lg", "molecule")}
    for arch, sids in cells.items():
        for sid in sids:
            b = steps.make_step(treg.get_arch(arch), sid, mesh=mesh)
            assert b.shardings is not None and b.layout is not None, sid
            assert len(b.shardings) == len(b.args) == len(b.layout), sid
            assert "replicated" in b.meta, sid
    b = steps.make_step(treg.get_arch("smollm-135m"), "train_4k", mesh=mesh)
    assert "w_ffn_in" in b.meta["replicated"]
    b = steps.make_step(treg.get_arch("gin-tu"), "full_graph_sm", mesh=mesh)
    assert b.meta["engine_caps"]["n_dev"] == 256


def test_optimizer_state_round_trip():
    """The AdamW state to numpy and back, in the reference's layout: the
    reference's update on the carried state equals the port's."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=(3,)).astype(np.float32)]}
    grads = jax.tree.map(lambda p: np.float32(0.3) * p + 0.1, params)
    cfg = jopt.OptConfig(warmup_steps=2)
    jstate = jopt.init(params, cfg)
    jp, jstate, _ = jopt.update(grads, jstate, params, cfg)
    jstate = jax.tree.map(np.asarray, jstate)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), tree_from_numpy(
        params, jax.tree.map(lambda a: torch.zeros(a.shape), params)))
    tcfg = opt.OptConfig(warmup_steps=2)
    tstate = opt.state_from_numpy(jstate, tp, tcfg)
    assert tstate["step"].dtype == torch.int32 and int(tstate["step"]) == 1
    back = opt.state_to_numpy(tstate)
    assert set(back) == {"m", "v", "step"}
    for a, b in zip(tree_leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tg = tree_from_numpy(grads, tp)
    p2, s2, _ = opt.update(tg, tstate, tp, tcfg)
    jp2, js2, _ = jopt.update(grads, jstate, jax.tree.map(np.asarray, jp),
                              cfg)
    for a, b in zip(tree_leaves(tree_to_numpy(p2)), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


def test_kimi_train_step_on_the_meta_device():
    """kimi-k2's full train_4k step (1.04 T parameters) built on the meta
    device: bf16 moments, 4 microbatches, and every argument's shape and
    type equal to the reference's ``eval_shape``."""
    jb = jsteps.make_step(jreg.get_arch("kimi-k2-1t-a32b"), "train_4k")
    tb = steps.make_step(treg.get_arch("kimi-k2-1t-a32b"), "train_4k")
    assert tb.loop_scale == jb.loop_scale == 61 * 4
    assert tb.meta == jb.meta and tb.meta["params"] > 1e12
    assert steps.lm_opt_config(tb.model.cfg).state_dtype == torch.bfloat16
    ospecs = tb.args[1]
    assert {t.dtype for t in tree_leaves(ospecs["m"])} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(ospecs["v"])} == {torch.bfloat16}
    assert ospecs["step"].dtype == torch.int32
    assert tb.model.moe["router"].dtype == torch.float32
    jl = jax.tree.leaves(jb.args)
    tl = tree_leaves(tb.args)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


def test_bf16_state_update_matches_reference():
    """AdamW with ``state_dtype`` bfloat16 against the reference's update
    under the same config, two steps: bf16 and float32 parameters, bf16
    gradients (clipped: the norm is over 1), the moments stored in bf16
    after float32 arithmetic, equal bit for bit; the state keeps
    its type through ``init``, ``state_from_numpy`` and a checkpoint."""
    from repro_torch.train.checkpoint import CheckpointManager

    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(6, 5)).astype(jnp.bfloat16),
              "r": [rng.normal(size=(5,)).astype(np.float32)]}
    grads = [jax.tree.map(lambda p, i=i: (rng.normal(size=p.shape) * (i + 2)
                                          ).astype(p.dtype), params)
             for i in range(2)]
    jcfg = jopt.OptConfig(warmup_steps=2, state_dtype=jnp.bfloat16)
    tcfg = opt.OptConfig(warmup_steps=2, state_dtype=torch.bfloat16)
    like = {"w": torch.zeros((6, 5), dtype=torch.bfloat16),
            "r": [torch.zeros(5)]}
    tp = tree_from_numpy(params, like)
    ts = opt.init(tp, tcfg)
    assert {t.dtype for t in tree_leaves(ts["m"])} == {torch.bfloat16}
    jp, js = params, jopt.init(params, jcfg)
    for g in grads:
        jp, js, jst = jopt.update(g, js, jp, jcfg)
        tp, ts, tst = opt.update(tree_from_numpy(g, like), ts, tp, tcfg)
        assert float(jst["grad_norm"]) > 1
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-6)
        for a, b in zip(tree_leaves(tree_to_numpy((tp, ts))),
                        jax.tree.leaves((jp, js))):
            b = np.asarray(b).astype(np.float32) if b.dtype.name == \
                "bfloat16" else np.asarray(b)
            np.testing.assert_array_equal(a, b)
    back = opt.state_from_numpy(jax.tree.map(np.asarray, js), tp, tcfg)
    assert {t.dtype for t in tree_leaves(back["m"])} == {torch.bfloat16}
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(2, (tp, ts))
        (rp, rs), step = mgr.restore((tp, opt.init(tp, tcfg)))
    assert step == 2
    for a, b in zip(tree_leaves((rp, rs)), tree_leaves((tp, ts))):
        assert a.dtype == b.dtype and torch.equal(a, b)
