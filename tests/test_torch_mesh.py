"""The port's mesh tables against the reference package, on the CPU with
no ranks: ``dist.sharding.lm_rules`` over its flags, the step builders'
``_lm_rules`` for every LM cell on the production meshes (the reference
reads only the mesh's shape, so both take a stand-in), each LM arch's
``shard_params_rules``, the GNN engine's ``synth_caps`` and
``engine_array_specs``, and ``dist.context``'s ``MeshCtx`` and
``mesh_context``; then, in a world-1 gloo group, ``launch.mesh``'s
builders (each raises where the world does not fit) and
``launch.train.train`` on a mesh of one rank."""
import dataclasses
import itertools
from types import SimpleNamespace

import jax.numpy as jnp
import pytest

from repro.configs import registry as jreg
from repro.configs.shapes import FAMILY_SHAPES
from repro.dist import sharding as jsh
from repro.launch import gnn_engine as jge
from repro.launch import steps as jsteps
from repro.models.lm import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.dist import context as tctx
from repro_torch.dist import sharding as tsh
from repro_torch.launch import gnn_engine as tge
from repro_torch.launch import steps as tsteps
from repro_torch.models.lm import transformer as ttf

LM_ARCHS = [a for a in treg.ARCH_IDS if treg.get_arch(a).family == "lm"]
LM_CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
FLAGS = ("q_ok", "kv_ok", "ffn_ok", "vocab_ok", "sp", "resid_sp")


def _norm(spec) -> tuple:
    """A spec as a tuple of axis tuples, trailing replicated dims dropped
    (``P(None)`` and ``P()`` are the same layout)."""
    out = [tsh.spec_axes(e) for e in spec]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def _same_tree(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
        return
    assert _norm(got) == _norm(want), (where, got, want)


def _stand_ins(name):
    axes, shape = MESHES[name]
    return (SimpleNamespace(mesh_dim_names=axes, shape=shape),
            SimpleNamespace(shape=dict(zip(axes, shape)),
                            axis_names=axes))


@pytest.mark.parametrize("seq_kv,w2d", [((), ()), (("data",), ()),
                                        ((), ("data",)),
                                        (("pod", "data"), ("pod", "data"))])
@pytest.mark.parametrize("batch_axes", [(), ("data",), ("pod", "data")])
def test_lm_rules_equal_reference_over_every_flag(seq_kv, w2d, batch_axes):
    for values in itertools.product((False, True), repeat=len(FLAGS)):
        kw = dict(zip(FLAGS, values))
        got = tsh.lm_rules(batch_axes=batch_axes, seq_kv_axes=seq_kv,
                           w2d_axes=w2d, **kw)
        want = jsh.lm_rules(batch_axes=batch_axes, seq_kv_axes=seq_kv,
                            w2d_axes=w2d, **kw)
        assert set(got) == set(want)
        for name in want:
            assert _norm(got[name]) == _norm(want[name]), (name, kw)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cell_rules_equal_reference_on_production_meshes(arch):
    tcfg, jcfg = treg.get_arch(arch).config, jreg.get_arch(arch).config
    for mesh_name, cell in itertools.product(MESHES, LM_CELLS):
        tmesh, jmesh = _stand_ins(mesh_name)
        shape = dict(FAMILY_SHAPES["lm"][cell])
        got = tsteps._lm_rules(tcfg, shape, tmesh)
        want = jsteps._lm_rules(jcfg, shape, jmesh,
                                multi_pod=mesh_name == "2x16x16")
        assert set(got) == set(want), (mesh_name, cell)
        for name in want:
            assert _norm(got[name]) == _norm(want[name]), \
                (mesh_name, cell, name)
        _same_tree(ttf.shard_params_rules(tcfg, got),
                   jtf.shard_params_rules(jcfg, want), f"{mesh_name}/{cell}")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_shard_params_rules_cover_the_param_tree(arch):
    """Every parameter has a spec whose rank fits it, on the smoke model's
    tree (the full one's has the same keys)."""
    spec = treg.get_arch(arch)
    rules = tsh.lm_rules(batch_axes=("data",), seq_kv_axes=("data",),
                         w2d_axes=("data",))
    specs = ttf.shard_params_rules(spec.config, rules)
    params = ttf.Transformer(spec.smoke_config, device="meta").param_tree()
    for t, s in tsteps._leaves_with_specs(params, specs):
        assert len(s) <= t.dim(), (s, tuple(t.shape))
    _same_tree(specs, jtf.shard_params_rules(jreg.get_arch(arch).config,
                                             jsh.lm_rules(
        batch_axes=("data",), seq_kv_axes=("data",), w2d_axes=("data",))))


def test_layout_only_rules_are_named_replicated():
    """A train cell at 16 x 16: the tensor-parallel dense weights are
    realised by replication and named so; experts and the batch are cut
    as the rules say."""
    mesh, _ = _stand_ins("16x16")
    cfg = treg.get_arch("olmoe-1b-7b").config
    rules = tsteps._lm_rules(cfg, dict(FAMILY_SHAPES["lm"]["train_4k"]),
                             mesh)
    real, replicated = tsteps._realised(rules)
    assert "w_q" in replicated and "w_embed" in replicated
    assert "w_expert" not in replicated and "tok_bt" not in replicated
    assert real["w_expert"] == rules["w_expert"]
    assert _norm(real["w_q"]) == ()
    assert _norm(real["tok_bt"]) == (("data",),)


@pytest.mark.parametrize("cell", [c for c, s in FAMILY_SHAPES["gnn"].items()
                                  if s["kind"] == "full"])
@pytest.mark.parametrize("n_dev", [1, 4, 256, 512])
def test_synth_caps_and_engine_array_specs_equal_reference(cell, n_dev):
    shape = FAMILY_SHAPES["gnn"][cell]
    got = tge.synth_caps(shape, n_dev, rf=3.5)
    want = jge.synth_caps(shape, n_dev, rf=3.5)
    want_caps = dataclasses.asdict(want)
    assert want_caps.pop("sync_dtype") == "float32"    # the port's wire
    assert dataclasses.asdict(got) == want_caps
    for positions in (False, True):
        ga = tge.engine_array_specs(got, positions)
        wa = jge.engine_array_specs(want, positions)
        assert set(ga) == set(wa)
        for k in wa:
            assert ga[k].device.type == "meta"
            assert tuple(ga[k].shape) == tuple(wa[k].shape), k
            assert str(ga[k].dtype).split(".")[-1] == \
                jnp.dtype(wa[k].dtype).name, k


def test_mesh_ctx_degrees_error_and_nesting():
    mesh, _ = _stand_ins("2x16x16")
    ctx = tctx.MeshCtx(mesh, ("pod", "data"), "model")
    assert (ctx.dp, ctx.tp) == (32, 16)
    assert tctx.MeshCtx(mesh, (), "model").dp == 1
    with pytest.raises(ValueError, match="not in mesh axes"):
        tctx.MeshCtx(mesh, ("data", "rows"), "model")
    with pytest.raises(ValueError, match="not in mesh axes"):
        tctx.MeshCtx(mesh, ("data",), "tensor")
    assert tctx.get_mesh_ctx() is None
    with tctx.mesh_context(mesh, ("pod", "data")) as outer:
        assert tctx.get_mesh_ctx() is outer and outer.dp == 32
        with tctx.mesh_context(mesh, ()) as inner:
            assert tctx.get_mesh_ctx() is inner and inner.dp == 1
        assert tctx.get_mesh_ctx() is outer
    assert tctx.get_mesh_ctx() is None


def test_axes_of_a_size_one_tuple_have_no_group():
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    assert tctx.axes_group(mesh, ("data", "model")) is None
    assert tctx.axes_group(mesh, ()) is None
    big = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    with pytest.raises(ValueError, match="mesh order"):
        tctx.axes_group(big, ("model", "data"))


def test_meshes_raise_where_the_world_does_not_fit():
    """make_production_mesh needs 256 (or 512) ranks, make_host_mesh a
    model axis that divides the world, make_edge_mesh the whole world;
    none shrinks, and none is made without a group."""
    from repro_torch.dist import compat
    from repro_torch.launch import mesh as tmesh

    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(1)
    with compat.world1("gloo"):
        with pytest.raises(ValueError, match="256 ranks"):
            tmesh.make_production_mesh()
        with pytest.raises(ValueError, match="512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.make_host_mesh(2)
        with pytest.raises(ValueError, match="world has 1"):
            tmesh.make_edge_mesh(2)
        m = tmesh.make_host_mesh(1)
        assert tuple(m.mesh_dim_names) == ("data", "model")
        e = tmesh.make_edge_mesh()
        assert tuple(e.mesh_dim_names) == ("shard",) and e.size() == 1


def test_train_launcher_on_a_mesh_of_one_rank(tmp_path):
    """``launch.train.train`` with a mesh (the --full path's, at one rank)
    gives the mesh-free run's losses and parameters bit for bit."""
    import torch

    from repro_torch.dist import compat
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_leaves

    kw = dict(device="cpu", log=lambda *_: None, resume=False)
    p1, _, h1, _ = tlaunch.train("olmoe-1b-7b", 3, str(tmp_path / "a"), **kw)
    with compat.world1("gloo"):
        p2, _, h2, _ = tlaunch.train("olmoe-1b-7b", 3, str(tmp_path / "b"),
                                     mesh=make_host_mesh(1), **kw)
    assert [h["loss"] for h in h1] == [h["loss"] for h in h2]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1),
                                                 tree_leaves(p2)))
    assert (tmp_path / "b" / "rank0").is_dir()
