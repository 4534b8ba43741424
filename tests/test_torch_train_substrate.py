"""The port's training substrate against the reference's: the trainer's
resume, int8 error-feedback compression (in process at world 1, and at 2
spawned gloo ranks against the reference on 2 forced host devices), the
neighbor sampler bit for bit, a reference checkpoint resumed by the port's
trainer, and the training launcher's resume on the CPU.
"""
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_ranks
from repro.configs import registry as jreg
from repro.dist import compat as jcompat
from repro.launch import steps as jsteps
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.trainer import TrainLoopConfig as JLoopConfig
from repro.train.trainer import run_training as j_run_training
from repro_torch.configs import registry as treg
from repro_torch.dist import compat
from repro_torch.launch import steps
from repro_torch.launch import train as tlaunch
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import TrainLoopConfig, run_training
from repro_torch.tree import tree_from_numpy, tree_leaves, tree_to_numpy

GRADS_SEED = 11


def _quiet(*_):
    pass


def _grads(rank: int):
    rng = np.random.default_rng(GRADS_SEED + rank)
    return {"w": rng.normal(size=(64,)).astype(np.float32),
            "b": [rng.normal(size=(3, 5)).astype(np.float32) * 1e-3,
                  np.zeros((4,), np.float32)]}


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

def _quad_step():
    target = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8,)).astype(np.float32))
    cfg = opt.OptConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                        total_steps=100)

    def step_fn(params, state, batch):
        w = params["w"].detach().requires_grad_()
        loss = torch.sum((w - target) ** 2) + 0.0 * batch.sum()
        (g,) = torch.autograd.grad(loss, [w])
        params, state, stats = opt.update({"w": g}, state, params, cfg)
        return params, state, loss.detach(), stats["grad_norm"]

    return cfg, step_fn


def _zeros():
    while True:
        yield torch.zeros(())


def test_trainer_resume(tmp_path):
    """The reference's test: 40 steps, then a run to 60 resumes at 40; and
    the resumed run equals an uninterrupted 60-step run bit for bit."""
    cfg, step_fn = _quad_step()
    params = {"w": torch.zeros(8)}
    state = opt.init(params, cfg)
    tcfg = TrainLoopConfig(total_steps=40, ckpt_every=10,
                           ckpt_dir=str(tmp_path / "a"), log_every=100)
    run_training(step_fn, params, state, _zeros(), tcfg, log=_quiet)
    tcfg2 = TrainLoopConfig(total_steps=60, ckpt_every=10,
                            ckpt_dir=str(tmp_path / "a"), log_every=100)
    p2, s2, hist = run_training(step_fn, params, state, _zeros(), tcfg2,
                                log=_quiet)
    assert int(s2["step"]) == 60
    assert hist[0]["step"] >= 40
    tcfg3 = TrainLoopConfig(total_steps=60, ckpt_every=10,
                            ckpt_dir=str(tmp_path / "b"), log_every=100)
    p3, s3, _ = run_training(step_fn, params, state, _zeros(), tcfg3,
                             log=_quiet)
    assert torch.equal(p2["w"], p3["w"]) and torch.equal(s2["v"]["w"],
                                                         s3["v"]["w"])


def test_trainer_batch_stream_starts_at_resume(tmp_path):
    """A callable batch_iter gets the first step: a resumed run reads the
    batches from where the killed run stopped."""
    seen = []

    def batches(start):
        step = start
        while True:
            seen.append(step)
            yield torch.zeros(())
            step += 1

    cfg, step_fn = _quad_step()
    params = {"w": torch.zeros(8)}
    for total in (3, 5):
        run_training(step_fn, params, opt.init(params, cfg), batches,
                     TrainLoopConfig(total_steps=total, ckpt_every=3,
                                     ckpt_dir=str(tmp_path)), log=_quiet)
    assert seen == [0, 1, 2, 3, 4]


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's run_training (jitted smollm-135m smoke step) writes
    its checkpoint at step 2; the port's run_training resumes from it and
    takes steps 2 and 3 on the same batches as the reference's own
    resumed run: losses within 1e-5, parameters within 1e-5 + 1e-6|p|
    (the tolerances of test_torch_train_steps.py)."""
    arch = "smollm-135m"
    jspec, tspec = jreg.get_arch(arch), treg.get_arch(arch)
    jb = jsteps.make_step(jspec, "train_4k", smoke=True)
    tb = steps.make_step(tspec, "train_4k", smoke=True)
    from repro.models.lm.transformer import init_params
    cfg = jspec.smoke_config
    params = init_params(jax.random.PRNGKey(0), cfg)
    state = jopt.init(params, jsteps.OPT_CFG)
    rng = np.random.default_rng(5)
    toks = [rng.integers(0, cfg.vocab, tuple(tb.args[2].shape)).astype(
        np.int32) for _ in range(4)]
    jfn = jax.jit(jb.fn)
    ck = str(tmp_path / "ck")
    j_run_training(jfn, params, state, iter(jnp.asarray(t) for t in toks[:2]),
                   JLoopConfig(total_steps=2, ckpt_every=2, ckpt_dir=ck),
                   log=_quiet)
    # the reference resumes in a copy of the directory
    import shutil
    shutil.copytree(ck, str(tmp_path / "ck_ref"))
    jp, _, jhist = j_run_training(
        jfn, params, state, iter(jnp.asarray(t) for t in toks[2:]),
        JLoopConfig(total_steps=4, ckpt_every=10,
                    ckpt_dir=str(tmp_path / "ck_ref"), log_every=1),
        log=_quiet)
    tparams = tree_from_numpy(jax.tree.map(np.zeros_like, params),
                              tb.args[0])
    tstate = opt.init(tparams, steps.OPT_CFG)
    tp, ts, thist = run_training(
        tb.fn, tparams, tstate, iter(torch.from_numpy(t) for t in toks[2:]),
        TrainLoopConfig(total_steps=4, ckpt_every=10, ckpt_dir=ck,
                        log_every=1), log=_quiet)
    assert int(ts["step"]) == 4
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [2, 3]
    for a, b in zip(thist, jhist):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    for a, b in zip(tree_leaves(tree_to_numpy(tp)), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-5)


def test_launcher_trains_and_resumes(tmp_path):
    """``launch.train.train`` on the CPU (smollm-135m's smoke config): 3
    steps, then a resumed run to 5 equals an uninterrupted 5-step run bit
    for bit (the batches are drawn per step)."""
    kw = dict(device="cpu", log=_quiet, ckpt_every=3)
    tlaunch.train("smollm-135m", 3, str(tmp_path / "a"), **kw)
    p1, s1, h1, _ = tlaunch.train("smollm-135m", 5, str(tmp_path / "a"),
                                  **kw)
    p2, s2, h2, _ = tlaunch.train("smollm-135m", 5, str(tmp_path / "b"),
                                  **kw)
    assert [h["step"] for h in h1] == [4] and int(s1["step"]) == 5
    assert all(np.isfinite(h["loss"]) for h in h1 + h2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1),
                                                  tree_leaves(p2)))
    with pytest.raises(SystemExit, match="LM train path"):
        tlaunch.train("deepfm", 1, str(tmp_path / "c"), device="cpu")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_launcher_trains_the_moe_lms(tmp_path, arch):
    """The MoE LMs' smoke configs train through ``launch.train`` (loss =
    cross-entropy + the load-balance loss) and resume bit for bit."""
    kw = dict(device="cpu", log=_quiet, ckpt_every=2)
    tlaunch.train(arch, 2, str(tmp_path / "a"), **kw)
    p1, s1, h1, b = tlaunch.train(arch, 4, str(tmp_path / "a"), **kw)
    p2, _, h2, _ = tlaunch.train(arch, 4, str(tmp_path / "b"), **kw)
    assert b.model.cfg.moe is not None and int(s1["step"]) == 4
    assert all(np.isfinite(h["loss"]) for h in h1 + h2)
    assert all(torch.equal(a, c) for a, c in zip(tree_leaves(p1),
                                                  tree_leaves(p2)))


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------

def test_quantize_and_trees_match_reference():
    """quantize, dequantize, compress_tree, decompress_tree equal the
    reference's bit for bit (round half to even, float32)."""
    g, r = _grads(0), _grads(1)
    jpay, jres = jcomp.compress_tree(g, r)
    tg, tr = (tree_from_numpy(x, jax.tree.map(
        lambda a: torch.zeros(a.shape), x)) for x in (g, r))
    tpay, tres = comp.compress_tree(tg, tr)
    for (q, s), (jq, js) in zip(
            [tpay["b"][0], tpay["b"][1], tpay["w"]],
            [jpay["b"][0], jpay["b"][1], jpay["w"]]):
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s) == np.float32(js)
    for a, b in zip(tree_leaves(tree_to_numpy(tres)), jax.tree.leaves(jres)):
        assert np.array_equal(a, np.asarray(b))
    for a, b in zip(tree_leaves(tree_to_numpy(comp.decompress_tree(tpay))),
                    jax.tree.leaves(jcomp.decompress_tree(jpay))):
        assert np.array_equal(a, np.asarray(b))
    for a, b in zip(tree_leaves(tree_to_numpy(comp.init_residuals(tg))),
                    jax.tree.leaves(jcomp.init_residuals(g))):
        assert np.array_equal(a, np.asarray(b))


def _jax_psum(grads, resid, world):
    """The reference's psum_compressed over ``world`` devices (this
    process's, or a subprocess's with forced host devices)."""
    from jax.sharding import PartitionSpec as P

    mesh = jcompat.make_mesh((world,), ("d",))
    stack = lambda trees: jax.tree.map(lambda *x: np.stack(x), *trees)
    body = lambda g, r: jcomp.psum_compressed(
        jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], r),
        "d")
    out, new_r = jax.jit(jcompat.shard_map(
        lambda g, r: jax.tree.map(lambda x: x[None], body(g, r)),
        mesh=mesh, in_specs=(P("d"), P("d")),
        out_specs=(P("d"), P("d"))))(stack(grads), stack(resid))
    return jax.tree.map(np.asarray, (out, new_r))


def test_compression_error_feedback_world1():
    """The reference's test at world 1 (gloo, in process): the payload
    equals the reference's bit for bit, the quantization error is under
    a scale and captured by the residual."""
    g, r = _grads(0), jax.tree.map(np.zeros_like, _grads(0))
    jout, jres = _jax_psum([g], [r], 1)
    like = jax.tree.map(lambda a: torch.zeros(a.shape), g)
    with compat.world1("gloo"):
        out, new_r = comp.psum_compressed(tree_from_numpy(g, like),
                                          tree_from_numpy(r, like))
    for a, b in zip(tree_leaves(tree_to_numpy(out)), jax.tree.leaves(jout)):
        assert np.array_equal(a, b[0])
    for a, b in zip(tree_leaves(tree_to_numpy(new_r)), jax.tree.leaves(jres)):
        assert np.array_equal(a, b[0])
    scale = float(np.abs(g["w"]).max()) / 127.0
    assert float((out["w"] - torch.from_numpy(g["w"])).abs().max()) <= scale
    np.testing.assert_allclose((out["w"] + new_r["w"]).numpy(), g["w"],
                               rtol=1e-5, atol=1e-6)


_JAX_TWO = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[2])
from test_torch_train_substrate import _grads, _jax_psum
import jax
out, res = _jax_psum([_grads(0), _grads(1)], [_grads(2), _grads(3)], 2)
flat = {f"o{i}": a for i, a in enumerate(jax.tree.leaves(out))}
flat.update({f"r{i}": a for i, a in enumerate(jax.tree.leaves(res))})
np.savez(sys.argv[1], **flat)
"""


def test_compression_two_ranks_match_reference():
    """Two spawned gloo ranks (residuals carried in) equal the reference
    on two forced host devices bit for bit: the mean gradient on both
    ranks, and each rank's residual."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_TWO, path,
             os.path.dirname(os.path.abspath(__file__))], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        got = compat.spawn(torch_spmd_ranks.compression_checks, 2, "gloo",
                           [_grads(0), _grads(1)], [_grads(2), _grads(3)])
        err = proc.communicate(timeout=300)[1]
        assert proc.returncode == 0, err.decode()[-3000:]
        ref = np.load(path)
    n = len(jax.tree.leaves(_grads(0)))
    for rank in range(2):
        out, res = got[rank]
        for i, a in enumerate(tree_leaves(out)):
            assert np.array_equal(a, ref[f"o{i}"][rank])
        for i, a in enumerate(tree_leaves(res)):
            assert np.array_equal(a, ref[f"r{i}"][rank])
        assert len(tree_leaves(out)) == n


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fanout,seed", [((5, 3), 0), ((15, 10), 3)])
def test_neighbor_sampler_matches_reference(fanout, seed):
    """On the same RMAT graph (the port's Graph and the reference's), the
    samplers give the same batches bit for bit: an explicit seed list,
    then three batches of the stream."""
    from repro.graphs.rmat import rmat as jrmat
    from repro.graphs.sampler import NeighborSampler as JSampler
    from repro_torch.graphs.rmat import rmat
    from repro_torch.graphs.sampler import NeighborSampler

    tg, jg = rmat(9, 8, seed=1, device="cpu"), jrmat(9, 8, seed=1)
    ts, js = (NeighborSampler(tg, fanout, seed), JSampler(jg, fanout, seed))
    assert (ts.nodes_cap, ts.edges_cap) == (js.nodes_cap, js.edges_cap)
    seeds = np.array([3, 7, 11, 0, 511])
    pairs = [(ts.sample(seeds), js.sample(seeds))]
    tb, jb = ts.batches(4), js.batches(4)
    pairs += [(next(tb), next(jb)) for _ in range(3)]
    for a, b in pairs:
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert (pairs[0][0]["edge_index"] < ts.nodes_cap).all()
