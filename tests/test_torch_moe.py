"""The port's MoE LMs against the reference package.

``repro_torch.models.lm.moe`` against ``repro.models.lm.moe`` on the same
numpy inputs: the router (weights, experts, load-balance loss), a router
with tied columns (the reference's ``jax.lax.top_k`` returns ties lowest
index first), GShard's positions and the tokens that overflow an
expert's capacity (dropped alike), and ``moe_block``; then the
olmoe-smoke and kimi-smoke models from the reference's ``init_params``
(carried by ``params_from_numpy``): forward logits, aux and prefill
caches, one decode step, ``serve_batch`` tokens (greedy and T = 0.7), and
``loss_fn`` with its gradients.  Values within 1e-5 of the largest
(float32 sums in another order), experts, positions and tokens equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import kimi_k2_1t_a32b as jkimi
from repro.configs import olmoe_1b_7b as jolmoe
from repro.configs.shapes import SMOKE_SHAPES as J_SMOKE
from repro.dist.sharding import NO_RULES
from repro.models.lm import moe as jmoe
from repro.models.lm import serve as jserve
from repro.models.lm import transformer as jtf
from repro_torch.configs import kimi_k2_1t_a32b as tkimi
from repro_torch.configs import olmoe_1b_7b as tolmoe
from repro_torch.launch import steps
from repro_torch.models.common import params_from_numpy, params_to_numpy
from repro_torch.models.lm import moe as tmoe
from repro_torch.models.lm import serve as tserve
from repro_torch.models.lm import transformer as ttf
from repro_torch.tree import tree_leaves

CONFIGS = {"olmoe": (jolmoe.SMOKE, tolmoe.SMOKE),
           "kimi": (jkimi.SMOKE, tkimi.SMOKE)}
PREFILL = J_SMOKE["lm"]["prefill"]
DECODE = J_SMOKE["lm"]["decode"]


@functools.lru_cache(maxsize=None)
def _params(name):
    init = jax.jit(jtf.init_params, static_argnums=1)
    return jax.tree.map(np.asarray,
                        init(jax.random.PRNGKey(0), CONFIGS[name][0]))


def _model(name):
    return params_from_numpy(ttf.Transformer(CONFIGS[name][1],
                                             device="cpu"), _params(name))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _cfgs(**over):
    return (dataclasses.replace(jolmoe.SMOKE.moe, **over),
            dataclasses.replace(tolmoe.SMOKE.moe, **over))


def _layer0(name):
    """The reference's layer-0 MoE parameters, as numpy and as tensors."""
    p = {k: v[0] for k, v in _params(name)["layers"]["moe"].items()}
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# --------------------------------------------------------------------------
# the MoE layer's pieces
# --------------------------------------------------------------------------

def test_route_matches_reference():
    jc, tc = _cfgs()
    jp, tp = _layer0("olmoe")
    x = _x(40, 48, 1)
    jw, jidx, jaux = jmoe._route(jp["router"], jnp.asarray(x), jc)
    tw, tidx, taux = tmoe._route(tp["router"], torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)
    _close(taux, jaux)
    assert tw.dtype == torch.float32 and taux.dtype == torch.float32


def test_route_ties_lowest_index_first():
    """A router with equal columns gives equal probabilities bit for bit
    (integer inputs and dyadic weights: every sum exact); the experts are
    taken lowest index first, as ``jax.lax.top_k`` takes them, also where
    the tie straddles the k-th place."""
    cfg_j, cfg_t = _cfgs()
    cols = np.array([0, 1, 3, 3, 1, 3, 0, 2], np.float32) / 4
    router = np.zeros((48, 8), np.float32)
    router[:2] = cols                                    # columns 2, 3, 5 tie
    router[2, 4] = router[2, 1] = 0.5                   # 1 and 4 tie too
    x = np.zeros((3, 48), np.float32)
    x[0, 0] = 1.0                                        # 2, 3, 5 on top
    x[1, 0] = x[1, 1] = 1.0
    x[2, 2] = 4.0                                        # 1, 4 on top
    jw, jidx, _ = jmoe._route(jnp.asarray(router), jnp.asarray(x), cfg_j)
    tw, tidx, _ = tmoe._route(torch.from_numpy(router), torch.from_numpy(x),
                              cfg_t)
    assert np.asarray(jidx).tolist() == [[2, 3], [2, 3], [1, 4]]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    probs = torch.tensor([[1.0, 2.0, 2.0, 0.5, 2.0]])
    assert tmoe.top_k(probs, 3)[1].tolist() == [[1, 2, 4]]


def test_positions_and_overflow_drops():
    """Half the tokens pick expert 0 first: at a capacity of 3 its slots
    fill and the rest of its choices drop; positions, the keep mask and
    the combined output equal the reference's."""
    rng = np.random.default_rng(5)
    n, e, k = 24, 8, 2
    experts = rng.integers(0, e, (n, k)).astype(np.int32)
    experts[::2, 0] = 0
    experts[:, 1] = np.where(experts[:, 1] == experts[:, 0],
                             (experts[:, 0] + 1) % e, experts[:, 1])
    cap = 3
    jpos, jkeep = jmoe._positions(jnp.asarray(experts), e, cap)
    tpos, tkeep = tmoe._positions(torch.from_numpy(experts), e, cap)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert (~np.asarray(jkeep)).sum() >= 9              # overflow happened
    jp, tp = _layer0("olmoe")
    x = _x(n, 48, 6)
    w = rng.random((n, k)).astype(np.float32)
    want = jmoe._dispatch_compute_combine(
        jp, jnp.asarray(x), jnp.asarray(w), jnp.asarray(experts), jpos,
        jkeep, 0, e, cap)
    got = tmoe._dispatch_compute_combine(
        tp, torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(experts), tpos, tkeep, cap)
    _close(got, want)
    dropped = ~np.asarray(jkeep).any(axis=1)
    assert dropped.any() and not got.numpy()[dropped].any()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_matches_reference(capacity_factor):
    jc, tc = _cfgs(capacity_factor=capacity_factor)
    jp, tp = _layer0("olmoe")
    x = _x(3 * 10, 48, 7).reshape(3, 10, 48)
    want, jaux = jmoe.moe_block(jp, jnp.asarray(x), jc, NO_RULES)
    got, taux = tmoe.moe_block(tp, torch.from_numpy(x), tc)
    _close(got, want)
    _close(taux, jaux)
    assert tmoe.capacity(30, tc) == int(np.ceil(30 * 2 / 8
                                                * capacity_factor))


def test_moe_block_deterministic_mode_and_mesh():
    """The layer runs under torch's deterministic mode (training's resume
    check sets it), and under a mesh of one rank its expert-parallel
    branch gives the dense branch's bits: y, aux and the gradients."""
    from repro_torch.dist import compat
    from repro_torch.dist.context import mesh_context
    from repro_torch.launch.mesh import make_host_mesh

    jp, tp = _layer0("kimi")
    x = torch.from_numpy(_x(12, 64, 8).reshape(2, 6, 64))
    ref = tmoe.moe_block(tp, x, tkimi.SMOKE.moe)[0]
    torch.use_deterministic_algorithms(True)
    try:
        got = tmoe.moe_block(tp, x, tkimi.SMOKE.moe)[0]
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got, ref)

    def run(p, x):
        p = {k: w.detach().requires_grad_() for k, w in p.items()}
        x = x.detach().requires_grad_()
        y, aux = tmoe.moe_block(p, x, tkimi.SMOKE.moe)
        ((y * y).sum() + aux).backward()
        return [y, aux, x.grad] + [p[k].grad for k in sorted(p)]

    want = run(tp, x)
    with compat.world1("gloo"):
        with mesh_context(make_host_mesh(1)):
            got = run(tp, x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# olmoe-smoke and kimi-smoke
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_prefill_caches(name):
    jc = CONFIGS[name][0]
    tok = _tokens(PREFILL["global_batch"], PREFILL["seq_len"])
    want, (jk, jv), jaux = jtf.forward(_params(name), jnp.asarray(tok), jc,
                                       return_cache=True)
    model = _model(name)
    with torch.no_grad():
        got, (tk, tv), aux = model(torch.from_numpy(tok), return_cache=True)
        logits, aux2 = model(torch.from_numpy(tok))
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    _close(aux, jaux)
    assert float(aux) > 0
    assert torch.equal(logits, got) and torch.equal(aux2, aux)
    last, (pk, _) = steps.prefill_fn(model, torch.from_numpy(tok))
    _close(last, np.asarray(want)[:, -1])
    assert torch.equal(pk, tk)


@pytest.mark.parametrize("name", CONFIGS)
def test_one_decode_step(name):
    jc = CONFIGS[name][0]
    b, s0, smax = DECODE["global_batch"], PREFILL["seq_len"], \
        DECODE["seq_len"]
    tok = _tokens(b, s0 + 1, seed=2)
    _, (jk, jv), _ = jtf.forward(_params(name), jnp.asarray(tok[:, :s0]),
                                 jc, return_cache=True)
    shape = (jc.n_layers, b, smax, jc.n_kv_heads, jc.hd)
    kc, vc = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    kc[:, :, :s0], vc[:, :, :s0] = np.asarray(jk), np.asarray(jv)
    want, (jk2, jv2), _ = jtf.decode(
        _params(name), jnp.asarray(tok[:, s0:]),
        (jnp.asarray(kc), jnp.asarray(vc)), jnp.int32(s0), jc)
    got, tk2, tv2, tlen = steps.lm_serve_fn(
        _model(name), torch.from_numpy(tok[:, s0:]),
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), s0)
    assert tlen == s0 + 1
    _close(got, want)
    _close(tk2, jk2)
    _close(tv2, jv2)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("name", CONFIGS)
def test_serve_batch_tokens(name, temperature):
    """Each decode step routes the batch's 4 tokens together: capacity 2
    an expert (ceil(4 · 2 / 8 · 1.25)), so a token can be dropped by the
    others in its step, alike in both."""
    prompts = _tokens(4, 8, seed=4)
    scfg = dict(max_new_tokens=12, cache_len=24, temperature=temperature,
                seed=5)
    want = jserve.serve_batch(_params(name), prompts, CONFIGS[name][0],
                              jserve.ServeConfig(**scfg))
    got = tserve.serve_batch(_model(name), prompts,
                             tserve.ServeConfig(**scfg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients(name):
    """loss_fn (cross-entropy + aux_weight · aux) and its gradient of
    every leaf within 1e-5 of the leaf's largest (the router's through
    the softmax and the aux loss, the experts' through the dispatch)."""
    jc = CONFIGS[name][0]
    tok = _tokens(2, 17, seed=9)
    jl, jg = jax.value_and_grad(jtf.loss_fn)(_params(name),
                                             jnp.asarray(tok), jc)
    model = _model(name)
    tl, tg = steps.bind(model, ttf.loss_fn, grad=True)(
        model.param_tree(), torch.from_numpy(tok))
    _close(tl, jl)
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_params_both_ways_in_bf16():
    """A bf16 olmoe-smoke: the reference's parameters (bf16, the router
    float32) into the port and back, exactly, each leaf in the
    reference's type."""
    jc = dataclasses.replace(jolmoe.SMOKE, dtype=jnp.bfloat16)
    tc = dataclasses.replace(tolmoe.SMOKE, dtype=torch.bfloat16)
    params = jax.tree.map(np.asarray, jax.jit(
        jtf.init_params, static_argnums=1)(jax.random.PRNGKey(1), jc))
    model = params_from_numpy(ttf.Transformer(tc, device="cpu"), params)
    moe = model.param_tree()["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wi"].dtype == model.embed.dtype == torch.bfloat16
    back = params_to_numpy(model)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            tree_leaves(back)):
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want.astype(np.float32))
    for got, want in zip(tree_leaves(model.param_tree()),
                         jax.tree.leaves(params)):
        assert str(got.dtype).split(".")[-1] == want.dtype.name
