"""The port's smollm-135m serving path against the reference package.

On ``smollm-135m-smoke`` (float32), the reference's ``init_params`` go
through ``params_from_numpy``; the port's ``forward`` logits and prefill
caches, its chunked-attention branch, one ``decode`` step and the
serve-side step bodies are held to the reference's at 1e-5 (float32 sums
in another order); ``serve_batch`` must give the reference's tokens,
greedy and sampled at temperature 0.7; ``random.categorical`` must draw
what ``jax.random.categorical`` draws.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as jcfg
from repro.configs.shapes import LM_SHAPES as J_SHAPES
from repro.launch import steps as jsteps
from repro.models.lm import serve as jserve
from repro.models.lm import transformer as jtf
from repro_torch import random as trandom
from repro_torch.configs import smollm_135m as tcfg
from repro_torch.configs.shapes import LM_SHAPES, SMOKE_SHAPES
from repro_torch.launch import steps
from repro_torch.models.common import params_from_numpy
from repro_torch.models.lm import serve as tserve
from repro_torch.models.lm import transformer as ttf

PREFILL = SMOKE_SHAPES["lm"]["prefill"]
DECODE = SMOKE_SHAPES["lm"]["decode"]
CHUNKED = dict(use_chunked_attn_from=8, attn_chunk=8)


@functools.lru_cache(maxsize=None)
def _params():
    init = jax.jit(jtf.init_params, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg.SMOKE))


def _model(**over):
    cfg = dataclasses.replace(tcfg.SMOKE, **over)
    return params_from_numpy(ttf.Transformer(cfg, device="cpu"), _params())


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, tcfg.SMOKE.vocab, size=(b, s)).astype(np.int32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("over", [{}, CHUNKED], ids=["full", "chunked"])
def test_forward_and_prefill_caches(over):
    jc = dataclasses.replace(jcfg.SMOKE, **over)
    tok = _tokens(PREFILL["global_batch"], PREFILL["seq_len"])
    want, (jk, jv), _ = jtf.forward(_params(), jnp.asarray(tok), jc,
                                    return_cache=True)
    model = _model(**over)
    got, (tk, tv), aux = model(torch.from_numpy(tok), return_cache=True)
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    assert float(aux) == 0.0
    logits, _ = model(torch.from_numpy(tok))
    np.testing.assert_array_equal(logits.detach().numpy(),
                                  got.detach().numpy())


def test_chunked_branch_equals_full_attention():
    tok = torch.from_numpy(_tokens(2, 16, seed=1))
    full, _ = _model()(tok)
    chunked, _ = _model(**CHUNKED)(tok)
    _close(chunked, full.detach().numpy())


def test_one_decode_step():
    b, s0, smax = DECODE["global_batch"], PREFILL["seq_len"], \
        DECODE["seq_len"]
    tok = _tokens(b, s0 + 1, seed=2)
    _, (jk, jv), _ = jtf.forward(_params(), jnp.asarray(tok[:, :s0]),
                                 jcfg.SMOKE, return_cache=True)
    shape = (jcfg.SMOKE.n_layers, b, smax, jcfg.SMOKE.n_kv_heads,
             jcfg.SMOKE.hd)
    kc, vc = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    kc[:, :, :s0], vc[:, :, :s0] = np.asarray(jk), np.asarray(jv)
    want, (jk2, jv2), jlen = jtf.decode(
        _params(), jnp.asarray(tok[:, s0:]), (jnp.asarray(kc),
                                              jnp.asarray(vc)),
        jnp.int32(s0), jcfg.SMOKE)
    model = _model()
    caches = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    got, tk2, tv2, tlen = steps.lm_serve_fn(
        model, torch.from_numpy(tok[:, s0:]), *caches, s0)
    assert tlen == int(jlen) == s0 + 1
    _close(got, want)
    _close(tk2, jk2)
    _close(tv2, jv2)
    assert tk2 is caches[0]                      # written in place


def test_prefill_step_and_flops():
    tok = _tokens(PREFILL["global_batch"], PREFILL["seq_len"], seed=3)
    bundle = jsteps.make_lm_step(jcfg.SMOKE, PREFILL)
    want, (jk, _) = bundle.fn(_params(), jnp.asarray(tok))
    got, (tk, _) = steps.prefill_fn(_model(), torch.from_numpy(tok))
    _close(got, want)
    _close(tk, jk)
    assert LM_SHAPES == J_SHAPES
    for shape in LM_SHAPES.values():
        assert steps.lm_model_flops(tcfg.CONFIG, shape) == \
            jsteps.lm_model_flops(jcfg.CONFIG, shape)
    assert tcfg.CONFIG.param_count() == jcfg.CONFIG.param_count()


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_serve_batch_tokens(temperature):
    prompts = _tokens(4, 8, seed=4)
    scfg = dict(max_new_tokens=12, cache_len=24, temperature=temperature,
                seed=5)
    want = jserve.serve_batch(_params(), prompts, jcfg.SMOKE,
                              jserve.ServeConfig(**scfg))
    got = tserve.serve_batch(_model(), prompts, tserve.ServeConfig(**scfg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,shape,axis", [
    (0, (4, 512), -1), (1, (3, 49152), -1), (2, (1000,), -1),
    (3, (5, 7, 11), 1), (4, (6, 9), 0), (5, (8, 512), -1)])
def test_categorical_draws_jax_samples(seed, shape, axis):
    logits = np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * 3
    want = jax.random.categorical(jax.random.PRNGKey(seed),
                                  jnp.asarray(logits), axis=axis)
    got = trandom.categorical(trandom.PRNGKey(seed, device="cpu"),
                              torch.from_numpy(logits), axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    noise = trandom.gumbel(trandom.PRNGKey(seed, device="cpu"), shape)
    np.testing.assert_allclose(
        noise.numpy(), np.asarray(jax.random.gumbel(
            jax.random.PRNGKey(seed), shape)), rtol=1e-6, atol=1e-6)


def test_moe_model_has_the_reference_layout():
    """An MoE config builds (on the meta device) olmoe-1b-7b's full
    parameter tree, leaf for leaf the reference's shapes and types: the
    experts stacked over the layers in bf16, the router in float32, no
    dense FFN; its parameter counts are the reference's (which leave out
    the norms and routers)."""
    from repro.configs import olmoe_1b_7b as jolmoe
    from repro_torch.configs import olmoe_1b_7b as tolmoe
    from repro_torch.tree import tree_leaves

    want = jax.eval_shape(functools.partial(jtf.init_params,
                                            cfg=jolmoe.CONFIG),
                          jax.random.PRNGKey(0))
    model = ttf.Transformer(tolmoe.CONFIG, device="meta")
    tree = model.param_tree()
    assert "wi" not in tree["layers"] and "wo_ffn" not in tree["layers"]
    assert sorted(tree["layers"]["moe"]) == sorted(want["layers"]["moe"])
    got = tree_leaves(tree)
    assert len(got) == len(jax.tree.leaves(want))
    for t, j in zip(got, jax.tree.leaves(want)):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
    c = tolmoe.CONFIG
    uncounted = c.n_layers * (2 * c.d_model + c.d_model * c.moe.n_experts) \
        + c.d_model                      # norms and routers: not in the count
    assert sum(p.numel() for p in model.parameters()) - uncounted == \
        c.param_count() == jolmoe.CONFIG.param_count()
    assert tolmoe.CONFIG.active_param_count() == \
        jolmoe.CONFIG.active_param_count()
