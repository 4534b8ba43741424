"""The port's DeepFM serving path against the reference package.

The reference's ``init_params`` go through ``params_from_numpy``; the
port's ``forward`` (two embedding bags through ``ops.embedding_bag``'s
plain version), ``loss_fn`` and ``retrieval_scores`` are held to the
reference's at 1e-5 relative (float32 sums in another order), at the
smoke config and at full width with few rows (39 fields × 1,024 rows,
D 10, MLP 400-400-400, batch 512).  The serve-side step bodies and the
flop estimates of ``launch/steps.py`` are held to the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepfm as jcfg
from repro.configs.shapes import RECSYS_SHAPES as J_SHAPES
from repro.launch import steps as jsteps
from repro.models.recsys import deepfm as jd
from repro_torch.configs import deepfm as tcfg
from repro_torch.configs.shapes import RECSYS_SHAPES, SMOKE_SHAPES
from repro_torch.launch import steps
from repro_torch.models.common import params_from_numpy, params_to_numpy
from repro_torch.models.recsys import deepfm as td
from repro_torch.tree import tree_leaves

FULL_WIDTH = dict(rows_per_field=1_024, n_candidates=4_096)


def _configs(name):
    if name == "smoke":
        return jcfg.SMOKE, tcfg.SMOKE, SMOKE_SHAPES["recsys"]["serve"]["batch"]
    return (dataclasses.replace(jcfg.CONFIG, **FULL_WIDTH),
            dataclasses.replace(tcfg.CONFIG, **FULL_WIDTH),
            RECSYS_SHAPES["serve_p99"]["batch"])


@functools.lru_cache(maxsize=None)
def _model(name):
    jc, tc, b = _configs(name)
    init = jax.jit(jd.init_params, static_argnums=1)
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jc))
    model = params_from_numpy(td.DeepFM(tc, device="cpu"), params)
    rng = np.random.default_rng(1)
    # raw ids beyond a field's rows and negative ones exercise the modulo
    x = rng.integers(-5_000, 5 * tc.rows_per_field,
                     size=(b, tc.n_fields)).astype(np.int32)
    y = (rng.random(b) < 0.3).astype(np.float32)
    return jc, params, model, x, y


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name", ["smoke", "full_width"])
def test_deepfm_matches_reference(name):
    jc, params, model, x, y = _model(name)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(model(tx), jd.forward(params, jx, jc))
    _close(td.loss_fn(model, tx, torch.from_numpy(y)),
           jd.loss_fn(params, jx, jnp.asarray(y), jc))
    _close(model.retrieval_scores(tx[:1]),
           jd.retrieval_scores(params, jx[:1], jc))
    np.testing.assert_array_equal(
        td._field_ids(tx, model.cfg).numpy(),
        np.asarray(jd._field_ids(jx, jc)))


def test_params_round_trip_in_reference_layout():
    _, params, model, _, _ = _model("smoke")
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_serve_steps_match_reference():
    jc, params, model, x, _ = _model("smoke")
    bundle = jsteps.make_recsys_step(jc, SMOKE_SHAPES["recsys"]["serve"])
    _close(steps.recsys_serve_fn(model, torch.from_numpy(x)),
           bundle.fn(params, jnp.asarray(x)))
    bundle = jsteps.make_recsys_step(jc, SMOKE_SHAPES["recsys"]["retrieval"])
    _close(steps.retrieval_fn(model, torch.from_numpy(x[:1])),
           bundle.fn(params, jnp.asarray(x[:1])))
    assert RECSYS_SHAPES == J_SHAPES
    for shape in RECSYS_SHAPES.values():
        assert steps.recsys_model_flops(tcfg.CONFIG, shape) == \
            jsteps.recsys_model_flops(jcfg.CONFIG, shape)


def test_forward_runs_two_embedding_bags(monkeypatch):
    _, _, model, x, _ = _model("smoke")
    from repro_torch.models.recsys import embedding

    calls = []
    real = embedding.ops.embedding_bag      # the bags go through this
    monkeypatch.setattr(embedding.ops, "embedding_bag",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    model(torch.from_numpy(x))
    assert calls == [model.w1.shape, model.table.shape]


def test_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        td.DeepFM(tcfg.SMOKE)
