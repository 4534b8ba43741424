"""The plain versions of the two backward kernels against ``jax.grad`` of
the reference's plain functions, at smoke widths in float32.

- ``embedding_bag_backward_ref`` (table and weight gradients) against
  ``jax.grad`` of the reference's ``embedding_bag_ref``, with repeated
  ids, weighted and not: within 1e-6 of the largest (float32 sums in
  another order).
- ``attention_lse_ref`` and ``attention_backward_ref`` against
  ``jax.grad`` of the reference's attention, causal and not, with GQA
  G = 1 (the reference kernel's ``attention_ref`` on its (BH, S, D)
  layout) and G = 3 (the transformer's ``full_attention`` and
  ``chunked_attention`` over repeated kv heads): within 1e-5 of the
  largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag
from repro.kernels.flash_attention.ref import attention_ref as j_attn_bhsd
from repro.models.lm import transformer as jtf
from repro_torch.kernels.embedding_bag import ref as ebref
from repro_torch.kernels.flash_attention import ref as faref


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("d", [10, 1, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_backward_ref_matches_jax_grad(d, weighted):
    rng = np.random.default_rng(d)
    v, b, k = 300, 16, 39
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, 60, (b, k)).astype(np.int32)     # repeats
    w = (rng.random((b, k)).astype(np.float32) if weighted
         else np.ones((b, k), np.float32))
    g = rng.normal(size=(b, d)).astype(np.float32)
    jt, jw = jax.grad(lambda t, ww: jnp.sum(j_bag(t, ids, ww) * g),
                      argnums=(0, 1))(table, w)
    tt, tw = ebref.embedding_bag_backward_ref(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(w) if weighted else None, torch.from_numpy(g),
        True, True)
    _close(tt.numpy(), jt, 1e-6)
    _close(tw.numpy(), jw, 1e-6)


def _jax_attention(name, q, k, v, causal, g):
    if name == "attention_ref":            # (BH, S, D), one head a row
        b, s, h, d = q.shape
        to = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, s, d)
        out = j_attn_bhsd(to(q), to(k), to(v), causal)
        return out.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    kf, vf = jtf._repeat_kv(k, g), jtf._repeat_kv(v, g)
    if name == "full_attention":
        return jtf.full_attention(q, kf, vf, causal)
    return jtf.chunked_attention(q, kf, vf, 16, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name,hk", [("attention_ref", 6),
                                     ("full_attention", 2),
                                     ("chunked_attention", 2),
                                     ("full_attention", 6)])
def test_attention_backward_ref_matches_jax_grad(causal, name, hk):
    rng = np.random.default_rng(hk + causal)
    b, s, h, d = 2, 40, 6, 16
    q, do = (rng.normal(size=(b, s, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, s, hk, d)).astype(np.float32)
            for _ in range(2))
    g = h // hk
    jo, vjp = jax.vjp(lambda q_, k_, v_: _jax_attention(
        name, q_, k_, v_, causal, g), q, k, v)
    jdq, jdk, jdv = vjp(do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = faref.attention_lse_ref(tq, tk, tv, causal)
    _close(o.numpy(), jo, 1e-5)
    sc = np.einsum("bskgd,btkd->bkgst", q.reshape(b, s, hk, g, d), k) \
        / np.sqrt(d)
    if causal:
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    want_lse = jax.nn.logsumexp(sc, axis=-1).reshape(b, h, s)
    _close(lse.numpy(), want_lse, 1e-6)
    got = faref.attention_backward_ref(tq, tk, tv, o, lse, tdo, causal)
    for a, w in zip(got, (jdq, jdk, jdv)):
        _close(a.numpy(), w, 1e-5)
