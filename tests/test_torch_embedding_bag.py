"""The port's embedding bag against the reference package.

The plain version (the CPU route of ``ops.embedding_bag``) is held to the
reference's Pallas kernel (interpret mode, through its ``ops``) and to
its ``embedding_bag_ref`` on the same numpy-made inputs: 1e-5 in float32
(only the order of the float32 sums differs), 3e-2 with a bfloat16 table
(the reference's own tolerance: one bf16 rounding of the output, in
places that may differ).  ``mean`` keeps each module's rule: the kernel's
front door divides by Σ w (clamped at 1e-9), ``embedding_bag_dense`` by
K.  A padding slot (weight 0) still reads its row, so a NaN row read only
by padding gives NaN, as on the TPU.  The ``gpu`` cases hold the CUDA
kernel against the plain version on the card and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jops
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jref
from repro.models.recsys import embedding as jemb
from repro_torch.kernels.embedding_bag import ops, ref
from repro_torch.models.recsys import embedding as temb


def _inputs(v, d, b, k, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, k)).astype(np.int32)
    w = (rng.random((b, k)) > 0.2).astype(np.float32)
    return table, ids, w


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,d,b,k", [(50, 16, 8, 4), (1000, 64, 32, 10),
                                     (128, 128, 5, 1), (4000, 10, 64, 39),
                                     (4000, 1, 64, 39)])
def test_embedding_bag_sweep(v, d, b, k, dtype):
    table, ids, w = _inputs(v, d, b, k, v + b)
    jt = jnp.asarray(table).astype(dtype)
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    want = jops.embedding_bag(jt, jnp.asarray(ids), jnp.asarray(w))
    got = ops.embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(w))
    assert got.dtype == tt.dtype and got.shape == (b, d)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    _close(got, np.asarray(want, np.float32), tol)
    _close(got, np.asarray(jref(jt, jnp.asarray(ids), jnp.asarray(w)),
                           np.float32), tol)
    # no weights: weight 1 in every slot
    _close(ops.embedding_bag(tt, torch.from_numpy(ids)),
           np.asarray(jops.embedding_bag(jt, jnp.asarray(ids)), np.float32),
           tol)


def test_mean_mode_divides_by_the_weights():
    table, ids, w = _inputs(40, 8, 6, 5, 3)
    w[2] = 0.0                                   # an all-padding bag
    args = (torch.from_numpy(table), torch.from_numpy(ids))
    for tw, jw in ((None, None), (torch.from_numpy(w), jnp.asarray(w))):
        got = ops.embedding_bag(*args, tw, mode="mean")
        want = jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jw,
                                  mode="mean")
        _close(got, np.asarray(want), 1e-5)
    np.testing.assert_allclose(
        ops.embedding_bag(*args, mode="mean").numpy(),
        table[ids].mean(axis=1), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        ops.embedding_bag(*args, mode="max")


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_dense_mean_divides_by_k(weighted):
    table, ids, w = _inputs(40, 8, 6, 5, 4)
    tw = torch.from_numpy(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    for mode in ("sum", "mean"):
        got = temb.embedding_bag_dense(torch.from_numpy(table),
                                       torch.from_numpy(ids), weights=tw,
                                       mode=mode)
        want = jemb.embedding_bag_dense(jnp.asarray(table), jnp.asarray(ids),
                                        weights=jw, mode=mode)
        _close(got, np.asarray(want), 1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_dense_offsets(weighted):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    ids = rng.integers(0, 30, size=17).astype(np.int32)
    offsets = np.array([0, 3, 3, 9, 17], np.int32)   # one empty bag
    w = rng.random(17).astype(np.float32)
    tw = torch.from_numpy(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    for mode in ("sum", "mean"):
        got = temb.embedding_bag_dense(
            torch.from_numpy(table), torch.from_numpy(ids),
            torch.from_numpy(offsets), tw, mode)
        want = jemb.embedding_bag_dense(jnp.asarray(table), jnp.asarray(ids),
                                        jnp.asarray(offsets), jw, mode)
        _close(got, np.asarray(want), 1e-5)


def test_sharded_lookup_is_the_gather():
    table, ids, _ = _inputs(40, 8, 6, 5, 6)
    got = temb.sharded_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    want = jemb.sharded_lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_padding_slot_reads_its_row():
    table, ids, w = _inputs(20, 4, 5, 3, 7)
    table[13] = np.nan
    ids[:, :] = np.where(ids == 13, 0, ids)
    ids[1, 2], w[1, 2] = 13, 0.0                 # only a padding slot
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(w)).numpy()
    want = np.asarray(jops.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(ids), jnp.asarray(w)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and np.isfinite(np.delete(got, 1, 0)).all()
    np.testing.assert_allclose(np.delete(got, 1, 0), np.delete(want, 1, 0),
                               atol=1e-5, rtol=1e-5)


def test_plain_version_is_the_reference_formula():
    table, ids, w = _inputs(60, 10, 7, 39, 8)
    got = ref.embedding_bag_ref(torch.from_numpy(table),
                                torch.from_numpy(ids), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(),
                               (table[ids] * w[..., None]).sum(1),
                               atol=1e-5, rtol=1e-5)


def test_other_devices_raise():
    table, ids, _ = _inputs(10, 4, 2, 3, 9)
    with pytest.raises(ValueError):
        ops.embedding_bag(torch.from_numpy(table).to("meta"),
                          torch.from_numpy(ids).to("meta"))


# --------------------------------------------------------------------------
# the CUDA kernel (on a card only)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,k", [(50, 16, 8, 4), (1000, 64, 32, 10),
                                     (128, 128, 5, 1), (40_000, 10, 512, 39),
                                     (40_000, 1, 512, 39)])
def test_embedding_bag_kernel_matches_plain(cuda, v, d, b, k, dtype):
    table, ids, w = _inputs(v, d, b, k, v + b)
    tt = torch.from_numpy(table).to(cuda, dtype)
    ti, tw = torch.from_numpy(ids).to(cuda), torch.from_numpy(w).to(cuda)
    before = ops.launches["embedding_bag"]
    for weights in (tw, None):
        got = ops.embedding_bag(tt, ti, weights)
        torch.cuda.synchronize()
        want = ref.embedding_bag_ref(
            tt, ti, weights if weights is not None else torch.ones_like(tw))
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    assert ops.launches["embedding_bag"] == before + 2


@pytest.mark.gpu
def test_embedding_bag_kernel_padding_nan(cuda):
    table, ids, w = _inputs(20, 4, 5, 3, 7)
    table[13] = np.nan
    ids[:, :] = np.where(ids == 13, 0, ids)
    ids[1, 2], w[1, 2] = 13, 0.0
    got = ops.embedding_bag(torch.from_numpy(table).to(cuda),
                            torch.from_numpy(ids).to(cuda),
                            torch.from_numpy(w).to(cuda)).cpu().numpy()
    assert np.isnan(got[1]).all() and np.isfinite(np.delete(got, 1, 0)).all()


@pytest.mark.gpu
def test_embedding_bag_kernel_rejects_what_it_does_not_take(cuda):
    table = torch.zeros((10, 4), device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.embedding_bag(table.double(), ids)
    with pytest.raises(ValueError):
        ops.embedding_bag(table, ids.cpu())
    with pytest.raises(ValueError):
        ops.embedding_bag(table.t(), ids)
