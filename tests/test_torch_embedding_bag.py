"""The port's embedding bag against the reference package.

The plain version (the CPU route of ``ops.embedding_bag``) is held to the
reference's Pallas kernel (interpret mode, through its ``ops``) and to
its ``embedding_bag_ref`` on the same numpy-made inputs: 1e-5 in float32
(only the order of the float32 sums differs), 3e-2 with a bfloat16 table
(the reference's own tolerance: one bf16 rounding of the output, in
places that may differ).  ``mean`` keeps each module's rule: the kernel's
front door divides by Σ w (clamped at 1e-9), ``embedding_bag_dense`` by
K.  A padding slot (weight 0) still reads its row, so a NaN row read only
by padding gives NaN, as on the TPU.  ``ref.embedding_bag_inorder_ref``
(the slot-by-slot float32 sum) is held to the Pallas kernel, which sums
slot by slot too: bit for bit without weights, and within 1e-6 +
1e-5·|want| in float32 with weights (XLA may fuse the product and the
add, the plain sum rounds both).  ``ops.plan``'s cut is checked on the
CPU.  The ``gpu`` cases hold the CUDA kernel against the plain versions
on the card, at each of its routes, and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jops
from repro.kernels.embedding_bag.embedding_bag import embedding_bag_kernel
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,d,b,k", [(50, 16, 8, 4), (4000, 10, 16, 39),
                                     (4000, 1, 16, 39), (128, 128, 5, 1)])
def test_inorder_ref_matches_pallas_kernel(v, d, b, k, dtype):
    table, ids, w = _inputs(v, d, b, k, v + b)
    w = w * np.random.default_rng(v).random((b, k)).astype(np.float32)
    jt = jnp.asarray(table).astype(dtype)
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    ti = torch.from_numpy(ids)
    for tw, jw in ((None, jnp.ones((b, k), jnp.float32)),
                   (torch.from_numpy(w), jnp.asarray(w))):
        want = np.asarray(embedding_bag_kernel(jt, jnp.asarray(ids), jw,
                                               interpret=True), np.float32)
        got = ref.embedding_bag_inorder_ref(tt, ti, tw)
        assert got.dtype == tt.dtype and got.shape == (b, d)
        got = got.float().numpy()
        if tw is None:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("b,k,d,size,weighted,ptr,want", [
    (512, 39, 1, 4, False, 0, dict(g=1, kt=39, vec=1)),      # serve_p99 w1
    (512, 39, 10, 4, False, 0, dict(g=1, kt=39, vec=2)),     # serve_p99
    (262_144, 39, 10, 4, False, 0, dict(g=6, kt=39, vec=2)),  # serve_bulk
    (262_144, 39, 1, 4, False, 0, dict(g=27, kt=39, vec=1)),
    (3, 2048, 64, 4, True, 0, dict(g=1, kt=185, vec=4)),     # tiles
    (40, 20, 128, 2, False, 0, dict(g=1, kt=20, vec=8)),     # bf16
    (40, 20, 128, 4, False, 4, dict(g=1, kt=20, vec=1)),     # unaligned
    (5, 300, 5000, 4, True, 0, dict(g=1, kt=10, dt=1024, vec=4)),
])
def test_plan_cuts_within_the_budget(b, k, d, size, weighted, ptr, want):
    """G whole bags a block within 48 KB and at least 2 blocks an SM
    where B allows, else one bag in tiles of slots; VEC elements a load
    only where the row and the address allow."""
    cut = ops.plan(b, k, d, size, weighted, ptr)
    assert {f: getattr(cut, f) for f in want} == want
    assert cut.kt == k or cut.g == 1
    assert 1 <= cut.kt <= k and 1 <= cut.g <= b
    assert cut.dt == min(d, ops.MAX_COLS) and cut.dt % cut.vec == 0
    assert d % cut.vec == 0 and ptr % (cut.vec * size) == 0
    assert cut.vec * size <= 16
    need = 4 * cut.g * cut.kt * (1 + weighted + cut.dt) + (
        4 * cut.dt if cut.kt < k else 0)
    assert need <= cut.smem <= ops.SMEM_BUDGET
    assert cut.threads % 32 == 0 and 32 <= cut.threads <= ops.THREADS
    if b >= 2 * ops.SMS:
        assert -(-b // cut.g) >= 2 * ops.SMS


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


@pytest.mark.gpu
@pytest.mark.parametrize("v,d,b,k,dtype,offset,vec", [
    (40_000, 10, 1, 39, torch.float32, 0, 2),        # B = 1
    (40_000, 10, 1001, 39, torch.float32, 0, 2),     # G = 3, B % G = 2
    (40_000, 1, 1001, 39, torch.bfloat16, 0, 1),
    (40_000, 1, 262_144, 39, torch.float32, 0, 1),   # G = 27, B % G = 1
    (5_000, 64, 3, 2048, torch.float32, 0, 4),       # tiles of slots
    (5_000, 64, 3, 2048, torch.bfloat16, 0, 8),
    (2_000, 128, 40, 20, torch.float32, 0, 4),
    (3_000, 1100, 4, 7, torch.float32, 0, 4),        # two column tiles
    (1_000, 7, 300, 5, torch.bfloat16, 0, 1),
    (1_000, 10, 300, 39, torch.float32, 1, 1),       # a view 4 B off
], ids=["B1", "G3", "G3-w1-bf16", "G27", "tiles", "tiles-bf16", "vec4",
        "cols", "D7-bf16", "unaligned"])
def test_embedding_bag_kernel_routes(cuda, v, d, b, k, dtype, offset, vec):
    """Each cut of the kernel against the plain versions: without weights
    (and with 0/1 weights, whose products are exact) bit for bit the
    in-order float32 sum; with random weights within 1e-6 + 1e-5·Σ|w·row|
    (float32 sums of K rounded products in another order: a bound on the
    terms, since the sum itself may cancel to near 0) + 2^-7·|plain| for
    bf16 (one rounding of float32 sums that differ in the last bits); and
    the same bits from call to call."""
    gen = torch.Generator(device=cuda).manual_seed(v + b)
    flat = torch.randn(v * d + offset, generator=gen, device=cuda)
    tt = flat[offset:].view(v, d).to(dtype) if dtype != torch.float32 \
        else flat[offset:].view(v, d)
    ti = torch.randint(0, v, (b, k), generator=gen, device=cuda,
                       dtype=torch.int32)
    w01 = (torch.rand((b, k), generator=gen, device=cuda) >= 0.1).float()
    wr = torch.rand((b, k), generator=gen, device=cuda)
    cut = ops.plan(b, k, d, tt.element_size(), False, tt.data_ptr())
    assert cut.vec == vec
    assert (cut.kt < k) == (k == 2048)
    before = ops.launches["embedding_bag"]
    got = ops.embedding_bag(tt, ti)
    assert torch.equal(got, ref.embedding_bag_inorder_ref(tt, ti))
    assert torch.equal(ops.embedding_bag(tt, ti), got)
    got = ops.embedding_bag(tt, ti, w01)
    assert torch.equal(got, ref.embedding_bag_inorder_ref(tt, ti, w01))
    got = ops.embedding_bag(tt, ti, wr)
    assert torch.equal(ops.embedding_bag(tt, ti, wr), got)
    want = ref.embedding_bag_ref(tt, ti, wr).float()
    terms = ref.embedding_bag_ref(tt.float().abs(), ti, wr).float()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    err = (got.float() - want).abs()
    assert bool((err <= 1e-6 + 1e-5 * terms + rtol * want.abs()).all()), \
        float(err.max())
    assert ops.launches["embedding_bag"] == before + 5
