"""The port's block-sparse SpMM against the reference package.

``build_block_csr`` must give the reference's arrays exactly (slot order,
counts, padding).  The plain ``block_spmm_ref`` and ``aggregate_neighbors``
are held to the reference's Pallas kernel (interpret mode) and
``aggregate_neighbors`` on the same numpy-made inputs, to a float32
tolerance: the sums run in another order, and A's entries are small
integers, so |got - want| <= 1e-5 * (|A| @ |x|) + 1e-6.  The gradient of
``block_spmm`` is the same product on A^T, which for the symmetric A it
takes is A's own block-CSR: ``build_block_csr`` records whether A is
symmetric, and the backward raises for an A that is not.  The card's
tensor-core kernel splits each operand into two TF32 terms; a numpy
emulation of that split shows why (one TF32 product misses the
tolerance, the split passes) and that it keeps the plain version's
non-finite pattern.  The ``gpu`` cases hold both CUDA kernels against the
plain version on the card (the same tolerance and reason) and skip
without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.generators import barabasi_albert
from repro.graphs.generators import erdos_renyi as j_erdos_renyi
from repro.graphs.rmat import rmat as j_rmat
from repro.kernels.block_spmm import block_spmm as jbs
from repro.kernels.block_spmm import ops as jops
from repro_torch.kernels.block_spmm import ops, ref
from repro_torch.tools import block_csr_tiles as tiles

GRAPHS = {"ba300": lambda: np.asarray(barabasi_albert(300, 3, seed=0).edges),
          "rmat8": lambda: np.asarray(j_rmat(8, 8, seed=0).edges)}
NUM_NODES = {"ba300": 300, "rmat8": 256}


def _edges(name):
    return GRAPHS[name](), NUM_NODES[name]


def _x(rows, f, seed):
    return np.random.default_rng(seed).normal(size=(rows, f)).astype(
        np.float32)


def _spmm_off(got, want, cols, blocks, x):
    """The entries of ``got`` off ``want`` by more than 1e-5 * (|A| @ |x|)
    + 1e-6, on the rows that ``got`` has."""
    scale = ref.block_spmm_ref(cols, blocks.abs(), x.abs())[:len(got)]
    return (got - want).abs() > 1e-5 * scale + 1e-6


def _assert_spmm_close(got, want, cols, blocks, x):
    """|got - want| <= 1e-5 * (|A| @ |x|) + 1e-6, elementwise, on the rows
    that ``got`` has."""
    bad = _spmm_off(got, want, cols, blocks, x)
    assert not bad.any(), (f"{int(bad.sum())} entries off, max err "
                           f"{float((got - want).abs().max())}")


# --------------------------------------------------------------------------
# the host block-CSR builder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("directed_both", [True, False])
@pytest.mark.parametrize("b", [16, 32, 128])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_build_block_csr_matches_reference(graph, b, directed_both):
    e, n = _edges(graph)
    want = jbs.build_block_csr(e, n, b, b, directed_both)
    got = ops.build_block_csr(e, n, b, b, directed_both)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_build_block_csr_odd_inputs_match_reference():
    """No edges; a loop and a duplicate; bm != bn."""
    e = np.array([[3, 3], [0, 5], [5, 0], [0, 5], [20, 1]], np.int32)
    for args in ((np.zeros((0, 2), np.int32), 10, 16, 16),
                 (e, 21, 16, 16), (e, 21, 16, 32), (e, 40, 32, 16)):
        want = jbs.build_block_csr(*args)
        got = ops.build_block_csr(*args)
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("directed_both", [True, False])
@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tile_stats_count_what_build_block_csr_builds(graph, b,
                                                      directed_both):
    e, n = _edges(graph)
    cols, blocks, _ = ops.build_block_csr(e, n, b, b, directed_both)
    st = tiles.tile_stats(e, n, b, b, directed_both)
    assert (st["R"], st["NB"]) == cols.shape
    assert st["tiles"] == int((blocks.sum((2, 3)) != 0).sum())
    assert (st["blocks_bytes"], st["cols_bytes"]) == (blocks.nbytes,
                                                      cols.nbytes)


def test_expected_tiles_of_uniform_ids():
    rng = np.random.default_rng(0)
    n, m = 1 << 13, 20_000
    st = tiles.tile_stats(rng.integers(0, n, (m, 2)), n)
    assert abs(st["tiles"] / tiles.expected_tiles(n, m) - 1) < 0.01


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_directed_both_block_csr_is_its_own_transpose(graph):
    """A of ``directed_both`` is symmetric, so A^T's block-CSR (built from
    the reversed edges) is A's own: the backward reuses (cols, blocks)."""
    e, n = _edges(graph)
    a = ops.build_block_csr(e, n, 32, 32)
    at = ops.build_block_csr(e[:, ::-1], n, 32, 32)
    for g, w in zip(at[:2], a[:2]):
        np.testing.assert_array_equal(g, w)
    dense = ops.block_spmm(*(torch.from_numpy(t) for t in a[:2]),
                           torch.eye(a[2]))
    np.testing.assert_array_equal(dense.numpy(), dense.numpy().T)


# --------------------------------------------------------------------------
# the plain versions against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,f", [(32, 20), (128, 7)])
def test_block_spmm_ref_matches_pallas_interpret(b, f):
    e, n = _edges("rmat8")
    cols, blocks, n_pad = ops.build_block_csr(e, n, b, b)
    x = _x(n_pad, f, b)
    want = np.array(jbs.block_spmm(cols, blocks, x, interpret=True))
    tc, tb, tx = (torch.from_numpy(a) for a in (cols, blocks, x))
    got = ops.block_spmm(tc, tb, tx)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.block_spmm_ref(tc, tb, tx).numpy())
    _assert_spmm_close(got, torch.from_numpy(want), tc, tb, tx)
    # the edge-list primitive agrees on the same graph
    _assert_spmm_close(got[:n], ref.spmm_ref(e, tx[:n], n), tc, tb, tx)


def test_padded_slot_propagates_non_finite_as_reference():
    """A padded slot multiplies a zero block with x's column block 0, so an
    inf there turns the row tiles with padding into NaN, as on the TPU."""
    e = np.array([[0, 1], [0, 20], [40, 41]], np.int32)
    cols, blocks, n_pad = ops.build_block_csr(e, 48, 16, 16)
    assert cols.tolist() == [[0, 1], [0, 0], [2, 0]]   # rows 1, 2 padded
    x = _x(n_pad, 3, 1)
    x[5, 0] = np.inf
    want = np.asarray(jbs.block_spmm(cols, blocks, x, interpret=True))
    got = ops.block_spmm(*(torch.from_numpy(a) for a in (cols, blocks, x)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want).any()
    ok = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-6)


@pytest.mark.parametrize("b", [32, 128])
def test_aggregate_neighbors_matches_reference(b):
    e, n = _edges("ba300")
    x = _x(n, 10, 7)
    want = np.array(jops.aggregate_neighbors(e, jnp.asarray(x), n, b, b))
    want_ref = np.array(jops.aggregate_neighbors_reference(e, x, n))
    got = ops.aggregate_neighbors(e, torch.from_numpy(x), n, b, b)
    assert got.shape == (n, 10)
    cols, blocks, n_pad = ops.build_block_csr(e, n, b, b)
    tc, tb = torch.from_numpy(cols), torch.from_numpy(blocks)
    tx = torch.from_numpy(np.pad(x, ((0, n_pad - n), (0, 0))))
    for w in (want, want_ref):
        _assert_spmm_close(got, torch.from_numpy(w), tc, tb, tx)


@pytest.mark.parametrize("directed_both", [True, False])
def test_block_spmm_grad_equals_autograd_through_spmm_ref(directed_both):
    """The gradient in x: the product on A's own block-CSR, A^T = A, for a
    symmetric A built either way (``directed_both``, or both directions
    of each edge listed), against autograd through ``spmm_ref``'s gather
    and ``index_add_``."""
    e, n = _edges("ba300")
    if not directed_both:
        e = np.concatenate([e, e[:, ::-1]])
    csr = ops.build_block_csr(e, n, 32, 32, directed_both)
    cols, blocks, n_pad = csr
    assert csr.symmetric
    tc, tb = torch.from_numpy(cols), torch.from_numpy(blocks)
    x = torch.from_numpy(_x(n_pad, 6, 3)).requires_grad_()
    w = torch.from_numpy(_x(n_pad, 6, 4))
    launches = dict(ops.launches)
    (ops.block_spmm(tc, tb, x, csr.symmetric) * w).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    (ref.spmm_ref(e, x2, n_pad, directed_both) * w).sum().backward()
    _assert_spmm_close(x.grad, x2.grad, tc, tb, w)
    assert ops.launches == launches          # the CPU launches no kernel
    # cols and blocks take no gradient
    tb2 = tb.clone().requires_grad_()
    ops.block_spmm(tc, tb2, x.detach(), csr.symmetric).sum().backward()
    assert tb2.grad is None


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_block_csr_records_symmetry(graph):
    """True for ``directed_both`` and for edges listed both ways, False for
    one-directional edges; the record is the matrix's own symmetry."""
    e, n = _edges(graph)
    both = np.concatenate([e, e[:, ::-1]])
    for edges, directed_both, want in ((e, True, True), (both, False, True),
                                       (e, False, False)):
        csr = ops.build_block_csr(edges, n, 32, 32, directed_both)
        assert csr.symmetric is want
        dense = ops.block_spmm(*(torch.from_numpy(t) for t in csr[:2]),
                               torch.eye(csr[2]))
        assert bool((dense == dense.T).all()) is want


def test_block_spmm_grad_raises_for_one_directional_edges():
    """A one-directional A is not its own transpose: the backward raises
    rather than return A @ grad, the forward still matches the reference,
    and the same edges with ``directed_both=True`` get the gradient that
    autograd through ``spmm_ref`` gives."""
    e, n = _edges("rmat8")
    csr = ops.build_block_csr(e, n, 32, 32, directed_both=False)
    cols, blocks, n_pad = csr
    tc, tb = torch.from_numpy(cols), torch.from_numpy(blocks)
    x = torch.from_numpy(_x(n_pad, 5, 6))
    want = np.array(jbs.block_spmm(cols, blocks, x.numpy(), interpret=True))
    _assert_spmm_close(ops.block_spmm(tc, tb, x, csr.symmetric),
                       torch.from_numpy(want), tc, tb, x)
    with pytest.raises(ValueError, match="symmetric"):
        ops.block_spmm(tc, tb, x.clone().requires_grad_(),
                       csr.symmetric).sum().backward()
    with pytest.raises(ValueError, match="symmetric"):   # no record given
        ops.block_spmm(tc, tb, x.clone().requires_grad_()).sum().backward()
    csr = ops.build_block_csr(e, n, 32, 32, directed_both=True)
    tc, tb = torch.from_numpy(csr[0]), torch.from_numpy(csr[1])
    w = torch.from_numpy(_x(n_pad, 5, 7))
    xg = x.clone().requires_grad_()
    (ops.block_spmm(tc, tb, xg, csr.symmetric) * w).sum().backward()
    x2 = x.clone().requires_grad_()
    (ref.spmm_ref(e, x2, n_pad, True) * w).sum().backward()
    _assert_spmm_close(xg.grad, x2.grad, tc, tb, w)


def test_block_spmm_grad_needs_square_blocks():
    """With bm != bn A's block-CSR is not A^T's, so the backward raises
    rather than return a wrong gradient; the forward is the reference's."""
    e, n = _edges("rmat8")
    csr = ops.build_block_csr(e, n, 16, 32)
    cols, blocks, n_pad = csr
    tc, tb = torch.from_numpy(cols), torch.from_numpy(blocks)
    x = torch.from_numpy(_x(n_pad, 4, 5))
    want = np.array(jbs.block_spmm(cols, blocks, x.numpy(),
                                   interpret=True))
    _assert_spmm_close(ops.block_spmm(tc, tb, x), torch.from_numpy(want),
                       tc, tb, x)
    with pytest.raises(ValueError, match="bm == bn"):
        ops.block_spmm(tc, tb, x.requires_grad_(),
                       csr.symmetric).sum().backward()


def test_block_spmm_routes_by_device():
    cols = torch.zeros((1, 1), dtype=torch.int32)
    blocks = torch.zeros((1, 1, 16, 16))
    with pytest.raises(ValueError, match="no block_spmm kernel"):
        ops.block_spmm(cols.to("meta"), blocks.to("meta"),
                       torch.zeros((16, 2), device="meta"))


# --------------------------------------------------------------------------
# the tensor-core kernel's arithmetic, emulated
# --------------------------------------------------------------------------

def _tf32_rn(bits):
    """Round float32 bit patterns (int64) to TF32: nearest even on the 13
    low mantissa bits."""
    return (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000


def _f32(bits):
    return (bits & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _split_tf32(v):
    """block_spmm.cu's ``split_tf32`` in numpy: (hi, lo, hi with non-finite
    values set to 0), float32 arrays whose 13 low mantissa bits are 0."""
    v = np.ascontiguousarray(v, np.float32)
    b = v.view(np.uint32).astype(np.int64)
    finite = (b & 0x7F800000) != 0x7F800000
    r = _tf32_rn(b)
    carry = (r & 0x7F800000) == 0x7F800000
    r = np.where(carry, b & 0xFFFFE000, r)
    nonfin = np.where(b & 0x7FFFFF, 0x7FC00000, b)
    with np.errstate(invalid="ignore"):
        rest = (v - _f32(r)).view(np.uint32).astype(np.int64)
    lo = np.where(carry, rest & 0xFFFFE000, _tf32_rn(rest))
    return (_f32(np.where(finite, r, nonfin)), _f32(np.where(finite, lo, 0)),
            _f32(np.where(finite, r, 0)))


def _emulate_tc(cols, blocks, x, split):
    """The tensor-core kernel's sums on the CPU: TF32 products (exact in
    float32) summed in float32; A_lo x_hi + A_hi x_lo + A_hi x_hi with
    ``split``, A_hi x_hi alone without."""
    bm, bn = blocks.shape[2:]
    xb = x.reshape(-1, bn, x.shape[-1])[cols.astype(np.int64)]
    ah, al, af = (torch.from_numpy(t) for t in _split_tf32(blocks))
    xh, xl, xf = (torch.from_numpy(t) for t in _split_tf32(xb))
    out = torch.einsum("rjab,rjbf->raf", ah, xh)
    if split:
        out = (torch.einsum("rjab,rjbf->raf", al, xf)
               + torch.einsum("rjab,rjbf->raf", af, xl) + out)
    return out.reshape(-1, x.shape[-1])


TC_GRAPHS = {"rmat11": lambda: (np.asarray(j_rmat(11, 8, seed=2).edges),
                                2048),
             "er1000": lambda: (np.asarray(j_erdos_renyi(1000, 6.5,
                                                         seed=0).edges),
                                1000)}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("graph", sorted(TC_GRAPHS))
def test_one_tf32_product_misses_and_the_split_passes(graph, weighted):
    """At 128 x 128 blocks, A_hi x_hi alone misses 1e-5 * (|A| @ |x|)
    + 1e-6 (11 bits of x, and of A when its entries are edge counts times
    random weights); the three-product split passes: the kernel runs the
    split for that reason."""
    e, n = TC_GRAPHS[graph]()
    cols, blocks, n_pad = ops.build_block_csr(e, n, 128, 128)
    if weighted:
        blocks = blocks * _x(blocks.size, 1, 12).reshape(blocks.shape)
    x = _x(n_pad, 24, 11)
    tc, tb, tx = (torch.from_numpy(a) for a in (cols, blocks, x))
    want = ref.block_spmm_ref(tc, tb, tx)
    for split, ok in ((True, True), (False, False)):
        got = _emulate_tc(cols, blocks, x, split)
        assert bool(_spmm_off(got, want, tc, tb, tx).any()) is not ok


def test_tf32_split_keeps_the_plain_non_finite_pattern():
    """inf, -inf and NaN in x (in a padded slot's block 0 and elsewhere)
    and finite values near FLT_MAX: the emulated split gives exactly the
    plain version's NaN, +inf and -inf entries, and its finite entries
    within the tolerance; no finite operand becomes inf."""
    e = np.array([[0, 1], [0, 20], [40, 41], [3, 33]], np.int32)
    cols, blocks, n_pad = ops.build_block_csr(e, 256, 128, 128)
    x = _x(n_pad, 16, 2)
    x[5, 0], x[1, 3], x[20, 5], x[41, 7] = np.inf, -np.inf, np.nan, np.inf
    x[130, 2] = np.float32(3.4e38)
    x[33, 9] = -np.finfo(np.float32).max     # its rounding would carry
    hi, lo, fin = _split_tf32(x)
    ok = np.isfinite(x)
    assert np.isfinite(hi[ok]).all() and np.isfinite(hi[ok] + lo[ok]).all()
    assert (lo[~ok] == 0).all() and (fin[~ok] == 0).all()
    np.testing.assert_array_equal(np.isnan(hi), np.isnan(x))
    np.testing.assert_array_equal(hi[np.isinf(x)], x[np.isinf(x)])
    err = np.abs(hi[ok] + lo[ok] - x[ok])
    assert (err <= 2.0 ** -21 * np.abs(x[ok])).all()
    tc, tb, tx = (torch.from_numpy(a) for a in (cols, blocks, x))
    want = ref.block_spmm_ref(tc, tb, tx).numpy()
    got = _emulate_tc(cols, blocks, x, True).numpy()
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    assert np.isnan(want).any() and np.isinf(want).any()
    assert (want == -np.finfo(np.float32).max).any()
    ok = np.isfinite(want)
    scale = ref.block_spmm_ref(tc, tb.abs(), tx.abs()).numpy()
    assert (np.abs(got[ok] - want[ok]) <= 1e-5 * scale[ok] + 1e-6).all()


def test_kernel_design_and_slot_split():
    """Which (bm, bn) take the tensor-core kernel, how many columns of F
    a block covers, and how it splits the slots: the GIN cell (R = NB =
    22, 128 x 128, 132 SMs) splits at F = 64 and not at F = 1,433."""
    assert ops.design(128, 128) == "tc" and ops.design(64, 32) == "tc"
    for bm, bn in ((16, 16), (32, 32), (100, 128), (128, 48)):
        assert ops.design(bm, bn) == "fma"
    assert (ops.tc_cols(64), ops.tc_cols(65), ops.tc_cols(1433)) == (64, 128,
                                                                     128)
    assert ops.tc_slots_per_split(22, 22, 128, 64, 132) == 2
    assert ops.tc_slots_per_split(22, 22, 128, 1433, 132) == 22
    assert ops.tc_slots_per_split(22, 22, 128, 128, 132) == 4   # 6 splits
    assert ops.tc_slots_per_split(1, 200, 128, 1, 132) == 4     # 50 splits
    assert ops.tc_slots_per_split(3, 1, 128, 7, 132) == 1


# --------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,f", [(128, 1433), (128, 64), (16, 64),
                                 (32, 7), (16, 1)])
def test_block_spmm_kernel_matches_plain(cuda, b, f):
    e = np.asarray(j_rmat(11, 8, seed=2).edges)
    csr = ops.build_block_csr(e, 2048, b, b)
    cols, blocks, n_pad = csr
    tc, tb = (torch.from_numpy(a).to(cuda) for a in (cols, blocks))
    x = torch.from_numpy(_x(n_pad, f, f)).to(cuda).requires_grad_()
    before = ops.launches["block_spmm"]
    got = ops.block_spmm(tc, tb, x, csr.symmetric)
    torch.cuda.synchronize()
    assert ops.launches["block_spmm"] == before + 1
    _assert_spmm_close(got, ref.block_spmm_ref(tc, tb, x.detach()), tc, tb,
                       x.detach())
    g = torch.from_numpy(_x(n_pad, f, f + 1)).to(cuda)
    got.backward(g)
    assert ops.launches["block_spmm"] == before + 2
    _assert_spmm_close(x.grad, ref.block_spmm_ref(tc, tb, g), tc, tb, g)
    # the route this shape takes gives the same bits on a second call
    assert ops.design(b, b) == ("tc" if b == 128 else "fma")
    again = ops.block_spmm(tc, tb, x.detach())
    assert torch.equal(got.detach().view(torch.int32),
                       again.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,weighted", [
    (128, 64, False), (128, 1433, False), (128, 96, False), (128, 7, False),
    (128, 64, True), (128, 1433, True), (16, 64, False)])
def test_block_spmm_kernels_keep_non_finite_and_bits(cuda, b, f, weighted):
    """Each card kernel (``design``: tensor cores at 128 x 128, FMA at
    16 x 16; 64 or 128 columns a block; F = 64 and 96 split the slots,
    F = 1,433 does not; F = 1,433 and 7 pad x's rows to a multiple of 4
    floats; weighted A is not exact in TF32, so the tensor-core kernel
    splits it too): inf, -inf and NaN in x, padded slots included,
    give exactly the plain version's non-finite entries, the finite ones
    within the tolerance, and two calls give the same bits."""
    e = np.asarray(j_rmat(11, 8, seed=3).edges)
    csr = ops.build_block_csr(e, 2048, b, b)
    cols, blocks, n_pad = csr
    if weighted:
        blocks = blocks * _x(blocks.size, 1, 4).reshape(blocks.shape)
    assert ops.design(b, b) == ("tc" if b == 128 else "fma")
    x = _x(n_pad, f, 9)
    x[3, 0], x[700, f - 1], x[1500, f // 2] = np.inf, -np.inf, np.nan
    tc, tb, tx = (torch.from_numpy(a).to(cuda) for a in (cols, blocks, x))
    got, again = ops.block_spmm(tc, tb, tx), ops.block_spmm(tc, tb, tx)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = ref.block_spmm_ref(tc, tb, tx)
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want))
    assert bool(torch.isnan(want).any())
    ok = torch.isfinite(want)
    scale = ref.block_spmm_ref(tc, tb.abs(), tx.abs())
    assert bool(((got - want).abs()[ok] <= 1e-5 * scale[ok] + 1e-6).all())


@pytest.mark.gpu
def test_block_spmm_kernel_rejects_what_it_does_not_take(cuda):
    cols = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    blocks = torch.zeros((1, 1, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        ops.block_spmm(cols, blocks.double(),
                       torch.zeros((16, 2), dtype=torch.float64,
                                   device=cuda))
    with pytest.raises(ValueError):
        ops.block_spmm(cols, blocks, torch.zeros((17, 2), device=cuda))
    with pytest.raises(ValueError):
        ops.block_spmm(cols.cpu(), blocks, torch.zeros((16, 2), device=cuda))
