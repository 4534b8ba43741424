"""The port's bit-packed replica-set kernels against the reference package.

``pack_bits``, ``unpack_bits`` and ``or_words`` on the CPU run their plain
versions; each is held, exactly, against the reference's XLA version and
its Pallas kernel in interpret mode, on the same numpy-made inputs, for
ragged and whole-word partition counts, with bit 31 set and pad bits 0.
The port's words are the int32 bit patterns of the reference's uint32
words.  The ``gpu`` cases hold the CUDA kernels against the plain
versions on the card and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ne_round import ne_round as ne_pl
from repro.kernels.ne_round import ref as jref
from repro_torch.kernels.ne_round import ops, ref

P_LIST = [1, 31, 32, 37, 64, 96, 100, 128]


def _bools(n, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, p)) < 0.5
    x[::3, -1] = True                      # the last partition's bit
    if p >= 32:
        x[::2, 31] = True                  # bit 31 of word 0
    return x


def _words(n, p, seed, pad_bits=False):
    """(N, W) uint32 words with bit 31 set in many, pad bits 0 unless
    ``pad_bits``."""
    rng = np.random.default_rng(seed)
    w = ref.replica_words(p)
    words = rng.integers(0, 2**32, (n, w)).astype(np.uint32)
    words[::4] |= np.uint32(1 << 31)
    if not pad_bits and p % 32:
        words[:, -1] &= np.uint32((1 << (p % 32)) - 1)
    return words


@pytest.mark.parametrize("p", P_LIST)
def test_pack_bits_matches_reference(p):
    x = _bools(300, p, p)
    got = ops.pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (300, (p + 31) // 32)
    got_u = got.numpy().view(np.uint32)
    for want in (jref.pack_bits_ref(jnp.asarray(x)),
                 ne_pl.pack_bits(jnp.asarray(x), block_rows=128,
                                 interpret=True)):
        np.testing.assert_array_equal(got_u, np.asarray(want))
    if p % 32:                                             # pad bits 0
        assert not (got_u[:, -1] >> np.uint32(p % 32)).any()
    if p >= 32:
        assert (got_u[::2, 0] >> np.uint32(31) == 1).all()
        assert (got[::2, 0] < 0).all()                   # bit 31 → sign
    np.testing.assert_array_equal(ref.pack_bits_np(x).view(np.uint32),
                                  jref.pack_bits_np(x))


@pytest.mark.parametrize("p", P_LIST)
def test_unpack_bits_matches_reference(p):
    words = _words(300, p, p, pad_bits=True)      # unpacking ignores them
    got = ops.unpack_bits(torch.from_numpy(words.view(np.int32)), p)
    assert got.dtype == torch.bool and got.shape == (300, p)
    assert got.is_contiguous()
    for want in (jref.unpack_bits_ref(jnp.asarray(words), p),
                 ne_pl.unpack_bits(jnp.asarray(words), p, block_rows=128,
                                   interpret=True)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_np = jref.unpack_bits_np(words, p)
    np.testing.assert_array_equal(ref.unpack_bits_np(words.view(np.int32), p),
                                  want_np)
    np.testing.assert_array_equal(ref.unpack_bits_np(words, p), want_np)
    # pack(unpack(w)) is w with its pad bits cleared
    clean = _words(300, p, p)
    np.testing.assert_array_equal(
        ops.pack_bits(ops.unpack_bits(torch.from_numpy(clean.view(np.int32)),
                                      p)).numpy().view(np.uint32), clean)


@pytest.mark.parametrize("p", P_LIST)
def test_or_words_matches_reference(p):
    a, b = _words(300, p, p), _words(300, p, p + 1000)
    got = ops.or_words(torch.from_numpy(a.view(np.int32)),
                       torch.from_numpy(b.view(np.int32)))
    assert got.dtype == torch.int32
    for want in (jref.or_words_ref(jnp.asarray(a), jnp.asarray(b)),
                 ne_pl.or_words(jnp.asarray(a), jnp.asarray(b),
                                block_rows=128, interpret=True)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))


def test_bits_front_door_routes_by_device():
    """CPU tensors take the plain versions (no launch counted); a device
    with no kernel raises."""
    ops.reset_launches()
    x = torch.rand(10, 37) < 0.5
    w = ops.pack_bits(x)
    ops.or_words(w, ops.pack_bits(ops.unpack_bits(w, 37)))
    assert all(v == 0 for v in ops.launches.values())
    meta = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.unpack_bits(meta, 37)
    with pytest.raises(ValueError):
        ops.or_words(meta, w[:4])


@pytest.mark.parametrize("p,offset,route", [
    (32, 0, "vector"), (64, 0, "vector"), (128, 0, "vector"),
    (64, 1, "ballot"), (64, 16, "vector"), (37, 0, "ballot"),
    (1, 0, "ballot")])
def test_pack_bits_route_by_p_and_alignment(p, offset, route):
    """The card's route follows P % 32 and the map's 16-byte alignment
    (torch's allocations are aligned; a view may not be)."""
    base = torch.zeros(10 * p + offset, dtype=torch.bool)
    x = base[offset:].view(10, p)
    assert base.data_ptr() % 16 == 0
    assert ops.pack_bits_route(x) == route


@pytest.mark.parametrize("p,w,route", [
    (32, 1, "vector"), (64, 2, "vector"), (96, 3, "vector"),
    (128, 4, "vector"), (37, 2, "generic"), (48, 2, "generic"),
    (1, 1, "generic"), (64, 3, "generic")])
def test_unpack_bits_route_by_p(p, w, route):
    """The card's route follows P == 32 W: word t is then flag bytes
    32t .. 32t + 31 of the map.  Ragged P, and words past those P needs,
    take the generic kernel."""
    words = torch.zeros((10, w), dtype=torch.int32)
    assert ops.unpack_bits_route(words, p) == route


@pytest.mark.parametrize("offsets,route", [
    ((0, 0, 0), "vector"), ((4, 4, 4), "vector"), ((1, 0, 0), "scalar"),
    ((0, 1, 0), "scalar"), ((0, 0, 1), "scalar"), ((2, 2, 2), "scalar")])
def test_or_words_route_by_alignment(offsets, route):
    """The card's route follows the 16-byte alignment of a, b and out
    together (offsets in int32 words from torch's aligned allocations)."""
    a, b, out = (torch.zeros(20 + k, dtype=torch.int32)[k:]
                 for k in offsets)
    assert ops.or_words_route(a, b, out) == route


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 37, 64, 100])
def test_pack_unpack_kernels_match_plain(cuda, p):
    n = 1 << 16
    x = torch.from_numpy(_bools(n, p, 3)).to(cuda)
    before = dict(ops.launches)
    words = ops.pack_bits(x)
    torch.testing.assert_close(words, ref.pack_bits_ref(x), rtol=0, atol=0)
    dirty = torch.from_numpy(_words(n, p, 4, pad_bits=True)
                             .view(np.int32)).to(cuda)
    got = ops.unpack_bits(dirty, p)
    torch.testing.assert_close(got, ref.unpack_bits_ref(dirty, p), rtol=0,
                               atol=0)
    torch.testing.assert_close(ops.unpack_bits(words, p), x, rtol=0, atol=0)
    assert ops.launches["pack_bits"] == before["pack_bits"] + 1
    assert ops.launches["unpack_bits"] == before["unpack_bits"] + 2


@pytest.mark.gpu
@pytest.mark.parametrize("offset,route", [(0, "vector"), (1, "scalar"),
                                          (4, "vector")])
def test_or_words_kernel_matches_plain(cuda, offset, route):
    """Both routes exactly equal the plain version at a word count that is
    not a multiple of 4 (the vector route's tail); ``offset`` words off
    the allocation (1: every operand 4 bytes off 16-byte alignment, the
    scalar route); two calls give the same bits."""
    n, w = (1 << 20) + 3, 2
    flat = [torch.from_numpy(_words(n * w + offset, 32, s)
                             .view(np.int32).ravel()).to(cuda)
            for s in (5, 6)]
    a, b = (f[offset:].view(n, w) for f in flat)
    assert ops.or_words_route(a, b, torch.empty_like(a)) == route
    before = ops.launches["or_words"]
    got = ops.or_words(a, b)
    torch.testing.assert_close(got, ref.or_words_ref(a, b), rtol=0, atol=0)
    assert torch.equal(ops.or_words(a, b), got)
    assert ops.launches["or_words"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("p,offset,route", [
    (32, 0, "vector"), (64, 0, "vector"), (96, 0, "vector"),
    (128, 0, "vector"), (64, 1, "ballot"), (37, 0, "ballot")])
def test_pack_bits_routes_match_plain(cuda, p, offset, route):
    """The vector route (P % 32 == 0, a 16-byte aligned map) and the
    ballot route (ragged P, a view 1 byte off) exactly equal the plain
    version; N·W is not a multiple of a vector block's 1,024 words, and
    flags that are not 0 or 1 (a uint8 map viewed as bool) count as set."""
    n = (1 << 16) + 3
    gen = torch.Generator(device=cuda).manual_seed(p + offset)
    raw = torch.randint(0, 4, (n * p + offset,), generator=gen, device=cuda,
                        dtype=torch.uint8)
    raw[offset::37] = 0x80                   # a flag byte with bit 7 alone
    x = raw[offset:].view(torch.bool).view(n, p)
    assert ops.pack_bits_route(x) == route
    before = ops.launches["pack_bits"]
    got = ops.pack_bits(x)
    want = ref.pack_bits_ref(raw[offset:].view(n, p) != 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.launches["pack_bits"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("p,route", [
    (32, "vector"), (64, "vector"), (96, "vector"), (128, "vector"),
    (37, "generic"), (48, "generic")])
def test_unpack_bits_routes_match_plain(cuda, p, route):
    """Both routes exactly equal the plain version, with bit 31 and pad
    bits set; 2·N·W is not a multiple of a vector block's 2,048 halves;
    two calls give the same bits."""
    n = (1 << 20) + 3
    words = torch.from_numpy(_words(n, p, p, pad_bits=True)
                             .view(np.int32)).to(cuda)
    assert ops.unpack_bits_route(words, p) == route
    before = ops.launches["unpack_bits"]
    got = ops.unpack_bits(words, p)
    torch.testing.assert_close(got, ref.unpack_bits_ref(words, p), rtol=0,
                               atol=0)
    assert torch.equal(ops.unpack_bits(words, p), got)
    assert ops.launches["unpack_bits"] == before + 2

