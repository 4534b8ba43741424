"""The port's flash attention against the reference package.

The plain versions (the CPU route of ``ops``) are held to the reference's
Pallas kernel (interpret mode, bq = bk = 32), its ``flash_attention``
front door and its ``attention_ref``, on the same numpy-made inputs, at
the reference's tolerances: 2e-5 in float32 (sums in another order), 2e-2
in bfloat16 (one rounding of the output, in places that may differ).
Grouped-query heads (HK < H) are held to the reference on repeated k and
v, a ragged ``kv_len`` to the reference on the first kv_len keys, and
the decode shape (S = 1 against a cache) to the transformer's
``decode_attention``.  The chunked plain version equals the whole-matrix
one.  An emulation of the bf16 kernel's arithmetic in plain torch shows
why its P·V product takes p as two bf16 terms (hi + lo): with bf16(p)
alone it misses the card checks' 1e-5 + 2^-7·|plain| (one bf16 step) at
long rows.  The ``gpu`` cases hold the CUDA kernel against the plain
version on the card and skip without one: the existing cases at their
tolerances (2e-5 float32, 2e-2 bf16), the bf16 tensor-core and split-KV
routes at 1e-5 + 2^-7·|plain|, and each bit for bit from call to call.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_bhsd as j_bhsd
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ops import flash_attention_reference
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models.lm.transformer import decode_attention as j_decode
from repro_torch.kernels.flash_attention import ops, ref

SWEEP = [(64, 64, 32, True), (64, 64, 32, False), (100, 100, 64, True),
         (8, 72, 16, False), (256, 256, 128, True)]


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    """The arrays for JAX and for torch, both rounded to ``dtype``."""
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,d,causal", SWEEP)
def test_flash_attention_sweep(s, t, d, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(
        _normal(s * t + d, (3, s, d), (3, t, d), (3, t, d)), dtype)
    got = ops.flash_attention_bhsd(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (3, s, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    _close(got, j_bhsd(jq, jk, jv, causal=causal, bq=32, bk=32), tol)
    _close(got, j_ref(jq, jk, jv, causal=causal), tol)


def test_flash_attention_bshd_layout():
    q, k, v = _normal(0, (2, 48, 4, 32), (2, 48, 4, 32), (2, 48, 4, 32))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    args = [jnp.asarray(a) for a in (q, k, v)]
    _close(got, j_flash(*args, causal=True, bq=16, bk=16), 2e-5)
    _close(got, flash_attention_reference(*args, causal=True), 2e-5)


@pytest.mark.parametrize("h,hk,causal", [(9, 3, True), (4, 1, False),
                                         (6, 2, True)])
def test_grouped_kv_heads(h, hk, causal):
    q, k, v = _normal(h, (2, 40, h, 16), (2, 40, hk, 16), (2, 40, hk, 16))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    rep = h // hk
    want = flash_attention_reference(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)), causal=causal)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("s,t,kv_len", [(1, 100, 37), (16, 80, 80),
                                        (5, 64, 1)])
def test_ragged_kv_len(s, t, kv_len):
    q, k, v = _normal(kv_len, (3, s, 32), (3, t, 32), (3, t, 32))
    got = ops.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v)),
                                   causal=False, kv_len=kv_len)
    want = j_ref(jnp.asarray(q), jnp.asarray(k[:, :kv_len]),
                 jnp.asarray(v[:, :kv_len]), causal=False)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("cache_len", [0, 17, 63])
def test_decode_shape_matches_decode_attention(cache_len):
    q, kc, vc = _normal(cache_len, (2, 1, 9, 64), (2, 64, 3, 64),
                        (2, 64, 3, 64))
    got = ops.flash_attention(*map(torch.from_numpy, (q, kc, vc)),
                              causal=False, kv_len=cache_len + 1)
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.int32(cache_len + 1))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("causal,kv_len,chunk", [(True, None, 16),
                                                 (True, None, 64),
                                                 (False, 50, 7)])
def test_chunked_plain_version(causal, kv_len, chunk):
    q, k, v = _normal(chunk, (2, 64, 6, 16), (2, 64, 2, 16), (2, 64, 2, 16))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = ref.attention_chunked_ref(*args, causal=causal, kv_len=kv_len,
                                    chunk=chunk)
    _close(got, ref.attention_ref(*args, causal=causal, kv_len=kv_len),
           2e-5)


def _emulate_bf16_kernel(q, k, v, causal, kv_len, split):
    """The bf16 kernel's arithmetic in plain torch: float32 scores, p =
    exp(s - max) in float32, l summed from the unrounded p, P·V with p
    rounded to bf16 (``split``: plus the bf16 rounding of the remainder,
    a second product), products of bf16 values summed in float32, the
    output rounded once to bf16."""
    b, s, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, hk, h // hk, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    sc = sc.masked_fill(~ref._mask(s, 0, t, kv_len, causal, q.device),
                        float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    acc = torch.einsum("bkgst,btkd->bskgd", hi, v.float())
    if split:
        lo = (p - hi).bfloat16().float()
        acc = acc + torch.einsum("bkgst,btkd->bskgd", lo, v.float())
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]           # (B, S, HK, G, 1)
    return (acc / l).reshape(b, s, h, d).bfloat16()


@pytest.mark.parametrize("b,s,t,causal", [(2, 1, 20_001, False),
                                          (1, 1024, 1024, True)])
def test_bf16_probabilities_need_hi_plus_lo(b, s, t, causal):
    """At a decode shape (kv_len 20,001) and a causal S = T = 1,024 shape
    (9 heads over 3, D = 64, random bf16), p split as hi + lo keeps the
    output within 1e-5 + 2^-7·|plain| of the plain version, and bf16(p)
    alone does not: the kernel runs two P·V products for that reason."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _normal(
        t, (b, s, 9, 64), (b, t, 3, 64), (b, t, 3, 64)))
    want = ref.attention_ref(q, k, v, causal=causal).float()
    tol = 1e-5 + 2.0 ** -7 * want.abs()
    for split, ok in ((True, True), (False, False)):
        got = _emulate_bf16_kernel(q, k, v, causal, t, split).float()
        assert bool(((got - want).abs() <= tol).all()) is ok


def test_split_kv_chunks():
    """Which card calls take the split-KV route, and in how many chunks:
    bf16 with at most 16 rows a kv head, keys up to kv_len (up to S when
    causal) in chunks of DECODE_CHUNK."""
    bf, c = torch.bfloat16, ops.DECODE_CHUNK
    assert ops.split_chunks(bf, 1, 3, 95, False) == 1       # serve_batch
    assert ops.split_chunks(bf, 1, 3, 32_768, False) == 32_768 // c
    assert ops.split_chunks(bf, 1, 3, c, False) == 1
    assert ops.split_chunks(bf, 1, 3, c + 1, False) == 2
    assert ops.split_chunks(bf, 4, 4, 5000, True) == 1      # 16 rows
    assert ops.split_chunks(bf, 17, 1, 5000, False) == 0    # tensor cores
    assert ops.split_chunks(torch.float32, 1, 3, 5000, False) == 0


def test_bad_inputs_raise():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError):
        ref.attention_ref(q, q[:, :, :1].expand(1, 4, 3, 16).contiguous(),
                          q[:, :, :1].expand(1, 4, 3, 16).contiguous())


# --------------------------------------------------------------------------
# the CUDA kernel (on a card only)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hk,d,causal,kv_len", [
    (3, 64, 64, 1, 1, 32, True, None), (3, 100, 100, 1, 1, 64, True, None),
    (3, 8, 72, 1, 1, 16, False, None), (3, 256, 256, 1, 1, 128, True, None),
    (2, 300, 300, 9, 3, 64, True, None), (2, 1, 1000, 9, 3, 64, False, 777),
    (4, 1, 96, 4, 4, 128, False, 1), (1, 130, 200, 6, 2, 32, False, 150)])
def test_flash_kernel_matches_plain(cuda, b, s, t, h, hk, d, causal, kv_len,
                                    dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _normal(
        s + t + d, (b, s, h, d), (b, t, hk, d), (b, t, hk, d)))
    before = ops.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_caches(cuda):
    kc, vc = (torch.randn((2, 3, 64, 2, 32), device=cuda) for _ in range(2))
    q = torch.randn((3, 1, 4, 32), device=cuda)
    got = ops.flash_attention(q, kc[1], vc[1], causal=False, kv_len=40)
    want = ref.attention_ref(q, kc[1], vc[1], causal=False, kv_len=40)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros((1, 8, 2, 24), device=cuda),
                            torch.zeros((1, 8, 2, 24), device=cuda),
                            torch.zeros((1, 8, 2, 24), device=cuda))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, kv_len=9)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.cpu(), q)


def _bf16_case(cuda, b, s, t, h, hk, d, seed):
    return (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _normal(
        seed, (b, s, h, d), (b, t, hk, d), (b, t, hk, d)))


def _check_bf16_route(q, k, v, causal, kv_len, combines):
    """The kernel within 1e-5 + 2^-7·|plain| (one bf16 step: both compute
    in float32 and round once, in different orders), equal bit for bit on
    a second call, with one flash_attention launch a call and
    ``combines`` combine launches."""
    before = dict(ops.launches)
    got = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    again = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before["flash_attention"] + 2
    assert ops.launches["flash_attention_combine"] == \
        before["flash_attention_combine"] + 2 * combines
    assert torch.equal(got, again)
    want = ref.attention_ref(q, k, v, causal=causal, kv_len=kv_len).float()
    err = (got.float() - want).abs()
    assert bool((err <= 1e-5 + 2.0 ** -7 * want.abs()).all()), \
        float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_kernel_tensor_core_route(cuda, d, g, causal):
    """The bf16 wgmma route (more than 16 rows a kv head) at every head
    dim and group size, 150 queries (rows not a multiple of a block's)
    against 333 keys, causal or with kv_len 300."""
    q, k, v = _bf16_case(cuda, 2, 150, 333, 2 * g, 2, d, 16 * d + g)
    _check_bf16_route(q, k, v, causal, None if causal else 300, 0)


@pytest.mark.gpu
def test_flash_kernel_tensor_core_route_more_queries_than_keys(cuda):
    q, k, v = _bf16_case(cuda, 1, 333, 150, 9, 3, 64, 7)
    _check_bf16_route(q, k, v, True, None, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_len", [1, ops.DECODE_CHUNK,
                                    ops.DECODE_CHUNK + 1, 20_001])
def test_flash_kernel_split_kv_route(cuda, kv_len):
    """The bf16 split-KV route (3 rows a kv head: one query, 9 heads over
    3) against a 32,768-row cache: one chunk writes the output, more take
    one combine launch."""
    q, k, v = _bf16_case(cuda, 2, 1, 32_768, 9, 3, 64, kv_len)
    chunks = ops.split_chunks(q.dtype, 1, 3, kv_len, False)
    _check_bf16_route(q, k, v, False, kv_len, int(chunks > 1))


# --------------------------------------------------------------------------
# split-KV across ranks: a rank's partial result and the merge
# --------------------------------------------------------------------------

def _slices(k, v, kv_len, r):
    """The (k, v, kept rows) of R equal slices of the cache rows, as R
    ranks hold them: slice i keeps rows [i·T/R, min((i+1)·T/R, kv_len))."""
    t = k.shape[1] // r
    return [(k[:, i * t:(i + 1) * t], v[:, i * t:(i + 1) * t],
             min(max(kv_len - i * t, 0), t)) for i in range(r)]


def _partials(q, k, v, kv_len, r, fn):
    """Stacked partials of R slices; an empty slice gives o = 0 and
    lse = -inf, and ``fn`` is not called on it."""
    b, s, h, d = q.shape
    os_, ls = [], []
    for ks, vs, n in _slices(k, v, kv_len, r):
        if n:
            o, lse = fn(q, ks, vs, n)
        else:
            o = torch.zeros((b, s, h, d), dtype=torch.float32,
                            device=q.device)
            lse = torch.full((b, h, s), float("-inf"), device=q.device)
        os_.append(o)
        ls.append(lse)
    return torch.stack(os_), torch.stack(ls)


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("kv_len", [1, 7, 16, 24, 31, 32])
def test_merged_plain_partials_equal_whole_cache_attention(r, kv_len):
    """R slices' plain partials merged equal attention over the whole
    cache within 1e-6 in float32, the slices past kv_len empty; at R = 1
    the merge gives the single call's bits."""
    q, k, v = (torch.from_numpy(a) for a in _normal(
        100 + kv_len, (2, 1, 6, 16), (2, 32, 3, 16), (2, 32, 3, 16)))
    want = ref.attention_ref(q, k, v, causal=False, kv_len=kv_len)
    o, lse = _partials(q, k, v, kv_len, r, ref.attention_partials_ref)
    got = ops.merge_partials(o, lse, torch.float32)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    if r == 1:
        assert torch.equal(got, o[0])
        _, lse1 = ref.attention_lse_ref(q[:, :, :, :], k[:, :kv_len],
                                        v[:, :kv_len], causal=False)
        torch.testing.assert_close(lse[0], lse1, atol=1e-6, rtol=1e-6)


def test_merge_of_one_partial_is_its_rounding():
    o = torch.from_numpy(_normal(5, (1, 3, 1, 4, 8))[0])
    lse = torch.from_numpy(_normal(6, (1, 3, 4, 1))[0])
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(ops.merge_partials(o, lse, dt), o[0].to(dt))


def test_decode_partials_merge_to_decode_attention_bits():
    """The model's CPU partial (probabilities in q's type, as
    decode_attention rounds them) merged alone gives decode_attention's
    bits, in float32 and bfloat16."""
    from repro_torch.models.lm import transformer as ttf

    q, k, v = (torch.from_numpy(a) for a in _normal(
        9, (2, 1, 6, 16), (2, 40, 3, 16), (2, 40, 3, 16)))
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        want = ttf.decode_attention(qd, kd, vd, 29)
        o, lse = ttf.decode_attention_partials(qd, kd, vd, 29)
        assert torch.equal(ops.merge_partials(o[None], lse[None], dt), want)


def test_merge_rejects_what_it_does_not_take():
    o = torch.zeros((2, 1, 1, 4, 8))
    with pytest.raises(ValueError):
        ops.merge_partials(o, torch.zeros((2, 1, 1, 4)))
    with pytest.raises(TypeError):
        ops.merge_partials(o.double(), torch.zeros((2, 1, 4, 1)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len", [1, 700, ops.DECODE_CHUNK,
                                    ops.DECODE_CHUNK + 1, 5000])
def test_kernel_partials_match_plain(cuda, dtype, kv_len):
    """A rank's partial on the card (float32: the FMA kernel with its
    LSE; bf16: split-KV with combine_kernel writing float32 rows and the
    LSE, at one chunk too) against ref.attention_partials_ref."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _normal(
        kv_len, (2, 1, 8, 128), (2, 6000, 8, 128), (2, 6000, 8, 128)))
    before = dict(ops.launches)
    o, lse = ops.flash_attention_partials(q, k, v, kv_len)
    torch.cuda.synchronize()
    wo, wl = ref.attention_partials_ref(q, k, v, kv_len)
    assert o.dtype == lse.dtype == torch.float32
    assert ops.launches["flash_attention"] == before["flash_attention"] + 1
    if dtype == torch.bfloat16:
        assert ops.launches["flash_attention_combine"] == \
            before["flash_attention_combine"] + 1
    torch.testing.assert_close(o, wo, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, wl, atol=2e-5, rtol=2e-5)
    # merged alone, the partial is the single call's output
    single = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    assert torch.equal(ops.merge_partials(o[None], lse[None], dtype), single)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("where", ["last", "boundary", "first"])
def test_merge_kernel_matches_plain(cuda, r, where):
    """R slices' kernel partials merged by merge_kernel: against the plain
    merge of the same partials (float32 within 1e-6 relative; bf16 within
    one rounding) and against the whole-cache call, with empty slices."""
    t = 8192
    kv_len = {"last": t - 100, "boundary": t // 2, "first": 300}[where]
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _normal(
        r + kv_len, (2, 1, 8, 128), (2, t, 8, 128), (2, t, 8, 128)))
    o, lse = _partials(q, k, v, kv_len, r, ops.flash_attention_partials)
    before = ops.launches["flash_attention_merge"]
    got = ops.merge_partials(o, lse, torch.bfloat16)
    got32 = ops.merge_partials(o, lse, torch.float32)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_merge"] == before + 2
    want32 = ref.merge_partials_ref(o.cpu(), lse.cpu(), torch.float32)
    torch.testing.assert_close(got32.cpu(), want32, atol=1e-6, rtol=1e-6)
    assert (got.float().cpu() - want32.to(torch.bfloat16).float()).abs() \
        .max() <= 2.0 ** -7 * want32.abs().max()
    single = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    if r == 1:
        assert torch.equal(got, single)
    plain = ref.attention_ref(q, k, v, causal=False, kv_len=kv_len).float()
    err = (got.float() - plain).abs()
    assert bool((err <= 1e-5 + 2.0 ** -7 * plain.abs()).all())
