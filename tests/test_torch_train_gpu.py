"""The backward kernels of the training path, against their plain versions.

The CPU cases hold the autograd functions (``EmbeddingBagFn``,
``FlashAttentionFn``) to torch's autograd through the plain forwards, the
routes and refusals of the wrappers, and emulate in float32 on the CPU
why the flash backward keeps P and dS out of bf16.  The ``gpu`` cases run
each CUDA backward against its plain version on the card, at small
shapes and at the training path's, and check that it gives the same bits
from call to call; that remat none, dots and full give one train step
the same bits on the card; and int8 gradient compression at world 1 on
the card (NCCL) against the CPU (gloo).  This file imports no JAX, so it
runs on the card as it is.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.dist import compat
from repro_torch.kernels.embedding_bag import ops as eb
from repro_torch.kernels.embedding_bag import ref as ebref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as faref
from repro_torch.train import compression as comp


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(got, want, rtol, atol):
    """|got - want| <= atol + rtol |want| everywhere; returns the max (0
    for empty tensors of the same shape)."""
    assert got.shape == want.shape
    if got.numel() == 0:
        return 0.0
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())
    return float(err.max().detach())


# --------------------------------------------------------------------------
# CPU: the autograd functions on their plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_grad_matches_autograd(weighted, mode):
    """EmbeddingBagFn on the CPU (the plain backward) equals torch's
    autograd through the plain gather and sum, for the table and the
    weights, with repeated ids in a bag and across bags."""
    rng = np.random.default_rng(3)
    table0 = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 20, (9, 7)).astype(np.int32))
    w0 = torch.from_numpy(rng.random((9, 7)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(9, 6)).astype(np.float32))
    t1 = table0.clone().requires_grad_()
    w1 = w0.clone().requires_grad_() if weighted else None
    eb.embedding_bag(t1, ids, w1, mode).backward(g)
    t2 = table0.clone().requires_grad_()
    w2 = w0.clone().requires_grad_() if weighted else None
    emb = t2[ids.long()]
    if weighted:
        emb = emb * w2[..., None]
    out = emb.sum(1)
    if mode == "mean":
        out = out / (w2.sum(1, keepdim=True).clamp(min=1e-9) if weighted
                     else ids.shape[1])
    out.backward(g)
    _close(t1.grad, t2.grad, 1e-6, 1e-6)
    if weighted:
        _close(w1.grad, w2.grad, 1e-6, 1e-6)


def test_embedding_bag_backward_ref_is_in_order():
    """The plain table gradient sums a row's slots in slot order in
    float32 (what the kernel's run sum does): equal bit for bit to an
    explicit loop."""
    rng = np.random.default_rng(4)
    table = torch.zeros((30, 3))
    ids = torch.from_numpy(rng.integers(0, 5, (40, 6)).astype(np.int32))
    w = torch.from_numpy(rng.random((40, 6)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    gt, gw = ebref.embedding_bag_backward_ref(table, ids, w, g)
    want = torch.zeros((30, 3))
    for b in range(40):
        for k in range(6):
            want[ids[b, k]] = want[ids[b, k]] + w[b, k] * g[b]
    assert torch.equal(gt, want) and gw is None


# --------------------------------------------------------------------------
# CPU: the backward kernel's cut and its design, emulated
# --------------------------------------------------------------------------

DEEPFM_V = 39 << 20            # DeepFM's table: 39 fields x 2^20 rows


def _tiles(v, d, plan):
    """The (r0, rows, c0, columns) of every block, as the C entry's grid
    (ceil(V / rows), ceil(D / dt)) and the kernel cut them."""
    return [(r0, min(plan.rows, v - r0), c0, min(plan.dt, d - c0))
            for r0 in range(0, v, plan.rows) for c0 in range(0, d, plan.dt)]


@pytest.mark.parametrize("d", [1, 10, 300])
@pytest.mark.parametrize("v", [1, 8, 1000, 4099, 40_000])
def test_backward_plan_tiles_cover_once(v, d):
    """Each element of the (V, D) gradient lies in exactly one tile, the
    rows a multiple of 8 (a tile of all D columns starts 16 bytes on)."""
    plan = eb.backward_plan(v, d, 4)
    assert plan.rows % 8 == 0 and 1 <= plan.dt <= min(d, eb.BWD_COLS)
    seen = np.zeros((v, d), np.int64)
    for r0, nr, c0, nc in _tiles(v, d, plan):
        assert nr >= 1 and nc >= 1
        seen[r0:r0 + nr, c0:c0 + nc] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("d", [1, 10, 16, 300, 4096])
def test_backward_plan_shared_memory(d, size):
    """The float32 tile and the staged ids and slots fit the 48 KB a
    block gets without opting in, at DeepFM's V and a small one; threads
    are whole warps, at least the tile's columns, at most 256."""
    for v in (DEEPFM_V, 100):
        plan = eb.backward_plan(v, d, size)
        assert plan.smem == (4 * plan.rows * plan.dt
                             + 8 * eb.BWD_STAGE * plan.threads) <= 48 * 1024
        assert plan.threads % 32 == 0
        assert max(32, plan.dt) <= plan.threads <= eb.BWD_THREADS
        assert d <= eb.BWD_COLS or plan.dt < d          # column tiles


def test_backward_plan_ragged_v():
    """Where the tile's rows do not divide V (DeepFM's table, D 10; 4,099
    rows at D 1) the last tile is ragged and ends at V; a small V takes
    one tile of V rounded up to 8 rows."""
    for v, d in ((DEEPFM_V, 10), (4099, 1), (4099, 300)):
        plan = eb.backward_plan(v, d, 4)
        assert v % plan.rows
        *_, (r0, nr, _, _) = _tiles(v, d, plan)
        assert r0 + nr == v and nr == v % plan.rows
    assert eb.backward_plan(5, 10, 4).rows == 8
    assert eb.backward_plan(0, 10, 4).rows == 8
    for bad in ((10, 0, 4), (-1, 10, 4), (10, 10, 8)):
        with pytest.raises(ValueError, match="no backward plan"):
            eb.backward_plan(*bad)


def _lower_bound_warp(sorted_ids, x):
    """The kernel's 32-way search (``lower_bound_warp``): each round, 32
    probes at lo + (j + 1) step - 1, then the part between the last
    below x and the first at or above it."""
    lo, hi = 0, len(sorted_ids)
    while hi - lo > 32:
        step = -(-(hi - lo) // 32)
        below = [q < hi and sorted_ids[q] < x
                 for q in (lo + (j + 1) * step - 1 for j in range(32))]
        c = sum(below)
        assert below == [True] * c + [False] * (32 - c)
        if c < 32:
            hi = min(hi, lo + (c + 1) * step - 1)
        lo += c * step
    return lo + sum(q < hi and sorted_ids[q] < x
                    for q in range(lo, lo + 32))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1025, 20_000])
def test_lower_bound_warp_emulated(n):
    """The search gives np.searchsorted's left bound on sorted ids with
    runs, at every value from below the first to past the last."""
    rng = np.random.default_rng(n)
    ids = np.sort(rng.integers(0, max(1, n // 3), n))
    for x in [-1, 0, *rng.integers(0, max(1, n // 3), 40), n // 3, n]:
        assert _lower_bound_warp(ids, x) == np.searchsorted(ids, x, "left")


def _bag_ids(rng, kind, v, b, k, rows):
    """(B, K) int32 ids in [0, V): "uniform"; "skew" (half the slots on
    one row); "last_tile" (only in the last, ragged tile of ``rows``);
    "one_tile" (every id in the second tile)."""
    if kind == "last_tile":
        r0 = (v - 1) // rows * rows
        return rng.integers(r0, v, (b, k)).astype(np.int32)
    if kind == "one_tile":
        return rng.integers(rows, min(v, 2 * rows), (b, k)).astype(np.int32)
    ids = rng.integers(0, v, (b, k)).astype(np.int32)
    if kind == "skew":
        ids.reshape(-1)[rng.random(b * k) < 0.5] = v // 3
    return ids


def _emulate_tiles(v, d, ids, w, g, plan, group, stage):
    """The tile kernel's walk and float32 arithmetic in numpy: a stable
    sort; blocks of ``group`` consecutive row tiles, one warp search for
    the first; each tile's entries staged ``stage`` at a time and
    counted below the tile's end; each run summed in slot order (product
    rounded, then added) into a zero tile from its first entry, past the
    stage in the sorted arrays; the tile written once.  Returns the
    (V, D) gradient and how often each row was written."""
    flat = ids.reshape(-1)
    perm = np.argsort(flat, kind="stable")
    srt = flat[perm]
    n, kk = len(flat), ids.shape[1]
    out = np.full((v, d), np.nan, np.float32)
    writes = np.zeros(v, np.int64)
    tiles = -(-v // plan.rows)

    def part(slot, c0, nc):
        x = g[slot // kk, c0:c0 + nc]
        return x if w is None else np.float32(w.reshape(-1)[slot]) * x

    for ta in range(0, tiles, group):
        tb = min(ta + group, tiles)
        for c0 in range(0, d, plan.dt):
            nc = min(plan.dt, d - c0)
            q = _lower_bound_warp(srt, ta * plan.rows)
            for ti in range(ta, tb):
                r0 = ti * plan.rows
                r1, nr = r0 + plan.rows, min(plan.rows, v - r0)
                tile = np.zeros((nr, nc), np.float32)
                last = -1
                while True:
                    ids_s = [srt[q + j] if q + j < n else 2**31 - 1
                             for j in range(stage)]
                    slot_s = [perm[q + j] if q + j < n else 0
                              for j in range(stage)]
                    cnt = sum(x < r1 for x in ids_s)
                    for e in range(cnt):
                        rid = ids_s[e]
                        if (ids_s[e - 1] if e else last) == rid:
                            continue
                        acc, r = np.zeros(nc, np.float32), e
                        while r < cnt and ids_s[r] == rid:
                            acc = acc + part(slot_s[r], c0, nc)
                            r += 1
                        if r == stage:
                            a = q + r
                            while a < n and srt[a] == rid:
                                acc = acc + part(perm[a], c0, nc)
                                a += 1
                        tile[rid - r0] = acc
                    if cnt:
                        last = ids_s[cnt - 1]
                    q += cnt
                    if cnt < stage:
                        break
                out[r0:r0 + nr, c0:c0 + nc] = tile
                writes[r0:r0 + nr] += c0 == 0
    return out, writes


@pytest.mark.parametrize("group,stage", [(1, 8), (4, 512)])
@pytest.mark.parametrize("v,d,b,k,weighted,kind", [
    (3000, 10, 64, 39, False, "skew"), (2000, 10, 64, 39, True,
                                        "last_tile"),
    (2000, 10, 64, 39, False, "one_tile"), (816 * 2 + 5, 10, 40, 9, True,
                                            "uniform"),
    (300, 300, 16, 7, True, "uniform"), (50, 1, 30, 39, False, "skew")])
def test_tile_design_emulated_equals_plain(v, d, b, k, weighted, kind,
                                           group, stage):
    """The tile design's walk and arithmetic, emulated on the CPU (one
    tile a block, or four as the kernel writes; runs that straddle a
    small stage or fit the kernel's 512 entries), are the plain in-order
    float32 sum bit for bit, and write every row once."""
    rng = np.random.default_rng(v + d + k)
    plan = eb.backward_plan(v, d, 4)
    ids = _bag_ids(rng, kind, v, b, k, plan.rows)
    w = rng.random((b, k)).astype(np.float32) if weighted else None
    g = rng.normal(size=(b, d)).astype(np.float32)
    got, writes = _emulate_tiles(v, d, ids, w, g, plan, group, stage)
    want, _ = ebref.embedding_bag_backward_ref(
        torch.zeros((v, d)), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), torch.from_numpy(g))
    assert (writes == 1).all()
    assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hk", [(3, 3), (6, 2), (3, 1)])
def test_flash_fn_matches_autograd(causal, h, hk):
    """FlashAttentionFn on the CPU (plain forward with LSE, plain backward
    from the formulas) equals torch's autograd through attention_ref in
    float64: 1e-5 (the plain versions compute in float32)."""
    q0, k0, v0, do = (torch.from_numpy(a).double() for a in _normal(
        5, (2, 33, h, 16), (2, 33, hk, 16), (2, 33, hk, 16), (2, 33, h, 16)))
    x = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    faref.attention_ref(*x, causal=causal).backward(do)
    y = [t.clone().float().requires_grad_() for t in (q0, k0, v0)]
    out = fa.flash_attention(*y, causal=causal)
    _close(out, faref.attention_ref(q0, k0, v0, causal), 0, 1e-5)
    out.backward(do.float())
    for a, b in zip(y, x):
        _close(a.grad, b.grad, 1e-5, 1e-5)


def test_flash_backward_route_and_refusals():
    """bf16 takes the tensor-core route ("mma") and float32 the FMA route
    at every head dim; any other type or head dim is refused, and so is a
    backward call on a device with no kernel or across devices."""
    for d in fa.HEAD_DIMS:
        assert fa.flash_attention_backward_route(torch.bfloat16, d) == "mma"
        assert fa.flash_attention_backward_route(torch.float32, d) == "fma"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_backward_route(torch.float16, 64)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_backward_route(torch.bfloat16, 48)
    q = torch.zeros((1, 4, 2, 16))
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        fa.flash_attention_backward(*(x.to("meta") for x in (q, q, q, q)),
                                    lse.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_attention_backward(q, q, q, q, lse, q.to("meta"))
    with pytest.raises(ValueError, match="S == T"):
        fa.flash_attention_backward(q, q[:, :3], q[:, :3], q, lse, q)


def test_flash_training_calls_refused():
    """A training call keeps every key, and causal needs S == T."""
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    k = torch.zeros((1, 6, 2, 16), requires_grad=True)
    with pytest.raises(ValueError, match="S == T"):
        fa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attention(q, k, k, causal=False, kv_len=5)


def _emulate_bwd(q, k, v, do, causal, split):
    """dV = Pᵀ dO, dK = scale · dSᵀ Q and dQ = scale · dS K in float32 from
    bf16 inputs, with P and dS rounded to bf16 (``split`` False), kept as
    bf16 hi + lo (``split`` True) or float32 (``split`` None) before the
    products."""
    o, lse = faref.attention_lse_ref(q, k, v, causal)
    b, s, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.float().reshape(b, s, hk, g, d)
    dog = do.float().reshape(b, s, hk, g, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    p = torch.exp(sc - lse.reshape(b, hk, g, s)[..., None])
    if causal:
        p = p.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), 0.0)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    dd = (dog * o.float().reshape(b, s, hk, g, d)).sum(-1)
    ds = p * (dp - dd.permute(0, 2, 3, 1)[..., None])

    def rnd(x):
        if split is None:
            return x
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if split else hi

    dv = torch.einsum("bkgst,bskgd->btkd", rnd(p), dog)
    dk = torch.einsum("bkgst,bskgd->btkd", rnd(ds), qg) / math.sqrt(d)
    dq = torch.einsum("bkgst,btkd->bskgd", rnd(ds), k.float()).reshape(
        b, s, h, d) / math.sqrt(d)
    return dk, dv, dq


def test_bf16_backward_keeps_p_and_ds_in_float32():
    """At a causal S = T = 512 shape (9 heads over 3, D = 64, random
    bf16), dV, dK and dQ within 2^-7·|plain| + 1e-4·max|plain| of the
    plain float32 gradient (the tolerance of the card check: one bf16
    rounding of each, float32 sums in another order) hold with P and dS
    in float32 (the "fma" route's products) and with a bf16 hi + lo split
    (the "mma" route's), and miss it with bf16(P) and bf16(dS) alone: the
    tensor-core design needs the forward's split for both, dQ's dS too."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _normal(
        6, (1, 512, 9, 64), (1, 512, 3, 64), (1, 512, 3, 64),
        (1, 512, 9, 64)))
    o, lse = faref.attention_lse_ref(q, k, v, True)
    want_q, want_k, want_v = (x.float() for x in faref.attention_backward_ref(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), True))
    for split, ok in ((None, True), (True, True), (False, False)):
        dk, dv, dq = _emulate_bwd(q, k, v, do, True, split)
        for got, want in ((dk, want_k), (dv, want_v), (dq, want_q)):
            tol = 2.0 ** -7 * want.abs() + 1e-4 * float(want.abs().max())
            fine = bool(((got.bfloat16().float() - want).abs() <= tol).all())
            assert fine is ok, (split, float((got - want).abs().max()))


# --------------------------------------------------------------------------
# the CUDA kernels (on a card only)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,k,weighted,kind", [
    (1000, 10, 64, 39, False, "uniform"), (1000, 1, 64, 39, True, "uniform"),
    (50, 16, 300, 7, True, "uniform"), (3, 8, 10, 5, False, "uniform"),
    (200_000, 10, 4096, 39, False, "uniform"),
    (200_000, 10, 4096, 39, False, "skew"),
    (20_000, 10, 512, 39, True, "last_tile"),
    (20_000, 1, 512, 39, False, "last_tile"),
    (50_000, 10, 1024, 39, False, "one_tile"),
    (816 * 5 + 3, 10, 256, 39, False, "uniform"),
    (3000, 300, 128, 7, True, "uniform"),
    (100, 10, 0, 5, True, "uniform"), (100, 10, 8, 0, True, "uniform")])
def test_embedding_bag_backward_kernel(cuda, dtype, v, d, b, k, weighted,
                                       kind):
    """The kernel's table gradient equals the plain in-order float32 sum
    bit for bit in float32 (each product rounded, then added, in slot
    order), within one bf16 step in bf16; the weight gradient within
    1e-5 relative; the same bits from call to call; one count a call.
    Ids uniform, skewed (one row holds half the slots), only in the last
    ragged tile, all in one tile; V not a multiple of the tile's rows; D
    300 (column tiles); B or K of 0."""
    rng = np.random.default_rng(v + d)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                             ).to(cuda, dtype)
    rows = eb.backward_plan(v, d, table.element_size()).rows
    ids = torch.from_numpy(_bag_ids(rng, kind, v, b, k, rows)).to(cuda)
    w = (torch.from_numpy(rng.random((b, k)).astype(np.float32)).to(cuda)
         if weighted else None)
    g = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)
                         ).to(cuda, dtype)
    before = eb.launches["embedding_bag_backward"]
    gt, gw = eb.embedding_bag_backward(table, ids, w, g, True, weighted)
    gt2, gw2 = eb.embedding_bag_backward(table, ids, w, g, True, weighted)
    assert eb.launches["embedding_bag_backward"] == before + 2
    assert torch.equal(gt, gt2)
    want_t, want_w = ebref.embedding_bag_backward_ref(
        table.cpu(), ids.cpu(), None if w is None else w.cpu(), g.cpu(),
        True, weighted)
    if dtype == torch.float32:
        assert torch.equal(gt.cpu(), want_t)
    else:
        _close(gt.cpu(), want_t, 2.0 ** -7, 1e-6)
    if weighted:
        assert torch.equal(gw, gw2)
        _close(gw.cpu(), want_w, 1e-5, 1e-5)


@pytest.mark.gpu
def test_embedding_bag_grad_through_autograd_on_card(cuda):
    """The card's bag carries a gradient: the table's gradient through
    ``embedding_bag`` equals the plain one from the CPU bit for bit
    (float32, weight 1)."""
    rng = np.random.default_rng(9)
    t0 = torch.from_numpy(rng.normal(size=(500, 10)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 500, (128, 39)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(128, 10)).astype(np.float32))
    grads = []
    for dev in (cuda, "cpu"):
        t = t0.to(dev).requires_grad_()
        eb.embedding_bag(t, ids.to(dev)).backward(g.to(dev))
        grads.append(t.grad.cpu())
    assert torch.equal(*grads)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,d,causal", [
    (2, 64, 1, 1, 16, True), (2, 100, 3, 1, 32, True),
    (1, 130, 6, 2, 64, False), (2, 77, 4, 4, 128, True),
    (1, 256, 9, 3, 64, True), (1, 70, 2, 1, 128, False),
    (1, 300, 8, 2, 64, True), (2, 129, 4, 1, 128, True)])
def test_flash_backward_kernel(cuda, dtype, b, s, h, hk, d, causal):
    """The LSE of the training forward within 1e-5 + 1e-5|plain|; dq, dk,
    dv against the plain gradient (from the same q, k, v, out and LSE)
    within 2^-7|plain| + 1e-4 max|plain| in bf16 on the "mma" route (P
    and dS as bf16 hi + lo, one rounding of each output, float32 sums in
    another order), 1e-4|plain| + 1e-5 max|plain| in float32 on the "fma"
    route; the same bits from call to call; one count a call.  Ragged S
    (77, 100, 129, 130, 300) and G = H / HK up to 4 cut the tiles at
    their edges."""
    route = fa.flash_attention_backward_route(dtype, d)
    assert route == ("mma" if dtype == torch.bfloat16 else "fma")
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype) for a in _normal(
        s + d, (b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d)))
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    _, want_lse = faref.attention_lse_ref(q, k, v, causal)
    _close(lse, want_lse, 1e-5, 1e-5)
    before = fa.launches["flash_attention_backward"]
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    assert fa.launches["flash_attention_backward"] == before + 2
    want = faref.attention_backward_ref(q, k, v, o, lse, do, causal)
    rtol, arel = ((2.0 ** -7, 1e-4) if dtype == torch.bfloat16
                  else (1e-4, 1e-5))
    for x, y, w in zip(got, again, want):
        assert torch.equal(x, y)
        _close(x, w, rtol, arel * float(w.float().abs().max()))


@pytest.mark.gpu
def test_flash_grad_through_autograd_on_card(cuda):
    """A float32 causal call's gradients through FlashAttentionFn on the
    card equal the CPU's within 1e-4 of their largest; a bf16 call on the
    split-KV route refuses to train."""
    q0, k0, v0, do = (torch.from_numpy(a) for a in _normal(
        11, (2, 90, 6, 32), (2, 90, 2, 32), (2, 90, 2, 32), (2, 90, 6, 32)))
    grads = []
    for dev in (cuda, "cpu"):
        x = [t.to(dev).requires_grad_() for t in (q0, k0, v0)]
        fa.flash_attention(*x, causal=True).backward(do.to(dev))
        grads.append([t.grad.cpu() for t in x])
    for a, b in zip(*grads):
        _close(a, b, 0, 1e-4 * float(b.abs().max()))
    q = torch.zeros((1, 1, 3, 64), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(ValueError, match="split-KV"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1], causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_modes_equal_bit_for_bit_on_card(cuda, dtype):
    """One train step of smollm-135m's smoke config (S 32, B 2) on the
    card under remat none, dots and full, from the same parameters,
    optimizer state and batch, gives the same parameters, state, loss and
    grad_norm bit for bit, though under dots and full each layer's flash
    forward (with its LSE) runs again in the backward: L forward launches
    under none, 2L under dots and full."""
    import dataclasses

    from repro_torch.configs import smollm_135m
    from repro_torch.configs.shapes import SMOKE_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models.lm.transformer import Transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(smollm_135m.SMOKE, dtype=dtype)
    shape = dict(SMOKE_SHAPES["lm"]["train"])
    params = tree_map(lambda p: p.detach(), Transformer(
        cfg, torch.Generator(device=cuda).manual_seed(0),
        device=cuda).param_tree())
    state = opt.init(params, steps.OPT_CFG)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (shape["global_batch"], shape["seq_len"] + 1)).astype(
        np.int32)).to(cuda)
    outs = []
    for mode, forward in (("none", 1), ("dots", 2), ("full", 2)):
        fn = steps.make_lm_step(cfg, shape, remat_override=mode).fn
        before = dict(fa.launches)
        outs.append(tree_leaves(fn(params, state, tok)))
        assert (fa.launches["flash_attention"] - before["flash_attention"]
                == forward * cfg.n_layers)
        assert (fa.launches["flash_attention_backward"]
                - before["flash_attention_backward"] == cfg.n_layers)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.mark.gpu
def test_compression_world1_on_card(cuda):
    """psum_compressed at world 1 over NCCL on the card equals the CPU's
    over gloo bit for bit, two steps with the residual carried (at
    1,024 x 1,024 the scale max|g| / 127 once came out one ulp apart,
    divided on the card by the reciprocal of a CPU scalar)."""
    rng = np.random.default_rng(13)
    grads = [{"w": rng.normal(size=(1024, 1024)).astype(np.float32),
              "b": rng.normal(size=(9,)).astype(np.float32) * 1e-4}
             for _ in range(2)]
    outs = []
    for dev, backend in ((cuda, "nccl"), ("cpu", "gloo")):
        with compat.world1(backend):
            res = {k: torch.zeros(v.shape, device=dev)
                   for k, v in grads[0].items()}
            got = []
            for g in grads:
                out, res = comp.psum_compressed(
                    {k: torch.from_numpy(v).to(dev) for k, v in g.items()},
                    res)
                got += [out["w"].cpu(), out["b"].cpu(), res["w"].cpu(),
                        res["b"].cpu()]
        outs.append(got)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
