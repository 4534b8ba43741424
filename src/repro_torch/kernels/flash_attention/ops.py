"""Front door of the flash attention kernel: ``flash_attention`` on the
(B, S, H, D) layout (k and v with H or fewer heads, grouped-query) and
``flash_attention_bhsd`` on the reference kernel's (BH, S, D) layout.

The tensor's device decides the route: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel in
``csrc/flash_attention.cu`` (built with ``nvcc`` at first use); anything
else raises.  There is no fallback from the kernel to the plain version.
The wrapper checks its inputs, allocates the output, launches on the
current stream and adds one to ``launches["flash_attention"]`` per
call.  A bfloat16 call with at most :data:`DECODE_ROWS` rows a (batch, kv
head) (S·H/HK, as at a decode step) splits its keys into chunks of
:data:`DECODE_CHUNK`; with more than one chunk the wrapper allocates the
chunks' float32 scratch, and a second launch merges them in order and
adds one to ``launches["flash_attention_combine"]``.
``models/lm/transformer.py`` calls it only with CUDA tensors: on the CPU
the model runs the reference's own plain attention (whose decode and
short-sequence branches round the probabilities to the model's type), so
the CPU branch here serves the kernel's tests.

Where q, k or v requires a gradient (a training call), the call goes
through :class:`FlashAttentionFn`: its forward runs the same kernel and
also writes each row's float32 log-sum-exp (B, H, S); its backward runs
``flash_attention_backward`` (one count in
``launches["flash_attention_backward"]`` a call: D = rowsum(dO ∘ O), then
dK/dV and dQ, P recomputed from the LSE).
:func:`flash_attention_backward_route` names its design: ``"mma"`` for
bf16 (the tensor cores, P and dS as bf16 hi + lo terms), ``"fma"`` for
float32; the C entry refuses any other pairing.  Training takes causal
calls with S == T and unmasked calls with kv_len == T; the split-KV route
(bf16, S·H/HK <= 16) takes no gradient, so a training call there raises.
Serving passes no LSE pointer.

Split-KV across ranks (a sequence-sharded KV cache at decode):
:func:`flash_attention_partials` gives a rank's partial result, each row's
output in float32 and its log-sum-exp (the float32 kernel writes both;
on the bf16 split-KV route ``combine_kernel`` writes them, at any chunk
count); :func:`merge_partials` merges R ranks' partials with the
hand-written ``merge_kernel`` (one count in
``launches["flash_attention_merge"]`` a call), whose plain version is
``ref.merge_partials_ref``.  One partial merged alone gives the bits of
the single call.  On the CPU the function's forward and
backward are the plain ``ref.attention_lse_ref`` and
``ref.attention_backward_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_attention import ref

launches = {"flash_attention": 0, "flash_attention_combine": 0,
            "flash_attention_backward": 0, "flash_attention_merge": 0}

HEAD_DIMS = (16, 32, 64, 128)
DECODE_ROWS = 16        # bf16 calls with at most this many rows split KV
DECODE_CHUNK = 1024     # keys a block of the split-KV route
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _LL, _LL,
              ctypes.c_int, ctypes.c_int, _LL, _LL, ctypes.c_int,
              ctypes.c_float] + [_LL] * 13 + [_P, _P, _P])
_BWD_ARGTYPES = ([_P] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              _LL, _LL, ctypes.c_int, ctypes.c_int, _LL,
                              ctypes.c_int, ctypes.c_float] + [_P] * 5)
_COMBINE_ARGTYPES = [_P, _P, ctypes.c_int, _LL, _LL, ctypes.c_int,
                     ctypes.c_int, _LL, _LL, _LL, _LL, _P, _P, _P]
_MERGE_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_int, _LL,
                   ctypes.c_int, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BWD_ROUTES = {"fma": 0, "mma": 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    """The built library, its argument types set (built at first use)."""
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = _ARGTYPES
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_combine.argtypes = _COMBINE_ARGTYPES
        lib.flash_attention_combine.restype = ctypes.c_int
        lib.flash_attention_backward.argtypes = _BWD_ARGTYPES
        lib.flash_attention_backward.restype = ctypes.c_int
        lib.flash_attention_merge.argtypes = _MERGE_ARGTYPES
        lib.flash_attention_merge.restype = ctypes.c_int
    return lib


def _route(*tensors) -> str:
    """'cpu' or 'cuda' from the tensors' common device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_attention kernel for device {dev}")
    return dev.type


def _check(q, k, v, kv_len):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, "
                        f"v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, S, H, D), k and v (B, T, HK, D) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (HK must divide H)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[1]}]")
    vec = 16 // q.element_size()          # the kernel's 16-byte loads
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dimension, "
                             f"strides in multiples of {vec} elements and "
                             f"a 16-byte aligned start")


def flash_attention(q, k, v, causal: bool = True, kv_len: int | None = None):
    """q (B, S, H, D), k and v (B, T, HK, D) with HK dividing H (query
    head h attends with kv head h // (H // HK)) → (B, S, H, D) in q's
    type.  Keys j < ``kv_len`` (default T) are kept, and j <= i when
    ``causal`` (the reference kernel's mask).  D is 16, 32, 64 or 128 on
    the card.  Where q, k or v requires a gradient, the call carries one
    (:class:`FlashAttentionFn`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, kv_len)
    t = k.shape[1]
    kv_len = t if kv_len is None else int(kv_len)
    if _route(q, k, v) == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    return _forward(q, k, v, causal, kv_len, None)


def _forward(q, k, v, causal: bool, kv_len: int, lse, o32=None):
    """The card's launch(es): out, and each row's log-sum-exp into
    ``lse`` (B, H, S) float32 where it is given.  On the split-KV route
    an ``lse`` comes with ``o32`` ((B, S, H, D) float32, contiguous),
    which takes the rows unrounded in place of ``out`` (a partial
    result)."""
    _check(q, k, v, kv_len)
    b, s, h, d = q.shape
    hk, t = k.shape[2], k.shape[1]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    chunks = split_chunks(q.dtype, s, h // hk, kv_len, causal)
    if chunks and lse is not None and o32 is None:
        raise ValueError(f"the split-KV route (bf16, S·H/HK = "
                         f"{s * h // hk} <= {DECODE_ROWS}) takes no "
                         f"gradient")
    part = None
    if chunks > 1 or (chunks and o32 is not None):
        part = torch.empty(b * hk * chunks * s * (h // hk) * (d + 2),
                           dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _lib()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], d, b, s, h, hk, t, kv_len, int(causal),
        1.0 / math.sqrt(d), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], DECODE_CHUNK,
        None if part is None else part.data_ptr(),
        None if lse is None else lse.data_ptr(), stream)
    if err:
        raise RuntimeError(f"flash_attention failed with cudaError_t {err}")
    launches["flash_attention"] += 1
    if part is not None:
        err = lib.flash_attention_combine(
            part.data_ptr(), out.data_ptr(), d, b, s, h, hk, chunks,
            *out.stride()[:3], None if o32 is None else o32.data_ptr(),
            None if o32 is None else lse.data_ptr(), stream)
        if err:
            raise RuntimeError(f"flash_attention_combine failed with "
                               f"cudaError_t {err}")
        launches["flash_attention_combine"] += 1
    return out


def flash_attention_partials(q, k, v, kv_len: int | None = None):
    """A rank's partial result of unmasked attention over its keys
    j < ``kv_len``: (o (B, S, H, D) float32, the rows normalised over
    those keys; lse (B, H, S) float32, each row's natural-log
    log-sum-exp of its scaled, kept scores).  The plain version on the
    CPU; on the card the float32 kernel (one launch), or bf16 at
    S·H/HK <= :data:`DECODE_ROWS` the split-KV route, whose combine
    launch writes both (two launches).  Other bf16 calls raise."""
    t = k.shape[1]
    kv_len = t if kv_len is None else int(kv_len)
    if _route(q, k, v) == "cpu":
        return ref.attention_partials_ref(q, k, v, kv_len)
    b, s, h, d = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        return _forward(q, k, v, False, kv_len, lse), lse
    if not split_chunks(q.dtype, s, h // k.shape[2], kv_len, False):
        raise ValueError(f"bf16 partials need S·H/HK <= {DECODE_ROWS}, got "
                         f"{s * h // k.shape[2]}")
    o32 = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    _forward(q, k, v, False, kv_len, lse, o32)
    return o32, lse


def merge_partials(o, lse, dtype=torch.bfloat16):
    """R ranks' partials of the same rows → the attention over all their
    keys: o (R, B, S, H, D) and lse (R, B, H, S) float32 (a rank that kept
    no key: o = 0, lse = -inf) → (B, S, H, D) in ``dtype`` (float32 or
    bfloat16): Σ_r e^(lse_r - M)·o_r / Σ_r e^(lse_r - M), M = max_r lse_r,
    in rank order.  The plain version on the CPU, else one launch of
    ``merge_kernel``.  With R = 1 the result is o itself, rounded."""
    if o.dim() != 5 or lse.shape != (o.shape[0], o.shape[1], o.shape[3],
                                     o.shape[2]):
        raise ValueError(f"o (R, B, S, H, D) and lse (R, B, H, S) expected, "
                         f"got {tuple(o.shape)}, {tuple(lse.shape)}")
    if o.dtype != torch.float32 or lse.dtype != torch.float32 \
            or dtype not in _DTYPES:
        raise TypeError(f"float32 o and lse into float32 or bfloat16, got "
                        f"{o.dtype}, {lse.dtype} into {dtype}")
    if _route(o, lse) == "cpu":
        return ref.merge_partials_ref(o, lse, dtype)
    r, b, s, h, d = o.shape
    o = o.contiguous()
    lse = lse.transpose(2, 3).contiguous()             # (R, B, S, H)
    out = torch.empty((b, s, h, d), dtype=dtype, device=o.device)
    err = _lib().flash_attention_merge(
        o.data_ptr(), lse.data_ptr(), out.data_ptr(), _DTYPES[dtype], r,
        b * s * h, d, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_merge failed with cudaError_t "
                           f"{err}")
    launches["flash_attention_merge"] += 1
    return out


def _check_train(q, k, causal: bool, kv_len: int | None):
    s, t = q.shape[1], k.shape[1]
    if kv_len is not None and int(kv_len) != t:
        raise ValueError(f"a training call keeps every key: kv_len "
                         f"{kv_len} != T {t}")
    if causal and s != t:
        raise ValueError(f"a causal training call needs S == T, got S {s} "
                         f"and T {t}")


def flash_attention_forward(q, k, v, causal: bool = True):
    """The training forward: (out (B, S, H, D), lse (B, H, S) float32, the
    natural log of each row's Σ_j exp(q·k_j / sqrt(D)) over its kept
    keys).  The plain version on the CPU, else one kernel launch."""
    _check_train(q, k, causal, None)
    if _route(q, k, v) == "cpu":
        return ref.attention_lse_ref(q, k, v, causal=causal)
    b, s, h, _ = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, k.shape[1], lse), lse


def _aligned(x):
    """``x`` contiguous from a 16-byte aligned start (the backward
    kernels' 16-byte copies), copied where it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention_backward_route(dtype, d: int) -> str:
    """The backward kernels a card call takes: "mma" (bf16, the tensor
    cores) or "fma" (float32, the CUDA cores), at a head dim in
    :data:`HEAD_DIMS`; raises for any other type or head dim."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"flash_attention_backward takes float32 or bfloat16, "
                    f"got {dtype}")


def flash_attention_backward(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) of a training call for the upstream ``do``, from its
    inputs, output and LSE; each in its input's type.  The plain version
    on the CPU, else one ``flash_attention_backward`` call (three kernels,
    the same bits from call to call)."""
    _check_train(q, k, causal, None)
    if _route(q, k, v, o, lse, do) == "cpu":
        return ref.attention_backward_ref(q, k, v, o, lse, do, causal)
    q, k, v, o, do = (_aligned(x) for x in (q, k, v, o, do.to(q.dtype)))
    _check(q, k, v, k.shape[1])
    b, s, h, d = q.shape
    hk, t = k.shape[2], k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype} do not fit q {tuple(q.shape)}")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dd = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _lib().flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype],
        _BWD_ROUTES[flash_attention_backward_route(q.dtype, d)], d, b, s, h,
        hk, t, int(causal), 1.0 / math.sqrt(d), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dd.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_backward failed with "
                           f"cudaError_t {err}")
    launches["flash_attention_backward"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient: :func:`flash_attention_forward` (out
    and LSE) and :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len):
        _check_train(q, k, causal, kv_len)
        o, lse = flash_attention_forward(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              ctx.causal)
        return dq, dk, dv, None, None


def split_chunks(dtype, s: int, g: int, kv_len: int, causal: bool) -> int:
    """Chunks of :data:`DECODE_CHUNK` keys that a card call with S
    queries over G = H / HK heads a kv head takes on the split-KV route
    (bfloat16, S·G <= :data:`DECODE_ROWS`), up to kv_len and, when
    causal, up to S; 0 for the other routes."""
    if dtype != torch.bfloat16 or s * g > DECODE_ROWS:
        return 0
    kv_end = min(kv_len, s) if causal else kv_len
    return -(-kv_end // DECODE_CHUNK)


def flash_attention_bhsd(q, k, v, causal: bool = True,
                         kv_len: int | None = None):
    """q (BH, S, D), k and v (BH, T, D) → (BH, S, D): the reference
    kernel's layout, as one head per row of BH."""
    return flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                           causal=causal, kv_len=kv_len)[:, :, 0]
