"""Front door of the flash attention kernel: ``flash_attention`` on the
(B, S, H, D) layout (k and v with H or fewer heads, grouped-query) and
``flash_attention_bhsd`` on the reference kernel's (BH, S, D) layout.

The tensor's device decides the route: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel in
``csrc/flash_attention.cu`` (built with ``nvcc`` at first use); anything
else raises.  There is no fallback from the kernel to the plain version.
The wrapper checks its inputs, allocates the output, launches on the
current stream and adds one to ``launches["flash_attention"]`` per
kernel call.  ``models/lm/transformer.py`` calls it only with CUDA
tensors: on the CPU the model runs the reference's own plain attention
(whose decode and short-sequence branches round the probabilities to the
model's type), so the CPU branch here serves the kernel's tests.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_attention import ref

launches = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128)
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _LL, _LL,
              ctypes.c_int, ctypes.c_int, _LL, _LL, ctypes.c_int,
              ctypes.c_float] + [_LL] * 12 + [_P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    the card."""
    t = k.shape[1]
    kv_len = t if kv_len is None else int(kv_len)
    if _route(q, k, v) == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    _check(q, k, v, kv_len)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], d, b, s, h, k.shape[2], t, kv_len, int(causal),
        1.0 / math.sqrt(d), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention failed with cudaError_t {err}")
    launches["flash_attention"] += 1
    return out


def flash_attention_bhsd(q, k, v, causal: bool = True,
                         kv_len: int | None = None):
    """q (BH, S, D), k and v (BH, T, D) → (BH, S, D): the reference
    kernel's layout, as one head per row of BH."""
    return flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                           causal=causal, kv_len=kv_len)[:, :, 0]
