"""Front door of the NE-round kernels: ``one_hop``, ``select_chunk``
(boundary selection with its restart draw), ``claim_scatter``,
``two_hop_best`` (the two-hop chunk's candidate keys), and the bit-packed
replica-set kernels ``pack_bits``, ``unpack_bits`` and ``or_words``, with
the reference package's signatures (packed words are int32 bit patterns
of the reference's uint32 words).

The tensor's device decides the route: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel in
``csrc/ne_round.cu`` (built with ``nvcc`` at first use); anything else
raises.  There is no fallback from the kernel to the plain version.
Each wrapper checks its inputs, allocates its outputs, launches on the
current stream and adds one to ``launches[name]`` per kernel call;
``select_chunk`` counts its selection under ``"select"`` and its restart
draw under ``"restart_draw"``, and the draw adds the rows it drew to a
counter on the device (:func:`rows_drawn`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ne_round import ref

launches = {"one_hop": 0, "select": 0, "restart_draw": 0,
            "claim_scatter": 0, "two_hop_best": 0, "pack_bits": 0,
            "unpack_bits": 0, "or_words": 0}
_drawn: dict = {}        # device -> (1,) int64 rows the restart draw drew

_P = ctypes.c_void_p
_ARGTYPES = {
    "ne_one_hop": [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                   _P, _P, _P],
    "ne_claim_scatter": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                         ctypes.c_longlong, ctypes.c_int, _P, _P],
    "ne_select": [_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P, _P,
                  ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                  ctypes.c_int, _P, _P, _P, _P, _P],
    "ne_two_hop_best": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
                        _P, _P, ctypes.c_longlong, _P, _P],
    "ne_pack_bits": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, _P, _P],
    "ne_unpack_bits": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _P, _P],
    "ne_or_words": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P],
}
MAX_K_SEL = 4096   # select_finish sorts K + 2,048 keys in 64 KB of shared
                   # memory


def reset_launches() -> None:
    """Every launch count to 0, and the rows-drawn counters."""
    for k in launches:
        launches[k] = 0
    for t in _drawn.values():
        t.zero_()


def rows_drawn(device) -> int:
    """Rows the restart draw kernel drew on ``device`` since the last
    :func:`reset_launches` (reads the device counter: a sync)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _drawn.get(dev)
    return 0 if t is None else int(t.item())


def _lib():
    """The built library, its argument types set (built at first use)."""
    from repro_torch.kernels import build

    lib = build.load("ne_round")
    if lib.ne_select.argtypes is None:
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.ne_select_scratch_bytes.argtypes = [ctypes.c_int,
                                                ctypes.c_longlong,
                                                ctypes.c_int]
        lib.ne_select_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _route(*tensors) -> str:
    """'cpu' or 'cuda' from the tensors' common device; raises otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no NE-round kernel for device {dev}")
    return dev.type


def _check(t, dtype, shape, name):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, fn: str) -> None:
    if err:
        raise RuntimeError(f"{fn} failed with cudaError_t {err}")


def one_hop(vclaim, u, v, edge_part, num_partitions: int, mask=None):
    """Returns ``(part, counts)``: (M,) int32, -1 where no new allocation,
    and the (P,) int32 histogram of new allocations."""
    if _route(vclaim, u, v, edge_part, mask) == "cpu":
        return ref.one_hop_ref(vclaim, u, v, edge_part, num_partitions,
                               mask=mask)
    m = u.shape[0]
    _check(vclaim, torch.int32, vclaim.shape[:1], "vclaim")
    for t, name in ((u, "u"), (v, "v"), (edge_part, "edge_part")):
        _check(t, torch.int32, (m,), name)
    if mask is not None:
        _check(mask, torch.bool, (m,), "mask")
    part = torch.empty(m, dtype=torch.int32, device=u.device)
    counts = torch.empty(num_partitions, dtype=torch.int32, device=u.device)
    err = _lib().ne_one_hop(_ptr(vclaim), _ptr(u), _ptr(v), _ptr(edge_part),
                            _ptr(mask), m, num_partitions, _ptr(part),
                            _ptr(counts), _stream())
    _raise_on(err, "ne_one_hop")
    launches["one_hop"] += 1
    return part, counts


def select_chunk(vparts_c, active_c, degree_rest, lam: float, k_sel: int,
                 keys_c, remaining_c):
    """Boundary selection of C rows (partitions) with the restart draw
    from their (C, 2) int64 threefry keys; returns ``(idx, valid)`` of
    shape (C, k_sel).  ``vparts_c`` may be a strided view (the kernel
    reads it through its strides, in place): the partitioner passes the
    whole (N, P) map transposed."""
    if _route(vparts_c, active_c, degree_rest, keys_c, remaining_c) == "cpu":
        return ref.select_chunk_ref(vparts_c, active_c, degree_rest, lam,
                                    k_sel, keys_c, remaining_c)
    c, n = vparts_c.shape
    if vparts_c.dtype != torch.bool:
        raise TypeError(f"vparts_c: dtype {vparts_c.dtype}, expected bool")
    if not 1 <= k_sel <= min(n, MAX_K_SEL):
        raise ValueError(f"k_sel={k_sel} outside [1, min(N, {MAX_K_SEL})]")
    _check(degree_rest, torch.int32, (n,), "degree_rest")
    _check(active_c, torch.bool, (c,), "active_c")
    _check(remaining_c, torch.int32, (c,), "remaining_c")
    _check(keys_c, torch.int64, (c, 2), "keys_c")
    dev = vparts_c.device
    lib = _lib()
    scratch = torch.empty(lib.ne_select_scratch_bytes(c, n, k_sel),
                          dtype=torch.uint8, device=dev)
    if dev not in _drawn:
        _drawn[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    idx = torch.empty((c, k_sel), dtype=torch.int32, device=dev)
    valid = torch.empty((c, k_sel), dtype=torch.bool, device=dev)
    s_c, s_n = vparts_c.stride()
    err = lib.ne_select(_ptr(vparts_c), s_c, s_n, _ptr(degree_rest),
                        _ptr(active_c), _ptr(remaining_c), _ptr(keys_c), c, n,
                        float(lam), k_sel, _ptr(scratch), _ptr(_drawn[dev]),
                        _ptr(idx), _ptr(valid), _stream())
    _raise_on(err, "ne_select")
    launches["select"] += 1
    launches["restart_draw"] += 1
    return idx, valid


def claim_scatter(sel_idx, sel_valid, edges_per_part, num_vertices: int,
                  num_partitions: int):
    """(P, K) selections → (N,) int32 claim keys."""
    if _route(sel_idx, sel_valid, edges_per_part) == "cpu":
        return ref.claim_scatter_ref(sel_idx, sel_valid, edges_per_part,
                                     num_vertices, num_partitions)
    rows, k = sel_idx.shape
    _check(sel_idx, torch.int32, (rows, k), "sel_idx")
    _check(sel_valid, torch.bool, (rows, k), "sel_valid")
    _check(edges_per_part, torch.int32, (rows,), "edges_per_part")
    out = torch.empty(num_vertices, dtype=torch.int32, device=sel_idx.device)
    if num_vertices == 0:                  # nothing to write: no launch
        return out
    err = _lib().ne_claim_scatter(_ptr(sel_idx), _ptr(sel_valid),
                                  _ptr(edges_per_part), rows, k,
                                  num_vertices, num_partitions, _ptr(out),
                                  _stream())
    _raise_on(err, "ne_claim_scatter")
    launches["claim_scatter"] += 1
    return out


def pack_bits_route(bools) -> str:
    """The kernel that packs ``bools`` on the card: ``"vector"`` (one
    thread a word, 16-byte loads) where P % 32 == 0 and the map is 16-byte
    aligned, else ``"ballot"`` (one warp a word)."""
    vec = bools.shape[1] % 32 == 0 and bools.data_ptr() % 16 == 0
    return "vector" if vec else "ballot"


def pack_bits(bools):
    """(N, P) bool → (N, ceil(P/32)) int32 words, LSB-first, pad bits 0."""
    if _route(bools) == "cpu":
        return ref.pack_bits_ref(bools)
    n, p = bools.shape
    _check(bools, torch.bool, (n, p), "bools")
    w = ref.replica_words(p)
    words = torch.empty((n, w), dtype=torch.int32, device=bools.device)
    err = _lib().ne_pack_bits(_ptr(bools), n, p, w,
                              int(pack_bits_route(bools) == "vector"),
                              _ptr(words), _stream())
    _raise_on(err, "ne_pack_bits")
    launches["pack_bits"] += 1
    return words


def unpack_bits_route(words, num_partitions: int) -> str:
    """The kernel that unpacks ``words`` on the card: ``"vector"`` (one
    thread a 16-flag half, 16-byte stores) where P == 32 W, so that word t
    is flag bytes 32t .. 32t + 31 of the map, else ``"generic"``."""
    vec = num_partitions == 32 * words.shape[1]
    return "vector" if vec else "generic"


def unpack_bits(words, num_partitions: int):
    """(N, W) int32 words → (N, P) bool, contiguous: the inverse of
    :func:`pack_bits`."""
    if _route(words) == "cpu":
        return ref.unpack_bits_ref(words, num_partitions)
    n, w = words.shape
    _check(words, torch.int32, (n, w), "words")
    if not 1 <= num_partitions <= 32 * w:
        raise ValueError(f"num_partitions={num_partitions} outside "
                         f"[1, {32 * w}] for {w} words")
    bools = torch.empty((n, num_partitions), dtype=torch.bool,
                        device=words.device)
    vec = unpack_bits_route(words, num_partitions) == "vector"
    err = _lib().ne_unpack_bits(_ptr(words), n, num_partitions, w, int(vec),
                                _ptr(bools), _stream())
    _raise_on(err, "ne_unpack_bits")
    launches["unpack_bits"] += 1
    return bools


def two_hop_best(vparts, uu, vv, un, enc_vec, num_partitions: int):
    """(ce,) int32 candidate keys of a two-hop chunk: per edge, the least
    ``enc_vec[p]`` over the partitions p holding both endpoints, where the
    edge is unallocated (``un``), else ``I32_INF``.  ``vparts`` is the
    (N, P) bool map or the (N, W) int32 packed words."""
    if _route(vparts, uu, vv, un, enc_vec) == "cpu":
        return ref.two_hop_best_ref(vparts, uu, vv, un, enc_vec,
                                    num_partitions)
    ce = uu.shape[0]
    n, w = vparts.shape
    words = vparts.dtype == torch.int32
    if words and not 1 <= num_partitions <= 32 * w:
        raise ValueError(f"num_partitions={num_partitions} outside "
                         f"[1, {32 * w}] for {w} words")
    _check(vparts, torch.int32 if words else torch.bool,
           (n, w if words else num_partitions), "vparts")
    for t, name in ((uu, "uu"), (vv, "vv")):
        _check(t, torch.int32, (ce,), name)
    _check(un, torch.bool, (ce,), "un")
    _check(enc_vec, torch.int32, (num_partitions,), "enc_vec")
    best = torch.empty(ce, dtype=torch.int32, device=uu.device)
    if ce == 0:                            # nothing to write: no launch
        return best
    err = _lib().ne_two_hop_best(_ptr(vparts), int(words), w, num_partitions,
                                 _ptr(uu), _ptr(vv), _ptr(un), _ptr(enc_vec),
                                 ce, _ptr(best), _stream())
    _raise_on(err, "ne_two_hop_best")
    launches["two_hop_best"] += 1
    return best


def or_words_route(a, b, out) -> str:
    """The kernel that ORs ``a`` and ``b`` into ``out`` on the card:
    ``"vector"`` (16-byte loads and stores) where all three are 16-byte
    aligned (torch's allocations are; a view may not be), else
    ``"scalar"``."""
    vec = (a.data_ptr() | b.data_ptr() | out.data_ptr()) % 16 == 0
    return "vector" if vec else "scalar"


def or_words(a, b):
    """Element-wise OR of two packed replica maps of one shape."""
    if _route(a, b) == "cpu":
        return ref.or_words_ref(a, b)
    _check(a, torch.int32, a.shape, "a")
    _check(b, torch.int32, a.shape, "b")
    out = torch.empty_like(a)
    vec = or_words_route(a, b, out) == "vector"
    err = _lib().ne_or_words(_ptr(a), _ptr(b), a.numel(), int(vec),
                             _ptr(out), _stream())
    _raise_on(err, "ne_or_words")
    launches["or_words"] += 1
    return out
