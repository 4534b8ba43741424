#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Distributed NE on one NVIDIA card.

    python3 chip_smoke.py                 # the full run (RMAT scale 22)
    python3 chip_smoke.py --scale 16      # a quicker rehearsal of 1-6, 9

Phases, each printing its lines; any failed check exits non-zero:

1. the device (name and power limit from nvidia-smi) and the time to
   build the CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (RMAT scale-22 graph, P = 64, K = 256; ``select_chunk``
   over all 64 rows of the map, as the main path calls it, with restart
   rows at N = 2^22 and the rows its draw ran counted on the device, and
   over an 8-row chunk view; ``two_hop_best`` at the two-hop chunk on
   bool rows and packed words; the bit-packing kernels also at a ragged
   P = 37 and at the two-hop chunk shape, and each on each of its routes
   at 2^20 + 3 rows: ``pack_bits``'s vector route at P = 32, 64, 96, 128,
   its ballot route at P = 37 and on a view 1 byte off alignment;
   ``unpack_bits``'s vector route at P = 32, 64, 96, 128 and its generic
   route at P = 37 and 48; ``or_words``'s vector route and its scalar
   route on views one word off alignment; each the same bits from call
   to call), exactly: the kernels are integer math, so the tolerance is
   0;
3. the main path: ``partition`` of the RMAT graph (edge factor 16,
   P = 64, the other NEConfig fields at their defaults) on the card, with
   the kernel launch counts set to 0 just before and read just after
   (one ``select`` and one ``restart_draw`` a round, ``two_hop_best``
   once a two-hop chunk), and its invariants;
3b. the SPMD path: ``partition_spmd`` of the same graph and config in a
   world-1 NCCL group on the card, with the counts set to 0 just before
   and read just after; it must equal phase 3's result bit for bit, and
   each kernel's launches must match the round count's formula;
4. ``partition`` at RMAT scale 14 on the card and on the CPU (plain
   versions), and ``partition_spmd`` at that scale on the card (NCCL)
   and on the CPU (gloo), all four bit-identical;
5. one round of each path under torch.profiler (device time by kernel,
   busy share), the time of the round's layers (the restart draw,
   ``vertex_claims``, the two-hop) at round 0 and at the timed round with
   the rows the draw ran, and each kernel's time on inputs taken from a
   real round (single-controller kernels; ``two_hop_best`` on bool rows)
   or a real SPMD round (bit-packing kernels; ``two_hop_best`` on packed
   words) beside its plain version's, a library call's and its bound
   (bytes, or a restart draw's integer operations), as one JSON line;
   each also with the device time of its own kernels and of the library
   call's (torch.profiler), and the route each bit-packing kernel took,
   the device time of a ``copy_`` of its bytes (the card's streaming
   rate) and the 16-byte loads and stores of the vector kernels
   (``cuobjdump -sass``);
   ``claim_scatter``'s one launch a call;
6. full-graph GIN training (gin-tu, 5 layers, d_hidden 64) over the
   vertex-cut engine in a world-1 NCCL group, on a graph of Cora's size
   (``full_graph_sm``: 2,708 vertices, ~10,556 edges, 1,433 features,
   7 classes) made from a seed: the registers, shared memory and spills
   of the ``block_spmm`` kernels and the HMMA count of the tensor-core
   one (``cuobjdump -sass``); each ``block_spmm`` kernel against its
   plain version (forward and backward; the tensor-core kernel at the
   main path's 128 x 128 blocks, the FMA kernel at 16 x 16) and bit for
   bit from call to call, three steps on the card against three on the CPU
   (gloo, plain versions), 20 steps of ``train_engine_gin`` with the
   launch counts set to 0 just before and read just after (steps x
   (2L - 1) launches), and the kernel's times (events, and its own
   kernels' device time) beside its FP32 and 3xTF32 bounds, its plain
   version's and a library call's.  Its row joins phase 5's JSON line;
7. DeepFM serving at full width (deepfm: 39 fields x 1,048,576 rows,
   D 10, MLP 400-400-400, 10^6 candidates, float32, seeded random
   parameters made on the card): the ``embedding_bag`` kernel against its
   plain version at the serve_p99 (B = 512) and serve_bulk (B = 262,144)
   shapes and at its other cuts (one bag in tiles of slots, B = 1, B not
   a multiple of the bags a block), each sum also bit for bit the
   in-order float32 sum and the same bits from call to call, the card's
   forward against the CPU's, the time per batch and
   rows/s of each (2 launches a forward, counts set to 0 just before and
   read just after), the retrieval_cand time, peak memory, and the
   kernel's times (events and device time) beside its bounds (bytes, and
   the 32-byte sectors its rows touch), its plain version's and
   ``F.embedding_bag``'s;
8. smollm-135m serving at full width in bf16 (seeded random weights): the
   ``flash_attention`` kernel against its plain version at prefill shapes
   and every head dim and group size on the tensor-core route, at the
   decode_32k shape (one chunk, several, a chunk boundary) on the split-KV
   route and at serve_batch's decode shapes, each bit for bit from call to
   call; the tensor-core and TMA instructions that ``cuobjdump -sass``
   counts in the built prefill kernel; the model in float32 on the card
   against the CPU
   (prefill logits, 8 teacher-forced decode steps), ``serve_batch`` of 8
   prompts of 64 tokens with 32 new ones (30 x 95 launches), prefill_32k
   at batch 1 (cut from 32) and one decode_32k step at batch 32 (cut from
   128; 30 flash_attention and 30 combine launches) on a seeded random
   cache, each with its counts set to 0 just
   before and read just after, and the kernel's times (events and device
   time) at the prefill_32k and decode_32k layers beside its bound, the
   plain version's and ``F.scaled_dot_product_attention``'s.  Rows 7, 8
   and 9 join the line;
9. the driver from the store: phase 3's canonical edge list written as
   an EdgeFile; ``PartitionDriver`` in spmd mode from it, in a world-1
   NCCL group in a child process (a CUDA context of its own), with a
   snapshot every rounds / 8 rounds, killed by SIGKILL right after the
   fourth is published; resumed in this process from the newest snapshot
   with the launch counts set to 0 just before and read just after (each
   NE row of the line gets them as ``launches_driver``); the resumed run
   must equal phase 3's result bit for bit (at scale 22: 448 rounds, RF
   1.7922852039337158, EB 1.10000089317367) with launches matching the
   resumed rounds; its time a round beside phase 3b's, the ingest,
   snapshot save and restore times (the driver's obs spans) and peak
   memory; then the result saved as an artifact, loaded back and equal;
10. baselines and hybrid: (a) what the quality matrix does not reach:
   the stream kernels ``hdrf_scan`` and ``oblivious_scan`` against their
   plain versions bit for bit and call to call on rmat(10, 8, seed 3)
   at P = 1 and a ragged P = 37, HDRF at lambda 0.5 and 2, Oblivious at
   a limit every partition fills (the overflow rule); (b) the 32 rows of
   ``BENCH_QUALITY.json``'s fast matrix (``repro_torch.tools.quality``:
   RMAT scale 14 and the ingested power-law ``real`` graph, P = 4 and
   16, NE, the hybrid at tau 0.5 and 0.25, the five baselines) each
   equal to its expected (rf, eb, vb), with the launch counts set to 0
   just before and read just after; then each stream kernel at every
   cell of that matrix on the baselines' own inputs: the wrapper's
   time, the launch's alone and its fills' apart (CUDA events), the
   bound, and on ``real`` (P = 4 and 16) the kernel against its plain
   version bit for bit and the plain version's time; (c)
   ``partition_hybrid`` from phase 9's EdgeFile at P = 64, tau = 0.25
   (the split streamed on the host, the rounds on the card), counts set
   to 0 just before and read just after (one ``select`` and one
   ``restart_draw`` a round, ``two_hop_best`` once a two-hop chunk), its
   obs spans (split, rounds, finalize), theta, M_low, peak memory and
   invariants; (d) ``PartitionDriver`` in hybrid mode on the scale-14
   RMAT graph at P = 16, snapshots every 8 rounds, stopped at round 24
   and resumed in this process: (b)'s run bit for bit, and the artifact
   round trip.

The last line is ``{"ok": true, "device": {...}}``.  There is no CPU
fallback: without a CUDA device the script exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

EDGE_FACTOR = 16                   # the main path's graph: RMAT, EF 16
PARTITIONS = 64                    # P = 64; other NEConfig fields default

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOPS = 67e12                 # H100 SXM, FP32 on the CUDA cores
BF16_FLOPS = 989e12                # H100 SXM, bf16 dense, tensor cores
TF32_FLOPS = 495e12                # H100 SXM, TF32 dense, tensor cores
# H100 SXM integer rate of one pipe: 64 lanes an SM (Hopper white paper) x
# 132 SMs x 1.98 GHz, the clock at which the 67 TFLOP/s FP32 figure holds
INT32_OPS = 64 * 132 * 1.98e9
# integer operations of one threefry2x32 uniform draw: 20 rounds of add,
# rotate and xor, 5 key injections of 2 adds, 2 initial adds, then the
# xor and shift of the output bits and the compare with the running max.
# An add runs on the ALU pipe (IADD3) or on the FMA pipe (IMAD.IADD),
# 64 lanes an SM each; a rotate, xor, shift or compare on the ALU pipe
# alone. So a draw takes at least the larger of its ALU-only operations
# and half of all its operations at one pipe's rate.
THREEFRY_ADDS = 20 + 5 * 2 + 2
THREEFRY_ALU_ONLY = 20 * 2 + 3
THREEFRY_PIPE_OPS = max(THREEFRY_ALU_ONLY,
                        (THREEFRY_ADDS + THREEFRY_ALU_ONLY) / 2)
CU_SOURCE = "src/repro_torch/kernels/ne_round/csrc/ne_round.cu"
SPMM_SOURCE = "src/repro_torch/kernels/block_spmm/csrc/block_spmm.cu"
EB_SOURCE = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
FA_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu")
GNN_SHAPE = "full_graph_sm"        # Cora's size (configs/shapes.py)
ER_DEGREE = 6.5                    # |E| after dedup 10,545 (10,556 - 0.1 %)
GNN_STEPS = 20                     # examples/train_gnn_partitioned.py:
GNN_OPT = dict(lr=3e-3, weight_decay=0.0, warmup_steps=20)   # its OptConfig
CHECK_STEPS = 3                    # card against CPU
# phase 9: a snapshot every (phase 3's rounds) / 8 rounds, the child killed
# after the fourth (rounds 56-224 of 448 at scale 22); the resumed run must
# give the main path's rounds, RF and EB at scale 22 (PERF.md §5)
DRIVER_SNAPSHOTS_BEFORE_KILL = 4
SCALE22_RESULT = (448, 1.7922852039337158, 1.10000089317367)
CHILD_TIMEOUT_S = 600
REPLACES = {
    "one_hop": "src/repro/kernels/ne_round/ne_round.py:80",
    "select": "src/repro/kernels/ne_round/ne_round.py:188",
    # the draw the reference makes in XLA outside its select kernel
    "restart_draw": "src/repro/core/partitioner.py:132",
    "claim_scatter": "src/repro/kernels/ne_round/ne_round.py:245",
    "pack_bits": "src/repro/kernels/ne_round/ne_round.py:296",
    "unpack_bits": "src/repro/kernels/ne_round/ne_round.py:313",
    # unpack_bits at the two-hop chunk, with the AND, where and min around
    "two_hop_best": "src/repro/kernels/ne_round/ne_round.py:313",
    "or_words": "src/repro/kernels/ne_round/ne_round.py:330",
    "block_spmm": "src/repro/kernels/block_spmm/block_spmm.py:41",
    "embedding_bag": "src/repro/kernels/embedding_bag/embedding_bag.py:34",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:63",
    # lax.scan loops, not Pallas kernels: XLA runs them one edge a step
    "hdrf_scan": "src/repro/core/baselines.py:56",
    "oblivious_scan": "src/repro/core/baselines.py:100",
}
BIT_KERNELS = ("pack_bits", "unpack_bits", "or_words")
# phase 10: the baselines' stream kernels, the quality matrix, the hybrid
STREAM_SOURCE = "src/repro_torch/kernels/stream/csrc/stream.cu"
STREAM_KERNELS = ("hdrf_scan", "oblivious_scan")
STREAM_CHECK_PARTS = (1, 37)       # (a): one partition; a ragged 2nd warp
STREAM_LAMBDAS = (0.5, 2.0)        # (a)'s HDRF; the matrix runs lambda 1
STREAM_PLAIN_GRAPH = "real"        # the matrix's cells held against plain
STREAM_ROW_P = 16                  # the JSON rows' cell (real, P = 16)
CLOCK_HZ = 1.98e9                  # H100 SXM boost clock (INT32_OPS's)
HYBRID_TAU = 0.25                  # (c) and (d): the tightest budget
HYBRID_DRIVER = ("rmat_s14_ef16", 16, 8, 24)   # graph, P, every, stop


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(torch, fn, reps: int) -> dict:
    """{kernel name: (ms, instances)} a call of ``fn``'s own kernels on the
    device, from the self device time that torch.profiler records over
    ``reps`` calls after a warm-up call: each kernel's mean time an
    instance times its instances a call (its count over ``reps``, rounded:
    the profiler loses an instance now and then)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and e.count:
            k = max(1, round(e.count / reps))
            out[e.key] = (k * e.self_device_time_total / e.count / 1e3, k)
    return out


def device_ms(torch, fn, reps: int, tries: int = 5):
    """(ms, kernels) per call of ``fn``'s own kernels on the device
    (:func:`device_kernels` summed).  Late in full runs the profiler lost
    some instances of a call's kernels in a window (up to all 3 of the
    prefill layer's, where a fresh process lost none), so calls are
    profiled 20 at a time where they can be, and a profile with no device
    time at all is taken again and said so.  Fails if all ``tries`` are
    empty."""
    for attempt in range(1, tries + 1):
        per = device_kernels(torch, fn, reps)
        ms = sum(t for t, _ in per.values())
        if ms > 0:
            return ms, sum(k for _, k in per.values())
        print(f"device_ms: torch.profiler recorded no device time (try "
              f"{attempt} of {tries}, {time.perf_counter() - T_START:.1f} "
              f"s into the script)", flush=True)
    fail("torch.profiler recorded no device time")


def kernel_ms(per: dict, match: str) -> float:
    """The device ms a call of the kernels whose name holds ``match``."""
    return sum(t for name, (t, _) in per.items() if match in name)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def draw_bound_ms(draws: int) -> float:
    """The least time of ``draws`` threefry draws on the integer pipes."""
    return draws * THREEFRY_PIPE_OPS / INT32_OPS * 1e3


def cuobjdump():
    """The cuobjdump of the CUDA toolkit or of Triton's package, or None."""
    import shutil

    tools = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((t for t in tools if t and os.path.exists(t)), None)


def sass_counts(tool, build, family: str, match: str, instrs) -> dict:
    """{kernel: {instruction: count}} from ``tool -sass`` (cuobjdump) of a
    built family, for the kernels whose mangled name holds ``match``."""
    sass = subprocess.run([tool, "-sass", str(build._library(family))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if match in fn else None
            if fn:
                counts[fn] = dict.fromkeys(instrs, 0)
        elif fn:
            for ins in counts[fn]:
                counts[fn][ins] += f" {ins}." in line or f" {ins} " in line
    return counts


def ptxas_report(build, family: str, kernels, label: str) -> None:
    """Print ``nvcc -Xptxas -v``'s registers, static shared memory and
    spills of the named kernels of a family built in this run."""
    name, seen = None, set()
    for line in build.build_logs.get(family, "").splitlines():
        if ("Compiling entry function" in line
                or "Function properties for" in line):
            name = next((k for k in kernels if k in line), None)
        elif name and ("spill" in line or "Used" in line):
            seen.add(name)
            print(f"{label}: ptxas {name}: {line.split(':', 1)[-1].strip()}",
                  flush=True)
    if set(kernels) - seen:
        print(f"{label}: ptxas: no report for {sorted(set(kernels) - seen)} "
              f"in the build log of {family}", flush=True)


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0


def select_err(got, want) -> int:
    """Only valid slots feed claim_scatter: compare ``valid`` and
    ``where(valid, idx, -1)``."""
    import torch

    gi, gv = got
    wi, wv = want
    m1 = torch.where(gv, gi, torch.full_like(gi, -1))
    m2 = torch.where(wv, wi, torch.full_like(wi, -1))
    return max(max_abs_err(gv, wv), max_abs_err(m1, m2))


def phase_kernels(torch, ops, ref, g, dev, p_num, c, k_sel):
    """Phase 2: kernels against plain versions at the main path's shapes."""
    n, m = g.num_vertices, g.num_edges
    gen = torch.Generator(device=dev).manual_seed(12)
    i32 = torch.int32
    u = g.edges[:, 0].contiguous()
    v = g.edges[:, 1].contiguous()

    # one_hop: a tenth of the vertices claimed, a third of the edges taken
    vclaim = torch.full((n,), ref.I32_INF, dtype=i32, device=dev)
    cl = torch.randint(0, n, (n // 10,), generator=gen, device=dev)
    vclaim[cl] = torch.randint(0, 1 << 20, (cl.numel(),), generator=gen,
                               device=dev, dtype=i32)
    ep = torch.where(torch.rand(m, generator=gen, device=dev) < 0.3,
                     torch.randint(0, p_num, (m,), generator=gen,
                                   device=dev, dtype=i32),
                     torch.full((m,), -1, dtype=i32, device=dev))
    mask = torch.rand(m, generator=gen, device=dev) < 0.9
    for mk in (None, mask):
        got = ops.one_hop(vclaim, u, v, ep, p_num, mask=mk)
        want = ref.one_hop_ref(vclaim, u, v, ep, p_num, mask=mk)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        check(err == 0, f"one_hop differs (mask={mk is not None}): {err}")
    print(f"phase 2: one_hop == plain at M={m}, N={n}, P={p_num} "
          "(with and without mask)", flush=True)

    # claim_scatter: half the selections crowd onto 1000 vertices
    sel_idx = torch.randint(0, n, (p_num, k_sel), generator=gen, device=dev,
                            dtype=i32)
    sel_idx[:, ::2] = torch.randint(0, 1000, (p_num, k_sel // 2),
                                    generator=gen, device=dev, dtype=i32)
    sel_valid = torch.rand((p_num, k_sel), generator=gen, device=dev) < 0.7
    epp = torch.randint(0, 1 << 20, (p_num,), generator=gen, device=dev,
                        dtype=i32)
    err = max_abs_err(ops.claim_scatter(sel_idx, sel_valid, epp, n, p_num),
                      ref.claim_scatter_ref(sel_idx, sel_valid, epp, n,
                                            p_num))
    check(err == 0, f"claim_scatter differs: {err}")
    print(f"phase 2: claim_scatter == plain at P={p_num}, K={k_sel}, N={n}",
          flush=True)

    # select_chunk: all P rows as one strided (P, N) view of the (N, P)
    # map, as on the main path; "chunk view" reads 8 rows by byte loads
    from repro_torch import random as trandom

    deg = g.degree.to(i32)
    cases = {}
    dr = torch.where(torch.rand(n, generator=gen, device=dev) < 0.3,
                     torch.zeros_like(deg), deg)
    cases["random"] = (torch.rand((n, p_num), generator=gen, device=dev)
                       < 0.05, dr, p_num)
    cases["ties"] = (torch.rand((n, p_num), generator=gen, device=dev) < 0.02,
                     torch.ones_like(deg), p_num)        # every score equal
    vp = torch.zeros((n, p_num), dtype=torch.bool, device=dev)
    for col in range(p_num):                             # |B| = 0 .. > K
        rows = torch.randint(0, n, (col * 37,), generator=gen, device=dev)
        vp[rows, col] = True
    cases["sparse+restart"] = (vp, deg, p_num)
    cases["all restart"] = (torch.zeros_like(vp), dr, p_num)   # as round 0
    vp = torch.rand((n, p_num), generator=gen, device=dev) < 0.05
    vp[:, ::3] = False
    cases["some restart"] = (vp, dr, p_num)
    cases["chunk view"] = (torch.rand((n, p_num), generator=gen, device=dev)
                           < 0.05, dr, c)
    for name, (vp, dr, rows) in cases.items():
        active = torch.ones(rows, dtype=torch.bool, device=dev)
        active[rows - 2] = False
        remaining = torch.randint(0, 5000, (rows,), generator=gen,
                                  device=dev, dtype=i32)
        remaining[0] = 1 << 30
        keys = trandom.fold_in(trandom.PRNGKey(7, device=dev),
                               torch.arange(rows, device=dev))
        args = (vp[:, :rows].T, active, dr, 0.1, k_sel, keys, remaining)
        drawn = ops.rows_drawn(dev)
        got = ops.select_chunk(*args)
        drawn = ops.rows_drawn(dev) - drawn
        err = select_err(got, ref.select_chunk_ref(*args))
        check(err == 0, f"select_chunk differs on case {name!r}: {err}")
        bnd = args[0] & (dr > 0)[None, :] & active[:, None]
        want = int((~bnd.any(1) & active).sum()) if bool((dr > 0).any()) \
            else 0
        check(drawn == want, f"select_chunk case {name!r}: the draw ran for "
              f"{drawn} rows, {want} restart")
        print(f"phase 2: select_chunk == plain, case {name!r}, C={rows}, "
              f"N={n}, K={k_sel}; the draw ran for {drawn} restart rows",
              flush=True)


def phase_two_hop_kernel(torch, ops, ref, g, dev, p_num, ce):
    """Phase 2, ``two_hop_best`` against its plain version at the two-hop
    chunk (the graph's first ``ce`` edges, 60 % unallocated) on bool rows
    and packed words, at P and at a ragged 37 (byte loads, a pad word)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    n = g.num_vertices
    u = g.edges[:ce, 0].contiguous()
    v = g.edges[:ce, 1].contiguous()
    un = torch.rand(ce, generator=gen, device=dev) < 0.6
    bools = torch.rand((n, p_num), generator=gen, device=dev) < 0.05
    enc = torch.randint(0, 1 << 20, (p_num,), generator=gen, device=dev,
                        dtype=torch.int32)
    enc[::7] = ref.I32_INF                      # partitions over the limit
    for p in (p_num, 37):
        rows = bools[:, :p].contiguous()
        for fmt, vparts in (("bool rows", rows),
                            ("packed words", ops.pack_bits(rows))):
            args = (vparts, u, v, un, enc[:p].contiguous(), p)
            err = max_abs_err(ops.two_hop_best(*args),
                              ref.two_hop_best_ref(*args))
            check(err == 0, f"two_hop_best differs on {fmt} at P={p}: {err}")
            print(f"phase 2: two_hop_best == plain on {fmt} at P={p}, "
                  f"chunk {ce}", flush=True)


def random_words(torch, gen, n, w, dev):
    """(n, w) int32 words of random bits, bit 31 set in every fourth row."""
    words = torch.randint(-2**31, 2**31, (n, w), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    words[::4] |= torch.tensor(-2**31, dtype=torch.int32, device=dev)
    return words


def phase_bit_kernels(torch, ops, ref, n, dev, p_num, chunk):
    """Phase 2, the SPMD round's bit-packing kernels against their plain
    versions: the whole replica map at P and at a ragged 37, and the
    two-hop chunk shape; random words have bit 31 and pad bits set."""
    gen = torch.Generator(device=dev).manual_seed(13)
    for p, rows in ((p_num, n), (37, n), (p_num, chunk)):
        w = ref.replica_words(p)
        bools = torch.rand((rows, p), generator=gen, device=dev) < 0.3
        bools[::2, min(31, p - 1)] = True
        got = ops.pack_bits(bools)
        err = max_abs_err(got, ref.pack_bits_ref(bools))
        check(err == 0, f"pack_bits differs at ({rows}, {p}): {err}")
        words = random_words(torch, gen, rows, w, dev)
        err = max(max_abs_err(ops.unpack_bits(words, p),
                              ref.unpack_bits_ref(words, p)),
                  max_abs_err(ops.unpack_bits(got, p), bools))
        check(err == 0, f"unpack_bits differs at ({rows}, {w}): {err}")
        other = random_words(torch, gen, rows, w, dev)
        err = max_abs_err(ops.or_words(words, other),
                          ref.or_words_ref(words, other))
        check(err == 0, f"or_words differs at ({rows}, {w}): {err}")
        print(f"phase 2: pack_bits ({ops.pack_bits_route(bools)} route), "
              f"unpack_bits, or_words == plain at N={rows}, P={p}, W={w}",
              flush=True)
    # pack_bits at each route: N·W not a multiple of a vector block's
    # 1,024 words, flag bytes other than 0 and 1 (a uint8 map as bool)
    rows = (1 << 20) + 3
    for p, offset, route in ((32, 0, "vector"), (64, 0, "vector"),
                             (96, 0, "vector"), (128, 0, "vector"),
                             (37, 0, "ballot"), (64, 1, "ballot")):
        raw = torch.randint(0, 4, (rows * p + offset,), generator=gen,
                            device=dev, dtype=torch.uint8)
        raw[offset::37] = 0x80
        bools = raw[offset:].view(torch.bool).view(rows, p)
        got_route = ops.pack_bits_route(bools)
        check(got_route == route, f"pack_bits at P={p}, offset {offset}: "
              f"{got_route} route, want {route}")
        err = max_abs_err(ops.pack_bits(bools),
                          ref.pack_bits_ref(raw[offset:].view(rows, p) != 0))
        check(err == 0, f"pack_bits ({route}) differs at ({rows}, {p}), "
              f"offset {offset}: {err}")
        print(f"phase 2: pack_bits == plain on the {route} route at N={rows}, "
              f"P={p}, map {offset} B off 16-byte alignment", flush=True)
    # unpack_bits at each route: 2·N·W not a multiple of a vector block's
    # 2,048 halves, bit 31 and pad bits set
    for p, route in ((32, "vector"), (64, "vector"), (96, "vector"),
                     (128, "vector"), (37, "generic"), (48, "generic")):
        words = random_words(torch, gen, rows, ref.replica_words(p), dev)
        got_route = ops.unpack_bits_route(words, p)
        check(got_route == route, f"unpack_bits at P={p}: {got_route} "
              f"route, want {route}")
        got = ops.unpack_bits(words, p)
        err = max_abs_err(got, ref.unpack_bits_ref(words, p))
        check(err == 0, f"unpack_bits ({route}) differs at ({rows}, {p}): "
              f"{err}")
        check(torch.equal(ops.unpack_bits(words, p), got),
              f"unpack_bits ({route}) differs from call to call at P={p}")
        print(f"phase 2: unpack_bits == plain on the {route} route at "
              f"N={rows}, P={p}, W={words.shape[1]}, the same bits call to "
              "call", flush=True)
    # or_words at each route: N·W % 4 == 2 (the vector route's tail
    # words); views one word off 16-byte alignment take the scalar route
    for offset, route in ((0, "vector"), (1, "scalar")):
        a, b = (random_words(torch, gen, rows * 2 + offset, 1, dev)
                .view(-1)[offset:].view(rows, 2) for _ in range(2))
        got_route = ops.or_words_route(a, b, torch.empty_like(a))
        check(got_route == route, f"or_words at offset {offset}: "
              f"{got_route} route, want {route}")
        got = ops.or_words(a, b)
        err = max_abs_err(got, ref.or_words_ref(a, b))
        check(err == 0, f"or_words ({route}) differs at ({rows}, 2): {err}")
        check(torch.equal(ops.or_words(a, b), got),
              f"or_words ({route}) differs from call to call")
        print(f"phase 2: or_words == plain on the {route} route at "
              f"({rows}, 2), operands {4 * offset} B off 16-byte alignment, "
              "the same bits call to call", flush=True)


def kernel_row(torch, name, kern, plain, lib, bound, reps, err):
    """One kernel's line entry: event times of the kernel, its plain
    version and the library call, the device time of the kernel's own
    kernels and of the library call's, and its bound ``(ms, by)``."""
    dev_ms, _ = device_ms(torch, kern, reps)
    return {
        "name": name, "route": "cuda", "source": CU_SOURCE,
        "replaces": REPLACES[name], "max_abs_err": err,
        "ms": time_ms(kern, reps), "device_ms": dev_ms,
        "plain_ms": time_ms(plain, max(1, reps // 4)),
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": None if lib is None else time_ms(lib, reps),
        "library_device_ms": None if lib is None
        else device_ms(torch, lib, reps)[0],
    }


def copy_device_ms(torch, nbytes, dev, reps) -> float:
    """Device ms of one torch ``copy_`` that reads ``nbytes / 2`` and
    writes ``nbytes / 2``: the rate the card streams a call's bytes at,
    the yardstick of a kernel bound by its bytes."""
    src = torch.ones(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return device_ms(torch, lambda: dst.copy_(src), reps)[0]


def two_hop_bound(un, ce, row_bytes, p_num):
    """(ms, 'bytes') of one two-hop chunk: u, v, the flag and best
    streamed, the enc vector, and two gathered rows for each unallocated
    edge (an allocated edge gathers nothing)."""
    return bound_ms(13 * ce + 4 * p_num
                    + 2 * row_bytes * int(un.sum())), "bytes"


def phase_spmd_times(torch, tp, sm, ops, ref, u, v, n, cfg, limit, state,
                     reps):
    """Phase 5, the bit-packing kernels on one real SPMD round's inputs
    (this rank's state after some rounds, its shard ``u``, ``v``): the
    replica delta that the round's one-hop allocation packs, the packed
    map it unpacks and merges into; and ``two_hop_best`` on packed words
    at its first two-hop chunk (returned apart, as keys of the
    two_hop_best entry)."""
    p_num = cfg.num_partitions
    from repro_torch import random as trandom

    _, sub = trandom.split(state.key)
    vclaim = tp.vertex_claims(cfg, limit, ops.unpack_bits(state.vparts, p_num),
                              state.degree_rest, state.edges_per_part, sub)
    part1, _ = ops.one_hop(vclaim, u, v, state.edge_part, p_num)
    delta = sm.replica_delta(part1 >= 0, part1, u, v, n, p_num)
    words = state.vparts
    packed = ops.pack_bits(delta)
    w = words.shape[1]
    rows = []
    for name, kern, plain, lib, nbytes in (
        ("pack_bits", lambda: ops.pack_bits(delta),
         lambda: ref.pack_bits_ref(delta), None, n * p_num + 4 * n * w),
        ("unpack_bits", lambda: ops.unpack_bits(words, p_num),
         lambda: ref.unpack_bits_ref(words, p_num), None,
         4 * n * w + n * p_num),
        ("or_words", lambda: ops.or_words(words, packed),
         lambda: ref.or_words_ref(words, packed),
         lambda: torch.bitwise_or(words, packed), 12 * n * w),
    ):
        err = max_abs_err(kern(), plain())
        check(err == 0, f"{name} differs on the captured SPMD round: {err}")
        rows.append(kernel_row(torch, name, kern, plain, lib,
                               (bound_ms(nbytes), "bytes"), reps, err))
        rows[-1]["copy_device_ms"] = copy_device_ms(torch, nbytes, u.device,
                                                    reps)
    rows[0]["pack_route"] = ops.pack_bits_route(delta)
    rows[1]["unpack_route"] = ops.unpack_bits_route(words, p_num)
    rows[2]["or_route"] = ops.or_words_route(words, packed,
                                             torch.empty_like(words))
    for r, key in zip(rows, ("pack_route", "unpack_route", "or_route")):
        print(f"phase 5: {r['name']} on the captured SPMD round's ({n}, "
              f"{p_num}) map: {r[key]} route, device_ms {r['device_ms']!r}, "
              f"bound {r['bound_ms']!r}, library device_ms "
              f"{r['library_device_ms']!r}, a copy_ of its bytes "
              f"{r['copy_device_ms']!r}", flush=True)
    # the first two-hop chunk of the next round, on this state's words
    ce = min(cfg.edge_chunk, u.shape[0])
    pid = torch.arange(p_num, dtype=torch.int32, device=u.device)
    enc = torch.where(state.edges_per_part <= limit,
                      tp.priority_enc(state.edges_per_part, pid, p_num),
                      torch.full_like(pid, ref.I32_INF))
    un = (state.edge_part < 0)[:ce].contiguous()
    args = (words, u[:ce], v[:ce], un, enc, p_num)
    err = max_abs_err(ops.two_hop_best(*args), ref.two_hop_best_ref(*args))
    check(err == 0, f"two_hop_best differs on the captured SPMD chunk: {err}")
    t = kernel_row(torch, "two_hop_best", lambda: ops.two_hop_best(*args),
                   lambda: ref.two_hop_best_ref(*args), None,
                   two_hop_bound(un, ce, 4 * w, p_num), reps, err)
    t["plain_device_ms"] = device_ms(torch, lambda: ref.two_hop_best_ref(
        *args), max(1, reps // 4))[0]
    words_keys = {k + "_words": t[k] for k in (
        "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
        "max_abs_err")}
    chunk_ms = time_ms(lambda: ops.unpack_bits(
        words[u[:ce].long()] & words[v[:ce].long()], p_num), reps)
    print(f"phase 5: SPMD round {int(state.rounds)}: {int(delta.sum())} "
          f"replica flags set by its one-hop; two_hop_best on packed words "
          f"at the chunk ({ce} edges, {int(un.sum())} unallocated): ms "
          f"{t['ms']!r} device_ms {t['device_ms']!r} bound_ms "
          f"{t['bound_ms']!r} plain_ms {t['plain_ms']!r} plain device_ms "
          f"{t['plain_device_ms']!r}; the "
          f"unpack_bits kernel on the chunk's AND alone: ms {chunk_ms!r}",
          flush=True)
    return rows, words_keys


def restart_rows(state, limit) -> int:
    """The rows of a round's selection that restart: an empty boundary
    on an active row while some vertex has D_rest > 0."""
    dr = state.degree_rest
    bnd = (state.vparts & (dr > 0)[:, None]).any(0)
    active = state.edges_per_part <= limit
    return int((~bnd & active).sum()) if bool((dr > 0).any()) else 0


def phase_times(torch, tp, ops, ref, g, cfg, limit, state, reps):
    """Phase 5: kernel, plain and library times on one real round's
    inputs (the state after some rounds of the main path's run), the
    restart draw at round 0's, and the round's layers at both."""
    n, m, p_num = g.num_vertices, g.num_edges, cfg.num_partitions
    from repro_torch import random as trandom

    dev = g.device
    state0 = tp.ne_init_state(g, cfg)

    def sel_args(st):
        _, sub = trandom.split(st.key)
        keys = trandom.fold_in(sub, torch.arange(p_num, device=dev))
        return (st.vparts.T, st.edges_per_part <= limit, st.degree_rest,
                cfg.lam, cfg.k_sel, keys,
                (limit - st.edges_per_part).to(torch.int32))

    args, args0 = sel_args(state), sel_args(state0)
    _, sub = trandom.split(state.key)
    claims = tp.vertex_claims(cfg, limit, state.vparts, state.degree_rest,
                              state.edges_per_part, sub)
    sel_idx, sel_valid = ops.select_chunk(*args)
    u = g.edges[:, 0].contiguous()
    v = g.edges[:, 1].contiguous()
    oh_args = (claims, u, v, state.edge_part, p_num)
    cs_args = (sel_idx, sel_valid, state.edges_per_part, n, p_num)
    ce = min(cfg.edge_chunk, m)
    pid = torch.arange(p_num, dtype=torch.int32, device=dev)
    enc = torch.where(state.edges_per_part <= limit,
                      tp.priority_enc(state.edges_per_part, pid, p_num),
                      torch.full_like(pid, ref.I32_INF))
    un = (state.edge_part < 0)[:ce].contiguous()
    th_args = (state.vparts, u[:ce], v[:ce], un, enc, p_num)

    # the library yardsticks, never used by the port: one PyTorch call each,
    # and for claim_scatter the fill and the scatter, as the kernel's call
    # fills its output before it scatters
    bnd = args[0] & (state.degree_rest > 0)[None, :] & args[1][:, None]
    comp = ((torch.where(bnd, state.degree_rest[None, :],
                         torch.full_like(state.degree_rest, ref.I32_INF))
             .to(torch.int64) << 32)
            | torch.arange(n, device=dev)[None, :])
    flat_v = torch.where(sel_valid, sel_idx,
                         torch.full_like(sel_idx, n)).reshape(-1).long()
    enc_k = ref._enc(state.edges_per_part[:, None], pid[:, None], p_num)
    enc_k = enc_k.expand(p_num, cfg.k_sel).reshape(-1)
    buf = torch.full((n + 1,), ref.I32_INF, dtype=torch.int32, device=dev)

    def select_bound(st):
        """bytes: D_rest, the 32-byte sectors of a vertex's P flag bytes
        where D_rest > 0 (the scan reads no other row), keys, active,
        remaining, the outputs; operations: a threefry draw a vertex with
        D_rest > 0 for each restart row."""
        n_pos = int((st.degree_rest > 0).sum())
        by = bound_ms(-(-p_num // 32) * 32 * n_pos + 4 * n + 21 * p_num
                      + 5 * p_num * cfg.k_sel)
        ops_ms = draw_bound_ms(restart_rows(st, limit) * n_pos)
        return (ops_ms, "operations") if ops_ms > by else (by, "bytes")

    rows = []
    for name, kern, plain, lib, bound in (
        ("one_hop", lambda: ops.one_hop(*oh_args),
         lambda: ref.one_hop_ref(*oh_args), None,
         (bound_ms(16 * m + 4 * n + 4 * p_num), "bytes")),
        ("select", lambda: ops.select_chunk(*args),
         lambda: ref.select_chunk_ref(*args),
         lambda: torch.topk(comp, cfg.k_sel, dim=1, largest=False),
         select_bound(state)),
        ("claim_scatter", lambda: ops.claim_scatter(*cs_args),
         lambda: ref.claim_scatter_ref(*cs_args),
         lambda: buf.fill_(ref.I32_INF).scatter_reduce_(
             0, flat_v, enc_k, reduce="amin"),
         (bound_ms(5 * p_num * cfg.k_sel + 4 * p_num + 4 * n), "bytes")),
        ("two_hop_best", lambda: ops.two_hop_best(*th_args),
         lambda: ref.two_hop_best_ref(*th_args), None,
         two_hop_bound(un, ce, p_num, p_num)),
    ):
        got, want = kern(), plain()
        err = (select_err(got, want) if name == "select"
               else max(max_abs_err(a, b) for a, b in zip(
                   got if isinstance(got, tuple) else (got,),
                   want if isinstance(want, tuple) else (want,))))
        check(err == 0, f"{name} differs on the captured round: {err}")
        rows.append(kernel_row(torch, name, kern, plain, lib, bound, reps,
                               err))
        if name == "two_hop_best":
            rows[-1]["plain_device_ms"] = device_ms(torch, plain,
                                                    max(1, reps // 4))[0]
        if name == "claim_scatter":
            _, kernels = device_ms(torch, kern, reps)
            check(kernels == 1, f"claim_scatter ran {kernels} kernels a "
                  "call, not 1")
            rows[-1]["cuda_launches_per_call"] = kernels
    print(f"phase 5: timed on round {int(state.rounds)}'s inputs (boundary "
          f"|B| = {int(bnd.sum())} over {p_num} rows, "
          f"{int((state.degree_rest > 0).sum())} vertices with D_rest > 0; "
          f"two-hop chunk of {ce} edges, {int(un.sum())} unallocated)",
          flush=True)
    per = device_kernels(torch, lambda: ops.select_chunk(*args), reps)
    print("phase 5: select_chunk device ms a call by kernel: " + ", ".join(
        f"{name.split('(')[0]} x{k} {t!r}" for name, (t, k) in per.items()),
        flush=True)

    # the restart draw at round 0, where every row restarts: its own
    # kernel's device time inside a select_chunk call
    got0 = ops.select_chunk(*args0)[0][:, 0]
    rnd0 = torch.cat([ref.boundary_reseed(state0.degree_rest,
                                          args0[5][j:j + ref.REF_ROWS])[0]
                      for j in range(0, p_num, ref.REF_ROWS)])
    err = max_abs_err(got0, rnd0)
    check(err == 0, f"the restart draw differs at round 0: {err}")
    per0 = device_kernels(torch, lambda: ops.select_chunk(*args0), reps)
    draw_ms = kernel_ms(per0, "restart_draw_kernel")
    check(draw_ms > 0, "no restart_draw_kernel device time at round 0")
    n_pos = int((state0.degree_rest > 0).sum())
    draw_bound = max((draw_bound_ms(p_num * n_pos), "operations"),
                     (bound_ms(4 * n + 16 * p_num), "bytes"))
    rows.append({
        "name": "restart_draw", "route": "cuda", "source": CU_SOURCE,
        "replaces": REPLACES["restart_draw"], "max_abs_err": err,
        "ms": draw_ms, "device_ms": draw_ms,
        "plain_ms": time_ms(lambda: [
            ref.boundary_reseed(state0.degree_rest,
                                args0[5][j:j + ref.REF_ROWS])
            for j in range(0, p_num, ref.REF_ROWS)], 3, warmup=1),
        "bound_ms": draw_bound[0], "bound_by": draw_bound[1],
        "library_ms": None,
        "library_device_ms": None, "timed_at_round": 0,
        "select_device_ms_round0": sum(t for t, _ in per0.values()),
    })
    print(f"phase 5: restart draw at round 0 ({p_num} rows restart, "
          f"{n_pos} vertices with D_rest > 0): device ms {draw_ms!r} of "
          f"select_chunk's {rows[-1]['select_device_ms_round0']!r}; bound "
          f"{rows[-1]['bound_ms']!r} ({rows[-1]['bound_by']}); plain "
          f"(boundary_reseed over {p_num} rows) {rows[-1]['plain_ms']!r} ms",
          flush=True)

    # the round's layers, each as the round runs it, at round 0 and at the
    # timed round, with the rows the draw ran (counted on the device)
    for label, st in (("round 0", state0),
                      (f"round {int(state.rounds)}", state)):
        _, sub = trandom.split(st.key)

        def claims_fn(st=st, sub=sub):
            return tp.vertex_claims(cfg, limit, st.vparts, st.degree_rest,
                                    st.edges_per_part, sub)

        def hop_fn(st=st):
            return tp._two_hop(u, v, st.edge_part, st.vparts,
                               st.edges_per_part, cfg, limit)

        drawn = ops.rows_drawn(dev)
        claims_fn()
        drawn = ops.rows_drawn(dev) - drawn
        want = restart_rows(st, limit)
        check(drawn == want, f"{label}: the draw ran for {drawn} rows, "
              f"{want} restart")
        per = device_kernels(torch, claims_fn, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        claims_fn()                      # no sync inside: host dispatch time
        host_ms = (time.perf_counter() - t0) * 1e3
        spent = {
            "vertex_claims_host_dispatch": host_ms,
            "restart_draw_device": kernel_ms(per, "restart_draw_kernel"),
            "vertex_claims_device": sum(t for t, _ in per.values()),
            "vertex_claims": time_ms(claims_fn, 3, warmup=1),
            "two_hop": time_ms(hop_fn, 3, warmup=1),
        }
        # the two-hop layer's device time: two_hop_best's kernel and the
        # rest of the chunk loop (candidates, exclusive_rank, quota)
        hop = device_kernels(torch, hop_fn, 1)
        spent["two_hop_device"] = sum(t for t, _ in hop.values())
        spent["two_hop_best_device"] = kernel_ms(hop, "two_hop_kernel")
        chunks = -(-m // ce)
        best = spent["two_hop_best_device"]
        rest = spent["two_hop_device"] - best
        print(f"phase 5: {label}: rows drawn {drawn} (restart rows {want}); "
              "layer ms per round: " + ", ".join(
                  f"{k}={t!r}" for k, t in spent.items())
              + f"; a two-hop chunk ({chunks} a round): two_hop_best "
              f"{best / chunks!r}, the rest {rest / chunks!r} device ms",
              flush=True)
    return rows


def profile_round(torch, label, round_fn, top: int = 12, host_top: int = 0):
    """One round or step (``round_fn()``) under torch.profiler: device
    time by kernel, the device's busy share of its wall time and, with
    ``host_top``, the host operators by their own host time; returns the
    profiler's device rows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        round_fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows)
    print(f"{label}: wall {wall_us:.0f}"
          f" us, device busy {busy:.0f} us ({100 * busy / wall_us:.1f}%)",
          flush=True)
    for e in rows[:top]:
        print(f"  {e.self_device_time_total:12.0f} us  {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    if host_top:
        print(f"{label}: host time by operator (self): "
              f"{sum(e.self_cpu_time_total for e in host):.0f} us", flush=True)
    for e in host[:host_top]:
        print(f"  {e.self_cpu_time_total:12.0f} us  {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)
    return rows


def spmm_close(ref, got, want, cols, blocks, x):
    """(max |got - want|, whether every entry is within 1e-5 * (|A| @ |x|)
    + 1e-6): A's entries are small integers, so only the order of the
    float32 sums differs between the kernel and its plain version."""
    scale = ref.block_spmm_ref(cols, blocks.abs(), x.abs())
    err = (got - want).abs()
    return float(err.max()), bool((err <= 1e-5 * scale + 1e-6).all())


def spmm_bound(r, nb, bm, bn, f, x_rows, products=1, flops=FP32_FLOPS):
    """(bound ms, what bounds it) of one block_spmm call: ``products`` x 2
    R NB bm bn F operations at ``flops`` (FP32 on the CUDA cores; the
    tensor-core kernel's three TF32 products at the TF32 rate), or the
    bytes of blocks, x, out and cols at the memory rate, whichever takes
    longer."""
    ops_ms = products * 2 * r * nb * bm * bn * f / flops * 1e3
    bytes_ms = bound_ms(4 * (r * nb * bm * bn + x_rows * f + r * bm * f
                             + r * nb))
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def gnn_data(np, shape, seed):
    """The GNN cell's graph (Erdos-Renyi of Cora's size), features (binary
    bag-of-words at Cora's density, 18 words of 1,433 a paper), labels (a
    random linear rule, as examples/train_gnn_partitioned.py makes them)
    and label mask (every vertex with an edge)."""
    from repro_torch.graphs.generators import erdos_renyi

    n = shape["n_nodes"]
    edges = erdos_renyi(n, ER_DEGREE, seed, device="cpu").edges.numpy()
    rng = np.random.default_rng(seed)
    feats = (rng.random((n, shape["d_feat"])) < 18 / 1433).astype(np.float32)
    w_true = rng.normal(size=(shape["d_feat"], shape["n_classes"]))
    labels = (feats @ w_true).argmax(1).astype(np.int32)
    label_mask = np.bincount(edges.ravel(), minlength=n) > 0
    return edges, feats, labels, label_mask


def phase_spmm_checks(torch, spmm, sref, a, local, r_mirrors, d_feat, dev):
    """Phase 6, check 1: block_spmm against its plain version on the card,
    forward and backward, on the main path's mirror block-CSR (128 x 128
    blocks: the tensor-core kernel) at layer 1's F and at d_hidden 64, and
    on 16 x 16 blocks of the same adjacency (the FMA kernel), each forward
    bit for bit from call to call.  Returns the largest error."""
    gen = torch.Generator(device=dev).manual_seed(14)
    csr16 = spmm.build_block_csr(local, r_mirrors, 16, 16)
    cases = [(128, a["cols"], a["blocks"], a["symmetric"], d_feat),
             (128, a["cols"], a["blocks"], a["symmetric"], 64),
             (16, torch.from_numpy(csr16[0]).to(dev),
              torch.from_numpy(csr16[1]).to(dev), csr16.symmetric, 64)]
    worst = 0.0
    for b, cols, blocks, symmetric, f in cases:
        rows = cols.shape[0] * b
        x = torch.randn((rows, f), generator=gen, device=dev)
        g = torch.randn((rows, f), generator=gen, device=dev)
        xg = x.clone().requires_grad_()
        out = spmm.block_spmm(cols, blocks, xg, symmetric)
        out.backward(g)
        again = spmm.block_spmm(cols, blocks, x)
        torch.cuda.synchronize()
        check(torch.equal(out.detach().view(torch.int32),
                          again.view(torch.int32)),
              f"block_spmm at {b}x{b} blocks, F={f}: two calls differ")
        for what, got, xx in (("forward", out.detach(), x),
                              ("backward", xg.grad, g)):
            err, ok = spmm_close(sref, got,
                                 sref.block_spmm_ref(cols, blocks, xx),
                                 cols, blocks, xx)
            check(ok, f"block_spmm {what} differs from plain at {b}x{b} "
                  f"blocks, F={f}: max abs err {err!r}")
            worst = max(worst, err)
        print(f"phase 6: block_spmm ({spmm.design(b, b)} kernel) == plain "
              f"(forward and backward) at {b}x{b} blocks, R={cols.shape[0]}, "
              f"NB={cols.shape[1]}, F={f}; tolerance 1e-5*(|A|@|x|)+1e-6; "
              "the same bits from call to call", flush=True)
    return worst


def relu_tape(torch, replay=None):
    """A torch function mode that records, in call order and on the host,
    the input of every ``torch.relu`` run under it.  Given ``replay``
    (another run's record) each call keeps the units that run kept, so both
    runs take the same side of every ReLU kink."""
    from torch.overrides import TorchFunctionMode

    class Tape(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.inputs = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is not torch.relu:
                return func(*args, **(kwargs or {}))
            z = args[0]
            self.inputs.append(z.detach().cpu())
            if replay is None:
                return func(z)
            on = replay[len(self.inputs) - 1].to(z.device) > 0
            return torch.where(on, z, torch.zeros_like(z))

    return Tape()


def name_units(zs, per, units):
    """'forward f, layer l <where>, master row r, channel c' for each
    (call, row, channel) of a run's ReLU record (``per`` calls a forward:
    each layer's MLP hidden units, then its output)."""
    return [f"forward {k // per} layer {k % per // 2 + 1} "
            f"{'MLP hidden' if k % 2 == 0 else 'output'}, master row {r}, "
            f"channel {c}: {float(zs[k][r, c])!r} of max "
            f"{float(zs[k].abs().max())!r}" for k, r, c in units]


def phase_gnn_card_vs_cpu(torch, np, compat, ge, gin, opt, data, cfg, p0,
                          ocfg, dev):
    """Phase 6, check 2: step 1's gradients and CHECK_STEPS steps of
    ``train_engine_gin`` on the card (kernel, NCCL) and on the CPU (plain
    versions, gloo), from the same parameters.  The CPU run takes the
    card's side of every ReLU kink (``relu_tape``); the units where its
    own side differs are named."""
    from repro_torch.apps import engine as eng
    from repro_torch.tree import tree_leaves

    edges, feats, labels, label_mask = data
    n = feats.shape[0]
    part = np.zeros(len(edges), np.int32)
    sg = eng.build_sharded_graph(edges, part, n, 1)
    caps = ge.caps_from_sharded_graph(sg, feats.shape[1], cfg.n_classes)
    runs, replay = {}, None
    for name, backend, device in (("card", "nccl", dev),
                                  ("CPU", "gloo", torch.device("cpu"))):
        tape = relu_tape(torch, replay)
        with compat.world1(backend), tape:
            model = gin.params_from_numpy(gin.GIN(cfg), p0).to(device)
            a = ge.engine_arrays(sg, feats, labels, label_mask, 0, device)
            ge.loss_and_grads(model, a, caps)
            grads = [p.grad.cpu().numpy() for p in
                     tree_leaves(model.param_tree())]
            model = gin.params_from_numpy(gin.GIN(cfg), p0)
            losses = ge.train_engine_gin(edges, part, n, feats, labels,
                                         label_mask, model, ocfg,
                                         CHECK_STEPS, device=device)
        runs[name] = (grads, losses,
                      tree_leaves(gin.params_to_numpy(model)), tape.inputs)
        replay = tape.inputs
    (g_c, l_c, p_c, z_c), (g_h, l_h, p_h, z_h) = runs["card"], runs["CPU"]
    check(len(z_c) == len(z_h) and len(z_c) % (CHECK_STEPS + 1) == 0,
          f"ReLU calls: card {len(z_c)}, CPU {len(z_h)}")
    per = len(z_c) // (CHECK_STEPS + 1)         # ReLU calls of a forward
    # The units where the CPU's own side of the kink is not the card's,
    # and step 1's units nearest the kink (its first two forwards, the
    # gradient pass and train_engine_gin's step 1, share the parameters).
    flips = [(k, int(r), int(c)) for k in range(len(z_c))
             for r, c in torch.nonzero((z_c[k] > 0) != (z_h[k] > 0))]
    near = []
    for k in range(2 * per):
        z = z_c[k].abs()
        z = torch.where(z == 0, torch.inf, z)       # exact zeros are not
        r, c = divmod(int(z.argmin()), z.shape[1])  # rounded either way
        near.append((float(z[r, c] / z_c[k].abs().max()), k, r, c))
    near = sorted(near)[:3]
    print(f"phase 6: card vs CPU: {per} ReLU calls a forward; {len(flips)} "
          f"units where the CPU alone would take the other side of the "
          f"kink: {name_units(z_c, per, flips[:6])}; CPU values "
          f"{[float(z_h[k][r, c]) for k, r, c in flips[:6]]}; step 1's "
          f"units nearest the kink on the card: "
          f"{name_units(z_c, per, [u[1:] for u in near])}", flush=True)
    # Step 1 runs both from the same parameters and takes the same side of
    # every kink, so the two differ only by float32 sums in other orders
    # (the kernel against torch.einsum, cuBLAS against the CPU's matmul,
    # dot products up to 1,433 long through 5 layers): ~1e-7 relative in
    # a run with no flip (PERF.md §6); 1e-5 for every ReLU input of step 1,
    # each loss and each leaf of step 1's gradients.  Steps 2-3 start from
    # parameters that agree as closely, except where AdamW's first step,
    # lr * g / |g|, takes a step-1 gradient element whose sign float32
    # does not settle (0 < |g| <= 1e-5 of its leaf's max): such an element
    # may move either way, by at most 2 x the summed learning rates.  Every
    # other parameter agrees to 1e-5 (~1e-7 measured).
    z_err = max(float((a - b).abs().max() / max(b.abs().max(), 1e-30))
                for a, b in zip(z_c[:2 * per], z_h[:2 * per]))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_c, l_h))
    grad_err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                   for a, b in zip(g_c, g_h))
    lr_sum = sum(float(opt.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))
                 for s in range(1, CHECK_STEPS + 1))
    loose = [(g != 0) & (np.abs(g) <= 1e-5 * np.abs(g).max()) for g in g_c]
    param_err = max(float(np.abs(a - b)[~m].max(initial=0.0))
                    for a, b, m in zip(p_c, p_h, loose))
    loose_err = max(float(np.abs(a - b)[m].max(initial=0.0))
                    for a, b, m in zip(p_c, p_h, loose))
    print(f"phase 6: card vs CPU over {CHECK_STEPS} steps: losses card "
          f"{l_c} CPU {l_h}, max rel err {loss_err!r} (tol 1e-5); step-1 "
          f"ReLU inputs max err / call max {z_err!r} (tol 1e-5); step-1 "
          f"gradients max err / leaf max {grad_err!r} (tol 1e-5); params "
          f"max abs err {param_err!r} (tol 1e-5), {sum(int(m.sum()) for m in loose)} "
          f"elements with a step-1 gradient in (0, 1e-5] of its leaf max: max abs err "
          f"{loose_err!r} (tol {2.01 * lr_sum!r})", flush=True)
    check(loss_err <= 1e-5, f"card and CPU losses differ: {l_c} vs {l_h}")
    check(z_err <= 1e-5, f"card and CPU ReLU inputs differ: {z_err}")
    check(grad_err <= 1e-5, f"card and CPU gradients differ: {grad_err}")
    check(param_err <= 1e-5 and loose_err <= 2.01 * lr_sum,
          f"card and CPU parameters differ by {param_err}, {loose_err}")


def library_spmm(torch, cols, blocks, x):
    """The library yardstick for block_spmm: ``torch.sparse.mm`` of a BSR
    tensor of the nonzero blocks, or a dense matmul of the (N_pad, N_pad)
    adjacency where torch refuses BSR on the card.  Returns (call, name).
    The port never calls either."""
    r, nb, bm, bn = blocks.shape
    real = blocks.sum((2, 3)) != 0          # real slots lead each row
    crow = torch.zeros(r + 1, dtype=torch.int64, device=x.device)
    crow[1:] = real.sum(1).cumsum(0)
    bsr = torch.sparse_bsr_tensor(crow, cols[real].long(), blocks[real],
                                  size=(r * bm, x.shape[0]))
    try:
        torch.sparse.mm(bsr, x)
        torch.cuda.synchronize()
        return (lambda: torch.sparse.mm(bsr, x)), "torch.sparse.mm(BSR)"
    except (RuntimeError, NotImplementedError) as e:
        print(f"phase 6: torch refuses BSR @ dense on the card "
              f"({str(e).splitlines()[0][:120]}); library = dense matmul",
              flush=True)
    dense = bsr.to_dense()
    return (lambda: dense @ x), "torch.matmul(dense adjacency)"


def fma_spmm(torch, spmm, cols, blocks, x):
    """A call of the FMA kernel (the first design, which the wrapper runs
    for small blocks) on the tensor-core kernel's shapes, for comparison:
    ``block_spmm_fma`` into a fresh output.  Never called by the port at
    these shapes."""
    r, nb, bm, bn = blocks.shape

    def call():
        out = torch.empty((r * bm, x.shape[1]), device=x.device)
        err = spmm._lib().block_spmm_fma(
            cols.data_ptr(), blocks.data_ptr(), x.data_ptr(), r, nb, bm, bn,
            x.shape[0], x.shape[1], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"block_spmm_fma failed with cudaError_t {err}")
        return out
    return call


def no_tf32(torch, label: str) -> None:
    """Full float32 matmuls and convolutions for a card-against-CPU check,
    and a line that says so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{label}: allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)


def phase_gnn(torch, np, compat, ne_ops, args):
    """Phase 6: the GNN cell.  Returns block_spmm's row of the kernels
    line."""
    from repro_torch.apps import engine as eng
    from repro_torch.configs import gin_tu
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.kernels import build
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.block_spmm import ref as sref
    from repro_torch.launch import gnn_engine as ge
    from repro_torch.models.gnn import gin
    from repro_torch.train import optimizer as opt

    dev = torch.device("cuda")
    no_tf32(torch, "phase 6")
    shape = GNN_SHAPES[GNN_SHAPE]
    data = gnn_data(np, shape, seed=0)
    edges, feats, labels, label_mask = data
    n, m = feats.shape[0], len(edges)
    check(abs(m / shape["n_edges"] - 1) <= 0.02,
          f"{m} edges, not within 2 % of {shape['n_edges']}")
    cfg = dataclasses.replace(gin_tu.CONFIG, d_feat=shape["d_feat"],
                              n_classes=shape["n_classes"])
    p0 = gin.params_to_numpy(gin.GIN(cfg, torch.Generator().manual_seed(0)))
    ocfg = opt.OptConfig(total_steps=GNN_STEPS, **GNN_OPT)
    sg = eng.build_sharded_graph(edges, np.zeros(m, np.int32), n, 1)
    caps = ge.caps_from_sharded_graph(sg, shape["d_feat"], cfg.n_classes)
    a = ge.engine_arrays(sg, feats, labels, label_mask, 0, dev)
    cols, blocks = a["cols"], a["blocks"]
    r, nb, bm, bn = blocks.shape
    local = sg.edges_ml[0][sg.emask[0]]
    tiles = int((blocks != 0).any(3).any(2).sum())
    print(f"phase 6: {cfg.name} L={cfg.n_layers} d_hidden={cfg.d_hidden} on "
          f"{GNN_SHAPE}: N={n} E={m} d_feat={shape['d_feat']} "
          f"classes={shape['n_classes']}; mirrors R={caps.r_mirrors}; "
          f"block-CSR {r}x{nb} slots of {bm}x{bn}: {tiles} nonzero tiles "
          f"of {r * nb}, blocks {blocks.nbytes} B + cols {cols.nbytes} B",
          flush=True)

    ptxas_report(build, "block_spmm",
                 ("spmm_tc_kernel", "spmm_reduce_kernel", "spmm_kernel"),
                 "phase 6")
    tool = cuobjdump()
    if tool is None:
        print("phase 6: spmm_tc_kernel instructions: no cuobjdump found, "
              "not counted", flush=True)
    else:
        hmma = sass_counts(tool, build, "block_spmm", "spmm_tc_kernel",
                           ("HMMA", "HGMMA"))
        print(f"phase 6: spmm_tc_kernel instructions ({tool} -sass): "
              f"{hmma}", flush=True)
        check(bool(hmma) and all(c["HMMA"] > 0 for c in hmma.values()),
              f"spmm_tc_kernel without HMMA instructions: {hmma}")
    worst = phase_spmm_checks(torch, spmm, sref, a, local, caps.r_mirrors,
                              shape["d_feat"], dev)
    phase_gnn_card_vs_cpu(torch, np, compat, ge, gin, opt, data, cfg, p0,
                          ocfg, dev)

    # --- the main path: train_engine_gin, counts 0 just before ------------
    with compat.world1("nccl"):
        model = gin.params_from_numpy(gin.GIN(cfg), p0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ne_ops.reset_launches()
        spmm.reset_launches()
        t0 = time.perf_counter()
        losses = ge.train_engine_gin(edges, np.zeros(m, np.int32), n, feats,
                                     labels, label_mask, model, ocfg,
                                     GNN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = spmm.launches["block_spmm"]
        ne_launches = dict(ne_ops.launches)
        peak = torch.cuda.max_memory_allocated() - base
        # steady steps, then one under the profiler
        state = opt.init(model.param_tree(), ocfg)
        for _ in range(2):
            ge.train_step(model, a, caps, state, ocfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            _, state = ge.train_step(model, a, caps, state, ocfg)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / args.reps
        prof = profile_round(torch, "phase 6: profiled training step",
                             lambda: ge.train_step(model, a, caps, state,
                                                   ocfg), host_top=12)
    want = GNN_STEPS * (2 * cfg.n_layers - 1)
    busy = sum(e.self_device_time_total for e in prof)
    spmm_us = sum(e.self_device_time_total for e in prof
                  if "spmm_" in e.key)
    print(f"phase 6: train_engine_gin {GNN_STEPS} steps: losses {losses}; "
          f"wall {wall!r} s (host build included); steady step "
          f"{step_s!r} s; peak device memory {peak} B above the "
          f"{base} B held before; block_spmm launches {launches} "
          f"(want {want} = {GNN_STEPS} x (2L - 1)); block_spmm "
          f"{spmm_us:.0f} of {busy:.0f} us device time of a step "
          f"({100 * spmm_us / max(busy, 1):.1f}%)", flush=True)
    check(len(losses) == GNN_STEPS and all(np.isfinite(losses)),
          f"losses {losses}")
    check(launches == want, f"block_spmm launched {launches} times, "
          f"not {want}")
    check(not any(ne_launches.values()),
          f"NE-round kernels ran in the GNN phase: {ne_launches}")

    # --- the kernel's times on the main path's block-CSR ------------------
    gen = torch.Generator(device=dev).manual_seed(15)
    row = {"name": "block_spmm", "route": "cuda", "source": SPMM_SOURCE,
           "replaces": REPLACES["block_spmm"], "launches": launches,
           "launches_per_step": 2 * cfg.n_layers - 1, "max_abs_err": worst}
    for f, tag in ((shape["d_feat"], ""), (cfg.d_hidden, "_f64")):
        x = torch.randn((r * bm, f), generator=gen, device=dev)
        lib, lib_name = library_spmm(torch, cols, blocks, x)
        err, ok = spmm_close(sref, lib(), sref.block_spmm_ref(cols, blocks, x),
                             cols, blocks, x)
        check(ok, f"the library yardstick {lib_name} differs: {err}")
        bound, by = spmm_bound(r, nb, bm, bn, f, x.shape[0])
        bound_tc, by_tc = spmm_bound(r, nb, bm, bn, f, x.shape[0], 3,
                                     TF32_FLOPS)
        kern = lambda: spmm.block_spmm(cols, blocks, x)    # noqa: E731
        dev_ms, kernels = device_ms(torch, kern, args.reps)
        lib_dev_ms, _ = device_ms(torch, lib, args.reps)
        fma = fma_spmm(torch, spmm, cols, blocks, x)
        err, ok = spmm_close(sref, fma(), sref.block_spmm_ref(cols, blocks, x),
                             cols, blocks, x)
        check(ok, f"the FMA kernel differs at F={f}: {err}")
        row.update({
            "design" + tag: spmm.design(bm, bn),
            "ms" + tag: time_ms(kern, args.reps),
            "device_ms" + tag: dev_ms,
            "cuda_launches_per_call" + tag: kernels,
            "plain_ms" + tag: time_ms(
                lambda: sref.block_spmm_ref(cols, blocks, x),
                max(1, args.reps // 4)),
            "bound_ms" + tag: bound, "bound_by" + tag: by,
            "bound_tc_ms" + tag: bound_tc, "bound_tc_by" + tag: by_tc,
            "library_ms" + tag: time_ms(lib, args.reps),
            "library_device_ms" + tag: lib_dev_ms,
            "fma_ms" + tag: time_ms(fma, args.reps),
            "fma_device_ms" + tag: device_ms(torch, fma, args.reps)[0],
            "library_call" + tag: lib_name, "F" + tag: f})
    print(f"phase 6: block_spmm times (F={shape['d_feat']} / F=64, "
          f"{row['design']} / {row['design_f64']} kernel): ms "
          f"{row['ms']!r} / {row['ms_f64']!r}, device_ms "
          f"{row['device_ms']!r} / {row['device_ms_f64']!r} "
          f"(profiler; {row['cuda_launches_per_call']} / "
          f"{row['cuda_launches_per_call_f64']} kernels a call), FP32 bound "
          f"{row['bound_ms']!r} / {row['bound_ms_f64']!r} "
          f"({row['bound_by']} / {row['bound_by_f64']}), 3xTF32 bound "
          f"{row['bound_tc_ms']!r} / {row['bound_tc_ms_f64']!r}, plain "
          f"{row['plain_ms']!r} / {row['plain_ms_f64']!r}, library "
          f"{row['library_ms']!r} / {row['library_ms_f64']!r}, library "
          f"device_ms {row['library_device_ms']!r} / "
          f"{row['library_device_ms_f64']!r} ({row['library_call']}); the "
          f"FMA kernel at the same shapes: ms {row['fma_ms']!r} / "
          f"{row['fma_ms_f64']!r}, device_ms {row['fma_device_ms']!r} / "
          f"{row['fma_device_ms_f64']!r}", flush=True)
    return row


def all_counts():
    """Every kernel's launch count, by name."""
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ne_round import ops as ne
    from repro_torch.kernels.stream import ops as stream

    return {**ne.launches, **spmm.launches, **eb.launches, **fa.launches,
            **stream.launches}


def reset_counts() -> None:
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ne_round import ops as ne
    from repro_torch.kernels.stream import ops as stream

    for mod in (ne, spmm, eb, fa, stream):
        mod.reset_launches()


def check_counts(label: str, want: dict) -> dict:
    """The counts since ``reset_counts``: ``want``'s kernels at their
    numbers, every other kernel at 0."""
    got = all_counts()
    check(all(got[k] == want.get(k, 0) for k in got),
          f"{label}: launch counts {got}, want {want} and 0 elsewhere")
    return got


def within(got, want, rtol: float, atol: float):
    """(max |got - want|, whether |got - want| <= atol + rtol |want|
    everywhere, NaN where both are NaN)."""
    g, w = got.float(), want.float()
    both_nan = g.isnan() & w.isnan()
    err = (g - w).abs().masked_fill(both_nan, 0)
    ok = bool(((err <= atol + rtol * w.abs()) | both_nan).all())
    return float(err.max()), ok


def plain_bag(ebref, table, ids, weights, mode):
    """The plain version of ``ops.embedding_bag`` on the same inputs."""
    import torch

    w = weights if weights is not None else torch.ones(
        ids.shape, device=ids.device)
    out = ebref.embedding_bag_ref(table, ids, w)
    if mode == "mean":
        out = out / torch.clamp(w.sum(1, keepdim=True), min=1e-9)
    return out


def bag_bound(b, k, d, size, weighted):
    """(bound ms, 'bytes') of one bag call: the rows, the ids (and the
    weights) and the output, each once."""
    return bound_ms(b * k * d * size + b * k * 4 * (1 + weighted)
                    + b * d * size), "bytes"


def bag_sector_bound(ids, d, size, weighted) -> float:
    """The bound in ms of one bag call with its rows counted as the 32-byte
    sectors they touch (a random row comes from device memory in whole
    sectors), exactly from these ids: Σ over slots of (⌊(id·D·s + D·s −
    1)/32⌋ − ⌊id·D·s/32⌋ + 1) × 32 for a table at a 32-byte aligned
    address, plus the ids, the weights and the output."""
    off = ids.long() * (d * size)
    sectors = int(((off + d * size - 1) // 32 - off // 32 + 1).sum())
    return bound_ms(32 * sectors + ids.numel() * 4 * (1 + weighted)
                    + ids.shape[0] * d * size)


def bag_bits_check(torch, eb, ebref, tab, i, weights, label) -> None:
    """The kernel's sum equals the in-order float32 sum bit for bit, with
    no weights or with 0/1 weights (exact products), and repeats its bits
    from call to call."""
    got = eb.embedding_bag(tab, i, weights)
    check(torch.equal(got, ebref.embedding_bag_inorder_ref(tab, i, weights)),
          f"embedding_bag at {label} is not the in-order sum bit for bit")
    check(torch.equal(eb.embedding_bag(tab, i, weights), got),
          f"embedding_bag at {label} changed its bits from call to call")


def bag_cut_sweep(torch, eb, tab, i, reps: int) -> dict:
    """{bags a block: ms by events} of the kernel on ``tab`` and ``i``
    (no weights) at the plan's G and at each of 1 .. 48 that fits 48 KB,
    its threads as the plan would give them, launched through the
    C entry point (these launches are not counted); and, under
    ``"index_select"``, torch's gather of the same rows with its (B·K, D)
    output: where the time stays flat over G and near the gather's, the
    calls sit on the card's rate of random reads, not on the kernel's
    loads in flight."""
    b, k = i.shape
    d = tab.shape[1]
    cut = eb.plan(b, k, d, tab.element_size(), False, tab.data_ptr())
    out = torch.empty((b, d), dtype=tab.dtype, device=tab.device)
    lib, stream = eb._lib(), torch.cuda.current_stream().cuda_stream
    times = {}
    for g in sorted({1, 2, 4, 8, 16, 27, 48, cut.g}):
        smem = g * k * 4 * (1 + d)
        if smem > eb.SMEM_BUDGET or g > b:
            continue
        threads = min(eb.THREADS, -(-g * k * (d // cut.vec) // 32) * 32)

        def run(g=g, smem=smem, threads=threads):
            err = lib.embedding_bag(tab.data_ptr(), eb._DTYPES[tab.dtype],
                                    i.data_ptr(), None, b, k, d, g, k, d,
                                    cut.vec, threads, smem, out.data_ptr(),
                                    stream)
            check(err == 0, f"embedding_bag at G={g}: cudaError_t {err}")
        times[g] = time_ms(run, reps)
    times["index_select"] = time_ms(
        lambda: tab.index_select(0, i.view(-1)), reps)
    return times


def phase_bag_routes(torch, eb, ebref, dev) -> None:
    """Phase 7, check 1b: the kernel's cuts beyond the serve shapes (one
    bag in tiles of slots, B = 1, B not a multiple of G; float32 and
    bf16, weighted with a tenth of the slots padding and not), each bit
    for bit the in-order sum and within 1e-6 + 1e-5·Σ|w·row| (+ 2^-7
    |plain| in bf16) of the plain version: 2,048-slot sums of random
    rows cancel to near 0, where a bound relative to the sum is no
    bound."""
    gen = torch.Generator(device=dev).manual_seed(73)
    for name, v, d, b, k in (("tiles of slots", 1 << 16, 64, 3, 2048),
                             ("B = 1", 1 << 20, 10, 1, 39),
                             ("B % G != 0", 1 << 20, 10, 1001, 39),
                             ("B % G != 0, w1", 1 << 20, 1, 1001, 39)):
        base = torch.randn((v, d), generator=gen, device=dev)
        i = torch.randint(0, v, (b, k), generator=gen, device=dev,
                          dtype=torch.int32)
        w = (torch.rand((b, k), generator=gen, device=dev) >= 0.1).float()
        cuts = set()
        for tab in (base, base.to(torch.bfloat16)):
            for weights in (None, w):
                cut = eb.plan(b, k, d, tab.element_size(),
                              weights is not None, tab.data_ptr())
                cuts.add(cut)
                label = f"{name} ({tab.dtype}, weighted={weights is not None})"
                bag_bits_check(torch, eb, ebref, tab, i, weights, label)
                got = eb.embedding_bag(tab, i, weights).float()
                want = plain_bag(ebref, tab, i, weights, "sum").float()
                terms = plain_bag(ebref, tab.float().abs(), i, weights,
                                  "sum")
                rtol = 2.0 ** -7 if tab.dtype == torch.bfloat16 else 0.0
                err = (got - want).abs()
                check(bool((err <= 1e-6 + 1e-5 * terms
                            + rtol * want.abs()).all()),
                      f"embedding_bag differs from plain at {label}: "
                      f"{float(err.max())!r}")
        if name == "tiles of slots":
            check(all(c.kt < k and c.g == 1 for c in cuts),
                  f"{name}: cuts {cuts} do not tile the slots")
        print(f"phase 7: embedding_bag == in-order sum bit for bit and "
              f"== plain at {name} (B={b}, K={k}, D={d}), float32 and "
              f"bf16, weighted and not; cuts (g, kt, dt, vec, threads, "
              f"smem) {sorted(tuple(c) for c in cuts)}", flush=True)


def phase_deepfm_kernel(torch, eb, ebref, model, ids):
    """Phase 7, check 1: the embedding_bag kernel against its plain version
    on the card at the serve shapes, for the table (D = 10) and w1 (D = 1),
    sum and mean, weighted (a tenth of the slots padding) and not, float32
    and bfloat16.  float32: 1e-6 + 1e-5 |plain| (sums in another order);
    bfloat16: 1e-6 + 2^-7 |plain| (one bf16 rounding of float32 sums that
    differ in the last bits may land one bf16 step apart).  Unweighted and
    with the 0/1 weights, each sum also equals the in-order float32 sum
    bit for bit, and repeats its bits.  Returns the largest float32
    error."""
    gen = torch.Generator(device=ids["serve_p99"].device).manual_seed(71)
    tables = {"table": model.table.detach(), "w1": model.w1.detach()}
    tables.update({f"{k} bf16": t.to(torch.bfloat16)
                   for k, t in list(tables.items())})
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for shape, i in ids.items():
        w = (torch.rand(i.shape, generator=gen, device=i.device)
             >= 0.1).float()
        for name, tab in tables.items():
            kind = "bfloat16" if tab.dtype == torch.bfloat16 else "float32"
            rtol = 2.0 ** -7 if kind == "bfloat16" else 1e-5
            for weights in (None, w):
                bag_bits_check(torch, eb, ebref, tab, i, weights,
                               f"{shape} {name}")
            for mode in ("sum", "mean"):
                for weights in (None, w):
                    got = eb.embedding_bag(tab, i, weights, mode)
                    torch.cuda.synchronize()
                    err, ok = within(got, plain_bag(ebref, tab, i, weights,
                                                    mode), rtol, 1e-6)
                    check(ok, f"embedding_bag differs from plain at "
                          f"{shape}, {name}, {mode}, weighted="
                          f"{weights is not None}: max abs err {err!r}")
                    worst[kind] = max(worst[kind], err)
        print(f"phase 7: embedding_bag == plain at {shape} (B={i.shape[0]}, "
              f"K={i.shape[1]}): table D=10 and w1 D=1, sum and mean, "
              f"weighted and not, float32 and bfloat16; the sums == the "
              f"in-order sum bit for bit, the same bits call to call",
              flush=True)
    print(f"phase 7: embedding_bag max abs err float32 "
          f"{worst['float32']!r} (tol 1e-6 + 1e-5|plain|), bfloat16 "
          f"{worst['bfloat16']!r} (tol 1e-6 + 2^-7|plain|)", flush=True)
    return worst["float32"]


def phase_deepfm(torch, args):
    """Phase 7: DeepFM serving at full width (deepfm: 39 fields of
    1,048,576 rows, D 10, MLP 400-400-400, 10^6 candidates, float32), with
    seeded random parameters made on the card and ids uniform over each
    field's rows.  Returns embedding_bag's row of the kernels line."""
    import copy

    from repro_torch.configs import deepfm as dcfg
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag import ref as ebref
    from repro_torch.launch import steps
    from repro_torch.models.recsys import deepfm as dfm

    dev = torch.device("cuda")
    cfg = dcfg.CONFIG
    no_tf32(torch, "phase 7")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = dfm.DeepFM(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.parameters())
    print(f"phase 7: {cfg.name}: {cfg.n_fields} fields x "
          f"{cfg.rows_per_field} rows, D={cfg.embed_dim}, MLP "
          f"{cfg.mlp_dims}, {cfg.n_candidates} candidates; {nparam} "
          f"float32 parameters made on the card in "
          f"{time.perf_counter() - t0!r} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(72)
    xs = {s: torch.randint(0, cfg.rows_per_field,
                           (RECSYS_SHAPES[s]["batch"], cfg.n_fields),
                           generator=gen, device=dev, dtype=torch.int32)
          for s in ("serve_p99", "serve_bulk")}
    ids = {s: dfm._field_ids(x, cfg) for s, x in xs.items()}
    worst = phase_deepfm_kernel(torch, eb, ebref, model, ids)
    phase_bag_routes(torch, eb, ebref, dev)

    # check 2: the card's forward against the CPU's on the same parameters
    cpu = copy.deepcopy(model).to("cpu")
    x = xs["serve_p99"]
    got = steps.recsys_serve_fn(model, x).cpu()
    want = steps.recsys_serve_fn(cpu, x.cpu())
    scale = float(want.abs().max())
    err, ok = within(got, want, 0.0, 1e-5 * scale)
    print(f"phase 7: forward card vs CPU at serve_p99: max abs err {err!r} "
          f"of max |logit| {scale!r} (tol 1e-5 x max: float32 sums in "
          f"another order)", flush=True)
    check(ok and bool(got.isfinite().all()),
          f"DeepFM forward differs between card and CPU: {err}")
    del cpu

    # --- the main path: counts 0 just before, read just after ------------
    out = {}
    for shape, x in xs.items():
        b = x.shape[0]
        steps.recsys_serve_fn(model, x)               # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            logits = steps.recsys_serve_fn(model, x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.reps
        counts = check_counts(f"phase 7 {shape}",
                              {"embedding_bag": 2 * args.reps})
        peak = torch.cuda.max_memory_allocated() - base
        check(logits.shape == (b,) and bool(logits.isfinite().all()),
              f"{shape}: logits {tuple(logits.shape)} not finite")
        out[shape] = counts["embedding_bag"]
        print(f"phase 7: {shape} B={b}: {wall * 1e3!r} ms a batch, "
              f"{b / wall!r} rows/s; peak {peak} B above the {base} B "
              f"held; embedding_bag launches {counts['embedding_bag']} = "
              f"2 x {args.reps} forwards", flush=True)
        profile_round(torch, f"phase 7: profiled {shape} forward",
                      lambda: steps.recsys_serve_fn(model, x), top=8,
                      host_top=6)
    q = xs["serve_p99"][:1]
    steps.retrieval_fn(model, q)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        scores = steps.retrieval_fn(model, q)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.reps
    check_counts("phase 7 retrieval_cand", {})
    check(scores.shape == (cfg.n_candidates,)
          and bool(scores.isfinite().all()), "retrieval scores")
    print(f"phase 7: retrieval_cand: {wall * 1e3!r} ms a query against "
          f"{cfg.n_candidates} candidates", flush=True)

    # --- the kernel's times at the forward's calls ------------------------
    fe = torch.nn.functional.embedding_bag
    row = {"name": "embedding_bag", "route": "cuda", "source": EB_SOURCE,
           "replaces": REPLACES["embedding_bag"],
           "launches": out["serve_bulk"],
           "launches_serve_p99": out["serve_p99"], "max_abs_err": worst}
    for shape, i in ids.items():
        b, k = i.shape
        ones = torch.ones(i.shape, device=dev)
        for name, tab in (("table", model.table.detach()),
                          ("w1", model.w1.detach())):
            d = tab.shape[1]
            lib_out = fe(i, tab, mode="sum")
            err, ok = within(lib_out, ebref.embedding_bag_ref(tab, i, ones),
                             1e-5, 1e-6)
            check(ok, f"F.embedding_bag differs from plain: {err}")
            bound, by = bag_bound(b, k, d, 4, False)
            tag = "" if (shape, name) == ("serve_bulk", "table") else \
                f"_{shape}_{name}"
            row.update({
                "sector_bound_ms" + tag: bag_sector_bound(i, d, 4, False),
                "plan" + tag: eb.plan(b, k, d, 4, False,
                                      tab.data_ptr())._asdict(),
                "ms" + tag: time_ms(lambda: eb.embedding_bag(tab, i),
                                    args.reps),
                "plain_ms" + tag: time_ms(
                    lambda: ebref.embedding_bag_ref(tab, i, ones),
                    args.reps),
                "bound_ms" + tag: bound, "bound_by" + tag: by,
                "library_ms" + tag: time_ms(lambda: fe(i, tab, mode="sum"),
                                            args.reps),
                "device_ms" + tag: device_ms(
                    torch, lambda: eb.embedding_bag(tab, i), args.reps)[0],
                "library_device_ms" + tag: device_ms(
                    torch, lambda: fe(i, tab, mode="sum"), args.reps)[0]})
            if shape == "serve_bulk":
                row["cut_sweep_ms" + tag] = bag_cut_sweep(torch, eb, tab, i,
                                                          args.reps)
                print(f"phase 7: embedding_bag at {shape} {name}, ms by "
                      f"events for G bags a block (and torch's gather): "
                      f"{row['cut_sweep_ms' + tag]}", flush=True)
            print(f"phase 7: embedding_bag at {shape} {name} (B={b}, K={k}, "
                  f"D={d}; cut {row['plan' + tag]}): ms {row['ms' + tag]!r}, "
                  f"device_ms {row['device_ms' + tag]!r}, bound "
                  f"{row['bound_ms' + tag]!r} (bytes), sector bound "
                  f"{row['sector_bound_ms' + tag]!r}, plain "
                  f"{row['plain_ms' + tag]!r}, F.embedding_bag "
                  f"{row['library_ms' + tag]!r} (device_ms "
                  f"{row['library_device_ms' + tag]!r})", flush=True)
    del model
    return row


def top2_margin(logits):
    """Each row's gap between its largest and second-largest logit."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def check_flash(torch, fa, faref, name, q, k, v, causal, kv_len,
                combines: int) -> float:
    """The flash kernel against its plain version on the card in bfloat16:
    both compute in float32 and round once to bf16, in different orders:
    1e-5 + 2^-7 |plain| (one bf16 step).  A second call must give the same
    bits, each call one flash_attention launch and ``combines`` combine
    launches.  Returns the largest error."""
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    again = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    check(torch.equal(got, again),
          f"flash_attention differs from call to call at {name}")
    check(fa.launches["flash_attention"] == before["flash_attention"] + 2
          and fa.launches["flash_attention_combine"]
          == before["flash_attention_combine"] + 2 * combines,
          f"flash_attention launches at {name}: {fa.launches}, before "
          f"{before}, want {combines} combine launches a call")
    err, ok = within(got, faref.attention_ref(q, k, v, causal, kv_len),
                     2.0 ** -7, 1e-5)
    check(ok, f"flash_attention differs from plain at {name}: {err!r}")
    return err


def phase_lm_kernel(torch, fa, faref, dev):
    """Phase 8, check 1: the flash kernel against its plain version on the
    card in bfloat16 (``check_flash``).  The tensor-core route (more than
    16 rows a kv head): a prefill shape (9 heads over 3 kv heads, S = T =
    4,096, and a ragged 4,000, causal), every head dim (16, 32, 64, 128)
    at 1 to 4 query heads a kv head with 150 queries against 333 keys
    (causal, or kv_len 300), and 333 queries against 150 keys.  The
    split-KV route: the decode_32k shape (batch 32, one query against a
    32,768-row cache) at kv_len 1, one chunk, one key past a chunk and a
    ragged 20,001, and every decode step of phase 8's serve_batch (batch
    8, one query against a 256-row cache, kv_len 1 to 95).  Returns the
    largest error."""
    gen = torch.Generator(device=dev).manual_seed(81)
    bf = torch.bfloat16

    def qkv(b, s, t, h, hk, d):
        return tuple(torch.randn(shape, generator=gen, device=dev, dtype=bf)
                     for shape in ((b, s, h, d), (b, t, hk, d), (b, t, hk, d)))

    cases = [(f"prefill S=T={s}", *qkv(1, s, s, 9, 3, 64), True, None)
             for s in (4096, 4000)]
    for d in fa.HEAD_DIMS:
        for g in (1, 2, 3, 4):
            q, k, v = qkv(2, 150, 333, 2 * g, 2, d)
            cases += [(f"D={d} G={g} S=150 T=333 causal", q, k, v, True,
                       None),
                      (f"D={d} G={g} S=150 T=333 kv_len=300", q, k, v,
                       False, 300)]
    cases.append(("S=333 T=150 causal", *qkv(1, 333, 150, 9, 3, 64), True,
                  None))
    worst = 0.0
    for name, q, k, v, causal, kv_len in cases:
        err = check_flash(torch, fa, faref, name, q, k, v, causal, kv_len, 0)
        worst = max(worst, err)
        print(f"phase 8: flash_attention == plain (bf16, tensor cores) at "
              f"{name}: max abs err {err!r} (tol 1e-5 + 2^-7|plain|)",
              flush=True)
    q, k, v = qkv(32, 1, 32768, 9, 3, 64)
    for kv_len in (1, fa.DECODE_CHUNK, fa.DECODE_CHUNK + 1, 20001):
        chunks = fa.split_chunks(bf, 1, 3, kv_len, False)
        err = check_flash(torch, fa, faref,
                          f"decode B=32 T=32768 kv_len={kv_len}", q, k, v,
                          False, kv_len, int(chunks > 1))
        worst = max(worst, err)
        print(f"phase 8: flash_attention == plain (bf16, split-KV, {chunks} "
              f"chunks) at decode B=32 T=32768 kv_len={kv_len}: max abs err "
              f"{err!r} (tol 1e-5 + 2^-7|plain|)", flush=True)
    del q, k, v
    # serve_batch's decode steps: a layer's (B, Smax, HK, D) cache slice
    q = torch.randn((8, 1, 9, 64), generator=gen, device=dev, dtype=bf)
    kc, vc = (torch.randn((2, 8, 256, 3, 64), generator=gen, device=dev,
                          dtype=bf) for _ in range(2))
    errs = [check_flash(torch, fa, faref, f"the serve_batch decode shape, "
                        f"kv_len {kv_len}", q, kc[1], vc[1], False, kv_len, 0)
            for kv_len in range(1, 96)]
    worst = max(worst, *errs)
    print(f"phase 8: flash_attention == plain (bf16) at serve_batch's decode "
          f"B=8 T=256, kv_len 1..95: max abs err {max(errs)!r} (tol 1e-5 + "
          f"2^-7|plain|)", flush=True)
    return worst


def prefill_instructions(build) -> None:
    """Phase 8: count the tensor-core and TMA instructions of the built
    prefill kernel (``cuobjdump -sass`` of the flash library, from the CUDA
    toolkit or Triton's package); fails if the tool is found and the
    kernel has no HGMMA or HMMA."""
    tool = cuobjdump()
    if tool is None:
        print("phase 8: prefill kernel instructions: no cuobjdump found (CUDA "
              "toolkit or triton/backends/nvidia/bin), not counted",
              flush=True)
        return
    instrs = ("HGMMA", "HMMA", "UTMALDG")
    counts = sass_counts(tool, build, "flash_attention", "prefill_kernel",
                         instrs)
    check(bool(counts), "no prefill_kernel in the flash library's SASS")
    total = {ins: sum(c[ins] for c in counts.values()) for ins in instrs}
    print(f"phase 8: prefill kernel instructions ({tool} -sass, "
          f"{len(counts)} head-dim instances): " + "; ".join(
              f"D={d}: {c}" for d, c in sorted(
                  (int(f.split("prefill_kernelILi")[1].split("E")[0]), c)
                  for f, c in counts.items())) + f"; total {total}",
          flush=True)
    check(all(c["HGMMA"] + c["HMMA"] > 0 for c in counts.values()),
          f"a prefill kernel without tensor-core instructions: {counts}")


def phase_lm_card_vs_cpu(torch, cfg, steps, dev):
    """Phase 8, check 2: the model in float32 at full width on the card and
    on the CPU (plain attention), from the same parameters: the last
    position's logits of a 2 x 64-token prefill, then 8 decode steps that
    the CPU takes on the card's greedy tokens.  Logits within 1e-4 of the
    largest (float32 through 30 layers, sums in other orders); the CPU's
    greedy token must be the card's at every step whose top-2 margin is
    above that tolerance, and the steps where it is not are named."""
    import copy

    from repro_torch.models.lm.transformer import Transformer

    tol = 1e-4
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    card = Transformer(c32, torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    cpu = copy.deepcopy(card).to("cpu")
    tok = torch.randint(0, cfg.vocab, (2, 64),
                        generator=torch.Generator().manual_seed(82),
                        dtype=torch.int32)
    runs = {}
    for name, model, d in (("card", card, dev), ("CPU", cpu, "cpu")):
        last, caches = steps.prefill_fn(model, tok.to(d))
        full = tuple(torch.zeros((c32.n_layers, 2, 72, c32.n_kv_heads,
                                  c32.hd), device=d) for _ in range(2))
        for f, c in zip(full, caches):
            f[:, :, :64] = c
        runs[name] = (last.cpu(), full)

    def close(got, want):
        scale = float(want.abs().max())
        err, ok = within(got, want, 0.0, tol * scale)
        return err / scale, ok

    err, ok = close(runs["card"][0], runs["CPU"][0])
    rows = [("prefill", err, ok, runs["card"][0], runs["CPU"][0])]
    nxt = runs["card"][0].argmax(-1).to(torch.int32)[:, None]
    for i in range(8):
        lc = steps.lm_serve_fn(card, nxt.to(dev), *runs["card"][1], 64 + i)[0]
        lh = steps.lm_serve_fn(cpu, nxt, *runs["CPU"][1], 64 + i)[0]
        lc = lc[:, -1].cpu()
        lh = lh[:, -1]
        err, ok = close(lc, lh)
        rows.append((f"decode {i}", err, ok, lc, lh))
        nxt = lc.argmax(-1).to(torch.int32)[:, None]
    near = []
    for name, err, ok, lc, lh in rows:
        check(ok, f"card vs CPU logits at {name}: {err!r} > {tol}")
        scale = float(lh.abs().max())
        margin = top2_margin(lh)
        same = lc.argmax(-1) == lh.argmax(-1)
        tied = margin <= tol * scale
        check(bool((same | tied).all()),
              f"card vs CPU greedy tokens differ at {name} with a clear "
              f"margin: {margin.tolist()}")
        near += [f"{name} row {r} (margin {float(margin[r])!r})"
                 for r in torch.nonzero(tied).flatten().tolist()]
    print(f"phase 8: card vs CPU (float32, full width): logits max err / "
          f"max {[r[1] for r in rows]} (tol {tol}); greedy tokens equal "
          f"wherever the top-2 margin is above the tolerance; "
          f"steps with a top-2 margin under the tolerance: {near or 'none'}",
          flush=True)
    return max(r[1] for r in rows)


def phase_lm(torch, args):
    """Phase 8: smollm-135m serving at full width in bf16 (30 layers,
    d_model 576, 9 heads over 3 kv heads, head_dim 64, d_ff 1,536, vocab
    49,152, tied), seeded random weights.  Returns flash_attention's row
    of the kernels line."""
    from repro_torch.configs import smollm_135m
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.launch import steps
    from repro_torch.models.lm import serve
    from repro_torch.models.lm.transformer import Transformer

    dev = torch.device("cuda")
    cfg = smollm_135m.CONFIG
    no_tf32(torch, "phase 8")
    worst = phase_lm_kernel(torch, fa, faref, dev)
    prefill_instructions(build)
    phase_lm_card_vs_cpu(torch, cfg, steps, dev)
    torch.cuda.empty_cache()
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    nparam = sum(p.numel() for p in model.parameters())
    print(f"phase 8: {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads} HK={cfg.n_kv_heads} hd={cfg.hd} "
          f"d_ff={cfg.d_ff} V={cfg.vocab}: {nparam} bf16 parameters",
          flush=True)
    L = cfg.n_layers

    # --- main path 1: serve_batch, greedy ---------------------------------
    prompts = torch.randint(0, cfg.vocab, (8, 64),
                            generator=torch.Generator().manual_seed(83),
                            dtype=torch.int32).numpy()
    scfg = serve.ServeConfig(max_new_tokens=32, cache_len=256)
    serve.serve_batch(model, prompts, scfg)               # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = serve.serve_batch(model, prompts, scfg)
    wall = time.perf_counter() - t0
    n_steps = prompts.shape[1] - 1 + scfg.max_new_tokens
    want = L * n_steps
    counts = check_counts("phase 8 serve_batch", {"flash_attention": want})
    check(out.shape == (8, 96) and (out[:, :64] == prompts).all()
          and ((out >= 0) & (out < cfg.vocab)).all(),
          f"serve_batch output {out.shape}")
    served = counts["flash_attention"]
    caches = tuple(torch.zeros((L, 8, scfg.cache_len, cfg.n_kv_heads,
                                cfg.hd), dtype=cfg.dtype, device=dev)
                   for _ in range(2))
    tok8 = torch.from_numpy(out[:, 64:65]).to(dev)
    profile_round(torch, "phase 8: profiled serve_batch decode step "
                  "(B=8, cache 256, position 80)",
                  lambda: steps.lm_serve_fn(model, tok8, *caches, 80),
                  top=8, host_top=8)
    del caches
    print(f"phase 8: serve_batch 8 x 64 prompts, 32 new tokens, cache 256, "
          f"greedy: {wall!r} s, {wall / n_steps * 1e3!r} ms a step, "
          f"{8 * scfg.max_new_tokens / wall!r} new tokens/s, "
          f"{8 * n_steps / wall!r} tokens/s through the decode step; "
          f"flash_attention launches {served} = {L} x ({prompts.shape[1] - 1}"
          f" + {scfg.max_new_tokens})", flush=True)

    # --- main path 2: prefill_32k at batch 1 (cut from 32) ----------------
    s = LM_SHAPES["prefill_32k"]["seq_len"]
    tok = torch.randint(0, cfg.vocab, (1, s), device=dev, dtype=torch.int32,
                        generator=torch.Generator(device=dev).manual_seed(84))
    steps.prefill_fn(model, tok)                          # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    last, caches = steps.prefill_fn(model, tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_counts("phase 8 prefill_32k", {"flash_attention": L})
    peak = torch.cuda.max_memory_allocated() - base
    check(last.shape == (1, cfg.vocab) and bool(last.isfinite().all())
          and caches[0].shape == (L, 1, s, cfg.n_kv_heads, cfg.hd),
          "prefill_32k outputs")
    print(f"phase 8: prefill_32k batch 1 (cut from 32): {wall!r} s, "
          f"{s / wall!r} tokens/s, peak {peak} B above the {base} B held; "
          f"flash_attention launches {L}", flush=True)
    del last, caches
    profile_round(torch, "phase 8: profiled prefill_32k",
                  lambda: steps.prefill_fn(model, tok), top=8)

    # --- main path 3: one decode step at decode_32k, batch 32 (cut from 128)
    smax = LM_SHAPES["decode_32k"]["seq_len"]
    b = 32
    g = torch.Generator(device=dev).manual_seed(85)
    shape = (L, b, smax, cfg.n_kv_heads, cfg.hd)
    kc = torch.randn(shape, generator=g, device=dev, dtype=cfg.dtype)
    vc = torch.randn(shape, generator=g, device=dev, dtype=cfg.dtype)
    token = torch.randint(0, cfg.vocab, (b, 1), device=dev,
                          dtype=torch.int32, generator=g)
    steps.lm_serve_fn(model, token, kc, vc, smax - 1)     # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, _, _, new_len = steps.lm_serve_fn(model, token, kc, vc, smax - 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_counts("phase 8 decode_32k", {"flash_attention": L,
                                        "flash_attention_combine": L})
    peak = torch.cuda.max_memory_allocated() - base
    check(logits.shape == (b, 1, cfg.vocab) and new_len == smax
          and bool(logits.isfinite().all()), "decode_32k outputs")
    print(f"phase 8: decode_32k one step, batch {b} (cut from 128), cache "
          f"{2 * kc.numel() * kc.element_size()} B: {wall * 1e3!r} ms, "
          f"{b / wall!r} tokens/s; peak {peak} B above the {base} B held; "
          f"flash_attention launches {L}, flash_attention_combine "
          f"launches {L}", flush=True)
    profile_round(torch, "phase 8: profiled decode_32k step",
                  lambda: steps.lm_serve_fn(model, token, kc, vc, smax - 1),
                  top=8)

    # --- the kernel's times at the prefill_32k and decode_32k layers ------
    row = {"name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
           "replaces": REPLACES["flash_attention"], "launches": served,
           "launches_prefill_32k": L, "launches_decode_32k": L,
           "combine_launches_decode_32k": L,
           "max_abs_err": worst}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(86)
    q = torch.randn((1, s, 9, 64), generator=gen, device=dev, dtype=cfg.dtype)
    k = torch.randn((1, s, 3, 64), generator=gen, device=dev, dtype=cfg.dtype)
    v = torch.randn((1, s, 3, 64), generator=gen, device=dev, dtype=cfg.dtype)
    dq = torch.randn((b, 1, 9, 64), generator=gen, device=dev,
                     dtype=cfg.dtype)
    for tag, (qq, kk, vv, causal) in (("", (q, k, v, True)),
                                      ("_decode_32k", (dq, kc[0], vc[0],
                                                       False))):
        bq, sq, h, d = qq.shape
        t = kk.shape[1]
        pairs = sq * (sq + 1) // 2 if causal else sq * t
        ops_ms = 4 * bq * h * d * pairs / BF16_FLOPS * 1e3
        bytes_ms = bound_ms(2 * d * (2 * bq * sq * h + 2 * bq * t * kk.shape[2]))
        # the library call on the same inputs, kv heads repeated for it
        qh = qq.transpose(1, 2).contiguous()
        kh = kk.repeat_interleave(h // kk.shape[2], 2).transpose(1, 2) \
            .contiguous()
        vh = vv.repeat_interleave(h // kk.shape[2], 2).transpose(1, 2) \
            .contiguous()
        plain = (lambda: faref.attention_chunked_ref(qq, kk, vv, causal)) \
            if causal else (lambda: faref.attention_ref(qq, kk, vv, causal))
        name = "prefill_32k" if causal else "decode_32k"
        want = plain()
        got = fa.flash_attention(qq, kk, vv, causal=causal)
        err, ok = within(got, want, 2.0 ** -7, 1e-5)
        check(ok, f"flash_attention differs from plain at {name}: {err!r}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        print(f"phase 8: flash_attention == plain (bf16) at {name}: max abs "
              f"err {err!r} (tol 1e-5 + 2^-7|plain|)", flush=True)
        # SDPA rounds its probabilities to bf16 before the product with v:
        # held to plain only as a check that it computes the same function
        lib = sdpa(qh, kh, vh, is_causal=causal).transpose(1, 2)
        err, ok = within(lib, want, 2e-2, 2e-2)
        check(ok, f"SDPA and plain disagree at {name}: {err!r}")
        del lib, got, want
        row.update({
            "ms" + tag: time_ms(lambda: fa.flash_attention(
                qq, kk, vv, causal=causal), 3 if causal else args.reps, 1),
            "plain_ms" + tag: time_ms(plain, 1, 1),
            "bound_ms" + tag: max(ops_ms, bytes_ms),
            "bound_by" + tag: "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms" + tag: time_ms(
                lambda: sdpa(qh, kh, vh, is_causal=causal),
                3 if causal else args.reps, 1),
            "device_ms" + tag: device_ms(torch, lambda: fa.flash_attention(
                qq, kk, vv, causal=causal), args.reps)[0],
            "library_device_ms" + tag: device_ms(
                torch, lambda: sdpa(qh, kh, vh, is_causal=causal),
                args.reps)[0]})
        del qh, kh, vh
        print(f"phase 8: flash_attention at {name} layer (B={bq}, S={sq}, "
              f"T={t}, H={h}, HK={kk.shape[2]}, D={d}): ms "
              f"{row['ms' + tag]!r}, device_ms {row['device_ms' + tag]!r}, "
              f"bound {row['bound_ms' + tag]!r} ({row['bound_by' + tag]}), "
              f"plain "
              f"{'chunked ' if causal else ''}{row['plain_ms' + tag]!r}, "
              f"SDPA {row['library_ms' + tag]!r} (device_ms "
              f"{row['library_device_ms' + tag]!r})", flush=True)
    del kc, vc, model
    torch.cuda.empty_cache()
    return row


def same_result(np, a, b) -> bool:
    """Two PartitionResults equal bit for bit."""
    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("edge_part", "vparts", "edges_per_part"))
            and a.rounds == b.rounds and a.leftover == b.leftover
            and a.stats == b.stats)


def spmd_rounds(torch, sm, g, cfg, limit, rounds):
    """The world-1 SPMD state after ``rounds`` rounds (run inside an open
    group), and this rank's shard (u, v) on the card."""
    from repro_torch.core.graph import shard_edges

    shards, masks, _, _ = shard_edges(g.edges.cpu().numpy(), 1)
    u, v = (torch.from_numpy(shards[0, :, i].copy()).to(g.device)
            for i in (0, 1))
    mask = torch.from_numpy(masks[0]).to(g.device)
    state = sm.spmd_init_state(shards, masks, g.num_vertices, cfg,
                               device=g.device)
    while int(state.rounds) < rounds and not sm.spmd_done(state, cfg):
        state = sm.spmd_round_step(cfg, limit, g.num_vertices, u, v, mask,
                                   state)
    return state, u, v, mask


def child_trace(snap_dir: str) -> str:
    """The killed child's obs log, beside its snapshot dir."""
    return snap_dir + ".trace.jsonl"


def driver_child(ef_path: str, snap_dir: str, every: int, kill_at: int,
                 device: str) -> None:
    """Phase 9's killed run, in a process (and CUDA context) of its own:
    ``PartitionDriver`` in spmd mode on the EdgeFile at ``ef_path`` in a
    world-1 group, a snapshot every ``every`` rounds, the process killed
    by SIGKILL right after the step that publishes round ``kill_at``'s
    snapshot.  Its spans go to :func:`child_trace`, flushed first."""
    import signal

    import torch
    from repro_torch.core import partitioner as tp
    from repro_torch.dist import compat
    from repro_torch.io import EdgeFile
    from repro_torch.obs import trace as obs
    from repro_torch.runtime import PartitionDriver

    dev = torch.device(device)
    obs.configure(path=child_trace(snap_dir))
    cfg = tp.NEConfig(num_partitions=PARTITIONS)
    with compat.world1("nccl" if dev.type == "cuda" else "gloo"):
        drv = PartitionDriver(EdgeFile(ef_path), cfg, snapshot_dir=snap_dir,
                              snapshot_every=every,
                              keep=DRIVER_SNAPSHOTS_BEFORE_KILL, device=dev)
        while not drv.done:
            if drv.step() == kill_at:
                obs.flush()
                os.kill(os.getpid(), signal.SIGKILL)
    fail(f"phase 9: the run reached its fixed point before round {kill_at}")


def span_seconds(events, name: str) -> list:
    """The durations (s) of the named spans of an obs event list."""
    return [e["dur"] / 1e6 for e in events
            if e["ev"] == "span" and e["name"] == name]


def phase_driver(torch, np, edges, res, per_round_3b: float, chunks: int,
                 dev, scale: int, tmp: str):
    """Phase 9: the driver from the store.  Phase 3's edge list goes into
    a canonical EdgeFile in ``tmp``; a child process runs
    ``PartitionDriver`` in spmd mode from it with snapshots and is killed
    by SIGKILL; this process resumes from the newest snapshot (launch
    counts set to 0 just before), runs to the fixed point and must equal
    phase 3's result bit for bit; then the result goes through an
    artifact and back.  Returns the resumed run's launch counts and the
    EdgeFile (phase 10 reads it)."""
    import shutil
    import signal

    from repro_torch.core import partitioner as tp
    from repro_torch.dist import compat
    from repro_torch.io import FLAG_CANONICAL, write_edgefile
    from repro_torch.kernels.ne_round import ops
    from repro_torch.obs import trace as obs
    from repro_torch.runtime import PartitionDriver, load_artifact

    t_phase = time.perf_counter()
    every = max(res.rounds // (2 * DRIVER_SNAPSHOTS_BEFORE_KILL), 1)
    kill_at = DRIVER_SNAPSHOTS_BEFORE_KILL * every
    cfg = tp.NEConfig(num_partitions=PARTITIONS)
    ef_path = os.path.join(tmp, "main.edges")
    snap = os.path.join(tmp, "snap")
    art_dir = os.path.join(tmp, "artifact")
    try:
        t0 = time.perf_counter()
        ef = write_edgefile(ef_path, edges, num_vertices=1 << scale,
                            flags=FLAG_CANONICAL)
        print(f"phase 9: canonical EdgeFile of phase 3's edge list: "
              f"{ef.num_edges} edges in {ef.num_blocks} blocks, "
              f"{os.path.getsize(ef_path)} B, written in "
              f"{time.perf_counter() - t0!r} s", flush=True)

        # --- the killed run, in a child process ----------------------------
        if dev.type == "cuda":
            torch.cuda.empty_cache()       # room for the child's context
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--driver-child",
             ef_path, snap, str(every), str(kill_at), str(dev)],
            capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        check(child.returncode == -signal.SIGKILL,
              f"phase 9: the child exited {child.returncode}, not killed by "
              f"SIGKILL: {child.stdout[-2000:]} {child.stderr[-3000:]}")
        published = sorted(int(d.split("_")[1]) for d in os.listdir(snap)
                           if d.startswith("step_"))
        want_steps = [every * (i + 1)
                      for i in range(DRIVER_SNAPSHOTS_BEFORE_KILL)]
        check(published == want_steps,
              f"phase 9: published rounds {published}, not {want_steps}")
        with open(child_trace(snap)) as f:
            events = [json.loads(line) for line in f]
        rounds_s = span_seconds(events, "round")
        saves = span_seconds(events, "snapshot")
        snap_bytes = sum(os.path.getsize(os.path.join(snap, d, f))
                         for d in os.listdir(snap) if d.startswith("step_")
                         for f in os.listdir(os.path.join(snap, d)))
        print(f"phase 9: child killed by SIGKILL after round {kill_at}, "
              f"{child_s!r} s after its start; snapshots published at "
              f"rounds {published} ({snap_bytes} B in all); its ingest "
              f"{span_seconds(events, 'ingest')} s, {len(rounds_s)} rounds "
              f"({float(np.median(rounds_s)) * 1e3!r} ms median, snapshot "
              f"rounds included), snapshot saves {saves} s", flush=True)

        # --- resume in this process: the main path of the phase -------------
        backend = "nccl" if dev.type == "cuda" else "gloo"
        tracer = obs.configure(path=None)
        try:
            with compat.world1(backend):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t0 = time.perf_counter()
                drv = PartitionDriver.resume(ef, cfg, snap, device=dev)
                start = drv.rounds
                got = drv.run()
                wall = time.perf_counter() - t0
                launches = dict(ops.launches)
                peak = torch.cuda.max_memory_allocated()
                t0 = time.perf_counter()
                drv.save_artifact(art_dir)
                save_s = time.perf_counter() - t0
        finally:
            obs.disable()
        events = tracer.events
        rounds_s = span_seconds(events, "round")
        resumed = got.rounds - start
        st = got.stats
        print(f"phase 9: resumed from round {start} in a world-1 "
              f"{backend.upper()} group: rounds={got.rounds} leftover="
              f"{got.leftover} RF={st.replication_factor!r} "
              f"EB={st.edge_balance!r} wall={wall!r} s; ingest "
              f"{span_seconds(events, 'ingest')} s, restore "
              f"{span_seconds(events, 'restore')} s, finalize "
              f"{span_seconds(events, 'finalize')} s; {len(rounds_s)} "
              f"rounds at {float(np.mean(rounds_s)) * 1e3!r} ms a round "
              f"(phase 3b: {per_round_3b * 1e3!r} ms); peak_mem={peak} B "
              f"launches={launches}", flush=True)
        check(start == kill_at,
              f"phase 9: resumed from round {start}, not {kill_at}")
        check(same_result(np, got, res),
              "phase 9: the resumed run differs from phase 3's result")
        if scale == 22:
            check((got.rounds, st.replication_factor, st.edge_balance)
                  == SCALE22_RESULT,
                  f"phase 9: rounds, RF, EB are not {SCALE22_RESULT}")
        want = {"select": resumed, "restart_draw": resumed,
                "one_hop": resumed, "claim_scatter": resumed,
                "pack_bits": 2 * resumed, "or_words": 2 * resumed,
                "unpack_bits": resumed, "two_hop_best": resumed * chunks}
        check(launches == want and resumed > 0,
              f"phase 9: launch counts {launches} are not {want}")

        # --- the artifact and back -------------------------------------------
        t0 = time.perf_counter()
        back = load_artifact(art_dir).result()
        load_s = time.perf_counter() - t0
        art_bytes = sum(os.path.getsize(os.path.join(art_dir, f))
                        for f in os.listdir(art_dir))
        check(all(np.array_equal(getattr(back, f), getattr(got, f))
                  for f in ("edge_part", "vparts", "edges_per_part"))
              and (back.rounds, back.leftover) == (got.rounds, got.leftover),
              "phase 9: the artifact's result differs from the run's")
        print(f"phase 9: == phase 3 bit for bit; launch counts match the "
              f"resumed rounds {start + 1}-{got.rounds}; artifact "
              f"{art_bytes} B in {len(os.listdir(art_dir))} files, saved in "
              f"{save_s!r} s, loaded back in {load_s!r} s and equal; phase "
              f"9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
        return launches, ef
    finally:
        for d in (snap, art_dir):
            shutil.rmtree(d, ignore_errors=True)


def stream_chain_ops(name: str, p: int) -> int:
    """Dependent operations an edge on the scan's serial chain: step i + 1
    reads |E_p| after step i's choice.  HDRF: the count's update, its
    conversion, max - |E_p|, the division, the product and the sum, then
    a compare and a select at each of ceil(log2 P) levels of the argmax;
    Oblivious: the update, the conversion and the room test, then the
    argmin's levels."""
    levels = max(1, (p - 1).bit_length())
    return (6 if name == "hdrf_scan" else 3) + 2 * levels


def stream_bound(name: str, m: int, p: int):
    """(ms, by, floor): the larger of the bytes (8 B of edge read and 4 B
    of partition written an edge) at the card's rate, P partitions'
    scores (10 float operations each) at its FP32 rate, and the serial
    chain at one dependent operation a clock."""
    times = {"bytes": bound_ms(12 * m),
             "operations": max(10 * m * p / FP32_FLOPS * 1e3,
                               m * stream_chain_ops(name, p) / CLOCK_HZ
                               * 1e3)}
    by = max(times, key=times.get)
    return times[by], by, (f"serial chain: {stream_chain_ops(name, p)} "
                           f"dependent operations an edge at one a clock "
                           f"({CLOCK_HZ / 1e9} GHz)")


def phase_stream_kernels(torch, dev) -> int:
    """Phase 10 (a): the cases the quality matrix does not reach, each
    stream kernel against its plain version on the card, bit for bit, and
    the same bits call to call, on rmat(10, 8, seed 3): P = 1 and a ragged
    P = 37 (two warps, the second partly idle), HDRF at lambda 0.5 and 2,
    Oblivious at a limit every partition fills (the overflow rule).
    Returns the largest difference (0)."""
    from repro_torch.graphs.rmat import rmat
    from repro_torch.kernels.stream import ops as sops
    from repro_torch.kernels.stream import ref as sref

    t0 = time.perf_counter()
    g = rmat(10, 8, seed=3, device=dev)
    e, n, m = g.edges, g.num_vertices, g.num_edges
    worst = 0
    for p in STREAM_CHECK_PARTS:
        calls = []
        for lam in STREAM_LAMBDAS:
            calls.append((f"hdrf lam={lam}", lambda lam=lam: sops.hdrf_scan(
                e, p, n, lam), lambda lam=lam: sref.hdrf_scan_ref(
                    e, p, n, lam)))
        limit = max(1, m // (2 * p))
        calls.append((f"oblivious limit={limit}",
                      lambda: sops.oblivious_scan(e, p, n, limit),
                      lambda: sref.oblivious_scan_ref(e, p, n, limit)))
        for name, kern, plain in calls:
            a, b, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            err = max(max_abs_err(a, want), max_abs_err(a, b))
            worst = max(worst, err)
            check(err == 0, f"phase 10: {name} at P={p} differs from its "
                            f"plain version or from call to call ({err})")
        # the small limit fills every partition: the overflow rule ran
        full = torch.bincount(a.long(), minlength=p).min().item()
        check(full >= limit,
              f"phase 10: oblivious at P={p} left a partition unfilled")
        print(f"phase 10: hdrf_scan and oblivious_scan == plain bit for bit "
              f"and call to call at M={m}, N={n}, P={p} ({len(calls)} "
              f"cases)", flush=True)
    print(f"phase 10 (a): took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return worst


def phase_quality(torch, np, dev, workdir: str):
    """Phase 10 (b): the 32 rows of BENCH_QUALITY.json's fast matrix on the
    card (``repro_torch.tools.quality``), each against its expected (rf,
    eb, vb), with the launch counts set to 0 just before and read just
    after.  Returns the graphs, the rows and the counts."""
    from repro_torch.tools import quality

    t0 = time.perf_counter()
    graphs = {"rmat_s14_ef16": quality.rmat_graph(dev),
              "real": quality.real_graph(workdir, dev)[0]}
    for name, g in graphs.items():
        print(f"phase 10: {name}: N={g.num_vertices} M={g.num_edges}",
              flush=True)
        # one two-hop chunk a round on every row below
        check(g.num_edges <= 1 << 18, f"phase 10: {name} has > 2^18 edges")
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    rows = quality.run_matrix(graphs,
                              log=lambda line: print(f"phase 10: {line}",
                                                     flush=True))
    wall = time.perf_counter() - t1
    counts = all_counts()
    rounds = sum(r["rounds"] for r in rows if r["rounds"] is not None)
    streams = len(graphs) * len(quality.PARTS)
    check_counts("phase 10 (b)", {
        "select": rounds, "restart_draw": rounds, "one_hop": rounds,
        "claim_scatter": rounds, "two_hop_best": rounds,
        "hdrf_scan": streams, "oblivious_scan": streams})
    bad = [r["name"] for r in rows if not r["ok"]]
    check(not bad, f"phase 10: rows differ from the expected table: {bad}")
    print(f"phase 10 (b): all {len(rows)} rows == the expected table "
          f"({len(quality.STALE)} of them the reference's present value, "
          f"stale in BENCH_QUALITY.json) in {wall:.1f} s; {rounds} NE "
          f"rounds; launches {counts}; took {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    return graphs, rows, counts


def launch_ms(torch, sops, scan, reps: int):
    """(kernel ms, fill ms) a call of ``scan``, by CUDA events: around its
    launch alone, and around the zeroing of its state before it.  Each
    call is queued behind a 1 ms ``torch.cuda._sleep`` so that the host's
    dispatch lies inside the sleep, not between the events.  A warm-up
    call first."""
    kern = fill = 0.0
    for i in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda._sleep(int(CLOCK_HZ / 1e3))
        ev[0].record()
        scan.vparts.zero_()
        if scan.degree is not None:
            scan.degree.zero_()
        ev[1].record()
        sops.launch(scan)
        ev[2].record()
        ev[2].synchronize()
        if i:
            fill += ev[0].elapsed_time(ev[1])
            kern += ev[1].elapsed_time(ev[2])
    return kern / reps, fill / reps


def stream_cells(torch, graphs, counts, err: int) -> list:
    """Each stream kernel at every cell of (b)'s matrix, on the inputs the
    baselines give it there (stream order of seed 0, HDRF at lambda 1,
    Oblivious at the alpha limit): the wrapper's time (``ms``), the
    launch's alone and the fills' (:func:`launch_ms`), the bound; on
    ``STREAM_PLAIN_GRAPH`` also the plain version's time (one call: it
    takes ~0.3-0.5 ms an edge on the card) and the kernel's bits against
    it and from call to call.  Returns the two JSON rows: the numbers of
    the (real, P = 16) cell, with (b)'s launch counts and every cell
    under ``cells``."""
    from repro_torch.core.baselines import stream_order
    from repro_torch.kernels.stream import ops as sops
    from repro_torch.kernels.stream import ref as sref
    from repro_torch.tools import quality

    t0 = time.perf_counter()
    cells = {name: [] for name in STREAM_KERNELS}
    for gname, g in graphs.items():
        n, m = g.num_vertices, g.num_edges
        es = g.edges[stream_order(g, 0)]
        for p in quality.PARTS:
            limit = int(1.1 * m / p) + 1
            for name, arg, kern, plain in (
                    ("hdrf_scan", 1.0,
                     lambda: sops.hdrf_scan(es, p, n, 1.0),
                     lambda: sref.hdrf_scan_ref(es, p, n, 1.0)),
                    ("oblivious_scan", limit,
                     lambda: sops.oblivious_scan(es, p, n, limit),
                     lambda: sref.oblivious_scan_ref(es, p, n, limit))):
                bound, by, floor = stream_bound(name, m, p)
                dev_ms, fill_ms = launch_ms(
                    torch, sops, sops.prepare(name, es, p, n, arg), 3)
                cell = {"graph": gname, "p": p, "m": m, "n": n,
                        "ms": time_ms(kern, 3, warmup=1), "device_ms": dev_ms,
                        "fill_ms": fill_ms, "bound_ms": bound, "bound_by": by,
                        "bound_floor": floor, "plain_ms": None,
                        "max_abs_err": None}
                if gname == STREAM_PLAIN_GRAPH:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    want = plain()
                    end.record()
                    end.synchronize()
                    a, b = kern(), kern()
                    diff = max(max_abs_err(a, want), max_abs_err(a, b))
                    check(diff == 0, f"phase 10: {name} at {gname} P={p} "
                                     f"differs from its plain version or "
                                     f"from call to call ({diff})")
                    cell.update(plain_ms=start.elapsed_time(end),
                                max_abs_err=diff)
                cells[name].append(cell)
                held = ("" if cell["plain_ms"] is None else
                        f", == plain bit for bit and call to call, plain "
                        f"{cell['plain_ms']!r} ms")
                print(f"phase 10: {name} at {gname} P={p} (M={m}): ms "
                      f"{cell['ms']!r}, launch {dev_ms!r} ms "
                      f"({dev_ms * 1e6 / m!r} ns an edge), fills {fill_ms!r} "
                      f"ms, bound {bound!r} ({by}: {floor}){held}",
                      flush=True)
    rows = []
    for name, cs in cells.items():
        top = next(c for c in cs if c["graph"] == STREAM_PLAIN_GRAPH
                   and c["p"] == STREAM_ROW_P)
        rows.append({
            "name": name, "route": "cuda", "source": STREAM_SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max([err] + [c["max_abs_err"] for c in cs
                                        if c["max_abs_err"] is not None]),
            "ms": top["ms"], "device_ms": top["device_ms"],
            "device_ms_by": ("CUDA events around the launch alone, queued "
                             "behind a 1 ms sleep; its two fills apart in "
                             "fill_ms"),
            "fill_ms": top["fill_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "bound_floor": top["bound_floor"], "library_ms": None,
            "library_device_ms": None,
            "shape": (f"{STREAM_PLAIN_GRAPH} in stream order, P="
                      f"{STREAM_ROW_P}, M={top['m']}; launches over (b)'s "
                      f"four cells"),
            "cells": cs})
    print(f"phase 10: stream cells took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


def phase_hybrid_scale(torch, np, ef, dev):
    """Phase 10 (c): ``partition_hybrid`` from phase 9's canonical
    EdgeFile at P = 64, tau = 0.25 (the streamed split on the host, the
    expansion on the card), launch counts set to 0 just before and read
    just after, its phases' obs spans, peak memory and invariants."""
    from repro_torch.core.hybrid import HybridConfig, partition_hybrid
    from repro_torch.core.metrics import stats_from_counts
    from repro_torch.obs import trace as obs

    cfg = HybridConfig(num_partitions=PARTITIONS, budget_frac=HYBRID_TAU)
    tracer = obs.configure(path=None)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = partition_hybrid(ef, cfg, device=dev)
        wall = time.perf_counter() - t0
        counts = all_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        obs.disable()
    spans = {e["name"]: e for e in tracer.events if e["ev"] == "span"}
    split = spans["hybrid_split"]
    theta, m_low = split["args"]["threshold"], split["args"]["low_edges"]
    rounds = res.rounds
    chunks = -(-m_low // min(cfg.edge_chunk, m_low))
    check_counts("phase 10 (c)", {
        "select": rounds, "restart_draw": rounds, "one_hop": rounds,
        "claim_scatter": rounds, "two_hop_best": rounds * chunks})
    st = res.stats
    rounds_s = spans["hybrid_rounds"]["dur"] / 1e6
    print(f"phase 10 (c): partition_hybrid of the EdgeFile (N="
          f"{ef.num_vertices}, M={ef.num_edges}) P={PARTITIONS} tau="
          f"{HYBRID_TAU}: theta={theta} M_low={m_low} "
          f"({m_low / ef.num_edges:.4f} of M) rounds={rounds} leftover="
          f"{res.leftover} RF={st.replication_factor!r} "
          f"EB={st.edge_balance!r} VB={st.vertex_balance!r}; wall {wall!r} "
          f"s: split {split['dur'] / 1e6!r} s (host), rounds {rounds_s!r} s "
          f"({rounds_s / max(rounds, 1) * 1e3!r} ms a round), finalize "
          f"{spans['hybrid_finalize']['dur'] / 1e6!r} s; peak_mem={peak} B; "
          f"launches {counts}", flush=True)
    # invariants: every edge assigned; counts and replicas from edge_part
    t0 = time.perf_counter()
    ep = res.edge_part
    check(bool((ep >= 0).all()) and bool((ep < PARTITIONS).all()),
          "phase 10 (c): unassigned edges")
    check(np.array_equal(res.edges_per_part,
                         np.bincount(ep, minlength=PARTITIONS)),
          "phase 10 (c): edges_per_part disagrees with edge_part")
    edges = ef.read_all()
    vp = np.zeros((ef.num_vertices, PARTITIONS), bool)
    vp[edges[:, 0], ep] = True
    vp[edges[:, 1], ep] = True
    check(np.array_equal(vp, res.vparts),
          "phase 10 (c): vparts disagrees with edge_part")
    check(st == stats_from_counts(vp.sum(axis=0), res.edges_per_part,
                                  ef.num_vertices),
          "phase 10 (c): stats disagree with edge_part")
    print(f"phase 10 (c): invariants hold (every edge assigned; counts, "
          f"replicas and stats from edge_part; checked in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return res


def phase_hybrid_driver(torch, np, graphs, rows, dev, tmp: str) -> None:
    """Phase 10 (d): ``PartitionDriver`` in hybrid mode on the matrix's
    RMAT graph, a snapshot every 8 rounds, stopped at round 24, resumed in
    this process from that snapshot (counts set to 0 just before) and run
    to the end: (b)'s ``partition_hybrid`` result bit for bit; then the
    artifact and back."""
    from repro_torch.core.hybrid import HybridConfig
    from repro_torch.runtime import PartitionDriver, load_artifact
    from repro_torch.tools import quality

    gname, p, every, stop = HYBRID_DRIVER
    want = next(r["result"] for r in rows if r["name"] == quality.row_name(
        gname, p, f"hybrid_t{int(HYBRID_TAU * 100)}"))
    g = graphs[gname]
    cfg = HybridConfig(num_partitions=p, budget_frac=HYBRID_TAU, seed=0)
    snap = os.path.join(tmp, "hybrid_snap")
    t0 = time.perf_counter()
    drv = PartitionDriver(g, cfg, mode="hybrid", snapshot_dir=snap,
                          snapshot_every=every, keep=8, device=dev)
    while drv.rounds < stop and not drv.done:
        drv.step()
    check(drv.rounds == stop, f"phase 10 (d): stopped at {drv.rounds}")
    del drv
    reset_counts()
    drv = PartitionDriver.resume(g, cfg, snap, mode="hybrid", device=dev)
    start = drv.rounds
    got = drv.run()
    counts = all_counts()
    resumed = got.rounds - start
    check(start == stop, f"phase 10 (d): resumed from round {start}")
    check(same_result(np, got, want),
          "phase 10 (d): the resumed driver differs from (b)'s run")
    check_counts("phase 10 (d)", {
        "select": resumed, "restart_draw": resumed, "one_hop": resumed,
        "claim_scatter": resumed, "two_hop_best": resumed})
    art = os.path.join(tmp, "hybrid_artifact")
    drv.save_artifact(art)
    back = load_artifact(art).result()
    check(all(np.array_equal(getattr(back, f), getattr(got, f))
              for f in ("edge_part", "vparts", "edges_per_part"))
          and (back.rounds, back.leftover) == (got.rounds, got.leftover),
          "phase 10 (d): the artifact's result differs from the run's")
    print(f"phase 10 (d): hybrid driver on {gname} P={p} tau={HYBRID_TAU}: "
          f"snapshots every {every} rounds, stopped at round {stop}, "
          f"resumed and run to round {got.rounds} == (b)'s partition_hybrid "
          f"bit for bit; launches {counts}; artifact round trip equal; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale of the main run (2^scale vertices)")
    ap.add_argument("--check-scale", type=int, default=14,
                    help="RMAT scale of the card-vs-CPU identity runs")
    ap.add_argument("--time-round", type=int, default=20,
                    help="round whose inputs the kernel timings use")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--driver-child", nargs=5, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    if args.driver_child:
        ef_path, snap, every, kill_at, device = args.driver_child
        driver_child(ef_path, snap, int(every), int(kill_at), device)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")

    from repro_torch.core import partitioner as tp
    from repro_torch.core.epilogue import alpha_limit
    from repro_torch.core.graph import from_edges
    from repro_torch.core.metrics import theorem1_upper_bound
    from repro_torch.dist import compat
    from repro_torch.dist import partitioner_sm as sm
    from repro_torch.graphs.rmat import rmat_edges
    from repro_torch.kernels import build
    from repro_torch.kernels.ne_round import ops, ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    build.load(*build.FAMILIES)
    print(f"phase 1: built {', '.join(build.FAMILIES)} (one nvcc each, "
          f"together) in {time.perf_counter() - t0:.2f} s", flush=True)
    for fam in build.FAMILIES:
        for line in build.build_logs.get(fam, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {fam}: {line.strip()}", file=sys.stderr)

    # the main path's graph: RMAT, Graph500 (a, b, c, d), seed 1
    t0 = time.perf_counter()
    edges = rmat_edges(args.scale, EDGE_FACTOR, seed=1)
    g = from_edges(edges, num_vertices=1 << args.scale, device=dev)
    del edges
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n, m = g.num_vertices, g.num_edges
    print(f"phase 1: RMAT scale {args.scale} EF {EDGE_FACTOR}: "
          f"N={n} M={m} (host generation + CSR + copy {gen_s:.2f} s)",
          flush=True)

    cfg = tp.NEConfig(num_partitions=PARTITIONS).clamped(n)
    p_num = cfg.num_partitions
    ce = min(cfg.edge_chunk, m)
    ptxas_report(build, "ne_round", ("claim_kernel", "select_scan_kernel",
                                     "select_pass_kernel",
                                     "select_finish_kernel",
                                     "restart_draw_kernel", "two_hop_kernel",
                                     "unpack_vec_kernel", "pack_vec_kernel",
                                     "or_vec_kernel"),
                 "phase 2")
    tool = cuobjdump()
    draw_sass = None if tool is None else sass_counts(
        tool, build, "ne_round", "restart_draw_kernel",
        ("IMAD.IADD", "IMAD", "IADD3", "LOP3", "SHF"))
    print(f"phase 2: restart_draw_kernel instructions ({tool} -sass): "
          f"{draw_sass if tool else 'no cuobjdump found, not counted'}",
          flush=True)
    phase_kernels(torch, ops, ref, g, dev, p_num, 8, cfg.k_sel)
    phase_two_hop_kernel(torch, ops, ref, g, dev, p_num, ce)
    phase_bit_kernels(torch, ops, ref, n, dev, p_num, ce)

    # --- phase 3: the single-controller path --------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = tp.partition(g, cfg)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    limit = alpha_limit(cfg.alpha, m, p_num)
    ep = res.edge_part
    st = res.stats
    rf_bound = theorem1_upper_bound(n, m, p_num)
    per_round = wall / max(res.rounds, 1)
    print(f"phase 3: partition P={p_num}: rounds={res.rounds} "
          f"leftover={res.leftover} RF={st.replication_factor!r} "
          f"EB={st.edge_balance!r} VB={st.vertex_balance!r} "
          f"wall={wall!r} s per_round={per_round!r} s "
          f"peak_mem={peak} B launches={launches}", flush=True)
    check(bool((ep >= 0).all()), "unassigned edges")
    check(np.array_equal(res.edges_per_part,
                         np.bincount(ep, minlength=p_num)),
          "edges_per_part disagrees with bincount(edge_part)")
    check(int(res.edges_per_part.max()) <= limit + 1,
          f"max |E_p| {int(res.edges_per_part.max())} > limit + 1")
    check(st.replication_factor <= rf_bound,
          f"RF {st.replication_factor} > Theorem 1 bound {rf_bound}")
    chunks = -(-m // ce)                              # two-hop chunks
    check(all(launches[k] == res.rounds for k in (
              "select", "restart_draw", "one_hop", "claim_scatter"))
          and launches["two_hop_best"] == res.rounds * chunks
          and all(launches[k] == 0 for k in BIT_KERNELS) and res.rounds > 0,
          f"launch counts {launches} do not match {res.rounds} rounds")

    # --- phase 3b: the SPMD path, world 1 on the card -----------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with compat.world1("nccl"):
        ops.reset_launches()
        t0 = time.perf_counter()
        res_sm = sm.partition_spmd(g, cfg)
        wall_sm = time.perf_counter() - t0
        launches_sm = dict(ops.launches)
    peak_sm = torch.cuda.max_memory_allocated()
    rounds = res_sm.rounds
    want = {"select": rounds, "restart_draw": rounds, "one_hop": rounds,
            "claim_scatter": rounds, "pack_bits": 2 * rounds,
            "or_words": 2 * rounds, "unpack_bits": rounds,
            "two_hop_best": rounds * chunks}          # shard = M at world 1
    print(f"phase 3b: partition_spmd world 1 P={p_num}: rounds={rounds} "
          f"leftover={res_sm.leftover} "
          f"RF={res_sm.stats.replication_factor!r} wall={wall_sm!r} s "
          f"per_round={wall_sm / max(rounds, 1)!r} s peak_mem={peak_sm} B "
          f"launches={launches_sm}", flush=True)
    check(same_result(np, res_sm, res),
          "SPMD world-1 result differs from the single controller's")
    check(launches_sm == want and rounds > 0,
          f"SPMD launch counts {launches_sm} are not {want}")
    print("phase 3b: SPMD == single controller bit for bit; launch counts "
          "match the formulas", flush=True)

    # --- phase 4: card == CPU at a small scale ------------------------------
    small = rmat_edges(args.check_scale, EDGE_FACTOR, seed=1)
    n_small = 1 << args.check_scale
    g_gpu = from_edges(small, n_small, device=dev)
    g_cpu = from_edges(small, n_small, device="cpu")
    runs = {}
    t0 = time.perf_counter()
    runs["single card"] = tp.partition(g_gpu, cfg)
    runs["single CPU"] = tp.partition(g_cpu, cfg)
    with compat.world1("nccl"):
        runs["SPMD card"] = sm.partition_spmd(g_gpu, cfg)
    with compat.world1("gloo"):
        runs["SPMD CPU"] = sm.partition_spmd(g_cpu, cfg, device="cpu")
    for name, r in runs.items():
        check(same_result(np, r, runs["single card"]),
              f"scale-{args.check_scale} {name} run differs from the "
              "single-controller card run")
    print(f"phase 4: scale {args.check_scale}: single card == single CPU == "
          f"SPMD card == SPMD CPU bit for bit (rounds="
          f"{runs['single card'].rounds}, all four in "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)

    # --- phase 5: kernel times on real rounds' inputs -----------------------
    state = tp.ne_init_state(g, cfg)
    while int(state.rounds) < args.time_round and not tp.ne_done(state, cfg):
        state = tp.ne_round_step(g, cfg, limit, state)
    profile_round(torch, f"phase 5: profiled single-controller round "
                  f"{int(state.rounds)}",
                  lambda: tp.ne_round_step(
                      g, cfg, limit, tp.NEState(*(t.clone() for t in state))))
    rows = phase_times(torch, tp, ops, ref, g, cfg, limit, state, args.reps)
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] == "restart_draw":
            r["sass"] = draw_sass
    del state
    with compat.world1("nccl"):
        st_sm, u, v, mask = spmd_rounds(torch, sm, g, cfg, limit,
                                        args.time_round)
        profile_round(torch, f"phase 5: profiled SPMD round "
                      f"{int(st_sm.rounds)}",
                      lambda: sm.spmd_round_step(cfg, limit, n, u, v, mask,
                                                 st_sm))
    bit_rows, words_keys = phase_spmd_times(torch, tp, sm, ops, ref, u, v, n,
                                            cfg, limit, st_sm, args.reps)
    for r in bit_rows:
        r["launches"] = launches_sm[r["name"]]
    if tool is not None:       # 16-byte loads and stores the kernels issue
        for r, kern in zip(bit_rows[1:], ("unpack_vec_kernel",
                                          "or_vec_kernel")):
            r["sass"] = sass_counts(tool, build, "ne_round", kern,
                                    ("LDG.E.128", "LDG.E.CONSTANT",
                                     "STG.E.128"))
            print(f"phase 5: {kern} instructions ({tool} -sass): "
                  f"{r['sass']}", flush=True)
    row = next(r for r in rows if r["name"] == "two_hop_best")
    row.update(words_keys, launches_spmd=launches_sm["two_hop_best"])
    main_edges = g.edges.cpu().numpy()       # phase 9 writes them to a file
    del st_sm, u, v, mask, g

    # --- phase 6: GIN training over the vertex-cut engine -------------------
    spmm_row = phase_gnn(torch, np, compat, ops, args)

    # --- phases 7 and 8: DeepFM and smollm-135m serving ---------------------
    t0 = time.perf_counter()
    bag_row = phase_deepfm(torch, args)
    flash_row = phase_lm(torch, args)
    print(f"phases 7-8: {time.perf_counter() - t0:.1f} s", flush=True)

    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # --- phase 9: the driver from the store, killed and resumed ---------
        launches_drv, ef = phase_driver(torch, np, main_edges, res,
                                        wall_sm / max(rounds, 1), chunks,
                                        dev, args.scale, work)
        for r in rows + bit_rows:
            r["launches_driver"] = launches_drv[r["name"]]
        del main_edges, res

        # --- phase 10: baselines and hybrid ----------------------------------
        t0 = time.perf_counter()
        ptxas_report(build, "stream", ("hdrf_kernel", "oblivious_kernel"),
                     "phase 10")
        err = phase_stream_kernels(torch, dev)
        graphs, q_rows, q_counts = phase_quality(torch, np, dev, work)
        stream = stream_cells(torch, graphs, q_counts, err)
        phase_hybrid_scale(torch, np, ef, dev)
        phase_hybrid_driver(torch, np, graphs, q_rows, dev, work)
        print(f"phase 10: took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"the script: {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": rows + bit_rows + [spmm_row, bag_row,
                                                   flash_row] + stream}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
