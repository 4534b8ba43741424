#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Distributed NE on one NVIDIA card.

    python3 chip_smoke.py                 # the full run (RMAT scale 22)
    python3 chip_smoke.py --scale 16      # a quicker rehearsal of 1-6, 9

Phases, each printing its lines; any failed check exits non-zero:

1. the device (name and power limit from nvidia-smi) and the time to
   build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (their
   nvcc processes run while the host draws the main path's RMAT edges;
   ``core.graph.from_edges`` builds the canonical form and the CSR on
   the card);
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
4. the scale-14 Graph built on the card equal to the host build, then
   ``partition`` at RMAT scale 14 on the card and on the CPU (plain
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
9. multi-controller runs from the store: phase 3's canonical edge list
   written as an EdgeFile; (a) ``python -m
   repro_torch.tools.launch_multihost`` with one worker on the card (a
   world-1 NCCL group): each rank's block range ingested through an
   exchange dir, a multi-writer snapshot every rounds / 8 rounds, traced
   and with the live bus, the worker killed (exit 17) after the fourth
   snapshot; the launcher must return 17 and ``monitor_run --once`` on
   its bus 4 (STALLED); (b) the gang resumed from the newest snapshot to
   the fixed point with ``REPRO_FORBID_EDGE_PART_MATERIALIZE`` set and
   ``--artifact-out`` (the sharded finalize, the multi-writer artifact):
   the bus's done line must give phase 3's RF and EB, the artifact's
   manifest its rounds, the trace's launch counts the resumed rounds'
   (``launches_mh`` in the JSON rows 1-6); its round p50/p90/p99, the
   exchange ingest, snapshot, restore, finalize and artifact spans and
   peak memory from its trace (``obs.report``); (c) the single-writer
   spmd driver in this process (its ingest beside (b)) resumes from (b)'s
   seventh snapshot with the launch counts set to 0 just before and read
   just after (``launches_driver``): it must equal phase 3's result bit
   for bit (at scale 22: 448 rounds, RF 1.7922852039337158, EB
   1.10000089317367), its single-writer snapshots (as often as (b)'s:
   round 448 at scale 22) must have the bytes of (b)'s multi-writer step
   dirs, and its artifact must have (b)'s bytes, which are loaded back
   and must equal the run's result;
10. baselines and hybrid: (a) what the quality matrix does not reach:
   the stream kernels ``hdrf_scan`` and ``oblivious_scan`` against their
   plain versions (run on the CPU in a pool process beside phase 9) bit
   for bit and call to call on rmat(10, 8, seed 3): HDRF at P = 1, 4,
   16, 32, 33, 64 and 256 on its one-warp route and at 257 and a ragged
   1,500 on its block route, at lambda 0.5 and 2; Oblivious at P = 1, 4,
   33, 37 and 256 on its one-warp route and at 257 and 1,500 on its
   block route, at a limit every partition fills (the overflow rule); the
   registers of each stream kernel (ptxas); (b) the 32 rows of
   ``BENCH_QUALITY.json``'s fast matrix (``repro_torch.tools.quality``:
   RMAT scale 14 and the ingested power-law ``real`` graph, P = 4 and
   16, NE, the hybrid at tau 0.5 and 0.25, the five baselines) each
   equal to its expected (rf, eb, vb), with the launch counts set to 0
   just before and read just after; then each stream kernel at every
   cell of that matrix on the baselines' own inputs: the wrapper's
   route, its time, the launch's alone and its fills' apart (CUDA
   events), the bound, and on ``real`` (P = 4 and 16) the kernel against
   its plain
   version bit for bit, the plain version run on the CPU in a pool
   process beside phase 9 (at (real, P = 16) HDRF's also on the card over
   the stream's first 8,192 edges, bits equal to the CPU's) with its
   time; (c)
   ``partition_hybrid`` from phase 9's EdgeFile at P = 64, tau = 0.25
   (the split streamed on the host, the rounds on the card), counts set
   to 0 just before and read just after (one ``select`` and one
   ``restart_draw`` a round, ``two_hop_best`` once a two-hop chunk), its
   obs spans (split, rounds, finalize), theta, M_low, peak memory and
   invariants; (d) ``PartitionDriver`` in hybrid mode on the scale-14
   RMAT graph at P = 16, snapshots every 8 rounds, stopped at round 24
   and resumed in this process: (b)'s run bit for bit, and the artifact
   round trip;
11. the engine's other consumers: (a) PageRank (30 supersteps), SSSP
   (from the hub) and WCC over a one-part ShardedGraph of phase 3's graph
   in a world-1 NCCL group, against scipy oracles of the reference's
   formulas in float64 (PageRank within 1e-4 of the largest rank, SSSP
   and WCC exact), with the host build time, ms a superstep, supersteps,
   a profiled PageRank run and peak memory; (b) paper Table 5
   (``benchmarks/bench_apps.py``): BA(8000, 5, seed 11) at P = 8
   partitioned by NE on the card (launch counts set to 0 just before and
   read just after; equal to the CPU's), ``random_1d`` and ``grid_2d``,
   each one's RF and 30-superstep PageRank wire bytes
   (``comm_volume_model``), equal to 2 · comm_slots · 4 · 30 of the
   8-part ShardedGraph; (c) ``redistribute_edges`` at world 1 on the card
   over phase 3b's shards with a one-part and phase 3's 64-part
   assignment, equal to the host path; (d) PNA (4 x 75), EGNN (4 x 64)
   and EquiformerV2 (12 layers, d 128, l_max 6, m_max 2, 8 heads) at full
   width over the engine on phase 6's graph with seeded positions: the
   engine loss against the plain model's on the card, the loss and
   gradients on the card against the CPU's (gloo; EquiformerV2 with 1 of
   its layers), 20 ``train_step``s each (EquiformerV2: 5) with finite
   losses, ms a step, a profiled step and peak memory (no kernel of the
   port launched);
12. training, with the backward kernels: (a) ``embedding_bag_backward``
   against its plain version on the card at DeepFM's train calls (B
   65,536 bags of 39 ids; the table, D 10, and w1, D 1; also bit for bit
   the CPU's in-order float32 sum; a call's kernels from its profile:
   ``tile_kernel`` and no ``zero_kernel``, the sort's device time) and
   ``flash_attention_backward`` at
   smollm-135m's train shape (B 8, S 4,096, 9 heads over 3, D 64, bf16,
   causal) on its tensor-core route ("mma", P and dS as bf16 hi + lo;
   HMMA / HGMMA counted in its kernels by ``cuobjdump -sass``, none
   fails), at a float32 shape on its "fma" route and at every head dim
   (bf16, ragged S 300, causal and not), each the same bits call to
   call, with their times beside their bounds, the plain
   versions' and the library's backward (``F.embedding_bag``,
   ``F.scaled_dot_product_attention`` over repeated kv heads); (b) DeepFM
   at full width (phase 7's seeded parameters) through
   ``make_recsys_step`` at train_batch, 20 steps with the counts set to 0
   just before and read just after (2 bag and 2 bag-backward launches a
   step), ms a step, rows/s, a profiled step, peak memory, and 3 card
   steps against 3 CPU steps at 1,024 rows a field; (c) smollm-135m at
   full width and depth in bf16 (remat "dots") at train_4k's S 4,096
   with the batch cut to 8, 10 steps through ``launch.train``'s function
   (``--full``; a step 60 flash launches, the forward's and remat's
   recompute, and 30 backward), ms a step, tokens/s, a profiled step,
   peak memory, and 3 card steps against 3 CPU steps in float32 at its
   width with 2 layers, S 256, B 2; then one bf16 step at that size under
   remat none, dots and full from the same state, equal bit for bit
   (L, 2L and 2L forward flash launches); (d) the trainer killed and resumed:
   a child process (``--train-child``) trains DeepFM (65,536 rows a
   field) and smollm's width with 2 layers (bf16) to their checkpoints at
   step 3 and is SIGKILLed; this process resumes each to step 6 and must
   equal an uninterrupted 6-step run bit for bit, all under
   ``torch.use_deterministic_algorithms(True)``; (e) one smoke
   ``make_step`` train step of every ported arch on the card against the
   CPU (the MoE LMs' CPU step replaying the card's tied router choices);
   (f) ``psum_compressed`` at world 1 on the card (NCCL) == the CPU
   (gloo) bit for bit.  The two backward rows join the kernels line;
13. olmoe-1b-7b serving at full width in bf16 (16 layers, d 2,048, 16
   heads of 128 over 16 kv heads, 64 experts of 1,024, top-8; 6.92 B
   seeded random parameters made on the card, 13.8 GB): (a) the
   ``flash_attention`` kernel at its attention's shapes against its plain
   version and bit for bit call to call, on the tensor-core route at
   prefills of 333 and 4,096 tokens and at one 32,768-token layer, on the
   split-KV route at decode_32k's shape at batch 8 (one chunk, a chunk
   boundary, a key past it, all 32 chunks); (b) one MoE layer and (c)
   the model with 2 of its 16 layers, in float32 on the card against the
   CPU (a prefill and 8 teacher-forced decode steps), within 1e-4 of the
   largest value, the router's choices equal wherever they do not tie
   within 1e-4 of a row's largest probability, and where they tie the
   CPU takes the card's, each named; (d) at full depth ``serve_batch`` of
   8 prompts of 64 tokens with 32 new ones (16 x 95 flash launches),
   prefill_32k at batch 1 (cut from 32) and one decode_32k step at batch
   8 (cut from 128: a 34.4 GB cache; 16 flash and 16 combine launches),
   each with its counts set to 0 just before and read just after, its ms,
   tokens/s, a profiled step's busy share and peak memory beside its
   bound (every expert's weights and the cache read once; the experts'
   products at capacity, the causal attention, the projections); then
   the kernel's times at its prefill_32k and decode_32k layers (D 128)
   beside its bound, the plain version's and SDPA's, a row of its own
   in the kernels line.  It runs right after phase 8: late in a full run
   torch.profiler returned no device events for whole windows of the
   flash kernel's and SDPA's calls;
14. the partition-serving layer (``repro_torch.serve``, numpy and the
   standard library: no kernel, no device) over phase 9 (b)'s artifact,
   with ``benchmarks/bench_serve.py``'s traffic (Zipf a 1.3, seed 1,
   over the non-isolated vertices).  Right after phase 9 a 2-member
   HTTP gang (``launch_serving_gang``, cache 256, batch 0, the live bus
   on) and a pool process's single-process ``ShardStore`` over all 64
   partitions (64 rows a shard) build beside phases 10-11; the mean
   replica count equals the artifact's and phase 3's RF, and phase 3's
   edge list gives the oracle of 512 distinct Zipf targets and 512
   boundary vertices (seed 2).  After phase 11: (a) 20,000 queries in
   the single process, cache on and off (mean, p50, p99, hit ratio,
   decodes; the cache-on p99 below the cache-off p99); (b) the gang's
   time to ready and 2,000 queries through ``GangClient`` (QPS, p50,
   p99, the fan-out histogram beside the replica counts).  Each checked
   vertex's neighbors and degree, in the single process and through the
   gang, equal the oracle; fan-out equals the replica count in the full
   store and is at most it through the gang; features through the gang
   are ``vertex_features``' bytes; the 2-hop set and ppr (eps 1e-3) of 4
   boundary vertices of degree <= 8 through the gang equal the single
   process's (``==``); ``/health``, ``/metrics``, the live bus's serve
   rows, a terminated member found by ``poll_dead()``, and no member
   left after ``close()``;
15. the device mesh and the sharded steps (``launch.mesh.make_host_mesh(1)``:
   a world-1 NCCL group, mesh (1, 1) over ("data", "model")), each against
   its mesh-free step bit for bit: (a) olmoe-1b-7b train_4k at full width
   with 4 of its 16 layers (bf16, S 4,096, B 4, cut from 8: at 8 the step ran out of the 80 GB; 1.89 B
   parameters), 5
   steps through the mesh step (expert parallelism and data parallelism
   under ``mesh_context``) with the counts set to 0 just before and read
   just after (2L forward and L backward flash launches a step), loss,
   grad norm, parameters, m and v equal to the mesh-free steps', ms a
   step (the median of the steps after the first, each way), tokens/s
   and peak memory; one card-against-CPU step through the mesh step in
   float32 with 2 layers (the CPU replaying the card's tied router
   choices; its CPU step runs in a thread beside (b), (c) and phase 9,
   and is compared after phase 9); (b) split-KV across ranks at olmoe's
   decode_32k layer (B 8, 16 kv heads, D 128, 32,768 rows): the cache
   cut into 1, 2 and 4 slices, each slice's partial (float32 rows and
   LSE) by the flash kernel against its plain version, merged by
   ``merge_kernel``, kv_len inside the last slice, at a slice boundary
   and inside the first (later slices empty), and with one quarter's
   keys doubled (slices of clearly different LSEs): the merge against its
   plain version and against the whole-cache call (bit for bit at one
   slice), and merges with wrong weights must miss the whole-cache call;
   its times beside its bound, a row in the kernels line; then olmoe's
   decode_32k step (4 layers, B 8) through the mesh (its rules cut no
   sequence at world 1: the single-card attention) and through
   ``Transformer.decode`` with the cache's sequence over ("data",
   "model") (split-KV, one slice: one partial and one merge a layer,
   counted), each against the mesh-free step; (c) DeepFM train_batch at
   full width and GIN full_graph_sm through the mesh against their
   mesh-free steps (the embedding_bag kernels and block_spmm on the
   sharded path, their launches equal).

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
from concurrent.futures import ThreadPoolExecutor

# cuBLAS's workspace as the card's default (32 MiB on Hopper), named so
# that torch's deterministic mode (phase 12 (d)) accepts cuBLAS calls; set
# before torch starts, for this process and its children
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# phase 9: a snapshot every (phase 3's rounds) / 8 rounds, the gang killed
# after the fourth (rounds 56-224 of 448 at scale 22), resumed to the end,
# and the single-writer driver resumed from the seventh (round 392); both
# must give the main path's rounds, RF and EB at scale 22 (PERF.md §5)
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
    # backward kernels with no TPU kernel: XLA's gradients of the
    # reference's DeepFM gathers and of train_4k's full_attention branch
    "embedding_bag_backward": "src/repro/models/recsys/deepfm.py:58",
    "flash_attention_backward": "src/repro/models/lm/transformer.py:175",
    # lax.scan loops, not Pallas kernels: XLA runs them one edge a step
    "hdrf_scan": "src/repro/core/baselines.py:56",
    "oblivious_scan": "src/repro/core/baselines.py:100",
    # no TPU kernel: GSPMD splits the reference's decode softmax over a
    # sequence-sharded cache; the merge of the ranks' partials is its step
    "flash_attention_merge": "src/repro/models/lm/transformer.py:237",
}
BIT_KERNELS = ("pack_bits", "unpack_bits", "or_words")
# phase 10: the baselines' stream kernels, the quality matrix, the hybrid
STREAM_SOURCE = "src/repro_torch/kernels/stream/csrc/stream.cu"
STREAM_KERNELS = ("hdrf_scan", "oblivious_scan")
# the CUDA kernels of each, by route ("warp" for P <= 256, else "block")
STREAM_CUDA = {"hdrf_scan": ["hdrf_warp_kernel<W>", "hdrf_kernel"],
               "oblivious_scan": ["oblivious_warp_kernel<W>",
                                  "oblivious_kernel"]}
STREAM_CHECK_GRAPH = (10, 8, 3)    # (a): rmat(scale, edge factor, seed)
# (a)'s HDRF: the warp route at 1 to 8 words a vertex (33: a ragged 2nd
# word), the block route above 256 (1,500: a ragged last warp)
STREAM_HDRF_PARTS = (1, 4, 16, 32, 33, 64, 256, 257, 1500)
# (a)'s Oblivious: the warp route at 1 to 8 words (33, 37: ragged words),
# the block route above 256
STREAM_OBLIVIOUS_PARTS = (1, 4, 33, 37, 256, 257, 1500)
STREAM_LAMBDAS = (0.5, 2.0)        # (a)'s HDRF; the matrix runs lambda 1
STREAM_PLAIN_GRAPH = "real"        # the matrix's cells held against plain
STREAM_ROW_P = 16                  # the JSON rows' cell (real, P = 16)
# the plain loops run on the CPU (float32 steps, the card's bits); at this
# cell also on the card, whose bits the CPU's must equal
STREAM_PLAIN_CARD = ("hdrf_scan", 16)
# ... over the stream's first edges only (a stream scan's first k results
# are its run on the first k edges): ~0.5 ms an edge there
STREAM_PLAIN_CARD_EDGES = 8192
CLOCK_HZ = 1.98e9                  # H100 SXM boost clock (INT32_OPS's)
HYBRID_TAU = 0.25                  # (c) and (d): the tightest budget
HYBRID_DRIVER = ("rmat_s14_ef16", 16, 8, 24)   # graph, P, every, stop
# phase 11: the GAS apps and paper Table 5 (benchmarks/bench_apps.py:32-45)
APP_PR_ITERS = 30                  # PageRank supersteps (bench_apps.py:45)
APP_DAMPING = 0.85
# PageRank against float64 scipy: float32 sums by atomics, in no fixed
# order; a vertex's rank sums its degree's terms, whose rounding spreads
# ~sqrt(d) 2^-24 of it (2.4e-5 at the hub's 162,781, scale 22): each
# vertex within 1e-4 of its own rank
APP_PR_TOL = 1e-4
APP_REPS = 3                       # timed calls of each app, the least kept
TABLE5_GRAPH = (8000, 5, 11)       # barabasi_albert(n, m, seed)
TABLE5_P = 8
# (d): PNA, EGNN, EquiformerV2 at full width over the engine
FAMILY_STEPS = 20
EQV2_STEPS = 5                     # EquiformerV2's (~1.1 s a step)
EQV2_CPU_LAYERS = 1                # of 12, for the card-against-CPU check
# card against CPU: float32 sums in another order, a loss to 1e-5
# relative, a gradient leaf to 1e-5 of its largest entry.  PNA is
# compared in float64 at PNA_SEEDS parameter seeds: in float32 its max
# and min pick another message where two lie within a rounding of each
# other, and its std's clamp of sq/cnt - mean² decides by a rounding, so
# a sound card's float32 gradients differ from the CPU's by 8.2e-3 of a
# leaf's largest at one seed (PERF.md).  In float64 no such near tie is
# met; its sums in another order magnified as float32's are (~600x from
# 2^-24 to 3.5e-5) stay near 1e-13, held to 1e-10
FAMILY_LOSS_RTOL = 1e-5
FAMILY_GRAD_TOL = 1e-5
PNA_GRAD_TOL = 1e-10
PNA_SEEDS = 4
# phase 12: training
TRAIN_DEEPFM_STEPS = 20            # (b) at train_batch, B 65,536
TRAIN_LM_STEPS = 10                # (c) smollm-135m at S 4,096, B 8
TRAIN_CHECK_STEPS = 3              # card against CPU
DEEPFM_CHECK_ROWS = 1024           # (b)'s check: rows a field
DEEPFM_CHECK_BATCH = 8192
LM_CHECK = (2, 256, 2)             # (c)'s check: layers, S, B (float32)
REMAT_CHECK = (2, 256, 2)          # (c)'s remat check: layers, S, B (bf16)
REMAT_MODES = ("none", "dots", "full")
FLASH_TRAIN = (8, 4096, 9, 3, 64)  # B, S, H, HK, D of (c)'s attention
RESUME_K = 3                       # (d): checkpoint at k, kill, resume to 2k
RESUME_MODELS = ("deepfm", "lm")
RESUME_ROWS = 65536                # (d)'s DeepFM: rows a field
RESUME_BATCH = 4096
RESUME_LM = (2, 512, 2)            # (d)'s LM: layers, S, B (bf16)
# phase 14: serving phase 9's artifact, benchmarks/bench_serve.py's traffic
SERVE_QUERIES = 20000              # (a)'s Zipf stream (bench_serve.py:88)
SERVE_GANG_QUERIES = 2000          # (b): its first 2,000 (bench_serve.py:171)
SERVE_ZIPF = (1.3, 1)              # Zipf a, seed (bench_serve.py:33, :102)
SERVE_ROWS = 64                    # (a)'s rows a shard (bench_serve.py:105)
SERVE_CACHE = 256                  # decoded shards kept (bench_serve.py:104)
SERVE_GROUPS = 2                   # the gang's members (bench_serve.py:166)
SERVE_PROBE = (512, 2)             # checked Zipf heads and boundary draws;
#                                    the draw's seed (bench_serve.py:115)
SERVE_WALKS = (4, 8, 8192)         # traversals: boundary vertices of degree
#                                    <= 8, the first of 8,192 drawn
SERVE_PPR_EPS = 1e-3               # bench_serve.py:156
SERVE_READY_S = 600                # the gang's builds run beside phases 10-11
SERVE_CHECK_THREADS = 4            # clients checking the gang against oracle
MESH_LAYERS = 4                    # phase 15 (a): olmoe's layers (of 16)
MESH_BATCH = 4                     # (a): train_4k's S 4,096, FULL_BATCH cut to 4
MESH_STEPS = 5                     # (a) and (c): steps each way, the
#                                    median of the last 4 timed
MESH_CHECK = (2, 64, 1)            # (a)'s card-vs-CPU step: layers, S, B
MESH_CHECK_THREADS = 4             # its CPU step's threads, beside phase 9
SPLIT_RANKS = (1, 2, 4)            # (b): slices of the decode_32k cache
SPLIT_DECODE_LEN = 20000           # (b): the decode step's cache_len


def timed_build(build) -> float:
    """Build every kernel family (one nvcc each, all together); returns
    the seconds it took."""
    t0 = time.perf_counter()
    build.load(*build.FAMILIES)
    return time.perf_counter() - t0


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
        if name == "one_hop":
            # three reads of its times; the row keeps the middle one
            reads = [(rows[-1]["ms"], rows[-1]["device_ms"])] + [
                (time_ms(kern, reps), device_ms(torch, kern, reps)[0])
                for _ in range(2)]
            ms_reads, dev_reads = (sorted(x) for x in zip(*reads))
            rows[-1].update(ms=ms_reads[1], device_ms=dev_reads[1],
                            ms_reads=ms_reads, device_ms_reads=dev_reads)
            print(f"phase 5: one_hop, three reads: ms {ms_reads}, device "
                  f"ms {dev_reads}; bound {bound[0]!r} ({bound[1]})",
                  flush=True)
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
                combines: int, plain=None) -> float:
    """The flash kernel against its plain version on the card in bfloat16:
    both compute in float32 and round once to bf16, in different orders:
    1e-5 + 2^-7 |plain| (one bf16 step).  A second call must give the same
    bits, each call one flash_attention launch and ``combines`` combine
    launches.  ``plain`` is ``faref.attention_ref`` unless given (the
    chunked one where the scores would not fit).  Returns the largest
    error."""
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
    plain = faref.attention_ref if plain is None else plain
    err, ok = within(got, plain(q, k, v, causal, kv_len), 2.0 ** -7, 1e-5)
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


def route_tape(torch, k: int, replay=None, tol: float = 1e-4):
    """A torch function mode over the MoE router's top-k (``moe.top_k``'s
    stable descending ``torch.sort``), as :func:`relu_tape` is over ReLU:
    it records each call's order and sorted probabilities on the host.
    Given ``replay`` (the card's record), the CPU takes the card's order
    after checking that each of the card's first ``k`` choices has a CPU
    probability within ``tol`` of the row's largest of the CPU's own
    choice at that place: a choice may differ only where two experts tie
    within the tolerance and the card's and the CPU's sums broke the tie
    apart.  Those rows are named in ``tied``; ``max_diff`` is the largest
    difference of a chosen probability, card against CPU."""
    from torch.overrides import TorchFunctionMode

    class Tape(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.orders, self.tied, self.max_diff = [], [], 0.0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is not torch.sort or not k:      # k 0: no MoE router
                return out
            i = len(self.orders)
            self.orders.append((out[0].detach().cpu(), out[1].cpu()))
            if replay is None:
                return out
            probs, (vals, own) = args[0], out
            card_vals, card = (t.to(probs.device) for t in replay.orders[i])
            theirs = probs.gather(-1, card)
            chosen = theirs[:, :k].detach()
            self.max_diff = max(self.max_diff, float(
                (chosen - card_vals[:, :k]).abs().max()))
            gap = (chosen - vals[:, :k].detach()).abs()
            scale = vals[:, :1].detach()
            check(bool((gap <= tol * scale).all()),
                  f"router call {i}: the card's choices differ from the "
                  f"CPU's by {float(gap.max())!r} of a probability, above "
                  f"{tol} of the row's largest")
            for r in torch.nonzero((own[:, :k] != card[:, :k]).any(-1)
                                   ).flatten().tolist():
                self.tied.append(
                    f"call {i} token {r}: card {card[r, :k].tolist()} CPU "
                    f"{own[r, :k].tolist()} (gap {float(gap[r].max())!r} "
                    f"of {float(scale[r, 0])!r})")
            return theirs, card

    return Tape()


def phase_lm_card_vs_cpu(torch, cfg, steps, dev, label="phase 8"):
    """Phase 8 and 13 (c): the model in float32 at full width on the card
    and on the CPU (plain attention), from the same parameters: the last
    position's logits of a 2 x 64-token prefill, then 8 decode steps that
    the CPU takes on the card's greedy tokens.  Logits within 1e-4 of the
    largest (float32 through the layers, sums in other orders); the CPU's
    greedy token must be the card's at every step whose top-2 margin is
    above that tolerance, and the steps where it is not are named.  An MoE
    model's CPU run takes the card's router choices where the two tie
    (:func:`route_tape`), and those are named too."""
    import copy

    from repro_torch.models.lm.transformer import Transformer

    tol = 1e-4
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    k = c32.moe.top_k if c32.moe is not None else 0
    card = Transformer(c32, torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    cpu = copy.deepcopy(card).to("cpu")
    tok = torch.randint(0, cfg.vocab, (2, 64),
                        generator=torch.Generator().manual_seed(82),
                        dtype=torch.int32)
    ties, route_diff = [], 0.0

    def pair(name, on_card, on_cpu):
        nonlocal route_diff
        tape = route_tape(torch, k)
        with tape:
            got = on_card()
        rep = route_tape(torch, k, tape)
        with rep:
            want = on_cpu()
        ties.extend(f"{name} {t}" for t in rep.tied)
        route_diff = max(route_diff, rep.max_diff)
        return got, want

    def prefill(model, d):
        last, caches = steps.prefill_fn(model, tok.to(d))
        full = tuple(torch.zeros((c32.n_layers, 2, 72, c32.n_kv_heads,
                                  c32.hd), device=d) for _ in range(2))
        for f, c in zip(full, caches):
            f[:, :, :64] = c
        return last.cpu(), full

    runs = dict(zip(("card", "CPU"), pair("prefill",
                                          lambda: prefill(card, dev),
                                          lambda: prefill(cpu, "cpu"))))

    def close(got, want):
        scale = float(want.abs().max())
        err, ok = within(got, want, 0.0, tol * scale)
        return err / scale, ok

    err, ok = close(runs["card"][0], runs["CPU"][0])
    rows = [("prefill", err, ok, runs["card"][0], runs["CPU"][0])]
    nxt = runs["card"][0].argmax(-1).to(torch.int32)[:, None]
    for i in range(8):
        lc, lh = pair(f"decode {i}", lambda: steps.lm_serve_fn(
            card, nxt.to(dev), *runs["card"][1], 64 + i)[0],
            lambda: steps.lm_serve_fn(cpu, nxt, *runs["CPU"][1], 64 + i)[0])
        lc = lc[:, -1].cpu()
        lh = lh[:, -1]
        err, ok = close(lc, lh)
        rows.append((f"decode {i}", err, ok, lc, lh))
        nxt = lc.argmax(-1).to(torch.int32)[:, None]
    near = []
    for name, err, ok, lc, lh in rows:
        check(ok, f"{label}: card vs CPU logits at {name}: {err!r} > {tol}")
        scale = float(lh.abs().max())
        margin = top2_margin(lh)
        same = lc.argmax(-1) == lh.argmax(-1)
        tied = margin <= tol * scale
        check(bool((same | tied).all()),
              f"{label}: card vs CPU greedy tokens differ at {name} with a "
              f"clear margin: {margin.tolist()}")
        near += [f"{name} row {r} (margin {float(margin[r])!r})"
                 for r in torch.nonzero(tied).flatten().tolist()]
    routing = "" if not k else (
        f"; router choices equal wherever the margin is above {tol} of a "
        f"row's largest probability (chosen probabilities within "
        f"{route_diff!r}), tied choices the CPU took from the card: "
        f"{ties or 'none'}")
    print(f"{label}: card vs CPU (float32, full width, {c32.n_layers} "
          f"layers): logits max err / max {[r[1] for r in rows]} (tol "
          f"{tol}); greedy tokens equal wherever the top-2 margin is above "
          f"the tolerance; steps with a top-2 margin under the tolerance: "
          f"{near or 'none'}{routing}", flush=True)
    del card, cpu
    torch.cuda.empty_cache()
    return max(r[1] for r in rows)


def lm_bounds(cfg, dec_batch: int, dec_len: int, prefill_len: int) -> dict:
    """The least time (ms) of a decode step and of a prefill on the card:
    a decode step reads every weight once (an MoE layer runs all its
    experts on their capacity buffers, so all of them) and the cache's
    first ``dec_len`` rows of ``dec_batch`` sequences; a prefill of
    ``prefill_len`` tokens does the projections, the FFN (an MoE layer's
    experts at capacity: E · C slots), the causal attention's two
    products and the head at the bf16 rate, the float32 router at the
    FP32 rate.  Returns each part and the totals."""
    from repro_torch.models.lm.moe import capacity

    d, hd, h, hk, L = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                       cfg.n_layers)
    size = 2                                    # bf16
    attn_w = d * (h + 2 * hk) * hd + h * hd * d
    head_w = cfg.vocab * d
    t = prefill_len
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_expert
        ffn_w, router_w = e * 3 * d * f, d * e
        ffn_ops = 2 * 3 * d * f * e * capacity(t, cfg.moe)
    else:
        ffn_w, router_w = 3 * d * cfg.d_ff, 0
        ffn_ops = 2 * 3 * d * cfg.d_ff * t
    weights = L * (attn_w + ffn_w) * size + L * router_w * 4 \
        + head_w * size
    cache = 2 * L * dec_batch * dec_len * hk * hd * size
    parts = {
        "weights_ms": bound_ms(weights),
        "cache_ms": bound_ms(cache),
        "experts_ms" if cfg.moe is not None else "ffn_ms":
            L * ffn_ops / BF16_FLOPS * 1e3,
        "attention_ms": L * 4 * h * hd * (t * (t + 1) // 2)
        / BF16_FLOPS * 1e3,
        "projections_ms": (L * 2 * attn_w + 2 * head_w) * t
        / BF16_FLOPS * 1e3,
        "router_ms": L * 2 * router_w * t / FP32_FLOPS * 1e3}
    parts["decode_ms"] = parts["weights_ms"] + parts["cache_ms"]
    parts["prefill_ms"] = sum(v for k, v in parts.items() if k not in (
        "weights_ms", "cache_ms", "decode_ms"))
    return parts


def lm_serve_paths(torch, label, model, dec_batch: int):
    """The three serving paths of a full-width bf16 model, each with the
    launch counts set to 0 just before and read just after, its ms a step,
    tokens/s, peak memory and a profiled step (the device's busy share),
    beside the bounds of :func:`lm_bounds`: ``serve_batch`` of 8 prompts
    of 64 tokens with 32 new ones (cache 256; L x 95 flash launches);
    prefill_32k at batch 1 (cut from 32; L launches); one decode_32k step
    at batch ``dec_batch`` (cut from 128) on a seeded random cache (L
    flash and L combine launches).  Returns (serve_batch's flash launches,
    the decode cache (k, v))."""
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models.lm import serve

    dev = torch.device("cuda")
    cfg = model.cfg
    L = cfg.n_layers
    s = LM_SHAPES["prefill_32k"]["seq_len"]
    smax = LM_SHAPES["decode_32k"]["seq_len"]

    # --- main path 1: serve_batch, greedy ---------------------------------
    prompts = torch.randint(0, cfg.vocab, (8, 64),
                            generator=torch.Generator().manual_seed(83),
                            dtype=torch.int32).numpy()
    scfg = serve.ServeConfig(max_new_tokens=32, cache_len=256)
    n_steps = prompts.shape[1] - 1 + scfg.max_new_tokens
    serve_bound = lm_bounds(cfg, 8, (n_steps + 1) // 2, 1)  # mean rows
    serve.serve_batch(model, prompts[:, :2], dataclasses.replace(
        scfg, max_new_tokens=1))                          # warm-up, 2 steps
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = serve.serve_batch(model, prompts, scfg)
    wall = time.perf_counter() - t0
    counts = check_counts(f"{label} serve_batch",
                          {"flash_attention": L * n_steps})
    peak = torch.cuda.max_memory_allocated() - base
    check(out.shape == (8, 96) and (out[:, :64] == prompts).all()
          and ((out >= 0) & (out < cfg.vocab)).all(),
          f"serve_batch output {out.shape}")
    served = counts["flash_attention"]
    caches = tuple(torch.zeros((L, 8, scfg.cache_len, cfg.n_kv_heads,
                                cfg.hd), dtype=cfg.dtype, device=dev)
                   for _ in range(2))
    tok8 = torch.from_numpy(out[:, 64:65]).to(dev)
    profile_round(torch, f"{label}: profiled serve_batch decode step "
                  "(B=8, cache 256, position 80)",
                  lambda: steps.lm_serve_fn(model, tok8, *caches, 80),
                  top=8, host_top=8)
    del caches
    print(f"{label}: serve_batch 8 x 64 prompts, 32 new tokens, cache 256, "
          f"greedy: {wall!r} s, {wall / n_steps * 1e3!r} ms a step (bound "
          f"{serve_bound['decode_ms']!r}: weights {serve_bound['weights_ms']!r}"
          f" + cache), {8 * scfg.max_new_tokens / wall!r} new tokens/s, "
          f"{8 * n_steps / wall!r} tokens/s through the decode step; peak "
          f"{peak} B above the {base} B held; flash_attention launches "
          f"{served} = {L} x ({prompts.shape[1] - 1} + "
          f"{scfg.max_new_tokens})", flush=True)

    # --- main path 2: prefill_32k at batch 1 (cut from 32) ----------------
    bound = lm_bounds(cfg, dec_batch, smax, s)
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
    check_counts(f"{label} prefill_32k", {"flash_attention": L})
    peak = torch.cuda.max_memory_allocated() - base
    check(last.shape == (1, cfg.vocab) and bool(last.isfinite().all())
          and caches[0].shape == (L, 1, s, cfg.n_kv_heads, cfg.hd),
          "prefill_32k outputs")
    parts = ", ".join(f"{k[:-3]} {bound[k]!r}" for k in (
        "experts_ms" if cfg.moe is not None else "ffn_ms", "attention_ms",
        "projections_ms", "router_ms") if bound.get(k))
    print(f"{label}: prefill_32k batch 1 (cut from 32): {wall!r} s, "
          f"{s / wall!r} tokens/s (bound {bound['prefill_ms']!r} ms: "
          f"{parts}); peak {peak} B above the {base} B held; "
          f"flash_attention launches {L}", flush=True)
    del last, caches
    profile_round(torch, f"{label}: profiled prefill_32k",
                  lambda: steps.prefill_fn(model, tok), top=8)
    del tok
    torch.cuda.empty_cache()

    # --- main path 3: one decode step at decode_32k (batch cut from 128) --
    g = torch.Generator(device=dev).manual_seed(85)
    shape = (L, dec_batch, smax, cfg.n_kv_heads, cfg.hd)
    kc = torch.randn(shape, generator=g, device=dev, dtype=cfg.dtype)
    vc = torch.randn(shape, generator=g, device=dev, dtype=cfg.dtype)
    token = torch.randint(0, cfg.vocab, (dec_batch, 1), device=dev,
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
    check_counts(f"{label} decode_32k", {"flash_attention": L,
                                         "flash_attention_combine": L})
    peak = torch.cuda.max_memory_allocated() - base
    check(logits.shape == (dec_batch, 1, cfg.vocab) and new_len == smax
          and bool(logits.isfinite().all()), "decode_32k outputs")
    print(f"{label}: decode_32k one step, batch {dec_batch} (cut from 128), "
          f"cache {2 * kc.numel() * kc.element_size()} B: {wall * 1e3!r} ms "
          f"(bound {bound['decode_ms']!r}: weights {bound['weights_ms']!r} + "
          f"cache {bound['cache_ms']!r}), {dec_batch / wall!r} tokens/s; "
          f"peak {peak} B above the {base} B held; flash_attention launches "
          f"{L}, flash_attention_combine launches {L}", flush=True)
    profile_round(torch, f"{label}: profiled decode_32k step",
                  lambda: steps.lm_serve_fn(model, token, kc, vc, smax - 1),
                  top=8)
    return served, (kc, vc)


def flash_layer_times(torch, args, fa, faref, row, label, cfg, kc, vc):
    """The flash kernel's times at a prefill_32k layer (batch 1, causal)
    and at a decode_32k layer (one query a sequence against layer 0 of the
    cache ``kc``, ``vc``) at ``cfg``'s heads, beside its bound, the plain
    version's and ``F.scaled_dot_product_attention``'s (kv heads repeated
    for it), each checked against plain first; fills ``row``'s keys
    (``_decode_32k`` for the decode layer's)."""
    from repro_torch.configs.shapes import LM_SHAPES

    dev = torch.device("cuda")
    s = LM_SHAPES["prefill_32k"]["seq_len"]
    h, hk, d, b = cfg.n_heads, cfg.n_kv_heads, cfg.hd, kc.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(86)
    q = torch.randn((1, s, h, d), generator=gen, device=dev, dtype=cfg.dtype)
    k = torch.randn((1, s, hk, d), generator=gen, device=dev, dtype=cfg.dtype)
    v = torch.randn((1, s, hk, d), generator=gen, device=dev, dtype=cfg.dtype)
    dq = torch.randn((b, 1, h, d), generator=gen, device=dev,
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
        print(f"{label}: flash_attention == plain (bf16) at {name}: max abs "
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
        print(f"{label}: flash_attention at {name} layer (B={bq}, S={sq}, "
              f"T={t}, H={h}, HK={kk.shape[2]}, D={d}): ms "
              f"{row['ms' + tag]!r}, device_ms {row['device_ms' + tag]!r}, "
              f"bound {row['bound_ms' + tag]!r} ({row['bound_by' + tag]}), "
              f"plain "
              f"{'chunked ' if causal else ''}{row['plain_ms' + tag]!r}, "
              f"SDPA {row['library_ms' + tag]!r} (device_ms "
              f"{row['library_device_ms' + tag]!r})", flush=True)


def phase_lm(torch, args):
    """Phase 8: smollm-135m serving at full width in bf16 (30 layers,
    d_model 576, 9 heads over 3 kv heads, head_dim 64, d_ff 1,536, vocab
    49,152, tied), seeded random weights.  Returns flash_attention's row
    of the kernels line."""
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.launch import steps
    from repro_torch.models.lm.transformer import Transformer

    dev = torch.device("cuda")
    cfg = smollm_135m.CONFIG
    no_tf32(torch, "phase 8")
    worst = phase_lm_kernel(torch, fa, faref, dev)
    prefill_instructions(build)
    phase_lm_card_vs_cpu(torch, cfg, steps, dev)
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    nparam = sum(p.numel() for p in model.parameters())
    print(f"phase 8: {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads} HK={cfg.n_kv_heads} hd={cfg.hd} "
          f"d_ff={cfg.d_ff} V={cfg.vocab}: {nparam} bf16 parameters",
          flush=True)
    L = cfg.n_layers
    served, (kc, vc) = lm_serve_paths(torch, "phase 8", model, 32)
    row = {"name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
           "replaces": REPLACES["flash_attention"], "launches": served,
           "launches_prefill_32k": L, "launches_decode_32k": L,
           "combine_launches_decode_32k": L,
           "max_abs_err": worst}
    flash_layer_times(torch, args, fa, faref, row, "phase 8", cfg, kc, vc)
    del kc, vc, model
    torch.cuda.empty_cache()
    return row


def phase_moe_kernel(torch, fa, faref, cfg, dev) -> float:
    """Phase 13 (a): the flash kernel at olmoe-1b-7b's attention (D 128,
    16 query heads over 16 kv heads, bf16) against its plain version and
    bit for bit call to call (:func:`check_flash`): on the tensor-core
    route at a short prefill (333 and 4,096 tokens, causal) and at one
    32,768-token prefill_32k layer (against the chunked plain version);
    on the split-KV route at decode_32k's shape at batch 8 (one query
    against a 32,768-row cache) at kv_len 1 (one chunk), 1,024 (a chunk
    boundary), 1,025 (a key past it) and 32,768 (all 32 chunks).
    Returns the largest error."""
    gen = torch.Generator(device=dev).manual_seed(130)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def qkv(b, s, t):
        return tuple(torch.randn(shape, generator=gen, device=dev,
                                 dtype=torch.bfloat16)
                     for shape in ((b, s, h, d), (b, t, hk, d), (b, t, hk, d)))

    worst = 0.0
    for s in (333, 4096, 32768):
        plain = faref.attention_chunked_ref if s > 4096 else None
        err = check_flash(torch, fa, faref, f"olmoe prefill S=T={s}",
                          *qkv(1, s, s), True, None, 0, plain)
        worst = max(worst, err)
        print(f"phase 13 (a): flash_attention == plain (bf16, tensor cores) "
              f"at olmoe's prefill S=T={s}, H=HK={h}, D={d}: max abs err "
              f"{err!r} (tol 1e-5 + 2^-7|plain|)", flush=True)
    q, k, v = qkv(8, 1, 32768)
    for kv_len in (1, fa.DECODE_CHUNK, fa.DECODE_CHUNK + 1, 32768):
        chunks = fa.split_chunks(torch.bfloat16, 1, h // hk, kv_len, False)
        err = check_flash(torch, fa, faref,
                          f"olmoe decode B=8 T=32768 kv_len={kv_len}", q, k,
                          v, False, kv_len, int(chunks > 1))
        worst = max(worst, err)
        print(f"phase 13 (a): flash_attention == plain (bf16, split-KV, "
              f"{chunks} chunks) at olmoe's decode_32k B=8 kv_len={kv_len}: "
              f"max abs err {err!r} (tol 1e-5 + 2^-7|plain|)", flush=True)
    return worst


def phase_moe_layer(torch, cfg, dev) -> None:
    """Phase 13 (b): one MoE layer at olmoe-1b-7b's full width (d 2,048,
    64 experts of d_expert 1,024, top-8) in float32 on the card and on the
    CPU from the same parameters (seeded, made on the card) and the same
    2 x 64 hidden states: capacity 20 an expert, so tokens overflow.
    The router's choices must be equal wherever they do not tie within
    1e-4 of a row's largest probability; where they tie the CPU takes the
    card's (:func:`route_tape`) and the choices are named; then the
    outputs within 1e-4 of the largest and the load-balance loss within
    1e-4 of itself."""
    from repro_torch.models.lm import moe

    tol = 1e-4
    mc = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(131)
    p = {k: w[0] for k, w in moe.init_moe(gen, 1, cfg.d_model, mc,
                                           torch.float32, dev).items()}
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=dev)
    tape = route_tape(torch, mc.top_k)
    with tape:
        y, aux = moe.moe_block(p, x, mc)
    rep = route_tape(torch, mc.top_k, tape)
    with rep:
        yh, auxh = moe.moe_block({k: w.cpu() for k, w in p.items()}, x.cpu(),
                                 mc)
    scale = float(yh.abs().max())
    err, ok = within(y.cpu(), yh, 0.0, tol * scale)
    check(ok, f"phase 13 (b): the MoE layer's output on the card differs "
          f"from the CPU's by {err!r} of a largest {scale!r}")
    aux_err = abs(float(aux) - float(auxh))
    check(aux_err <= tol * float(auxh),
          f"phase 13 (b): aux {float(aux)!r} on the card, {float(auxh)!r} "
          f"on the CPU")
    cap = moe.capacity(128, mc)
    print(f"phase 13 (b): one MoE layer (float32, d {cfg.d_model}, "
          f"{mc.n_experts} experts x {mc.d_expert}, top-{mc.top_k}, 2 x 64 "
          f"tokens, capacity {cap}): card == CPU, outputs max err / max "
          f"{err / scale!r}, aux {float(aux)!r} (CPU {float(auxh)!r}); "
          f"router choices equal wherever the margin is above {tol} of a "
          f"row's largest probability (chosen probabilities within "
          f"{rep.max_diff!r}); tied choices the CPU took from the card: "
          f"{rep.tied or 'none'}", flush=True)


def phase_moe(torch, args):
    """Phase 13: olmoe-1b-7b serving at full width in bf16 (16 layers,
    d_model 2,048, 16 heads of 128 over 16 kv heads, 64 experts of
    d_expert 1,024, top-8, vocab 50,304, untied; 6.92 B parameters, 13.8
    GB), seeded random weights made on the card: (a) the flash kernel at
    its attention's shapes, (b) one MoE layer and (c) the model with 2 of
    its 16 layers in float32, card against CPU, (d) the three serving
    paths at full depth (:func:`lm_serve_paths`, the decode_32k step at
    batch 8: a 34.4 GB cache) beside their bounds, and the flash kernel's
    times at its prefill_32k and decode_32k layers.  Returns the flash
    kernel's row for this model."""
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.launch import steps
    from repro_torch.models.lm.transformer import Transformer

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = olmoe_1b_7b.CONFIG
    no_tf32(torch, "phase 13")
    worst = phase_moe_kernel(torch, fa, faref, cfg, dev)
    phase_moe_layer(torch, cfg, dev)
    phase_lm_card_vs_cpu(torch, dataclasses.replace(cfg, n_layers=2), steps,
                         dev, "phase 13 (c)")
    print(f"phase 13 (a)-(c): {time.perf_counter() - t0:.1f} s", flush=True)
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    nparam = sum(p.numel() for p in model.parameters())
    print(f"phase 13 (d): {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads} HK={cfg.n_kv_heads} hd={cfg.hd} E="
          f"{cfg.moe.n_experts} top-{cfg.moe.top_k} d_expert="
          f"{cfg.moe.d_expert} V={cfg.vocab}: {nparam} parameters "
          f"({torch.cuda.memory_allocated()} B on the card)", flush=True)
    L = cfg.n_layers
    print(f"phase 13 (d): the model made in "
          f"{time.perf_counter() - t0:.1f} s into the phase", flush=True)
    served, (kc, vc) = lm_serve_paths(torch, "phase 13 (d)", model, 8)
    del model
    torch.cuda.empty_cache()
    print(f"phase 13 (d): the serving paths done "
          f"{time.perf_counter() - t0:.1f} s into the phase", flush=True)
    row = {"name": "flash_attention", "cell": cfg.name, "route": "cuda",
           "source": FA_SOURCE, "replaces": REPLACES["flash_attention"],
           "launches": served, "launches_prefill_32k": L,
           "launches_decode_32k": L, "combine_launches_decode_32k": L,
           "max_abs_err": worst}
    flash_layer_times(torch, args, fa, faref, row, "phase 13 (d)", cfg, kc,
                      vc)
    del kc, vc
    torch.cuda.empty_cache()
    print(f"phase 13: took {time.perf_counter() - t0:.1f} s", flush=True)
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


def same_files(a: str, b: str) -> bool:
    """The two directory trees hold the same files with the same bytes."""
    def tree(root):
        out = {}
        for d, _, files in os.walk(root):
            for f in files:
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = fh.read()
        return out

    return tree(a) == tree(b)


def span_seconds(events, name: str) -> list:
    """The durations (s) of the named spans of an obs event list."""
    return [e["dur"] / 1e6 for e in events
            if e["ev"] == "span" and e["name"] == name]


def launch_gang(tag: str, base: list, extra: list):
    """One ``python -m repro_torch.tools.launch_multihost`` run (one worker
    on the card) to its end; returns (exit code, seconds, stderr)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.launch_multihost", *base,
         "--timeout", str(CHILD_TIMEOUT_S), *extra],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=CHILD_TIMEOUT_S + 60)
    print(f"phase 9 ({tag}): the launcher exited {proc.returncode} after "
          f"{time.perf_counter() - t0!r} s", flush=True)
    return proc.returncode, time.perf_counter() - t0, proc.stderr


def rounds_line(rep: dict) -> str:
    r = rep["rounds"]
    return (f"{r['count']} rounds, p50 {r['p50_s'] * 1e3!r} ms, p90 "
            f"{r['p90_s'] * 1e3!r} ms, p99 {r['p99_s'] * 1e3!r} ms")


def spans_line(rep: dict, names) -> str:
    ph = rep["phases"]
    return ", ".join(f"{n} {ph[n]['total_s']!r} s" for n in names
                     if n in ph)


def card_peak(rep: dict):
    """The worker's peak card memory, a counter of its trace."""
    return rep["counters"].get("cuda_peak_bytes", {}).get("last")


def phase_driver(torch, np, edges, res, per_round_3b: float, chunks: int,
                 dev, scale: int, tmp: str):
    """Phase 9: the multi-controller run from the store, killed, resumed
    and finished, then the single-writer driver.

    Phase 3's edge list goes into a canonical EdgeFile in ``tmp``.  (a)
    ``launch_multihost`` runs one worker on the card through an exchange
    dir, a multi-writer snapshot every rounds / 8 rounds, traced and with
    the live bus, and kills it (exit 17) after the fourth snapshot; the
    monitor must call its bus STALLED (4).  (b) The gang resumes from the
    newest snapshot to the fixed point with edge_part's materialization
    forbidden and writes the multi-writer artifact: the bus's done line
    must give phase 3's RF and EB, the artifact phase 3's rounds.  (c)
    This process's single-writer spmd driver resumes from (b)'s seventh
    snapshot (launch counts set to 0 just before) and must equal phase 3
    bit for bit; on the way it writes single-writer snapshots as often as
    (b) did into a store of its own, each with the bytes of (b)'s step
    dir, and its artifact must have (b)'s bytes; that artifact is loaded
    back and must equal the run's result.  Returns (c)'s launch counts,
    (b)'s (from its trace), the EdgeFile (phase 10 reads it) and (b)'s
    artifact, moved into ``tmp`` (phase 14 serves it).
    """
    import shutil

    from repro_torch.core import partitioner as tp
    from repro_torch.dist import compat
    from repro_torch.io import FLAG_CANONICAL, write_edgefile
    from repro_torch.kernels.ne_round import ops
    from repro_torch.obs import live, report
    from repro_torch.obs import trace as obs
    from repro_torch.runtime import PartitionDriver, load_artifact
    from repro_torch.runtime.snapshot import RunSnapshot

    t_phase = time.perf_counter()
    every = max(res.rounds // (2 * DRIVER_SNAPSHOTS_BEFORE_KILL), 1)
    kill_at = DRIVER_SNAPSHOTS_BEFORE_KILL * every
    resume_c = 7 * every
    cfg = tp.NEConfig(num_partitions=PARTITIONS)
    ef_path = os.path.join(tmp, "main.edges")
    run = os.path.join(tmp, "mh")
    snap = os.path.join(run, "snap")
    art_b, art_c = os.path.join(run, "art_b"), os.path.join(run, "art_c")
    snap_c = os.path.join(run, "snap_c")
    try:
        t0 = time.perf_counter()
        ef = write_edgefile(ef_path, edges, num_vertices=1 << scale,
                            flags=FLAG_CANONICAL)
        print(f"phase 9: canonical EdgeFile of phase 3's edge list: "
              f"{ef.num_edges} edges in {ef.num_blocks} blocks, "
              f"{os.path.getsize(ef_path)} B, written in "
              f"{time.perf_counter() - t0!r} s", flush=True)
        base = ["--edgefile", ef_path, "--partitions", str(PARTITIONS),
                "--num-processes", "1", "--snapshot-dir", snap,
                "--exchange-dir", os.path.join(run, "exchange"),
                "--snapshot-every", str(every), "--keep", "8"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()       # room for the worker's context

        # --- (a) the gang, killed after round kill_at -----------------------
        rc, secs_a, err = launch_gang("a", base, [
            "--log-dir", os.path.join(run, "logs_a"),
            "--trace-dir", os.path.join(run, "trace_a"),
            "--metrics-dir", os.path.join(run, "live_a"),
            "--die-round", str(kill_at), "--die-stage", "after-round",
            "--die-process", "0"])
        check(rc == 17, f"phase 9 (a): the launcher exited {rc}, not 17: "
              f"{err[-3000:]}")
        published = sorted(int(d.split("_")[1]) for d in os.listdir(snap)
                           if d.startswith("step_"))
        want_steps = [every * (i + 1)
                      for i in range(DRIVER_SNAPSHOTS_BEFORE_KILL)]
        check(published == want_steps,
              f"phase 9 (a): published rounds {published}, not {want_steps}")
        mon = subprocess.run(
            [sys.executable, "-m", "repro_torch.tools.monitor_run",
             os.path.join(run, "live_a"), "--once", "--stall-after", "0.05",
             "--dead-after", "1e18"], capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": SRC}, timeout=120)
        check(mon.returncode == 4,
              f"phase 9 (a): monitor_run --once exited {mon.returncode}, "
              f"not 4 (STALLED): {mon.stdout[-2000:]} {mon.stderr[-2000:]}")
        rep_a = report.summarize_run(os.path.join(run, "trace_a"))
        print(f"phase 9 (a): killed with 17 after round {kill_at}, "
              f"{secs_a!r} s after the launch; monitor_run --once: 4 "
              f"(STALLED); snapshots at rounds {published}; "
              f"{rounds_line(rep_a)}; "
              + spans_line(rep_a, ("ingest", "exchange_write",
                                   "exchange_assemble", "snapshot")),
              flush=True)

        # --- (b) the gang resumed to the fixed point, sharded finish --------
        # (c)'s driver ingests the store in this process while (b) runs
        proc_b = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.tools.launch_multihost",
             *base, "--timeout", str(CHILD_TIMEOUT_S), "--resume",
             "--log-dir", os.path.join(run, "logs_b"),
             "--trace-dir", os.path.join(run, "trace_b"),
             "--metrics-dir", os.path.join(run, "live_b"),
             "--artifact-out", art_b],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": SRC,
                 "REPRO_FORBID_EDGE_PART_MATERIALIZE": "1"})
        t_b = time.perf_counter()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        tracer = obs.configure(path=None)
        try:
            with compat.world1(backend):
                drv = PartitionDriver(ef, cfg, snapshot_dir=snap,
                                      device=dev)
                ingest_c = time.perf_counter() - t_b
                _, err = proc_b.communicate(timeout=CHILD_TIMEOUT_S + 60)
                secs_b = time.perf_counter() - t_b
                check(proc_b.returncode == 0,
                      f"phase 9 (b): the launcher exited "
                      f"{proc_b.returncode}: {err[-3000:]}")
                snaps = live.load_snapshots(
                    live.host_metrics(os.path.join(run, "live_b"))[0])
                done = snaps[-1]
                rep_b = report.summarize_run(os.path.join(run, "trace_b"))
                with open(os.path.join(art_b, "manifest.json")) as f:
                    manifest = json.load(f)
                launches_b = {
                    k[len("launches_"):]: int(c["last"])
                    for k, c in rep_b["counters"].items()
                    if k.startswith("launches_")}
                stepped = [x["round"] for x in snaps
                           if x.get("phase") == "round"]
                print(f"phase 9 (b): resumed from round {stepped[0] - 1}"
                      f" to round {done['round']} in {secs_b!r} s (launch "
                      f"to exit), edge_part never materialized; the bus's "
                      f"done line RF={done['rf']!r} EB={done['eb']!r}; the "
                      f"artifact's manifest {manifest['rounds']} rounds; "
                      f"{rounds_line(rep_b)}; "
                      + spans_line(rep_b, (
                          "ingest", "exchange_write", "exchange_assemble",
                          "restore", "snapshot", "finalize",
                          "stage_leftovers", "apply_leftovers",
                          "artifact_save"))
                      + f"; peak RSS {rep_b['hosts'][0]['peak_rss_kb']} kB,"
                      f" card peak {card_peak(rep_b)} B; launches "
                      f"{launches_b}", flush=True)
                check(done.get("done") and done["round"] == res.rounds,
                      f"phase 9 (b): the bus's last line is {done}")
                check(stepped == list(range(kill_at + 1, res.rounds + 1)),
                      f"phase 9 (b): the bus saw rounds {stepped[:3]} ... "
                      f"{stepped[-3:]}, not {kill_at + 1}-{res.rounds}")
                st = res.stats
                check((done["rf"], done["eb"])
                      == (st.replication_factor, st.edge_balance),
                      f"phase 9 (b): the done line's RF, EB "
                      f"{(done['rf'], done['eb'])} are not phase 3's")
                check(manifest["rounds"] == res.rounds,
                      f"phase 9 (b): the artifact has {manifest['rounds']} "
                      f"rounds, not {res.rounds}")
                if scale == 22:
                    check((manifest["rounds"], done["rf"], done["eb"])
                          == SCALE22_RESULT,
                          f"phase 9 (b): rounds, RF, EB are not "
                          f"{SCALE22_RESULT}")
                resumed_b = res.rounds - kill_at
                want_b = round_launches(resumed_b, chunks, live_bus=True)
                check(launches_b == want_b,
                      f"phase 9 (b): launch counts {launches_b} are not "
                      f"{want_b}")

                # --- (c) the single-writer driver from (b)'s snapshot ----
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t0 = time.perf_counter()
                start = drv.restore_snapshot(resume_c)
                # from here on its own single-writer snapshots, as often
                # as (b)'s: each must have the bytes of (b)'s step dir
                drv.snapshot = RunSnapshot(snap_c, drv.cfg,
                                           drv.snapshot.graph_fp, keep=8)
                drv.snapshot_every = every
                got = drv.run()
                wall = time.perf_counter() - t0
                launches = dict(ops.launches)
                peak = torch.cuda.max_memory_allocated()
                t0 = time.perf_counter()
                drv.save_artifact(art_c)
                save_s = time.perf_counter() - t0
        finally:
            obs.disable()
        events = tracer.events
        rounds_s = span_seconds(events, "round")
        resumed = got.rounds - start
        st = got.stats
        print(f"phase 9 (c): the single-writer driver resumed from (b)'s "
              f"round-{start} snapshot in a world-1 {backend.upper()} group: "
              f"rounds={got.rounds} leftover={got.leftover} "
              f"RF={st.replication_factor!r} EB={st.edge_balance!r} "
              f"wall={wall!r} s; ingest {ingest_c!r} s (beside (b)), "
              f"restore {span_seconds(events, 'restore')} s, finalize "
              f"{span_seconds(events, 'finalize')} s; {len(rounds_s)} "
              f"rounds at {float(np.mean(rounds_s)) * 1e3!r} ms a round "
              f"(phase 3b: {per_round_3b * 1e3!r} ms); peak_mem={peak} B "
              f"launches={launches}; artifact saved in {save_s!r} s",
              flush=True)
        check(start == resume_c,
              f"phase 9 (c): resumed from round {start}, not {resume_c}")
        check(same_result(np, got, res),
              "phase 9 (c): the resumed run differs from phase 3's result")
        want = round_launches(resumed, chunks)
        check(launches == want and resumed > 0,
              f"phase 9 (c): launch counts {launches} are not {want}")
        steps_c = sorted(d for d in os.listdir(snap_c)
                         if d.startswith("step_"))
        want_c = [f"step_{k:010d}"
                  for k in range(start + every, got.rounds + 1, every)]
        check(steps_c == want_c,
              f"phase 9 (c): its snapshots are {steps_c}, not {want_c}")
        for d in steps_c:
            check(same_files(os.path.join(snap, d), os.path.join(snap_c, d)),
                  f"phase 9 (c): its single-writer {d} differs from (b)'s "
                  "multi-writer one")
        names = sorted(os.listdir(art_b))
        check(same_files(art_b, art_c),
              "phase 9 (c): its artifact's bytes differ from (b)'s")

        # --- the artifact (one set of bytes) loaded back ---------------------
        t0 = time.perf_counter()
        back = load_artifact(art_b).result()
        load_s = time.perf_counter() - t0
        art_bytes = sum(os.path.getsize(os.path.join(art_b, f))
                        for f in names)
        check(all(np.array_equal(getattr(back, f), getattr(got, f))
                  for f in ("edge_part", "vparts", "edges_per_part"))
              and (back.rounds, back.leftover) == (got.rounds, got.leftover),
              "phase 9: the artifact's result differs from the run's")
        print(f"phase 9: (c) == phase 3 bit for bit, launch counts match its "
              f"rounds {start + 1}-{got.rounds}; (c)'s single-writer "
              f"{', '.join(steps_c)} byte-identical to (b)'s multi-writer "
              f"step dirs; (b)'s and (c)'s artifacts "
              f"byte-identical, {art_bytes} B in {len(names)} files, loaded "
              f"back in {load_s!r} s and equal to phase 3's result; phase 9 "
              f"took {time.perf_counter() - t_phase:.1f} s", flush=True)
        kept = os.path.join(tmp, "artifact")
        shutil.move(art_b, kept)
        return launches, launches_b, ef, kept
    finally:
        shutil.rmtree(run, ignore_errors=True)


def round_launches(rounds: int, chunks: int, live_bus: bool = False,
                   ) -> dict:
    """The NE kernels' launches over ``rounds`` SPMD rounds at world 1
    (``chunks`` two-hop chunks a round); with the live bus on, each
    round's gauges unpack the replica words once more
    (``partitioner_sm.round_quality``)."""
    return {"select": rounds, "restart_draw": rounds, "one_hop": rounds,
            "claim_scatter": rounds, "pack_bits": 2 * rounds,
            "or_words": 2 * rounds,
            "unpack_bits": (2 if live_bus else 1) * rounds,
            "two_hop_best": rounds * chunks}


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


def stream_check_cases():
    """Phase 10 (a)'s cases: (name, P, lambda or None: Oblivious at a limit
    every partition fills)."""
    return ([("hdrf_scan", p, lam) for p in STREAM_HDRF_PARTS
             for lam in STREAM_LAMBDAS]
            + [("oblivious_scan", p, None) for p in STREAM_OBLIVIOUS_PARTS])


def stream_check_oracle(name: str, p: int, lam):
    """One of phase 10 (a)'s plain scans on the CPU, run in a pool process
    before the phase: (its result, the edges it read, its argument), as
    numpy; Oblivious at the limit max(1, M // 2P)."""
    sys.path.insert(0, SRC)
    from repro_torch.graphs.rmat import rmat
    from repro_torch.kernels.stream import ref as sref

    scale, ef, seed = STREAM_CHECK_GRAPH
    g = rmat(scale, ef, seed=seed, device="cpu")
    e, n, m = g.edges, g.num_vertices, g.num_edges
    if name == "hdrf_scan":
        return sref.hdrf_scan_ref(e, p, n, lam).numpy(), e.numpy(), lam
    limit = max(1, m // (2 * p))
    return (sref.oblivious_scan_ref(e, p, n, limit).numpy(), e.numpy(),
            limit)


def phase_stream_kernels(torch, dev, plains: dict) -> int:
    """Phase 10 (a): the cases the quality matrix does not reach, each
    stream kernel against its plain version (run on the CPU in the pool:
    ``plains``) bit for bit, and the same bits call to call, on
    rmat(10, 8, seed 3): HDRF at every P of ``STREAM_HDRF_PARTS`` (the
    warp route to P = 256, the block route above) at lambda 0.5 and 2,
    Oblivious at every P of ``STREAM_OBLIVIOUS_PARTS`` (the same two
    routes) at a limit every partition fills (the overflow rule).
    Returns the largest difference (0)."""
    from repro_torch.graphs.rmat import rmat
    from repro_torch.kernels.stream import ops as sops

    t0 = time.perf_counter()
    scale, ef, seed = STREAM_CHECK_GRAPH
    g = rmat(scale, ef, seed=seed, device=dev)
    e, n, m = g.edges, g.num_vertices, g.num_edges
    worst, routes, waited = 0, {}, 0.0
    for name, p, lam in stream_check_cases():
        t1 = time.perf_counter()
        want, read, arg = plains[(name, p, lam)].result()
        waited += time.perf_counter() - t1
        check(torch.equal(torch.from_numpy(read), e.cpu()),
              f"phase 10 (a): the plain {name} read another edge stream")
        if name == "hdrf_scan":
            kern = lambda: sops.hdrf_scan(e, p, n, arg)
            label = f"hdrf lam={arg} ({sops.hdrf_route(p, m)})"
        else:
            kern = lambda: sops.oblivious_scan(e, p, n, arg)
            label = f"oblivious limit={arg} ({sops.oblivious_route(p, m)})"
        a, b = kern(), kern()
        torch.cuda.synchronize()
        err = max(max_abs_err(a.cpu(), torch.from_numpy(want)),
                  max_abs_err(a, b))
        worst = max(worst, err)
        check(err == 0, f"phase 10: {label} at P={p} differs from its "
                        f"plain version or from call to call ({err})")
        if name == "oblivious_scan":
            # the small limit fills every partition: the overflow rule ran
            full = torch.bincount(a.long(), minlength=p).min().item()
            check(full >= arg,
                  f"phase 10: oblivious at P={p} left a partition unfilled")
        routes.setdefault(name, []).append(f"P={p} {label}")
    for name, cases in routes.items():
        print(f"phase 10: {name} == plain (CPU) bit for bit and call to "
              f"call at M={m}, N={n}: {'; '.join(cases)}", flush=True)
    print(f"phase 10 (a): took {time.perf_counter() - t0:.1f} s (of it "
          f"{waited:.1f} s waiting for the pool's plain scans)", flush=True)
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


def stream_plain_oracle(name: str, p: int, tmp: str):
    """Phase 10's plain stream scan ``name`` at (``STREAM_PLAIN_GRAPH``,
    P = ``p``) on the CPU, run in a pool process long before the phase:
    (its result, the edge stream it read, its ms), as numpy."""
    sys.path.insert(0, SRC)
    from repro_torch.core.baselines import stream_order
    from repro_torch.kernels.stream import ref as sref
    from repro_torch.tools import quality

    g = quality.real_graph(tmp, "cpu")[0]
    n, m = g.num_vertices, g.num_edges
    es = g.edges[stream_order(g, 0)]
    t0 = time.perf_counter()
    if name == "hdrf_scan":
        out = sref.hdrf_scan_ref(es, p, n, 1.0)
    else:
        out = sref.oblivious_scan_ref(es, p, n, int(1.1 * m / p) + 1)
    return out.numpy(), es.numpy(), (time.perf_counter() - t0) * 1e3


def start_stream_oracles(pool, tmp: str) -> tuple:
    """Phase 10's plain scans on the CPU, submitted to ``pool`` with the
    app oracles (they run beside phase 9): (a)'s {(name, P, lambda):
    future} and the cells' {(name, P): future}."""
    from repro_torch.tools import quality

    checks = {case: pool.submit(stream_check_oracle, *case)
              for case in stream_check_cases()}
    out = {}
    for name in STREAM_KERNELS:
        for p in quality.PARTS:
            d = os.path.join(tmp, f"stream_{name}_{p}")
            os.makedirs(d, exist_ok=True)
            out[(name, p)] = pool.submit(stream_plain_oracle, name, p, d)
    return checks, out


def stream_cells(torch, graphs, counts, err: int, plains: dict) -> list:
    """Each stream kernel at every cell of (b)'s matrix, on the inputs the
    baselines give it there (stream order of seed 0, HDRF at lambda 1,
    Oblivious at the alpha limit): the wrapper's time (``ms``), the
    launch's alone and the fills' (:func:`launch_ms`), the bound; on
    ``STREAM_PLAIN_GRAPH`` also the kernel's bits against the plain
    version and from call to call.  The plain version runs on the CPU
    (~0.1 ms an edge there, ~0.3-0.5 on the card, where each of its small
    ops waits for the host), in a pool process beside phase 9
    (``plains``: :func:`start_stream_oracles`; the stream it read must be
    this one); at ``STREAM_PLAIN_CARD`` also on the card over the first
    ``STREAM_PLAIN_CARD_EDGES`` edges, whose bits the CPU's must equal.
    Returns the two JSON rows: the numbers of the (real, P = 16) cell,
    with (b)'s launch counts and every cell under ``cells``."""
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
                     lambda x: sref.hdrf_scan_ref(x, p, n, 1.0)),
                    ("oblivious_scan", limit,
                     lambda: sops.oblivious_scan(es, p, n, limit),
                     lambda x: sref.oblivious_scan_ref(x, p, n, limit))):
                bound, by, floor = stream_bound(name, m, p)
                scan = sops.prepare(name, es, p, n, arg)
                dev_ms, fill_ms = launch_ms(torch, sops, scan, 3)
                cell = {"graph": gname, "p": p, "m": m, "n": n,
                        "kernel_route": scan.route,
                        "ms": time_ms(kern, 3, warmup=1), "device_ms": dev_ms,
                        "fill_ms": fill_ms, "bound_ms": bound, "bound_by": by,
                        "bound_floor": floor, "plain_cpu_ms": None,
                        "max_abs_err": None}
                held = ""
                if gname == STREAM_PLAIN_GRAPH:
                    want, read, cpu_ms = plains[(name, p)].result()
                    check(torch.equal(torch.from_numpy(read), es.cpu()),
                          f"phase 10: {name} at {gname} P={p}: the plain "
                          f"run read another edge stream")
                    want = torch.from_numpy(want)
                    a, b = kern(), kern()
                    diff = max(max_abs_err(a.cpu(), want), max_abs_err(a, b))
                    check(diff == 0, f"phase 10: {name} at {gname} P={p} "
                                     f"differs from its plain version or "
                                     f"from call to call ({diff})")
                    cell.update(plain_cpu_ms=cpu_ms, max_abs_err=diff)
                    held = (f", == plain (CPU, {cpu_ms!r} ms) bit for bit "
                            f"and call to call")
                if gname == STREAM_PLAIN_GRAPH and \
                        (name, p) == STREAM_PLAIN_CARD:
                    k = STREAM_PLAIN_CARD_EDGES
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    on_card = plain(es[:k])
                    end.record()
                    end.synchronize()
                    check(max_abs_err(on_card.cpu(), want[:k]) == 0,
                          f"phase 10: {name} at {gname} P={p}: the plain "
                          f"version's bits on the card and the CPU differ")
                    cell.update(plain_card_first_ms=start.elapsed_time(end),
                                plain_card_first_edges=k)
                    held += (f"; plain on the card over the first {k} "
                             f"edges {cell['plain_card_first_ms']!r} ms, == "
                             f"the CPU's bits")
                cells[name].append(cell)
                print(f"phase 10: {name} ({scan.route}) at {gname} P={p} "
                      f"(M={m}): ms "
                      f"{cell['ms']!r}, launch {dev_ms!r} ms "
                      f"({dev_ms * 1e6 / m!r} ns an edge), fills {fill_ms!r} "
                      f"ms, bound {bound!r} ({by}: {floor}){held}",
                      flush=True)
    rows = []
    for name, cs in cells.items():
        top = next(c for c in cs if c["graph"] == STREAM_PLAIN_GRAPH
                   and c["p"] == STREAM_ROW_P)
        rows.append({
            "name": name, "route": "cuda",
            "kernel_route": top["kernel_route"], "source": STREAM_SOURCE,
            "cuda_kernels": STREAM_CUDA[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max([err] + [c["max_abs_err"] for c in cs
                                        if c["max_abs_err"] is not None]),
            "ms": top["ms"], "device_ms": top["device_ms"],
            "device_ms_by": ("CUDA events around the launch alone, queued "
                             "behind a 1 ms sleep; its two fills apart in "
                             "fill_ms"),
            "fill_ms": top["fill_ms"],
            "plain_ms": top["plain_cpu_ms"], "plain_on": "cpu",
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


def adjacency(path: str, n: int):
    """The symmetric (n, n) float64 CSR adjacency of the canonical edge
    list saved at ``path``, and each vertex's degree."""
    import numpy as np
    import scipy.sparse as sp

    e = np.load(path)
    u, v = e[:, 0], e[:, 1]
    a = sp.csr_matrix((np.ones(2 * len(e)), (np.concatenate([u, v]),
                                              np.concatenate([v, u]))),
                      shape=(n, n))
    return a, np.diff(a.indptr).astype(np.float64)


def pagerank_oracle(path: str, n: int, iters: int, damping: float):
    """Phase 11 (a)'s PageRank in float64 with the reference's formula:
    from 1/n over the vertices with an edge, a vertex of degree 0
    contributing 0, a vertex with no edge at (1 - d)/n.  Returns (ranks,
    seconds); runs in a process of its own."""
    import numpy as np

    t0 = time.perf_counter()
    a, deg = adjacency(path, n)
    has_edge = deg > 0
    pr = np.where(has_edge, 1.0 / n, 0.0)
    for _ in range(iters):
        contrib = np.where(deg > 0, pr / np.maximum(deg, 1.0), 0.0)
        pr = np.where(has_edge, (1.0 - damping) / n + damping * (a @ contrib),
                      0.0)
    pr[~has_edge] = (1.0 - damping) / n
    return pr, time.perf_counter() - t0


def sssp_wcc_oracle(path: str, n: int, source: int):
    """Phase 11 (a)'s SSSP and WCC with scipy: unweighted
    ``shortest_path`` from ``source``; ``connected_components`` labelled
    by the smallest id of each; inf and -1 where a vertex has no edge.
    Returns (distances, labels, seconds); runs in a process of its own."""
    import numpy as np
    from scipy.sparse import csgraph

    t0 = time.perf_counter()
    a, deg = adjacency(path, n)
    has_edge = deg > 0
    dist = csgraph.shortest_path(a, unweighted=True, indices=source)
    dist[~has_edge] = np.inf
    ncomp, comp = csgraph.connected_components(a, directed=False)
    low = np.full(ncomp, n, np.int64)
    np.minimum.at(low, comp, np.arange(n))
    labels = np.where(has_edge, low[comp], -1).astype(np.float64)
    return dist, labels, time.perf_counter() - t0


def timed(torch, fn):
    """(fn(), host seconds) around a call that ends in a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def backend_of(dev) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def start_app_oracles(np, pool, edges, n: int, tmp: str):
    """Phase 11 (a)'s scipy oracles, submitted to ``pool`` (two spawned
    processes) long before the phase, so that they run beside phases 9
    and 10: the edge list goes to ``tmp`` as .npy.  Returns the two
    futures and the SSSP source, the hub (the vertex of largest degree,
    as vertex 0 is in BA; RMAT permutes its ids)."""
    deg = np.bincount(edges.ravel(), minlength=n)
    source = int(deg.argmax())
    path = os.path.join(tmp, "apps_edges.npy")
    np.save(path, edges)
    return (pool.submit(pagerank_oracle, path, n, APP_PR_ITERS, APP_DAMPING),
            pool.submit(sssp_wcc_oracle, path, n, source), source)


def phase_apps(torch, np, edges, n: int, dev, oracles) -> None:
    """Phase 11 (a): PageRank, SSSP and WCC over the vertex-cut engine at
    world 1 (a one-part ShardedGraph of phase 3's graph, built on the
    host) in a world-1 NCCL group on the card, against the scipy oracles
    of :func:`start_app_oracles` (float64, in two other processes)."""
    from repro_torch.apps import algorithms as alg
    from repro_torch.apps import engine as eng
    from repro_torch.dist import compat

    t_phase = time.perf_counter()
    pr_oracle, label_oracle, source = oracles
    deg = np.bincount(edges.ravel(), minlength=n)
    sg, build_s = timed(torch, lambda: eng.build_sharded_graph(
        edges, np.zeros(len(edges), np.int32), n, 1))
    print(f"phase 11 (a): one-part ShardedGraph of phase 3's graph "
          f"(N={n}, M={len(edges)}, {int((deg > 0).sum())} vertices "
          f"with an edge): built on the host in {build_s!r} s; caps "
          f"{sg.caps}; SSSP source {source} (degree {int(deg[source])})",
          flush=True)
    with compat.world1(backend_of(dev)):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = alg.unpack(sg, dev)          # on the card once, for every call
        runs = {
            "pagerank": (lambda k: alg.pagerank(
                sg, k, APP_DAMPING, device=dev, arrays=a), APP_PR_ITERS),
            "sssp": (lambda k: alg.sssp(sg, source, max_iters=k, device=dev,
                                        arrays=a), 200),
            "wcc": (lambda k: alg.wcc(sg, max_iters=k, device=dev,
                                      arrays=a), 200)}
        got, per_step = {}, {}
        for name, (fn, k) in runs.items():
            got[name] = fn(k)
            steps = k if name == "pagerank" else got[name][1]
            # k supersteps less 0: the set-up and the stitch cancel
            wall = min(timed(torch, lambda: fn(k))[1]
                       for _ in range(APP_REPS))
            wall0 = min(timed(torch, lambda: fn(0))[1]
                        for _ in range(APP_REPS))
            per_step[name] = (wall - wall0) / steps
            print(f"phase 11 (a): {name}: {steps} supersteps in {wall!r} s, "
                  f"0 in {wall0!r} s (the least of {APP_REPS} calls each, "
                  f"the arrays on the card): {per_step[name] * 1e3!r} ms a "
                  f"superstep", flush=True)
        peak = torch.cuda.max_memory_allocated() - base
        prof = profile_round(torch, f"phase 11 (a): profiled PageRank "
                             f"run of {APP_PR_ITERS} supersteps",
                             lambda: runs["pagerank"][0](APP_PR_ITERS))
        del a
    t0 = time.perf_counter()
    pr_ref, pr_s = pr_oracle.result()
    dist_ref, lab_ref, label_s = label_oracle.result()
    wait_s = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof)
    pr = got["pagerank"]
    err = np.abs(pr - pr_ref)
    rel = float((err / pr_ref).max())
    check(bool((err <= APP_PR_TOL * pr_ref).all()),
          f"phase 11 (a): PageRank max rel err {rel!r} > {APP_PR_TOL}")
    dist, it_s = got["sssp"]
    labels, it_w = got["wcc"]
    check(np.array_equal(dist, dist_ref), "phase 11 (a): SSSP differs "
          "from scipy's shortest_path")
    check(np.array_equal(labels, lab_ref), "phase 11 (a): WCC differs "
          "from scipy's connected_components")
    reach = int(np.isfinite(dist).sum())
    print(f"phase 11 (a): == scipy (float64; PageRank {pr_s:.1f} s, SSSP "
          f"and WCC {label_s:.1f} s, in two other processes since phase 9; "
          f"waited {wait_s:.1f} s for them): PageRank max "
          f"abs err {float(err.max())!r} (max "
          f"{float(pr_ref.max())!r}), max rel err {rel!r} (tolerance "
          f"{APP_PR_TOL} of each vertex's rank); SSSP exact ({reach} "
          f"reached, max distance {int(dist[np.isfinite(dist)].max())}, "
          f"{it_s} supersteps); WCC "
          f"exact ({len(np.unique(labels[labels >= 0]))} components with "
          f"an edge, {it_w} supersteps); peak device memory {peak} B above "
          f"the {base} B held; the PageRank run {busy:.0f} us busy; phase "
          f"took {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_table5(torch, np, dev) -> dict:
    """Phase 11 (b): paper Table 5's partitions (``bench_apps.py``): NE on
    the card with the launch counts set to 0 just before and read just
    after, ``random_1d`` and ``grid_2d``; each one's RF and its PageRank
    wire bytes over 30 supersteps (``comm_volume_model``, F = 1, 4 bytes),
    equal to 2 · comm_slots · 4 · 30 of the 8-part ShardedGraph; NE's
    edge_part equal to the CPU's.  Returns NE's launch counts."""
    from repro_torch.apps import engine as eng
    from repro_torch.core import baselines
    from repro_torch.core import partitioner as tp
    from repro_torch.core.metrics import comm_volume_model, evaluate
    from repro_torch.graphs.generators import barabasi_albert

    t0 = time.perf_counter()
    n_ba, m_attach, seed = TABLE5_GRAPH
    g = barabasi_albert(n_ba, m_attach, seed, device=dev)
    e = g.edges.cpu().numpy()
    n, m, p = g.num_vertices, g.num_edges, TABLE5_P
    cfg = tp.NEConfig(num_partitions=p, seed=0, edge_chunk=1 << 14)
    torch.cuda.synchronize()
    reset_counts()
    res = tp.partition(g, cfg)
    counts = all_counts()
    chunks = -(-m // min(cfg.edge_chunk, m))
    check_counts("phase 11 (b)", {
        "select": res.rounds, "restart_draw": res.rounds,
        "one_hop": res.rounds, "claim_scatter": res.rounds,
        "two_hop_best": res.rounds * chunks})
    cpu = tp.partition(barabasi_albert(n_ba, m_attach, seed, device="cpu"),
                       cfg)
    check(same_result(np, res, cpu), "phase 11 (b): NE on the card differs "
          "from the CPU's")
    methods = {"dne": res.edge_part, "random": baselines.random_1d(g, p),
               "grid": baselines.grid_2d(g, p)}
    check_counts("phase 11 (b)", {k: v for k, v in counts.items() if v})
    for name, ep in methods.items():
        st = evaluate(e, ep, n, p)
        com = comm_volume_model(st, n, 1) * APP_PR_ITERS
        sg = eng.build_sharded_graph(e, ep, n, p)
        want = 2 * sg.comm_slots * 4 * APP_PR_ITERS
        check(com == want, f"phase 11 (b): {name}: comm_volume_model "
              f"{com} B, 2 comm_slots 4 30 = {want} B")
        print(f"phase 11 (b): Table 5 {name} on BA({n_ba}, {m_attach}, seed "
              f"{seed}) (M={m}) P={p}: RF={st.replication_factor!r} "
              f"EB={st.edge_balance!r}; PageRank wire bytes over "
              f"{APP_PR_ITERS} supersteps {com} B (= 2 x comm_slots "
              f"{sg.comm_slots} x 4 B x {APP_PR_ITERS})", flush=True)
    print(f"phase 11 (b): NE {res.rounds} rounds == the CPU's bit for bit; "
          f"launches {counts}; took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return counts


def phase_redistribute(torch, np, edges, edge_part, dev) -> None:
    """Phase 11 (c): ``redistribute_edges`` at world 1 on the card over
    phase 3b's shards (at world 1 the whole edge list in one shard), with
    the one-part assignment and with phase 3's 64-part assignment (63
    parts outside the world: dropped), each equal to the host path."""
    from repro_torch.core.graph import shard_edges
    from repro_torch.dist import compat
    from repro_torch.dist.redistribute import redistribute_edges

    t0 = time.perf_counter()
    shards, masks, _, dev_of = shard_edges(edges, 1)
    check(bool((dev_of == 0).all()), "phase 11 (c): world-1 shards split")
    for label, parts in (("one part", np.zeros(masks.shape, np.int32)),
                         ("phase 3's 64 parts",
                          edge_part[None, :].astype(np.int32))):
        want, host_s = timed(torch, lambda: redistribute_edges(
            shards, masks, parts))
        with compat.world1(backend_of(dev)):
            got, card_s = timed(torch, lambda: redistribute_edges(
                shards[0], masks[0], parts[0],
                torch.distributed.group.WORLD, dev))
        same = (np.array_equal(got[0], want[0][0])
                and np.array_equal(got[1], want[1][0]) and got[2] == want[2])
        check(same, f"phase 11 (c): {label}: the card's rows differ from "
              f"the host path's")
        print(f"phase 11 (c): redistribute_edges ({label}) over {masks.size} "
              f"rows: card == host path bit for bit ({int(got[1].sum())} "
              f"rows landed, {got[2]} dropped); card {card_s!r} s (host "
              f"copies included), host path {host_s!r} s", flush=True)
    print(f"phase 11 (c): took {time.perf_counter() - t0:.1f} s", flush=True)


def grads_rel_err(np, got, want) -> float:
    """max over leaves of max |got - want| / max |want|."""
    from repro_torch.tree import tree_leaves

    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def family_loss_grads(torch, np, compat, ge, model, sg, data, pos, device,
                      backend, dtype):
    """(loss, gradients as numpy) of the engine loss at world 1, the model
    and the float arrays in ``dtype``."""
    from repro_torch.tree import tree_map

    edges, feats, labels, label_mask = data
    with compat.world1(backend):
        a = ge.engine_arrays(sg, feats, labels, label_mask, 0, device, pos)
        a = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
             else v for k, v in a.items()}
        model.to(device, dtype)
        loss = ge.loss_and_grads(model, a, ge.caps_from_sharded_graph(
            sg, feats.shape[1], model.cfg.n_classes))
        grads = tree_map(lambda p: p.grad.cpu().numpy(), model.param_tree())
    return float(loss), grads


FAMILY_MODULES = {"pna": "PNA", "egnn": "EGNN",
                  "equiformer_v2": "EquiformerV2"}


def family_inputs(np):
    """Phase 11 (d)'s graph: (shape, (edges, feats, labels, label_mask),
    positions, one-part ShardedGraph), all from seeds."""
    from repro_torch.apps import engine as eng
    from repro_torch.configs.shapes import GNN_SHAPES

    shape = GNN_SHAPES[GNN_SHAPE]
    data = gnn_data(np, shape, seed=0)
    edges, feats = data[0], data[1]
    n, m = feats.shape[0], len(edges)
    pos = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    sg = eng.build_sharded_graph(edges, np.zeros(m, np.int32), n, 1)
    return shape, data, pos, sg


def family_check_params(torch, name: str, shape: dict, seed: int):
    """(model class, full config, the check's config, its dtype, its
    parameters as numpy) of phase 11 (d)'s card-against-CPU check of
    family ``name`` at parameter seed ``seed``: at seed 0 the full model's
    parameters (EquiformerV2's first EQV2_CPU_LAYERS layers of them),
    else the check's model's drawn from the seed; PNA in float64."""
    import importlib

    from repro_torch.models.common import params_to_numpy

    cls = getattr(importlib.import_module(f"repro_torch.models.gnn.{name}"),
                  FAMILY_MODULES[name])
    conf = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = dataclasses.replace(conf.CONFIG, d_feat=shape["d_feat"],
                              n_classes=shape["n_classes"])
    eq = name == "equiformer_v2"
    ccfg = dataclasses.replace(cfg, n_layers=EQV2_CPU_LAYERS) if eq else cfg
    if seed == 0:
        ps = params_to_numpy(cls(cfg, torch.Generator().manual_seed(0)))
        if eq:
            ps = dict(ps, layers=ps["layers"][:EQV2_CPU_LAYERS])
    else:
        ps = params_to_numpy(cls(ccfg, torch.Generator().manual_seed(seed)))
    dtype = torch.float64 if name == "pna" else torch.float32
    return cls, cfg, ccfg, dtype, ps


def family_cpu_oracle(name: str, seed: int):
    """Phase 11 (d)'s CPU side of one card-against-CPU check, in a pool
    process long before the phase: (loss, gradients as numpy, seconds) of
    family ``name``'s engine loss at world 1 on the CPU (gloo, plain
    versions) at parameter seed ``seed``."""
    sys.path.insert(0, SRC)
    import numpy as np
    import torch

    from repro_torch.dist import compat
    from repro_torch.launch import gnn_engine as ge
    from repro_torch.models.common import params_from_numpy

    torch.set_num_threads(2)        # two workers beside the main process
    shape, data, pos, sg = family_inputs(np)
    cls, _, ccfg, dtype, ps = family_check_params(torch, name, shape, seed)
    t0 = time.perf_counter()
    loss, grads = family_loss_grads(torch, np, compat, ge,
                                    params_from_numpy(cls(ccfg), ps), sg,
                                    data, pos, "cpu", "gloo", dtype)
    return loss, grads, time.perf_counter() - t0


def start_family_oracles(pool) -> dict:
    """Phase 11 (d)'s CPU checks, submitted to ``pool`` with the other
    oracles: {(family, seed): future}."""
    return {(name, seed): pool.submit(family_cpu_oracle, name, seed)
            for name in FAMILY_MODULES
            for seed in range(PNA_SEEDS if name == "pna" else 1)}


def phase_families(torch, np, dev, cpu_checks: dict) -> None:
    """Phase 11 (d): PNA (4 x 75), EGNN (4 x 64) and EquiformerV2 (12
    layers, d 128, l_max 6, m_max 2, 8 heads) at full width over the
    vertex-cut engine at world 1, on phase 6's graph with seeded
    positions: the engine loss against the plain model's on the card; the
    engine's loss and gradients on the card against the CPU's (gloo,
    plain versions; EquiformerV2 with 1 of its 12 layers; the CPU's side
    computed in the pool beside phase 9, ``cpu_checks``); 20
    ``train_step``s (EquiformerV2: 5) with finite losses, ms a step, the
    busy share of a
    profiled step and peak memory, the launch counts set to 0 just before
    and read just after (no kernel of the port runs on these paths)."""
    from repro_torch.dist import compat
    from repro_torch.launch import gnn_engine as ge
    from repro_torch.models.common import (cross_entropy, params_from_numpy,
                                           params_to_numpy)
    from repro_torch.models.gnn.common import GraphData, to_directed_padded
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    shape, data, pos, sg = family_inputs(np)
    edges, feats, labels, label_mask = data
    n, m = feats.shape[0], len(edges)
    ei, em = to_directed_padded(edges, n)
    gd = GraphData(*(torch.from_numpy(x).to(dev) for x in (feats, ei, em)),
                   positions=torch.from_numpy(pos).to(dev))
    ocfg = opt.OptConfig(total_steps=FAMILY_STEPS, **GNN_OPT)
    for name in FAMILY_MODULES:
        t0 = time.perf_counter()
        cls, cfg, ccfg, dtype, _ = family_check_params(torch, name, shape, 0)
        p0 = params_to_numpy(cls(cfg, torch.Generator().manual_seed(0)))
        model = params_from_numpy(cls(cfg), p0).to(dev)
        caps = ge.caps_from_sharded_graph(sg, shape["d_feat"],
                                          cfg.n_classes)
        y = torch.from_numpy(labels).to(dev)
        lm = torch.from_numpy(label_mask).to(dev)
        with torch.no_grad():
            plain = float(cross_entropy(model(gd), y, lm))
            with compat.world1(backend_of(dev)):
                a = ge.engine_arrays(sg, feats, labels, label_mask, 0, dev,
                                     pos)
                eng_loss = float(ge.engine_loss(model, a, caps))
        check(abs(eng_loss - plain) <= FAMILY_LOSS_RTOL * abs(plain),
              f"phase 11 (d): {cfg.name}: engine loss {eng_loss!r}, plain "
              f"{plain!r}")
        # card against CPU, EquiformerV2 with EQV2_CPU_LAYERS of its
        # layers; the CPU's side from the pool
        f64 = name == "pna"
        seeds = PNA_SEEDS if f64 else 1
        g_tol = PNA_GRAD_TOL if f64 else FAMILY_GRAD_TOL
        g_errs, cpu_s = [], 0.0
        for seed in range(seeds):
            ps = family_check_params(torch, name, shape, seed)[4]
            card = family_loss_grads(torch, np, compat, ge,
                                     params_from_numpy(cls(ccfg), ps), sg,
                                     data, pos, dev, backend_of(dev), dtype)
            *host, secs = cpu_checks[(name, seed)].result()
            cpu_s += secs
            g_errs.append(grads_rel_err(np, card[1], host[1]))
            check(abs(card[0] - host[0]) <= FAMILY_LOSS_RTOL * abs(host[0])
                  and g_errs[-1] <= g_tol,
                  f"phase 11 (d): {cfg.name} seed {seed}: card loss "
                  f"{card[0]!r} against the CPU's {host[0]!r}, gradients "
                  f"{g_errs[-1]!r} of a leaf's largest (tolerance {g_tol})")
            if seed == 0:
                loss0 = (card[0], host[0])
        # the training steps: counts 0 just before, read just after
        n_steps = EQV2_STEPS if name == "equiformer_v2" else FAMILY_STEPS
        with compat.world1(backend_of(dev)):
            model = params_from_numpy(cls(cfg), p0).to(dev)
            state = opt.init(model.param_tree(), ocfg)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t1 = time.perf_counter()
            losses = []
            for _ in range(n_steps):
                loss, state = ge.train_step(model, a, caps, state, ocfg)
                losses.append(loss)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t1) / n_steps
            check_counts(f"phase 11 (d) {cfg.name}", {})
            peak = torch.cuda.max_memory_allocated() - base
            prof = profile_round(torch, f"phase 11 (d): profiled {cfg.name} "
                                 f"train_step",
                                 lambda: ge.train_step(model, a, caps, state,
                                                       ocfg), host_top=8)
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"phase 11 (d): {cfg.name} losses "
              f"{losses}")
        busy = sum(e.self_device_time_total for e in prof)
        print(f"phase 11 (d): {cfg.name} L={cfg.n_layers} on {GNN_SHAPE} "
              f"(N={n}, E={m}): engine loss {eng_loss!r} == plain "
              f"{plain!r} (rel {abs(eng_loss - plain) / abs(plain)!r}); "
              f"card vs CPU ({ccfg.n_layers} layers, {dtype}; the CPU's loss "
              f"and gradients {cpu_s:.1f} s in the pool): loss {loss0[0]!r} / "
              f"{loss0[1]!r}, gradients within {g_errs!r} of a leaf's "
              f"largest at parameter seeds 0..{seeds - 1} (tolerance "
              f"{g_tol}); {n_steps} train_steps: losses {losses[0]!r} "
              f"-> {losses[-1]!r}, {step_s * 1e3!r} ms a step, peak "
              f"{peak} B above the {base} B held, a profiled step "
              f"{busy:.0f} us busy; {time.perf_counter() - t0:.1f} s",
              flush=True)
        del model, state, a
        torch.cuda.empty_cache()
    print(f"phase 11 (d): took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --------------------------------------------------------------------------
# phase 12: training (DeepFM, the dense LMs) and the backward kernels
# --------------------------------------------------------------------------

class _Stopped(Exception):
    """Raised by a batch stream where a run is to stop (phase 12 (d))."""


def bag_bwd_bound(v: int, d: int, b: int, k: int):
    """(ms, 'bytes') of one table gradient: the dense (V, D) float32 write,
    the ids and grad_out read once."""
    return bound_ms(4 * (v * d + b * k + b * d)), "bytes"


def flash_bwd_bound(b: int, s: int, h: int, hk: int, d: int, size: int):
    """(ms, by) of a causal S = T backward: the five products' operations
    (S = Q·Kᵀ, dP = dO·Vᵀ, dV, dK, dQ: 2·D each a kept pair) on the
    tensor cores' bf16 rate (the FMA kernel's float32 rate for float32), or the
    bytes of q, k, v, out, dout read and dq, dk, dv written once, with the
    float32 lse."""
    pairs = s * (s + 1) // 2
    ops = 5 * 2 * pairs * d * b * h
    rate = BF16_FLOPS if size == 2 else FP32_FLOPS
    nbytes = size * (4 * b * s * h * d + 4 * b * s * hk * d) + 4 * b * h * s
    by_ops, by_bytes = ops / rate * 1e3, bound_ms(nbytes)
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                               "bytes")


def train_bag_kernel(torch, eb, ebref, table, ids, name, reps) -> dict:
    """Phase 12 (a), the bag: ``embedding_bag_backward`` at a DeepFM train
    call (B 65,536 bags of the 39 fields' ids; the table, D 10, or w1,
    D 1; float32, weight 1) against its plain version on the card (1e-6 +
    1e-5 |plain|: its ``index_add_`` adds by atomics, in no fixed order),
    bit for bit the plain version's in-order float32 sum on the CPU, the
    same bits call to call; a call's kernels from its profile (one
    ``tile_kernel``, no ``zero_kernel``: each gradient row written once),
    the preparation's (the sort, its index fill, the int32 cast) apart as
    ``sort_device_ms``; its times beside the bound, the plain version's
    and the backward of ``F.embedding_bag(mode="sum")``."""
    from repro_torch.tools.bag_backward_profile import short

    dev = table.device
    (b, k), (v, d) = ids.shape, table.shape
    g = torch.randn((b, d), generator=torch.Generator(device=dev)
                    .manual_seed(121 + d), device=dev)
    got, _ = eb.embedding_bag_backward(table, ids, None, g)
    again, _ = eb.embedding_bag_backward(table, ids, None, g)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"phase 12 (a): embedding_bag_backward "
          f"({name}) differs from call to call")
    want, _ = ebref.embedding_bag_backward_ref(table, ids, None, g)
    err, ok = within(got, want, 1e-5, 1e-6)
    check(ok, f"phase 12 (a): embedding_bag_backward ({name}) differs from "
          f"plain: {err!r}")
    del again, want
    cpu, _ = ebref.embedding_bag_backward_ref(
        torch.empty((v, d)), ids.cpu(), None, g.cpu())
    check(torch.equal(got.cpu(), cpu), f"phase 12 (a): embedding_bag_"
          f"backward ({name}) is not the in-order float32 sum")
    del got, cpu
    fe = torch.nn.functional.embedding_bag
    tg = table.detach().requires_grad_()
    out = fe(ids, tg, mode="sum")
    (lib,) = torch.autograd.grad(out, tg, g, retain_graph=True)
    lerr, lok = within(lib, ebref.embedding_bag_backward_ref(
        table, ids, None, g)[0], 1e-5, 1e-6)
    check(lok, f"phase 12 (a): F.embedding_bag's backward differs from "
          f"plain: {lerr!r}")
    del lib
    kern = lambda: eb.embedding_bag_backward(table, ids, None, g)
    plain = lambda: ebref.embedding_bag_backward_ref(table, ids, None, g)
    libf = lambda: torch.autograd.grad(out, tg, g, retain_graph=True)
    bound = bag_bwd_bound(v, d, b, k)
    for _ in range(5):             # an empty profile is taken again
        per = device_kernels(torch, kern, reps)
        if per:
            break
    tiles = {n: c for n, (_, c) in per.items() if "tile_kernel" in n}
    check(sum(tiles.values()) == 1 and not any(
        "zero_kernel" in n or "run_kernel" in n for n in per),
        f"phase 12 (a): embedding_bag_backward ({name}) ran {sorted(per)} "
        f"a call, not one tile_kernel and no zero_kernel")
    tile_ms = kernel_ms(per, "tile_kernel")
    sort_ms = sum(t for n, (t, _) in per.items() if "tile_kernel" not in n)
    print(f"phase 12 (a): embedding_bag_backward ({name}) device ms a call "
          f"by kernel: " + "; ".join(f"{short(n)} x{c} {t!r}"
                                     for n, (t, c) in per.items()),
          flush=True)
    row = {"ms": time_ms(kern, reps), "device_ms": tile_ms + sort_ms,
           "tile_device_ms": tile_ms, "sort_device_ms": sort_ms,
           "cuda_kernels": ["tile_kernel<T>"],
           "plain_ms": time_ms(plain, max(1, reps // 4)),
           "bound_ms": bound[0], "bound_by": bound[1],
           "library_ms": time_ms(libf, reps),
           "library_device_ms": device_ms(torch, libf, reps)[0],
           "max_abs_err": err}
    print(f"phase 12 (a): embedding_bag_backward ({name}: V={v}, D={d}, "
          f"B={b}, K={k}) == plain (max abs err {err!r}, tol 1e-6 + "
          f"1e-5|plain|), == the CPU's in-order sum bit for bit, the same "
          f"bits call to call; ms {row['ms']!r}, device_ms "
          f"{row['device_ms']!r} (tile_kernel {tile_ms!r}, the sort and "
          f"its casts {sort_ms!r}), bound {row['bound_ms']!r} (bytes), plain "
          f"{row['plain_ms']!r}, F.embedding_bag backward "
          f"{row['library_ms']!r} (device_ms {row['library_device_ms']!r})",
          flush=True)
    return row


def flash_bwd_case(torch, fa, faref, shape, dtype, causal, gen, label):
    """Phase 12 (a), one flash case: the training forward's LSE against the
    plain one (1e-5 + 1e-5 |plain|), then dq, dk, dv against the plain
    gradient from the same q, k, v, out and LSE (bf16: 2^-7 |plain| +
    1e-4 max|plain|, one bf16 rounding of each and float32 sums in another
    order; float32: 1e-4 |plain| + 1e-5 max|plain|), the same bits call to
    call, on the route the type takes ("mma" for bf16, "fma" for
    float32).  Returns (the largest absolute error, the largest over
    max|plain|, the inputs)."""
    b, s, h, hk, d = shape
    dev = torch.device("cuda")
    route = fa.flash_attention_backward_route(dtype, d)
    check(route == ("mma" if dtype == torch.bfloat16 else "fma"),
          f"phase 12 (a): {dtype} takes the {route!r} route at {label}")
    q, do = (torch.randn((b, s, h, d), generator=gen, device=dev,
                         dtype=dtype) for _ in range(2))
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev,
                        dtype=dtype) for _ in range(2))
    o, lse = fa.flash_attention_forward(q, k, v, causal)
    want_lse = torch.cat([faref.attention_lse_ref(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], causal)[1] for i in range(b)])
    err, ok = within(lse, want_lse, 1e-5, 1e-5)
    check(ok, f"phase 12 (a): flash LSE differs from plain at {label}: "
          f"{err!r}")
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    again = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    want = faref.attention_backward_ref(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    rtol, arel = (2.0 ** -7, 1e-4) if dtype == torch.bfloat16 else (1e-4,
                                                                    1e-5)
    worst = worst_abs = 0.0
    for name, x, y, w in zip(("dq", "dk", "dv"), got, again, want):
        check(torch.equal(x, y), f"phase 12 (a): flash_attention_backward "
              f"{name} differs from call to call at {label}")
        scale = float(w.float().abs().max())
        e, ok = within(x, w, rtol, arel * scale)
        check(ok, f"phase 12 (a): flash_attention_backward {name} differs "
              f"from plain at {label}: {e!r} of max {scale!r}")
        worst, worst_abs = max(worst, e / scale), max(worst_abs, e)
    return worst_abs, worst, (q, k, v, o, lse, do)


def flash_bwd_instructions() -> dict:
    """Phase 12 (a): the tensor-core instructions (HMMA, HGMMA) that
    ``cuobjdump -sass`` counts in the built "mma" route's kernels,
    {kernel: {instruction: count}}; fails if the tool is found and a
    kernel has none."""
    from repro_torch.kernels import build

    tool = cuobjdump()
    if tool is None:
        print("phase 12 (a): backward kernel instructions: no cuobjdump "
              "found, not counted", flush=True)
        return {}
    counts = {}                    # one cuobjdump of the library for both
    for fn, c in sass_counts(tool, build, "flash_attention", "_mma_kernel",
                             ("HMMA", "HGMMA")).items():
        kern = "kv_mma_kernel" if "kv_mma_kernel" in fn else "q_mma_kernel"
        counts[f"{kern}<{fn.split(kern + 'ILi')[1].split('E')[0]}>"] = c
    check(len(counts) == 8, f"phase 12 (a): {len(counts)} mma backward "
                            f"kernels in the flash library's SASS, not 8")
    check(all(c["HMMA"] + c["HGMMA"] > 0 for c in counts.values()),
          f"phase 12 (a): an mma backward kernel without tensor-core "
          f"instructions: {counts}")
    print(f"phase 12 (a): mma backward kernel instructions ({tool} -sass): "
          f"{counts}", flush=True)
    return counts


def train_flash_kernel(torch, fa, faref, reps) -> dict:
    """Phase 12 (a), flash: the backward against its plain version at the
    training path's shape (B 8, S = T = 4,096, 9 heads over 3, D 64,
    bf16, causal: the "mma" route), at a float32 one (B 2, S 1,024: the
    "fma" route) and at every head dim (bf16, 2 heads a kv head, ragged
    S 300, causal and not); the tensor-core instructions of the "mma"
    kernels; its times at the path's shape beside the bound, the plain
    version's and the backward of ``F.scaled_dot_product_attention`` with
    the kv heads repeated."""
    gen = torch.Generator(device="cuda").manual_seed(122)
    bf = torch.bfloat16
    sass = flash_bwd_instructions()
    route = fa.flash_attention_backward_route(bf, FLASH_TRAIN[4])
    err, worst, inputs = flash_bwd_case(torch, fa, faref, FLASH_TRAIN, bf,
                                        True, gen, "the train_4k shape")
    print(f"phase 12 (a): flash_attention_backward ({route}) == plain at B, "
          f"S, H, HK, D = {FLASH_TRAIN} bf16 causal: max abs err {err!r}, "
          f"{worst!r} of max|plain| "
          f"(tol 2^-7|plain| + 1e-4 max), LSE within 1e-5, the same bits "
          f"call to call", flush=True)
    errs = {}
    cases = [((2, 1024, 9, 3, 64), torch.float32, True, "float32 (fma)")]
    cases += [((2, 300, 4, 2, d), bf, c,
               f"D={d} {'causal' if c else 'all'} (mma)")
              for d in fa.HEAD_DIMS for c in (True, False)]
    for shape, dtype, causal, label in cases:
        errs[label] = flash_bwd_case(torch, fa, faref, shape, dtype, causal,
                                     gen, label)[1]
    print(f"phase 12 (a): flash_attention_backward == plain (max err over "
          f"max|plain|): {errs}", flush=True)
    q, k, v, o, lse, do = inputs
    b, s, h, hk, d = FLASH_TRAIN
    kern = lambda: fa.flash_attention_backward(q, k, v, o, lse, do, True)
    plain = lambda: faref.attention_backward_ref(q, k, v, o, lse, do, True)
    rep = lambda x: x.repeat_interleave(h // hk, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (rep(x).detach().requires_grad_() for x in (k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    dot = do.transpose(1, 2)
    libf = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
    lq = libf()[0].transpose(1, 2)
    want_q = plain()[0]
    scale = float(want_q.float().abs().max())
    # the library rounds P and dS to bf16 for its products (which misses
    # 2^-7, tests/test_torch_train_gpu.py): this only checks that it
    # computes the same function, so that its time is comparable
    lerr, lok = within(lq, want_q, 2.0 ** -5, 1e-2 * scale)
    check(lok, f"phase 12 (a): SDPA's dq differs from plain: {lerr!r} of "
          f"max {scale!r}")
    bound = flash_bwd_bound(b, s, h, hk, d, 2)
    row = {"name": "flash_attention_backward", "route": "cuda",
           "kernel_route": route, "sass": sass,
           "source": FA_SOURCE, "replaces": REPLACES[
               "flash_attention_backward"], "max_abs_err": err,
           "max_err_over_max": worst, "max_err_over_max_other": errs,
           "ms": time_ms(kern, reps), "device_ms": device_ms(torch, kern,
                                                             reps)[0],
           "plain_ms": time_ms(plain, max(1, reps // 4)),
           "bound_ms": bound[0], "bound_by": bound[1],
           "library_ms": time_ms(libf, reps),
           "library_device_ms": device_ms(torch, libf, reps)[0]}
    print(f"phase 12 (a): flash_attention_backward ({route}) at "
          f"{FLASH_TRAIN} bf16: "
          f"ms {row['ms']!r}, device_ms {row['device_ms']!r}, bound "
          f"{row['bound_ms']!r} ({row['bound_by']}), plain "
          f"{row['plain_ms']!r}, SDPA backward {row['library_ms']!r} "
          f"(device_ms {row['library_device_ms']!r})", flush=True)
    return row


def forced_steps(torch, np, label, fn, p0, batches, n: int, dev,
                 route_k: int = 0):
    """``n`` train steps of ``fn`` on the CPU from parameters ``p0`` and a
    fresh AdamW state, and the same steps on the card, each taken from the
    CPU's parameters and state before it (teacher-forced: AdamW's early
    steps move an entry by ~lr · sign(g), so two free runs part at every
    entry whose gradient cancels to float32 noise, and then everywhere).
    Each card step must give the CPU's loss and grad_norm within 1e-5
    relative, its moments m within 1e-4 and v within 1e-3 of each leaf's
    largest (the gradients, float32 sums in another order), and its
    parameters within 1e-5 + 1e-6 |p| except where the step's gradient is
    under 1e-4 of its leaf's largest (there the sign may flip: at most
    ~2 lr).  The CPU replays the card's ReLU decisions (``relu_tape``, as
    phase 6 does): a unit within a rounding of 0 takes either side, and
    one such flip moves a whole row's gradient.  With ``route_k`` (an MoE
    model's top-k) it replays the card's router choices where they tie
    too (``route_tape``).  ``batches(i, device)`` gives step i's inputs.
    Returns (the CPU's losses, the largest checked
    parameter difference, the entries let off, the ReLU units that
    flipped)."""
    from repro_torch.launch.steps import OPT_CFG
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_leaves, tree_map, tree_to_numpy

    params, state = p0, opt.init(p0, OPT_CFG)
    losses, worst, let_off, flips = [], 0.0, 0, 0
    for i in range(n):
        tape, routes = relu_tape(torch), route_tape(torch, route_k)
        with tape, routes:
            card = fn(tree_map(lambda t: t.to(dev), params),
                      tree_map(lambda t: t.to(dev), state), *batches(i, dev))
        replay = relu_tape(torch, tape.inputs)
        with replay, route_tape(torch, route_k, routes):
            host = fn(params, state, *batches(i, "cpu"))
        flips += sum(int(((a > 0) != (b > 0)).sum())
                     for a, b in zip(tape.inputs, replay.inputs))
        (gp, gs, gl, gn), (wp, ws, wl, wn) = (tree_to_numpy(card),
                                              tree_to_numpy(host))
        check(abs(gl - wl) <= 1e-5 * abs(wl) and abs(gn - wn) <= 1e-5 * abs(
            wn), f"{label}: step {i} card loss {gl!r} gnorm {gn!r}, CPU "
            f"{wl!r} {wn!r}")
        for key, tol in (("m", 1e-4), ("v", 1e-3)):
            for j, (a, b) in enumerate(zip(tree_leaves(gs[key]),
                                           tree_leaves(ws[key]))):
                e = float(np.abs(a - b).max()) if a.size else 0.0
                top = float(np.abs(b).max(initial=0.0))
                check(e <= tol * top, f"{label}: step {i} {key} leaf {j} "
                      f"{a.shape} differs by {e!r}, its largest {top!r}")
        old_m = tree_leaves(tree_to_numpy(state["m"]))
        for a, b, m_new, m_old in zip(tree_leaves(gp), tree_leaves(wp),
                                      tree_leaves(ws["m"]), old_m):
            g = np.abs(m_new - OPT_CFG.b1 * m_old)
            near = g <= 1e-4 * float(g.max(initial=0.0))
            d = np.abs(a - b)
            far = d > 1e-5 + 1e-6 * np.abs(b)
            if (far & ~near).any():
                fail(f"{label}: step {i} parameters differ by "
                     f"{float(d[~near].max())!r} where the gradient is not "
                     f"near 0")
            if (~near).any():
                worst = max(worst, float(d[~near].max()))
            let_off += int((far & near).sum())
        losses.append(float(wl))
        params, state = host[0], host[1]
    return losses, worst, let_off, flips


def phase_train_deepfm(torch, np, args):
    """Phase 12 (a) for the bag and (b): DeepFM training at full width
    (39 fields x 2^20 rows, D 10, MLP 400-400-400; phase 7's parameters,
    drawn again from its seed on the card) at train_batch (B 65,536)
    through ``make_recsys_step``: the bag's backward checked and timed at
    this path's calls, 20 steps with the counts set to 0 just before and
    read just after (2 bag and 2 bag-backward launches a step), ms a step,
    rows/s, a profiled step and peak memory; then 3 card steps against 3
    CPU steps at full width with 1,024 rows a field.  Returns the bag
    backward's row."""
    from repro_torch.configs import deepfm as dcfg
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag import ref as ebref
    from repro_torch.launch import steps
    from repro_torch.models.recsys import deepfm as dfm
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_map, tree_to_numpy

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    no_tf32(torch, "phase 12 (b)")
    cfg = dcfg.CONFIG
    shape = RECSYS_SHAPES["train_batch"]
    b = shape["batch"]
    bundle = steps.make_recsys_step(cfg, shape)
    params = tree_map(lambda p: p.detach(), dfm.DeepFM(
        cfg, torch.Generator(device=dev).manual_seed(0),
        device=dev).param_tree())

    def batch(step: int):
        gen = torch.Generator(device=dev).manual_seed(1200 + step)
        x = torch.randint(0, cfg.rows_per_field, (b, cfg.n_fields),
                          generator=gen, device=dev, dtype=torch.int32)
        return x, (torch.rand(b, generator=gen, device=dev) < 0.3).float()

    ids = dfm._field_ids(batch(0)[0], cfg)
    rows = {name: train_bag_kernel(torch, eb, ebref, params[name], ids, name,
                                   args.reps) for name in ("table", "w1")}
    del ids
    row = {"name": "embedding_bag_backward", "route": "cuda",
           "source": EB_SOURCE,
           "replaces": REPLACES["embedding_bag_backward"], **rows["table"],
           **{f"{k}_w1": v for k, v in rows["w1"].items()}}
    torch.cuda.empty_cache()

    state = opt.init(params, steps.OPT_CFG)
    params, state, _, _ = bundle.fn(params, state, *batch(0))   # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_DEEPFM_STEPS
    reset_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(n):
        params, state, loss, _ = bundle.fn(params, state, *batch(i + 1))
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    counts = check_counts("phase 12 (b)", {"embedding_bag": 2 * n,
                                           "embedding_bag_backward": 2 * n})
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"phase 12 (b): losses {losses}")
    prof = profile_round(torch, "phase 12 (b): profiled DeepFM train step",
                         lambda: bundle.fn(params, state, *batch(n + 1)),
                         top=10, host_top=6)
    busy = sum(e.self_device_time_total for e in prof)
    row["launches"] = counts["embedding_bag_backward"]
    print(f"phase 12 (b): DeepFM train_batch B={b}: {n} steps, losses "
          f"{losses[0]!r} -> {losses[-1]!r}, {step_s * 1e3!r} ms a step, "
          f"{b / step_s!r} rows/s, a profiled step {busy:.0f} us busy; peak "
          f"{peak} B above the {base} B held; launches embedding_bag "
          f"{counts['embedding_bag']} and embedding_bag_backward "
          f"{counts['embedding_bag_backward']} = 2 x {n} steps", flush=True)
    del params, state, prof
    torch.cuda.empty_cache()

    # card against CPU at 1,024 rows a field
    ccfg = dataclasses.replace(cfg, rows_per_field=DEEPFM_CHECK_ROWS,
                               n_candidates=4096)
    cb = steps.make_recsys_step(ccfg, dict(shape, batch=DEEPFM_CHECK_BATCH))
    p0 = tree_map(lambda p: p.detach(), dfm.DeepFM(
        ccfg, torch.Generator().manual_seed(3), device="cpu").param_tree())
    rng = np.random.default_rng(4)
    data = [(rng.integers(0, 3 * ccfg.rows_per_field, (
        DEEPFM_CHECK_BATCH, ccfg.n_fields)).astype(np.int32),
        (rng.random(DEEPFM_CHECK_BATCH) < 0.3).astype(np.float32))
        for _ in range(TRAIN_CHECK_STEPS)]
    losses, worst, let_off, flips = forced_steps(
        torch, np, "phase 12 (b) card vs CPU", cb.fn, p0,
        lambda i, d: tuple(torch.from_numpy(a).to(d) for a in data[i]),
        TRAIN_CHECK_STEPS, dev)
    print(f"phase 12 (b): card vs CPU, {TRAIN_CHECK_STEPS} steps at "
          f"{ccfg.rows_per_field} rows a field, B={DEEPFM_CHECK_BATCH}, each "
          f"from the CPU's state: losses {losses}, loss, grad_norm, m and v "
          f"equal within tolerance, parameters within {worst!r} (tol 1e-5 + "
          f"1e-6|p|; {let_off} entries with a gradient near 0 let off); "
          f"the CPU replays the card's ReLU decisions, {flips} units "
          f"flipped; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return row


def phase_train_lm(torch, np, args, work: str):
    """Phase 12 (a) for flash and (c): smollm-135m training at full width
    and depth (bf16, remat "dots") at train_4k's S 4,096 with the batch
    cut to 8, 10 steps through ``launch.train``'s function (``--full``)
    with the counts set to 0 just before and read just after (a step: 30
    forward and 30 recomputed flash launches, 30 backward), ms a step,
    tokens/s, a profiled step and peak memory.  Returns
    flash_attention_backward's row and the phase's card-against-CPU check
    (:func:`train_lm_check`) to run."""
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.launch import steps
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.lm.transformer import Transformer
    from repro_torch.tree import tree_map, tree_to_numpy

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    row = train_flash_kernel(torch, fa, faref, args.reps)
    torch.cuda.empty_cache()
    print(f"phase 12 (a): took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    cfg = smollm_135m.CONFIG
    n = TRAIN_LM_STEPS
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    params, state, hist, bundle = tlaunch.train(
        "smollm-135m", n, os.path.join(work, "smollm_ckpt"),
        ckpt_every=n, resume=False, full=True, device=dev,
        log=lambda *_: None, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layers = cfg.n_layers
    counts = check_counts("phase 12 (c)", {
        "flash_attention": 2 * layers * n,
        "flash_attention_backward": layers * n})
    peak = torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in hist]
    check(len(hist) == n and all(np.isfinite(losses)),
          f"phase 12 (c): losses {losses}")
    step_s = float(np.mean([h["step_time_s"] for h in hist[1:]]))
    tokens = tlaunch.FULL_BATCH * 4096
    shape = dict(kind="train", seq_len=4096,
                 global_batch=tlaunch.FULL_BATCH)
    tok = tlaunch.synthetic_batch(cfg, shape, n, tlaunch.SEED, dev)
    prof = profile_round(torch, "phase 12 (c): profiled smollm-135m train "
                         "step", lambda: bundle.fn(params, state, tok),
                         top=12, host_top=6)
    busy = sum(e.self_device_time_total for e in prof)
    row["launches"] = counts["flash_attention_backward"]
    row["launches_forward"] = counts["flash_attention"]
    print(f"phase 12 (c): smollm-135m train_4k (L={layers}, S=4096, "
          f"B={tlaunch.FULL_BATCH}, bf16, remat {cfg.remat}): {n} steps in "
          f"{wall:.1f} s (the first {hist[0]['step_time_s']!r} s), losses "
          f"{losses[0]!r} -> {losses[-1]!r}, {step_s * 1e3!r} ms a step, "
          f"{tokens / step_s!r} tokens/s, a profiled step {busy:.0f} us "
          f"busy; peak {peak} B above the {base} B held; launches "
          f"flash_attention {counts['flash_attention']} = 2 x {layers} x "
          f"{n} (forward and remat's recompute), flash_attention_backward "
          f"{counts['flash_attention_backward']} = {layers} x {n}",
          flush=True)
    del params, state, bundle, prof, tok
    torch.cuda.empty_cache()
    return row, lambda: train_lm_check(torch, np, t_phase)


def train_lm_check(torch, np, t_phase: float) -> None:
    """Phase 12 (c)'s checks: 3 train steps on the card, each from the
    CPU's state, against the CPU's, in float32 at smollm-135m's width with
    2 layers, S 256, B 2; then :func:`remat_check`."""
    from repro_torch.configs import smollm_135m
    from repro_torch.launch import steps
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.lm.transformer import Transformer
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    ccfg = dataclasses.replace(smollm_135m.CONFIG, n_layers=LM_CHECK[0],
                               dtype=torch.float32)
    cshape = dict(kind="train", seq_len=LM_CHECK[1],
                  global_batch=LM_CHECK[2])
    cb = steps.make_lm_step(ccfg, cshape)
    p0 = tree_map(lambda p: p.detach(), Transformer(
        ccfg, torch.Generator().manual_seed(2), device="cpu").param_tree())
    losses, worst, let_off, _ = forced_steps(
        torch, np, "phase 12 (c) card vs CPU", cb.fn, p0,
        lambda i, d: (tlaunch.synthetic_batch(ccfg, cshape, i, 8, d),),
        TRAIN_CHECK_STEPS, dev)
    print(f"phase 12 (c): card vs CPU (float32, width 576, {LM_CHECK[0]} "
          f"layers, S {LM_CHECK[1]}, B {LM_CHECK[2]}, {TRAIN_CHECK_STEPS} "
          f"steps each from the CPU's state; the card's attention the flash "
          f"kernel, the CPU's plain): losses {losses}, loss, grad_norm, m "
          f"and v equal within tolerance, parameters within {worst!r} (tol "
          f"1e-5 + 1e-6|p|; {let_off} entries with a gradient near 0 let "
          f"off); {time.perf_counter() - t_phase:.1f} s", flush=True)
    remat_check(torch)


def remat_check(torch) -> None:
    """Phase 12 (c)'s remat check: one bf16 train step at smollm-135m's
    width with 2 layers, S 256, B 2 on the card under each of remat none,
    dots and full, from the same parameters, optimizer state and batch.
    Remat changes memory, not values: the three must give equal
    parameters, optimizer state, loss and grad_norm bit for bit, though
    under dots and full the flash forward (with its LSE) runs again in the
    backward and under full the matmuls do too.  Each mode's launches are
    counted: L forward flash launches under none, 2L under dots and full,
    L backward under each."""
    from repro_torch.configs import smollm_135m
    from repro_torch.launch import steps
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.lm.transformer import Transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    layers, s, b = REMAT_CHECK
    cfg = dataclasses.replace(smollm_135m.CONFIG, n_layers=layers)
    shape = dict(kind="train", seq_len=s, global_batch=b)
    params = tree_map(lambda p: p.detach(), Transformer(
        cfg, torch.Generator(device=dev).manual_seed(6),
        device=dev).param_tree())
    state = opt.init(params, steps.OPT_CFG)
    tok = tlaunch.synthetic_batch(cfg, shape, 0, 10, dev)
    outs, forward = {}, {}
    for mode in REMAT_MODES:
        fn = steps.make_lm_step(cfg, shape, remat_override=mode).fn
        reset_counts()
        outs[mode] = tree_leaves(fn(params, state, tok))
        torch.cuda.synchronize()
        forward[mode] = check_counts(f"phase 12 (c) remat {mode}", {
            "flash_attention": layers * (1 if mode == "none" else 2),
            "flash_attention_backward": layers})["flash_attention"]
    n = len(outs["none"])
    for mode in REMAT_MODES[1:]:
        diff = [i for i, (a, c) in enumerate(zip(outs["none"], outs[mode]))
                if not torch.equal(a, c)]
        check(not diff, f"phase 12 (c): remat {mode} on the card differs "
              f"from none at leaves {diff} of {n} (parameters, optimizer "
              f"state, then loss and grad_norm)")
    loss, gn = (float(x) for x in outs["none"][-2:])
    print(f"phase 12 (c): remat none, dots and full on the card (bf16, "
          f"width 576, {layers} layers, S {s}, B {b}, one step from the "
          f"same state): all {n} leaves equal bit for bit (loss {loss!r}, "
          f"grad_norm {gn!r}); flash_attention launches {forward} "
          f"(the recompute under dots and full), flash_attention_backward "
          f"{layers} each; {time.perf_counter() - t0:.1f} s", flush=True)


def resume_run(torch, name: str, ckpt_dir: str, total: int,
               stop: int | None = None):
    """One of phase 12 (d)'s runs: ``name`` ("deepfm" at reduced rows, or
    "lm", smollm's width with 2 layers in bf16) from seeded parameters on
    the card, through ``run_training`` to ``total`` steps with a
    checkpoint every RESUME_K steps, resuming from ``ckpt_dir``'s newest
    checkpoint; the batch of step i is drawn from a seed and i, and the
    stream raises ``_Stopped`` where step ``stop`` would begin.  Returns
    (params, state, history)."""
    from repro_torch.configs import deepfm as dcfg
    from repro_torch.configs import smollm_135m
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.launch import steps
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.lm.transformer import Transformer
    from repro_torch.models.recsys import deepfm as dfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainLoopConfig, run_training
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    if name == "deepfm":
        cfg = dataclasses.replace(dcfg.CONFIG, rows_per_field=RESUME_ROWS,
                                  n_candidates=4096)
        b = RESUME_BATCH
        bundle = steps.make_recsys_step(cfg, dict(
            RECSYS_SHAPES["train_batch"], batch=b))
        model = dfm.DeepFM(cfg, gen, device=dev)

        def batch(step):
            g = torch.Generator(device=dev).manual_seed(1300 + step)
            x = torch.randint(0, cfg.rows_per_field, (b, cfg.n_fields),
                              generator=g, device=dev, dtype=torch.int32)
            return x, (torch.rand(b, generator=g, device=dev) < 0.3).float()

        def step_fn(params, state, xy):
            return bundle.fn(params, state, *xy)
    else:
        cfg = dataclasses.replace(smollm_135m.CONFIG, n_layers=RESUME_LM[0])
        shape = dict(kind="train", seq_len=RESUME_LM[1],
                     global_batch=RESUME_LM[2])
        step_fn = steps.make_lm_step(cfg, shape).fn
        model = Transformer(cfg, gen, device=dev)

        def batch(step):
            return tlaunch.synthetic_batch(cfg, shape, step, 9, dev)

    params = tree_map(lambda p: p.detach(), model.param_tree())
    del model

    def batches(start):
        step = start
        while True:
            if step == stop:
                raise _Stopped
            yield batch(step)
            step += 1

    return run_training(step_fn, params, opt.init(params, steps.OPT_CFG),
                        batches, TrainLoopConfig(
                            total_steps=total, ckpt_every=RESUME_K,
                            ckpt_dir=ckpt_dir, log_every=1),
                        log=lambda *_: None)


def train_child(work: str) -> None:
    """Phase 12 (d)'s killed runs, in a process of its own: under
    deterministic algorithms, each model trains to its checkpoint at step
    RESUME_K and stops where step RESUME_K would begin; then the process
    says so and waits for its SIGKILL."""
    import torch

    torch.use_deterministic_algorithms(True)
    for name in RESUME_MODELS:
        try:
            resume_run(torch, name, os.path.join(work, f"killed_{name}"),
                       2 * RESUME_K, stop=RESUME_K)
        except _Stopped:
            pass
        else:
            fail(f"phase 12 (d): {name} ran past step {RESUME_K}")
    print("phase 12 (d) child: checkpointed", flush=True)
    time.sleep(CHILD_TIMEOUT_S)
    fail("phase 12 (d): the child was not killed")


def start_train_child(work: str):
    """Phase 12 (d)'s child process, started early so that its start-up
    runs beside (c)'s check: (the process, its start time)."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-child", work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), time.perf_counter()


def phase_train_resume(torch, work: str, started) -> None:
    """Phase 12 (d): the trainer killed and resumed.  A child process
    (``chip_smoke.py --train-child``) trains DeepFM (39 fields x 65,536
    rows, B 4,096) and smollm's width with 2 layers (bf16, S 512, B 2) to
    their checkpoints at step k = RESUME_K and is SIGKILLed; this process
    resumes each to 2k, its batch stream starting at batch k, and must
    equal an uninterrupted 2k-step run here bit for bit (parameters,
    optimizer state, losses).  All of it under
    ``torch.use_deterministic_algorithms(True)`` (cuBLAS's workspace set
    by CUBLAS_WORKSPACE_CONFIG at the script's start): an op without a
    deterministic version raises instead of passing."""
    import signal
    import threading

    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.tree import tree_leaves

    child, t0 = started
    timer = threading.Timer(CHILD_TIMEOUT_S, child.kill)
    timer.start()
    said = []
    for line in child.stdout:
        said.append(line)
        if "checkpointed" in line:
            os.kill(child.pid, signal.SIGKILL)
            break
    child.wait()
    timer.cancel()
    check(child.returncode == -signal.SIGKILL,
          f"phase 12 (d): the child ended with {child.returncode}: "
          f"{''.join(said)[-3000:]}")
    child_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(True)
    try:
        for name in RESUME_MODELS:
            killed = os.path.join(work, f"killed_{name}")
            check(CheckpointManager(killed).steps() == [RESUME_K],
                  f"phase 12 (d): {name}'s checkpoints "
                  f"{CheckpointManager(killed).steps()}")
            t1 = time.perf_counter()
            p1, s1, h1 = resume_run(torch, name, killed, 2 * RESUME_K)
            p2, s2, h2 = resume_run(torch, name, os.path.join(
                work, f"whole_{name}"), 2 * RESUME_K)
            check([h["step"] for h in h1] == list(range(RESUME_K,
                                                        2 * RESUME_K)),
                  f"phase 12 (d): {name} resumed at {h1[0]['step']}")
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves((p1, s1)), tree_leaves((p2, s2))))
            same_loss = [h["loss"] for h in h1] == [
                h["loss"] for h in h2[RESUME_K:]]
            check(same and same_loss, f"phase 12 (d): {name} killed at step "
                  f"{RESUME_K} and resumed differs from the whole run "
                  f"(parameters and state equal: {same}; losses "
                  f"{[h['loss'] for h in h1]} / "
                  f"{[h['loss'] for h in h2[RESUME_K:]]})")
            print(f"phase 12 (d): {name}: SIGKILLed after its checkpoint at "
                  f"step {RESUME_K}, resumed to {2 * RESUME_K} == the whole "
                  f"run bit for bit (parameters, optimizer state, losses "
                  f"{[h['loss'] for h in h1]}); the two runs here "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"phase 12 (d): the child (started before (c)'s check; both runs "
          f"to step {RESUME_K}) {child_s:.1f} s; took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def smoke_batch(np, spec, cfg, args, seed):
    """Numpy inputs of a smoke train step's meta ``args``, in valid
    ranges (tokens below the vocabulary, edge ids below the node count,
    labels below the class count, raw DeepFM ids up to 3x a field's
    rows)."""
    rng = np.random.default_rng(seed)
    if spec.family == "lm":
        return [rng.integers(0, cfg.vocab, tuple(args[0].shape)).astype(
            np.int32)]
    if spec.family == "recsys":
        x, y = args
        return [rng.integers(0, 3 * cfg.rows_per_field,
                             tuple(x.shape)).astype(np.int32),
                (rng.random(tuple(y.shape)) < 0.3).astype(np.float32)]
    a = args[0]
    n = a["feats"].shape[-2]
    shp = lambda key: tuple(a[key].shape)
    return [{"feats": rng.normal(size=shp("feats")).astype(np.float32),
             "edge_index": rng.integers(0, n, shp("edge_index")).astype(
                 np.int32),
             "edge_mask": rng.random(shp("edge_mask")) < 0.8,
             "labels": rng.integers(0, cfg.n_classes, shp("labels")).astype(
                 np.int32),
             "label_mask": rng.random(shp("label_mask")) < 0.8,
             "positions": rng.normal(size=shp("positions")).astype(
                 np.float32)}]


def phase_train_archs(torch, np) -> None:
    """Phase 12 (e): one smoke ``make_step`` train step of every arch (the
    LMs at train_4k, the MoE ones too, the GNNs at full_graph_sm, DeepFM at
    train_batch) on the card against the CPU from the same parameters and
    batch, as :func:`forced_steps` holds them.  PNA runs in float64, as
    in phase 11 (d): in float32 its max, min and std's clamp decide near
    ties by a rounding."""
    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map, tree_to_numpy

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    shape_of = {"lm": "train_4k", "gnn": "full_graph_sm",
                "recsys": "train_batch"}
    done = []
    for arch in ARCH_IDS:
        spec = get_arch(arch)
        bundle = steps.make_step(spec, shape_of[spec.family], smoke=True)
        cfg = bundle.model.cfg
        p0 = tree_map(lambda p: p.detach(), bundle.model.__class__(
            cfg, device="cpu").param_tree())
        data = smoke_batch(np, spec, cfg, bundle.args[2:], 12)
        f64 = arch == "pna"
        if f64:
            p0 = tree_map(lambda p: p.double(), p0)

        def batches(i, d):
            return [tree_map(lambda a: (lambda t: t.double() if f64 and
                                        t.is_floating_point() else t)(
                torch.from_numpy(np.asarray(a)).to(d)), x) for x in data]

        reset_counts()
        moe = getattr(cfg, "moe", None)
        losses, worst, let_off, flips = forced_steps(
            torch, np, f"phase 12 (e) {arch}", bundle.fn, p0, batches, 1,
            dev, moe.top_k if moe is not None else 0)
        counts = {k: v for k, v in all_counts().items() if v}
        done.append(f"{arch} ({'float64; ' if f64 else ''}loss "
                    f"{losses[0]!r}, parameters within {worst!r}, {let_off} "
                    f"let off, {flips} ReLU flips"
                    f"{', launches ' + str(counts) if counts else ''})")
    print(f"phase 12 (e): one smoke train step on the card == the CPU's "
          f"(as forced_steps holds them): "
          f"{'; '.join(done)}; {time.perf_counter() - t0:.1f} s", flush=True)


def phase_train_compression(torch, np) -> None:
    """Phase 12 (f): int8 error-feedback compression
    (``train.compression.psum_compressed``) at world 1 on the card (NCCL)
    against the CPU (gloo): two steps over a gradient tree (a 1,024 x
    1,024 leaf, a small one, a zero one), the residual carried, equal bit
    for bit; the first step's error within a quantization step."""
    from repro_torch.dist import compat
    from repro_torch.train import compression as comp
    from repro_torch.tree import tree_leaves, tree_map, tree_to_numpy

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    grads = [{"w": rng.normal(size=(1024, 1024)).astype(np.float32),
              "b": [rng.normal(size=(4096,)).astype(np.float32) * 1e-3,
                    np.zeros((7,), np.float32)]} for _ in range(2)]
    outs = {}
    for key, dev, backend in (("card", torch.device("cuda"), "nccl"),
                              ("cpu", torch.device("cpu"), "gloo")):
        with compat.world1(backend):
            res = comp.init_residuals(tree_map(
                lambda a, _d=dev: torch.from_numpy(a).to(_d), grads[0]))
            steps = []
            for g in grads:
                out, res = comp.psum_compressed(tree_map(
                    lambda a, _d=dev: torch.from_numpy(a).to(_d), g), res)
                steps.append(tree_to_numpy((out, res)))
        outs[key] = steps
    same = all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(outs["card"]), tree_leaves(outs["cpu"])))
    check(same, "phase 12 (f): psum_compressed on the card differs from "
          "the CPU's")
    err = float(np.abs(outs["card"][0][0]["w"] - grads[0]["w"]).max())
    scale = float(np.abs(grads[0]["w"]).max()) / 127
    check(err <= scale, f"phase 12 (f): error {err!r} > a step {scale!r}")
    print(f"phase 12 (f): psum_compressed at world 1, card (NCCL) == CPU "
          f"(gloo) bit for bit over 2 steps (means and residuals); step 1's "
          f"largest error {err!r} within its quantization step {scale!r}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_train(torch, np, args) -> list:
    """Phase 12: training.  Returns the backward kernels' rows."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        bag_row = phase_train_deepfm(torch, np, args)
        flash_row, lm_check = phase_train_lm(torch, np, args, work)
        started = start_train_child(work)
        lm_check()
        phase_train_resume(torch, work, started)
        phase_train_archs(torch, np)
        phase_train_compression(torch, np)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 12: took {time.perf_counter() - t0:.1f} s", flush=True)
    return [bag_row, flash_row]

def serve_oracle(np, edges, n: int, vs) -> dict:
    """{v: sorted unique neighbors of v over both columns of the edge
    list} for each v of ``vs``, from the edge list alone."""
    sel = np.zeros(n, bool)
    sel[vs] = True
    keys = []
    for a, b in ((0, 1), (1, 0)):
        hit = sel[edges[:, a]]
        keys.append(edges[hit, a].astype(np.int64) * n + edges[hit, b])
    keys = np.unique(np.concatenate(keys))
    owner, starts = np.unique(keys // n, return_index=True)
    rows = dict(zip(owner.tolist(), np.split(keys % n, starts[1:])))
    return {v: rows.get(v, np.zeros(0, np.int64))
            for v in map(int, vs)}


def serve_single(art_dir: str, targets, probe, walks,
                 submitted: float) -> dict:
    """Phase 14 (a), in a pool process beside phases 10-11: the
    single-process configuration, a ``ShardStore`` over every partition
    of ``art_dir`` (``SERVE_ROWS`` rows a shard), then
    ``bench_serve.py``'s storm, the ``targets``' neighbor queries with
    ``batch=0``, once with the LRU at ``SERVE_CACHE`` entries and once
    with it off.  Then, cache on, each ``probe`` vertex's neighbors,
    degree and fan-out, and each ``walks`` vertex's 2-hop set and ppr
    (eps 1e-3) with the neighbor calls each made."""
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.runtime.artifact import load_artifact
    from repro_torch.serve import LRUCache, PartitionService, ShardStore

    waited = time.time() - submitted
    t_job = time.perf_counter()
    art = load_artifact(art_dir)
    t0 = time.perf_counter()
    store = ShardStore(art, rows_per_shard=SERVE_ROWS,
                       cache_entries=SERVE_CACHE)
    build_s = time.perf_counter() - t0
    arms = {}
    for label, cache in (("cache on", SERVE_CACHE), ("cache off", 0)):
        store.cache, store.decodes = LRUCache(cache), 0
        svc = PartitionService(store, batch=0)
        lats = np.empty(len(targets))
        for i, v in enumerate(targets):
            t0 = time.perf_counter()
            svc.neighbors(v)
            lats[i] = (time.perf_counter() - t0) * 1e6
        p50, p99 = (float(x) for x in np.percentile(lats, [50, 99]))
        arms[label] = {"mean_us": float(lats.mean()), "p50_us": p50,
                       "p99_us": p99,
                       "hit_ratio": store.cache.hit_ratio(),
                       "decodes": store.decodes}
        svc.close()
    store.cache = LRUCache(SERVE_CACHE)
    svc = PartitionService(store, batch=0)
    answers = {}
    for v in map(int, probe):
        nbrs = svc.neighbors(v)
        answers[v] = (nbrs, svc.degree(v), svc._fanout[-1])
    walked = {}
    for v in map(int, walks):
        s0 = svc.served
        hop = svc.k_hop(v, 2)
        s1 = svc.served
        mass = svc.ppr(v, eps=SERVE_PPR_EPS)
        walked[v] = (hop, s1 - s0, mass, svc.served - s1)
    st = store.stats()
    return {"waited_s": waited, "build_s": build_s,
            "bytes": st["compressed_bytes"],
            "shards": sum(ps.num_shards for ps in store._parts.values()),
            "arms": arms, "answers": answers, "walks": walked,
            "job_s": time.perf_counter() - t_job}


def start_serving(np, pool, art_dir: str, edges, rf: float, work: str):
    """Phase 14's start, right after phase 9 (``art_dir`` is (b)'s
    artifact, ``edges`` phase 3's edge list and ``rf`` its RF): the
    checked vertices and their oracle from the edge list, then a
    ``SERVE_GROUPS``-member gang launched in a thread and the
    single-process job submitted to ``pool`` (their stores build beside
    phases 10-11).  Returns what ``phase_serve`` reads."""
    from repro_torch.runtime.artifact import load_artifact
    from repro_torch.serve import launch_serving_gang

    t0 = time.perf_counter()
    art = load_artifact(art_dir)
    reps = art.replica_counts()
    # the artifact's non-isolated and boundary vertices, as
    # vparts.any(axis=1) and boundary_vertices() give them
    verts, boundary = np.flatnonzero(reps > 0), np.flatnonzero(reps > 1)
    rf_mean = float(reps.mean())
    print(f"phase 14: the artifact's replica counts: mean over all "
          f"{reps.size} vertices {rf_mean!r}, over the {verts.size} "
          f"non-isolated {float(reps[verts].mean())!r}; the manifest's RF "
          f"{art.replication_factor!r}, phase 3's {rf!r}", flush=True)
    check(rf_mean == art.replication_factor == rf,
          f"phase 14: the mean replica count {rf_mean!r}, the artifact's "
          f"RF {art.replication_factor!r} and phase 3's {rf!r} differ")
    # bench_serve.py's stream: Zipf ranks over the non-isolated vertices,
    # rank r asking verts[min(r - 1, n - 1)]; checked: its first distinct
    # targets and a draw of boundary vertices
    a, seed = SERVE_ZIPF
    ranks = np.random.default_rng(seed).zipf(a, size=SERVE_QUERIES)
    targets = verts[np.minimum(ranks - 1, verts.size - 1)]
    count, seed = SERVE_PROBE
    _, first = np.unique(targets, return_index=True)
    head = targets[np.sort(first)][:count]
    drawn = np.random.default_rng(seed).choice(
        boundary, size=min(count, boundary.size), replace=False)
    # the traversals start from boundary vertices of low degree (a hub's
    # 2-hop set is millions of vertices, an HTTP call each): the first
    # ones of a larger draw, since few of the 512 drawn qualify
    t1 = time.perf_counter()
    count, bound, pool_size = SERVE_WALKS
    cand = np.random.default_rng(SERVE_PROBE[1]).choice(
        boundary, size=min(pool_size, boundary.size), replace=False)
    found = serve_oracle(np, edges, art.num_vertices,
                         np.unique(np.concatenate([head, drawn, cand])))
    walks = [v for v in map(int, cand) if found[v].size <= bound][:count]
    check(len(walks) == count,
          f"phase 14: {len(walks)} of {cand.size} drawn boundary vertices "
          f"have degree <= {bound}, not {count}")
    probe = np.unique(np.concatenate([head, drawn, walks]))
    oracle = {v: found[v] for v in probe.tolist()}
    oracle_s = time.perf_counter() - t1
    bus = os.path.join(work, "serve_live")
    launcher = ThreadPoolExecutor(1)

    def launch():
        t = time.perf_counter()
        gang = launch_serving_gang(
            art_dir, SERVE_GROUPS, log_dir=os.path.join(work, "serve_logs"),
            cache=SERVE_CACHE, batch=0, timeout_s=SERVE_READY_S,
            extra_env={"PYTHONPATH": SRC, "REPRO_LIVE_METRICS": bus})
        return gang, time.perf_counter() - t

    gang = launcher.submit(launch)
    launcher.shutdown(wait=False)
    job = pool.submit(serve_single, art_dir, targets, probe, walks,
                      time.time())
    print(f"phase 14: started the {SERVE_GROUPS}-member gang and the "
          f"single-process job; {probe.size} checked vertices ({head.size} "
          f"Zipf heads, {drawn.size} boundary draws, {count} traversal "
          f"starts of degree <= {bound} from {cand.size} more), their "
          f"oracle from phase 3's edge list, in "
          f"{oracle_s:.2f} s; traversals from {walks}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"art": art, "reps": reps, "targets": targets, "oracle": oracle,
            "walks": walks, "gang": gang, "job": job, "bus": bus}


def stop_serving(serving) -> None:
    """Closes phase 14's gang, whatever phase 14 reached."""
    if serving is not None:
        try:
            serving["gang"].result(timeout=SERVE_READY_S)[0].close()
        except Exception:  # noqa: BLE001 — its launch failed: nothing up
            pass


def phase_serve(np, serving) -> None:
    """Phase 14: phase 9's artifact served.  (a) the single-process job's
    storms (cache on, cache off) and store; (b) the gang: time to ready,
    ``SERVE_GANG_QUERIES`` Zipf queries in sequence through
    ``GangClient`` (QPS, p50, p99, the fan-out histogram beside the
    queried vertices' mean replica count).  Checks: each checked vertex's
    neighbors in the single process and through the gang equal the
    oracle and its degree their length; the full store's fan-out equals
    the replica count, the gang's is at most it (the client raises
    otherwise); features through the gang are ``vertex_features``'
    bytes; each traversal through the gang equals the single process's
    (``ppr`` dicts by ``==``); ``/health`` lists each member's
    round-robin group, ``/metrics`` carries
    ``repro_serve_requests_total``, the live bus shows both members
    serving with a qps; member 1 terminated is ``poll_dead() == [1]``;
    after ``close()`` no member is left."""
    import urllib.request

    from repro_torch.obs.monitor import BusMonitor
    from repro_torch.serve import (GangClient, group_partitions,
                                   vertex_features)

    t_phase = time.perf_counter()
    art, reps, oracle = serving["art"], serving["reps"], serving["oracle"]
    one = serving["job"].result()
    arms = one["arms"]
    print(f"phase 14 (a): the single-process store (every partition, "
          f"{SERVE_ROWS} rows a shard) built in {one['build_s']!r} s "
          f"beside phases 10-11, {one['bytes']} compressed B in "
          f"{one['shards']} shards; the job waited {one['waited_s']:.1f} s"
          f" and took {one['job_s']:.1f} s; {SERVE_QUERIES} Zipf queries, "
          f"batch 0: " + "; ".join(
              f"{k}: mean {a['mean_us']!r} us, p50 {a['p50_us']!r} us, "
              f"p99 {a['p99_us']!r} us, hit ratio {a['hit_ratio']!r}, "
              f"{a['decodes']} decodes" for k, a in arms.items()),
          flush=True)
    check(arms["cache on"]["p99_us"] < arms["cache off"]["p99_us"],
          "phase 14 (a): the cache-on p99 is not below the cache-off p99")
    for v, want in oracle.items():
        nbrs, deg, fanout = one["answers"][v]
        check(np.array_equal(nbrs, want) and deg == want.size,
              f"phase 14 (a): vertex {v}'s neighbors or degree differ "
              f"from phase 3's edge list")
        check(fanout == reps[v],
              f"phase 14 (a): vertex {v} fanned out to {fanout} "
              f"partitions, not its {reps[v]} replicas")

    gang, ready_s = serving["gang"].result(timeout=SERVE_READY_S)
    cli = GangClient(art, gang.ports)
    queried = serving["targets"][:SERVE_GANG_QUERIES]
    lats = np.empty(queried.size)
    t0 = time.perf_counter()
    for i, v in enumerate(queried.tolist()):
        t = time.perf_counter()
        cli.neighbors(v)
        lats[i] = (time.perf_counter() - t) * 1e3
    storm_s = time.perf_counter() - t0
    cst = cli.stats()
    p50, p99 = (float(x) for x in np.percentile(lats, [50, 99]))
    rep_mean = float(reps[queried].mean())
    print(f"phase 14 (b): the gang ready {ready_s!r} s after its launch; "
          f"{queried.size} Zipf queries in sequence through GangClient: "
          f"{queried.size / storm_s!r} QPS, p50 {p50!r} ms, p99 {p99!r} "
          f"ms; fan-out {cst['fanout_hist']}, mean "
          f"{cst['fanout_mean']!r} beside the queried vertices' mean "
          f"replica count {rep_mean!r}", flush=True)
    check(max(cst["fanout_hist"]) <= SERVE_GROUPS
          and cst["fanout_mean"] <= rep_mean,
          f"phase 14 (b): fan-out {cst['fanout_hist']} exceeds the "
          "replica counts")

    t0 = time.perf_counter()

    def differ(items):
        # a client a thread: GangClient counts without a lock
        c = GangClient(art, gang.ports)
        return [v for v, want in items
                if not (np.array_equal(c.neighbors(v), want)
                        and c.degree(v) == want.size)]

    items = list(oracle.items())
    with ThreadPoolExecutor(SERVE_CHECK_THREADS) as ex:
        bad = sum(ex.map(differ, [items[i::SERVE_CHECK_THREADS]
                                  for i in range(SERVE_CHECK_THREADS)]), [])
    check(not bad, f"phase 14 (b): vertices {bad[:8]}' neighbors or degrees "
          "through the gang differ from phase 3's edge list")
    feats = list(oracle)[:64]
    check(all(cli.feature(v).tobytes()
              == vertex_features(np.asarray([v]))[0].tobytes()
              for v in feats),
          "phase 14 (b): features through the gang differ from "
          "vertex_features'")
    walked = []
    for v in serving["walks"]:
        hop1, calls1, mass1, pcalls1 = one["walks"][v]
        s0 = cli.served
        hop = cli.k_hop(v, 2)
        s1 = cli.served
        mass = cli.ppr(v, eps=SERVE_PPR_EPS)
        check(np.array_equal(hop, hop1) and mass == mass1,
              f"phase 14 (b): vertex {v}'s 2-hop set or ppr through the "
              "gang differ from the single process's")
        walked.append(f"{v}: 2-hop {hop.size} vertices, {s1 - s0} "
                      f"(single {calls1}) calls; ppr {len(mass)} vertices, "
                      f"{cli.served - s1} (single {pcalls1}) calls")
    print(f"phase 14 (b): {len(oracle)} vertices' neighbors and degrees "
          f"through the gang == phase 3's edge list == the single "
          f"process's, fan-out == the replica count in the full store; "
          f"{len(feats)} features == vertex_features' bytes; traversals "
          f"== the single process's ({'; '.join(walked)}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    for g, h in enumerate(cli.health()):
        check(h["partitions"] == group_partitions(art.num_partitions, g,
                                                  SERVE_GROUPS),
              f"phase 14: member {g} serves {h['partitions']}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{gang.ports[g]}/metrics") as resp:
            check("repro_serve_requests_total" in resp.read().decode(),
                  f"phase 14: member {g}'s /metrics lacks "
                  "repro_serve_requests_total")
    served = [s["served"] for s in cli.gang_stats()]
    deadline = time.monotonic() + 15
    while True:
        mon = BusMonitor(serving["bus"])
        mon.poll()
        rows = mon.assess()["hosts"]
        if (len(rows) == SERVE_GROUPS
                and all(r["phase"] == "serve" and r["qps"] is not None
                        for r in rows.values())):
            break
        check(time.monotonic() < deadline,
              f"phase 14: the live bus shows {rows}, not both members "
              "serving")
        time.sleep(0.25)
    gang.procs[1].terminate()
    gang.procs[1].wait(timeout=30)
    dead = gang.poll_dead()
    gang.close()
    check(dead == [1], f"phase 14: poll_dead() is {dead}, not [1]")
    check(all(p.poll() is not None for p in gang.procs),
          "phase 14: a gang member outlived close()")
    print(f"phase 14: /health lists each member's round-robin group, "
          f"/metrics carries repro_serve_requests_total, the live bus "
          f"shows {len(rows)} members serving (qps "
          f"{[r['qps'] for r in rows.values()]}); served {served}; member "
          f"1 terminated: poll_dead() == [1]; no member left after "
          f"close(); phase 14 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --------------------------------------------------------------------------
# phase 15: the device mesh and the sharded steps, world 1 on the card
# --------------------------------------------------------------------------

def tree_equal(torch, got, want) -> bool:
    """Two tensor trees (in tree_leaves order) equal bit for bit; ``want``
    may lie on the host (each leaf is compared on ``got``'s device)."""
    from repro_torch.tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x, y.to(x.device)) for x, y in zip(a, b))


def step_ms(secs) -> float:
    """ms a step: the median of the steps after the first (the first
    builds the caches and the allocator's pool)."""
    import statistics

    return statistics.median(secs[1:]) * 1e3


def mesh_steps(torch, fn, start: list, batches) -> tuple:
    """Train steps of ``fn`` from ``start`` = [params, state], which it
    empties (so that each step's inputs are freed as the next is made),
    one a batch, each timed on the host clock to its synchronise:
    (params, state, losses, grad norms, seconds a step)."""
    params, state = start
    start.clear()
    losses, norms, secs = [], [], []
    for tok in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, gn = fn(params, state, *tok)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(float(gn))
    return params, state, losses, norms, secs


def mesh_train_olmoe(torch, np, mesh, card: str) -> None:
    """Phase 15 (a): olmoe-1b-7b train_4k at full width with MESH_LAYERS of
    its 16 layers (bf16, remat "dots", S 4,096, B MESH_BATCH), MESH_STEPS
    steps through ``make_step(..., mesh=make_host_mesh(1))`` (EP and DP
    under ``mesh_context``) with the counts set to 0 just before and read
    just after, against the same steps mesh-free from the same seeded
    parameters and batches: loss, grad norm, parameters, m and v bit for
    bit.  ms a step (:func:`step_ms`, each way), tokens/s and peak memory
    of the mesh run."""
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.dist import compat
    from repro_torch.launch import steps
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.lm.transformer import Transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda")
    cfg = dataclasses.replace(olmoe_1b_7b.CONFIG, n_layers=MESH_LAYERS)
    shape = dict(kind="train", seq_len=4096, global_batch=MESH_BATCH)
    ocfg = steps.lm_opt_config(cfg)
    batches = [(tlaunch.synthetic_batch(cfg, shape, i, tlaunch.SEED, dev),)
               for i in range(MESH_STEPS)]

    def init():
        gen = torch.Generator(device=dev).manual_seed(tlaunch.SEED)
        p = tree_map(lambda t: t.detach(),
                     Transformer(cfg, gen, device=dev).param_tree())
        return p, opt.init(p, ocfg)

    t0 = time.perf_counter()
    free = steps.make_lm_step(cfg, shape)
    start = list(init())
    nparam = sum(t.numel() for t in tree_leaves(start[0]))
    out = mesh_steps(torch, free.fn, start, batches)
    f_loss, f_norm, f_secs = out[2:]
    t_free = time.perf_counter() - t0
    want = tree_map(lambda t: t.cpu(), out[:2])    # 19 GB: both do not fit
    del out
    torch.cuda.empty_cache()
    t_copy = time.perf_counter() - t0 - t_free

    meshed = steps.make_lm_step(cfg, shape, mesh)     # make_step's LM path
    start = [compat.shard_tree(x, lay, mesh)
             for x, lay in zip(init(), meshed.layout[:2])]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params, state, m_loss, m_norm, m_secs = mesh_steps(
        torch, meshed.fn, start, batches)
    L = cfg.n_layers
    counts = check_counts("phase 15 (a)", {
        "flash_attention": 2 * L * MESH_STEPS,
        "flash_attention_backward": L * MESH_STEPS})
    peak = torch.cuda.max_memory_allocated()
    check(m_loss == f_loss and m_norm == f_norm,
          f"phase 15 (a): mesh losses {m_loss} norms {m_norm}, mesh-free "
          f"{f_loss} {f_norm}")
    check(all(np.isfinite(m_loss)), f"phase 15 (a): losses {m_loss}")
    t1 = time.perf_counter()
    check(tree_equal(torch, (params, state), want),
          "phase 15 (a): the mesh step's parameters or optimizer state "
          "differ from the mesh-free step's")
    t_cmp = time.perf_counter() - t1
    tokens = MESH_BATCH * 4096
    m_ms, f_ms = step_ms(m_secs), step_ms(f_secs)
    print(f"phase 15 (a): {cfg.name} train_4k at full width, {L} of 16 "
          f"layers ({nparam} parameters, bf16, remat {cfg.remat}), S 4096, "
          f"B {MESH_BATCH}, {MESH_STEPS} steps through make_step(mesh="
          f"make_host_mesh(1)) (world-1 NCCL, mesh (1, 1); replicated "
          f"rules {meshed.meta['replicated']}) == mesh-free bit for bit: "
          f"losses {m_loss}, grad norms {m_norm}, parameters, m and v; "
          f"{m_ms!r} ms a step (the median of steps 2-{MESH_STEPS}; "
          f"mesh-free {f_ms!r}; each step's ms, mesh "
          f"{[x * 1e3 for x in m_secs]}, mesh-free "
          f"{[x * 1e3 for x in f_secs]}), "
          f"{tokens / m_ms * 1e3!r} tokens/s, peak {peak / 1e9:.3f} GB "
          f"({peak} B; {base} B held before) on {card}; launches {counts}; "
          f"mesh-free init and steps {t_free:.1f} s, its state to the host "
          f"{t_copy:.1f} s, compared on the card {t_cmp:.1f} s", flush=True)
    del params, state, want
    torch.cuda.empty_cache()


def start_mesh_check(torch, mesh):
    """Phase 15 (a)'s card-against-CPU step: olmoe-1b-7b at full width in
    float32 with MESH_CHECK's layers, S and B, one step through the mesh
    step on the card from seeded parameters and a fresh AdamW state
    (recording the router's order, :func:`route_tape`), then the same
    step on the CPU in a thread of MESH_CHECK_THREADS intra-op threads
    (the CPU replaying the card's tied router choices) while the card
    goes on with (b), (c) and phase 9.  Returns what
    :func:`finish_mesh_check` compares."""
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.launch import steps
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.lm.transformer import Transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    layers, s, b = MESH_CHECK
    # remat "none": the tape numbers the router's calls, and a recompute
    # would call it again (remat moves memory, not values: tests hold the
    # three modes bit for bit)
    ccfg = dataclasses.replace(olmoe_1b_7b.CONFIG, n_layers=layers,
                               dtype=torch.float32, remat="none")
    shape = dict(kind="train", seq_len=s, global_batch=b)
    fn = steps.make_lm_step(ccfg, shape, mesh).fn
    # drawn on the card (the host's draw of 1 B values took ~8 s), the
    # CPU's copy of the same values
    pc = tree_map(lambda p: p.detach(), Transformer(
        ccfg, torch.Generator(device=dev).manual_seed(15),
        device=dev).param_tree())
    p0 = tree_map(lambda p: p.cpu(), pc)
    s0 = opt.init(p0, steps.OPT_CFG)
    t_init = time.perf_counter() - t0
    tape = route_tape(torch, ccfg.moe.top_k)
    with tape:
        card = fn(pc, opt.init(pc, steps.OPT_CFG),
                  tlaunch.synthetic_batch(ccfg, shape, 0, 15, dev))
    del pc
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0 - t_init

    def host_step():
        t1 = time.perf_counter()
        torch.set_num_threads(MESH_CHECK_THREADS)     # this thread's own
        rep = route_tape(torch, ccfg.moe.top_k, tape)
        with rep:
            host = fn(p0, s0, tlaunch.synthetic_batch(ccfg, shape, 0, 15,
                                                      "cpu"))
        return host, rep, time.perf_counter() - t1

    pool = ThreadPoolExecutor(1)
    return dict(card=card, host=pool.submit(host_step), pool=pool, t0=t0,
                t_init=t_init, t_card=t_card, shape=(layers, s, b))


def finish_mesh_check(torch, check_state) -> None:
    """Phase 15 (a)'s check, compared on the card: loss and grad_norm
    within 1e-5 relative, m within 1e-4 and v within 1e-3 of each leaf's
    largest, parameters within 1e-5 + 1e-6 |p| except where the step's
    gradient is under 1e-4 of its leaf's largest (:func:`forced_steps`'s
    rules for one step from a zero state)."""
    from repro_torch.launch.steps import OPT_CFG
    from repro_torch.tree import tree_leaves

    c = check_state
    t_wait = time.perf_counter()
    host, rep, t_host = c["host"].result()
    c["pool"].shutdown()
    t1 = time.perf_counter()
    t_wait = t1 - t_wait
    (gp, gs, gl, gn), (wp, ws, wl, wn) = c["card"], host
    gl, gn, wl, wn = (float(x) for x in (gl, gn, wl, wn))
    check(abs(gl - wl) <= 1e-5 * abs(wl) and abs(gn - wn) <= 1e-5 * abs(wn),
          f"phase 15 (a) card vs CPU: loss {gl!r} gnorm {gn!r}, CPU {wl!r} "
          f"{wn!r}")
    for key, tol in (("m", 1e-4), ("v", 1e-3)):
        for j, (a, w) in enumerate(zip(tree_leaves(gs[key]),
                                       tree_leaves(ws[key]))):
            w = w.to(a.device)
            e, top = float((a - w).abs().max()), float(w.abs().max())
            check(e <= tol * top, f"phase 15 (a) card vs CPU: {key} leaf "
                  f"{j} {tuple(a.shape)} differs by {e!r}, its largest "
                  f"{top!r}")
    worst, let_off = 0.0, 0
    for a, w, m_new in zip(tree_leaves(gp), tree_leaves(wp),
                           tree_leaves(ws["m"])):
        w, m_new = w.to(a.device), m_new.to(a.device)
        g = m_new.abs()                      # (1 - b1) |g| from a zero m
        near = g <= 1e-4 * float(g.max())
        d = (a - w).abs()
        far = d > 1e-5 + 1e-6 * w.abs()
        check(not bool((far & ~near).any()),
              f"phase 15 (a) card vs CPU: parameters differ by "
              f"{float(d[~near].max())!r} where the gradient is not near 0")
        if bool((~near).any()):
            worst = max(worst, float(d[~near].max()))
        let_off += int((far & near).sum())
    layers, s, b = c["shape"]
    print(f"phase 15 (a): card vs CPU through the mesh step (float32, "
          f"remat none, olmoe's full width, {layers} layers, S {s}, B {b}, "
          f"one step from the same seeded state; the CPU replays the "
          f"card's tied router choices, chosen probabilities within "
          f"{rep.max_diff!r}, tied: {rep.tied or 'none'}): loss {wl!r}, "
          f"grad_norm, m and v equal within tolerance, parameters within "
          f"{worst!r} (tol 1e-5 + 1e-6|p|; {let_off} entries with a "
          f"gradient near 0 let off); init {c['t_init']:.1f} s, card step "
          f"{c['t_card']:.1f} s, CPU step {t_host:.1f} s (in a thread of "
          f"{MESH_CHECK_THREADS} beside (b), (c) and phase 9; waited "
          f"{t_wait:.1f} s for it), compare {time.perf_counter() - t1:.1f} "
          f"s; "
          f"{time.perf_counter() - c['t0']:.1f} s from its start",
          flush=True)


def split_slices(torch, fa, q, k, v, kv_len: int, r: int, faref=None):
    """R ranks' partials of one decode layer, the cache's rows cut into R
    equal slices as R ranks would hold them: each slice with a kept row
    through the kernel (``flash_attention_partials``), an empty one as
    o = 0, lse = -inf; stacked (R, ...).  With ``faref``, each kernel
    partial is held against ``faref.attention_partials_ref`` on the same
    slice (o and lse within 2e-5 + 2e-5 |plain|), and the largest errors
    of o and lse come back too."""
    b, s_, h, d = q.shape
    t = k.shape[1] // r
    os_, ls = [], []
    eo = el = 0.0
    for i in range(r):
        n = min(max(kv_len - i * t, 0), t)
        if n:
            ks, vs = k[:, i * t:(i + 1) * t], v[:, i * t:(i + 1) * t]
            o, lse = fa.flash_attention_partials(q, ks, vs, n)
            if faref is not None:
                wo, wl = faref.attention_partials_ref(q, ks, vs, n)
                e1, ok1 = within(o, wo, 2e-5, 2e-5)
                e2, ok2 = within(lse, wl, 2e-5, 2e-5)
                check(ok1 and ok2, f"phase 15 (b): slice {i} of {r}'s "
                      f"partial (kv_len {n}) differs from plain: o by "
                      f"{e1!r}, lse by {e2!r}")
                eo, el = max(eo, e1), max(el, e2)
        else:
            o = torch.zeros((b, s_, h, d), dtype=torch.float32,
                            device=q.device)
            lse = torch.full((b, h, s_), float("-inf"), device=q.device)
        os_.append(o)
        ls.append(lse)
    out = torch.stack(os_), torch.stack(ls)
    return out if faref is None else (*out, eo, el)


def merge_bound(r: int, n: int, d: int, out_size: int):
    """(ms, "bytes"): R·N·D float32 o and R·N float32 lse read once, N·D
    outputs written once, against the card's memory rate."""
    return (bound_ms(4 * r * n * d + 4 * r * n + out_size * n * d),
            "bytes")


def split_kv_kernels(torch, fa, faref, cfg, args) -> dict:
    """Phase 15 (b), the kernels: at olmoe's decode_32k layer (B 8, 16 kv
    heads of D 128, a 32,768-row cache, bf16) the cache cut into R in
    SPLIT_RANKS slices, kv_len inside the last slice, at a slice boundary
    (the later slices empty at R = 4) and inside the first slice, and
    with the keys of the cache's second quarter doubled (its slices'
    LSEs ~1 above the others', so the merge's weights are far from
    equal); each slice's partial by the flash kernel, against its plain
    version, merged by merge_kernel.  The merge against the whole-cache
    call (bit for bit at R = 1, else within 1e-5 + 2^-7 |plain|) and
    against its plain version on the same partials (float32 within 1e-6
    relative, bf16 within one rounding).  On the doubled keys at R > 1,
    the plain merge with wrong weights (the LSE in log2 units; all
    weights equal) must miss the whole-cache call: the check can see a
    wrong weight.  Returns the merge kernel's row (times at R = 4)."""
    import math

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(150)
    h, hk, d, t, b = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 32768, 8
    q = torch.randn((b, 1, h, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, t, hk, d), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    k2 = k.clone()
    k2[:, t // 4:t // 2] *= 2                    # exact in bf16
    worst = 0.0
    for r in SPLIT_RANKS:
        for where, kv_len, keys in (
                ("inside the last slice", t - 100, k),
                ("at a slice boundary", t // 2, k),
                ("inside the first slice", 300, k),
                ("the second quarter's keys doubled", t - 100, k2)):
            o, lse, eo, el = split_slices(torch, fa, q, keys, v, kv_len, r,
                                          faref)
            got = fa.merge_partials(o, lse, torch.bfloat16)
            got32 = fa.merge_partials(o, lse, torch.float32)
            whole = fa.flash_attention(q, keys, v, causal=False,
                                       kv_len=kv_len)
            plain32 = faref.merge_partials_ref(o, lse, torch.float32)
            plain = faref.merge_partials_ref(o, lse, torch.bfloat16)
            torch.cuda.synchronize()
            e32, ok32 = within(got32, plain32, 1e-6, 1e-6)
            check(ok32, f"phase 15 (b): merge_kernel (float32) differs from "
                  f"plain by {e32!r} at R {r}, kv_len {kv_len}")
            eb, okb = within(got, plain, 2.0 ** -8, 1e-6)
            check(okb, f"phase 15 (b): merge_kernel (bf16) differs from "
                  f"plain by {eb!r} at R {r}, kv_len {kv_len}")
            if r == 1:
                check(torch.equal(got, whole),
                      f"phase 15 (b): R = 1 differs from the whole-cache "
                      f"call at kv_len {kv_len}")
                ew = 0.0
            else:
                ew, ok = within(got, whole, 2.0 ** -7, 1e-5)
                check(ok, f"phase 15 (b): R {r} differs from the whole-"
                      f"cache call by {ew!r} at kv_len {kv_len}")
            wrong = ""
            if r > 1 and keys is k2:
                spread = float((lse.amax(0) - lse.amin(0)).mean())
                misses = []
                for name, bad in (("log2 LSE", lse / math.log(2)),
                                  ("equal weights", torch.zeros_like(lse))):
                    e_bad, ok_bad = within(faref.merge_partials_ref(
                        o, bad, torch.bfloat16), whole, 2.0 ** -7, 1e-5)
                    check(not ok_bad, f"phase 15 (b): a merge with "
                          f"{name} passes the whole-cache check at R {r} "
                          f"(err {e_bad!r}): the case cannot see a weight")
                    misses.append(f"{name} err {e_bad!r}")
                wrong = (f"; the slices' LSE spread {spread!r}, wrong "
                         f"weights miss the whole-cache call ("
                         f"{', '.join(misses)})")
            worst = max(worst, e32, eb)
            print(f"phase 15 (b): R {r}, kv_len {kv_len} ({where}): "
                  f"partials by the flash kernel == plain (o err {eo!r}, "
                  f"lse err {el!r}; tol 2e-5 + 2e-5|plain|), merged by "
                  f"merge_kernel == plain merge (float32 err {e32!r}, bf16 "
                  f"err {eb!r}); "
                  f"{'== the whole-cache call bit for bit' if r == 1 else f'whole-cache err {ew!r} (tol 1e-5 + 2^-7|plain|)'}"
                  f"{wrong}", flush=True)
    del k2
    r = SPLIT_RANKS[-1]
    o, lse = split_slices(torch, fa, q, k, v, t - 100, r)
    n = b * h

    def kern():
        return fa.merge_partials(o, lse, torch.bfloat16)

    def plain():
        return faref.merge_partials_ref(o, lse, torch.bfloat16)

    row = {"name": "flash_attention_merge", "route": "cuda",
           "source": FA_SOURCE, "replaces": REPLACES["flash_attention_merge"],
           "max_abs_err": worst, "ms": time_ms(kern, args.reps),
           "device_ms": device_ms(torch, kern, args.reps)[0],
           "plain_ms": time_ms(plain, args.reps),
           "library_ms": None, "library_device_ms": None}
    row["bound_ms"], row["bound_by"] = merge_bound(r, n, d, 2)

    def split_layer():
        o_, l_ = split_slices(torch, fa, q, k, v, t - 100, r)
        return fa.merge_partials(o_, l_, torch.bfloat16)

    layer_ms = time_ms(split_layer, args.reps)
    whole_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=False,
                                                  kv_len=t - 100),
                       args.reps)
    print(f"phase 15 (b): merge_kernel at R {r} over a decode_32k layer's "
          f"rows (B {b} x H {h}, D {d}): {row['ms']!r} ms (device "
          f"{row['device_ms']!r}), plain {row['plain_ms']!r} ms, bound "
          f"{row['bound_ms']!r} ms (bytes); the layer split in {r} "
          f"(partials + merge, one card) {layer_ms!r} ms against the "
          f"whole-cache call's {whole_ms!r} ms", flush=True)
    del q, k, v, o, lse
    return row


def mesh_decode_olmoe(torch, mesh, row) -> None:
    """Phase 15 (b), the path: olmoe-1b-7b's decode_32k step at full width
    with MESH_LAYERS layers, batch 8, cache_len SPLIT_DECODE_LEN, against
    the mesh-free decode step (logits and caches bit for bit), twice, the
    counts set to 0 just before each and read just after: through
    ``make_step``'s mesh decode (at world 1 the kv_cache rule cuts no
    sequence, so each layer takes the single-card attention), and through
    ``Transformer.decode`` with the caches' sequence over ("data",
    "model") under ``mesh_context`` (split-KV across ranks, one slice at
    world 1: one partial and one merge a layer)."""
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.dist import compat
    from repro_torch.dist.context import mesh_context
    from repro_torch.launch import steps
    from repro_torch.models.lm.transformer import Transformer
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    cfg = dataclasses.replace(olmoe_1b_7b.CONFIG, n_layers=MESH_LAYERS)
    shape = dict(kind="decode", seq_len=32768, global_batch=8)
    gen = torch.Generator(device=dev).manual_seed(151)
    params = tree_map(lambda p: p.detach(),
                      Transformer(cfg, gen, device=dev).param_tree())
    cache = (cfg.n_layers, 8, 32768, cfg.n_kv_heads, cfg.hd)
    kc, vc = (torch.randn(cache, generator=gen, device=dev,
                          dtype=cfg.dtype) for _ in range(2))
    tok = torch.randint(0, cfg.vocab, (8, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    free = steps.make_lm_step(cfg, shape)
    want = free.fn(params, tok, kc.clone(), vc.clone(), SPLIT_DECODE_LEN)
    meshed = steps.make_lm_step(cfg, shape, mesh)
    lay = meshed.layout
    args = [compat.shard_tree(x, s, mesh) for x, s in
            zip((params, tok, kc, vc), lay[:4])]
    torch.cuda.synchronize()
    reset_counts()
    got = meshed.fn(*args, SPLIT_DECODE_LEN)
    torch.cuda.synchronize()
    L = cfg.n_layers
    counts = check_counts("phase 15 (b) decode", {
        "flash_attention": L, "flash_attention_combine": L})

    def same(out):
        return out[3] == want[3] and all(
            torch.equal(a, b) for a, b in zip(out[:3], want[:3]))

    check(same(got), "phase 15 (b): the mesh decode step's logits or caches "
          "differ from the mesh-free step's")
    del got, args
    split = steps.bind(meshed.model, steps.lm_serve_fn)
    seq = ("data", "model")
    torch.cuda.synchronize()
    reset_counts()
    with mesh_context(mesh, (), "model"):
        got = split(params, tok, kc.clone(), vc.clone(), SPLIT_DECODE_LEN,
                    seq)
    torch.cuda.synchronize()
    split_counts = check_counts("phase 15 (b) split-KV decode", {
        "flash_attention": L, "flash_attention_combine": L,
        "flash_attention_merge": L})
    check(same(got), "phase 15 (b): the split-KV decode's logits or caches "
          "differ from the mesh-free step's")
    row["launches"] = split_counts["flash_attention_merge"]
    print(f"phase 15 (b): {cfg.name} decode_32k at full width, {L} layers, "
          f"B 8, cache_len {SPLIT_DECODE_LEN}: through the world-1 mesh "
          f"(kv_cache rule {steps._lm_rules(cfg, shape, mesh)['kv_cache']!r}"
          f": no sequence cut, the single-card attention; launches "
          f"{ {k: n for k, n in counts.items() if n} }) and through "
          f"Transformer.decode with the caches' sequence over {seq} "
          f"(split-KV, one slice: a partial and a merge a layer; launches "
          f"{ {k: n for k, n in split_counts.items() if n} }), each == "
          f"mesh-free bit for bit (logits and caches)", flush=True)
    del params, kc, vc, got, want
    torch.cuda.empty_cache()


def mesh_small_steps(torch, np, mesh) -> None:
    """Phase 15 (c): DeepFM train_batch at full width (39 fields x 2^20
    rows, B 65,536) and GIN full_graph_sm (phase 6's graph and model, one
    edge part) through the world-1 mesh, MESH_STEPS steps each, against
    their mesh-free steps (DeepFM's ``make_recsys_step`` without a mesh;
    the engine's ``gnn_engine.train_step``): loss, grad norm, parameters
    and state bit for bit, with equal launch counts of the embedding_bag
    kernels and block_spmm."""
    from repro_torch.apps import engine as eng
    from repro_torch.configs import deepfm as deepfm_cfg
    from repro_torch.configs import gin_tu
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import GNN_SHAPES, RECSYS_SHAPES
    from repro_torch.dist import compat
    from repro_torch.launch import gnn_engine as ge
    from repro_torch.launch import steps
    from repro_torch.models.gnn import gin
    from repro_torch.models.recsys.deepfm import DeepFM
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    cfg = deepfm_cfg.CONFIG
    shape = dict(RECSYS_SHAPES["train_batch"])
    gen = torch.Generator(device=dev).manual_seed(152)
    b = shape["batch"]
    xb = torch.randint(0, 3 * cfg.rows_per_field, (b, cfg.n_fields),
                       generator=gen, device=dev, dtype=torch.int32)
    yb = (torch.rand((b,), generator=gen, device=dev) < 0.3).float()
    results = {}
    for name, mesh_ in (("mesh-free", None), ("mesh", mesh)):
        bundle = steps.make_recsys_step(cfg, shape, mesh_)
        p = tree_map(lambda t: t.detach(), DeepFM(
            cfg, torch.Generator(device=dev).manual_seed(0),
            device=dev).param_tree())
        st = opt.init(p, steps.OPT_CFG)
        if mesh_ is not None:
            p = compat.shard_tree(p, bundle.layout[0], mesh_)
            st = compat.shard_tree(st, bundle.layout[1], mesh_)
        reset_counts()
        p, st, losses, norms, secs = mesh_steps(
            torch, bundle.fn, [p, st], [(xb, yb)] * MESH_STEPS)
        results[name] = ((p, st), losses, norms, all_counts(), secs)
        del p, st
    (wf, lf, nf, cf, sf), (wm, lm, nm, cm, sm_) = (results["mesh-free"],
                                                   results["mesh"])
    check(lf == lm and nf == nm and cf == cm and tree_equal(torch, wm, wf)
          and cm["embedding_bag"] > 0 and cm["embedding_bag_backward"] > 0,
          f"phase 15 (c): DeepFM through the mesh (losses {lm}, counts "
          f"{cm}) differs from mesh-free ({lf}, {cf})")
    print(f"phase 15 (c): DeepFM train_batch (B {b}) through the world-1 "
          f"mesh == mesh-free bit for bit over {MESH_STEPS} steps: losses "
          f"{lm}, grad norms {nm}; embedding_bag {cm['embedding_bag']} and "
          f"embedding_bag_backward {cm['embedding_bag_backward']} launches "
          f"each way; {step_ms(sm_)!r} ms a step (the median of steps "
          f"2-{MESH_STEPS}; mesh-free {step_ms(sf)!r})", flush=True)
    del results, xb, yb
    torch.cuda.empty_cache()

    gshape = GNN_SHAPES[GNN_SHAPE]
    edges, feats, labels, label_mask = gnn_data(np, gshape, seed=0)
    n = feats.shape[0]
    gcfg = dataclasses.replace(gin_tu.CONFIG, d_feat=gshape["d_feat"],
                               n_classes=gshape["n_classes"])
    sg = eng.build_sharded_graph(edges, np.zeros(len(edges), np.int32), n, 1)
    caps = ge.caps_from_sharded_graph(sg, gshape["d_feat"], gcfg.n_classes)
    a = ge.engine_arrays(sg, feats, labels, label_mask, 0, dev)
    model = gin.GIN(gcfg, torch.Generator().manual_seed(0)).to(dev)
    p0 = tree_map(lambda t: t.detach().clone(), model.param_tree())
    state = opt.init(model.param_tree(), steps.OPT_CFG)
    reset_counts()
    free_losses = []
    for _ in range(MESH_STEPS):
        loss, state = ge.train_step(model, a, caps, state, steps.OPT_CFG)
        free_losses.append(float(loss))
    cf = all_counts()
    bundle = steps.make_gnn_step(get_arch("gin-tu"), gin_tu.CONFIG, gshape,
                                 mesh, caps=caps)
    reset_counts()
    p, st, lm, nm, secs = mesh_steps(torch, bundle.fn,
                                     [p0, opt.init(p0, steps.OPT_CFG)],
                                     [(a,)] * MESH_STEPS)
    cm = all_counts()
    check(lm == free_losses and cf == cm and cm["block_spmm"] > 0
          and tree_equal(torch, (p, st), (model.param_tree(), state)),
          f"phase 15 (c): GIN's engine step through the mesh (losses {lm}, "
          f"counts {cm}) differs from its mesh-free step ({free_losses}, "
          f"{cf})")
    print(f"phase 15 (c): GIN {GNN_SHAPE} (engine, one part) through "
          f"make_gnn_step's mesh branch == gnn_engine.train_step bit for "
          f"bit over {MESH_STEPS} steps: losses {lm}; block_spmm "
          f"{cm['block_spmm']} launches each way", flush=True)


def phase_mesh(torch, np, args, card: str | None = None):
    """Phase 15: the device mesh (``launch.mesh.make_host_mesh(1)``, a
    world-1 NCCL group, mesh (1, 1)) and the sharded steps, each against
    its mesh-free step bit for bit: (a) olmoe-1b-7b training at full
    width, and one card-against-CPU step; (b) split-KV across ranks: the
    merge kernel on one card, then the decode step; (c) DeepFM and GIN.
    Returns the merge kernel's row and (a)'s card-against-CPU check, whose
    CPU step goes on in a thread (:func:`finish_mesh_check` ends it)."""
    from repro_torch.dist import compat
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    no_tf32(torch, "phase 15")
    if card is None:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    with compat.world1("nccl"):
        mesh = make_host_mesh(1)
        mesh_train_olmoe(torch, np, mesh, card)
        print(f"phase 15 (a): {time.perf_counter() - t0:.1f} s", flush=True)
        cpu_check = start_mesh_check(torch, mesh)
        row = split_kv_kernels(torch, fa, faref, olmoe_1b_7b.CONFIG, args)
        mesh_decode_olmoe(torch, mesh, row)
        print(f"phase 15 (b): {time.perf_counter() - t0:.1f} s", flush=True)
        mesh_small_steps(torch, np, mesh)
        print(f"phase 15 (c): {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase 15: took {time.perf_counter() - t0:.1f} s (its CPU "
          f"check goes on beside phase 9)", flush=True)
    return row, cpu_check


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale of the main run (2^scale vertices)")
    ap.add_argument("--check-scale", type=int, default=14,
                    help="RMAT scale of the card-vs-CPU identity runs")
    ap.add_argument("--time-round", type=int, default=20,
                    help="round whose inputs the kernel timings use")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train-child", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    if args.train_child:
        train_child(args.train_child)
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
    marks = [("1-2", time.perf_counter())]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    # the kernels build (nvcc processes, waited on in a thread) while this
    # thread makes the main path's graph on the host: RMAT, Graph500
    # (a, b, c, d), seed 1; neither needs the other
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as builder:
        building = builder.submit(timed_build, build)
        edges = rmat_edges(args.scale, EDGE_FACTOR, seed=1)
        g = from_edges(edges, 1 << args.scale, device=dev)
        del edges
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        build_s = building.result()
    print(f"phase 1: built {', '.join(build.FAMILIES)} (one nvcc each, "
          f"together, beside the graph's generation) in {build_s:.2f} s",
          flush=True)
    for fam in build.FAMILIES:
        for line in build.build_logs.get(fam, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {fam}: {line.strip()}", file=sys.stderr)
    n, m = g.num_vertices, g.num_edges
    print(f"phase 1: RMAT scale {args.scale} EF {EDGE_FACTOR}: "
          f"N={n} M={m} (host generation + copy, canonical form and CSR "
          f"on the card: {gen_s:.2f} s; "
          f"build and graph together {time.perf_counter() - t0:.2f} s)",
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
    mark("3")
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
    mark("3b")
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
    mark("4")
    small = rmat_edges(args.check_scale, EDGE_FACTOR, seed=1)
    n_small = 1 << args.check_scale
    g_gpu = from_edges(small, n_small, device=dev)
    g_cpu = from_edges(small, n_small, device="cpu")
    check(all(torch.equal(getattr(g_gpu, f).cpu(), getattr(g_cpu, f))
              for f in ("edges", "indptr", "adj_dst", "adj_eid", "slot_src",
                        "degree")),
          f"scale-{args.check_scale} Graph built on the card differs from "
          "the host build")
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
    print(f"phase 4: scale {args.check_scale}: Graph on the card == host "
          f"build; single card == single CPU == "
          f"SPMD card == SPMD CPU bit for bit (rounds="
          f"{runs['single card'].rounds}, all four in "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)

    # --- phase 5: kernel times on real rounds' inputs -----------------------
    mark("5")
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
    mark("6")
    spmm_row = phase_gnn(torch, np, compat, ops, args)

    # --- phases 7 and 8: DeepFM and smollm-135m serving ---------------------
    mark("7 and 8")
    t0 = time.perf_counter()
    bag_row = phase_deepfm(torch, args)
    flash_row = phase_lm(torch, args)
    print(f"phases 7-8: {time.perf_counter() - t0:.1f} s", flush=True)

    # --- phase 13: olmoe-1b-7b serving (MoE), beside phase 8 ----------------
    mark("13")
    torch.cuda.empty_cache()
    moe_row = phase_moe(torch, args)

    # --- phase 15: the device mesh and the sharded steps --------------------
    mark("15")
    torch.cuda.empty_cache()
    merge_row, mesh_check = phase_mesh(torch, np, args, card)

    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
        "spawn"))
    # phase 14's single-process job, in a process of its own beside 10-11
    serve_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    serving = None
    try:
        oracles = start_app_oracles(np, pool, main_edges, 1 << args.scale,
                                    work)
        stream_checks, stream_plains = start_stream_oracles(pool, work)
        family_cpu = start_family_oracles(pool)
        # --- phase 9: the driver from the store, killed and resumed ---------
        mark("9")
        launches_drv, launches_mh, ef, art_dir = phase_driver(
            torch, np, main_edges, res, wall_sm / max(rounds, 1), chunks,
            dev, args.scale, work)
        for r in rows + bit_rows:
            r["launches_driver"] = launches_drv[r["name"]]
            r["launches_mh"] = launches_mh[r["name"]]

        # --- phase 15 (a)'s card-against-CPU check, run beside phase 9 ------
        mark("15 check")
        finish_mesh_check(torch, mesh_check)
        del mesh_check

        # --- phase 14's start: its gang and store builds beside 10-11 --------
        mark("14a")
        serving = start_serving(np, serve_pool, art_dir, main_edges,
                                res.stats.replication_factor, work)

        # --- phase 10: baselines and hybrid ----------------------------------
        mark("10")
        t0 = time.perf_counter()
        ptxas_report(build, "stream", ("hdrf_kernel", "hdrf_warp_kernel",
                                       "oblivious_kernel",
                                       "oblivious_warp_kernel"), "phase 10")
        err = phase_stream_kernels(torch, dev, stream_checks)
        graphs, q_rows, q_counts = phase_quality(torch, np, dev, work)
        stream = stream_cells(torch, graphs, q_counts, err, stream_plains)
        phase_hybrid_scale(torch, np, ef, dev)
        phase_hybrid_driver(torch, np, graphs, q_rows, dev, work)
        print(f"phase 10: took {time.perf_counter() - t0:.1f} s", flush=True)
        del graphs, ef

        # --- phase 11: the GAS apps, Table 5, redistribution, GNNs ----------
        mark("11")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        phase_apps(torch, np, main_edges, 1 << args.scale, dev, oracles)
        launches_t5 = phase_table5(torch, np, dev)
        for r in rows:
            r["launches_table5"] = launches_t5[r["name"]]
        phase_redistribute(torch, np, main_edges, res.edge_part, dev)
        del main_edges, res
        phase_families(torch, np, dev, family_cpu)
        print(f"phase 11: took {time.perf_counter() - t0:.1f} s", flush=True)

        # --- phase 14: phase 9's artifact served ------------------------------
        mark("14")
        phase_serve(np, serving)
    finally:
        stop_serving(serving)
        serve_pool.shutdown(cancel_futures=True)
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)

    # --- phase 12: training, the backward kernels ---------------------------
    mark("12")
    torch.cuda.empty_cache()
    train_rows = phase_train(torch, np, args)
    mark("end")
    print("phase times (s): " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:])),
        flush=True)
    print(f"the script: {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": rows + bit_rows + [spmm_row, bag_row,
                                                   flash_row, moe_row]
                      + stream + train_rows + [merge_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
