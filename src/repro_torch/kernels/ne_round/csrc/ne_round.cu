// The Distributed NE expansion round's kernels for Hopper (sm_90a): the
// three of every round with the restart draw, the two-hop candidate
// kernel, and the three of the SPMD round's bit-packed replica sets.
//
// Plain C interface: each entry point takes device pointers and a
// cudaStream_t passed as void*, launches on that stream, does not
// synchronise, allocates nothing, and returns the cudaError_t of the
// launch (0 on success).  The Python wrapper (ops.py) allocates outputs
// and scratch, checks shapes and types, and raises on a non-zero return.
//
// All arithmetic is integer except k_eff = ceilf(lam * |B|) in float32,
// which is what the reference computes; every result is order-independent
// (integer atomics, a total order on the selection keys), so the kernels
// are bit-identical to the plain versions in ref.py.
//
// one_hop — replaces repro/kernels/ne_round/ne_round.py::one_hop.
//   Per edge: k = min(vclaim[u], vclaim[v]); an unallocated, claimed (and
//   unmasked) edge gets part = k % P, every other edge -1; plus the (P,)
//   histogram of new allocations.
//   Bound: device memory.  u, v, edge_part in and part out are 16 B per
//   edge streamed once; the two vclaim gathers hit a (N,) int32 array that
//   fits the 50 MB L2 at N = 2^22.  Design: one thread per edge in a
//   grid-stride loop (coalesced streams), the histogram in shared memory
//   with atomicAdd, flushed with one global atomicAdd per non-empty bin.
//
// claim_scatter — replaces ne_round.py::claim_scatter.
//   vclaim[v] = min over claiming partitions of priority_enc(|E_p|, p),
//   INT32_MAX where no partition claimed v.
//   Bound: device memory, the 4N-byte output; the P*K claims are tiny.
//   Design: one launch, no global atomics and no grid sync.  Each block
//   owns CLAIM_RANGE = 32,768 consecutive vertices (128 KB of shared
//   memory, one block an SM; at N = 2^22, 128 blocks): it fills its range
//   with I32_INF in shared memory, reads all P*K slots (16-byte index and
//   4-byte flag loads, eight of each in flight a thread; L2-resident
//   after the first blocks), applies a shared-memory atomicMin for each
//   valid slot whose vertex lies in its range, and writes the range once
//   with 16-byte stores.  So the output is written once and never read,
//   where a separate fill wrote it and the scatter then read and wrote it
//   again.  Every block reads all the slots, so fewer, larger ranges read
//   less (16,384 vertices a block was slower).  Slots with a vertex
//   outside [0, N) fall in no block's range and are dropped.
//
// select — replaces ne_round.py::select, and the restart draw that the
//   reference makes outside it (core/partitioner.py::boundary_reseed).
//   For C rows (partitions) of the replica map: boundary mask vparts &
//   D_rest > 0 & active, |B|, the kk = min(k_eff, |B|) smallest keys
//   (D_rest << 32) | v (ties to the lowest vertex id), k_eff =
//   clamp(ceil(lam |B|), 1, K), the capacity prefix cut against
//   `remaining`, and the restart slot 0: for a row with |B| = 0 that is
//   active while some vertex has D_rest > 0, the argmax over D_rest > 0
//   of JAX's uniform bits from the row's threefry key.
//   Bound: device memory for 4N of D_rest and the 32-byte sectors of the
//   flags of each vertex with D_rest > 0 (no other vertex's flags are
//   read); a restart row adds a threefry evaluation for each such vertex,
//   integer work on the ALU and FMA pipes.
//   The TPU kernel streams tiles through one core and merges a (C, K)
//   top-k accumulator from tile to tile, with the restart vertices drawn
//   outside.  Blocks here run in no order; the design fills the card and
//   reads the map at most once:
//   * select_scan (one launch): one thread per vertex; where D_rest > 0
//     it reads the vertex's flags for 64 rows (four 16-byte loads when
//     the rows are the map's contiguous bytes, else byte loads through
//     the view's strides), writes them as two 32-bit words of boundary
//     bits (32 MB at N = 2^22 against the map's 256 MB), and histograms
//     each boundary key's score, capped at 256, into shared memory,
//     flushed with one global atomicAdd per non-empty bin.  It also sets
//     the any-D_rest flag on the device (never read by the host).
//   * the pick: the last block of each pass (an atomic ticket) scans
//     every row's 256 bins (a warp a row) and narrows the row's key
//     interval [lo, hi] to the bucket holding the kk-th key; the keys
//     below the bucket (fewer than kk) are collected in the next pass.
//     Level 0's buckets are exact scores 1..255 and one for >= 256; later
//     levels split the interval into 256 equal buckets (an exact score's
//     interval spans the vertex ids, so the ties at the threshold score
//     are resolved by id).  A bucket of at most SEL_FINAL keys is
//     collected whole.  The interval loses 8 bits a level, so every row is
//     collected after at most SEL_PASSES passes.
//   * restart_draw (its own launch, its own count): a (blocks, C) grid;
//     blocks of a row that does not restart return at once.  A restart
//     row computes threefry2x32 (20 rounds, counters (0, i)) for each
//     vertex with D_rest > 0 and keeps the maximum of (bits << 32) |
//     (0xFFFFFFFF - i) by a block reduction and one 64-bit atomicMax: the
//     largest uniform, ties to the lowest index, as jnp.argmax breaks them.
//   * select_pass (SEL_PASSES launches): one thread per vertex reads the
//     two boundary words (and D_rest where one is set, skipping scores no
//     live row needs), appends the keys below each row's bucket to the
//     row's candidates and histograms the keys inside it; a pass with no
//     live row returns at once.
//   * select_finish: one block per row sorts its candidates (at most
//     kk - 1 + SEL_FINAL, bitonic in shared memory) and runs the
//     epilogue.  Keys are unique, so any order of the passes selects the
//     same kk keys as the reference's top-k.
//
// two_hop_best — replaces ne_round.py::unpack_bits at the two-hop chunk,
//   with the AND, where and min around it (dist/partitioner_sm.py and
//   core/partitioner.py::_two_hop).  Per edge: the minimum of enc[p] over
//   the partitions p in replicas(u) & replicas(v) when the edge is
//   unallocated, else I32_INF.  Bound: device memory, 13 B an edge
//   streamed (u, v, the unallocated flag, best) plus the two gathered
//   rows of each unallocated edge.  One thread per edge; an allocated edge
//   gathers nothing.  Two row formats: (N, W) int32 words (the SPMD round;
//   the (N, 2) map is 32 MB and stays in the 50 MB L2), ANDed and walked
//   bit by bit with __ffs; or (N, P) bool rows (the single controller),
//   ANDed 16 bytes at a time when P % 16 == 0, byte by byte otherwise.
//   The enc vector sits in shared memory.
//
// pack_bits / unpack_bits / or_words — replace ne_round.py::pack_bits,
//   ::unpack_bits and ::or_words.  A replica set of P partitions is
//   W = ceil(P/32) 32-bit words per vertex: partition p is bit p % 32 of
//   word p / 32, LSB-first, and the pad bits P..32W-1 are 0.  The port
//   holds a word as the int32 bit pattern of the reference's uint32 word.
//   All three are memory-bound integer passes; their bound is the bytes
//   they stream (N*P flag bytes, 4*N*W word bytes).
//   * pack_bits, vector route (P % 32 == 0 and a 16-byte aligned map,
//     the SPMD round's (N, 64) delta): word t is bytes 32t .. 32t + 31 of
//     the map, so no division; one thread a word turns two 16-byte loads
//     into 32 bits (__vcmpne4, a mask and a multiply gather each 4 flag
//     bytes into 4 bits) and stores 4 bytes.  Each thread has 4 words
//     (8 loads) in flight, so a warp streams 4 KB a step where the warp a
//     word of the ballot route has 32 bytes in flight.
//   * pack_bits, ballot route (ragged P, an unaligned view): one warp per
//     (row, word).  Lane l reads flag byte 32w + l of the row (0 past P),
//     and __ballot_sync hands back the word with lane l's flag in bit l,
//     which is the LSB-first layout; lane 0 stores it.  The (row, word)
//     of the warp's grid stride is divided once, outside the loop.
//   * unpack_bits, vector route (P == 32 W: the SPMD round's whole-map
//     unpack, (N, 2) words -> (N, 64) flags, once a round): the call
//     writes 8 flag bytes for every byte it reads, so its bound is the
//     flag stores (268 of its 302 MB at N = 2^22).  The first port gave a
//     thread 4 flag bytes (one 4-byte store, a 64-bit division to find
//     the word, each word loaded 8 times) in a grid-stride loop capped at
//     2,112 blocks.  Now word t's flags are bytes 32t .. 32t + 31, so no
//     division: a thread takes 8 halves of 16 flags, loads all 8 first,
//     and turns each 4-bit nibble into 4 flag bytes with one multiply and
//     a mask (nibble_flags, the inverse of flag_nibble); each half is one
//     16-byte store, and a warp's store instruction covers 512 contiguous
//     bytes (lane l of step j writes half 256j + l of its block), where
//     one thread a word would write two 16-byte halves 32 bytes apart per
//     instruction.  Words are read unsigned: the shift is logical.
//   * unpack_bits, generic route (ragged P, or more words than P needs):
//     the first port's kernel: one thread per 4 flag bytes when P % 4 ==
//     0 (the 4 bits lie in one word since 32 % 4 == 0), else one a byte.
//   * or_words, vector route (a, b and out 16-byte aligned: every call of
//     the round, on torch's allocations): bound by its 12 bytes a word.
//     The first port had one int4 pair in flight a thread in a capped
//     grid-stride loop, and lost ~1 % to torch.bitwise_or.  Now a block
//     ORs 1,024 contiguous int4s, a thread issues its 8 16-byte loads (4
//     of a, 4 of b) before the first OR, the grid covers the words (2,048
//     blocks at (2^22, 2)) with no stride loop, the index is 32-bit where
//     it fits, and the last block takes the count % 4 tail words.
//   * or_words, scalar route (an operand off 16-byte alignment): the same
//     shape with 4-byte words.

#include <cuda_runtime.h>
#include <stdint.h>

#define I32_INF 2147483647

typedef unsigned long long u64;

// ---------------------------------------------------------------------------
// one_hop
// ---------------------------------------------------------------------------

__global__ void one_hop_kernel(const int* __restrict__ vclaim,
                               const int* __restrict__ u,
                               const int* __restrict__ v,
                               const int* __restrict__ edge_part,
                               const uint8_t* __restrict__ mask,
                               long long m, int p,
                               int* __restrict__ part,
                               int* __restrict__ counts) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < p; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < m; e += stride) {
    const int k = min(__ldg(vclaim + u[e]), __ldg(vclaim + v[e]));
    const bool fresh = edge_part[e] < 0 && k < I32_INF &&
                       (mask == nullptr || mask[e]);
    const int pp = fresh ? k % p : -1;
    part[e] = pp;
    if (fresh) atomicAdd(&hist[pp], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += blockDim.x)
    if (hist[i]) atomicAdd(&counts[i], hist[i]);
}

extern "C" int ne_one_hop(const int* vclaim, const int* u, const int* v,
                          const int* edge_part, const uint8_t* mask,
                          long long m, int p, int* part, int* counts,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * p, s);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    const int threads = 256;
    long long blocks = (m + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    one_hop_kernel<<<(int)blocks, threads, sizeof(int) * p, s>>>(
        vclaim, u, v, edge_part, mask, m, p, part, counts);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// claim_scatter
// ---------------------------------------------------------------------------

constexpr int CLAIM_RANGE = 32768;    // vertices a block owns
constexpr int CLAIM_THREADS = 512;
constexpr int CLAIM_UNROLL = 8;       // 16-byte index loads in flight

__device__ __forceinline__ void claim_one(int vtx, bool valid, long long t,
                                          long long base, int len, int k,
                                          int p_num, int cap,
                                          const int* __restrict__ epp,
                                          int* claim_s) {
  const long long off = (long long)vtx - base;
  if (valid && off >= 0 && off < len) {
    const int row = (int)(t / k);
    atomicMin(claim_s + off, min(__ldg(epp + row), cap) * p_num + row);
  }
}

__global__ void __launch_bounds__(CLAIM_THREADS)
claim_kernel(const int* __restrict__ sel_idx,
             const uint8_t* __restrict__ sel_valid,
             const int* __restrict__ edges_per_part, int rows, int k,
             int p_num, long long n, int vec, int* __restrict__ out) {
  extern __shared__ int4 claim_s4[];
  int* claim_s = reinterpret_cast<int*>(claim_s4);
  const long long base = (long long)blockIdx.x * CLAIM_RANGE;
  const int len = (int)min((long long)CLAIM_RANGE, n - base);
  const int4 inf4 = make_int4(I32_INF, I32_INF, I32_INF, I32_INF);
  for (int i = threadIdx.x; i < CLAIM_RANGE / 4; i += CLAIM_THREADS)
    claim_s4[i] = inf4;
  __syncthreads();

  const int cap = (I32_INF - p_num) / p_num - 1;
  const long long slots = (long long)rows * k;
  const long long q = vec ? slots / 4 : 0;   // groups of 4 slots
  const int4* idx4 = reinterpret_cast<const int4*>(sel_idx);
  const unsigned* val4 = reinterpret_cast<const unsigned*>(sel_valid);
  for (long long i0 = threadIdx.x; i0 < q;
       i0 += (long long)CLAIM_THREADS * CLAIM_UNROLL) {
    int4 iv[CLAIM_UNROLL];
    unsigned vv[CLAIM_UNROLL];
#pragma unroll
    for (int u = 0; u < CLAIM_UNROLL; ++u) {
      const long long i = i0 + (long long)u * CLAIM_THREADS;
      vv[u] = i < q ? __ldg(val4 + i) : 0u;
      iv[u] = i < q ? __ldg(idx4 + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < CLAIM_UNROLL; ++u) {
      const long long t = 4 * (i0 + (long long)u * CLAIM_THREADS);
      claim_one(iv[u].x, vv[u] & 0xFFu, t, base, len, k, p_num, cap,
                edges_per_part, claim_s);
      claim_one(iv[u].y, vv[u] & 0xFF00u, t + 1, base, len, k, p_num, cap,
                edges_per_part, claim_s);
      claim_one(iv[u].z, vv[u] & 0xFF0000u, t + 2, base, len, k, p_num,
                cap, edges_per_part, claim_s);
      claim_one(iv[u].w, vv[u] & 0xFF000000u, t + 3, base, len, k, p_num,
                cap, edges_per_part, claim_s);
    }
  }
  for (long long t = 4 * q + threadIdx.x; t < slots; t += CLAIM_THREADS)
    claim_one(__ldg(sel_idx + t), sel_valid[t] != 0, t, base, len, k, p_num,
              cap, edges_per_part, claim_s);
  __syncthreads();

  int* o = out + base;                   // 16-byte aligned: see the caller
  for (int i = threadIdx.x; i < len / 4; i += CLAIM_THREADS)
    reinterpret_cast<int4*>(o)[i] = claim_s4[i];
  for (int i = (len / 4) * 4 + threadIdx.x; i < len; i += CLAIM_THREADS)
    o[i] = claim_s[i];
}

// One launch of ceil(N / CLAIM_RANGE) blocks; none for N = 0.  `out` must
// be 16-byte aligned (a fresh torch.empty is).
extern "C" int ne_claim_scatter(const int* sel_idx, const uint8_t* sel_valid,
                                const int* edges_per_part, int rows, int k,
                                long long n, int p_num, int* out,
                                void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        claim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        CLAIM_RANGE * (int)sizeof(int));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  if (n <= 0) return 0;
  const int vec = ((uintptr_t)sel_idx % 16 == 0) &&
                  ((uintptr_t)sel_valid % 4 == 0);
  const long long blocks = (n + CLAIM_RANGE - 1) / CLAIM_RANGE;
  claim_kernel<<<(unsigned)blocks, CLAIM_THREADS,
                 CLAIM_RANGE * sizeof(int), (cudaStream_t)stream>>>(
      sel_idx, sel_valid, edges_per_part, rows, k, p_num, n, vec, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// select
// ---------------------------------------------------------------------------

constexpr int SEL_BINS = 256;        // buckets a level (8-bit digits)
constexpr int SEL_GROUP = 64;        // rows a block reads: two words
constexpr int SEL_FINAL = 2048;      // a bucket this small is collected
constexpr int SEL_PASSES = 8;        // passes after the scan: 7 narrow
                                     // a 63-bit interval to 7 bits, 1 collects
constexpr int SEL_THREADS = 512;
constexpr int SEL_SMEM = SEL_GROUP * SEL_BINS * (int)sizeof(int);

struct SelRow {
  u64 lo, hi;      // interval holding the kk-th key
  u64 coll;        // keys in [coll, lo) are collected by the next pass
  int krem;        // keys still to take from [lo, hi]
  int shift;       // bucket = (key - lo) >> shift
  int mode;        // 0 done, 1 histogram [lo, hi], 2 collect [coll, hi]
  int kk;          // keys to select: min(k_eff, |B|)
  int bs;          // |B|
  int restart;
};

struct SelCtrl {
  unsigned ticket; // blocks of the current pass that have finished
  int live;        // some row still reads keys
  int dmin, dmax;  // the scores the next pass looks at
  int any_ok;      // some vertex has D_rest > 0
};

__device__ __forceinline__ int span_shift(u64 span) {
  const int bits = span == 0 ? 0 : 64 - __clzll((long long)span);
  return bits > 8 ? bits - 8 : 0;
}

// bit j = byte j of x is nonzero, j < 4
__device__ __forceinline__ unsigned nz4(unsigned x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
}

__device__ __forceinline__ unsigned nz16(uint4 q) {
  return nz4(q.x) | (nz4(q.y) << 4) | (nz4(q.z) << 8) | (nz4(q.w) << 12);
}

struct SelArgs {
  const int* degree_rest;
  const uint8_t* active;
  int c_rows, k_sel, wtot, cap;
  long long n;
  float lam;
  unsigned* bw;        // (N, wtot) boundary words
  int* hist;           // (C, SEL_BINS)
  SelRow* rows;        // (C,)
  int* ncand;          // (C,)
  u64* cand;           // (C, cap)
  SelCtrl* ctrl;
};

// The bucket of the krem-th key of one row's histogram (a warp a row):
// returns (bucket, keys below it, keys in it, keys in all buckets).
__device__ void warp_bucket(const int* h, int krem, int* bucket, int* below,
                            int* count, int* total) {
  const int lane = threadIdx.x & 31;
  int loc[SEL_BINS / 32];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < SEL_BINS / 32; ++j) {
    loc[j] = __ldcg(h + lane * (SEL_BINS / 32) + j);
    sum += loc[j];
  }
  int incl = sum;                       // inclusive scan over lanes
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  *total = __shfl_sync(0xffffffffu, incl, 31);
  const unsigned hit = __ballot_sync(0xffffffffu, incl >= krem && krem > 0);
  *bucket = *below = *count = 0;
  if (hit) {
    const int src = __ffs(hit) - 1;
    int b = 0, cum = incl - sum, cnt = 0;
    if (lane == src) {
      for (int j = 0; j < SEL_BINS / 32; ++j) {
        if (cum + loc[j] >= krem) { b = j; cnt = loc[j]; break; }
        cum += loc[j];
      }
      b += lane * (SEL_BINS / 32);
    }
    *bucket = __shfl_sync(0xffffffffu, b, src);
    *below = __shfl_sync(0xffffffffu, cum, src);
    *count = __shfl_sync(0xffffffffu, cnt, src);
  }
}

// Run by the last block of a pass: narrow every row's interval and set
// what the next pass reads.  level 0 follows the scan.
__device__ void select_pick(const SelArgs& a, int level) {
  __shared__ int s_live, s_dmin, s_dmax;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) { s_live = 0; s_dmin = I32_INF; s_dmax = 0; }
  __syncthreads();
  const int any_ok = *(volatile int*)&a.ctrl->any_ok;
  for (int c = warp; c < a.c_rows; c += SEL_THREADS / 32) {
    int* h = a.hist + (long long)c * SEL_BINS;
    SelRow r = a.rows[c];
    int krem = r.krem;
    if (level == 0) {
      int b, below, cnt, total;
      warp_bucket(h, 1 << 30, &b, &below, &cnt, &total);   // total = |B|
      const int bs = total;
      int k_eff = (int)ceilf(__fmul_rn(a.lam, (float)bs));
      k_eff = k_eff < 1 ? 1 : (k_eff > a.k_sel ? a.k_sel : k_eff);
      r.bs = bs;
      r.kk = bs < k_eff ? bs : k_eff;
      r.restart = bs == 0 && a.active[c] && any_ok;
      r.mode = 0;
      krem = r.kk;
      if (krem > 0) {
        warp_bucket(h, krem, &b, &below, &cnt, &total);
        const u64 top = ((u64)0x7FFFFFFF << 32) | (u64)(a.n - 1);
        r.lo = (u64)(b + 1) << 32;
        r.hi = b < SEL_BINS - 1 ? (r.lo | (u64)(a.n - 1)) : top;
        r.coll = (u64)1 << 32;
        r.krem = krem - below;
        r.shift = span_shift(r.hi - r.lo);
        r.mode = cnt <= SEL_FINAL ? 2 : 1;
      }
    } else if (r.mode == 2) {
      r.mode = 0;                        // this pass collected [coll, hi]
    } else if (r.mode == 1) {
      int b, below, cnt, total;
      warp_bucket(h, krem, &b, &below, &cnt, &total);
      const u64 lo = r.lo + ((u64)b << r.shift);
      const u64 hi = lo + (((u64)1 << r.shift) - 1);
      r.coll = r.lo;                     // [old lo, lo) is collected next
      r.lo = lo;
      r.hi = hi < r.hi ? hi : r.hi;
      r.krem = krem - below;
      r.shift = span_shift(r.hi - r.lo);
      r.mode = cnt <= SEL_FINAL ? 2 : 1;
    }
    for (int j = lane; j < SEL_BINS; j += 32) h[j] = 0;
    if (lane == 0) {
      a.rows[c] = r;
      if (r.mode) {
        atomicOr(&s_live, 1);
        atomicMin(&s_dmin, (int)(r.coll >> 32));
        atomicMax(&s_dmax, (int)(r.hi >> 32));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.ctrl->live = s_live;
    a.ctrl->dmin = s_dmin;
    a.ctrl->dmax = s_dmax;
    a.ctrl->ticket = 0;
  }
}

// The end of every pass: the block's histogram to global memory, and the
// pick in the last block to finish.
__device__ void select_pass_end(const SelArgs& a, const int* sh, int r0,
                                int nr, int level) {
  __syncthreads();
  for (int j = threadIdx.x; j < nr * SEL_BINS; j += SEL_THREADS)
    if (sh[j]) atomicAdd(a.hist + (long long)r0 * SEL_BINS + j, sh[j]);
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(&a.ctrl->ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  select_pick(a, level);
}

__global__ void __launch_bounds__(SEL_THREADS)
select_scan_kernel(const uint8_t* __restrict__ vp, long long stride_c,
                   long long stride_n, int vec, SelArgs a) {
  extern __shared__ int sh[];
  __shared__ unsigned act_w[2];
  const int r0 = blockIdx.y * SEL_GROUP;
  const int nr = min(SEL_GROUP, a.c_rows - r0);
  for (int j = threadIdx.x; j < nr * SEL_BINS; j += SEL_THREADS) sh[j] = 0;
  if (threadIdx.x < 2) {
    unsigned w = 0;
    for (int j = 0; j < 32; ++j) {
      const int r = 32 * threadIdx.x + j;
      if (r < nr && a.active[r0 + r]) w |= 1u << j;
    }
    act_w[threadIdx.x] = w;
  }
  __syncthreads();
  bool any = false;
  const long long stride = (long long)gridDim.x * SEL_THREADS;
  for (long long i = (long long)blockIdx.x * SEL_THREADS + threadIdx.x;
       i < a.n; i += stride) {
    const int d = a.degree_rest[i];
    unsigned w0 = 0, w1 = 0;
    if (d > 0) {
      any = true;
      const uint8_t* row = vp + i * stride_n + (long long)r0 * stride_c;
      if (vec) {
        const uint4* q = reinterpret_cast<const uint4*>(row);
        const uint4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
                    q3 = __ldg(q + 3);
        w0 = nz16(q0) | (nz16(q1) << 16);
        w1 = nz16(q2) | (nz16(q3) << 16);
      } else {
        for (int r = 0; r < nr; ++r)
          if (row[r * stride_c]) {
            if (r < 32) w0 |= 1u << r; else w1 |= 1u << (r - 32);
          }
      }
      w0 &= act_w[0];
      w1 &= act_w[1];
      const int bin = (d < SEL_BINS ? d : SEL_BINS) - 1;
      for (unsigned w = w0; w; w &= w - 1)
        atomicAdd(&sh[(__ffs(w) - 1) * SEL_BINS + bin], 1);
      for (unsigned w = w1; w; w &= w - 1)
        atomicAdd(&sh[(31 + __ffs(w)) * SEL_BINS + bin], 1);
    }
    reinterpret_cast<uint2*>(a.bw)[i * (a.wtot / 2) + blockIdx.y] =
        make_uint2(w0, w1);
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(&a.ctrl->any_ok, 1);
  select_pass_end(a, sh, r0, nr, 0);
}

__global__ void __launch_bounds__(SEL_THREADS)
select_pass_kernel(SelArgs a, int level) {
  if (!*(volatile int*)&a.ctrl->live) return;   // the same for every block
  extern __shared__ int sh[];
  __shared__ SelRow rs[SEL_GROUP];
  const int r0 = blockIdx.y * SEL_GROUP;
  const int nr = min(SEL_GROUP, a.c_rows - r0);
  for (int j = threadIdx.x; j < nr * SEL_BINS; j += SEL_THREADS) sh[j] = 0;
  for (int j = threadIdx.x; j < nr; j += SEL_THREADS) rs[j] = a.rows[r0 + j];
  const int dmin = a.ctrl->dmin, dmax = a.ctrl->dmax;
  __syncthreads();
  const long long stride = (long long)gridDim.x * SEL_THREADS;
  for (long long i = (long long)blockIdx.x * SEL_THREADS + threadIdx.x;
       i < a.n; i += stride) {
    const uint2 w = reinterpret_cast<const uint2*>(a.bw)[
        i * (a.wtot / 2) + blockIdx.y];
    if ((w.x | w.y) == 0) continue;
    const int d = a.degree_rest[i];
    if (d < dmin || d > dmax) continue;
    const u64 key = ((u64)(unsigned)d << 32) | (u64)i;
    for (int half = 0; half < 2; ++half) {
      for (unsigned m = half ? w.y : w.x; m; m &= m - 1) {
        const int r = 32 * half + __ffs(m) - 1;
        const SelRow& s = rs[r];
        if (s.mode == 0 || key < s.coll || key > s.hi) continue;
        if (s.mode == 2 || key < s.lo) {
          const int slot = atomicAdd(a.ncand + r0 + r, 1);
          if (slot < a.cap) a.cand[(long long)(r0 + r) * a.cap + slot] = key;
        } else {
          atomicAdd(&sh[r * SEL_BINS + (int)((key - s.lo) >> s.shift)], 1);
        }
      }
    }
  }
  select_pass_end(a, sh, r0, nr, level);
}

// JAX's uniform bits of counter (0, i) under key (k0, k1): threefry2x32,
// 20 rounds, then the 23 top bits of x0 ^ x1 (the float32 mantissa of a
// value in [1, 2); uniform = that value - 1, so the order is the bits').
__device__ __forceinline__ unsigned uniform_bits(unsigned k0, unsigned k1,
                                                 unsigned i) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  unsigned x0 = k0, x1 = i + k1;
#define TF_ROUND(r) x0 += x1; x1 = __funnelshift_l(x1, x1, r) ^ x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_EVEN x0 += k1; x1 += k2 + 1u;
  TF_ODD  x0 += k2; x1 += k0 + 2u;
  TF_EVEN x0 += k0; x1 += k1 + 3u;
  TF_ODD  x0 += k1; x1 += k2 + 4u;
  TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef TF_EVEN
#undef TF_ODD
#undef TF_ROUND
  return (x0 ^ x1) >> 9;
}

constexpr int DRAW_THREADS = 256;
constexpr int DRAW_VERTICES = 16384;   // vertices a block of a restart row

__global__ void __launch_bounds__(DRAW_THREADS)
restart_draw_kernel(const int* __restrict__ degree_rest,
                    const long long* __restrict__ keys,
                    const SelRow* __restrict__ rows, long long n,
                    u64* __restrict__ rkey, u64* __restrict__ drawn) {
  const int c = blockIdx.y;
  if (!rows[c].restart) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(drawn, 1ull);
  const unsigned k0 = (unsigned)keys[2 * c], k1 = (unsigned)keys[2 * c + 1];
  u64 best = 0;
  const long long stride = (long long)gridDim.x * DRAW_THREADS;
  for (long long i = (long long)blockIdx.x * DRAW_THREADS + threadIdx.x;
       i < n; i += stride) {
    if (degree_rest[i] > 0) {
      const u64 key = ((u64)uniform_bits(k0, k1, (unsigned)i) << 32) |
                      (u64)(0xFFFFFFFFu - (unsigned)i);
      best = key > best ? key : best;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const u64 y = __shfl_down_sync(0xffffffffu, best, o);
    best = y > best ? y : best;
  }
  __shared__ u64 wmax[DRAW_THREADS / 32];
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < DRAW_THREADS / 32; ++w)
      best = wmax[w] > best ? wmax[w] : best;
    if (best) atomicMax(rkey + c, best);
  }
}

// dynamic shared memory: kp u64 slots (kp = the candidate capacity
// rounded up to a power of two)
__global__ void select_finish_kernel(const u64* __restrict__ cand,
                                     const int* __restrict__ ncand,
                                     const SelRow* __restrict__ rows,
                                     const u64* __restrict__ rkey,
                                     const uint8_t* __restrict__ active,
                                     const int* __restrict__ remaining,
                                     int cap, int k_sel,
                                     int* __restrict__ idx_out,
                                     uint8_t* __restrict__ valid_out) {
  extern __shared__ u64 sel[];
  const int c = blockIdx.x;
  const int nc = min(ncand[c], cap);
  int kp = 1;
  while (kp < nc) kp <<= 1;
  for (int i = threadIdx.x; i < kp; i += blockDim.x)
    sel[i] = i < nc ? cand[(long long)c * cap + i] : ~0ull;
  __syncthreads();
  for (int k = 2; k <= kp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kp; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const u64 x = sel[i], y = sel[ixj];
          if ((x > y) == up) { sel[i] = y; sel[ixj] = x; }
        }
      }
      __syncthreads();
    }
  }

  // epilogue (sequential over K: the capacity cut is a prefix sum)
  if (threadIdx.x == 0) {
    const SelRow r = rows[c];
    const bool act = active[c] != 0;
    const int rem = remaining[c];
    unsigned cum = 0;                 // int32 prefix sum, wrapping
    for (int i = 0; i < k_sel; ++i) {
      const bool have = i < r.kk;     // i < min(k_eff, |B|)
      const int score = have ? (int)(sel[i] >> 32) : 0;
      int vid = have ? (int)(sel[i] & 0xffffffffull) : 0;
      cum += have ? (unsigned)score : 0u;
      bool val = have && ((int)cum <= rem || i == 0);
      if (i == 0 && r.restart) {
        vid = (int)(0xFFFFFFFFu - (unsigned)(rkey[c] & 0xffffffffull));
        val = true;
      }
      idx_out[(long long)c * k_sel + i] = vid;
      valid_out[(long long)c * k_sel + i] = (val && act) ? 1 : 0;
    }
  }
}

static long long align16(long long x) { return (x + 15) / 16 * 16; }

struct SelLayout {
  long long ctrl, rows, rkey, hist, ncand, zero_end, cand, bw, total;
  int groups, wtot, cap;
};

static SelLayout sel_layout(int c_rows, long long n, int k_sel) {
  SelLayout l;
  l.groups = (c_rows + SEL_GROUP - 1) / SEL_GROUP;
  l.wtot = 2 * l.groups;
  l.cap = k_sel + SEL_FINAL;
  l.ctrl = 0;
  l.rows = align16(sizeof(SelCtrl));
  l.rkey = l.rows + align16((long long)sizeof(SelRow) * c_rows);
  l.hist = l.rkey + align16(8LL * c_rows);
  l.ncand = l.hist + align16(4LL * SEL_BINS * c_rows);
  l.zero_end = l.ncand + align16(4LL * c_rows);
  l.cand = l.zero_end;
  l.bw = l.cand + align16(8LL * c_rows * l.cap);
  l.total = l.bw + align16(4LL * l.wtot * n);
  return l;
}

// Bytes of scratch ne_select needs (the wrapper allocates them).
extern "C" long long ne_select_scratch_bytes(int c_rows, long long n,
                                             int k_sel) {
  return sel_layout(c_rows, n, k_sel).total;
}

// Launches: the scan, the restart draw, SEL_PASSES passes and the finish,
// in that order on one stream.  `keys` is the (C, 2) int64 threefry keys,
// `drawn` a counter the draw adds 1 to for each row it draws.
extern "C" int ne_select(const uint8_t* vp, long long stride_c,
                         long long stride_n, const int* degree_rest,
                         const uint8_t* active, const int* remaining,
                         const long long* keys, int c_rows, long long n,
                         float lam, int k_sel, void* scratch, u64* drawn,
                         int* idx, uint8_t* valid, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        select_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SEL_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(select_pass_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SEL_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(select_finish_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 64 * 1024);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const SelLayout l = sel_layout(c_rows, n, k_sel);
  char* base = (char*)scratch;
  cudaError_t err = cudaMemsetAsync(base, 0, l.zero_end, s);
  if (err != cudaSuccess) return (int)err;
  SelArgs a;
  a.degree_rest = degree_rest;
  a.active = active;
  a.c_rows = c_rows;
  a.k_sel = k_sel;
  a.wtot = l.wtot;
  a.cap = l.cap;
  a.n = n;
  a.lam = lam;
  a.bw = (unsigned*)(base + l.bw);
  a.hist = (int*)(base + l.hist);
  a.rows = (SelRow*)(base + l.rows);
  a.ncand = (int*)(base + l.ncand);
  a.cand = (u64*)(base + l.cand);
  a.ctrl = (SelCtrl*)(base + l.ctrl);
  u64* rkey = (u64*)(base + l.rkey);

  const int vec = stride_c == 1 && c_rows % SEL_GROUP == 0 &&
                  stride_n % 16 == 0 && (uintptr_t)vp % 16 == 0;
  long long bx = (n + SEL_THREADS - 1) / SEL_THREADS;
  if (bx > 132 * 3) bx = 132 * 3;
  const dim3 grid((unsigned)bx, (unsigned)l.groups);
  select_scan_kernel<<<grid, SEL_THREADS, SEL_SMEM, s>>>(vp, stride_c,
                                                          stride_n, vec, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long dx = (n + DRAW_VERTICES - 1) / DRAW_VERTICES;
  restart_draw_kernel<<<dim3((unsigned)dx, (unsigned)c_rows), DRAW_THREADS,
                        0, s>>>(degree_rest, keys, a.rows, n, rkey, drawn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int level = 1; level <= SEL_PASSES; ++level) {
    select_pass_kernel<<<grid, SEL_THREADS, SEL_SMEM, s>>>(a, level);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int kp = 1;
  while (kp < l.cap) kp <<= 1;
  select_finish_kernel<<<c_rows, 1024, sizeof(u64) * kp, s>>>(
      a.cand, a.ncand, a.rows, rkey, active, remaining, l.cap, k_sel, idx,
      valid);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pack_bits / unpack_bits / or_words
// ---------------------------------------------------------------------------

static int grid_blocks(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  return (int)(blocks > 132 * 16 ? 132 * 16 : blocks);
}

// The 4 flags of x's bytes as bits 0-3, byte j -> bit j: __vcmpne4 sets
// a byte to 0xFF where it is not 0, & 0x80808080 keeps bit 7 of each,
// and the product by 2^0 + 2^7 + 2^14 + 2^21 moves byte j's bit 8j + 7
// to bit 28 + j; its 16 partial products land on 16 different bits, so
// nothing carries into bits 28-31.
__device__ __forceinline__ unsigned flag_nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x80808080u) * 0x00204081u) >> 28;
}

constexpr int PACK_THREADS = 256;
constexpr int PACK_WORDS = 4;      // words a thread, all loads in flight

// P % 32 == 0 and a 16-byte aligned map: word t is bytes 32t .. 32t + 31
// of the map, two 16-byte loads; one thread a word, PACK_WORDS words a
// thread, a block's words contiguous.  I is the index type (32-bit where
// 2 * total fits).
template <typename I>
__global__ void __launch_bounds__(PACK_THREADS)
pack_vec_kernel(const uint4* __restrict__ src, I total,
                unsigned* __restrict__ words) {
  const I base = (I)blockIdx.x * (PACK_THREADS * PACK_WORDS) + threadIdx.x;
  uint4 lo[PACK_WORDS], hi[PACK_WORDS];
#pragma unroll
  for (int j = 0; j < PACK_WORDS; ++j) {
    const I t = base + (I)(j * PACK_THREADS);
    if (t < total) {
      lo[j] = __ldg(src + 2 * t);
      hi[j] = __ldg(src + 2 * t + 1);
    }
  }
#pragma unroll
  for (int j = 0; j < PACK_WORDS; ++j) {
    const I t = base + (I)(j * PACK_THREADS);
    if (t < total)
      words[t] = flag_nibble(lo[j].x) | flag_nibble(lo[j].y) << 4 |
                 flag_nibble(lo[j].z) << 8 | flag_nibble(lo[j].w) << 12 |
                 flag_nibble(hi[j].x) << 16 | flag_nibble(hi[j].y) << 20 |
                 flag_nibble(hi[j].z) << 24 | flag_nibble(hi[j].w) << 28;
  }
}

// Any P and alignment: one warp a (row, word); the row and column of the
// warp's word and of its stride are divided once, then stepped.
__global__ void pack_ballot_kernel(const uint8_t* __restrict__ bools,
                                   long long n, int p, int w,
                                   unsigned* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long total = n * w;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  long long row = t / w;
  int col = (int)(t - row * w);
  const long long drow = warps / w;
  const int dcol = (int)(warps - drow * w);
  // t is warp-uniform, so every lane joins each ballot
  for (; t < total; t += warps) {
    const int c = col * 32 + lane;
    const bool b = c < p && bools[row * p + c] != 0;
    const unsigned word = __ballot_sync(0xffffffffu, b);
    if (lane == 0) words[t] = word;
    row += drow;
    col += dcol;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
}

// vec: 1 for the vector route (the caller has checked P % 32 == 0 and a
// 16-byte aligned map; refused otherwise), 0 for the ballot route.
extern "C" int ne_pack_bits(const uint8_t* bools, long long n, int p, int w,
                            int vec, unsigned* words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = n * w;
  if (vec && (p % 32 || (uintptr_t)bools % 16))
    return (int)cudaErrorInvalidValue;
  if (total > 0 && vec) {
    const long long per = PACK_THREADS * PACK_WORDS;
    const long long blocks = (total + per - 1) / per;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const uint4* src = reinterpret_cast<const uint4*>(bools);
    if (2 * total + 2 * per < 0xffffffffLL)
      pack_vec_kernel<unsigned><<<(unsigned)blocks, PACK_THREADS, 0, s>>>(
          src, (unsigned)total, words);
    else
      pack_vec_kernel<long long><<<(unsigned)blocks, PACK_THREADS, 0, s>>>(
          src, total, words);
  } else if (total > 0) {
    pack_ballot_kernel<<<grid_blocks(total * 32, 256), 256, 0, s>>>(
        bools, n, p, w, words);
  }
  return (int)cudaGetLastError();
}

// The 4 flags of bits 0-3 of nib as bytes 0-3, bit j -> byte j (0 or 1):
// the inverse of flag_nibble.  The product by 2^0 + 2^7 + 2^14 + 2^21
// puts bit j at 8j by its j-th partial product; the 16 partial products
// land on bits 0-3, 7-10, 14-17 and 21-24, so nothing carries, and the
// mask keeps bits 0, 8, 16 and 24.
__device__ __forceinline__ unsigned nibble_flags(unsigned nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

constexpr int UNPACK_THREADS = 256;
constexpr int UNPACK_HALVES = 8;   // 16-flag halves a thread, loads first

// P == 32 W: word t's flags are bytes 32t .. 32t + 31 of the map, so half
// h (bits 16(h % 2) .. + 15 of word h / 2) is the h-th 16-byte piece of
// it.  Lane l of a warp's j-th step stores half base + 256 j + l: each
// store instruction of a warp writes 512 contiguous bytes, and the two
// lanes of a word read the same 4 bytes.  I is the index type (32-bit
// where the halves fit).
template <typename I>
__global__ void __launch_bounds__(UNPACK_THREADS)
unpack_vec_kernel(const unsigned* __restrict__ words, I halves,
                  uint4* __restrict__ bools) {
  const I base = (I)blockIdx.x * (UNPACK_THREADS * UNPACK_HALVES) +
                 threadIdx.x;
  unsigned bits[UNPACK_HALVES];
#pragma unroll
  for (int j = 0; j < UNPACK_HALVES; ++j) {
    const I h = base + (I)(j * UNPACK_THREADS);
    bits[j] = h < halves ? __ldg(words + (h >> 1)) >> ((h & 1) * 16) : 0u;
  }
#pragma unroll
  for (int j = 0; j < UNPACK_HALVES; ++j) {
    const I h = base + (I)(j * UNPACK_THREADS);
    if (h < halves)
      bools[h] = make_uint4(nibble_flags(bits[j] & 15u),
                            nibble_flags((bits[j] >> 4) & 15u),
                            nibble_flags((bits[j] >> 8) & 15u),
                            nibble_flags((bits[j] >> 12) & 15u));
  }
}

// Any P: one thread per 4 flag bytes (one uchar4 store) when P % 4 == 0,
// the 4 bits lying in one word since 32 % 4 == 0; else one per byte.
template <int VEC>
__global__ void unpack_bits_kernel(const unsigned* __restrict__ words,
                                   long long n, int p, int w,
                                   uint8_t* __restrict__ bools) {
  const int per_row = p / VEC;
  const long long total = n * per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / per_row;
    const int col = (int)(t - row * per_row) * VEC;
    const unsigned bits = __ldg(words + row * w + (col >> 5)) >> (col & 31);
    if (VEC == 4) {
      reinterpret_cast<uchar4*>(bools)[t] =
          make_uchar4(bits & 1u, (bits >> 1) & 1u, (bits >> 2) & 1u,
                      (bits >> 3) & 1u);
    } else {
      bools[t] = (uint8_t)(bits & 1u);
    }
  }
}

// vec: 1 for the vector route (the caller has checked P == 32 W; refused
// otherwise, and for a map that is not 16-byte aligned), 0 for the
// generic route.  bools must be 4-byte aligned (the wrapper allocates it).
extern "C" int ne_unpack_bits(const unsigned* words, long long n, int p,
                              int w, int vec, uint8_t* bools, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec && (p != 32 * w || (uintptr_t)bools % 16))
    return (int)cudaErrorInvalidValue;
  const long long halves = 2 * n * w;
  if (n > 0 && vec) {
    const long long per = UNPACK_THREADS * UNPACK_HALVES;
    const long long blocks = (halves + per - 1) / per;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    uint4* out = reinterpret_cast<uint4*>(bools);
    if (halves + per < 0xffffffffLL)
      unpack_vec_kernel<unsigned><<<(unsigned)blocks, UNPACK_THREADS, 0, s>>>(
          words, (unsigned)halves, out);
    else
      unpack_vec_kernel<long long><<<(unsigned)blocks, UNPACK_THREADS, 0,
                                      s>>>(words, halves, out);
  } else if (n > 0 && p % 4 == 0) {
    unpack_bits_kernel<4><<<grid_blocks(n * (p / 4), 256), 256, 0, s>>>(
        words, n, p, w, bools);
  } else if (n > 0) {
    unpack_bits_kernel<1><<<grid_blocks(n * p, 256), 256, 0, s>>>(
        words, n, p, w, bools);
  }
  return (int)cudaGetLastError();
}

constexpr int OR_THREADS = 256;
constexpr int OR_VEC = 4;          // items of a and of b a thread, loads first

// All three pointers 16-byte aligned: a block ORs OR_THREADS * OR_VEC
// contiguous int4s (16 KB of output), a thread's 2 * OR_VEC 16-byte loads
// all in flight before the first OR; the last block also ORs the `tail`
// (count % 4) words past the last int4.  I is the index type.
template <typename I>
__global__ void __launch_bounds__(OR_THREADS)
or_vec_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
              I count4, I tail, int4* __restrict__ out) {
  const I base = (I)blockIdx.x * (OR_THREADS * OR_VEC) + threadIdx.x;
  int4 x[OR_VEC], y[OR_VEC];
#pragma unroll
  for (int j = 0; j < OR_VEC; ++j) {
    const I i = base + (I)(j * OR_THREADS);
    if (i < count4) {
      x[j] = __ldg(a + i);
      y[j] = __ldg(b + i);
    }
  }
#pragma unroll
  for (int j = 0; j < OR_VEC; ++j) {
    const I i = base + (I)(j * OR_THREADS);
    if (i < count4)
      out[i] = make_int4(x[j].x | y[j].x, x[j].y | y[j].y, x[j].z | y[j].z,
                         x[j].w | y[j].w);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const I i = count4 * 4 + threadIdx.x;
    reinterpret_cast<int*>(out)[i] =
        __ldg(reinterpret_cast<const int*>(a) + i) |
        __ldg(reinterpret_cast<const int*>(b) + i);
  }
}

// Any alignment: a block ORs OR_THREADS * OR_VEC contiguous words, a
// thread's loads all in flight before the first OR.
template <typename I>
__global__ void __launch_bounds__(OR_THREADS)
or_scalar_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 I count, int* __restrict__ out) {
  const I base = (I)blockIdx.x * (OR_THREADS * OR_VEC) + threadIdx.x;
  int x[OR_VEC], y[OR_VEC];
#pragma unroll
  for (int j = 0; j < OR_VEC; ++j) {
    const I i = base + (I)(j * OR_THREADS);
    if (i < count) {
      x[j] = __ldg(a + i);
      y[j] = __ldg(b + i);
    }
  }
#pragma unroll
  for (int j = 0; j < OR_VEC; ++j) {
    const I i = base + (I)(j * OR_THREADS);
    if (i < count) out[i] = x[j] | y[j];
  }
}

// vec: 1 for the vector route (the caller has checked that a, b and out
// are 16-byte aligned; refused otherwise), 0 for the scalar route.
extern "C" int ne_or_words(const int* a, const int* b, long long count,
                           int vec, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec && (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  if (count <= 0) return (int)cudaGetLastError();
  const long long per = OR_THREADS * OR_VEC;
  const long long items = vec ? count / 4 : count;
  const long long blocks = items > 0 ? (items + per - 1) / per : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool narrow = count + per < 0xffffffffLL;
  if (vec) {
    const int4* a4 = reinterpret_cast<const int4*>(a);
    const int4* b4 = reinterpret_cast<const int4*>(b);
    int4* o4 = reinterpret_cast<int4*>(out);
    if (narrow)
      or_vec_kernel<unsigned><<<(unsigned)blocks, OR_THREADS, 0, s>>>(
          a4, b4, (unsigned)items, (unsigned)(count % 4), o4);
    else
      or_vec_kernel<long long><<<(unsigned)blocks, OR_THREADS, 0, s>>>(
          a4, b4, items, count % 4, o4);
  } else if (narrow) {
    or_scalar_kernel<unsigned><<<(unsigned)blocks, OR_THREADS, 0, s>>>(
        a, b, (unsigned)count, out);
  } else {
    or_scalar_kernel<long long><<<(unsigned)blocks, OR_THREADS, 0, s>>>(
        a, b, count, out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// two_hop_best
// ---------------------------------------------------------------------------

// FMT 0: (N, W) words; 1: (N, P) bool rows, 16-byte loads; 2: byte loads
template <int FMT>
__global__ void two_hop_kernel(const void* __restrict__ map, int w, int p,
                               const int* __restrict__ u,
                               const int* __restrict__ v,
                               const uint8_t* __restrict__ un,
                               const int* __restrict__ enc, long long ce,
                               int* __restrict__ best) {
  extern __shared__ int enc_s[];
  for (int i = threadIdx.x; i < p; i += blockDim.x) enc_s[i] = enc[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < ce; e += stride) {
    int b = I32_INF;
    if (un[e]) {
      const long long a = u[e], c = v[e];
      if (FMT == 0) {
        const unsigned* words = static_cast<const unsigned*>(map);
        for (int j = 0; j < w; ++j) {
          for (unsigned x = __ldg(words + a * w + j) & __ldg(words + c * w + j);
               x; x &= x - 1) {
            const int q = 32 * j + __ffs(x) - 1;
            if (q < p) b = min(b, enc_s[q]);
          }
        }
      } else if (FMT == 1) {
        const uint4* ra = static_cast<const uint4*>(map) + a * (p / 16);
        const uint4* rc = static_cast<const uint4*>(map) + c * (p / 16);
        for (int j = 0; j < p / 16; ++j) {
          const uint4 x = __ldg(ra + j), y = __ldg(rc + j);
          const unsigned m = nz16(make_uint4(x.x & y.x, x.y & y.y,
                                             x.z & y.z, x.w & y.w));
          for (unsigned t = m; t; t &= t - 1)
            b = min(b, enc_s[16 * j + __ffs(t) - 1]);
        }
      } else {
        const uint8_t* ra = static_cast<const uint8_t*>(map) + a * p;
        const uint8_t* rc = static_cast<const uint8_t*>(map) + c * p;
        for (int q = 0; q < p; ++q)
          if (ra[q] && rc[q]) b = min(b, enc_s[q]);
      }
    }
    best[e] = b;
  }
}

// words != 0: `map` is (N, w) int32 words; else (N, p) bool rows.
extern "C" int ne_two_hop_best(const void* map, int words, int w, int p,
                               const int* u, const int* v, const uint8_t* un,
                               const int* enc, long long ce, int* best,
                               void* stream) {
  if (ce <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = grid_blocks(ce, 256);
  const size_t smem = sizeof(int) * p;
  if (words)
    two_hop_kernel<0><<<blocks, 256, smem, s>>>(map, w, p, u, v, un, enc, ce,
                                                best);
  else if (p % 16 == 0 && (uintptr_t)map % 16 == 0)
    two_hop_kernel<1><<<blocks, 256, smem, s>>>(map, w, p, u, v, un, enc, ce,
                                                best);
  else
    two_hop_kernel<2><<<blocks, 256, smem, s>>>(map, w, p, u, v, un, enc, ce,
                                                best);
  return (int)cudaGetLastError();
}
