// The Distributed NE expansion round's kernels for Hopper (sm_90a): the
// three of every round, and the three of the SPMD round's bit-packed
// replica sets.
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
// select — replaces ne_round.py::select.
//   For a (C, N) chunk of partitions: boundary mask vparts & D_rest > 0 &
//   active, |B|, the K smallest D_rest with ties to the lowest vertex id,
//   k_eff = clamp(ceil(lam |B|), 1, K), the capacity prefix cut against
//   `remaining`, and the restart slot 0 from the pre-drawn rnd_v.
//   Bound: device memory, C*N bytes of replica flags plus 4N of D_rest.
//   The TPU kernel streams tiles through one core and merges a (C, K)
//   top-k accumulator from tile to tile; blocks here run in no order, so
//   the work is split in two launches:
//   * select_compact: one thread per vertex reads its C replica flags
//     (the chunk arrives as a strided (C, N) view of the (N, P) replica
//     map: row stride 1 byte, vertex stride P bytes; the kernel reads it
//     in place through the strides given, no contiguous copy) and appends
//     the 64-bit key (D_rest << 32) | v of each boundary vertex to its
//     row's buffer with a warp-aggregated atomicAdd.  The final counter
//     is |B|.  Keys are unique, so their order is a total order equal to
//     the reference's (score, lowest index) tie rule.
//   * select_finish: one block per row runs an MSB-first radix select
//     (8-bit digits, shared-memory histograms) over the row's compacted
//     keys to find the K-th smallest, collects the keys at or below it,
//     sorts them (bitonic, shared memory) and runs the epilogue.
//   The compacted keys are |B| per row, far fewer than N, so the radix
//   passes read little; the one full pass over the chunk is the compact.
//
// pack_bits / unpack_bits / or_words — replace ne_round.py::pack_bits,
//   ::unpack_bits and ::or_words.  A replica set of P partitions is
//   W = ceil(P/32) 32-bit words per vertex: partition p is bit p % 32 of
//   word p / 32, LSB-first, and the pad bits P..32W-1 are 0.  The port
//   holds a word as the int32 bit pattern of the reference's uint32 word.
//   All three are memory-bound integer passes; their bound is the bytes
//   they stream (N*P flag bytes, 4*N*W word bytes).
//   * pack_bits: one warp per (row, word).  Lane l reads flag byte 32w + l
//     of the row (0 past P), and __ballot_sync hands back the word with
//     lane l's flag in bit l, which is the LSB-first layout; lane 0 stores
//     it.  A warp's 32 loads are one 32-byte sector of the row.
//   * unpack_bits: one thread per 4 flag bytes, one uchar4 store, when
//     P % 4 == 0 (the 4 bits lie in one word since 32 % 4 == 0); else one
//     thread per byte.  Words are read unsigned: the shift is logical.
//   * or_words: int4 (16-byte) loads and stores while all three pointers
//     are 16-byte aligned, a scalar tail; scalar throughout otherwise.

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

__global__ void select_compact_kernel(const uint8_t* __restrict__ vp,
                                      long long stride_c, long long stride_n,
                                      const int* __restrict__ degree_rest,
                                      const uint8_t* __restrict__ active,
                                      int c_rows, long long n,
                                      u64* __restrict__ keys,
                                      int* __restrict__ bsize) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is warp-uniform so every lane joins each ballot
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i - lane < n; i += stride) {
    const bool in = i < n;
    const int d = in ? degree_rest[i] : 0;
    for (int c = 0; c < c_rows; ++c) {
      const bool b = d > 0 && active[c] && vp[c * stride_c + i * stride_n];
      const unsigned ballot = __ballot_sync(0xffffffffu, b);
      if (ballot == 0) continue;
      const int leader = __ffs(ballot) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&bsize[c], __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (b)
        keys[(long long)c * n + base + __popc(ballot & lt_mask)] =
            ((u64)(unsigned)d << 32) | (u64)(unsigned)i;
    }
  }
}

__device__ u64 block_max_u64(u64 x, u64* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 y = __shfl_down_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 mx = 0;
    for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w)
      mx = scratch[w] > mx ? scratch[w] : mx;
    scratch[0] = mx;
  }
  __syncthreads();
  const u64 out = scratch[0];
  __syncthreads();
  return out;
}

// dynamic shared memory: kp u64 selection slots (kp = K rounded up to a
// power of two)
__global__ void select_finish_kernel(const u64* __restrict__ keys,
                                     const int* __restrict__ bsize,
                                     const uint8_t* __restrict__ active,
                                     const int* __restrict__ remaining,
                                     const int* __restrict__ rnd_v,
                                     const uint8_t* __restrict__ any_ok,
                                     long long n, float lam, int k_sel,
                                     int kp, int* __restrict__ idx_out,
                                     uint8_t* __restrict__ valid_out) {
  extern __shared__ u64 sel[];
  __shared__ int hist[256];
  __shared__ u64 scratch[32];
  __shared__ u64 prefix;
  __shared__ int krem;
  __shared__ int nsel;

  const int c = blockIdx.x;
  const int bs = bsize[c];
  const int kneed = bs < k_sel ? bs : k_sel;
  const u64* row = keys + (long long)c * n;

  // threshold: the kneed-th smallest key (all keys when |B| <= K)
  u64 thresh = ~0ull;
  if (bs > k_sel) {
    u64 mx = 0;
    for (int i = threadIdx.x; i < bs; i += blockDim.x)
      mx = row[i] > mx ? row[i] : mx;
    mx = block_max_u64(mx, scratch);
    const int top = 63 - __clzll((long long)mx);
    if (threadIdx.x == 0) { prefix = 0; krem = kneed; }
    for (int shift = (top / 8) * 8; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
      __syncthreads();
      const u64 want = shift + 8 >= 64 ? 0ull : prefix >> (shift + 8);
      for (int i = threadIdx.x; i < bs; i += blockDim.x) {
        const u64 key = row[i];
        const u64 hi = shift + 8 >= 64 ? 0ull : key >> (shift + 8);
        if (hi == want) atomicAdd(&hist[(key >> shift) & 255], 1);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int cum = 0, digit = 0;
        for (; digit < 256; ++digit) {
          if (cum + hist[digit] >= krem) break;
          cum += hist[digit];
        }
        krem -= cum;
        prefix |= (u64)digit << shift;
      }
      __syncthreads();
    }
    thresh = prefix;
  }

  // collect the kneed keys at or below the threshold, pad, sort
  if (threadIdx.x == 0) nsel = 0;
  for (int i = threadIdx.x; i < kp; i += blockDim.x) sel[i] = ~0ull;
  __syncthreads();
  for (int i = threadIdx.x; i < bs; i += blockDim.x) {
    const u64 key = row[i];
    if (key <= thresh) sel[atomicAdd(&nsel, 1)] = key;
  }
  __syncthreads();
  for (int k = 2; k <= kp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kp; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const u64 a = sel[i], b = sel[ixj];
          if ((a > b) == up) { sel[i] = b; sel[ixj] = a; }
        }
      }
      __syncthreads();
    }
  }

  // epilogue (sequential over K: the capacity cut is a prefix sum)
  if (threadIdx.x == 0) {
    const bool act = active[c] != 0;
    const bool restart = bs == 0 && act && any_ok[0] != 0;
    int k_eff = (int)ceilf(__fmul_rn(lam, (float)bs));
    k_eff = k_eff < 1 ? 1 : (k_eff > k_sel ? k_sel : k_eff);
    const int rem = remaining[c];
    unsigned cum = 0;                 // int32 prefix sum, wrapping
    for (int i = 0; i < k_sel; ++i) {
      const bool have = i < kneed;
      const int score = have ? (int)(sel[i] >> 32) : 0;
      int vid = have ? (int)(sel[i] & 0xffffffffull) : 0;
      bool val = have && i < k_eff;
      cum += val ? (unsigned)score : 0u;
      val = val && ((int)cum <= rem || i == 0);
      if (i == 0 && restart) { vid = rnd_v[c]; val = true; }
      idx_out[(long long)c * k_sel + i] = vid;
      valid_out[(long long)c * k_sel + i] = (val && act) ? 1 : 0;
    }
  }
}

extern "C" int ne_select(const uint8_t* vparts_c, long long stride_c,
                         long long stride_n, const int* degree_rest,
                         const uint8_t* active, const int* remaining,
                         const int* rnd_v, const uint8_t* any_ok, int c_rows,
                         long long n, float lam, int k_sel,
                         unsigned long long* keys, int* bsize, int* idx,
                         uint8_t* valid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(bsize, 0, sizeof(int) * c_rows, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    select_compact_kernel<<<(int)blocks, 256, 0, s>>>(
        vparts_c, stride_c, stride_n, degree_rest, active, c_rows, n, keys,
        bsize);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int kp = 1;
  while (kp < k_sel) kp <<= 1;
  select_finish_kernel<<<c_rows, 1024, sizeof(u64) * kp, s>>>(
      keys, bsize, active, remaining, rnd_v, any_ok, n, lam, k_sel, kp, idx,
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

__global__ void pack_bits_kernel(const uint8_t* __restrict__ bools,
                                 long long n, int p, int w,
                                 unsigned* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long total = n * w;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // t is warp-uniform, so every lane joins each ballot
  for (long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       t < total; t += warps) {
    const long long row = t / w;
    const int col = (int)(t - row * w) * 32 + lane;
    const bool b = col < p && bools[row * p + col] != 0;
    const unsigned word = __ballot_sync(0xffffffffu, b);
    if (lane == 0) words[t] = word;
  }
}

extern "C" int ne_pack_bits(const uint8_t* bools, long long n, int p, int w,
                            unsigned* words, void* stream) {
  const long long total = n * w;
  if (total > 0)
    pack_bits_kernel<<<grid_blocks(total * 32, 256), 256, 0,
                       (cudaStream_t)stream>>>(bools, n, p, w, words);
  return (int)cudaGetLastError();
}

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

// bools must be 4-byte aligned (the wrapper allocates it)
extern "C" int ne_unpack_bits(const unsigned* words, long long n, int p,
                              int w, uint8_t* bools, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && p % 4 == 0)
    unpack_bits_kernel<4><<<grid_blocks(n * (p / 4), 256), 256, 0, s>>>(
        words, n, p, w, bools);
  else if (n > 0)
    unpack_bits_kernel<1><<<grid_blocks(n * p, 256), 256, 0, s>>>(
        words, n, p, w, bools);
  return (int)cudaGetLastError();
}

__global__ void or_words_kernel(const int* __restrict__ a,
                                const int* __restrict__ b, long long count,
                                long long count4, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int4* a4 = reinterpret_cast<const int4*>(a);
  const int4* b4 = reinterpret_cast<const int4*>(b);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < count4; i += stride) {
    const int4 x = __ldg(a4 + i), y = __ldg(b4 + i);
    o4[i] = make_int4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
  }
  for (long long i = count4 * 4 + tid; i < count; i += stride)
    out[i] = a[i] | b[i];
}

extern "C" int ne_or_words(const int* a, const int* b, long long count,
                           int* out, void* stream) {
  const bool aligned =
      (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15) == 0;
  const long long count4 = aligned ? count / 4 : 0;
  const long long work = count4 + (count - count4 * 4);
  if (count > 0)
    or_words_kernel<<<grid_blocks(work, 256), 256, 0,
                      (cudaStream_t)stream>>>(a, b, count, count4, out);
  return (int)cudaGetLastError();
}
