// The two streaming baseline partitioners for Hopper (sm_90a): HDRF
// [Petroni+ CIKM'15] and PowerGraph's Oblivious greedy, one edge a step
// in stream order.
//
// Plain C interface, as in the other families: each entry point takes
// device pointers and a cudaStream_t passed as void*, launches on that
// stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).  The Python wrapper (ops.py)
// allocates the (N, P) replica flags, the partial degrees and the output,
// checks shapes and types, and raises on a non-zero return.
//
// hdrf_kernel — replaces the lax.scan of repro/core/baselines.py::
//   _hdrf_scan.  That is no Pallas kernel: XLA runs the scan one edge a
//   step.  For the edge (u, v): bump the partial degrees, score every
//   partition as C_rep + lam * C_bal, take the first maximum, mark u and
//   v in it and add one to its |E_p|.  The float32 steps are the ones XLA
//   runs on the CPU, read from the reference's optimised HLO:
//     theta_u = f32(du) / f32(du + dv)
//     g_u = in_u ? 2 - theta_u : 0          XLA folds 1 + (1 - x) to 2 - x
//     g_v = in_v ? 2 - (1 - theta_u) : 0    (theta_v = 1 - theta_u first)
//     c_bal = spread > 0 ? f32(max - |E_p|) / max(f32(spread), 1) : 1
//     score = (g_u + g_v) + lam * c_bal     each rounded: no FMA
//   Each is written with a _rn intrinsic, so nvcc contracts nothing.  XLA
//   contracts lam * x + y into an FMA in a plain elementwise fusion on the
//   CPU, but not in this scan's fused reduction: an FMA picks another
//   partition at a near tie (tests/test_torch_baselines.py).
// oblivious_kernel — replaces baselines.py::_oblivious_scan: among the
//   partitions with room (|E_p| < limit) the first of least |E_p| that
//   holds both endpoints, else one endpoint, else any; every partition
//   full: the first of least |E_p| overall.  |E_p| is compared as float32,
//   as the reference's -f32(sizes) score is, so ties past 2^24 stay its.
//
// Bound: latency.  Each step reads |E_p| after the step before chose its
// partition, so the M steps form one dependent chain: the scores, a
// reduction over P and the update.  The bytes (8 of edge and 4 of output
// an edge, two rows of P flags) and the operations (a few dozen for each
// of P partitions) would take microseconds at the card's rates.
// Design: one thread block for the whole stream; thread t owns the
// partitions t, t + T, t + 2T, ... (T = blockDim, P rounded up to 32, at
// most 1,024), so any P works.  |E_p| lives in shared memory and only its
// owner writes it; the (N, P) flags and the partial degrees in device
// memory (L2-resident at the test sizes).  A step: the next edge is
// already in registers; each thread scores its partitions and keeps the
// best as one 64-bit key (score order, then the lowest index), a warp
// shuffle reduction, one key a warp in shared memory, a barrier, every
// thread reduces the warp keys itself; thread 0 writes the partial
// degrees and the output, the owner of the chosen partition its |E_p|
// and its two flags after a second barrier.  The owner is the only
// thread that ever reads a partition's flags and |E_p|, so its own
// writes are in order for it; the second barrier orders the degree
// writes before the next step's reads.  HDRF's max and min of |E_p| are
// kept in registers (the same in every thread): max grows with the
// chosen count, and min rises when the last partition at min leaves it,
// when a block-wide count finds how many sit at the new min.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int SMEM_LIMIT = 227 * 1024;   // a block's shared memory, opted in
constexpr unsigned long long NONE = ~0ull;

// a float's order as an unsigned int (negative values included)
__device__ __forceinline__ uint32_t ordered(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(0xffffffffu, k, o);
    k = x > k ? x : k;
  }
  return k;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(0xffffffffu, k, o);
    k = x < k ? x : k;
  }
  return k;
}

// How many partitions hold |E_p| == level (every thread of the block calls
// it, and gets the same count).
__device__ int block_count(const int* sizes, int p, int level,
                           int* scratch) {
  int c = 0;
  for (int j = threadIdx.x; j < p; j += blockDim.x) c += sizes[j] == level;
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = c;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  return total;
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
hdrf_kernel(const int2* __restrict__ edges, long long m, int p,
            unsigned char* __restrict__ vp, int* __restrict__ pdeg,
            float lam, int* __restrict__ out) {
  extern __shared__ int sizes[];                 // (P,) |E_p|
  __shared__ unsigned long long red[MAX_WARPS];
  __shared__ int scratch[MAX_WARPS];
  const int t = threadIdx.x, lane = t & 31, nw = blockDim.x >> 5;
  for (int j = t; j < p; j += blockDim.x) sizes[j] = 0;
  __syncthreads();
  int maxs = 0, mins = 0, nmin = p;              // max, min, count at min
  int2 next = edges[0];
  for (long long i = 0; i < m; ++i) {
    const int u = next.x, v = next.y;
    if (i + 1 < m) next = edges[i + 1];
    const int same = u == v;                     // a loop adds 2 to both
    const int du = pdeg[u] + 1 + same, dv = pdeg[v] + 1 + same;
    const float tu = __fdiv_rn(__int2float_rn(du), __int2float_rn(du + dv));
    const float gu1 = __fsub_rn(2.f, tu);
    const float gv1 = __fsub_rn(2.f, __fsub_rn(1.f, tu));
    const float spread = __int2float_rn(maxs - mins);
    const float den = fmaxf(spread, 1.f);
    unsigned char* ru = vp + (size_t)u * p;
    unsigned char* rv = vp + (size_t)v * p;
    unsigned long long best = 0;
    for (int j = t; j < p; j += blockDim.x) {
      const float g = __fadd_rn(ru[j] ? gu1 : 0.f, rv[j] ? gv1 : 0.f);
      const float cb = spread > 0.f
          ? __fdiv_rn(__int2float_rn(maxs - sizes[j]), den) : 1.f;
      // + 0 turns -0 into +0: the two tie as floats
      const float s = __fadd_rn(__fadd_rn(g, __fmul_rn(lam, cb)), 0.f);
      const unsigned long long key =
          ((unsigned long long)ordered(s) << 32) | (0xffffffffu - (uint32_t)j);
      best = key > best ? key : best;
    }
    best = warp_max(best);
    if (lane == 0) red[t >> 5] = best;
    __syncthreads();
    for (int w = 0; w < nw; ++w) best = red[w] > best ? red[w] : best;
    const int tgt = (int)(0xffffffffu - (uint32_t)(best & 0xffffffffu));
    const int old = sizes[tgt];
    if (t == 0) {
      pdeg[u] = du;
      pdeg[v] = dv;
      out[i] = tgt;
    }
    maxs = max(maxs, old + 1);
    if (old == mins && --nmin == 0) {
      // tgt was the last partition at min; it now joins min + 1
      nmin = block_count(sizes, p, mins + 1, scratch) + 1;
      ++mins;
    }
    __syncthreads();
    if (tgt % (int)blockDim.x == t) {
      sizes[tgt] = old + 1;
      ru[tgt] = 1;
      rv[tgt] = 1;
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
oblivious_kernel(const int2* __restrict__ edges, long long m, int p,
                 unsigned char* __restrict__ vp, int limit,
                 int* __restrict__ out) {
  extern __shared__ int sizes[];                 // (P,) |E_p|
  // the least key of each candidate class: both endpoints, one, room, any
  __shared__ unsigned long long red[4][MAX_WARPS];
  const int t = threadIdx.x, lane = t & 31, nw = blockDim.x >> 5;
  for (int j = t; j < p; j += blockDim.x) sizes[j] = 0;
  __syncthreads();
  int2 next = edges[0];
  for (long long i = 0; i < m; ++i) {
    const int u = next.x, v = next.y;
    if (i + 1 < m) next = edges[i + 1];
    unsigned char* ru = vp + (size_t)u * p;
    unsigned char* rv = vp + (size_t)v * p;
    unsigned long long k[4] = {NONE, NONE, NONE, NONE};
    for (int j = t; j < p; j += blockDim.x) {
      const int sz = sizes[j];
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(__int2float_rn(sz)) << 32) |
          (uint32_t)j;
      const bool room = sz < limit;
      const bool iu = room && ru[j], iv = room && rv[j];
      if (iu && iv) k[0] = key < k[0] ? key : k[0];
      if (iu || iv) k[1] = key < k[1] ? key : k[1];
      if (room) k[2] = key < k[2] ? key : k[2];
      k[3] = key < k[3] ? key : k[3];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      k[c] = warp_min(k[c]);
      if (lane == 0) red[c][t >> 5] = k[c];
    }
    __syncthreads();
    unsigned long long pick = NONE;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      unsigned long long kc = NONE;
      for (int w = 0; w < nw; ++w) kc = red[c][w] < kc ? red[c][w] : kc;
      if (pick == NONE) pick = kc;
    }
    const int tgt = (int)(pick & 0xffffffffu);
    if (t == 0) out[i] = tgt;
    __syncthreads();
    if (tgt % (int)blockDim.x == t) {
      sizes[tgt] += 1;
      ru[tgt] = 1;
      rv[tgt] = 1;
    }
  }
}

// Shared memory of a launch, opted in above 48 KB; cudaErrorInvalidValue
// where P does not fit a block.
int prepare(const void* kernel, int p, int threads, size_t* smem) {
  *smem = (size_t)p * sizeof(int);
  if (threads < 32 || threads > MAX_THREADS || threads % 32 ||
      *smem > SMEM_LIMIT - 2048)
    return (int)cudaErrorInvalidValue;
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return 0;
}

}  // namespace

extern "C" int stream_hdrf(const void* edges, long long m, int p, void* vp,
                           void* pdeg, float lam, int threads, void* out,
                           void* stream) {
  if (m < 1 || p < 1 || (uintptr_t)edges % 8) return (int)cudaErrorInvalidValue;
  size_t smem;
  const int err = prepare((const void*)hdrf_kernel, p, threads, &smem);
  if (err) return err;
  hdrf_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(edges), m, p,
      static_cast<unsigned char*>(vp), static_cast<int*>(pdeg), lam,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

extern "C" int stream_oblivious(const void* edges, long long m, int p,
                                void* vp, int limit, int threads, void* out,
                                void* stream) {
  if (m < 1 || p < 1 || (uintptr_t)edges % 8) return (int)cudaErrorInvalidValue;
  size_t smem;
  const int err = prepare((const void*)oblivious_kernel, p, threads, &smem);
  if (err) return err;
  oblivious_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(edges), m, p,
      static_cast<unsigned char*>(vp), limit, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
