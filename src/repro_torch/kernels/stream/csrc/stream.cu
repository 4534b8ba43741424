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
//   The candidate sets nest (both ⊆ one endpoint ⊆ room ⊆ all), so each
//   partition has a class: 0 both endpoints with room, 1 one endpoint
//   with room, 2 room, 3 none.  The pick is the least (class,
//   f32(|E_p|), index): the candidates are the partitions at the least
//   class, and every partition is at class 3 when none has room.
//
// Bound: latency.  Each step reads |E_p| after the step before chose its
// partition, so the M steps form one dependent chain: the scores, a
// reduction over P and the update.  The bytes (8 of edge and 4 of output
// an edge, two rows of P flags) and the operations (a few dozen for each
// of P partitions) would take microseconds at the card's rates.
//
// hdrf_warp_kernel (route "warp", P <= 256: the quality matrix's P 4 and
// 16, the NE cells' 64).  One warp walks the stream and never meets a
// block barrier: every step's state is the warp's own.  Lane l owns the
// partitions l, l + 32, ... (W = ceil(P / 32) slots); their |E_p| live in
// its registers.  The replica flags are bit words, (N, W) uint32 (bit l
// of word s is partition 32 s + l), so an endpoint's flags are W 4-byte
// loads, the same address in every lane.  A step: each lane scores its
// slots; the warp's maximum of each slot's 32-bit ordered score by
// __reduce_max_sync (redux.sync), then the first maximum by
// __ballot_sync + __ffs, slot by slot in index order (the lowest index
// among equal scores, -0 tied with +0, as the block kernel's 64-bit key).
// Step i starts the loads of edge i + 1's partial degrees and flag words
// (its endpoints read a step earlier) before it stores edge i's, so they
// have a step to arrive.  Where edge i writes a vertex that edge i + 1
// reads, the degree and the bit it wrote are kept beside edge i + 1's
// loaded values and applied when its step begins: forwarding from
// registers, which never waits on the load it corrects.  Every lane
// issues the same loads and stores (one transaction each), so each
// lane's later loads see its own stores in program order.  Max and min
// of |E_p| and the count at min are warp-uniform registers; ballots of
// the partitions at max and at min, taken off the chain, say whether the
// chosen one moves them (no shuffle of its |E_p|); when the last
// partition at min leaves it, __popc(__ballot_sync) counts the new min.
// The score's division with a zero dividend (a partition at max) gives
// +0 without __fdiv_rn, whose slow path a zero dividend takes.
//
// oblivious_warp_kernel (route "warp", P <= 256: the quality matrix's P
// 4 and 16) is HDRF's warp design without the degrees: lane l owns the
// partitions l, l + 32, ... with their |E_p| in registers, the flags are
// (N, W) bit words, edge i + 1's flag words load before edge i's stores
// and the bit edge i sets is forwarded from registers.  A step: each lane
// takes the least class of its slots (the room test is register work);
// the warp's least class by __reduce_min_sync; among the slots at that
// class the least float32 bit pattern of |E_p| (|E_p| >= 0, so the bits
// order as the values; past 2^24 equal floats tie as in the reference)
// by a second __reduce_min_sync; then the first such index by
// __ballot_sync + __ffs, slot by slot in index order.  Two redux.sync
// and W ballots a step, where the block kernel runs four 64-bit shuffle
// trees, a shared-memory exchange and two barriers.
//
// hdrf_kernel and oblivious_kernel (route "block", any P: the tests' P =
// 1,500): one thread block for the whole stream; thread t owns the
// partitions t, t + T, t + 2T, ... (T = blockDim, P rounded up to 32, at
// most 1,024), so any P works.  |E_p| lives in shared memory and only
// its owner writes it; the (N, P) byte flags and the partial degrees in
// device memory (L2-resident at the test sizes).  A step: the next edge
// is already in registers; each thread scores its partitions and keeps
// the best as one 64-bit key (score order, then the lowest index), a
// warp shuffle reduction, one key a warp in shared memory, a barrier,
// every thread reduces the warp keys itself; thread 0 writes the partial
// degrees and the output, the owner of the chosen partition its |E_p|
// and its two flags after a second barrier.  The owner is the only
// thread that ever reads a partition's flags and |E_p|, so its own
// writes are in order for it; the second barrier orders the degree
// writes before the next step's reads.  HDRF's max and min of |E_p| are
// kept in registers (the same in every thread): max grows with the
// chosen count, and min rises when the last partition at min leaves it,
// when a block-wide count finds how many sit at the new min.
//
// Precision: both HDRF kernels round every float32 step of the score
// with its own _rn intrinsic, in the order above; nothing is contracted
// into an FMA, so the output is the plain version's and the reference's
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int WARP_MAX_P = 256;          // route "warp": 8 words a vertex
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

// HDRF's float32 score of a partition, each step rounded (see above)
__device__ __forceinline__ float hdrf_score(bool in_u, bool in_v, float gu1,
                                            float gv1, int maxs, int size,
                                            float spread, float den,
                                            float lam) {
  const float g = __fadd_rn(in_u ? gu1 : 0.f, in_v ? gv1 : 0.f);
  // 0 / den is +0 exactly; a zero dividend fails __fdiv_rn's range check
  // and takes its slow path, which a warp at max |E_p| met every step
  const int num = maxs - size;
  const float cb = spread > 0.f
      ? (num == 0 ? 0.f : __fdiv_rn(__int2float_rn(num), den)) : 1.f;
  // + 0 turns -0 into +0: the two tie as floats
  return __fadd_rn(__fadd_rn(g, __fmul_rn(lam, cb)), 0.f);
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
      const float s = hdrf_score(ru[j], rv[j], gu1, gv1, maxs, sizes[j],
                                 spread, den, lam);
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

template <int W>
__global__ void __launch_bounds__(32, 1)
hdrf_warp_kernel(const int2* __restrict__ edges, int m, int p,
                 uint32_t* vp, int* pdeg, float lam, int* __restrict__ out) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  int sz[W];                                     // |E_p| of my partitions
#pragma unroll
  for (int s = 0; s < W; ++s) sz[s] = 0;
  int maxs = 0, mins = 0, nmin = p;              // max, min, count at min
  // edge i's state as loaded, and what edge i - 1 wrote to its endpoints
  // (kept apart: applying it never waits on the load)
  int2 e = edges[0];
  int pu_l = pdeg[e.x], pv_l = pdeg[e.y];
  uint32_t fu_l[W], fv_l[W];
#pragma unroll
  for (int s = 0; s < W; ++s) {
    fu_l[s] = vp[(size_t)e.x * W + s];
    fv_l[s] = vp[(size_t)e.y * W + s];
  }
  bool hu = false, hv = false;                   // endpoint written ...
  int ou = 0, ov = 0, fts = 0;                   // ... its degree, word
  uint32_t fbit = 0;                             // ... and bit
  int2 nx = m > 1 ? edges[1] : e;                // edge i + 1's endpoints
  for (int i = 0; i < m; ++i) {
    const int u = e.x, v = e.y;
    const int pu = hu ? ou : pu_l, pv = hv ? ov : pv_l;
    uint32_t fu[W], fv[W];
#pragma unroll
    for (int s = 0; s < W; ++s) {
      fu[s] = fu_l[s] | (hu && s == fts ? fbit : 0u);
      fv[s] = fv_l[s] | (hv && s == fts ? fbit : 0u);
    }
    // edge i + 1's state starts loading, before edge i's stores
    if (i + 1 < m) {
      pu_l = pdeg[nx.x];
      pv_l = pdeg[nx.y];
#pragma unroll
      for (int s = 0; s < W; ++s) {
        fu_l[s] = vp[(size_t)nx.x * W + s];
        fv_l[s] = vp[(size_t)nx.y * W + s];
      }
    }
    const int2 nn = i + 2 < m ? edges[i + 2] : nx;
    // the partitions at max and at min before this edge, so that the
    // chosen one's |E_p| needs no shuffle
    uint32_t amax[W], amin[W];
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const bool ok = s * 32 + lane < p;
      amax[s] = __ballot_sync(FULL, ok && sz[s] == maxs);
      amin[s] = __ballot_sync(FULL, ok && sz[s] == mins);
    }
    const int same = u == v;                     // a loop adds 2 to both
    const int du = pu + 1 + same, dv = pv + 1 + same;
    const float tu = __fdiv_rn(__int2float_rn(du), __int2float_rn(du + dv));
    const float gu1 = __fsub_rn(2.f, tu);
    const float gv1 = __fsub_rn(2.f, __fsub_rn(1.f, tu));
    const float spread = __int2float_rn(maxs - mins);
    const float den = fmaxf(spread, 1.f);
    uint32_t key[W];
    uint32_t best = 0;
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const uint32_t o = ordered(hdrf_score((fu[s] >> lane) & 1u,
                                            (fv[s] >> lane) & 1u, gu1, gv1,
                                            maxs, sz[s], spread, den, lam));
      // 0 is below every score's order (only a NaN maps there)
      key[s] = W * 32 <= p || s * 32 + lane < p ? o : 0u;
      best = max(best, __reduce_max_sync(FULL, key[s]));
    }
    int ts = W, tl = 0;                          // the first maximum
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const uint32_t hit = __ballot_sync(FULL, key[s] == best);
      if (ts == W && hit) {
        ts = s;
        tl = __ffs(hit) - 1;
      }
    }
    const uint32_t bit = 1u << tl;
    uint32_t wu = 0, wv = 0, at_max = 0, at_min = 0;
#pragma unroll
    for (int s = 0; s < W; ++s)
      if (s == ts) {
        wu = fu[s] | bit;
        wv = fv[s] | bit;
        at_max = amax[s] & bit;
        at_min = amin[s] & bit;
      }
    // every lane stores the same values: one transaction each
    pdeg[u] = du;
    pdeg[v] = dv;
    vp[(size_t)u * W + ts] = wu;
    vp[(size_t)v * W + ts] = wv;                // == wu where u == v
    if (lane == 0) out[i] = ts * 32 + tl;
    maxs += at_max != 0;
    if (at_min && --nmin == 0) {
      // the chosen partition was the last at min; it now joins min + 1
      int c = 0;
#pragma unroll
      for (int s = 0; s < W; ++s)
        c += __popc(__ballot_sync(FULL, s * 32 + lane < p &&
                                            sz[s] == mins + 1));
      nmin = c + 1;
      ++mins;
    }
#pragma unroll
    for (int s = 0; s < W; ++s)
      if (s == ts && lane == tl) ++sz[s];
    // what edge i wrote that edge i + 1 loaded before the stores
    hu = nx.x == u || nx.x == v;
    hv = nx.y == u || nx.y == v;
    ou = nx.x == u ? du : dv;
    ov = nx.y == u ? du : dv;
    fts = ts;
    fbit = bit;
    e = nx;
    nx = nn;
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

template <int W>
__global__ void __launch_bounds__(32, 1)
oblivious_warp_kernel(const int2* __restrict__ edges, int m, int p,
                      uint32_t* vp, int limit, int* __restrict__ out) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int PAST = 4;                        // a lane slot past P
  const int lane = threadIdx.x;
  int sz[W];                                     // |E_p| of my partitions
#pragma unroll
  for (int s = 0; s < W; ++s) sz[s] = 0;
  // edge i's flag words as loaded, and the bit edge i - 1 set in them
  // (kept apart: applying it never waits on the load)
  int2 e = edges[0];
  uint32_t fu_l[W], fv_l[W];
#pragma unroll
  for (int s = 0; s < W; ++s) {
    fu_l[s] = vp[(size_t)e.x * W + s];
    fv_l[s] = vp[(size_t)e.y * W + s];
  }
  bool hu = false, hv = false;                   // endpoint written ...
  int fts = 0;                                   // ... in word fts
  uint32_t fbit = 0;                             // ... with this bit
  int2 nx = m > 1 ? edges[1] : e;                // edge i + 1's endpoints
  for (int i = 0; i < m; ++i) {
    const int u = e.x, v = e.y;
    uint32_t fu[W], fv[W];
#pragma unroll
    for (int s = 0; s < W; ++s) {
      fu[s] = fu_l[s] | (hu && s == fts ? fbit : 0u);
      fv[s] = fv_l[s] | (hv && s == fts ? fbit : 0u);
    }
    // edge i + 1's flag words start loading, before edge i's stores
    if (i + 1 < m) {
#pragma unroll
      for (int s = 0; s < W; ++s) {
        fu_l[s] = vp[(size_t)nx.x * W + s];
        fv_l[s] = vp[(size_t)nx.y * W + s];
      }
    }
    const int2 nn = i + 2 < m ? edges[i + 2] : nx;
    int cls[W];
    int cmin = PAST;
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const uint32_t iu = (fu[s] >> lane) & 1u, iv = (fv[s] >> lane) & 1u;
      cls[s] = !(W * 32 <= p || s * 32 + lane < p) ? PAST
               : sz[s] >= limit ? 3 : (iu & iv) ? 0 : (iu | iv) ? 1 : 2;
      cmin = min(cmin, cls[s]);
    }
    cmin = __reduce_min_sync(FULL, cmin);
    uint32_t key[W];
    uint32_t best = 0xffffffffu;
#pragma unroll
    for (int s = 0; s < W; ++s) {
      key[s] = cls[s] == cmin ? __float_as_uint(__int2float_rn(sz[s]))
                              : 0xffffffffu;
      best = min(best, key[s]);
    }
    // a candidate's key is a float's bits below 0xffffffff
    best = __reduce_min_sync(FULL, best);
    int ts = W, tl = 0;                          // the first at the least
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const uint32_t hit = __ballot_sync(FULL, key[s] == best);
      if (ts == W && hit) {
        ts = s;
        tl = __ffs(hit) - 1;
      }
    }
    const uint32_t bit = 1u << tl;
    uint32_t wu = 0, wv = 0;
#pragma unroll
    for (int s = 0; s < W; ++s)
      if (s == ts) {
        wu = fu[s] | bit;
        wv = fv[s] | bit;
      }
    // every lane stores the same values: one transaction each
    vp[(size_t)u * W + ts] = wu;
    vp[(size_t)v * W + ts] = wv;                // == wu where u == v
    if (lane == 0) out[i] = ts * 32 + tl;
#pragma unroll
    for (int s = 0; s < W; ++s)
      if (s == ts && lane == tl) ++sz[s];
    // what edge i wrote that edge i + 1 loaded before the stores
    hu = nx.x == u || nx.x == v;
    hv = nx.y == u || nx.y == v;
    fts = ts;
    fbit = bit;
    e = nx;
    nx = nn;
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

template <int W>
int launch_hdrf_warp(const void* edges, long long m, int p, void* vp,
                     void* pdeg, float lam, void* out, cudaStream_t s) {
  hdrf_warp_kernel<W><<<1, 32, 0, s>>>(
      static_cast<const int2*>(edges), (int)m, p, static_cast<uint32_t*>(vp),
      static_cast<int*>(pdeg), lam, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

template <int W>
int launch_oblivious_warp(const void* edges, long long m, int p, void* vp,
                          int limit, void* out, cudaStream_t s) {
  oblivious_warp_kernel<W><<<1, 32, 0, s>>>(
      static_cast<const int2*>(edges), (int)m, p, static_cast<uint32_t*>(vp),
      limit, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// route 0 ("block"): vp is (N, P) uint8 flags, `threads` a block; route 1
// ("warp", P <= 256, M < 2^31): vp is (N, ceil(P / 32)) uint32 bit words,
// one warp (threads == 32).  A route whose precondition fails is refused.
extern "C" int stream_hdrf(const void* edges, long long m, int p, void* vp,
                           void* pdeg, float lam, int route, int threads,
                           void* out, void* stream) {
  if (m < 1 || p < 1 || (uintptr_t)edges % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (p > WARP_MAX_P || m > 0x7fffffffLL || threads != 32 ||
        (uintptr_t)vp % 4)
      return (int)cudaErrorInvalidValue;
    switch ((p + 31) / 32) {
      case 1: return launch_hdrf_warp<1>(edges, m, p, vp, pdeg, lam, out, st);
      case 2: return launch_hdrf_warp<2>(edges, m, p, vp, pdeg, lam, out, st);
      case 3: return launch_hdrf_warp<3>(edges, m, p, vp, pdeg, lam, out, st);
      case 4: return launch_hdrf_warp<4>(edges, m, p, vp, pdeg, lam, out, st);
      case 5: return launch_hdrf_warp<5>(edges, m, p, vp, pdeg, lam, out, st);
      case 6: return launch_hdrf_warp<6>(edges, m, p, vp, pdeg, lam, out, st);
      case 7: return launch_hdrf_warp<7>(edges, m, p, vp, pdeg, lam, out, st);
      case 8: return launch_hdrf_warp<8>(edges, m, p, vp, pdeg, lam, out, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  size_t smem;
  const int err = prepare((const void*)hdrf_kernel, p, threads, &smem);
  if (err) return err;
  hdrf_kernel<<<1, threads, smem, st>>>(
      static_cast<const int2*>(edges), m, p,
      static_cast<unsigned char*>(vp), static_cast<int*>(pdeg), lam,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// routes as stream_hdrf's: 0 ("block") the (N, P) uint8 flags and
// `threads` a block, 1 ("warp") the (N, ceil(P / 32)) uint32 bit words
// and one warp; a route whose precondition fails is refused.
extern "C" int stream_oblivious(const void* edges, long long m, int p,
                                void* vp, int limit, int route, int threads,
                                void* out, void* stream) {
  if (m < 1 || p < 1 || (uintptr_t)edges % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (p > WARP_MAX_P || m > 0x7fffffffLL || threads != 32 ||
        (uintptr_t)vp % 4)
      return (int)cudaErrorInvalidValue;
    switch ((p + 31) / 32) {
      case 1: return launch_oblivious_warp<1>(edges, m, p, vp, limit, out, st);
      case 2: return launch_oblivious_warp<2>(edges, m, p, vp, limit, out, st);
      case 3: return launch_oblivious_warp<3>(edges, m, p, vp, limit, out, st);
      case 4: return launch_oblivious_warp<4>(edges, m, p, vp, limit, out, st);
      case 5: return launch_oblivious_warp<5>(edges, m, p, vp, limit, out, st);
      case 6: return launch_oblivious_warp<6>(edges, m, p, vp, limit, out, st);
      case 7: return launch_oblivious_warp<7>(edges, m, p, vp, limit, out, st);
      case 8: return launch_oblivious_warp<8>(edges, m, p, vp, limit, out, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  size_t smem;
  const int err = prepare((const void*)oblivious_kernel, p, threads, &smem);
  if (err) return err;
  oblivious_kernel<<<1, threads, smem, st>>>(
      static_cast<const int2*>(edges), m, p,
      static_cast<unsigned char*>(vp), limit, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
