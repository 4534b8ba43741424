// EmbeddingBag gather-reduce for Hopper (sm_90a).
//
// embedding_bag — replaces
//   repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_kernel
//   (the Pallas kernel whose grid (bag, slot) pulls one table row into
//   VMEM per step through a scalar-prefetched index map and carries the
//   bag's float32 sum in VMEM scratch from slot to slot).
//
//   table   (V, D) float32 or bfloat16, row-major.
//   ids     (B, K) int32: the table row of each (bag, slot).
//   weights (B, K) float32, or null for weight 1 in every slot; weight 0
//           marks a padding slot, whose row is still read and multiplied
//           by 0 (as on the TPU: a non-finite row gives NaN).
//   out     (B, D) in the table's type, written once.
//   out[b, d] = fmaf(row_k, w_k, acc) over k = 0..K-1 in order, from
//   acc = 0 in float32, then rounded once to the table's type.  The
//   order is fixed (no atomics, no tree), so the bits are those of a
//   slot-by-slot float32 sum and the same from call to call.
//
//   Bound: bytes.  The rows B·K·D·sizeof(T), the ids B·K·4 (+ the weights
//   B·K·4 when given) and the output B·D·sizeof(T), against 3.35 TB/s;
//   the 2·B·K·D operations are nothing beside them.  A random row comes
//   from device memory in whole 32-byte sectors, so the rows really cost
//   the sectors they touch (a 40-byte row two, a 4-byte row one).
//
//   Design: the rows are random gathers of 4 to 40 bytes, so the kernel
//   is bound by how many loads are in flight, not by instructions.  A
//   block takes G whole bags (or, for a bag whose K·D values do not fit
//   the shared-memory budget, one bag in tiles of KT slots, in order):
//   * stage: the block's G·K ids (and weights) are one contiguous run;
//     its threads copy it into shared memory with 16-byte loads between
//     a scalar head and tail;
//   * gather: every thread issues its share of the G·K row loads, GATHER
//     of them back to back before it stores any, so all are in flight
//     together.  Consecutive threads take consecutive VEC-element pieces
//     of one row (VEC elements = 16, 8 or 4 bytes where the row length
//     and the table's address allow), and the values go to shared memory
//     as float32;
//   * sum: after one barrier the thread of output (b, d) runs the fmaf
//     chain over k in order from shared memory and stores once.  Across
//     tiles the chain's value waits in shared memory.
//   A warp-shuffle tree would change the order of the sum and its last
//   bits; the in-order chain keeps the bits of the one-thread-an-output
//   kernel this design replaced.  ops.plan picks
//   G (at least 2 blocks an SM where B allows), KT, the column tile and
//   VEC; the entry point refuses a plan the kernel cannot run.  Offsets
//   into the table are 64-bit (id · D reaches 4.1e8 at full size).
//
// embedding_bag_backward — the gradient of the same function (no TPU
//   kernel: the reference trains through XLA's gather).
//
//   grad_table (V, D) in the table's type, dense: every row written, 0
//           where no slot reads it, else Σ w[b, k] · grad_out[b] over
//           the slots (b, k) with ids[b, k] == row, in slot order b·K + k,
//           in float32 (each product rounded, then added: __fmul_rn and
//           __fadd_rn, no contraction), rounded once.
//   grad_w  (B, K) float32, where asked for: ⟨table[ids[b, k]],
//           grad_out[b]⟩, summed over the columns in order by fmaf.
//   The caller sorts the flat ids stably (`sorted`, with `perm` the slot
//   of each sorted entry: preparation, a torch.sort), so the slots of one
//   row form a run in slot order.  zero_kernel writes the whole grad
//   table; then run_kernel gives one thread each (run, column), and the
//   thread at the run's first entry sums the run in order and stores
//   once.  No atomics: the bits are the same from call to call.
//
//   Bound: bytes.  The dense grad write V·D·sizeof(T) (1.64 GB at
//   DeepFM's full table) dominates; the sorted ids, the permutation and
//   the grad_out rows read are small beside it.
//
// Plain C interface: device pointers and a cudaStream_t passed as void*;
// launches on that stream, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER = 8;      // row loads a thread issues before storing

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// VEC elements of T loaded as one access of VEC * sizeof(T) bytes
template <int BYTES> struct Raw;
template <> struct Raw<16> { typedef uint4 type; };
template <> struct Raw<8> { typedef uint2 type; };
template <> struct Raw<4> { typedef unsigned type; };
template <> struct Raw<2> { typedef unsigned short type; };

// 32-bit word i of a load (i is a constant after unrolling)
__device__ __forceinline__ unsigned word_of(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ unsigned word_of(const uint2& r, int i) {
  return i == 0 ? r.x : r.y;
}
__device__ __forceinline__ unsigned word_of(unsigned r, int) { return r; }

template <typename T, int VEC>
struct Piece {
  typedef typename Raw<VEC * sizeof(T)>::type raw;
  static __device__ __forceinline__ raw load(const T* p) {
    return __ldg(reinterpret_cast<const raw*>(p));
  }
  // the VEC values as float32 into dst[0 .. VEC-1]: a float32 is a word;
  // a bfloat16 is the high half of a float32's bits (exact), element 2i
  // in the low half of word i, 2i + 1 in the high half (little-endian)
  static __device__ __forceinline__ void put(const raw& r, float* dst) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (sizeof(T) == 4) {
        dst[i] = __uint_as_float(word_of(r, i));
      } else if constexpr (VEC == 1) {
        dst[i] = __uint_as_float((unsigned)r << 16);
      } else {
        const unsigned x = word_of(r, i / 2);
        dst[i] = __uint_as_float(i & 1 ? x & 0xffff0000u : x << 16);
      }
    }
  }
};

// src[0 .. n-1] (32-bit values: ids or weights) into dst, 16-byte loads
// between a scalar head and tail
__device__ __forceinline__ void copy_run(const unsigned* __restrict__ src,
                                         int n, unsigned* __restrict__ dst) {
  int head = (int)((16 - ((uintptr_t)src & 15)) & 15) / 4;
  head = head < n ? head : n;
  const int body = (n - head) / 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    dst[i] = __ldg(src + i);
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  unsigned* d = dst + head;
  for (int i = threadIdx.x; i < body; i += blockDim.x) {
    const uint4 v = __ldg(s4 + i);
    d[4 * i] = v.x;
    d[4 * i + 1] = v.y;
    d[4 * i + 2] = v.z;
    d[4 * i + 3] = v.w;
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

// grid (ceil(B / g), ceil(D / dt)); block: g bags (g == 1 when kt < k),
// the columns [blockIdx.y * dt, + dt) of their outputs, slots in tiles
// of kt.  Shared memory: ids[g·kt], weights[g·kt] (when given),
// rows[g·kt·dt] float32, and the carried sums[g·dt] when kt < k.
template <typename T, int VEC>
__global__ void bag_kernel(const T* __restrict__ table,
                           const int* __restrict__ ids,
                           const float* __restrict__ w, long long b, int k,
                           int d, int g, int kt, int dt,
                           T* __restrict__ out) {
  extern __shared__ float smem[];
  typedef Piece<T, VEC> P;
  const long long bag0 = (long long)blockIdx.x * g;
  const int gb = (int)(b - bag0 < g ? b - bag0 : g);     // bags here
  const int c_lo = blockIdx.y * dt;
  const int dc = d - c_lo < dt ? d - c_lo : dt;         // columns here
  int* ids_s = reinterpret_cast<int*>(smem);
  float* w_s = smem + g * kt;
  float* rows_s = w_s + (w ? g * kt : 0);
  float* acc_s = rows_s + g * kt * dt;
  const int units = dc / VEC;                            // pieces a row
  const int tpr = units < (int)blockDim.x ? units : (int)blockDim.x;
  const int rpp = blockDim.x / tpr;                      // rows a pass
  const int r0 = threadIdx.x / tpr, c0 = threadIdx.x - r0 * tpr;
  const int outs = gb * dc;
  for (int k0 = 0; k0 < k; k0 += kt) {
    const int kn = k - k0 < kt ? k - k0 : kt;
    const int ns = gb * kn;             // one run: gb == 1 or kn == k
    copy_run(reinterpret_cast<const unsigned*>(ids + bag0 * k + k0), ns,
             reinterpret_cast<unsigned*>(ids_s));
    if (w)
      copy_run(reinterpret_cast<const unsigned*>(w + bag0 * k + k0), ns,
               reinterpret_cast<unsigned*>(w_s));
    __syncthreads();
    if (r0 < rpp) {
      for (int cu = c0; cu < units; cu += tpr) {
        const T* col = table + c_lo + cu * VEC;
        for (int s = r0; s < ns; s += GATHER * rpp) {
          typename P::raw v[GATHER];
#pragma unroll
          for (int j = 0; j < GATHER; ++j) {
            const int sj = s + j * rpp;
            if (sj < ns) v[j] = P::load(col + (long long)ids_s[sj] * d);
          }
#pragma unroll
          for (int j = 0; j < GATHER; ++j) {
            const int sj = s + j * rpp;
            if (sj < ns) P::put(v[j], rows_s + sj * dc + cu * VEC);
          }
        }
      }
    }
    __syncthreads();
    const bool last = k0 + kn == k;
    for (int o = threadIdx.x; o < outs; o += blockDim.x) {
      const int gg = o / dc, c = o - gg * dc;
      const float* r = rows_s + gg * kn * dc + c;
      const float* ws = w_s + gg * kn;
      float acc = k0 ? acc_s[o] : 0.f;
      if (w) {
        for (int j = 0; j < kn; ++j) acc = fmaf(r[j * dc], ws[j], acc);
      } else {
        for (int j = 0; j < kn; ++j) acc = fmaf(r[j * dc], 1.f, acc);
      }
      if (last)
        store(out + (bag0 + gg) * d + c_lo + c, acc);
      else
        acc_s[o] = acc;
    }
    if (!last) __syncthreads();         // the next tile reuses the buffers
  }
}

template <typename T, int VEC>
int launch(const void* table, const int* ids, const float* w, long long b,
           int k, int d, int g, int kt, int dt, int threads, int smem,
           void* out, cudaStream_t s) {
  const long long gx = (b + g - 1) / g;
  const int gy = (d + dt - 1) / dt;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  bag_kernel<T, VEC><<<dim3((unsigned)gx, (unsigned)gy), threads, smem, s>>>(
      static_cast<const T*>(table), ids, w, b, k, d, g, kt, dt,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}


// ---- the backward -------------------------------------------------------

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// out[0 .. n) = 0 in 16-byte stores between a scalar head and tail
__global__ void zero_kernel(unsigned char* __restrict__ out, long long n) {
  const long long head = (long long)((16 - ((uintptr_t)out & 15)) & 15);
  const long long h = head < n ? head : n;
  const long long body = (n - h) / 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = t; i < h; i += stride) out[i] = 0;
  uint4* o4 = reinterpret_cast<uint4*>(out + h);
  for (long long i = t; i < body; i += stride) o4[i] = make_uint4(0, 0, 0, 0);
  for (long long i = h + 16 * body + t; i < n; i += stride) out[i] = 0;
}

// thread (p, c): if sorted entry p starts a run of equal ids, the run's
// column c, summed in order
template <typename T>
__global__ void run_kernel(const int* __restrict__ sorted,
                           const int* __restrict__ perm,
                           const T* __restrict__ gout,
                           const float* __restrict__ w, long long n, int k,
                           int d, T* __restrict__ gtab) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * d) return;
  const long long p = e / d;
  const int c = (int)(e - p * d);
  const int id = sorted[p];
  if (p > 0 && sorted[p - 1] == id) return;
  float acc = 0.f;
  for (long long q = p; q < n && sorted[q] == id; ++q) {
    const long long slot = perm[q];
    const float g = widen(gout[(slot / k) * d + c]);
    acc = __fadd_rn(acc, w ? __fmul_rn(w[slot], g) : g);
  }
  store(gtab + (long long)id * d + c, acc);
}

// thread s: grad_w[s] = Σ_c table[ids[s], c] · grad_out[s / K, c]
template <typename T>
__global__ void weight_grad_kernel(const T* __restrict__ table,
                                   const int* __restrict__ ids,
                                   const T* __restrict__ gout, long long n,
                                   int k, int d, float* __restrict__ gw) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const T* row = table + (long long)ids[s] * d;
  const T* g = gout + (s / k) * d;
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(widen(row[c]), widen(g[c]), acc);
  gw[s] = acc;
}

template <typename T>
int launch_backward(const void* table, const int* ids, const int* sorted,
                    const int* perm, const float* w, const void* gout,
                    long long b, int k, int d, long long v, void* gtab,
                    float* gw, cudaStream_t s) {
  const long long n = b * k;
  const T* go = static_cast<const T*>(gout);
  if (gtab) {
    const long long bytes = v * d * (long long)sizeof(T);
    zero_kernel<<<2 * 132 * 8, 256, 0, s>>>(
        static_cast<unsigned char*>(gtab), bytes);
    const long long work = n * d;
    if (work > 0) {
      const long long blocks = (work + 255) / 256;
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      run_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
          sorted, perm, go, w, n, k, d, static_cast<T*>(gtab));
    }
  }
  if (gw && n > 0) {
    const long long blocks = (n + 255) / 256;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    weight_grad_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const T*>(table), ids, go, n, k, d, gw);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (the table's and the output's type).
// g, kt, dt, vec, threads and smem are ops.plan's: bags a block, slots a
// tile, columns a block, elements a load, threads a block and the
// dynamic shared-memory bytes (at most the 48 KB a block gets without
// opting in: the plan tiles the slots to fit).  A plan the kernel cannot
// run is refused with cudaErrorInvalidValue before any launch.
extern "C" int embedding_bag(const void* table, int dtype, const int* ids,
                             const float* weights, long long b, int k,
                             int d, int g, int kt, int dt, int vec,
                             int threads, int smem, void* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int size = dtype == 0 ? 4 : 2;
  const long long need =
      4LL * g * kt * (1 + (weights != nullptr) + dt) + (kt < k ? 4LL * g * dt
                                                               : 0);
  if (b < 1 || k < 1 || d < 1 || g < 1 || kt < 1 || kt > k || dt < 1 ||
      dt > d || (kt < k && g != 1) || vec < 1 || dt % vec || d % vec ||
      (uintptr_t)table % (vec * size) || threads < 32 || threads > 1024 ||
      threads % 32 || smem < need || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 1: return launch<float, 1>(table, ids, weights, b, k, d, g, kt,
                                      dt, threads, smem, out, s);
      case 2: return launch<float, 2>(table, ids, weights, b, k, d, g, kt,
                                      dt, threads, smem, out, s);
      case 4: return launch<float, 4>(table, ids, weights, b, k, d, g, kt,
                                      dt, threads, smem, out, s);
    }
  } else if (dtype == 1) {
    typedef __nv_bfloat16 bf;
    switch (vec) {
      case 1: return launch<bf, 1>(table, ids, weights, b, k, d, g, kt, dt,
                                   threads, smem, out, s);
      case 2: return launch<bf, 2>(table, ids, weights, b, k, d, g, kt, dt,
                                   threads, smem, out, s);
      case 4: return launch<bf, 4>(table, ids, weights, b, k, d, g, kt, dt,
                                   threads, smem, out, s);
      case 8: return launch<bf, 8>(table, ids, weights, b, k, d, g, kt, dt,
                                   threads, smem, out, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The gradient of embedding_bag (sum mode).  dtype as above (the table's,
// grad_out's and grad_table's type).  ids (B, K) int32; sorted (B·K,) the
// flat ids sorted stably and perm (B·K,) int32 each sorted entry's slot
// b·K + k; weights (B, K) float32 or null (weight 1); grad_out (B, D).
// grad_table (V, D), or null for no table gradient; grad_w (B, K)
// float32, or null for no weight gradient.  Ids must lie in [0, V).
extern "C" int embedding_bag_backward(const void* table, int dtype,
                                      const int* ids, const int* sorted,
                                      const int* perm, const float* weights,
                                      const void* grad_out, long long b,
                                      int k, int d, long long v,
                                      void* grad_table, float* grad_w,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 0 || k < 0 || d < 1 || v < 0 || (grad_table && (!sorted || !perm))
      || (grad_w && (!table || !ids)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_backward<float>(table, ids, sorted, perm, weights,
                                  grad_out, b, k, d, v, grad_table, grad_w,
                                  s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(table, ids, sorted, perm, weights,
                                          grad_out, b, k, d, v, grad_table,
                                          grad_w, s);
  return (int)cudaErrorInvalidValue;
}
