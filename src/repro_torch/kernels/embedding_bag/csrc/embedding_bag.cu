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
//   out[b, d] = Σ_k weights[b, k] · table[ids[b, k], d], summed in float32
//   registers over k in order (no atomics: the order is fixed), then
//   rounded once to the table's type.
//
//   Bound: bytes.  The rows B·K·D·sizeof(T), the ids B·K·4 (+ the weights
//   B·K·4 when given) and the output B·D·sizeof(T), against 3.35 TB/s;
//   the 2·B·K·D operations are nothing beside them.
//
//   Design (simple first): the serving rows are narrow (D = 10, 40 bytes;
//   D = 1 for the first-order weights), so one warp per bag would idle 22
//   or 31 of its 32 lanes.  Instead every thread owns one output element
//   (b, d): consecutive threads take consecutive d of a bag and then the
//   next bag, so a warp covers 32 / D bags with every lane busy, and the
//   D threads of a bag read one row as one contiguous run.  Each thread
//   loops over k in order, loading ids[b, k] and weights[b, k] (the same
//   address for the D threads of a bag: one broadcast) and its element
//   of the row.  Offsets are 64-bit (id · D reaches 4.1e8 at full size).
//   No shared memory and no prefetch of the next row: rows are random
//   gathers, and the many warps in flight hide their latency.
//
// Plain C interface: device pointers and a cudaStream_t passed as void*;
// launches on that stream, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
           const float* __restrict__ w, long long total, int k, int d,
           T* __restrict__ out) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const long long b = e / d;
  const int c = (int)(e - b * d);
  const int* bag_ids = ids + b * k;
  const float* bag_w = w ? w + b * k : nullptr;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const float row = to_f32(table[(long long)bag_ids[j] * d + c]);
    acc = fmaf(row, bag_w ? bag_w[j] : 1.f, acc);
  }
  store(out + e, acc);
}

template <typename T>
int launch(const void* table, const int* ids, const float* w, long long b,
           int k, int d, void* out, cudaStream_t s) {
  const long long total = b * d;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bag_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(table), ids, w, total, k, d,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (the table's and the output's type).
extern "C" int embedding_bag(const void* table, int dtype, const int* ids,
                             const float* weights, long long b, int k,
                             int d, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(table, ids, weights, b, k, d, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, ids, weights, b, k, d, out, s);
  return (int)cudaErrorInvalidValue;
}
