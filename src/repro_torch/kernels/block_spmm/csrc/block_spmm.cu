// Block-sparse SpMM for Hopper (sm_90a): out = A @ x for a block-CSR A.
//
// block_spmm — replaces repro/kernels/block_spmm/block_spmm.py::block_spmm
//   (the Pallas kernel that runs one (bm, bn) @ (bn, F) MXU product per
//   grid step (i, j) and carries the (bm, F) sum of row tile i in VMEM
//   from slot to slot, with cols[i, j] scalar-prefetched into the x
//   index map).
//
//   cols   (R, NB) int32: the column block of each (row tile, slot);
//          padded slots point at block 0 and hold an all-zero block.
//   blocks (R, NB, bm, bn) float32.
//   x      (x_rows, F) float32, x_rows = C * bn.
//   out    (R * bm, F) float32, written once.
//   Every slot is computed, padded ones included, so a non-finite value
//   in x's block 0 reaches every row tile with a padded slot, as on the
//   TPU.  Sums are float32, over slots in order and over the bn inner
//   index in chunks of TK; only that order differs from the plain
//   version (torch.einsum), and A's entries are small integers.
//
//   Bound: 2 * R * NB * bm * bn * F operations against 67 TFLOP/s (FP32
//   CUDA cores, H100 SXM data sheet), or the bytes of blocks + x + out +
//   cols against 3.35 TB/s, whichever is longer.  At the GIN cell
//   (R = 22, NB = 22, bm = bn = 128) the first layer (F = 1433) is bound
//   by operations; the later layers (F = 64) nearly balance the two.
//
//   Design (simple first; wgmma, TMA and skipping padded or empty tiles
//   are later work): one block of 128 threads per (row tile, TM rows of
//   it, TN = 64 columns of F).  It loops over the NB slots, reads its own
//   cols[i, j] (in place of scalar prefetch), and for each TK = 32 slice
//   of bn stages the (TM, TK) piece of the block (transposed) and the
//   (TK, TN) rows of x in at most 12.8 KB of static shared memory; each
//   thread keeps a (TM / 8) x 4 tile of sums in registers and writes it
//   once.
//   TM is 32, or 16 when that gives too few blocks to fill the SMs (the
//   F = 64 layers: 22 row tiles x 4 x 1 = 88 blocks at TM = 32) or when
//   bm is 16.  Loads are scalar and masked, so any F works (F = 1433 is
//   odd: no float4 loads from x); the shared-memory reads are float4 or
//   float2.
//
// Plain C interface: device pointers and a cudaStream_t passed as void*;
// launches on that stream, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // 16 column groups x 8 row groups
constexpr int TN = 64;         // columns of F per block, 4 per thread
constexpr int TK = 32;         // slice of the block's bn inner index

template <int RPT>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void get(const float* p, float (&a)[4]) {
    float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  }
};
template <>
struct Vec<2> {
  __device__ static void get(const float* p, float (&a)[2]) {
    float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  }
};

// RPT rows per thread; a block covers TM = 8 * RPT rows of one row tile.
template <int RPT>
__global__ void __launch_bounds__(THREADS)
spmm_kernel(const int* __restrict__ cols, const float* __restrict__ blocks,
            const float* __restrict__ x, int nb, int bm, int bn,
            long long x_rows, int f, float* __restrict__ out) {
  constexpr int TM = 8 * RPT;
  constexpr int AS = TM + 4;   // row stride of a_s: keeps float4 alignment
  __shared__ __align__(16) float a_s[TK][AS];   // a_s[k][row]
  __shared__ __align__(16) float x_s[TK][TN];

  const long long tile = blockIdx.x;
  const int r0 = blockIdx.y * TM;
  const int f0 = blockIdx.z * TN;
  const int t = threadIdx.x;
  const int tx = t % 16;          // columns f0 + 4 tx .. + 3
  const int ty = t / 16;          // rows r0 + RPT ty .. + RPT - 1

  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int j = 0; j < nb; ++j) {
    const long long slot = tile * nb + j;
    const long long xrow0 = (long long)cols[slot] * bn;
    const float* a = blocks + slot * bm * bn;
    for (int k0 = 0; k0 < bn; k0 += TK) {
      // (TM, TK) of the block: consecutive threads read consecutive k
      for (int e = t; e < TM * TK; e += THREADS) {
        const int rr = e / TK, kk = e % TK;
        const int row = r0 + rr, k = k0 + kk;
        a_s[kk][rr] = (row < bm && k < bn) ? a[(long long)row * bn + k]
                                           : 0.f;
      }
      // (TK, TN) of x: consecutive threads read consecutive columns
      for (int e = t; e < TK * TN; e += THREADS) {
        const int kk = e / TN, c = e % TN;
        const long long xr = xrow0 + k0 + kk;
        const int fc = f0 + c;
        x_s[kk][c] = (k0 + kk < bn && fc < f && xr < x_rows)
                         ? x[xr * f + fc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        float av[RPT];
        Vec<RPT>::get(&a_s[kk][ty * RPT], av);
        const float4 xv = *reinterpret_cast<const float4*>(&x_s[kk][tx * 4]);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          acc[r][0] = fmaf(av[r], xv.x, acc[r][0]);
          acc[r][1] = fmaf(av[r], xv.y, acc[r][1]);
          acc[r][2] = fmaf(av[r], xv.z, acc[r][2]);
          acc[r][3] = fmaf(av[r], xv.w, acc[r][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = r0 + ty * RPT + r;
    if (row >= bm) continue;
    float* o = out + (tile * bm + row) * (long long)f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int fc = f0 + tx * 4 + c;
      if (fc < f) o[fc] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int block_spmm(const int* cols, const float* blocks,
                          const float* x, long long r, int nb, int bm,
                          int bn, long long x_rows, int f, float* out,
                          void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned fz = (unsigned)((f + TN - 1) / TN);
  const long long wide = r * ((bm + 31) / 32) * fz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 16 || wide < 2LL * sms) {
    dim3 grid((unsigned)r, (unsigned)((bm + 15) / 16), fz);
    spmm_kernel<2><<<grid, THREADS, 0, s>>>(cols, blocks, x, nb, bm, bn,
                                            x_rows, f, out);
  } else {
    dim3 grid((unsigned)r, (unsigned)((bm + 31) / 32), fz);
    spmm_kernel<4><<<grid, THREADS, 0, s>>>(cols, blocks, x, nb, bm, bn,
                                            x_rows, f, out);
  }
  return (int)cudaGetLastError();
}
