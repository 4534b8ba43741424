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
//   x      (x_rows, F) float32, x_rows = C * bn; rows of x at or past
//          x_rows read as 0.
//   out    (R * bm, F) float32, written once.
//   Every slot is computed, padded ones included, so a non-finite value
//   in x's block 0 reaches every row tile with a padded slot, as on the
//   TPU.
//
//   Bound: 2 * R * NB * bm * bn * F operations against the rate of the
//   units that run them (67 TFLOP/s FP32 on the CUDA cores; 495 TFLOP/s
//   TF32 on the tensor cores, three products an entry below), or the
//   bytes of blocks + x + out + cols against 3.35 TB/s, whichever is
//   longer (H100 SXM data sheet).  At the GIN cell (R = NB = 22,
//   bm = bn = 128) the F = 64 layers are bound by the 31.7 MB of blocks;
//   the first layer (F = 1,433) by operations.
//
// Two designs behind two entry points; the wrapper (ops.py) picks one by
// shape and alignment, and both run on the card:
//
// * block_spmm_tc — tensor cores at float32 accuracy (bm >= 64, bn a
//   multiple of 32, blocks 16-byte aligned).
//   Split TF32 ("3xTF32"): each operand v becomes hi = tf32(v) and
//   lo = tf32(v - hi) (round to nearest even on the 13 low mantissa bits;
//   v - hi is exact), and each product is A_hi x_hi + A_hi x_lo
//   + A_lo x_hi, three mma.sync.m16n8k8 TF32 products into float32
//   accumulators: about 22 bits of each operand, where one TF32 product
//   keeps 11 and misses the 1e-5 (|A| @ |x|) check at a row with one
//   neighbour.  x is split once a step for the whole block, in shared
//   memory.  A is taken as it is (hi = A, lo = 0, two products) where
//   every entry of the block's staged (128 x 32) A tile is finite and
//   exact in TF32, which __syncthreads_and decides on the data, so the
//   same inputs take the same path: build_block_csr's entries are
//   integer edge counts, so the GNN path runs two products.  Other A
//   tiles are split fragment by fragment, and the A_lo product is
//   skipped where a warp's fragment has A_lo == 0 everywhere.
//   Non-finite values: hi keeps inf, and a NaN becomes the canonical NaN
//   (TF32 reads only the top 19 bits, so a NaN whose payload lies in the
//   low 13 bits would read as inf); lo is 0 there, and the two
//   cross products take hi with non-finite values set to 0.  So exactly
//   one product, A_hi x_hi, carries an inf or NaN, and the output has
//   the plain version's non-finite pattern.  A finite value whose
//   rounding would carry into the exponent (|v| near FLT_MAX) has both
//   terms truncated instead, so hi and hi + lo stay finite.
//   Work: one block per (row tile, 128 rows of it, BN columns of F, range
//   of slots), each warp owning 64 x 32 of the output: BN = 64 (4 warps,
//   two blocks an SM) for F <= 64, else BN = 128 (8 warps, one block an
//   SM), which halves the re-reads of A from L2 across F tiles.  Slots
//   are split over blocks (`per` slots each) when the (row tile, F tile)
//   pairs alone cannot fill the card (the F = 64 layers: 22 pairs on 132
//   SMs); each block then writes a float32 partial into a workspace the
//   wrapper allocates, and spmm_reduce_kernel sums the partials in split
//   order (no float atomics: two calls on the same inputs give the same
//   bits).  Loads: a 3-stage ring of (128 x 32) A tiles and (32 x BN) x
//   tiles, all by 16-byte cp.async with zero fill past the edges (the
//   wrapper pads x's rows to a multiple of 4 floats where F is not one:
//   at F = 1,433 a 16 MB copy), rows padded in shared memory so that the
//   fragment reads are free of bank conflicts; 90 KB a block at BN = 64,
//   122 KB at 128.
//   The split is integer work of the same order as the products, so it
//   is done once a step for the block and not in each warp's fragments
//   (where each element would be split twice).
//
// * block_spmm_fma — the first design, on the CUDA cores, for the other
//   shapes (the 16 x 16 and 32 x 32 blocks): one block of 128 threads per
//   (row tile, TM rows of it, TN = 64 columns of F), looping over the NB
//   slots with its own cols[i, j], the (TM, TK) piece of the block
//   (transposed) and (TK, TN) rows of x staged in at most 12.8 KB of
//   static shared memory, each thread keeping a (TM / 8) x 4 tile of FP32
//   FMA sums in registers.  TM is 32, or 16 when that gives too few
//   blocks to fill the SMs or when bm is 16.  Loads are scalar and
//   masked, so any shape works.
//
// Plain C interface: device pointers and a cudaStream_t passed as void*;
// launches on that stream, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// block_spmm_fma
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// block_spmm_tc
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;             // rows of the row tile per block
constexpr int TC_BK = 32;              // slice of bn per pipeline step
constexpr int TC_STAGES = 3;
constexpr int A_LD = TC_BK + 4;        // 36: fragment reads hit 32 banks
constexpr int A_STAGE = TC_BM * A_LD;  // floats

// A block covers BN columns of F (64 or 128) with 2 x BN / 32 warps of
// 64 x 32 each; x tiles are (TC_BK, BN), rows padded to BN + 8 floats.
template <int BN>
struct Tc {
  static constexpr int WN = BN / 32;               // warps along F
  static constexpr int THREADS = 2 * WN * 32;      // and 2 along rows
  static constexpr int X_LD = BN + 8;              // 72 or 136
  static constexpr int X_STAGE = TC_BK * X_LD;
  // the ring of A and x tiles, then x_lo of the current step
  static constexpr int SMEM = (TC_STAGES * (A_STAGE + X_STAGE) + X_STAGE) * 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Round the float with bits b to TF32, nearest even on the 13 low bits.
__device__ __forceinline__ uint32_t tf32_rn(uint32_t b) {
  return (b + 0xFFFu + ((b >> 13) & 1u)) & 0xFFFFE000u;
}

// |v| >= 2^127, inf or NaN: the values split_tf32 treats apart.
__device__ __forceinline__ bool tf32_edge(uint32_t b) {
  return (b & 0x7F000000u) == 0x7F000000u;
}

// v -> (hi, lo, hi with non-finite values set to 0); see the header.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo, uint32_t& fin) {
  const uint32_t b = __float_as_uint(v);
  const bool finite = (b & 0x7F800000u) != 0x7F800000u;
  uint32_t r = tf32_rn(b);
  // a carry into the exponent would make hi inf: truncate both terms there
  // instead, so that hi + lo stays at or below |v|
  const bool carry = (r & 0x7F800000u) == 0x7F800000u;
  if (carry) r = b & 0xFFFFE000u;
  const uint32_t rest = __float_as_uint(v - __uint_as_float(r));   // exact
  const uint32_t nonfin = (b & 0x007FFFFFu) ? 0x7FC00000u : b;
  hi = finite ? r : nonfin;
  fin = finite ? r : 0u;
  lo = !finite ? 0u : carry ? rest & 0xFFFFE000u : tf32_rn(rest);
}

// split_tf32's (hi, lo) of a value that is not tf32_edge: the same bits.
__device__ __forceinline__ float split_fast(float v, float& lo) {
  const float hi = __uint_as_float(tf32_rn(__float_as_uint(v)));
  lo = __uint_as_float(tf32_rn(__float_as_uint(v - hi)));
  return hi;
}

__device__ __forceinline__ float split_any(float v, float& lo) {
  uint32_t hi, l, fin;
  split_tf32(v, hi, l, fin);
  lo = __uint_as_float(l);
  return __uint_as_float(hi);
}

// A float that TF32 holds exactly, finite: its hi is itself and its lo 0.
__device__ __forceinline__ bool tf32_exact(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x1FFFu) == 0u && (b & 0x7F800000u) != 0x7F800000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid: x = (row tile, 128-row block) * fz + F tile (F tiles of one row
// block are neighbours, so they share its A tiles in L2), y = slot split.
// x is (x_rows, ldx) with ldx >= f a multiple of 4 and x 16-byte aligned
// (the wrapper pads F where it must); out_split is the stride between the
// splits' partials (0 when one split writes out itself).
//
// A step: wait for its stage, start the load of the stage STAGES - 1
// ahead, then split the (32, BN) x tile once for the block (hi in place,
// lo beside it) while checking whether every A entry of the stage is
// exact in TF32 (__syncthreads_and); then each warp runs its 4 x 4
// m16n8k8 tiles for each k8: two products (A x_lo, A x_hi) from raw A
// where the stage is exact, else A's fragments split and the A_lo
// product added where a warp's fragment has a non-zero A_lo.
template <int BN>
__global__ void __launch_bounds__(Tc<BN>::THREADS, BN == 64 ? 2 : 1)
spmm_tc_kernel(const int* __restrict__ cols,
               const float* __restrict__ blocks,
               const float* __restrict__ x, int nb, int bm, int bn,
               long long x_rows, int f, int ldx, int per,
               float* __restrict__ out, long long out_split) {
  using C = Tc<BN>;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                          // [STAGES][TC_BM][A_LD]
  float* x_s = smem + TC_STAGES * A_STAGE;    // [STAGES][TC_BK][X_LD]
  float* xl_s = x_s + TC_STAGES * C::X_STAGE; // [TC_BK][X_LD]

  const int fz = (f + BN - 1) / BN;
  const int rblocks = (bm + TC_BM - 1) / TC_BM;
  const long long unit = blockIdx.x / fz;
  const int f0 = (int)(blockIdx.x % fz) * BN;
  const long long tile = unit / rblocks;
  const int r0 = (int)(unit % rblocks) * TC_BM;
  const int j0 = blockIdx.y * per;
  const int j1 = min(nb, j0 + per);
  const int kchunks = bn / TC_BK;
  const int steps = (j1 - j0) * kchunks;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, t = lane & 3;

  auto load = [&](int step) {
    const int st = step % TC_STAGES;
    const long long slot = tile * nb + j0 + step / kchunks;
    const int k0 = (step % kchunks) * TC_BK;
    const float* a = blocks + slot * bm * (long long)bn + k0;
    float* as = a_s + st * A_STAGE;
#pragma unroll
    for (int i = 0; i < TC_BM * TC_BK / 4 / C::THREADS; ++i) {
      const int c = tid + i * C::THREADS;
      const int row = c / (TC_BK / 4), q = c % (TC_BK / 4) * 4;
      const bool ok = r0 + row < bm;
      cp_async16(as + row * A_LD + q,
                 ok ? a + (long long)(r0 + row) * bn + q : blocks, ok);
    }
    const long long xr0 = (long long)__ldg(cols + slot) * bn + k0;
    float* xs = x_s + st * C::X_STAGE;
#pragma unroll
    for (int i = 0; i < TC_BK * BN / 4 / C::THREADS; ++i) {
      const int c = tid + i * C::THREADS;
      const int kk = c / (BN / 4), q = c % (BN / 4) * 4;
      const bool ok = xr0 + kk < x_rows && f0 + q < f;
      cp_async16(xs + kk * C::X_LD + q,
                 ok ? x + (xr0 + kk) * ldx + f0 + q : x, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // stage `step` landed; stage step - 1 and xl_s free
    if (step + TC_STAGES - 1 < steps) load(step + TC_STAGES - 1);
    cp_async_commit();

    const float* as_stage = a_s + (step % TC_STAGES) * A_STAGE;
    float* xs_stage = x_s + (step % TC_STAGES) * C::X_STAGE;
    // split x once for the block; check A's exactness
#pragma unroll
    for (int i = 0; i < TC_BK * BN / 4 / C::THREADS; ++i) {
      const int c = tid + i * C::THREADS;
      const int off = c / (BN / 4) * C::X_LD + c % (BN / 4) * 4;
      float4 v = *reinterpret_cast<const float4*>(xs_stage + off);
      float4 lo;
      if (tf32_edge(__float_as_uint(v.x)) | tf32_edge(__float_as_uint(v.y)) |
          tf32_edge(__float_as_uint(v.z)) | tf32_edge(__float_as_uint(v.w))) {
        v.x = split_any(v.x, lo.x); v.y = split_any(v.y, lo.y);
        v.z = split_any(v.z, lo.z); v.w = split_any(v.w, lo.w);
      } else {
        v.x = split_fast(v.x, lo.x); v.y = split_fast(v.y, lo.y);
        v.z = split_fast(v.z, lo.z); v.w = split_fast(v.w, lo.w);
      }
      *reinterpret_cast<float4*>(xs_stage + off) = v;
      *reinterpret_cast<float4*>(xl_s + off) = lo;
    }
    bool exact = true;
#pragma unroll
    for (int i = 0; i < TC_BM * TC_BK / 4 / C::THREADS; ++i) {
      const int c = tid + i * C::THREADS;
      const float4 v = *reinterpret_cast<const float4*>(
          as_stage + c / (TC_BK / 4) * A_LD + c % (TC_BK / 4) * 4);
      exact &= tf32_exact(v.x) & tf32_exact(v.y) & tf32_exact(v.z) &
               tf32_exact(v.w);
    }
    exact = __syncthreads_and(exact);

    const float* as = as_stage + (wm * 64 + g) * A_LD + t;
    const float* xh = xs_stage + t * C::X_LD + wn * 32 + g;
    const float* xl = xl_s + t * C::X_LD + wn * 32 + g;
#pragma unroll
    for (int ks = 0; ks < TC_BK / 8; ++ks) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (ks * 8 + 4 * h) * C::X_LD + nt * 8;
          bh[nt][h] = __float_as_uint(xh[o]);
          bl[nt][h] = __float_as_uint(xl[o]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* ap = as + mt * 16 * A_LD + ks * 8;
        const float av[4] = {ap[0], ap[8 * A_LD], ap[4], ap[8 * A_LD + 4]};
        if (exact) {       // the stage's A is its own hi, its lo is 0
          const uint32_t a[4] = {__float_as_uint(av[0]),
                                 __float_as_uint(av[1]),
                                 __float_as_uint(av[2]),
                                 __float_as_uint(av[3])};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32(acc[mt][nt], a, bl[nt][0], bl[nt][1]);
            mma_tf32(acc[mt][nt], a, bh[nt][0], bh[nt][1]);
          }
          continue;
        }
        uint32_t ah[4], al[4], af[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(av[e], ah[e], al[e], af[e]);
        // the small products first, then the large one; x_hi with its
        // non-finite values set to 0 for A_lo
        if (__any_sync(0xFFFFFFFFu, (al[0] | al[1] | al[2] | al[3]) != 0u)) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            uint32_t bf[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              bf[h] = (bh[nt][h] & 0x7F800000u) == 0x7F800000u ? 0u
                                                               : bh[nt][h];
            mma_tf32(acc[mt][nt], al, bf[0], bf[1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], af, bl[nt][0], bl[nt][1]);
          mma_tf32(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* o = out + blockIdx.y * out_split + tile * bm * (long long)f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm * 64 + mt * 16 + g + 8 * h;
      if (row >= bm) continue;
      float* orow = o + (long long)row * f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = f0 + wn * 32 + nt * 8 + 2 * t;
        if (col < f) orow[col] = acc[mt][nt][2 * h];
        if (col + 1 < f) orow[col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

// out = sum over the splits' partials in split order; n4 float4s each.
__global__ void spmm_reduce_kernel(const float4* __restrict__ part,
                                   long long n4, int splits,
                                   float4* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 s = part[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = part[k * n4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    out[i] = s;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int BN>
cudaError_t launch_tc(const int* cols, const float* blocks, const float* x,
                      long long r, int nb, int bm, int bn, long long x_rows,
                      int f, int ldx, int per, float* dst,
                      long long dst_split, int splits, cudaStream_t s) {
  using C = Tc<BN>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        spmm_tc_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err == cudaSuccess)   // as much shared memory as the SM has
      err = cudaFuncSetAttribute(
          spmm_tc_kernel<BN>, cudaFuncAttributePreferredSharedMemoryCarveout,
          100);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long units = r * ((bm + TC_BM - 1) / TC_BM) * ((f + BN - 1) / BN);
  dim3 grid((unsigned)units, (unsigned)splits);
  spmm_tc_kernel<BN><<<grid, C::THREADS, C::SMEM, s>>>(
      cols, blocks, x, nb, bm, bn, x_rows, f, ldx, per, dst, dst_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" int block_spmm_fma(const int* cols, const float* blocks,
                              const float* x, long long r, int nb, int bm,
                              int bn, long long x_rows, int f, float* out,
                              void* stream) {
  const int sms = sm_count();
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

// F tiles of 64 columns for F <= 64, else 128 (`cols_per_block`, which the
// wrapper's split plan reads too); splits = ceil(nb / per) slot ranges;
// with more than one, `part` holds (splits, R * bm, F) float32 partials
// and a second launch sums them into out (R * bm * F is a multiple of 4:
// bm is a multiple of 16).
extern "C" int block_spmm_tc(const int* cols, const float* blocks,
                             const float* x, long long r, int nb, int bm,
                             int bn, long long x_rows, int f, int ldx,
                             int per, float* part, float* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (nb + per - 1) / per;
  const long long n_out = r * bm * (long long)f;
  float* dst = splits > 1 ? part : out;
  const long long dst_split = splits > 1 ? n_out : 0;
  cudaError_t err =
      f <= 64 ? launch_tc<64>(cols, blocks, x, r, nb, bm, bn, x_rows, f, ldx,
                              per, dst, dst_split, splits, s)
              : launch_tc<128>(cols, blocks, x, r, nb, bm, bn, x_rows, f,
                               ldx, per, dst, dst_split, splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n4 = n_out / 4;
  long long nblk = (n4 + 255) / 256;
  if (nblk > 8LL * sm_count()) nblk = 8LL * sm_count();
  spmm_reduce_kernel<<<(unsigned)nblk, 256, 0, s>>>(
      reinterpret_cast<const float4*>(part), n4, splits,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
