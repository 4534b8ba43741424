// Blocked online-softmax attention for Hopper (sm_90a).
//
// flash_attention — replaces
//   repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
//   (the Pallas kernel whose grid (b·h, q block, kv block) keeps a
//   (bq, d) query tile in VMEM, walks the kv blocks in grid order and
//   carries the running max, denominator and float32 accumulator in VMEM
//   scratch; masked scores are -1e30, the kv tail past kv_len is masked,
//   the causal mask is kj <= qi, and the output divides by max(l, 1e-30)).
//
//   q    (B, S, H, D) and out (B, S, H, D), k and v (B, T, HK, D), each
//        given by its strides (the last dimension contiguous), float32 or
//        bfloat16.  HK divides H: query head h reads kv head h / (H / HK)
//        itself, so grouped-query attention makes no repeated copy of k
//        and v.  The (BH, S, D) layout of the Pallas kernel is B = BH,
//        H = HK = 1.
//   out[b, i, h] = softmax_j(q[b, i, h] · k[b, j, h / G] * scale) · v over
//   the keys j < kv_len (and j <= i when causal), in float32, rounded once
//   to the output's type.
//
//   Bound: the larger of the operations, 4 · B · H · D per (query, key)
//   pair that the mask keeps, against 989 TFLOP/s (bf16 dense on the
//   tensor cores), and the bytes of q, k, v and out against 3.35 TB/s.
//   Prefill at S = T = 32,768 is bound by operations; decode (S = 1
//   against a long cache) by the bytes of k and v.
//
//   The rows of a (batch, kv head) are its (position, head) pairs: row r
//   is position r / G of query head hk·G + r % G, G = H / HK, so one k
//   and v tile serves all G query heads of its kv head.  Three designs:
//
//   flash_kernel (float32, any row count): 256 threads (16 x 16) own
//   16·RM rows (RM = 4, or 1 for at most 16 rows) and walk the kv tiles
//   of 64 keys in order, up to kv_len and, when causal, up to the last
//   row's position; q, k and v are staged in shared memory as float32,
//   scores and the product with v are FMAs, the probabilities go through
//   shared memory, and each thread keeps RM x D/16 of the float32
//   accumulator in registers.
//
//   prefill_kernel (bfloat16, more than 16 rows): the tensor cores.  A
//   block of three consumer warpgroups (two at D = 128, for registers),
//   64 rows each, and a producer warpgroup (one thread issues the loads,
//   the rest of its registers go to the consumers by setmaxnreg) walks the
//   kv tiles of 64 keys.
//   The producer keeps a ring of three k and v tiles in flight by TMA
//   (tensor maps built in the entry point from the strides, swizzled as
//   wgmma reads them), completed on mbarriers; each consumer takes
//   S = Q·K^T by wgmma (bf16 operands from shared memory, float32 sums: q
//   and k are bf16, so each product is exact), masks, scales and takes the
//   online softmax of its rows in registers, and adds P·V by wgmma with P
//   from registers.  P enters as two bf16 terms, p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi), two products on the same v tile: about 16 bits
//   of p are kept, where bf16(p) alone would miss the plain version's
//   2^-7 tolerance at long rows.  The denominator takes the unrounded
//   float32 p.  A warpgroup takes tile i's scores while tile i - 1's
//   product with v runs, and releases a tile with one arrival.  Tiles
//   wholly above a warpgroup's diagonal are skipped; blocks take the
//   longest row tiles first.
//
//   decode_kernel + combine_kernel (bfloat16, at most 16 rows, as at a
//   decode step): split-KV.  The keys up to kv_len are cut into chunks
//   of `chunk`; a block of four warps takes one (batch, kv head, chunk)
//   and streams its k and v tiles (bf16, 64 keys) through a four-stage
//   cp.async ring.  Each warp takes 16 keys of every tile for all the
//   rows with FMAs (decode does ~1.5 operations a byte) and keeps its own
//   online softmax; the warps merge in order at the end.  With one chunk
//   the block writes the output; otherwise it writes its float32
//   (m, l, acc) to scratch and combine_kernel merges a row's chunks in
//   chunk order (no atomics: the same result every run).  Asked for a
//   partial result (split-KV across ranks), the block always writes the
//   scratch and combine_kernel writes each row in float32 with its
//   log-sum-exp; merge_kernel then merges R ranks' partials.
//
// Plain C interface: device pointers and a cudaStream_t passed as void*;
// launches on that stream, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).  The tensor maps
// come from the driver's cuTensorMapEncodeTiled, found through
// cudaGetDriverEntryPoint (the library links no libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // 16 row groups x 16 column groups
constexpr int BK = 64;              // keys per kv tile, 4 a thread
constexpr float NEG = -1e30f;       // the Pallas kernel's masked score

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long s, t, kv_len;
  int h, hk, causal;
  float scale;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  float* lse;       // (B, H, S) float32 log-sum-exp of the scaled scores,
                    // natural log, or null (serving writes none)
};

// 16-byte global loads of VEC elements, widened to float32.
template <typename T>
struct Ld;
template <>
struct Ld<float> {
  static constexpr int VEC = 4;
  __device__ static void get(const float* p, float (&o)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ static void put(float* p, float x) { *p = x; }
};

// N consecutive floats of shared memory (16-, 8- or 4-byte aligned).
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = x.x; o[4 * i + 1] = x.y; o[4 * i + 2] = x.z;
      o[4 * i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int HD, int RM>
constexpr int smem_floats() {
  return HD * (16 * RM + 4) + HD * (BK + 4) + BK * HD + BK * (16 * RM + 4);
}

template <typename T, int HD, int RM>
__global__ void __launch_bounds__(THREADS)
flash_kernel(Params p) {
  constexpr int BQ = 16 * RM;
  constexpr int QS = BQ + 4;        // row strides keep float4 alignment
  constexpr int KS = BK + 4;
  constexpr int DC = HD / 16;       // output columns a thread
  constexpr int VEC = Ld<T>::VEC;
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // qs[d][row]
  float* ks = qs + HD * QS;                          // ks[d][key]
  float* vs = ks + HD * KS;                          // vs[key][d]
  float* ps = vs + BK * HD;                          // ps[key][row]

  const int g = p.h / p.hk;
  const long long rows = p.s * g;
  const long long b = blockIdx.x / p.hk;
  const int hk = (int)(blockIdx.x % p.hk);
  const long long r0 = (long long)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // the block's query rows, zero past the last
  for (int e = t; e < BQ * HD / VEC; e += THREADS) {
    const int rr = e / (HD / VEC);
    const int d0 = (e % (HD / VEC)) * VEC;
    const long long r = r0 + rr;
    float x[VEC];
    if (r < rows) {
      const long long pos = r / g;
      const int head = hk * g + (int)(r % g);
      Ld<T>::get(q + b * p.q_sb + pos * p.q_ss + head * p.q_sh + d0, x);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) qs[(d0 + i) * QS + rr] = x[i];
  }

  long long kv_end = p.kv_len;
  if (p.causal) {
    const long long last = (r0 + BQ - 1 < rows ? r0 + BQ - 1 : rows - 1) / g;
    if (last + 1 < kv_end) kv_end = last + 1;
  }
  long long pos_r[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) pos_r[r] = (r0 + ty * RM + r) / g;

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (long long k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int e = t; e < BK * HD / VEC; e += THREADS) {
      const int jj = e / (HD / VEC);
      const int d0 = (e % (HD / VEC)) * VEC;
      const long long j = k0 + jj;
      float xk[VEC], xv[VEC];
      if (j < p.t) {
        Ld<T>::get(k + b * p.k_sb + j * p.k_st + hk * p.k_sh + d0, xk);
        Ld<T>::get(v + b * p.v_sb + j * p.v_st + hk * p.v_sh + d0, xv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) xk[i] = xv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ks[(d0 + i) * KS + jj] = xk[i];
        vs[jj * HD + d0 + i] = xv[i];
      }
    }
    __syncthreads();

    float sc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[RM], kk[4];
      lds<RM>(qs + d * QS + ty * RM, a);
      lds<4>(ks + d * KS + tx * 4, kk);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(a[r], kk[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long j = k0 + tx * 4 + c;
        const bool ok = j < p.kv_len && (!p.causal || j <= pos_r[r]);
        sc[r][c] = ok ? sc[r][c] * p.scale : NEG;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(sc[r][c] - m_new);
        sum += e;
        ps[(tx * 4 + c) * QS + ty * RM + r] = e;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float pr[RM], vv[DC];
      lds<RM>(ps + j * QS + ty * RM, pr);
      lds<DC>(vs + j * HD + tx * DC, vv);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const long long row = r0 + ty * RM + r;
    if (row >= rows) continue;
    const int head = hk * g + (int)(row % g);
    T* o = out + b * p.o_sb + (row / g) * p.o_ss + head * p.o_sh + tx * DC;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) Ld<T>::put(o + c, acc[r][c] / den);
    if (p.lse != nullptr && tx == 0)
      p.lse[(b * p.h + head) * p.s + row / g] = m[r] + logf(den);
  }
}

template <typename T, int HD, int RM>
int launch(const Params& p, long long b, cudaStream_t s) {
  constexpr int BQ = 16 * RM;
  const size_t bytes = sizeof(float) * smem_floats<HD, RM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD, RM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.s * (p.h / p.hk) + BQ - 1) / BQ;
  if (tiles > 65535 || b * p.hk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * p.hk), (unsigned)tiles);
  flash_kernel<T, HD, RM><<<grid, THREADS, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_rm(const Params& p, long long b, cudaStream_t s) {
  if (p.s * (p.h / p.hk) <= 16) return launch<T, HD, 1>(p, b, s);
  return launch<T, HD, 4>(p, b, s);
}


// --------------------------------------------------------------------------
// PTX helpers: shared-memory addresses, mbarriers, TMA, cp.async, wgmma
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed; a wait of
// more than ~2^34 cycles (seconds) traps, so a lost arrival fails the
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1LL << 34)) __trap();
  }
}

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared; zeros where !ok (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 2^x by the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, which a row's sum of at least 1 cannot see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle (1: 128 B, 2: 64 B,
// 3: 32 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// The byte offset `o` of a tile whose rows are SW bytes, after the swizzle
// that TMA's CU_TENSOR_MAP_SWIZZLE_{32,64,128}B applies and wgmma reads:
// the 16-byte chunk index is XORed with address bits 7 and up.
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t o) {
  return o ^ (((o >> 7) & (SW / 16 - 1)) << 4);
}

// D (64 x N, float32, in the accumulator layout) (+)= A · B with A (64 x
// 16) and B (16 x N) both K-major in shared memory; scale_d = 0 overwrites
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

// D (64 x N) += A · B with A (64 x 16 bf16) from registers (the
// accumulator layout of a 64 x 16 tile, two bf16 a register) and B (16 x
// N) N-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --------------------------------------------------------------------------
// prefill_kernel: bfloat16, wgmma and TMA
// --------------------------------------------------------------------------

namespace pf {

constexpr int BM = 64;                    // rows a consumer warpgroup
constexpr int BN = 64;                    // keys a kv tile
constexpr int STAGES = 3;                 // kv tiles in the ring

// Shared-memory tiles are TMA's boxes: rows of SW bytes (one swizzle
// span), so D = 128 takes two column atoms of 64 values, stored one after
// the other.
template <int HD>
struct Tile {
  // consumer warpgroups a block (three, or two where D = 128 needs the
  // registers), and the threads with the producer warpgroup, which gives
  // its registers up to the consumers (setmaxnreg)
  static constexpr int NC = HD < 128 ? 3 : 2;
  static constexpr int THREADS = NC * 128 + 128;
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int ATOM = SW / 2;             // values a row of an atom
  static constexpr int ATOMS = HD / ATOM;
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int SMEM =
      1024 + NC * Q_BYTES + 2 * STAGES * KV_BYTES + 2 * STAGES * 8;
};

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::THREADS, 1)
prefill_kernel(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, Params p) {
  using TL = Tile<HD>;
  constexpr int SW = TL::SW;
  constexpr int NC = TL::NC;
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t q_s = (raw + 1023) & ~1023u;      // swizzle atoms: 1 KB
  const uint32_t k_s = q_s + NC * TL::Q_BYTES;
  const uint32_t v_s = k_s + STAGES * TL::KV_BYTES;
  const uint32_t full = v_s + STAGES * TL::KV_BYTES;   // STAGES mbarriers
  const uint32_t empty = full + STAGES * 8;            // STAGES mbarriers

  const int g = p.h / p.hk;
  const long long rows = p.s * g;
  const int b = (int)(blockIdx.x / p.hk);
  const int hk = (int)(blockIdx.x % p.hk);
  const long long r0 = (long long)(gridDim.y - 1 - blockIdx.y) * (NC * BM);
  long long kv_end = p.kv_len;
  if (p.causal) {
    const long long last = (r0 + NC * BM < rows ? r0 + NC * BM : rows) - 1;
    if (last / g + 1 < kv_end) kv_end = last / g + 1;
  }
  const int n_tiles = (int)((kv_end + BN - 1) / BN);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NC);      // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC * 4) {                   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == NC * 4 && lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * TL::KV_BYTES);
        for (int a = 0; a < TL::ATOMS; ++a) {
          const uint32_t off = s * TL::KV_BYTES + a * BN * SW;
          tma_load4(k_s + off, &tk, a * TL::ATOM, i * BN, hk, b, full + 8 * s);
          tma_load4(v_s + off, &tv, a * TL::ATOM, i * BN, hk, b, full + 8 * s);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows rw0 .. rw0 + 63.  65,536 registers over
  // the block's threads at launch (128 each with three consumers, 168 with
  // two); the producer's 24 leave the consumers 160 or 232.
  if constexpr (NC == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const long long rw0 = r0 + wg * BM;
  const uint32_t qw = q_s + wg * TL::Q_BYTES;
  const bf16* q = static_cast<const bf16*>(p.q);
  for (int e = tid; e < BM * HD / 8; e += 128) {
    const int rr = e / (HD / 8);
    const int c = e % (HD / 8);           // 16-byte chunk of the row
    const long long r = rw0 + rr;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < rows) {
      const long long pos = r / g;
      const int head = hk * g + (int)(r % g);
      x = *reinterpret_cast<const uint4*>(
          q + (long long)b * p.q_sb + pos * p.q_ss + head * p.q_sh + c * 8);
    }
    const uint32_t o = (c / (TL::ATOM / 8)) * (BM * SW) + rr * SW +
                       (c % (TL::ATOM / 8)) * 16;
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(qw + swizzle<SW>(o)), "r"(x.x), "r"(x.y), "r"(x.z),
                    "r"(x.w) : "memory");
  }
  // the q tile is read by wgmma (the async proxy): fence, then wait for
  // the warpgroup's 128 threads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

  // this thread's two rows of the accumulator layout
  const long long ra = rw0 + 16 * (warp % 4) + lane / 4;
  const long long rb = ra + 8;
  const long long pos_a = ra / g;
  const long long pos_b = rb / g;
  const int col = 2 * (lane % 4);
  int wg_tiles = 0;                     // kv tiles this warpgroup needs
  if (rw0 < rows) {
    long long wg_end = p.kv_len;
    const long long last = (rw0 + BM < rows ? rw0 + BM : rows) - 1;
    if (p.causal && last / g + 1 < wg_end) wg_end = last / g + 1;
    wg_tiles = (int)((wg_end + BN - 1) / BN);
  }
  const long long first_pos = rw0 / g;
  const float scale = p.scale * LOG2E;  // scores in log2 units: exp2

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float sc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  uint32_t hi[BN / 16][4], lo[BN / 16][4];
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float corr_a = 1.f, corr_b = 1.f;

  // S = Q K^T of tile i, K-major operands, 16 of D a step (issued, not
  // waited for)
  auto qk = [&](int i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t kt = k_s + s * TL::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t qo = (kk * 16 / TL::ATOM) * (BM * SW) +
                          (kk * 16 % TL::ATOM) * 2;
      const uint32_t ko = (kk * 16 / TL::ATOM) * (BN * SW) +
                          (kk * 16 % TL::ATOM) * 2;
      wgmma_ss<BN>(sc, smem_desc(qw + qo, 16, 8 * SW, TL::LAYOUT),
                   smem_desc(kt + ko, 16, 8 * SW, TL::LAYOUT), kk > 0);
    }
    wgmma_commit();
  };
  // O += P_hi V + P_lo V of tile i, V N-major, 16 keys a step (issued)
  auto pv = [&](int i) {
    const uint32_t vt = v_s + (i % STAGES) * TL::KV_BYTES;
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const uint64_t dv = smem_desc(vt + c * 16 * SW, BN * SW, 8 * SW,
                                    TL::LAYOUT);
      wgmma_rs<HD>(o, hi[c], dv);
      wgmma_rs<HD>(o, lo[c], dv);
    }
    wgmma_commit();
  };
  // tile i's scores -> float32 p in sc, the row maxima, the correction of
  // the earlier tiles and l (this thread's share of each row)
  auto softmax = [&](int i) {
    const long long k0 = (long long)i * BN;
    const bool whole = k0 + BN <= p.kv_len &&
                       (!p.causal || k0 + BN - 1 <= first_pos);
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];          // scaled below, by fmaf
        if (!whole) {
          const long long key = k0 + 8 * j + col + (e & 1);
          const long long pos = e < 2 ? pos_a : pos_b;
          if (key >= p.kv_len || (p.causal && key > pos)) x = NEG;
        }
        sc[4 * j + e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a * scale);   // scale > 0
    const float mn_b = fmaxf(m_b, mx_b * scale);
    corr_a = ex2(m_a - mn_a);
    corr_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale, -mn_a));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale, -mn_a));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale, -mn_b));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale, -mn_b));
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
  };
  // p -> p_hi + p_lo (bf16, the A operand of pv), and O *= the correction
  auto split = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const __nv_bfloat162 h01 =
          __floats2bfloat162_rn(sc[4 * j], sc[4 * j + 1]);
      const __nv_bfloat162 h23 =
          __floats2bfloat162_rn(sc[4 * j + 2], sc[4 * j + 3]);
      const float2 f01 = __bfloat1622float2(h01);
      const float2 f23 = __bfloat1622float2(h23);
      const __nv_bfloat162 l01 =
          __floats2bfloat162_rn(sc[4 * j] - f01.x, sc[4 * j + 1] - f01.y);
      const __nv_bfloat162 l23 =
          __floats2bfloat162_rn(sc[4 * j + 2] - f23.x, sc[4 * j + 3] - f23.y);
      // keys 8j .. 8j + 7 are half (j % 2) of the k16 step j / 2
      hi[j / 2][2 * (j % 2)] = *reinterpret_cast<const uint32_t*>(&h01);
      hi[j / 2][2 * (j % 2) + 1] = *reinterpret_cast<const uint32_t*>(&h23);
      lo[j / 2][2 * (j % 2)] = *reinterpret_cast<const uint32_t*>(&l01);
      lo[j / 2][2 * (j % 2) + 1] = *reinterpret_cast<const uint32_t*>(&l23);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr_a;
      o[4 * j + 1] *= corr_a;
      o[4 * j + 2] *= corr_b;
      o[4 * j + 3] *= corr_b;
    }
  };
  auto release = [&](int i) {           // the warpgroup is done with tile i
    if (tid == 0) mbar_arrive(empty + 8 * (i % STAGES));
  };

  // tile i's scores are taken while tile i - 1's product with v runs
  if (wg_tiles > 0) {
    wgmma_fence();
    qk(0);
    wgmma_wait<0>();
    softmax(0);
    split();
    for (int i = 1; i < wg_tiles; ++i) {
      wgmma_fence();
      qk(i);
      pv(i - 1);
      wgmma_wait<1>();                  // qk(i) is done
      softmax(i);
      wgmma_wait<0>();                  // pv(i - 1) is done
      release(i - 1);
      split();
    }
    wgmma_fence();
    pv(wg_tiles - 1);
    wgmma_wait<0>();
    release(wg_tiles - 1);
  }
  for (int i = wg_tiles; i < n_tiles; ++i) {  // tiles past this diagonal
    mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
    release(i);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = half ? rb : ra;
    if (r >= rows) continue;
    const float den = half ? den_b : den_a;
    const int head = hk * g + (int)(r % g);
    if (p.lse != nullptr && col == 0)   // scores in log2 units here
      p.lse[((long long)b * p.h + head) * p.s + r / g] =
          ((half ? m_b : m_a) + log2f(den)) * 0.6931471805599453f;
    bf16* dst = out + (long long)b * p.o_sb + (r / g) * p.o_ss +
                head * p.o_sh + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] / den,
                                o[4 * j + 2 * half + 1] / den);
  }
}

}  // namespace pf

// --------------------------------------------------------------------------
// decode_kernel and combine_kernel: bfloat16, split-KV
// --------------------------------------------------------------------------

namespace dec {

constexpr int ROWS = 16;                  // rows a (batch, kv head), at most
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 64;                    // keys a kv tile, 16 a warp
constexpr int STAGES = 4;                 // kv tiles in the cp.async ring

template <int HD>
struct Tile {
  static constexpr int R = HD + 8;        // padded bf16 row: no bank clash
  static constexpr int RING = 2 * STAGES * BK * R * 2;
  static constexpr int SMEM = RING + ROWS * HD * 4;
};

// A block takes one (batch, kv head, chunk) and RM >= S·G rows.  Each
// warp takes 16 keys of every tile for all rows and keeps its own online
// softmax state (lane l dots key l % 16 over half of D, then owns D/32
// output columns); the four warps' states merge at the end in warp order.
template <int HD, int RM>
__global__ void __launch_bounds__(THREADS)
decode_kernel(Params p, long long chunk, float* part) {
  constexpr int R = Tile<HD>::R;
  constexpr int CPR = HD / 8;             // 16-byte chunks a row
  constexpr int HALF = HD / 2;            // values a lane dots
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;   // output columns a lane
  extern __shared__ float4 smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);    // [STAGES][BK][R]
  bf16* vs = ks + STAGES * BK * R;                  // [STAGES][BK][R]
  float* qs = reinterpret_cast<float*>(vs + STAGES * BK * R);  // [RM][HD]

  const int g = p.h / p.hk;
  const int rows = (int)(p.s * g);
  const long long b = blockIdx.x / p.hk;
  const int hk = (int)(blockIdx.x % p.hk);
  const int t = threadIdx.x;
  const int w = t / 32;
  const int lane = t % 32;
  long long kv_end = p.kv_len;
  if (p.causal && p.s < kv_end) kv_end = p.s;
  const long long c0 = (long long)blockIdx.y * chunk;
  const long long c1 = c0 + chunk < kv_end ? c0 + chunk : kv_end;
  const int n_tiles = (int)((c1 - c0 + BK - 1) / BK);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int e = t; e < RM * HD; e += THREADS) {
    const int r = e / HD;
    float x = 0.f;
    if (r < rows)
      x = __bfloat162float(q[b * p.q_sb + (r / g) * p.q_ss +
                             (hk * g + r % g) * p.q_sh + e % HD]);
    qs[e] = x;
  }

  auto issue = [&](int i) {         // tile i of the chunk into its stage
    if (i < n_tiles) {
      const int s = i % STAGES;
      const long long k0 = c0 + (long long)i * BK;
      for (int e = t; e < 2 * BK * CPR; e += THREADS) {
        const int kv = e / (BK * CPR);
        const int jj = (e % (BK * CPR)) / CPR;
        const int cc = e % CPR;
        const long long j = k0 + jj;
        const bool ok = j < p.t;
        const bf16* src = kv ? v + (ok ? j : 0) * p.v_st
                             : k + (ok ? j : 0) * p.k_st;
        bf16* dst = (kv ? vs : ks) + (s * BK + jj) * R;
        cp_async16(smem_u32(dst + cc * 8), src + cc * 8, ok);
      }
    }
    cp_async_commit();              // an empty group past the last tile
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  const int kl = 16 * w + lane % 16;      // this lane's key in a tile
  const int dh = (lane / 16) * HALF;      // and the half of D it dots
  const int d0 = (lane * DPL) % HD;       // its output columns
  const float scale = p.scale * LOG2E;
  long long pos[RM];
  float m[RM], l[RM], acc[RM][DPL];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    pos[r] = r / g;
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();    // tile i has landed (this thread's part)
    __syncthreads();                // ... everyone's; tile i - 1 consumed
    issue(i + STAGES - 1);
    const int s = i % STAGES;
    const long long j = c0 + (long long)i * BK + kl;
    const bf16* kr = ks + (s * BK + kl) * R + dh;
    const bf16* vt = vs + (s * BK + 16 * w) * R + d0;

    float sc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) sc[r] = 0.f;
#pragma unroll
    for (int d = 0; d < HALF; d += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(kr + d);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
      float kf[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(h[u]);
        kf[2 * u] = f.x;
        kf[2 * u + 1] = f.y;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 qa =
            *reinterpret_cast<const float4*>(qs + r * HD + dh + d);
        const float4 qb =
            *reinterpret_cast<const float4*>(qs + r * HD + dh + d + 4);
        float a = sc[r];
        a = fmaf(qa.x, kf[0], a);
        a = fmaf(qa.y, kf[1], a);
        a = fmaf(qa.z, kf[2], a);
        a = fmaf(qa.w, kf[3], a);
        a = fmaf(qb.x, kf[4], a);
        a = fmaf(qb.y, kf[5], a);
        a = fmaf(qb.z, kf[6], a);
        sc[r] = fmaf(qb.w, kf[7], a);
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const float full = sc[r] + __shfl_xor_sync(0xffffffffu, sc[r], 16);
      const bool ok = j < p.kv_len && (!p.causal || j <= pos[r]);
      const float x = ok ? full * scale : NEG;
      float mx = x;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      const float pr = exp2f(x - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      sc[r] = pr;
    }

#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      float vf[DPL];
      if constexpr (DPL == 1) {
        vf[0] = __bfloat162float(vt[jj * R]);
      } else {
#pragma unroll
        for (int c = 0; c < DPL; c += 2) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vt + jj * R + c));
          vf[c] = f.x;
          vf[c + 1] = f.y;
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float pj = __shfl_sync(0xffffffffu, sc[r], jj);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vf[c], acc[r][c]);
      }
    }
  }

  // the warps' states, through the ring's memory, merged in warp order
  cp_async_wait<0>();
  __syncthreads();
  float* ws = reinterpret_cast<float*>(smem_raw);  // [WARPS][RM][HD + 2]
  if (lane * DPL < HD) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float* wr = ws + (w * RM + r) * (HD + 2);
      if (lane == 0) {
        wr[0] = m[r];
        wr[1] = l[r];
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c) wr[2 + d0 + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int e = t; e < rows * HD; e += THREADS) {
    const int r = e / HD;
    const int d = e % HD;
    float mg = NEG;
#pragma unroll
    for (int u = 0; u < WARPS; ++u)
      mg = fmaxf(mg, ws[(u * RM + r) * (HD + 2)]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) {
      const float* wr = ws + (u * RM + r) * (HD + 2);
      const float f = exp2f(wr[0] - mg);
      sum = fmaf(wr[1], f, sum);
      o = fmaf(wr[2 + d], f, o);
    }
    if (part == nullptr) {          // one chunk: the output itself
      static_cast<bf16*>(p.out)[b * p.o_sb + (r / g) * p.o_ss +
                                (hk * g + r % g) * p.o_sh + d] =
          __float2bfloat16(o / fmaxf(sum, 1e-30f));
    } else {                        // (m, l, acc[HD]) of (block, chunk, row)
      float* pw = part + (((long long)blockIdx.x * gridDim.y + blockIdx.y) *
                              rows + r) * (HD + 2);
      pw[2 + d] = o;
      if (d == 0) {
        pw[0] = mg;
        pw[1] = sum;
      }
    }
  }
}

// out[row] = Σ_c acc_c · 2^(m_c - M) / max(Σ_c l_c · 2^(m_c - M), 1e-30),
// M = max_c m_c, summed in chunk order.  With `o32` the row is written
// unrounded there instead ((B, S, H, D) float32, contiguous), and its
// natural-log log-sum-exp (M + log2 Σ_c l_c · 2^(m_c - M)) · ln 2 into
// p.lse ((B, H, S)): a rank's partial result for merge_kernel.
__global__ void __launch_bounds__(256)
combine_kernel(const float* part, int n_chunks, int hd, Params p,
               float* o32) {
  const int g = p.h / p.hk;
  const int rows = (int)(p.s * g);
  const long long b = blockIdx.x / p.hk;
  const int hk = (int)(blockIdx.x % p.hk);
  const long long per = (long long)rows * (hd + 2);     // a chunk's floats
  const float* base = part + (long long)blockIdx.x * n_chunks * per;
  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int r = e / hd;
    const int d = e % hd;
    const float* w = base + (long long)r * (hd + 2);
    float mg = NEG;
    for (int c = 0; c < n_chunks; ++c) mg = fmaxf(mg, w[c * per]);
    float l = 0.f, o = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float f = exp2f(w[c * per] - mg);
      l = fmaf(w[c * per + 1], f, l);
      o = fmaf(w[c * per + 2 + d], f, o);
    }
    const long long pos = r / g;
    const int head = hk * g + r % g;
    if (o32 == nullptr) {
      static_cast<bf16*>(p.out)[b * p.o_sb + pos * p.o_ss + head * p.o_sh +
                                d] = __float2bfloat16(o / fmaxf(l, 1e-30f));
    } else {
      o32[((b * p.s + pos) * p.h + head) * hd + d] = o / fmaxf(l, 1e-30f);
      if (d == 0)
        p.lse[(b * p.h + head) * p.s + pos] =
            (mg + log2f(l)) * 0.6931471805599453f;
    }
  }
}

// merge_kernel — R ranks' partial attention of the same rows, each over
// its own slice of the keys, merged (split-KV across ranks).  Replaces no
// TPU kernel: the reference lets GSPMD split the softmax's max and sum
// over a sequence-sharded cache (repro/models/lm/transformer.py's
// decode_attention); this is its merge step.
//   o (R, N, D) float32, lse (R, N) float32 (natural log; -inf for a rank
//   that kept no key) → out (N, D) in T:
//   out[n] = Σ_r o[r, n] · e^(lse[r, n] - M) / Σ_r e^(lse[r, n] - M),
//   M = max_r lse[r, n], summed in rank order, rounded once to T.  With
//   R = 1 the weight is e^0 = 1 and the row is o itself.
//   One thread an output value: the R weights of its row come from lse,
//   which the row's D threads share through the L1.
//   Bound: bytes, (R·N·D + R·N) · 4 read and N·D·sizeof(T) written.
template <typename T>
__global__ void __launch_bounds__(256)
merge_kernel(const float* o, const float* lse, T* out, int n_ranks,
             long long n, int hd) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * hd) return;
  const long long row = e / hd;
  const float neg_inf = -__int_as_float(0x7f800000);
  float mg = neg_inf;
  for (int r = 0; r < n_ranks; ++r) mg = fmaxf(mg, lse[r * n + row]);
  float l = 0.f, acc = 0.f;
  if (mg != neg_inf) {
    for (int r = 0; r < n_ranks; ++r) {
      const float w = expf(lse[r * n + row] - mg);
      l += w;
      acc = fmaf(w, o[r * n * hd + e], acc);
    }
  }
  const float x = l > 0.f ? acc / l : 0.f;
  if constexpr (sizeof(T) == 2)
    out[e] = __float2bfloat16(x);
  else
    out[e] = x;
}

}  // namespace dec


// --------------------------------------------------------------------------
// the backward: dot_kernel, then kv_kernel and q_kernel (route "fma",
// float32) or kv_mma_kernel and q_mma_kernel (route "mma", bfloat16)
//
// It replaces no TPU kernel: the reference trains through XLA's gradient
// of train_4k's full_attention (repro/models/lm/transformer.py:175).
// dQ, dK, dV of causal (S == T) or unmasked attention with GQA, P
// recomputed from the forward's float32 LSE: D = rowsum(dO ∘ O), P =
// exp(S·scale - lse), dS = P ∘ (dP - D), dV = Pᵀ·dO, dK = scale·dSᵀ·Q,
// dQ = scale·dS·K.  Two passes and no atomics (the same bits every call:
// training's resume check needs them): kv blocks own a tile of keys and
// walk all G heads' rows; q blocks own a tile of rows and walk the keys.
//
// Bound: operations.  Five products of 2·D operations a kept (row, key)
// pair, against 989 TFLOP/s bf16 on the tensor cores; the bytes (q, k, v,
// out, dout read and dq, dk, dv written once) are ~1 % of that at S 4,096.
//
// Route "fma" (float32): 256 threads over float32 shared-memory tiles,
// every product an FMA on the CUDA cores (67 TFLOP/s at best).
//
// Route "mma" (bfloat16): the products on the tensor cores by
// mma.sync.m16n8k16 (bf16 operands, float32 sums), as FlashAttention-2's
// backward shapes them.  Four warps a block; tiles stay bf16 in shared
// memory (rows padded by 16 bytes, so each ldmatrix row falls on its own
// banks), the next tile comes in by cp.async into a two-stage ring while
// the present one is used.  kv_mma_kernel: warp w holds 16 keys and takes
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (64 rows a tile, 32 at D = 128), Pᵀ and dSᵀ in
// float32 registers, then dV += Pᵀ·dO and dK += dSᵀ·Q with the accumulator
// fragments of Pᵀ and dSᵀ reused as the A operand in registers.
// q_mma_kernel: warp w holds 16 rows, S = Q·Kᵀ and dP = dO·Vᵀ over 64-key
// tiles, dQ += dS·K.  Masks are applied only on tiles that cross the
// causal diagonal or a ragged edge.
//
// Precision: q, k, v and dO are bf16 inputs, so S and dP are exact
// products summed in float32.  P and dS are never fed to a product as
// one bf16 term: each is split into hi = bf16(x) and lo = bf16(x - hi),
// and each of dV, dK and dQ takes two products, hi and lo, summed in
// float32 (bf16(P) or bf16(dS) alone misses the tolerance below:
// tests/test_torch_train_gpu.py).  dQ, dK, dV are rounded once to bf16 at
// the end.  Tolerance against the plain float32 gradient: 2^-7·|plain| +
// 1e-4·max|plain|.
// --------------------------------------------------------------------------

namespace bwd {

constexpr int THREADS = 256;              // 16 row groups x 16 column groups
constexpr int BK = 64;                    // keys a tile

template <int HD>
struct Cfg {
  static constexpr int BQ = HD == 128 ? 32 : 64;   // rows a tile
  static constexpr int RM = BQ / 16;      // rows a thread in S and dP
  static constexpr int DC = HD / 16;      // columns a thread in dK, dV, dQ
  static constexpr int QS = BQ + 4;       // padded strides: float4 rows
  static constexpr int KS = BK + 4;
  static constexpr int HS = HD + 4;
  // kv_kernel: kT, vT [HD][KS]; qT, doT [HD][QS]; q, dO [BQ][HS];
  // P, dS [BQ][KS]; lse, D [BQ]
  static constexpr int KV_FLOATS =
      2 * HD * KS + 2 * HD * QS + 2 * BQ * HS + 2 * BQ * KS + 2 * BQ;
  // q_kernel: qT, doT [HD][QS]; kT, vT [HD][KS]; k [BK][HS]; dS^T [BK][QS];
  // lse, D [BQ]
  static constexpr int Q_FLOATS =
      2 * HD * QS + 2 * HD * KS + BK * HS + BK * QS + 2 * BQ;
};

// every tensor contiguous: q, o, dout, dq (B, S, H, HD); k, v, dk, dv
// (B, T, HK, HD); lse and dd (B, H, S) float32
struct BParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* dd;
  void* dq;
  void* dk;
  void* dv;
  long long s, t;
  int h, hk, causal;
  float scale;
};

__device__ __forceinline__ float wid(float x) { return x; }
__device__ __forceinline__ float wid(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// 16 bytes of T widened to float32
template <typename T>
struct V16;
template <>
struct V16<float> {
  static constexpr int N = 4;
  __device__ static void get(const float* p, float (&o)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};

// D = rowsum(dO ∘ O): one warp a (batch, position, head) row, its lanes'
// products summed by a fixed shuffle tree
template <typename T, int HD>
__global__ void __launch_bounds__(256) dot_kernel(BParams p, long long b) {
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= b * p.s * p.h) return;       // the whole warp
  const T* o = static_cast<const T*>(p.o) + row * HD;
  const T* d = static_cast<const T*>(p.dout) + row * HD;
  float acc = 0.f;
  for (int c = lane; c < HD; c += 32) acc = fmaf(wid(o[c]), wid(d[c]), acc);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, x);
  const long long head = row % p.h;
  const long long bp = row / p.h;         // batch · S + position
  if (lane == 0)
    p.dd[((bp / p.s) * p.h + head) * p.s + bp % p.s] = acc;
}

// S and dP of a (BQ rows, BK keys) tile from the transposed q, dO, k and
// v tiles: thread (ty, tx) takes rows ty·RM .. + RM and keys tx·4 .. + 4
template <int HD, int RM, int QS, int KS>
__device__ __forceinline__ void scores(const float* qT, const float* doT,
                                       const float* kT, const float* vT,
                                       int tx, int ty, float (&sc)[RM][4],
                                       float (&dp)[RM][4]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RM], da[RM], kk[4], vv[4];
    lds<RM>(qT + d * QS + ty * RM, a);
    lds<RM>(doT + d * QS + ty * RM, da);
    lds<4>(kT + d * KS + tx * 4, kk);
    lds<4>(vT + d * KS + tx * 4, vv);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[r][c] = fmaf(a[r], kk[c], sc[r][c]);
        dp[r][c] = fmaf(da[r], vv[c], dp[r][c]);
      }
  }
}

// rows r0 .. r0 + BQ of (batch b, kv head hk) into transposed (and, with
// q_r / do_r, row-major) float32 tiles, zeros past the last row, and
// their lse and D
template <typename T, int HD, int BQ, int QS, int HS>
__device__ __forceinline__ void stage_rows(const BParams& p, long long b,
                                           int hk, long long r0, float* qT,
                                           float* doT, float* q_r,
                                           float* do_r, float* lse_s,
                                           float* dd_s) {
  constexpr int VEC = V16<T>::N;
  const int g = p.h / p.hk;
  const long long rows = p.s * g;
  for (int e = threadIdx.x; e < BQ * HD / VEC; e += THREADS) {
    const int rr = e / (HD / VEC);
    const int d0 = (e % (HD / VEC)) * VEC;
    const long long r = r0 + rr;
    float xq[VEC], xd[VEC];
    if (r < rows) {
      const long long off =
          ((b * p.s + r / g) * p.h + hk * g + r % g) * HD + d0;
      V16<T>::get(static_cast<const T*>(p.q) + off, xq);
      V16<T>::get(static_cast<const T*>(p.dout) + off, xd);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) xq[i] = xd[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qT[(d0 + i) * QS + rr] = xq[i];
      doT[(d0 + i) * QS + rr] = xd[i];
      if (q_r != nullptr) {
        q_r[rr * HS + d0 + i] = xq[i];
        do_r[rr * HS + d0 + i] = xd[i];
      }
    }
  }
  for (int rr = threadIdx.x; rr < BQ; rr += THREADS) {
    const long long r = r0 + rr;
    float ls = 0.f, dd = 0.f;
    if (r < rows) {
      const long long li = (b * p.h + hk * g + r % g) * p.s + r / g;
      ls = p.lse[li];
      dd = p.dd[li];
    }
    lse_s[rr] = ls;
    dd_s[rr] = dd;
  }
}

// keys j0 .. j0 + BK of (batch b, kv head hk) into transposed float32 k and
// v tiles (and, with k_r, a row-major k tile), zeros past T
template <typename T, int HD, int KS, int HS>
__device__ __forceinline__ void stage_keys(const BParams& p, long long b,
                                           int hk, long long j0, float* kT,
                                           float* vT, float* k_r) {
  constexpr int VEC = V16<T>::N;
  for (int e = threadIdx.x; e < BK * HD / VEC; e += THREADS) {
    const int jj = e / (HD / VEC);
    const int d0 = (e % (HD / VEC)) * VEC;
    const long long j = j0 + jj;
    float xk[VEC], xv[VEC];
    if (j < p.t) {
      const long long off = ((b * p.t + j) * p.hk + hk) * HD + d0;
      V16<T>::get(static_cast<const T*>(p.k) + off, xk);
      V16<T>::get(static_cast<const T*>(p.v) + off, xv);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) xk[i] = xv[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      kT[(d0 + i) * KS + jj] = xk[i];
      vT[(d0 + i) * KS + jj] = xv[i];
      if (k_r != nullptr) k_r[jj * HS + d0 + i] = xk[i];
    }
  }
}

// dK and dV of BK keys of one (batch, kv head): the rows of all G query
// heads of the group, tile by tile (causal: from the first row whose
// position reaches the tile), P = exp(S·scale - lse) and dS = P ∘ (dP -
// D) through shared memory, dV += P^T dO and dK += dS^T Q in registers
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) kv_kernel(BParams p) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, RM = C::RM, DC = C::DC;
  constexpr int QS = C::QS, KS = C::KS, HS = C::HS;
  extern __shared__ float4 smem_raw[];
  float* kT = reinterpret_cast<float*>(smem_raw);
  float* vT = kT + HD * KS;
  float* qT = vT + HD * KS;
  float* doT = qT + HD * QS;
  float* q_r = doT + HD * QS;
  float* do_r = q_r + BQ * HS;
  float* ps = do_r + BQ * HS;
  float* dss = ps + BQ * KS;
  float* lse_s = dss + BQ * KS;
  float* dd_s = lse_s + BQ;

  const int g = p.h / p.hk;
  const long long rows = p.s * g;
  const long long b = blockIdx.x / p.hk;
  const int hk = (int)(blockIdx.x % p.hk);
  const long long j0 = (long long)blockIdx.y * BK;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  stage_keys<T, HD, KS, HS>(p, b, hk, j0, kT, vT, nullptr);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[kk][c] = dv[kk][c] = 0.f;

  const long long r_begin = p.causal ? j0 * g / BQ * BQ : 0;
  for (long long r0 = r_begin; r0 < rows; r0 += BQ) {
    __syncthreads();                // the previous tile is consumed
    stage_rows<T, HD, BQ, QS, HS>(p, b, hk, r0, qT, doT, q_r, do_r, lse_s,
                                  dd_s);
    __syncthreads();
    float sc[RM][4], dp[RM][4];
    scores<HD, RM, QS, KS>(qT, doT, kT, vT, tx, ty, sc, dp);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int rr = ty * RM + r;
      const long long row = r0 + rr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long j = j0 + tx * 4 + c;
        const bool ok = row < rows && j < p.t && (!p.causal || j <= row / g);
        const float pr = ok ? expf(fmaf(sc[r][c], p.scale, -lse_s[rr])) : 0.f;
        ps[rr * KS + tx * 4 + c] = pr;
        dss[rr * KS + tx * 4 + c] = pr * (dp[r][c] - dd_s[rr]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float pv[4], dsv[4], dov[DC], qv[DC];
      lds<4>(ps + i * KS + ty * 4, pv);
      lds<4>(dss + i * KS + ty * 4, dsv);
      lds<DC>(do_r + i * HS + tx * DC, dov);
      lds<DC>(q_r + i * HS + tx * DC, qv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[kk][c] = fmaf(pv[kk], dov[c], dv[kk][c]);
          dk[kk][c] = fmaf(dsv[kk], qv[c], dk[kk][c]);
        }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const long long j = j0 + ty * 4 + kk;
    if (j >= p.t) continue;
    const long long off = ((b * p.t + j) * p.hk + hk) * HD + tx * DC;
    T* dkp = static_cast<T*>(p.dk) + off;
    T* dvp = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      put(dkp + c, dk[kk][c] * p.scale);
      put(dvp + c, dv[kk][c]);
    }
  }
}

// dQ of BQ rows of one (batch, kv head) (the forward's rows: position
// r / G of head hk·G + r % G), over the key tiles up to the last row's
// position when causal: dQ += dS K in registers, dS^T through shared
// memory
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) q_kernel(BParams p) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, RM = C::RM, DC = C::DC;
  constexpr int QS = C::QS, KS = C::KS, HS = C::HS;
  extern __shared__ float4 smem_raw[];
  float* qT = reinterpret_cast<float*>(smem_raw);
  float* doT = qT + HD * QS;
  float* kT = doT + HD * QS;
  float* vT = kT + HD * KS;
  float* k_r = vT + HD * KS;
  float* dsT = k_r + BK * HS;
  float* lse_s = dsT + BK * QS;
  float* dd_s = lse_s + BQ;

  const int g = p.h / p.hk;
  const long long rows = p.s * g;
  const long long b = blockIdx.x / p.hk;
  const int hk = (int)(blockIdx.x % p.hk);
  const long long r0 = (long long)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  stage_rows<T, HD, BQ, QS, HS>(p, b, hk, r0, qT, doT, nullptr, nullptr,
                                lse_s, dd_s);
  long long kv_end = p.t;
  if (p.causal) {
    const long long last = (r0 + BQ < rows ? r0 + BQ : rows) - 1;
    if (last / g + 1 < kv_end) kv_end = last / g + 1;
  }
  float dq[RM][DC];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[r][c] = 0.f;

  for (long long j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();                // the previous tile is consumed
    stage_keys<T, HD, KS, HS>(p, b, hk, j0, kT, vT, k_r);
    __syncthreads();
    float sc[RM][4], dp[RM][4];
    scores<HD, RM, QS, KS>(qT, doT, kT, vT, tx, ty, sc, dp);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int rr = ty * RM + r;
      const long long row = r0 + rr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long j = j0 + tx * 4 + c;
        const bool ok = row < rows && j < p.t && (!p.causal || j <= row / g);
        const float pr = ok ? expf(fmaf(sc[r][c], p.scale, -lse_s[rr])) : 0.f;
        dsT[(tx * 4 + c) * QS + rr] = pr * (dp[r][c] - dd_s[rr]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[RM], kv[DC];
      lds<RM>(dsT + j * QS + ty * RM, dsv);
      lds<DC>(k_r + j * HS + tx * DC, kv);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[r][c] = fmaf(dsv[r], kv[c], dq[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const long long row = r0 + ty * RM + r;
    if (row >= rows) continue;
    T* dqp = static_cast<T*>(p.dq) +
             ((b * p.s + row / g) * p.h + hk * g + row % g) * HD + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) put(dqp + c, dq[r][c] * p.scale);
  }
}

// ---- route "mma": bfloat16 on the tensor cores --------------------------

constexpr int MMA_THREADS = 128;          // 4 warps
constexpr int MBK = 64;                   // keys a tile: 16 a warp in kv
constexpr int QBQ = 64;                   // q_mma: rows a block, 16 a warp

template <int HD>
struct MCfg {
  static constexpr int BQ = HD == 128 ? 32 : 64;   // kv_mma: rows a tile
  // bf16 row stride of every tile: 16 bytes of padding put the 8 rows an
  // ldmatrix reads on distinct banks
  static constexpr int LD = HD + 8;
  // kv_mma: K, V [MBK][LD]; two stages of Q, dO [BQ][LD] and lse, D [BQ]
  static constexpr int KV_BYTES = 2 * MBK * LD * 2 + 2 * (2 * BQ * LD * 2 +
                                                          2 * BQ * 4);
  // q_mma: Q, dO [QBQ][LD], lse, D [QBQ]; two stages of K, V [MBK][LD]
  static constexpr int Q_BYTES = 2 * QBQ * LD * 2 + 2 * QBQ * 4 +
                                 2 * 2 * MBK * LD * 2;
};

// 4 bytes global -> shared; zero where !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// c += a (16 x 16, row) · b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two bf16x2 terms: hi = bf16(x, y), lo = bf16(x - hi.x, y - hi.y)
// (x - hi.x is exact in float32); the lower column in the low half
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the A operand (16 x 16, k = 16 columns) of two accumulator tiles
// (16 x 8 each: columns 0-7 and 8-15), as hi and lo terms: FlashAttention-
// 2's reuse of an accumulator fragment as the next product's operand
__device__ __forceinline__ void a_split(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// rows r0 .. r0 + n of (batch b, kv head hk) of q and dO into bf16 tiles
// [n][LD] and their lse and D, by cp.async, zeros past the last row
template <int HD>
__device__ __forceinline__ void stage_rows_mma(const BParams& p, long long b,
                                               int hk, long long r0, int n,
                                               bf16* qs, bf16* dos,
                                               float* lse_s, float* dd_s) {
  constexpr int LD = MCfg<HD>::LD;
  const int g = p.h / p.hk;
  const long long rows = p.s * g;
  for (int e = threadIdx.x; e < n * HD / 8; e += MMA_THREADS) {
    const int rr = e / (HD / 8);
    const int c = (e % (HD / 8)) * 8;
    const long long r = r0 + rr;
    const bool ok = r < rows;
    const long long rc = ok ? r : 0;
    const long long off = ((b * p.s + rc / g) * p.h + hk * g + rc % g) * HD
                          + c;
    cp_async16(smem_u32(qs + rr * LD + c),
               static_cast<const bf16*>(p.q) + off, ok);
    cp_async16(smem_u32(dos + rr * LD + c),
               static_cast<const bf16*>(p.dout) + off, ok);
  }
  for (int rr = threadIdx.x; rr < n; rr += MMA_THREADS) {
    const long long r = r0 + rr;
    const bool ok = r < rows;
    const long long rc = ok ? r : 0;
    const long long li = (b * p.h + hk * g + rc % g) * p.s + rc / g;
    cp_async4(smem_u32(lse_s + rr), p.lse + li, ok);
    cp_async4(smem_u32(dd_s + rr), p.dd + li, ok);
  }
}

// keys j0 .. j0 + MBK of (batch b, kv head hk) of k and v into bf16 tiles
// [MBK][LD] by cp.async, zeros past T
template <int HD>
__device__ __forceinline__ void stage_keys_mma(const BParams& p, long long b,
                                               int hk, long long j0, bf16* ks,
                                               bf16* vs) {
  constexpr int LD = MCfg<HD>::LD;
  for (int e = threadIdx.x; e < MBK * HD / 8; e += MMA_THREADS) {
    const int jj = e / (HD / 8);
    const int c = (e % (HD / 8)) * 8;
    const long long j = j0 + jj;
    const bool ok = j < p.t;
    const long long off = ((b * p.t + (ok ? j : 0)) * p.hk + hk) * HD + c;
    cp_async16(smem_u32(ks + jj * LD + c),
               static_cast<const bf16*>(p.k) + off, ok);
    cp_async16(smem_u32(vs + jj * LD + c),
               static_cast<const bf16*>(p.v) + off, ok);
  }
}

// does a (rows r0 .. r0 + nr, keys j0 .. j0 + MBK) tile need its mask:
// a ragged edge, or causal with a key past the tile's first position
__device__ __forceinline__ bool needs_mask(const BParams& p, long long r0,
                                           int nr, long long j0) {
  const long long rows = p.s * (p.h / p.hk);
  return r0 + nr > rows || j0 + MBK > p.t ||
         (p.causal && j0 + MBK - 1 > r0 / (p.h / p.hk));
}

// is (row, key j) kept
__device__ __forceinline__ bool kept(const BParams& p, long long row,
                                     long long j) {
  const int g = p.h / p.hk;
  return row < p.s * g && j < p.t && (!p.causal || j <= row / g);
}

// dK and dV of MBK keys of one (batch, kv head): warp w takes keys
// 16w .. 16w + 16 and walks the row tiles of all G query heads of the
// group (causal: from the first row whose position reaches the tile), the
// next tile's Q and dO loading into the other stage meanwhile.  Per tile:
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, Pᵀ = exp(Sᵀ·scale - lse) and dSᵀ = Pᵀ ∘ (dPᵀ
// - D) in registers, dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ as hi +
// lo bf16 terms.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS) kv_mma_kernel(BParams p) {
  using C = MCfg<HD>;
  constexpr int BQ = C::BQ, LD = C::LD;
  constexpr int NT = BQ / 8;              // row n-tiles of Sᵀ
  constexpr int DT = HD / 8;              // d n-tiles of dK, dV
  extern __shared__ float4 smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + MBK * LD;
  bf16* qs = vs + MBK * LD;               // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;           // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);   // [2][BQ]
  float* dd_s = lse_s + 2 * BQ;                                 // [2][BQ]

  const int g = p.h / p.hk;
  const long long rows = p.s * g;
  const long long b = blockIdx.x / p.hk;
  const int hk = (int)(blockIdx.x % p.hk);
  const long long j0 = (long long)blockIdx.y * MBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp * 16;               // the warp's first key in the tile
  const long long r_begin = p.causal ? j0 * g / BQ * BQ : 0;
  const int tiles = (int)((rows - r_begin + BQ - 1) / BQ);

  stage_keys_mma<HD>(p, b, hk, j0, ks, vs);
  stage_rows_mma<HD>(p, b, hk, r_begin, BQ, qs, dos, lse_s, dd_s);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[t][c] = dv[t][c] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const long long r0 = r_begin + (long long)it * BQ;
    const int buf = it & 1;
    if (it + 1 < tiles)
      stage_rows_mma<HD>(p, b, hk, r0 + BQ, BQ, qs + (buf ^ 1) * BQ * LD,
                         dos + (buf ^ 1) * BQ * LD, lse_s + (buf ^ 1) * BQ,
                         dd_s + (buf ^ 1) * BQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qs + buf * BQ * LD;
    const bf16* dt = dos + buf * BQ * LD;
    const float* ls = lse_s + buf * BQ;
    const float* ds = dd_s + buf * BQ;

    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int ao = (kw + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldsm4(ka, ks + ao);
      ldsm4(va, vs + ao);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t qb[4], ob[4];
        const int bo = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm4(qb, qt + bo);
        ldsm4(ob, dt + bo);
        mma16816(st[2 * np], ka, qb[0], qb[1]);
        mma16816(st[2 * np + 1], ka, qb[2], qb[3]);
        mma16816(dpt[2 * np], va, ob[0], ob[1]);
        mma16816(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }
    // Pᵀ and dSᵀ: element c of n-tile n is key kw + lane/4 (+ 8 for c >= 2)
    // and row n·8 + 2(lane % 4) + c % 2
    const bool edge = needs_mask(p, r0, BQ, j0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int rr = n * 8 + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(ls + rr);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + rr);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pr = expf(fmaf(st[n][c], p.scale, -(c & 1 ? l2.y : l2.x)));
        if (edge && !kept(p, r0 + rr + (c & 1),
                          j0 + kw + (lane >> 2) + (c >> 1) * 8))
          pr = 0.f;
        st[n][c] = pr;
        dpt[n][c] = pr * (dpt[n][c] - (c & 1 ? d2.y : d2.x));
      }
    }
    // dV += Pᵀ·dO, dK += dSᵀ·Q: k runs over the tile's rows
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      a_split(st[2 * kk], st[2 * kk + 1], ph, pl);
      a_split(dpt[2 * kk], dpt[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t ob[4], qb[4];
        const int bo = (kk * 16 + (lane & 15)) * LD + dp * 16 +
                       (lane >> 4) * 8;
        ldsm4t(ob, dt + bo);
        ldsm4t(qb, qt + bo);
        mma16816(dv[2 * dp], ph, ob[0], ob[1]);
        mma16816(dv[2 * dp], pl, ob[0], ob[1]);
        mma16816(dv[2 * dp + 1], ph, ob[2], ob[3]);
        mma16816(dv[2 * dp + 1], pl, ob[2], ob[3]);
        mma16816(dk[2 * dp], sh, qb[0], qb[1]);
        mma16816(dk[2 * dp], sl, qb[0], qb[1]);
        mma16816(dk[2 * dp + 1], sh, qb[2], qb[3]);
        mma16816(dk[2 * dp + 1], sl, qb[2], qb[3]);
      }
    }
    __syncthreads();                // the stage is consumed
  }
  // element c of n-tile t: key kw + lane/4 (+ 8 for c >= 2), column
  // t·8 + 2(lane % 4) + c % 2
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long j = j0 + kw + (lane >> 2) + half * 8;
    if (j >= p.t) continue;
    const long long off = ((b * p.t + j) * p.hk + hk) * HD + 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dk) + off +
                                         t * 8) =
          __floats2bfloat162_rn(dk[t][2 * half] * p.scale,
                                dk[t][2 * half + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dv) + off +
                                         t * 8) =
          __floats2bfloat162_rn(dv[t][2 * half], dv[t][2 * half + 1]);
    }
  }
}

// dQ of QBQ rows of one (batch, kv head) (the forward's rows: position
// r / G of head hk·G + r % G): warp w takes rows 16w .. 16w + 16 and walks
// the key tiles up to the last row's position when causal, the next
// tile's K and V loading into the other stage meanwhile.  Per tile: S =
// Q·Kᵀ and dP = dO·Vᵀ, P and dS = P ∘ (dP - D) in registers, dQ += dS·K
// with dS as hi + lo bf16 terms.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS) q_mma_kernel(BParams p) {
  constexpr int LD = MCfg<HD>::LD;
  constexpr int NT = MBK / 8;             // key n-tiles of S
  constexpr int DT = HD / 8;              // d n-tiles of dQ
  extern __shared__ float4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [QBQ][LD]
  bf16* dos = qs + QBQ * LD;
  bf16* ks = dos + QBQ * LD;              // [2][MBK][LD]
  bf16* vs = ks + 2 * MBK * LD;           // [2][MBK][LD]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * MBK * LD);   // [QBQ]
  float* dd_s = lse_s + QBQ;

  const int g = p.h / p.hk;
  const long long rows = p.s * g;
  const long long b = blockIdx.x / p.hk;
  const int hk = (int)(blockIdx.x % p.hk);
  const long long r0 = (long long)(gridDim.y - 1 - blockIdx.y) * QBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp * 16;               // the warp's first row in the tile
  long long kv_end = p.t;
  if (p.causal) {
    const long long last = (r0 + QBQ < rows ? r0 + QBQ : rows) - 1;
    if (last / g + 1 < kv_end) kv_end = last / g + 1;
  }
  const int tiles = (int)((kv_end + MBK - 1) / MBK);

  stage_rows_mma<HD>(p, b, hk, r0, QBQ, qs, dos, lse_s, dd_s);
  stage_keys_mma<HD>(p, b, hk, 0, ks, vs);
  cp_async_commit();

  float dq[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[t][c] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const long long j0 = (long long)it * MBK;
    const int buf = it & 1;
    if (it + 1 < tiles)
      stage_keys_mma<HD>(p, b, hk, j0 + MBK, ks + (buf ^ 1) * MBK * LD,
                         vs + (buf ^ 1) * MBK * LD);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + buf * MBK * LD;
    const bf16* vt = vs + buf * MBK * LD;

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], oa[4];
      const int ao = (rw + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldsm4(qa, qs + ao);
      ldsm4(oa, dos + ao);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4], vb[4];
        const int bo = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm4(kb, kt + bo);
        ldsm4(vb, vt + bo);
        mma16816(sc[2 * np], qa, kb[0], kb[1]);
        mma16816(sc[2 * np + 1], qa, kb[2], kb[3]);
        mma16816(dp[2 * np], oa, vb[0], vb[1]);
        mma16816(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }
    // P and dS: element c of n-tile n is row rw + lane/4 (+ 8 for c >= 2)
    // and key n·8 + 2(lane % 4) + c % 2
    const bool edge = needs_mask(p, r0, QBQ, j0);
    const int ra = rw + (lane >> 2);
    const float la = lse_s[ra], lb = lse_s[ra + 8];
    const float da = dd_s[ra], db = dd_s[ra + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pr = expf(fmaf(sc[n][c], p.scale, -(c >> 1 ? lb : la)));
        if (edge && !kept(p, r0 + ra + (c >> 1) * 8,
                          j0 + n * 8 + 2 * (lane & 3) + (c & 1)))
          pr = 0.f;
        sc[n][c] = pr * (dp[n][c] - (c >> 1 ? db : da));
      }
    // dQ += dS·K: k runs over the tile's keys
#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      a_split(sc[2 * kk], sc[2 * kk + 1], sh, sl);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t kb[4];
        ldsm4t(kb, kt + (kk * 16 + (lane & 15)) * LD + d2 * 16 +
                       (lane >> 4) * 8);
        mma16816(dq[2 * d2], sh, kb[0], kb[1]);
        mma16816(dq[2 * d2], sl, kb[0], kb[1]);
        mma16816(dq[2 * d2 + 1], sh, kb[2], kb[3]);
        mma16816(dq[2 * d2 + 1], sl, kb[2], kb[3]);
      }
    }
    __syncthreads();                // the stage is consumed
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = r0 + rw + (lane >> 2) + half * 8;
    if (row >= rows) continue;
    bf16* dqp = static_cast<bf16*>(p.dq) +
                ((b * p.s + row / g) * p.h + hk * g + row % g) * HD +
                2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dqp + t * 8) =
          __floats2bfloat162_rn(dq[t][2 * half] * p.scale,
                                dq[t][2 * half + 1] * p.scale);
  }
}

template <int HD>
int launch_mma(const BParams& p, long long b, cudaStream_t s) {
  using C = MCfg<HD>;
  const long long rows_all = b * p.s * p.h;
  const long long key_tiles = (p.t + MBK - 1) / MBK;
  const long long row_tiles = (p.s * (p.h / p.hk) + QBQ - 1) / QBQ;
  if (key_tiles > 65535 || row_tiles > 65535 || b * p.hk > 0x7fffffffLL ||
      (rows_all * 32 + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kv_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::KV_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(q_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::Q_BYTES);
  if (err != cudaSuccess) return (int)err;
  dot_kernel<bf16, HD><<<(unsigned)((rows_all * 32 + 255) / 256), 256, 0,
                         s>>>(p, b);
  kv_mma_kernel<HD><<<dim3((unsigned)(b * p.hk), (unsigned)key_tiles),
                      MMA_THREADS, C::KV_BYTES, s>>>(p);
  q_mma_kernel<HD><<<dim3((unsigned)(b * p.hk), (unsigned)row_tiles),
                     MMA_THREADS, C::Q_BYTES, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const BParams& p, long long b, cudaStream_t s) {
  using C = Cfg<HD>;
  const long long rows_all = b * p.s * p.h;
  const long long key_tiles = (p.t + BK - 1) / BK;
  const long long row_tiles = (p.s * (p.h / p.hk) + C::BQ - 1) / C::BQ;
  if (key_tiles > 65535 || row_tiles > 65535 || b * p.hk > 0x7fffffffLL ||
      (rows_all * 32 + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int kv_bytes = (int)sizeof(float) * C::KV_FLOATS;
  const int q_bytes = (int)sizeof(float) * C::Q_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(q_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_bytes);
  if (err != cudaSuccess) return (int)err;
  dot_kernel<T, HD><<<(unsigned)((rows_all * 32 + 255) / 256), 256, 0, s>>>(
      p, b);
  kv_kernel<T, HD><<<dim3((unsigned)(b * p.hk), (unsigned)key_tiles),
                     THREADS, kv_bytes, s>>>(p);
  q_kernel<T, HD><<<dim3((unsigned)(b * p.hk), (unsigned)row_tiles),
                    THREADS, q_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// route 0 ("fma"): float32; route 1 ("mma"): bfloat16
int launch_hd(const BParams& p, int route, int hd, long long b,
              cudaStream_t s) {
  if (route == 0) {
    switch (hd) {
      case 16: return launch<float, 16>(p, b, s);
      case 32: return launch<float, 32>(p, b, s);
      case 64: return launch<float, 64>(p, b, s);
      case 128: return launch<float, 128>(p, b, s);
    }
  } else if (route == 1) {
    switch (hd) {
      case 16: return launch_mma<16>(p, b, s);
      case 32: return launch_mma<32>(p, b, s);
      case 64: return launch_mma<64>(p, b, s);
      case 128: return launch_mma<128>(p, b, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace bwd

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of k or v (B, T, HK, D) from its element strides: boxes
// of (ATOM values, BN keys, 1, 1), swizzled as the wgmma descriptors read
// them, zeros past T.  A dimension of size 1 takes a stride of the span
// below it, whatever its own (TMA wants strides that are multiples of 16
// bytes).
template <int HD>
bool kv_map(CUtensorMap* map, const void* base, long long b, long long t,
            int hk, long long sb, long long st, long long sh) {
  using TL = pf::Tile<HD>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)t, (cuuint64_t)hk,
                              (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                           (cuuint64_t)sb * 2};
  cuuint64_t span = HD * 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = (span + 15) / 16 * 16;
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)TL::ATOM, (cuuint32_t)pf::BN, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = TL::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : TL::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_prefill(const Params& p, long long b, cudaStream_t s) {
  CUtensorMap tk, tv;
  if (!kv_map<HD>(&tk, p.k, b, p.t, p.hk, p.k_sb, p.k_st, p.k_sh) ||
      !kv_map<HD>(&tv, p.v, b, p.t, p.hk, p.v_sb, p.v_st, p.v_sh))
    return (int)cudaErrorInvalidValue;
  const int bytes = pf::Tile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      pf::prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int rows_a_block = pf::Tile<HD>::NC * pf::BM;
  const long long tiles =
      (p.s * (p.h / p.hk) + rows_a_block - 1) / rows_a_block;
  if (tiles > 65535 || b * p.hk > 0x7fffffffLL || b > 0x7fffffffLL ||
      p.t > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * p.hk), (unsigned)tiles);
  pf::prefill_kernel<HD><<<grid, pf::Tile<HD>::THREADS, bytes, s>>>(
      tk, tv, p);
  return (int)cudaGetLastError();
}

template <int HD, int RM>
int launch_decode_rm(const Params& p, long long b, long long n_chunks,
                     long long chunk, void* part, cudaStream_t s) {
  const int bytes = dec::Tile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      dec::decode_kernel<HD, RM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(b * p.hk), (unsigned)n_chunks);
  dec::decode_kernel<HD, RM><<<grid, dec::THREADS, bytes, s>>>(
      p, chunk, static_cast<float*>(part));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_decode(const Params& p, long long b, long long chunk, void* part,
                  cudaStream_t s) {
  long long kv_end = p.kv_len;
  if (p.causal && p.s < kv_end) kv_end = p.s;
  const long long n_chunks = (kv_end + chunk - 1) / chunk;
  if (chunk <= 0 || n_chunks > 65535 || b * p.hk > 0x7fffffffLL ||
      (n_chunks > 1 || p.lse != nullptr) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long rows = p.s * (p.h / p.hk);     // 1 .. dec::ROWS
  if (rows <= 1) return launch_decode_rm<HD, 1>(p, b, n_chunks, chunk, part,
                                                s);
  if (rows <= 2) return launch_decode_rm<HD, 2>(p, b, n_chunks, chunk, part,
                                                s);
  if (rows <= 4) return launch_decode_rm<HD, 4>(p, b, n_chunks, chunk, part,
                                                s);
  if (rows <= 8) return launch_decode_rm<HD, 8>(p, b, n_chunks, chunk, part,
                                                s);
  return launch_decode_rm<HD, 16>(p, b, n_chunks, chunk, part, s);
}

template <int HD>
int launch_bf16(const Params& p, long long b, long long chunk, void* part,
                cudaStream_t s) {
  if (p.s * (p.h / p.hk) <= dec::ROWS)
    return launch_decode<HD>(p, b, chunk, part, s);
  return launch_prefill<HD>(p, b, s);
}

int launch_hd(const Params& p, int dtype, int hd, long long b,
              long long chunk, void* part, cudaStream_t s) {
  if (dtype == 0) {
    switch (hd) {
      case 16: return launch_rm<float, 16>(p, b, s);
      case 32: return launch_rm<float, 32>(p, b, s);
      case 64: return launch_rm<float, 64>(p, b, s);
      case 128: return launch_rm<float, 128>(p, b, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return launch_bf16<16>(p, b, chunk, part, s);
      case 32: return launch_bf16<32>(p, b, chunk, part, s);
      case 64: return launch_bf16<64>(p, b, chunk, part, s);
      case 128: return launch_bf16<128>(p, b, chunk, part, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike); strides in
// elements; hd one of 16, 32, 64, 128; 1 <= kv_len <= t.  A bfloat16 call
// with at most 16 rows a (batch, kv head) (S·H/HK <= 16) takes the split-KV
// route with `chunk` keys a block: with more than one chunk up to kv_len
// (and up to S when causal), `part` is float32 scratch of B·HK·chunks·
// S·(H/HK)·(hd + 2) values that flash_attention_combine then reads;
// otherwise `part` is null and the output is written here.  `lse`
// is null, or (B, H, S) float32 for each row's natural-log log-sum-exp of
// its scaled, masked scores (what the backward recomputes P from).  On
// the split-KV route an `lse` asks for the partial result: `part` is then
// given at any chunk count, and flash_attention_combine writes the float32
// rows and the LSE.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int hd, long long b, long long s, int h, int hk, long long t,
    long long kv_len, int causal, float scale, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long chunk,
    void* part, float* lse, void* stream) {
  if (h <= 0 || hk <= 0 || h % hk) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, s, t, kv_len, h, hk, causal, scale,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           o_sb, o_ss, o_sh, lse};
  return launch_hd(p, dtype, hd, b, chunk, part,
                   static_cast<cudaStream_t>(stream));
}

// The second launch of a split-KV call: merges the n_chunks partial
// results in `part` into out (bfloat16, strides in elements), or with
// `o32` and `lse` both given into the float32 rows o32 ((B, S, H, hd),
// contiguous) and their log-sum-exp lse ((B, H, S)); out is then unused.
extern "C" int flash_attention_combine(
    const void* part, void* out, int hd, long long b, long long s, int h,
    int hk, long long n_chunks, long long o_sb, long long o_ss,
    long long o_sh, float* o32, float* lse, void* stream) {
  if (h <= 0 || hk <= 0 || h % hk || s * (h / hk) > dec::ROWS ||
      n_chunks < 1 || b * hk > 0x7fffffffLL ||
      (o32 == nullptr) != (lse == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{nullptr, nullptr, nullptr, out, s, 0, 0, h, hk, 0, 0.f,
           0, 0, 0, 0, 0, 0, 0, 0, 0, o_sb, o_ss, o_sh, lse};
  dec::combine_kernel<<<(unsigned)(b * hk), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), (int)n_chunks, hd, p, o32);
  return (int)cudaGetLastError();
}

// merge_kernel's launch: o (n_ranks, n, hd) and lse (n_ranks, n) float32,
// contiguous, into out (n, hd) contiguous, dtype 0 float32 or 1 bfloat16.
extern "C" int flash_attention_merge(const float* o, const float* lse,
                                     void* out, int dtype, int n_ranks,
                                     long long n, int hd, void* stream) {
  if (n_ranks < 1 || n < 0 || hd < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long total = n * hd;
  if (total == 0) return 0;
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dec::merge_kernel<bf16><<<(unsigned)blocks, 256, 0, st>>>(
        o, lse, static_cast<bf16*>(out), n_ranks, n, hd);
  else
    dec::merge_kernel<float><<<(unsigned)blocks, 256, 0, st>>>(
        o, lse, static_cast<float*>(out), n_ranks, n, hd);
  return (int)cudaGetLastError();
}

// The gradient of a causal (S == T) or unmasked (kv_len == T) call: dq,
// dk, dv for the upstream dout, from the forward's q, k, v, out and lse.
// Every tensor contiguous and 16-byte aligned, dtype as above (q, k, v,
// out, dout, dq, dk, dv alike); `dd` is (B, H, S) float32 scratch for
// D = rowsum(dout ∘ out).  `route` 0 ("fma") takes float32 only, 1
// ("mma") bfloat16 only; any other pairing is refused.  Three launches on
// the stream: dot_kernel (D), then kv_kernel / kv_mma_kernel (dk, dv: one
// block a (batch, kv head, 64 keys)) and q_kernel / q_mma_kernel (dq: one
// block a (batch, kv head, row tile)).  No atomics: the same bits from
// call to call.
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, int dtype, int route, int hd,
    long long b, long long s, int h, int hk, long long t, int causal,
    float scale, void* dq, void* dk, void* dv, float* dd, void* stream) {
  if (h <= 0 || hk <= 0 || h % hk || b < 1 || s < 1 || t < 1 ||
      (causal && s != t) || s * (h / hk) > 0x7fffffffLL ||
      !((dtype == 0 && route == 0) || (dtype == 1 && route == 1)))
    return (int)cudaErrorInvalidValue;
  bwd::BParams p{q, k, v, out, dout, lse, dd, dq, dk, dv, s, t, h, hk,
                 causal, scale};
  return bwd::launch_hd(p, route, hd, b, static_cast<cudaStream_t>(stream));
}
