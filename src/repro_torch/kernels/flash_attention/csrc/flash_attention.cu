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
//   Design (simple first; wgmma, TMA and warp specialisation are later
//   work): the rows of a block are the (position, head) pairs of one
//   (batch, kv head): row r is position r / G of query head hk·G + r % G,
//   G = H / HK.  A block of 256 threads (16 x 16) owns BQ = 16·RM such
//   rows (RM = 4 rows a thread, or RM = 1 when a (batch, kv head) has at
//   most 16 rows, as in decode, where G query heads share each k and v
//   tile) and walks the kv tiles of BK = 64 keys in order, up to kv_len
//   and, when causal, up to its last row's position (tiles wholly above
//   the diagonal would add exp(-1e30 - m) = 0).  q, k (both transposed)
//   and v tiles are staged in dynamic shared memory as float32 (16-byte
//   global loads); each thread computes a RM x 4 block of scores with
//   FMAs, the 16 threads of a row reduce its max and sum by shuffles, the
//   probabilities go through shared memory, and each thread keeps a
//   RM x D/16 block of the float32 accumulator in registers.  Blocks take
//   the last (longest, under a causal mask) row tiles first.
//
// Plain C interface: device pointers and a cudaStream_t passed as void*;
// launches on that stream, does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
template <>
struct Ld<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void get(const __nv_bfloat16* p, float (&o)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);     // round to nearest even, as torch's cast
  }
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

template <typename T>
int launch_hd(const Params& p, int hd, long long b, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_rm<T, 16>(p, b, s);
    case 32: return launch_rm<T, 32>(p, b, s);
    case 64: return launch_rm<T, 64>(p, b, s);
    case 128: return launch_rm<T, 128>(p, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike); strides in
// elements; hd one of 16, 32, 64, 128; 1 <= kv_len <= t.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int hd, long long b, long long s, int h, int hk, long long t,
    long long kv_len, int causal, float scale, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  if (h <= 0 || hk <= 0 || h % hk) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, s, t, kv_len, h, hk, causal, scale,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(p, hd, b, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(p, hd, b, st);
  return (int)cudaErrorInvalidValue;
}
