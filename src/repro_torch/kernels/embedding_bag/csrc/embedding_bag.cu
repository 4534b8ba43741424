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
//   row form a run in slot order.
//
//   Bound: bytes.  The dense grad write V·D·sizeof(T) (1.64 GB at
//   DeepFM's full table) dominates; the sorted ids, the permutation and
//   the grad_out rows read are small beside it.
//
//   Design (tile_kernel): every row of the gradient is written once, zeros
//   and sums alike.  A tile is R consecutive rows and DT columns, R·DT
//   float32 values in shared memory (ops.backward_plan: R·DT = 8,192 at
//   DeepFM's calls); a block writes GROUP = 4 consecutive tiles:
//   * its first tile's first entry of `sorted` by one warp's 32-way
//     search (one load a lane narrows the range 32-fold), while the other
//     warps zero the tile; each later tile starts where the last ended;
//   * the tile's entries staged in shared memory, ids and slots 2·threads
//     at a time (coalesced loads), counted below the tile's end;
//   * sums: thread (entry, column) at the first entry of a run sums the
//     run in slot order (__fmul_rn, __fadd_rn, as the plain version) into
//     the tile, a run past the stage going on in device memory; the
//     first terms of four entries load together.  No atomics, so the bits
//     are the same from call to call; a hot row only lengthens its
//     threads' chains;
//   * one write: after a barrier the block streams the tile out, 16-byte
//     stores between a scalar head and tail (one run of R·D values where
//     DT == D, else a warp a row), marked evict-first (st.global.cs) so
//     that the 1.64 GB stream does not push the sorted ids, the slots and
//     grad_out out of L2, where the next tiles' loads find them.
//   The design before this one wrote the whole table with zeros first and
//   then each touched row again, a scatter of partial sectors after the
//   zero stream had left L2.

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

constexpr int STAGE = 2;               // sorted entries a thread stages
constexpr int UNROLL = 4;              // run sums a thread starts at once
constexpr int GROUP = 4;               // consecutive tiles a block writes

// VEC float32 values as one 16-byte word of T: a float32 each, or two
// bf16 a word (element 2i in the low half, as in memory), rounded to
// nearest even as store() rounds
__device__ __forceinline__ uint4 pack16(const float* x, float) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack16(const float* x, __nv_bfloat16) {
  return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
                    pack2(x[6], x[7]));
}

// dst[0 .. n) = src[0 .. n) in T, by the nt threads of a group (this one
// t): 16-byte stores between a scalar head and tail
template <typename T>
__device__ void put_run(T* __restrict__ dst, const float* __restrict__ src,
                        long long n, int t, int nt) {
  constexpr int VEC = 16 / sizeof(T);
  long long head = (long long)(((16 - ((uintptr_t)dst & 15)) & 15)
                               / sizeof(T));
  head = head < n ? head : n;
  const long long body = (n - head) / VEC;
  for (long long i = t; i < head; i += nt) store(dst + i, src[i]);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const float* s = src + head;
  if ((uintptr_t)s % 16 == 0) {        // 16-byte shared loads: no conflict
    for (long long i = t; i < body; i += nt) {
      float x[VEC];
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(x + j) =
            *reinterpret_cast<const float4*>(s + i * VEC + j);
      __stcs(d4 + i, pack16(x, T()));
    }
  } else {
    for (long long i = t; i < body; i += nt)
      __stcs(d4 + i, pack16(s + i * VEC, T()));
  }
  for (long long i = head + VEC * body + t; i < n; i += nt)
    store(dst + i, src[i]);
}

// the first q in [0, n) with sorted[q] >= x, else n, by one warp: each
// round probes 32 evenly spaced entries and keeps the part between the
// last below x and the first at or above it
__device__ long long lower_bound_warp(const int* __restrict__ sorted,
                                      long long n, long long x, int lane) {
  long long lo = 0, hi = n;            // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + (lane + 1) * step - 1;
    const bool below = q < hi && sorted[q] < x;
    // sorted: the probes below x are lanes 0 .. c - 1
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c < 32) hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  const long long q = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, q < hi && sorted[q] < x));
}

// grid (ceil(T / GROUP), ceil(D / dt)): block b takes the row tiles
// [b GROUP, (b + 1) GROUP) (T = ceil(V / rows)) of the columns [c0, c0 +
// dt) in order, each as an (nr, nc) float32 tile in shared memory,
// followed by the staged ids and slots (STAGE a thread); blockDim >= dt
// (ops.backward_plan).  Entry q of `sorted` is the one after
// the last tile's: only the block's first tile needs the search.
template <typename T>
__global__ void __launch_bounds__(256)
tile_kernel(const int* __restrict__ sorted, const int* __restrict__ perm,
            const T* __restrict__ gout, const float* __restrict__ w,
            long long n, int k, int d, long long v, int rows, int dt,
            T* __restrict__ gtab) {
  extern __shared__ float tile[];
  __shared__ long long first;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31;
  const int stage = STAGE * nt;
  int* ids_s = reinterpret_cast<int*>(tile + rows * dt);
  int* slot_s = ids_s + stage;
  const long long tiles = (v + rows - 1) / rows;
  const long long ta = (long long)blockIdx.x * GROUP;
  const long long tb = ta + GROUP < tiles ? ta + GROUP : tiles;
  const int c0 = blockIdx.y * dt;
  const int nc = d - c0 < dt ? d - c0 : dt;
  const int per = nt / nc;                       // entries a pass
  const int c = t % nc;
  const bool summing = t < per * nc;
  // a slot's term in column c: its weight times grad_out (rounded)
  auto term = [&](int slot) {
    const float g = widen(gout[(long long)(slot / k) * d + c0 + c]);
    return w ? __fmul_rn(w[slot], g) : g;
  };
  if (t < 32) {                    // while the other warps zero the tile
    const long long at = lower_bound_warp(sorted, n, ta * rows, lane);
    if (lane == 0) first = at;
  }
  long long q = 0;
  for (long long ti = ta; ti < tb; ++ti) {
    const long long r0 = ti * rows, r1 = r0 + rows;
    const int nr = (int)(v - r0 < rows ? v - r0 : rows);
    for (int i = t; i < nr * nc / 4; i += nt)
      reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = nr * nc / 4 * 4 + t; i < nr * nc; i += nt) tile[i] = 0.f;
    if (ti == ta) {
      __syncthreads();
      q = first;
    }
    // the tile's entries, staged `stage` at a time: ids and slots loaded
    // together (coalesced), counted below r1 (they are sorted)
    int last = -1;                               // the id before entry q
    for (;;) {
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < STAGE; ++j) {
        const long long at = q + j * nt + t;
        ids_s[j * nt + t] = at < n ? sorted[at] : 0x7fffffff;
        slot_s[j * nt + t] = at < n ? perm[at] : 0;
      }
#pragma unroll
      for (int j = 0; j < STAGE; ++j)            // barriers, and the count
        cnt += __syncthreads_count(ids_s[j * nt + t] < r1);
      // thread (entry, column) at a run's first entry sums the run in
      // slot order; a run past the stage goes on in device memory.  The
      // first terms of UNROLL entries load together.
      for (int e0 = t / nc; summing && e0 < cnt; e0 += UNROLL * per) {
        float head[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (e0 + u * per < cnt) head[u] = term(slot_s[e0 + u * per]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int e = e0 + u * per;
          if (e >= cnt) break;
          const int id = ids_s[e];
          if ((e ? ids_s[e - 1] : last) == id) continue;
          float acc = __fadd_rn(0.f, head[u]);
          int r = e + 1;
          for (; r < cnt && ids_s[r] == id; ++r)
            acc = __fadd_rn(acc, term(slot_s[r]));
          if (r == stage)
            for (long long a = q + r; a < n && sorted[a] == id; ++a)
              acc = __fadd_rn(acc, term(perm[a]));
          tile[(id - r0) * nc + c] = acc;
        }
      }
      if (cnt) last = ids_s[cnt - 1];
      q += cnt;
      __syncthreads();                           // the stage is reused
      if (cnt < stage) break;
    }
    // one write of the tile: nr rows of nc columns at row stride d
    if (nc == d) {
      put_run(gtab + r0 * d, tile, (long long)nr * d, t, nt);
    } else {
      for (int r = t >> 5; r < nr; r += nt >> 5)
        put_run(gtab + (r0 + r) * d + c0, tile + r * nc, nc, lane, 32);
    }
    __syncthreads();                             // the tile is reused
  }
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
                    long long b, int k, int d, long long v, int rows, int dt,
                    int threads, int smem, void* gtab, float* gw,
                    cudaStream_t s) {
  const long long n = b * k;
  const T* go = static_cast<const T*>(gout);
  if (gtab && v > 0) {
    const long long gx = ((v + rows - 1) / rows + GROUP - 1) / GROUP;
    const int gy = (d + dt - 1) / dt;
    if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
    tile_kernel<T><<<dim3((unsigned)gx, (unsigned)gy), threads, smem, s>>>(
        sorted, perm, go, w, n, k, d, v, rows, dt, static_cast<T*>(gtab));
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
// rows, dt, threads and smem are ops.backward_plan's: rows and columns a
// tile, threads a block (a multiple of 32, at least dt, at most 256) and
// the dynamic shared-memory bytes (the rows·dt float32 tile and the
// stage, within 48 KB); a plan the kernel cannot run is refused before
// any launch.
extern "C" int embedding_bag_backward(const void* table, int dtype,
                                      const int* ids, const int* sorted,
                                      const int* perm, const float* weights,
                                      const void* grad_out, long long b,
                                      int k, int d, long long v, int rows,
                                      int dt, int threads, int smem,
                                      void* grad_table, float* grad_w,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 0 || k < 0 || d < 1 || v < 0 ||
      (grad_table && b * k > 0 && (!sorted || !perm)) ||
      (grad_w && b * k > 0 && (!table || !ids)))
    return (int)cudaErrorInvalidValue;
  if (grad_table && (rows < 1 || dt < 1 || dt > d || threads < 32 ||
                     threads > 256 || threads % 32 || threads < dt ||
                     smem < 4LL * rows * dt + 8LL * STAGE * threads ||
                     smem > 48 * 1024))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_backward<float>(table, ids, sorted, perm, weights,
                                  grad_out, b, k, d, v, rows, dt, threads,
                                  smem, grad_table, grad_w, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(table, ids, sorted, perm, weights,
                                          grad_out, b, k, d, v, rows, dt,
                                          threads, smem, grad_table, grad_w,
                                          s);
  return (int)cudaErrorInvalidValue;
}
