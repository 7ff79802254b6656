// Train-mode BatchNorm (+ residual add, + ReLU) forward and backward for
// Hopper (sm_90a): four kernels over x viewed as (rows, C), C contiguous,
// which is an NCHW tensor in channels_last layout (rows = N*H*W).
//
//   bn_stats       per-channel sum x, sum x^2 -> mean, var, rstd, a, b
//   bn_apply       y = act(x*a + b [+ res])
//   bn_bwd_reduce  per-channel sum g', sum g'*xhat (g' = g*[y>0] under ReLU)
//                  -> dscale, dbias, scale*rstd, sum g'/N, sum g'*xhat/N
//   bn_bwd_dx      dx = scale*rstd*(g' - sum g'/N - xhat*sum g'xhat/N)
//                  [+ (gmean + 2*gvar*(x-mean))/N], optionally dres = g'
//
// x, res, y, g, dx and dres share one dtype T (bf16 or f32); every per-
// channel vector is f32. Elementwise arithmetic is f32 with every product
// and sum rounded on its own (the __f*_rn intrinsics: no fused multiply-add
// contraction); every sum over rows is f64. ops/batchnorm.py's plain
// versions take the same steps in the same order, so kernel and plain
// version round alike: with bf16 inputs the f64 sums are exact whatever
// their order, and the two agree bit for bit.
//
// Replaces: rot_mvgaze_tpu/ops/batchnorm.py::_stats_kernel,
// _apply_kernel / _apply_res_kernel, _bwd_reduce_kernel and _bwd_dx_kernel
// (the Pallas TPU kernels), plus the XLA epilogues around them (mean, var,
// rstd and the affine coefficients at :268-272, the backward's C-vectors at
// :302-308 and the statistics cotangents at :314-317).
//
// Bound on the H100: bytes. Each kernel does a few flops per element and
// reads or writes every element of 2-4 (rows, C) tensors once, so at
// 3.35 TB/s a 802,816 x 64 bf16 pass (103 MB) costs about 31 us.
//
// What the design does about it:
// - One thread owns 16 bytes of channels (8 bf16 or 4 f32) and walks rows
//   with a stride; a warp covers whole 128-512 byte row segments, so every
//   load is a coalesced 16-byte load. Its channels' f32 parameters stay in
//   registers for the whole walk (bn_bwd_dx's in shared memory, below), and
//   there is no per-element index math.
// - The grid is (row chunks x channel tiles), planned on the host from the
//   SM count (ops/batchnorm.py::plan, plan_reduce and plan_dx), so 3,136 x
//   2,048 (layer 4) fills the card as well as 802,816 x 64 (stem) does.
// - The reductions never carry a sum across blocks in launch order (the
//   TPU's sequential grid) and use no float atomics. They run 128-thread
//   blocks over channel tiles of at most 8 lanes; each thread sums its rows
//   in f64; the block adds its rows by warp shuffles and its 4 warps in
//   order; each block writes an f64 partial; the last block of each group of
//   16 chunks adds the group's partials in chunk order, and the last group
//   of a tile adds the groups' sums (reduce_partials). Every order is fixed,
//   so results are deterministic, and no block adds more than a few dozen
//   partials after the others finish. The finishing block also computes the
//   per-channel epilogue, so a forward is 2 launches and a backward 2. f64
//   adds are cheap next to the bytes (H100: 34 TFLOP/s).
// - bn_bwd_reduce issues 2 rows (bf16; 4 for f32) of g, x and y before it
//   adds any and fits 5 blocks per SM; the plan launches a wave of 4, so
//   49 KB (bf16 under ReLU) to 98 KB (f32) per SM are in flight. That beat,
//   on the H100 over the step's 106 calls, 6 blocks (74 KB, with spills),
//   4 rows at 4 blocks, and 1 row at 8.
// - bn_stats issues 4 rows of x (16 bytes each) before it adds any, in a
//   wave of 6 blocks per SM: 48 KB in flight per SM, where one row at a
//   time kept 12 KB. For bf16 it widens each value to f64 once and adds its
//   square by one fma, which is exact and equal to the f32 square the plain
//   version adds wherever that square is a normal f32 or 0; a row holding
//   any other value takes the f32 product (stats_add). On the H100 an
//   ablation (tuning builds of this file, PERF.md) found the f64 work
//   nearly hidden (loads alone take almost all of the kernel's time) and a
//   large fixed cost per call: the launch, and reduce_partials' chain of
//   global round trips after the last block's loads. 2 or 8 rows, or 4
//   blocks per SM, were no faster.
// - var = E[x^2] - E[x]^2 (the JAX formula) is formed in f64 from f64
//   sums: the cancellation costs the f64 mantissa, not f32's.
// - A ragged C, or a pointer that is not 16-byte aligned, takes a masked
//   scalar path with the same thread layout.
// - bn_bwd_dx keeps 2 rows of loads in flight per thread before its
//   stores, loads its last-use inputs evict-first, reads its per-channel
//   constants from shared memory, and runs one wave of persistent blocks
//   (see kBwdDxMinBlocks below).
// No TMA, no cp.async pipeline, and the forward reads x twice (a
// single-pass forward is queued).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
struct Width {
  static constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
};

// V values of T at base[off..off+V), masked to channels c0+e < C.
template <typename T>
__device__ __forceinline__ void load_v(float (&out)[Width<T>::V], const T* base, long long off,
                                       int c0, int C, int vec) {
  constexpr int V = Width<T>::V;
  if (vec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(base + off));
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = to_f(t[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = (c0 + e < C) ? to_f(base[off + e]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_v(T* base, long long off, const float (&in)[Width<T>::V],
                                        int c0, int C, int vec) {
  constexpr int V = Width<T>::V;
  if (vec) {
    uint4 raw;
    T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = from_f<T>(in[e]);
    *reinterpret_cast<uint4*>(base + off) = raw;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c0 + e < C) base[off + e] = from_f<T>(in[e]);
  }
}

// V per-channel f32 values starting at channel c0 (0 past C, or if p is null).
template <int V>
__device__ __forceinline__ void load_c(float (&out)[V], const float* p, int c0, int C) {
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = (p != nullptr && c0 + e < C) ? p[c0 + e] : 0.f;
}

// The launch shape shared by the four kernels: block (chunk, tile) covers rows
// [chunk*chunk_rows, +chunk_rows) and channels [tile*lanes*V, +lanes*V);
// thread t owns channels c0 = (tile*lanes + t%lanes)*V .. +V and rows
// t/lanes, t/lanes + NTHREADS/lanes, ... of the chunk. The reductions also
// use `groups`: their chunks' partials are summed in groups of kGroup.
struct Shape {
  long long rows;
  int C;
  int lanes;
  long long chunk_rows;
  int chunks;
  int vec;
  int groups;
};

struct Coords {
  int c0;
  long long r_begin, r_end;
  int rstep;
};

template <int V, int NTHREADS>
__device__ __forceinline__ Coords coords(const Shape& s) {
  Coords k;
  const int lane = threadIdx.x % s.lanes;
  k.c0 = (blockIdx.y * s.lanes + lane) * V;
  k.rstep = NTHREADS / s.lanes;
  const long long chunk0 = (long long)blockIdx.x * s.chunk_rows;
  k.r_begin = chunk0 + threadIdx.x / s.lanes;
  k.r_end = min(s.rows, chunk0 + s.chunk_rows);
  return k;
}

// The reductions (bn_stats, bn_bwd_reduce) run NTR threads per block and at
// most kMaxReduceLanes lanes, so a channel tile is at most 64 bf16 or 32 f32
// channels and a warp spans at least 4 rows.
constexpr int NTR = 128;
constexpr int kMaxReduceLanes = 8;
constexpr int kGroup = 16;  // chunk partials per first-level group
constexpr int kMaxWidth = kMaxReduceLanes * 8;

// Sum of up to kGroup f64 values src[0], src[stride], ... (n of them), all
// loads issued before the first add; added in index order.
__device__ __forceinline__ double sum_run(const double* src, size_t stride, int n) {
  double v[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) v[u] = u < n ? __ldcg(src + u * stride) : 0.0;
  double t = v[0];
#pragma unroll
  for (int u = 1; u < kGroup; ++u)
    if (u < n) t += v[u];
  return t;
}

// Deterministic sum over all rows of each thread's V-wide (a, b) pair, in
// three levels with a fixed order and no float atomics:
// 1. the block: warp shuffles over a warp's rows (a fixed tree), then the
//    warps in order through 4 KB of shared memory; the block's f64 partial
//    goes to ws (2, chunks, C);
// 2. each group of kGroup chunks: its last block to arrive (a counter per
//    group) adds the group's partials in chunk order into ws2 (2, groups, C);
// 3. the tile: the last group to finish (one more counter) adds the groups'
//    sums in group order, 16 at a time.
// Counters are (tiles, groups + 1) ints, zero on entry; the block that
// reads a counter last resets it. Returns true in the one block per channel
// tile that finished level 3 (level 2 when there is one group); its threads
// j < lanes*V then hold channel tile*lanes*V + j's totals in sa/sb.
template <int V>
__device__ bool reduce_partials(const Shape& s, double (&a)[V], double (&b)[V], double* ws,
                                int* counters, double& sa, double& sb) {
  __shared__ double red[NTR / 32][2][kMaxWidth];
  __shared__ double total[2][kMaxWidth];
  __shared__ int is_last;
  const int width = s.lanes * V;  // channels in this tile
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    for (int off = s.lanes; off < 32; off <<= 1) {
      a[e] += __shfl_down_sync(0xffffffffu, a[e], off);
      b[e] += __shfl_down_sync(0xffffffffu, b[e], off);
    }
  }
  if (lane < s.lanes) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red[warp][0][lane * V + e] = a[e];
      red[warp][1][lane * V + e] = b[e];
    }
  }
  __syncthreads();
  // thread j < 2*width owns value j: kind j / width (a or b), channel j % width
  const int j = threadIdx.x;
  const int kind = j / width, jc = j - kind * width;
  const int c = blockIdx.y * width + jc;
  const bool owner = j < 2 * width && c < s.C;
  const size_t plane = (size_t)s.chunks * s.C;
  double* ws2 = ws + 2 * plane;
  const size_t plane2 = (size_t)s.groups * s.C;
  if (owner) {
    double t = red[0][kind][jc];
#pragma unroll
    for (int w = 1; w < NTR / 32; ++w) t += red[w][kind][jc];
    ws[kind * plane + (size_t)blockIdx.x * s.C + c] = t;
  }
  int* cnt = counters + blockIdx.y * (s.groups + 1);
  const int g = blockIdx.x / kGroup;
  const int g_first = g * kGroup, g_n = min(kGroup, s.chunks - g_first);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = (atomicAdd(&cnt[g], 1) == g_n - 1);
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  // level 2: this group's partials in chunk order
  double t = 0.0;
  if (owner) t = sum_run(ws + kind * plane + (size_t)g_first * s.C + c, s.C, g_n);
  if (threadIdx.x == 0) cnt[g] = 0;
  if (s.groups > 1) {
    if (owner) ws2[kind * plane2 + (size_t)g * s.C + c] = t;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = (atomicAdd(&cnt[s.groups], 1) == s.groups - 1);
    __syncthreads();
    if (!is_last) return false;
    __threadfence();
    // level 3: the groups' sums in group order, kGroup loads in flight
    if (owner) {
      const double* src = ws2 + kind * plane2 + c;
      t = sum_run(src, s.C, min(kGroup, s.groups));
      for (int g0 = kGroup; g0 < s.groups; g0 += kGroup)
        t += sum_run(src + (size_t)g0 * s.C, s.C, min(kGroup, s.groups - g0));
    }
    if (threadIdx.x == 0) cnt[s.groups] = 0;
  }
  if (owner) total[kind][jc] = t;
  __syncthreads();
  sa = sb = 0.0;
  if (j < width && blockIdx.y * width + j < s.C) {
    sa = total[0][j];
    sb = total[1][j];
  }
  return true;
}

// 16 bytes of T at base[off..), zeros for channels c0+e >= C (scalar loads
// when `vec` is 0).
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* base, long long off, int c0, int C, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(base + off));
  uint4 raw = make_uint4(0, 0, 0, 0);
  T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < Width<T>::V; ++e)
    if (c0 + e < C) t[e] = base[off + e];
  return raw;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int e) {
  return to_f(reinterpret_cast<const T*>(&raw)[e]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct StatsArgs {
  const void* x;
  const float* scale;
  const float* bias;
  double* ws;
  int* counters;
  float *mean, *var, *rstd, *a, *b;
  double eps;
};

// bn_stats' design (header): kStatsRows rows of 16-byte loads in flight per
// thread, in blocks of NTR threads of which kStatsMinBlocks fit an SM (its
// launch bounds; the plan launches one wave of ops/batchnorm.py's
// STATS_BLOCKS_PER_SM, at most that many).
constexpr int kStatsRows = 4;
constexpr int kStatsMinBlocks = 6;

// Whether every bf16 of the 16 bytes squares exactly into a normal f32 (or
// is 0): |v| in [2^-63, 2^64), i.e. |bits| in [0x2000, 0x5F80). Four 32-bit
// words of two bf16 each, tested two at a time with no carry between the
// halves: for a = |bits| <= 0x7fff, bit 15 of a + 0x7fff is (a != 0), of
// a + 0x6000 is (a >= 0x2000), and of a + 0x2080 is (a >= 0x5F80).
__device__ __forceinline__ bool squares_exact_in_f32(const uint4& raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t bad = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t h = w[i] & 0x7fff7fffu;
    bad |= ((h + 0x7fff7fffu) & ~(h + 0x60006000u)) | (h + 0x20802080u);
  }
  return (bad & 0x80008000u) == 0;
}

// One row's 16 bytes (V values) into this thread's f64 sums, in the order
// of the elements. sum takes (double)v. sq takes (double)(v*v rounded to
// f32), as the plain version squares in f32. For bf16, v is widened once
// and x*x added by one fma: v has an 8-bit significand, so x*x has at most
// 16 bits and is exact in f64, and equals the f32 square exactly where that
// is a normal f32 or 0 (squares_exact_in_f32); the fma rounds once, as the
// add of the exact square does, so the sums are the same bits. f32, and a
// bf16 row holding any other value (tiny, huge, inf, nan), widen v and its
// f32 square apart.
template <typename T>
__device__ __forceinline__ void stats_add(const uint4& raw, double (&sum)[Width<T>::V],
                                          double (&sq)[Width<T>::V]) {
  constexpr int V = Width<T>::V;
  if (sizeof(T) == 2 && squares_exact_in_f32(raw)) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const double x = (double)elem<T>(raw, e);
      sum[e] = __dadd_rn(sum[e], x);
      sq[e] = __fma_rn(x, x, sq[e]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float v = elem<T>(raw, e);
    sum[e] = __dadd_rn(sum[e], (double)v);
    sq[e] = __dadd_rn(sq[e], (double)__fmul_rn(v, v));
  }
}

template <typename T>
__global__ void __launch_bounds__(NTR, kStatsMinBlocks) bn_stats_kernel(const Shape s, const StatsArgs p) {
  constexpr int V = Width<T>::V;
  constexpr int U = kStatsRows;
  const Coords k = coords<V, NTR>(s);
  const T* x = static_cast<const T*>(p.x);
  double sum[V], sq[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sum[e] = sq[e] = 0.0;
  if (k.c0 < s.C) {
    long long r = k.r_begin;
    if (s.vec) {
      // whole passes: U rows' loads issued, then added in row order
      const long long step = (long long)U * k.rstep;
      for (; r + (long long)(U - 1) * k.rstep < k.r_end; r += step) {
        uint4 raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(x + (r + (long long)u * k.rstep) * s.C + k.c0));
#pragma unroll
        for (int u = 0; u < U; ++u) stats_add<T>(raw[u], sum, sq);
      }
    }
    // the rest of the rows, and the masked scalar path, one row at a time
    for (; r < k.r_end; r += k.rstep)
      stats_add<T>(load_raw<T>(x, r * s.C + k.c0, k.c0, s.C, s.vec), sum, sq);
  }
  double ts, tq;
  if (!reduce_partials<V>(s, sum, sq, p.ws, p.counters, ts, tq)) return;
  const int c = blockIdx.y * s.lanes * V + threadIdx.x;
  if (threadIdx.x < s.lanes * V && c < s.C) {
    // "/ N" is a product with 1/N rounded to f64, as PyTorch divides a
    // tensor by a Python number on the card, so that the plain version
    // rounds alike
    const double inv_n = 1.0 / (double)s.rows;
    const double mean = __dmul_rn(ts, inv_n);
    const double var = fmax(__dsub_rn(__dmul_rn(tq, inv_n), __dmul_rn(mean, mean)), 0.0);
    const float rstd = (float)(1.0 / sqrt(__dadd_rn(var, p.eps)));
    const float a = __fmul_rn(p.scale[c], rstd);
    p.mean[c] = (float)mean;
    p.var[c] = (float)var;
    p.rstd[c] = rstd;
    p.a[c] = a;
    p.b[c] = __fsub_rn(p.bias[c], __fmul_rn((float)mean, a));
  }
}

struct ApplyArgs {
  const void* x;
  const void* res;
  const float* a;
  const float* b;
  void* y;
};

template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(NT) bn_apply_kernel(const Shape s, const ApplyArgs p) {
  constexpr int V = Width<T>::V;
  const Coords k = coords<V, NT>(s);
  if (k.c0 >= s.C) return;
  const T* x = static_cast<const T*>(p.x);
  const T* res = static_cast<const T*>(p.res);
  T* y = static_cast<T*>(p.y);
  float a[V], b[V];
  load_c<V>(a, p.a, k.c0, s.C);
  load_c<V>(b, p.b, k.c0, s.C);
  for (long long r = k.r_begin; r < k.r_end; r += k.rstep) {
    const long long off = r * s.C + k.c0;
    float v[V];
    load_v<T>(v, x, off, k.c0, s.C, s.vec);
    float rv[V];
    if (RES) load_v<T>(rv, res, off, k.c0, s.C, s.vec);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float o = __fadd_rn(__fmul_rn(v[e], a[e]), b[e]);
      if (RES) o = __fadd_rn(o, rv[e]);
      if (RELU) o = fmaxf(o, 0.f);
      v[e] = o;
    }
    store_v<T>(y, off, v, k.c0, s.C, s.vec);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdReduceArgs {
  const void* g;
  const void* y;  // read only under ReLU
  const void* x;
  const float* mean;
  const float* rstd;
  const float* scale;
  double* ws;
  int* counters;
  float *dscale, *dbias, *k, *mg, *mgx;
};

// Rows in flight per thread in bn_bwd_reduce: 2 rows of 16 bytes of g, x
// (and y) for bf16, 4 for f32, within the registers that let 5 blocks of
// NTR threads share an SM (at most 102 a thread: 95 used, no spills). A
// sweep on the H100 over 1-4 rows and 3-8 blocks found this the fastest over
// the step's 106 calls; 6 blocks spilled.
constexpr int kBwdReduceMinBlocks = 5;
template <typename T>
struct ReduceUnroll {
  static constexpr int U = sizeof(T) == 2 ? 2 : 4;
};

template <typename T, bool RELU>
__global__ void __launch_bounds__(NTR, kBwdReduceMinBlocks) bn_bwd_reduce_kernel(const Shape s, const BwdReduceArgs p) {
  constexpr int V = Width<T>::V;
  constexpr int U = ReduceUnroll<T>::U;
  const Coords k = coords<V, NTR>(s);
  const T* g = static_cast<const T*>(p.g);
  const T* y = static_cast<const T*>(p.y);
  const T* x = static_cast<const T*>(p.x);
  double sg[V], sgx[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sg[e] = sgx[e] = 0.0;
  if (k.c0 < s.C) {
    float m[V], rs[V];
    load_c<V>(m, p.mean, k.c0, s.C);
    load_c<V>(rs, p.rstd, k.c0, s.C);
    const long long step = (long long)U * k.rstep;
    for (long long r = k.r_begin; r < k.r_end; r += step) {
      // U rows' loads first, then the sums in row order
      uint4 graw[U], xraw[U], yraw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long rr = r + (long long)u * k.rstep;
        if (rr < k.r_end) {
          const long long off = rr * s.C + k.c0;
          graw[u] = load_raw<T>(g, off, k.c0, s.C, s.vec);
          xraw[u] = load_raw<T>(x, off, k.c0, s.C, s.vec);
          if (RELU) yraw[u] = load_raw<T>(y, off, k.c0, s.C, s.vec);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + (long long)u * k.rstep >= k.r_end) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float gv = elem<T>(graw[u], e);
          if (RELU) gv = elem<T>(yraw[u], e) > 0.f ? gv : 0.f;
          const float xv = elem<T>(xraw[u], e);
          sg[e] += (double)gv;
          sgx[e] += (double)__fmul_rn(gv, __fmul_rn(__fsub_rn(xv, m[e]), rs[e]));
        }
      }
    }
  }
  double tg, tgx;
  if (!reduce_partials<V>(s, sg, sgx, p.ws, p.counters, tg, tgx)) return;
  const int c = blockIdx.y * s.lanes * V + threadIdx.x;
  if (threadIdx.x < s.lanes * V && c < s.C) {
    const double n = (double)s.rows;
    p.dbias[c] = (float)tg;
    p.dscale[c] = (float)tgx;
    p.k[c] = __fmul_rn(p.scale[c], p.rstd[c]);
    p.mg[c] = (float)(tg / n);
    p.mgx[c] = (float)(tgx / n);
  }
}

struct BwdDxArgs {
  const void* g;
  const void* y;  // read only under ReLU
  const void* x;
  const float* mean;
  const float* rstd;
  const float* k;
  const float* mg;
  const float* mgx;
  const float* gmean;  // cotangent of the returned mean, or null
  const float* gvar;   // cotangent of the returned var, or null
  void* dx;
  void* dres;  // g' (the residual's gradient), or null
};

// bn_bwd_dx streams 3 (rows, C) inputs (g, x and, under ReLU, y) and writes
// 1-2. Each thread issues kBwdDxRows rows of its loads before the first
// store; the pointers are __restrict__, so nothing orders a store before a
// later row's loads; g, x and y are read for the last time here and load
// evict-first (ld.global.cs), so that dx, which cuDNN's dgrad and wgrad
// read next, keeps the L2. The tile's per-channel constants live in shared
// memory and are read 4 channels at a time as each row is computed: held in
// registers (40 of them for bf16) they forced spills or fewer rows in
// flight. kBwdDxMinBlocks blocks of NT threads fit an SM, and the plan
// launches one wave of exactly that many (ops/batchnorm.py::plan_dx), each
// walking a contiguous chunk of rows: no second wave and no tail of small
// blocks at layer 4's 3,136 rows.
constexpr int kBwdDxMinBlocks = 3;
constexpr int kBwdDxRows = 2;

// 4 f32 of shared memory, read where the program says (asm volatile: the
// compiler neither hoists the read out of the row loop nor keeps the
// values in registers across rows).
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  return v;
}

// the per-channel constants of bn_bwd_dx, in its shared-memory table
enum { kMean, kRstd, kK, kMg, kMgx, kGm, kGv2, kDxConsts };

template <typename T>
struct DxRows {
  const T* __restrict__ g;
  const T* __restrict__ y;
  const T* __restrict__ x;
  T* __restrict__ dx;
  T* __restrict__ dres;
};

// 16 bytes of T at base[off..), loaded evict-first (streaming): 16-byte
// loads (VEC), or scalar loads masked to channels c0+e < C.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_last(const T* __restrict__ base, long long off, int c0, int C) {
  if (VEC) return __ldcs(reinterpret_cast<const uint4*>(base + off));
  uint4 raw = make_uint4(0, 0, 0, 0);
  T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < Width<T>::V; ++e)
    if (c0 + e < C) t[e] = __ldcs(base + off + e);
  return raw;
}

// U rows r, r + rstep, ... of one thread: every row's loads first, then
// each row's arithmetic and stores. cst is the table (kWidth floats per
// constant), j0 this thread's first channel in it.
template <typename T, bool RELU, bool GSTATS, bool VEC, int U, int kWidth>
__device__ __forceinline__ void bwd_dx_rows(const DxRows<T>& q, const float* cst, int j0, int c0,
                                            int C, long long r, int rstep, float inv_n,
                                            bool gm_on, bool gv_on) {
  constexpr int V = Width<T>::V;
  uint4 graw[U], xraw[U], yraw[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long off = (r + (long long)u * rstep) * C + c0;
    graw[u] = load_last<T, VEC>(q.g, off, c0, C);
    xraw[u] = load_last<T, VEC>(q.x, off, c0, C);
    if (RELU) yraw[u] = load_last<T, VEC>(q.y, off, c0, C);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long off = (r + (long long)u * rstep) * C + c0;
    float gv[V], out[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      gv[e] = elem<T>(graw[u], e);
      if (RELU) gv[e] = elem<T>(yraw[u], e) > 0.f ? gv[e] : 0.f;
    }
    if (RELU && q.dres != nullptr) store_v<T>(q.dres, off, gv, c0, C, VEC);
#pragma unroll
    for (int h = 0; h < V; h += 4) {
      const float4 m4 = lds4(cst + kMean * kWidth + j0 + h), rs4 = lds4(cst + kRstd * kWidth + j0 + h);
      const float4 k4 = lds4(cst + kK * kWidth + j0 + h), mg4 = lds4(cst + kMg * kWidth + j0 + h);
      const float4 mgx4 = lds4(cst + kMgx * kWidth + j0 + h);
      const float m[4] = {m4.x, m4.y, m4.z, m4.w}, rs[4] = {rs4.x, rs4.y, rs4.z, rs4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w}, mg[4] = {mg4.x, mg4.y, mg4.z, mg4.w};
      const float mgx[4] = {mgx4.x, mgx4.y, mgx4.z, mgx4.w};
      float xc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // k * ((g' - mg) - (x - mean) * rstd * mgx)
        xc[e] = __fsub_rn(elem<T>(xraw[u], h + e), m[e]);
        const float t = __fmul_rn(__fmul_rn(xc[e], rs[e]), mgx[e]);
        out[h + e] = __fmul_rn(kk[e], __fsub_rn(__fsub_rn(gv[h + e], mg[e]), t));
      }
      if (GSTATS) {
        const float4 gm4 = lds4(cst + kGm * kWidth + j0 + h), gv4 = lds4(cst + kGv2 * kWidth + j0 + h);
        const float gm[4] = {gm4.x, gm4.y, gm4.z, gm4.w}, gv2[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gm_on) out[h + e] = __fadd_rn(out[h + e], gm[e]);
          if (gv_on) out[h + e] = __fadd_rn(out[h + e], __fmul_rn(__fmul_rn(gv2[e], xc[e]), inv_n));
        }
      }
    }
    store_v<T>(q.dx, off, out, c0, C, VEC);
  }
}

// GSTATS: gmean or gvar (the cotangents of the returned statistics) given.
// VEC: 16-byte loads and stores (C a multiple of the vector, aligned
// pointers); else the masked scalar path, one row at a time.
template <typename T, bool RELU, bool GSTATS, bool VEC>
__global__ void __launch_bounds__(NT, kBwdDxMinBlocks) bn_bwd_dx_kernel(const Shape s, const BwdDxArgs p) {
  constexpr int V = Width<T>::V;
  constexpr int U = VEC ? kBwdDxRows : 1;
  constexpr int kWidth = 32 * V;  // channels of the widest tile (32 lanes)
  __shared__ __align__(16) float cst[kDxConsts * kWidth];
  const float inv_n = __frcp_rn((float)s.rows);
  const int width = s.lanes * V, tile0 = blockIdx.y * width;
  for (int i = threadIdx.x; i < width; i += NT) {
    const int c = tile0 + i;
    const bool in = c < s.C;
    cst[kMean * kWidth + i] = in ? p.mean[c] : 0.f;
    cst[kRstd * kWidth + i] = in ? p.rstd[c] : 0.f;
    cst[kK * kWidth + i] = in ? p.k[c] : 0.f;
    cst[kMg * kWidth + i] = in ? p.mg[c] : 0.f;
    cst[kMgx * kWidth + i] = in ? p.mgx[c] : 0.f;
    if (GSTATS) {
      // gmean / N; gvar * 2, then * (x - mean) / N per element. "/ N" is a
      // product with 1/N rounded to f32, as PyTorch divides a tensor by a
      // Python number on the card, so that the plain version rounds alike.
      cst[kGm * kWidth + i] = in && p.gmean != nullptr ? __fmul_rn(p.gmean[c], inv_n) : 0.f;
      cst[kGv2 * kWidth + i] = in && p.gvar != nullptr ? __fmul_rn(p.gvar[c], 2.f) : 0.f;
    }
  }
  __syncthreads();
  const Coords k = coords<V, NT>(s);
  if (k.c0 >= s.C || k.r_begin >= k.r_end) return;
  const DxRows<T> q{static_cast<const T*>(p.g), static_cast<const T*>(p.y),
                    static_cast<const T*>(p.x), static_cast<T*>(p.dx), static_cast<T*>(p.dres)};
  const int j0 = k.c0 - tile0;
  const bool gm_on = p.gmean != nullptr, gv_on = p.gvar != nullptr;
  // this thread's rows: whole passes of U rows, then the rest one by one
  const long long rows = (k.r_end - k.r_begin + k.rstep - 1) / k.rstep;
  long long r = k.r_begin;
  for (long long i = 0; i + U <= rows; i += U, r += (long long)U * k.rstep)
    bwd_dx_rows<T, RELU, GSTATS, VEC, U, kWidth>(q, cst, j0, k.c0, s.C, r, k.rstep, inv_n, gm_on, gv_on);
  for (; r < k.r_end; r += k.rstep)
    bwd_dx_rows<T, RELU, GSTATS, VEC, 1, kWidth>(q, cst, j0, k.c0, s.C, r, k.rstep, inv_n, gm_on, gv_on);
}

dim3 grid_of(const Shape& s, int V) {
  const int tiles = (s.C + s.lanes * V - 1) / (s.lanes * V);
  return dim3(s.chunks, tiles);
}

int check_shape(const Shape& s, bool reduce) {
  const int max_lanes = reduce ? kMaxReduceLanes : 32;
  if (s.rows <= 0 || s.C <= 0 || s.lanes <= 0 || s.lanes > max_lanes || NT % s.lanes != 0 ||
      s.chunks <= 0 || s.chunk_rows <= 0 || (long long)s.chunks * s.chunk_rows < s.rows ||
      (reduce && s.groups != (s.chunks + kGroup - 1) / kGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <typename T, bool RELU, bool GSTATS>
void launch_bwd_dx(const Shape& s, const BwdDxArgs& p, cudaStream_t st) {
  const dim3 grid = grid_of(s, Width<T>::V);
  if (s.vec)
    bn_bwd_dx_kernel<T, RELU, GSTATS, true><<<grid, NT, 0, st>>>(s, p);
  else
    bn_bwd_dx_kernel<T, RELU, GSTATS, false><<<grid, NT, 0, st>>>(s, p);
}

template <typename T>
void launch_bwd_dx(const Shape& s, const BwdDxArgs& p, bool relu, bool gstats, cudaStream_t st) {
  if (relu)
    gstats ? launch_bwd_dx<T, true, true>(s, p, st) : launch_bwd_dx<T, true, false>(s, p, st);
  else
    gstats ? launch_bwd_dx<T, false, true>(s, p, st) : launch_bwd_dx<T, false, false>(s, p, st);
}

}  // namespace

extern "C" {

// Threads per block, for the host-side planner to agree with.
int mvgaze_bn_threads() { return NT; }

// bn_bwd_dx's blocks per SM (its one-wave plan) and rows in flight per thread.
int mvgaze_bn_bwd_dx_config(int* min_blocks, int* rows) {
  *min_blocks = kBwdDxMinBlocks;
  *rows = kBwdDxRows;
  return 0;
}

// bn_stats' blocks that fit an SM (its launch bounds; the plan's blocks
// per SM must not exceed them).
int mvgaze_bn_stats_config(int* min_blocks) {
  *min_blocks = kStatsMinBlocks;
  return 0;
}

// The reductions' threads per block, most lanes and chunks per group.
int mvgaze_bn_reduce_config(int* threads, int* max_lanes, int* group) {
  *threads = NTR;
  *max_lanes = kMaxReduceLanes;
  *group = kGroup;
  return 0;
}

// Every function launches on `stream` and returns the cudaError_t of the
// launch (0 = success). dtype: 0 = float32, 1 = bfloat16 (the (rows, C)
// tensors). For the reductions, ws holds 2*(chunks + groups)*C doubles and
// counters (tiles, groups + 1) ints, zero on entry and left zero.

int mvgaze_bn_stats(int dtype, const void* x, const float* scale, const float* bias, double* ws,
                    int* counters, float* mean, float* var, float* rstd, float* a, float* b,
                    long long rows, int C, int lanes, long long chunk_rows, int chunks, int vec,
                    int groups, double eps, void* stream) {
  const Shape s{rows, C, lanes, chunk_rows, chunks, vec, groups};
  if (int err = check_shape(s, true)) return err;
  const StatsArgs p{x, scale, bias, ws, counters, mean, var, rstd, a, b, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    bn_stats_kernel<bf16><<<grid_of(s, Width<bf16>::V), NTR, 0, st>>>(s, p);
  else if (dtype == 0)
    bn_stats_kernel<float><<<grid_of(s, Width<float>::V), NTR, 0, st>>>(s, p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return last_error();
}

int mvgaze_bn_apply(int dtype, const void* x, const void* res, const float* a, const float* b,
                    void* y, long long rows, int C, int lanes, long long chunk_rows, int chunks,
                    int vec, int relu, void* stream) {
  const Shape s{rows, C, lanes, chunk_rows, chunks, vec, 0};
  if (int err = check_shape(s, false)) return err;
  const ApplyArgs p{x, res, a, b, y};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int variant = (res != nullptr ? 2 : 0) + (relu ? 1 : 0);
#define MVGAZE_APPLY(T)                                                                    \
  {                                                                                        \
    const dim3 grid = grid_of(s, Width<T>::V);                                             \
    switch (variant) {                                                                     \
      case 0: bn_apply_kernel<T, false, false><<<grid, NT, 0, st>>>(s, p); break;          \
      case 1: bn_apply_kernel<T, false, true><<<grid, NT, 0, st>>>(s, p); break;           \
      case 2: bn_apply_kernel<T, true, false><<<grid, NT, 0, st>>>(s, p); break;           \
      default: bn_apply_kernel<T, true, true><<<grid, NT, 0, st>>>(s, p); break;           \
    }                                                                                      \
  }
  if (dtype == 1)
    MVGAZE_APPLY(bf16)
  else if (dtype == 0)
    MVGAZE_APPLY(float)
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef MVGAZE_APPLY
  return last_error();
}

int mvgaze_bn_bwd_reduce(int dtype, const void* g, const void* y, const void* x,
                         const float* mean, const float* rstd, const float* scale, double* ws,
                         int* counters, float* dscale, float* dbias, float* k, float* mg,
                         float* mgx, long long rows, int C, int lanes, long long chunk_rows,
                         int chunks, int vec, int groups, int relu, void* stream) {
  const Shape s{rows, C, lanes, chunk_rows, chunks, vec, groups};
  if (int err = check_shape(s, true)) return err;
  const BwdReduceArgs p{g, y, x, mean, rstd, scale, ws, counters, dscale, dbias, k, mg, mgx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid = grid_of(s, Width<bf16>::V);
    if (relu) bn_bwd_reduce_kernel<bf16, true><<<grid, NTR, 0, st>>>(s, p);
    else bn_bwd_reduce_kernel<bf16, false><<<grid, NTR, 0, st>>>(s, p);
  } else if (dtype == 0) {
    const dim3 grid = grid_of(s, Width<float>::V);
    if (relu) bn_bwd_reduce_kernel<float, true><<<grid, NTR, 0, st>>>(s, p);
    else bn_bwd_reduce_kernel<float, false><<<grid, NTR, 0, st>>>(s, p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return last_error();
}

int mvgaze_bn_bwd_dx(int dtype, const void* g, const void* y, const void* x, const float* mean,
                     const float* rstd, const float* k, const float* mg, const float* mgx,
                     const float* gmean, const float* gvar, void* dx, void* dres,
                     long long rows, int C, int lanes, long long chunk_rows, int chunks,
                     int vec, int relu, void* stream) {
  const Shape s{rows, C, lanes, chunk_rows, chunks, vec, 0};
  if (int err = check_shape(s, false)) return err;
  const BwdDxArgs p{g, y, x, mean, rstd, k, mg, mgx, gmean, gvar, dx, dres};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gstats = gmean != nullptr || gvar != nullptr;
  if (dtype == 1)
    launch_bwd_dx<bf16>(s, p, relu, gstats, st);
  else if (dtype == 0)
    launch_bwd_dx<float>(s, p, relu, gstats, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return last_error();
}

}  // extern "C"
