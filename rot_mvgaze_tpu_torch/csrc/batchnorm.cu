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
//   registers for the whole walk, and there is no per-element index math.
// - The grid is (row chunks x channel tiles), planned on the host from the
//   SM count (ops/batchnorm.py::plan), so 3,136 x 2,048 (layer 4) fills the
//   card as well as 802,816 x 64 (stem) does.
// - The reductions never carry a sum across blocks in launch order (the
//   TPU's sequential grid) and use no float atomics: each thread sums its
//   rows in f64, each block writes f64 partials of at most 4,096 rows, and
//   the last block of a channel tile (a per-tile counter, reset by that
//   block) adds them in chunk order, so results are deterministic. The same
//   block finishes the per-channel epilogue, so a forward is 2 launches and
//   a backward 2. f64 adds are cheap next to the bytes (H100: 34 TFLOP/s).
// - var = E[x^2] - E[x]^2 (the JAX formula) is formed in f64 from f64
//   sums: the cancellation costs the f64 mantissa, not f32's.
// - A ragged C, or a pointer that is not 16-byte aligned, takes a masked
//   scalar path with the same thread layout.
// No TMA, no cp.async pipeline, and the forward reads x twice.

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
// t/lanes, t/lanes + NT/lanes, ... of the chunk.
struct Shape {
  long long rows;
  int C;
  int lanes;
  long long chunk_rows;
  int chunks;
  int vec;
};

struct Coords {
  int c0;
  long long r_begin, r_end;
  int rstep;
};

template <int V>
__device__ __forceinline__ Coords coords(const Shape& s) {
  Coords k;
  const int lane = threadIdx.x % s.lanes;
  k.c0 = (blockIdx.y * s.lanes + lane) * V;
  k.rstep = NT / s.lanes;
  const long long chunk0 = (long long)blockIdx.x * s.chunk_rows;
  k.r_begin = chunk0 + threadIdx.x / s.lanes;
  k.r_end = min(s.rows, chunk0 + s.chunk_rows);
  return k;
}

// Block-wide sum of each thread's V-wide (a, b) pair over its row lane, then
// the f64 partial of this block into ws (2, chunks, C). Returns true in the
// one block per channel tile that arrives last; its threads j < lanes*V then
// hold channel tile*lanes*V + j's totals in sa/sb (in chunk order).
template <int V>
__device__ bool reduce_partials(const Shape& s, const double (&a)[V], const double (&b)[V],
                                double* ws, int* counters, double& sa, double& sb) {
  __shared__ double red_a[NT * V];
  __shared__ double red_b[NT * V];
  __shared__ int is_last;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red_a[threadIdx.x * V + e] = a[e];
    red_b[threadIdx.x * V + e] = b[e];
  }
  __syncthreads();
  const int width = s.lanes * V;  // channels in this tile
  const int rstep = NT / s.lanes;
  const int j = threadIdx.x;
  const int c = blockIdx.y * width + j;
  const size_t plane = (size_t)s.chunks * s.C;
  if (j < width && c < s.C) {
    double pa = 0.0, pb = 0.0;
    for (int r = 0; r < rstep; ++r) {
      pa += red_a[r * width + j];
      pb += red_b[r * width + j];
    }
    ws[(size_t)blockIdx.x * s.C + c] = pa;
    ws[plane + (size_t)blockIdx.x * s.C + c] = pb;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = (atomicAdd(&counters[blockIdx.y], 1) == s.chunks - 1);
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  // The last block sums the partials: NT/width threads per channel, each over
  // a contiguous run of chunks in order, 8 loads in flight at a time; then
  // thread j < width adds the runs in order. The order is fixed, so the
  // result is deterministic.
  const int per_c = NT / width;
  const int q = j / width, jc = j % width;
  const int cc = blockIdx.y * width + jc;
  const int run = (s.chunks + per_c - 1) / per_c;
  const int z_end = min(s.chunks, (q + 1) * run);
  double ra = 0.0, rb = 0.0;
  if (cc < s.C) {
    int z = q * run;
    for (; z + 8 <= z_end; z += 8) {
      double va[8], vb[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        va[u] = __ldcg(ws + (size_t)(z + u) * s.C + cc);
        vb[u] = __ldcg(ws + plane + (size_t)(z + u) * s.C + cc);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        ra += va[u];
        rb += vb[u];
      }
    }
    for (; z < z_end; ++z) {
      ra += __ldcg(ws + (size_t)z * s.C + cc);
      rb += __ldcg(ws + plane + (size_t)z * s.C + cc);
    }
  }
  __syncthreads();  // red_a / red_b are reused below
  red_a[j] = ra;
  red_b[j] = rb;
  __syncthreads();
  sa = 0.0;
  sb = 0.0;
  if (j < width) {
    for (int u = 0; u < per_c; ++u) {
      sa += red_a[u * width + j];
      sb += red_b[u * width + j];
    }
  }
  if (threadIdx.x == 0) counters[blockIdx.y] = 0;  // ready for the next launch
  return true;
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
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(NT) bn_stats_kernel(const Shape s, const StatsArgs p) {
  constexpr int V = Width<T>::V;
  const Coords k = coords<V>(s);
  const T* x = static_cast<const T*>(p.x);
  double sum[V], sq[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sum[e] = sq[e] = 0.0;
  if (k.c0 < s.C) {
    for (long long r = k.r_begin; r < k.r_end; r += k.rstep) {
      float v[V];
      load_v<T>(v, x, r * s.C + k.c0, k.c0, s.C, s.vec);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sum[e] += (double)v[e];
        sq[e] += (double)__fmul_rn(v[e], v[e]);
      }
    }
  }
  double ts, tq;
  if (!reduce_partials<V>(s, sum, sq, p.ws, p.counters, ts, tq)) return;
  const int c = blockIdx.y * s.lanes * V + threadIdx.x;
  if (threadIdx.x < s.lanes * V && c < s.C) {
    const double n = (double)s.rows;
    const double mean = ts / n;
    const double var = fmax(__dsub_rn(tq / n, __dmul_rn(mean, mean)), 0.0);
    const float rstd = (float)(1.0 / sqrt(var + (double)p.eps));
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
  const Coords k = coords<V>(s);
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

template <typename T, bool RELU>
__global__ void __launch_bounds__(NT) bn_bwd_reduce_kernel(const Shape s, const BwdReduceArgs p) {
  constexpr int V = Width<T>::V;
  const Coords k = coords<V>(s);
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
    for (long long r = k.r_begin; r < k.r_end; r += k.rstep) {
      const long long off = r * s.C + k.c0;
      float gv[V], xv[V];
      load_v<T>(gv, g, off, k.c0, s.C, s.vec);
      load_v<T>(xv, x, off, k.c0, s.C, s.vec);
      if (RELU) {
        float yv[V];
        load_v<T>(yv, y, off, k.c0, s.C, s.vec);
#pragma unroll
        for (int e = 0; e < V; ++e) gv[e] = yv[e] > 0.f ? gv[e] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sg[e] += (double)gv[e];
        sgx[e] += (double)__fmul_rn(gv[e], __fmul_rn(__fsub_rn(xv[e], m[e]), rs[e]));
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

template <typename T, bool RELU>
__global__ void __launch_bounds__(NT) bn_bwd_dx_kernel(const Shape s, const BwdDxArgs p) {
  constexpr int V = Width<T>::V;
  const Coords k = coords<V>(s);
  if (k.c0 >= s.C) return;
  const T* g = static_cast<const T*>(p.g);
  const T* y = static_cast<const T*>(p.y);
  const T* x = static_cast<const T*>(p.x);
  T* dx = static_cast<T*>(p.dx);
  T* dres = static_cast<T*>(p.dres);
  const float n = (float)s.rows;
  float m[V], rs[V], kk[V], mg[V], mgx[V], gm[V], gv2[V];
  load_c<V>(m, p.mean, k.c0, s.C);
  load_c<V>(rs, p.rstd, k.c0, s.C);
  load_c<V>(kk, p.k, k.c0, s.C);
  load_c<V>(mg, p.mg, k.c0, s.C);
  load_c<V>(mgx, p.mgx, k.c0, s.C);
  load_c<V>(gm, p.gmean, k.c0, s.C);
  load_c<V>(gv2, p.gvar, k.c0, s.C);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    gm[e] = __fdiv_rn(gm[e], n);     // gmean / N
    gv2[e] = __fmul_rn(gv2[e], 2.f);  // gvar * 2, then * (x - mean) / N below
  }
  for (long long r = k.r_begin; r < k.r_end; r += k.rstep) {
    const long long off = r * s.C + k.c0;
    float gv[V], xv[V];
    load_v<T>(gv, g, off, k.c0, s.C, s.vec);
    load_v<T>(xv, x, off, k.c0, s.C, s.vec);
    if (RELU) {
      float yv[V];
      load_v<T>(yv, y, off, k.c0, s.C, s.vec);
#pragma unroll
      for (int e = 0; e < V; ++e) gv[e] = yv[e] > 0.f ? gv[e] : 0.f;
      if (dres != nullptr) store_v<T>(dres, off, gv, k.c0, s.C, s.vec);
    }
    float out[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      // k * ((g' - mg) - (x - mean) * rstd * mgx)
      const float xc = __fsub_rn(xv[e], m[e]);
      const float t = __fmul_rn(__fmul_rn(xc, rs[e]), mgx[e]);
      float d = __fmul_rn(kk[e], __fsub_rn(__fsub_rn(gv[e], mg[e]), t));
      if (p.gmean != nullptr) d = __fadd_rn(d, gm[e]);
      if (p.gvar != nullptr) d = __fadd_rn(d, __fdiv_rn(__fmul_rn(gv2[e], xc), n));
      out[e] = d;
    }
    store_v<T>(dx, off, out, k.c0, s.C, s.vec);
  }
}

dim3 grid_of(const Shape& s, int V) {
  const int tiles = (s.C + s.lanes * V - 1) / (s.lanes * V);
  return dim3(s.chunks, tiles);
}

int check_shape(const Shape& s) {
  if (s.rows <= 0 || s.C <= 0 || s.lanes <= 0 || s.lanes > 32 || NT % s.lanes != 0 ||
      s.chunks <= 0 || s.chunk_rows <= 0 || (long long)s.chunks * s.chunk_rows < s.rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Threads per block, for the host-side planner to agree with.
int mvgaze_bn_threads() { return NT; }

// Every function launches on `stream` and returns the cudaError_t of the
// launch (0 = success). dtype: 0 = float32, 1 = bfloat16 (the (rows, C)
// tensors). ws holds 2*chunks*C doubles; counters one int per channel tile,
// zero on entry and left zero.

int mvgaze_bn_stats(int dtype, const void* x, const float* scale, const float* bias, double* ws,
                    int* counters, float* mean, float* var, float* rstd, float* a, float* b,
                    long long rows, int C, int lanes, long long chunk_rows, int chunks, int vec,
                    float eps, void* stream) {
  const Shape s{rows, C, lanes, chunk_rows, chunks, vec};
  if (int err = check_shape(s)) return err;
  const StatsArgs p{x, scale, bias, ws, counters, mean, var, rstd, a, b, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    bn_stats_kernel<bf16><<<grid_of(s, Width<bf16>::V), NT, 0, st>>>(s, p);
  else if (dtype == 0)
    bn_stats_kernel<float><<<grid_of(s, Width<float>::V), NT, 0, st>>>(s, p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return last_error();
}

int mvgaze_bn_apply(int dtype, const void* x, const void* res, const float* a, const float* b,
                    void* y, long long rows, int C, int lanes, long long chunk_rows, int chunks,
                    int vec, int relu, void* stream) {
  const Shape s{rows, C, lanes, chunk_rows, chunks, vec};
  if (int err = check_shape(s)) return err;
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
                         int chunks, int vec, int relu, void* stream) {
  const Shape s{rows, C, lanes, chunk_rows, chunks, vec};
  if (int err = check_shape(s)) return err;
  const BwdReduceArgs p{g, y, x, mean, rstd, scale, ws, counters, dscale, dbias, k, mg, mgx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid = grid_of(s, Width<bf16>::V);
    if (relu) bn_bwd_reduce_kernel<bf16, true><<<grid, NT, 0, st>>>(s, p);
    else bn_bwd_reduce_kernel<bf16, false><<<grid, NT, 0, st>>>(s, p);
  } else if (dtype == 0) {
    const dim3 grid = grid_of(s, Width<float>::V);
    if (relu) bn_bwd_reduce_kernel<float, true><<<grid, NT, 0, st>>>(s, p);
    else bn_bwd_reduce_kernel<float, false><<<grid, NT, 0, st>>>(s, p);
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
  const Shape s{rows, C, lanes, chunk_rows, chunks, vec};
  if (int err = check_shape(s)) return err;
  const BwdDxArgs p{g, y, x, mean, rstd, k, mg, mgx, gmean, gvar, dx, dres};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid = grid_of(s, Width<bf16>::V);
    if (relu) bn_bwd_dx_kernel<bf16, true><<<grid, NT, 0, st>>>(s, p);
    else bn_bwd_dx_kernel<bf16, false><<<grid, NT, 0, st>>>(s, p);
  } else if (dtype == 0) {
    const dim3 grid = grid_of(s, Width<float>::V);
    if (relu) bn_bwd_dx_kernel<float, true><<<grid, NT, 0, st>>>(s, p);
    else bn_bwd_dx_kernel<float, false><<<grid, NT, 0, st>>>(s, p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return last_error();
}

}  // extern "C"
