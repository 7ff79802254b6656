// Rotate + concat + GEMM + bias + ReLU: layer 1 of the rotation-constrained
// feature fuser, for Hopper (sm_90a); the generic variant. It takes float32,
// and the bf16 shapes csrc/fusion_wgmma.cu does not (D or V not a multiple
// of 64, or a pointer that is not 16-byte aligned);
// ops/fusion.py::choose_variant decides.
//
//   h[b,:] = relu( img[b,:] @ W1[:, :D]^T
//                  + sum_i (sum_j R[b,i,j] * feat[b,j,:]) @ W1[:, D+iV : D+(i+1)V]^T
//                  + b1 )
//
// img (B,D), feat (B,3,V) and W1 (H, K=D+3V) share one dtype T (bf16 or f32);
// R (B,3,3) and b1 (H) are f32; h (B,H) is T. Accumulation is f32. The
// rotated row is computed in f32 and rounded to T before the product.
//
// Replaces: rot_mvgaze_tpu/ops/fusion.py::_kernel (the Pallas TPU kernel).
//
// Bound on the H100: W1's bytes. At the serving shape (B=64, D=2048, V=512,
// H=3584, bf16) the inputs and the output total 26.6 MB, 25.7 MB of it W1:
// about 7.9 us at 3.35 TB/s, against about 1.7 us of bf16 tensor-core work
// (1.64 GFLOP at 989 TFLOP/s). The product has only 64 rows, so the kernel
// must stream W1 at memory rate and nothing else matters much.
//
// What the design does about it:
// - W1 is read once. One 64-row tile covers the whole batch, so every W1
//   element is loaded by exactly one block, in 16-byte loads along K (W1 is
//   used as nn.Linear stores it, (H, K) row-major: both operands are
//   K-contiguous and no transpose copy exists).
// - Split-K fills the card: the 56 column tiles alone would occupy fewer than
//   half of the 132 SMs and keep too few loads in flight. The wrapper splits
//   K so that about four blocks run per SM. Each block writes an f32 partial;
//   the last block of a tile to finish (a counter per tile, in a persistent
//   buffer the block resets) adds the partials in split order
//   (deterministic), then applies bias and ReLU.
// - The concat is never materialised: for k >= D the A-tile load computes
//   A[b,k] = sum_j R[b,(k-D)/V,j] * feat[b,j,(k-D)%V] in f32 and rounds it.
// - bf16 runs on the tensor cores (wmma 16x16x16, f32 accumulate); f32 runs
//   on the FMA units, because TF32 would not hold f32 accuracy.
// - The next K-tile's global loads are issued into registers before the
//   current tile's products, so their latency overlaps the math.
// No wgmma, TMA or multi-stage shared-memory pipeline yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;   // batch rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // K per shared-memory tile
constexpr int NT = 256;  // threads per block
constexpr int CH = 8;    // consecutive K elements each thread loads per tile
constexpr int LDS = BK + 8;  // smem pitch of the A and W tiles (elements)
constexpr int LDC = BN + 4;  // smem pitch of the f32 accumulator tile

static_assert(BM * BK == NT * CH && BN * BK == NT * CH, "one chunk per thread");

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// CH values of T, 16-byte aligned so they move as uint4.
template <typename T>
struct alignas(16) Chunk {
  T v[CH];
};

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& dst, const T* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst.v);
#pragma unroll
  for (int i = 0; i < int(sizeof(Chunk<T>) / 16); ++i) d[i] = s[i];
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* dst, const Chunk<T>& src) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src.v);
#pragma unroll
  for (int i = 0; i < int(sizeof(Chunk<T>) / 16); ++i) d[i] = s[i];
}

__device__ __forceinline__ float rotate(const float r[3], float f0, float f1, float f2) {
  return r[0] * f0 + r[1] * f1 + r[2] * f2;
}

struct Args {
  const void* img;
  const void* feat;
  const float* rot;
  const void* w1;
  const float* b1;
  void* out;
  float* ws;      // (splits, B, H) f32 partials; unused when splits == 1
  int* counters;  // one per output tile, zero on entry; unused when splits == 1
  int B, D, V, H, K;
  int k_chunk, splits, vec;
};

// One thread's share of the next A tile, held in registers between the
// global loads and the shared-memory store. mode 0: `x` holds the values;
// mode 1: `f`/`r` hold a rotated chunk's inputs, combined at store time.
template <typename T>
struct AStage {
  Chunk<T> x;
  Chunk<T> f[3];
  float r[3];
  int mode;
};

template <typename T>
__device__ __forceinline__ void load_a(AStage<T>& s, const Args& a, int m, int k, int k_end) {
  const T* img = static_cast<const T*>(a.img);
  const T* feat = static_cast<const T*>(a.feat);
  s.mode = 0;
  if (m >= a.B || k >= k_end) {
#pragma unroll
    for (int e = 0; e < CH; ++e) s.x.v[e] = from_f<T>(0.f);
    return;
  }
  if (a.vec && k + CH <= k_end) {
    // D % CH == 0 and V % CH == 0 here, so a chunk never straddles the
    // image/rotated boundary or a rotation-row segment.
    if (k < a.D) {
      load_chunk(s.x, img + (size_t)m * a.D + k);
      return;
    }
    const int seg = (k - a.D) / a.V;
    const int v = (k - a.D) - seg * a.V;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      load_chunk(s.f[j], feat + ((size_t)m * 3 + j) * a.V + v);
      s.r[j] = a.rot[m * 9 + seg * 3 + j];
    }
    s.mode = 1;
    return;
  }
  // ragged or unaligned edge: element by element
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    const int kk = k + e;
    float val = 0.f;
    if (kk < k_end) {
      if (kk < a.D) {
        val = to_f(img[(size_t)m * a.D + kk]);
      } else {
        const int seg = (kk - a.D) / a.V;
        const int v = (kk - a.D) - seg * a.V;
        const float r[3] = {a.rot[m * 9 + seg * 3], a.rot[m * 9 + seg * 3 + 1],
                            a.rot[m * 9 + seg * 3 + 2]};
        const T* fp = feat + (size_t)m * 3 * a.V + v;
        val = rotate(r, to_f(fp[0]), to_f(fp[a.V]), to_f(fp[2 * a.V]));
      }
    }
    s.x.v[e] = from_f<T>(val);
  }
}

template <typename T>
__device__ __forceinline__ void store_a(AStage<T>& s, T* dst) {
  if (s.mode == 1) {
#pragma unroll
    for (int e = 0; e < CH; ++e)
      s.x.v[e] = from_f<T>(rotate(s.r, to_f(s.f[0].v[e]), to_f(s.f[1].v[e]), to_f(s.f[2].v[e])));
  }
  store_chunk(dst, s.x);
}

template <typename T>
__device__ __forceinline__ void load_w(Chunk<T>& c, const Args& a, int n, int k, int k_end) {
  const T* w1 = static_cast<const T*>(a.w1);
  if (n < a.H && k < k_end && a.vec && k + CH <= k_end) {
    load_chunk(c, w1 + (size_t)n * a.K + k);
    return;
  }
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    const int kk = k + e;
    c.v[e] = (n < a.H && kk < k_end) ? w1[(size_t)n * a.K + kk] : from_f<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
rotate_concat_matmul_relu_kernel(const Args a) {
  // raw bytes, cast below: __shared__ variables may not have constructors,
  // and bf16 is a class type
  __shared__ __align__(128) unsigned char As_raw[BM * LDS * sizeof(T)];
  __shared__ __align__(128) unsigned char Ws_raw[BN * LDS * sizeof(T)];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ int is_last;
  T* As = reinterpret_cast<T*>(As_raw);
  T* Ws = reinterpret_cast<T*>(Ws_raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * a.k_chunk;
  const int k_end = min(a.K, k_begin + a.k_chunk);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // this thread's chunk in both tiles: row tid/4, K offset (tid%4)*CH
  const int lr = tid / (BK / CH);
  const int lk = (tid % (BK / CH)) * CH;

  AStage<T> sa;
  Chunk<T> sw;
  load_a(sa, a, m0 + lr, k_begin + lk, k_end);
  load_w(sw, a, n0 + lr, k_begin + lk, k_end);

  constexpr bool kTensorCores = std::is_same<T, bf16>::value;
  const int warp = tid / 32;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc_tc[2];
  float acc[4][4];
  if constexpr (kTensorCores) {
    nvcuda::wmma::fill_fragment(acc_tc[0], 0.f);
    nvcuda::wmma::fill_fragment(acc_tc[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    store_a(sa, &As[lr * LDS + lk]);
    store_chunk(&Ws[lr * LDS + lk], sw);
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int k = k_begin + (t + 1) * BK + lk;
      load_a(sa, a, m0 + lr, k, k_end);
      load_w(sw, a, n0 + lr, k, k_end);
    }
    if constexpr (kTensorCores) {
      // warp (wm, wn) owns rows 16*wm.. and columns 32*wn.. of the tile
      const int wm = warp % 4, wn = warp / 4;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16, nvcuda::wmma::row_major> fa;
        nvcuda::wmma::load_matrix_sync(fa, &As[(wm * 16) * LDS + kk], LDS);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          // W tile is (n, k) row-major == the (k, n) operand in column-major
          nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16, nvcuda::wmma::col_major> fb;
          nvcuda::wmma::load_matrix_sync(fb, &Ws[(wn * 32 + f * 16) * LDS + kk], LDS);
          nvcuda::wmma::mma_sync(acc_tc[f], fa, fb, acc_tc[f]);
        }
      }
    } else {
      // thread (ty, tx) owns rows 4*ty.. and columns 4*tx.. of the tile
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_f(As[(ty * 4 + i) * LDS + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = to_f(Ws[(tx * 4 + j) * LDS + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (kTensorCores) {
    const int wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int f = 0; f < 2; ++f)
      nvcuda::wmma::store_matrix_sync(&Cs[(wm * 16) * LDC + wn * 32 + f * 16], acc_tc[f], LDC,
                                      nvcuda::wmma::mem_row_major);
  } else {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * 4 + i) * LDC + tx * 4 + j] = acc[i][j];
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
  if (a.splits == 1) {
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      const int m = m0 + r, n = n0 + c;
      if (m < a.B && n < a.H)
        out[(size_t)m * a.H + n] = from_f<T>(fmaxf(Cs[r * LDC + c] + a.b1[n], 0.f));
    }
    return;
  }

  // split-K: publish this block's partial, then the last block of the tile
  // reduces all partials in split order
  const size_t plane = (size_t)a.B * a.H;
  float* part = a.ws + blockIdx.z * plane;
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < a.B && n < a.H) part[(size_t)m * a.H + n] = Cs[r * LDC + c];
  }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = (atomicAdd(&a.counters[tile], 1) == a.splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < a.B && n < a.H) {
      const size_t off = (size_t)m * a.H + n;
      float s = 0.f;
      for (int z = 0; z < a.splits; ++z) s += __ldcg(a.ws + z * plane + off);
      out[off] = from_f<T>(fmaxf(s + a.b1[n], 0.f));
    }
  }
  if (tid == 0) a.counters[tile] = 0;
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.H + BN - 1) / BN, (a.B + BM - 1) / BM, a.splits);
  rotate_concat_matmul_relu_kernel<T><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile sizes the host-side planner must agree with.
int mvgaze_fusion_tiles(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
  return 0;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// dtype: 0 = float32, 1 = bfloat16 (img, feat, w1, out).
int mvgaze_rotate_concat_matmul_relu(int dtype, const void* img, const void* feat,
                                     const float* rot, const void* w1, const float* b1,
                                     void* out, float* ws, int* counters, int B, int D,
                                     int V, int H, int k_chunk, int splits, int vec,
                                     void* stream) {
  const Args a{img, feat, rot, w1, b1, out, ws, counters, B, D, V, H, D + 3 * V,
               k_chunk, splits, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(a, s);
  if (dtype == 0) return launch<float>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
