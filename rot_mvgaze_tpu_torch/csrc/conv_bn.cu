// 3x3 stride-1 same-pad NHWC convolution with the BatchNorm statistics in
// its epilogue, for Hopper (sm_90a):
//
//   out[b,y,x,n] = sum_{ky,kx,c} x[b, y+ky-1, x+kx-1, c] * w[ky,kx,c,n]  (0 outside)
//   stats[0,n]   = sum_{b,y,x} acc[b,y,x,n],  stats[1,n] = sum acc^2
//
// x (B,H,W,C) and w (3,3,C,Cout) HWIO are float32 or bf16 each, and are
// rounded to bf16 as they are loaded; products accumulate in f32 (acc); out
// is x's dtype; stats (2, Cout) f32 are taken from the f32 accumulator, not
// from the rounded output.
//
// Replaces: rot_mvgaze_tpu/ops/conv_bn.py::_kernel (the Pallas TPU kernel:
// 9 statically shifted (TB*H*W, C) x (C, Cout) MXU GEMMs per batch tile, the
// stats carried across a sequential grid).
//
// Bound on the H100: operations. At the probe's shape (B=256, 14x14, C =
// Cout = 256, bf16) the convolution is 59.2 GFLOP, 0.060 ms at 989 TFLOP/s,
// against 52.6 MB of x, w, out and stats, 0.016 ms at 3.35 TB/s; R50's
// other stride-1 3x3 shapes at 64 images are 14.8 GFLOP each and bound by
// operations too (layer 1's 56x56x64 by bytes and operations alike). So the
// tensor cores must be kept busy, and the statistics must cost no pass over
// the output.
//
// What the design does about it:
// - Implicit GEMM: M = B*H*W output pixels, N = Cout, K = 9*C in (tap, c)
//   order, so w viewed as (9C, Cout) is the B operand as it lies. No im2col
//   copy exists: each thread of the A-tile load owns fixed rows, works out
//   once which of their 9 taps stay inside the image (y and x checked, so a
//   tap never wraps into the neighbouring row or image of the flattened M),
//   and per K tile reads x at pixel m + dy*W + dx, or 0 outside. The
//   (tap, channel, offset) of each load advances by adds from tile to tile:
//   integer division and 64-bit address math per load had cost more issue
//   slots than the tensor-core instructions.
// - bf16 on the tensor cores (wmma 16x16x16, i.e. mma.sync, f32
//   accumulate): a 128x64 output tile per block of 8 warps, 32x32 per warp.
//   bf16 inputs with 16-byte loads (the probe's and R50's shapes) move by
//   cp.async into a ring of 3 shared-memory stages, zero-filled where a tap
//   leaves the image, so two K tiles are in flight during each tile's
//   products; one barrier per K tile. Other inputs (f32, ragged C or Cout)
//   load one K tile ahead into registers, rounding to bf16 on the way.
// - Epilogue: the f32 tile goes to shared memory once; the block writes out
//   from there and sums each channel's column (rows past M masked) in f64.
//   The statistics never carry a sum across blocks in launch order and use
//   no float atomics: each block writes its f64 column sums, and the last
//   block of a channel tile (a per-tile counter, reset by that block) adds
//   them in row-tile order, so the result is deterministic.
// - Split-K where the output tiles alone would leave SMs idle (R50 layer 4
//   at 64 images: 25 x 8 tiles): each split writes an f32 partial tile and
//   the last of them adds the partials in split order before the epilogue.
// - Ragged B, H, W, C and Cout: 16-byte loads when C (x) or Cout (w) is a
//   multiple of 8 and the pointer is aligned, a masked scalar path
//   otherwise.
// Not yet: wgmma and TMA; mma.sync reaches only a part of the card's bf16
// peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // K per shared-memory stage
constexpr int NT = 256;  // threads per block: 8 warps, 4 along M x 2 along N
constexpr int LDA = BK + 8;  // pitch of the A stage (bf16)
constexpr int LDB = BN + 8;  // pitch of the B stage (bf16)
constexpr int LDC = BN + 4;  // pitch of the f32 accumulator tile
constexpr int A_CHUNKS = BM * BK / 8 / NT;  // 8-element chunks of A per thread

static_assert(A_CHUNKS * NT * 8 == BM * BK, "A stage splits into whole chunks");
static_assert(BK * BN == NT * 8, "one 8-element chunk of B per thread");
static_assert(NT % BN == 0 && BM % (NT / BN) == 0, "stats: whole row groups per column");

constexpr int STAGES = 3;  // shared-memory stages of the K loop
constexpr int STAGE_A_BYTES = BM * LDA * 2;
constexpr int STAGE_B_BYTES = BK * LDB * 2;
constexpr int STAGES_BYTES = STAGES * (STAGE_A_BYTES + STAGE_B_BYTES);
constexpr int TILE_C_BYTES = BM * LDC * 4;
constexpr int MAIN_BYTES = STAGES_BYTES > TILE_C_BYTES ? STAGES_BYTES : TILE_C_BYTES;
constexpr int SMEM_BYTES = MAIN_BYTES + 2 * NT * 8;  // + the f64 column-sum scratch
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory");

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 8 consecutive elements at p, 16-byte aligned, as 8 bf16.
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
}

// 8 bf16 as raw bits (bf16 itself has constructors, which a union may not hold)
union Chunk {
  uint4 u;
  unsigned short h[8];
};

struct Args {
  const void* x;
  const void* w;
  void* out;
  float* stats;       // (2, N)
  float* ws;          // (splits, M, N) f32 partial tiles; split-K only
  double* partials;   // (2, m_tiles, N) per-block column sums
  int* counters;      // n_tiles (stats), then m_tiles * n_tiles (split-K)
  int H, W, C, N;     // N = Cout
  int M, K;           // M = B*H*W, K = 9*C
  int k_chunk, splits;
  int vec_x, vec_w;
};

// cp.async of 16 bytes from global to shared memory, zero-filled when !pred
// (no bytes are read then; src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 8-element A chunk a thread loads per K tile: pixel m (fixed for the
// block) at k = tap*C + c, walked forward by BK per tile. The tap's offset
// from pixel m, (dy*W + dx)*C, and the taps that stay inside the image (a
// bit each, none past M) are kept, so a tile's load costs a few adds and
// no division.
struct ACursor {
  long long base;  // element offset of pixel m: m * C
  int m, y, x;
  unsigned inside;  // bit tap: the tap's pixel lies in the image
  int k, tap, c, off;
};

__device__ __forceinline__ void a_init(ACursor& q, const Args& a, int m, int k) {
  q.m = m;
  q.x = m % a.W;
  q.y = (m / a.W) % a.H;
  q.base = (long long)m * a.C;
  q.inside = 0;
  if (m < a.M) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      if ((unsigned)(q.y + tap / 3 - 1) < (unsigned)a.H && (unsigned)(q.x + tap % 3 - 1) < (unsigned)a.W)
        q.inside |= 1u << tap;
  }
  q.k = k;
  q.tap = k / a.C;
  q.c = k - q.tap * a.C;
  q.off = ((q.tap / 3 - 1) * a.W + (q.tap % 3 - 1)) * a.C;
}

__device__ __forceinline__ void a_advance(ACursor& q, const Args& a) {
  q.k += BK;
  q.c += BK;
  while (q.c >= a.C) {  // next tap: dx + 1, or dx back to -1 and dy + 1
    q.c -= a.C;
    ++q.tap;
    q.off += (q.tap % 3 == 0 ? a.W - 2 : 1) * a.C;
  }
}

// The vector path's chunk (C % 8 == 0 and k % 8 == 0: it lies in one tap,
// inside K or not): whether it is read, and its element offset in x.
__device__ __forceinline__ bool a_in(const ACursor& q, int k_end) {
  return q.k < k_end && ((q.inside >> q.tap) & 1u);
}
__device__ __forceinline__ long long a_offset(const ACursor& q) { return q.base + q.off + q.c; }

// A chunk: 8 consecutive k of pixel q.m, 0 outside the image, past the
// split's K range, or past M.
template <typename TX>
__device__ __forceinline__ uint4 load_a(const Args& a, const ACursor& q, int k_end) {
  const TX* x = static_cast<const TX*>(a.x);
  Chunk v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  if (a.vec_x) {
    if (a_in(q, k_end)) v.u = load8(x + a_offset(q));
    return v.u;
  }
  if (q.m >= a.M) return v.u;
#pragma unroll
  for (int e = 0; e < 8; ++e) {  // ragged C: a chunk may span taps
    const int kk = q.k + e;
    if (kk >= k_end) break;
    const int tap = kk / a.C;
    const int c = kk - tap * a.C;
    const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
    if ((unsigned)(q.y + dy) < (unsigned)a.H && (unsigned)(q.x + dx) < (unsigned)a.W)
      v.h[e] = __bfloat16_as_ushort(to_bf16(x[((long long)q.m + dy * a.W + dx) * a.C + c]));
  }
  return v.u;
}

__device__ __forceinline__ void copy_a(void* dst, const Args& a, const ACursor& q, int k_end) {
  const bf16* x = static_cast<const bf16*>(a.x);  // the cp.async path is bf16 only
  const bool pred = a_in(q, k_end);
  cp_async16(dst, pred ? x + a_offset(q) : x, pred);
}

// B chunk: w[k, n .. n+8) of w viewed as (K, N), 0 past K, the split's range
// or N; p points at it (valid when k < k_end and n < N).
template <typename TW>
__device__ __forceinline__ uint4 load_b(const Args& a, const TW* p, int k, int n, int k_end) {
  Chunk v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  if (k >= k_end || n >= a.N) return v.u;
  if (a.vec_w) return load8(p);  // N % 8 == 0: n + 8 <= N
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (n + e < a.N) v.h[e] = __bfloat16_as_ushort(to_bf16(p[e]));
  return v.u;
}

template <typename TW>
__device__ __forceinline__ void copy_b(void* dst, const Args& a, const TW* p, int k, int n,
                                       int k_end) {
  const bool pred = k < k_end && n < a.N;
  cp_async16(dst, pred ? static_cast<const void*>(p) : a.w, pred);
}

// ASYNC: bf16 x and w with 16-byte loads, copied by cp.async into a
// STAGES-deep ring. Otherwise each thread loads (and rounds) its chunks into
// registers before a stage's products and stores them after.
template <typename TX, typename TW, bool ASYNC>
__global__ void __launch_bounds__(NT, 2) conv3x3_bn_stats_kernel(const Args a) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int is_last;
  // stage st: A at st * STAGE_A_BYTES, B after the STAGES A stages
  auto As = [&](int st) { return reinterpret_cast<bf16*>(smem + st * STAGE_A_BYTES); };
  auto Bs = [&](int st) {
    return reinterpret_cast<bf16*>(smem + STAGES * STAGE_A_BYTES + st * STAGE_B_BYTES);
  };
  float* const Cs = reinterpret_cast<float*>(smem);  // after the K loop only
  double* const red = reinterpret_cast<double*>(smem + MAIN_BYTES);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * a.k_chunk;
  const int k_end = min(a.K, k_begin + a.k_chunk);
  const int n_k_tiles = (k_end - k_begin + BK - 1) / BK;

  // this thread's A chunks: row idx/4, K offset (idx%4)*8, idx = tid + j*NT;
  // its B chunk: K row tid/8, columns (tid%8)*8
  ACursor qa[A_CHUNKS];
  int a_off[A_CHUNKS];
#pragma unroll
  for (int j = 0; j < A_CHUNKS; ++j) {
    const int idx = tid + j * NT;
    const int r = idx / (BK / 8);
    const int kc = (idx % (BK / 8)) * 8;
    a_off[j] = r * LDA + kc;
    a_init(qa[j], a, m0 + r, k_begin + kc);
  }
  const int b_n = (tid % (BN / 8)) * 8;
  const int b_off = (tid / (BN / 8)) * LDB + b_n;
  int b_kk = k_begin + tid / (BN / 8);  // its K row, walked by BK per tile
  const TW* b_ptr = static_cast<const TW*>(a.w) + (long long)b_kk * a.N + n0 + b_n;
  const long long b_step = (long long)BK * a.N;

  const int warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // warp's 32x32 block of the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[A_CHUNKS], rb;  // the register path's chunks in flight
  // the next K tile (the cursors walk K in order) into registers (register
  // path) or into stage st (cp.async)
  auto fetch = [&](int st) {
    if constexpr (ASYNC) {
#pragma unroll
      for (int j = 0; j < A_CHUNKS; ++j) copy_a(As(st) + a_off[j], a, qa[j], k_end);
      copy_b(Bs(st) + b_off, a, b_ptr, b_kk, n0 + b_n, k_end);
    } else {
#pragma unroll
      for (int j = 0; j < A_CHUNKS; ++j) ra[j] = load_a<TX>(a, qa[j], k_end);
      rb = load_b<TW>(a, b_ptr, b_kk, n0 + b_n, k_end);
    }
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) a_advance(qa[j], a);
    b_kk += BK;
    b_ptr += b_step;
  };
  auto put = [&](int st) {  // register path: the chunks into stage st
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) *reinterpret_cast<uint4*>(As(st) + a_off[j]) = ra[j];
    *reinterpret_cast<uint4*>(Bs(st) + b_off) = rb;
  };

  // prologue: tiles 0 .. STAGES-2 in flight (one commit group each)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_k_tiles) {
      fetch(t);
      if constexpr (!ASYNC) put(t);
    }
    if constexpr (ASYNC) cp_async_commit();
  }

  for (int t = 0; t < n_k_tiles; ++t) {
    const int cur = t % STAGES;
    // tile t has landed (at most STAGES-2 younger groups outstanding), and
    // every warp is done with tile t-1, whose stage the next fetch reuses
    if constexpr (ASYNC) cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    const bool more = next < n_k_tiles;
    if (more) fetch(next % STAGES);
    if constexpr (ASYNC) cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As(cur) + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs(cur) + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if constexpr (!ASYNC) {
      if (more) put(next % STAGES);
    }
  }
  if constexpr (ASYNC) cp_async_wait<0>();
  __syncthreads();

  // the barrier above ordered every read of the stages before Cs reuses them
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  const size_t MN = (size_t)a.M * a.N;
  if (a.splits > 1) {
    // publish this split's partial tile; the last split of the tile adds
    // all of them in split order
    float* part = a.ws + blockIdx.z * MN;
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < a.M && n0 + c < a.N) part[(size_t)(m0 + r) * a.N + n0 + c] = Cs[r * LDC + c];
    }
    __threadfence();
    __syncthreads();
    int* tile_counter = a.counters + gridDim.y + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) is_last = (atomicAdd(tile_counter, 1) == a.splits - 1);
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < a.M && n0 + c < a.N) {
        const size_t off = (size_t)(m0 + r) * a.N + n0 + c;
        float s = 0.f;
        for (int z = 0; z < a.splits; ++z) s += __ldcg(a.ws + z * MN + off);
        Cs[r * LDC + c] = s;
      }
    }
    if (tid == 0) *tile_counter = 0;  // ready for the next launch
    __syncthreads();
  }

  TX* out = static_cast<TX*>(a.out);
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    if (m0 + r < a.M && n0 + c < a.N)
      out[(size_t)(m0 + r) * a.N + n0 + c] = from_f<TX>(Cs[r * LDC + c]);
  }

  // column sums of the f32 accumulator: NT/BN row groups per column, in
  // f64, then added in group order
  constexpr int GROUPS = NT / BN;
  constexpr int GROUP_ROWS = BM / GROUPS;
  const int col = tid % BN, q = tid / BN;
  double s = 0.0, sq = 0.0;
  for (int r = q * GROUP_ROWS; r < (q + 1) * GROUP_ROWS; ++r) {
    if (m0 + r < a.M) {
      const double v = Cs[r * LDC + col];
      s += v;
      sq += v * v;
    }
  }
  red[q * BN + col] = s;
  red[NT + q * BN + col] = sq;
  __syncthreads();
  const size_t plane = (size_t)gridDim.x * a.N;
  if (tid < BN && n0 + tid < a.N) {
    double ps = 0.0, pq = 0.0;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      ps += red[g * BN + tid];
      pq += red[NT + g * BN + tid];
    }
    a.partials[(size_t)blockIdx.x * a.N + n0 + tid] = ps;
    a.partials[plane + (size_t)blockIdx.x * a.N + n0 + tid] = pq;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = (atomicAdd(a.counters + blockIdx.y, 1) == (int)gridDim.x - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block of this channel tile: GROUPS threads per column, each
  // over a contiguous run of row tiles in order, then the runs in order
  const int m_tiles = gridDim.x;
  const int run = (m_tiles + GROUPS - 1) / GROUPS;
  const int z_end = min(m_tiles, (q + 1) * run);
  double ts = 0.0, tq = 0.0;
  if (n0 + col < a.N) {
    const double* ps = a.partials + n0 + col;
#pragma unroll 8
    for (int z = q * run; z < z_end; ++z) {
      ts += __ldcg(ps + (size_t)z * a.N);
      tq += __ldcg(ps + plane + (size_t)z * a.N);
    }
  }
  __syncthreads();  // red is reused
  red[q * BN + col] = ts;
  red[NT + q * BN + col] = tq;
  __syncthreads();
  if (tid < BN && n0 + tid < a.N) {
    double fs = 0.0, fq = 0.0;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      fs += red[g * BN + tid];
      fq += red[NT + g * BN + tid];
    }
    a.stats[n0 + tid] = (float)fs;
    a.stats[a.N + n0 + tid] = (float)fq;
  }
  if (tid == 0) a.counters[blockIdx.y] = 0;  // ready for the next launch
}

template <typename TX, typename TW>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, a.splits);
  if constexpr (std::is_same<TX, bf16>::value && std::is_same<TW, bf16>::value) {
    if (a.vec_x && a.vec_w) {
      conv3x3_bn_stats_kernel<bf16, bf16, true><<<grid, NT, 0, stream>>>(a);
      return static_cast<int>(cudaGetLastError());
    }
  }
  conv3x3_bn_stats_kernel<TX, TW, false><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile sizes the host-side planner must agree with.
int mvgaze_conv_bn_tiles(int* bm, int* bn, int* bk) {
  *bm = BM;
  *bn = BN;
  *bk = BK;
  return 0;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// x_dtype, w_dtype: 0 = float32, 1 = bfloat16 (out has x's). partials holds
// 2 * ceil(M/BM) * Cout doubles; ws, splits * M * Cout floats when splits >
// 1 (else unused); counters ceil(Cout/BN) ints, plus ceil(M/BM) *
// ceil(Cout/BN) when splits > 1, zero on entry and left zero.
int mvgaze_conv3x3_bn_stats(int x_dtype, int w_dtype, const void* x, const void* w, void* out,
                            float* stats, float* ws, double* partials, int* counters, int B,
                            int H, int W, int C, int Cout, int k_chunk, int splits, int vec_x,
                            int vec_w, void* stream) {
  const long long M = (long long)B * H * W;
  const long long K = 9LL * C;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || M >= (1LL << 31) ||
      K >= (1LL << 31) || k_chunk <= 0 || k_chunk % BK != 0 || splits <= 0 ||
      (long long)splits * k_chunk < K || (long long)(splits - 1) * k_chunk >= K ||
      (splits > 1 && ws == nullptr) || (vec_x && C % 8 != 0) || (vec_w && Cout % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, out, stats, ws, partials, counters, H, W, C, Cout, (int)M, (int)K,
               k_chunk, splits, vec_x, vec_w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1) return launch<bf16, bf16>(a, s);
  if (x_dtype == 1 && w_dtype == 0) return launch<bf16, float>(a, s);
  if (x_dtype == 0 && w_dtype == 1) return launch<float, bf16>(a, s);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
