// Rotate + concat + GEMM + bias + ReLU, bf16, for Hopper (sm_90a): the
// wgmma + TMA variant of layer 1 of the rotation-constrained feature fuser.
//
//   h[b,:] = relu( [img[b,:] ; (R[b] @ feat[b]).flat] @ W1^T + b1 )
//
// img (B,D), feat (B,3,V) and W1 (H, K=D+3V) bf16; R (B,3,3) and b1 (H) f32;
// h (B,H) bf16. Accumulation is f32; the rotated row is computed in f32 and
// rounded to bf16 before the product, as in csrc/fusion.cu (the generic
// variant, which takes float32 and the shapes this one does not).
//
// Replaces: rot_mvgaze_tpu/ops/fusion.py::_kernel (the Pallas TPU kernel).
//
// Bound on the H100: W1's bytes. At the serving shape (B=64, D=2048, V=512,
// H=K=3584) W1 is 25.7 MB of the call's 26.6 MB: about 7.9 us at 3.35 TB/s,
// against about 1.7 us of bf16 tensor-core work. The kernel has to stream W1
// at memory rate and keep everything else off that path.
//
// What the design does about it:
// - The product runs transposed, h^T = W1 . X^T, so W1's rows are the M side
//   of wgmma (128 per block: two consumer warpgroups of m64) and the batch is
//   N (a tile of 64 or 128 rows). Both operands are K-major bf16 in shared
//   memory with the 128-byte swizzle, 64 K per stage. W1 is used as
//   nn.Linear stores it, (H, K) row-major: no transpose copy exists.
// - Every operand moves by TMA. One producer warp streams W1 into a ring of
//   stages (4 at N = 64: 64 KB of W1 in flight per SM; 3 at N = 128) and,
//   for k < D, img straight into the stage's X tile. A second producer warp
//   streams (N, 3, 64) slabs of feat into a ring of their own, so that they
//   do not queue behind W1. Six rotator warps form the rotated rows from a
//   slab in shared memory, sum_j R[b,seg,j] * feat[b,j,v] in f32 rounded to
//   bf16, into the stage's X tile; no global load sits on their path, and
//   the concat is never materialised. Batch rows past B are zeros (TMA
//   fills out-of-bounds rows with 0). The tensor maps come from
//   cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the build
//   needs no -lcuda. Needs D and V multiples of 64, so that a K step is all
//   image or all one rotation row.
// - Split-K across a thread block cluster (up to 8 blocks per M-tile). Block
//   z takes every S-th image step and every S-th v block of the rotated part
//   (its three rotation rows as three steps on one slab), so the blocks of a
//   cluster share the rotators' work evenly. The consumers keep one step's
//   wgmma in flight while they wait for the next stage.
// - The split-K sum stays on chip: each block leaves its f32 partial in its
//   own shared memory; after a cluster barrier each block sums a slice of
//   the batch rows over the cluster's partials through distributed shared
//   memory, in rank order (deterministic), adds b1, applies ReLU and writes
//   h with 16-byte stores. No f32 workspace and no counters in global
//   memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // W1 rows (output columns) per block
constexpr int BK = 64;   // K per stage: one 128-byte swizzle row of bf16
// warps 0-7 consumers (two warpgroups), 8 the W1/img producer, 9 the feat
// producer, 10-15 rotators
constexpr int NT = 512;
constexpr int kRotators = 192;
constexpr int kMaxCluster = 8;
constexpr int kPitch = BM + 4;  // f32 pitch of the partial tile (bank spread)

template <int N>
struct Cfg {
  static constexpr int kStages = N == 64 ? 4 : 3;
  static constexpr int kFeatSlots = N == 64 ? 3 : 2;
  static constexpr int kWBytes = BM * BK * 2;
  static constexpr int kXBytes = N * BK * 2;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kFeatBytes = 3 * N * BK * 2;  // one step's feat slab, [b][j][v]
  static constexpr int kRotOffset = kRingBytes + kFeatSlots * kFeatBytes;
  static constexpr int kBiasOffset = kRotOffset + N * 9 * 4;
  static constexpr int kBarOffset = kBiasOffset + BM * 4;
  static constexpr int kSmemBytes = kBarOffset + 2 * (kStages + kFeatSlots) * 8 + 1024;
  static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(N * kPitch * 4 <= kRingBytes, "the partial tile reuses the ring");
  static_assert(kSmemBytes <= 232448, "fits an H100 block");
};

struct Args {
  const bf16* img;
  const bf16* feat;
  const float* rot;
  const float* b1;
  bf16* out;
  int B, D, V, H, K;
  int vec_out;    // H % 8 == 0: h rows take 16-byte stores
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c_inner), "r"(c_outer)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::
                   : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// 16 bytes of block `rank`'s shared memory at this block's address `addr`.
// Not ordered against other shared-memory accesses by the compiler: call it
// only between cluster barriers, when no block of the cluster writes.
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

// wgmma descriptor of a K-major bf16 tile with the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO); the tile starts on a
// 1024-byte boundary. Moving along K inside the swizzle row is +32 bytes
// (+2 in the address field) per k16.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint32_t addr = smem_u32(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_prior() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Pins the accumulators at this point of the program, so that the compiler
// moves no access to them across an asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_k16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  wgmma_m64n64k16(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_k16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma_m64n128k16(d, a, b);
}

// The rotators' share of one rotated X tile (N batch rows x BK of K, one
// rotation row `seg`), from the step's feat slab [b][j][v] to the 128-byte
// swizzle: 16-byte chunk c of row r lands at r*128 + ((c ^ (r % 8)) * 16).
template <int N>
__device__ __forceinline__ void build_rotated(const unsigned char* slab, const float* rot_s,
                                              unsigned char* xtile, int seg, int t) {
  for (int idx = t; idx < N * (BK / 8); idx += kRotators) {
    const int row = idx / 8, c = idx % 8;
    const unsigned char* f = slab + (row * 3 * BK + 8 * c) * 2;
    const uint4 raw0 = *reinterpret_cast<const uint4*>(f);
    const uint4 raw1 = *reinterpret_cast<const uint4*>(f + BK * 2);
    const uint4 raw2 = *reinterpret_cast<const uint4*>(f + 2 * BK * 2);
    const float r0 = rot_s[row * 9 + seg * 3], r1 = rot_s[row * 9 + seg * 3 + 1],
                r2 = rot_s[row * 9 + seg * 3 + 2];
    const bf16* f0 = reinterpret_cast<const bf16*>(&raw0);
    const bf16* f1 = reinterpret_cast<const bf16*>(&raw1);
    const bf16* f2 = reinterpret_cast<const bf16*>(&raw2);
    uint4 val;
    bf16* o = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __float2bfloat16_rn(r0 * __bfloat162float(f0[e]) + r1 * __bfloat162float(f1[e]) +
                                 r2 * __bfloat162float(f2[e]));
    *reinterpret_cast<uint4*>(xtile + row * 128 + ((c ^ (row & 7)) << 4)) = val;
  }
}

// Grid (splits, M-tiles, N-tiles), cluster (splits, 1, 1): block z of a
// cluster takes every splits-th image step and every splits-th v block of
// rotated steps, starting at z, of M-tile blockIdx.y for batch tile
// blockIdx.z.
template <int N>
__global__ void __launch_bounds__(NT, 1)
fusion_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap imap,
                    const __grid_constant__ CUtensorMap fmap, const Args a) {
  using C = Cfg<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* feat_ring = smem + C::kRingBytes;
  float* rot_s = reinterpret_cast<float*>(smem + C::kRotOffset);
  float* bias_s = reinterpret_cast<float*>(smem + C::kBiasOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + C::kStages;
  uint64_t* feat_full = empty + C::kStages;
  uint64_t* feat_empty = feat_full + C::kFeatSlots;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * N;
  // K order: block z takes the image steps z, z+S, z+2S, ... (S = splits),
  // then the v blocks z, z+S, ... of the rotated part, each as three steps
  // (rotation rows seg 0, 1, 2 at k = D + seg*V + v0), so that one feat slab
  // [b][j][v0, v0+64) serves three steps, and every block of a cluster gets
  // a like share of image and rotated steps. The product's sum takes the
  // same terms in another fixed order.
  const int z = blockIdx.x, S = gridDim.x;
  const int d_steps = a.D / BK, v_blocks = a.V / BK;
  const int n_img = d_steps > z ? (d_steps - 1 - z) / S + 1 : 0;
  const int n_vb = v_blocks > z ? (v_blocks - 1 - z) / S + 1 : 0;
  const int n_steps = n_img + 3 * n_vb;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1 + kRotators);  // the producer's expect_tx + the rotators
      mbar_init(&empty[s], 256);           // consumer threads
    }
#pragma unroll
    for (int f = 0; f < C::kFeatSlots; ++f) {
      mbar_init(&feat_full[f], 1);
      mbar_init(&feat_empty[f], kRotators);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // W1/img producer: one lane, running up to a ring of stages ahead
    if (tid % 32 == 0) {
      for (int s = 0; s < n_steps; ++s) {
        const int st = s % C::kStages;
        mbar_wait(&empty[st], ((s / C::kStages) & 1) ^ 1);
        unsigned char* wtile = smem + st * C::kStageBytes;
        if (s < n_img) {
          const int k0 = (z + S * s) * BK;
          mbar_arrive_expect_tx(&full[st], C::kWBytes + C::kXBytes);
          tma_load_2d(wtile, &wmap, &full[st], k0, m0);
          tma_load_2d(wtile + C::kWBytes, &imap, &full[st], k0, n0);
        } else {
          const int q = s - n_img, vb = z + S * (q / 3);
          mbar_arrive_expect_tx(&full[st], C::kWBytes);
          tma_load_2d(wtile, &wmap, &full[st], a.D + (q % 3) * a.V + vb * BK, m0);
        }
      }
    }
  } else if (warp == 9) {
    // feat producer: one lane, each slab as soon as a slot is free, so that
    // the slabs do not queue behind W1's loads
    if (tid % 32 == 0) {
      for (int j = 0; j < n_vb; ++j) {
        const int f = j % C::kFeatSlots;
        mbar_wait(&feat_empty[f], ((j / C::kFeatSlots) & 1) ^ 1);
        mbar_arrive_expect_tx(&feat_full[f], C::kFeatBytes);
        tma_load_3d(feat_ring + f * C::kFeatBytes, &fmap, &feat_full[f], (z + S * j) * BK, 0, n0);
      }
    }
  } else if (warp > 9) {
    // rotators: the rotation matrices of the tile's rows and the tile's
    // b1 (for the epilogue), then each rotated step's X tile from its slab
    const int t = tid - 10 * 32;
    for (int i = t; i < N * 9; i += kRotators) {
      const int b = n0 + i / 9;
      rot_s[i] = b < a.B ? a.rot[(size_t)b * 9 + i % 9] : 0.f;
    }
    for (int i = t; i < BM; i += kRotators) bias_s[i] = m0 + i < a.H ? a.b1[m0 + i] : 0.f;
    asm volatile("bar.sync 2, %0;" ::"n"(kRotators) : "memory");
    for (int s = 0; s < n_steps; ++s) {
      const int st = s % C::kStages;
      mbar_wait(&empty[st], ((s / C::kStages) & 1) ^ 1);
      if (s >= n_img) {
        const int q = s - n_img, j = q / 3, seg = q % 3, f = j % C::kFeatSlots;
        if (seg == 0) mbar_wait(&feat_full[f], (j / C::kFeatSlots) & 1);
        build_rotated<N>(feat_ring + f * C::kFeatBytes, rot_s,
                         smem + st * C::kStageBytes + C::kWBytes, seg, t);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // X -> wgmma's proxy
        if (seg == 2) mbar_arrive(&feat_empty[f]);  // the slab's last step
      }
      mbar_arrive(&full[st]);
    }
  } else {
    // consumers: warpgroup wg owns W1 rows 64*wg.. of the tile
    const int wg = warp / 4;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < n_steps; ++s) {
      const int st = s % C::kStages;
      mbar_wait(&full[st], (s / C::kStages) & 1);
      const unsigned char* wtile = smem + st * C::kStageBytes;
      const uint64_t da = desc_sw128(wtile + wg * 64 * 128);
      const uint64_t db = desc_sw128(wtile + C::kWBytes);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_k16<N>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      // this step's products stay in flight; the previous step's are done,
      // and its stage goes back to the producers
      wgmma_wait_prior();
      fence_acc(acc);
      if (s > 0) mbar_arrive(&empty[(s - 1) % C::kStages]);
    }
    wgmma_wait_all();
    fence_acc(acc);
    // Both consumer warpgroups are past every stage, and every stage's X
    // and W1 had landed: the ring is free for the f32 partial,
    // [batch row][W1 row], in this block's shared memory.
    asm volatile("bar.sync 1, 256;" ::: "memory");
    float* part = reinterpret_cast<float*>(smem);
    const int t = tid % 128;
    const int row = wg * 64 + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int col = 8 * i + 2 * (t % 4);
      part[col * kPitch + row] = acc[4 * i];
      part[(col + 1) * kPitch + row] = acc[4 * i + 1];
      part[col * kPitch + row + 8] = acc[4 * i + 2];
      part[(col + 1) * kPitch + row + 8] = acc[4 * i + 3];
    }
  }
  __syncwarp();
  cluster_sync();  // every partial of the cluster is written

  // block `rank` finishes batch rows [rank*rows, +rows) of the tile: the
  // cluster's partials summed in rank order, + b1, ReLU, bf16
  const int rank = static_cast<int>(cluster_rank());
  const int splits = static_cast<int>(cluster_size());
  const int rows = (N + splits - 1) / splits;
  const int b_lo = rank * rows, b_hi = min(N, b_lo + rows);
  const uint32_t part_addr = smem_u32(smem);
  for (int item = tid; item < (b_hi - b_lo) * (BM / 8); item += NT) {
    const int bl = b_lo + item / (BM / 8);
    const int mg = (item % (BM / 8)) * 8;
    const int b = n0 + bl, m = m0 + mg;
    if (b >= a.B || m >= a.H) continue;
    const uint32_t off = part_addr + (uint32_t)(bl * kPitch + mg) * 4;
    // every partial's loads first, then the sums in rank order
    float4 p[kMaxCluster][2];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z)
      if (z < splits) {
        p[z][0] = ld_cluster_f4(off, z);
        p[z][1] = ld_cluster_f4(off + 16, z);
      }
    float s[8] = {p[0][0].x, p[0][0].y, p[0][0].z, p[0][0].w,
                  p[0][1].x, p[0][1].y, p[0][1].z, p[0][1].w};
#pragma unroll
    for (int z = 1; z < kMaxCluster; ++z)
      if (z < splits) {
        const float v[8] = {p[z][0].x, p[z][0].y, p[z][0].z, p[z][0].w,
                            p[z][1].x, p[z][1].y, p[z][1].z, p[z][1].w};
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] += v[e];
      }
    bf16* dst = a.out + (size_t)b * a.H + m;
    if (a.vec_out && m + 8 <= a.H) {
      uint4 o;
      bf16* ob = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int e = 0; e < 8; ++e) ob[e] = __float2bfloat16_rn(fmaxf(s[e] + bias_s[mg + e], 0.f));
      *reinterpret_cast<uint4*>(dst) = o;
    } else {
      for (int e = 0; e < 8 && m + e < a.H; ++e)
        dst[e] = __float2bfloat16_rn(fmaxf(s[e] + bias_s[mg + e], 0.f));
    }
  }
  __syncwarp();
  cluster_sync();  // no block leaves while a peer may still read its partial
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int N>
int launch(const CUtensorMap (&maps)[3], const Args& a, int m_tiles, int n_tiles, int splits,
           cudaStream_t stream) {
  using C = Cfg<N>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fusion_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, m_tiles, n_tiles);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, fusion_wgmma_kernel<N>, maps[0], maps[1], maps[2], a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A bf16 tensor map over `rank` dims (innermost first) with byte strides of
// the outer dims, loading `box` with the given swizzle; false on failure.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Tile sizes the host-side planner must agree with.
int mvgaze_fusion_wgmma_tiles(int* bm, int* bk, int* max_cluster) {
  *bm = BM;
  *bk = BK;
  *max_cluster = kMaxCluster;
  return 0;
}

// Launches on `stream`; returns a cudaError_t (0 = success). bf16 only;
// needs D % 64 == V % 64 == 0 and 16-byte aligned img, feat and w1 (checked
// by the wrapper). n_tile is 64 or 128; splits (1-8) K-splits form one
// cluster per M-tile.
int mvgaze_fusion_wgmma(const void* img, const void* feat, const float* rot, const void* w1,
                        const float* b1, void* out, int B, int D, int V, int H, int n_tile,
                        int splits, void* stream) {
  const int K = D + 3 * V;
  if (B <= 0 || H <= 0 || D <= 0 || V <= 0 || D % BK != 0 || V % BK != 0 || splits < 1 ||
      splits > kMaxCluster || (n_tile != 64 && n_tile != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[3];
  const cuuint64_t w_dims[2] = {(cuuint64_t)K, (cuuint64_t)H};
  const cuuint64_t w_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t w_box[2] = {BK, BM};
  const cuuint64_t i_dims[2] = {(cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t i_strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t i_box[2] = {BK, (cuuint32_t)n_tile};
  const cuuint64_t f_dims[3] = {(cuuint64_t)V, 3, (cuuint64_t)B};
  const cuuint64_t f_strides[2] = {(cuuint64_t)V * 2, (cuuint64_t)V * 6};
  const cuuint32_t f_box[3] = {BK, 3, (cuuint32_t)n_tile};
  if (!encode(fn, &maps[0], w1, 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(fn, &maps[1], img, 2, i_dims, i_strides, i_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(fn, &maps[2], feat, 3, f_dims, f_strides, f_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(img), static_cast<const bf16*>(feat), rot, b1,
               static_cast<bf16*>(out), B, D, V, H, K, H % 8 == 0};
  const int m_tiles = (H + BM - 1) / BM;
  const int n_tiles = (B + n_tile - 1) / n_tile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_tile == 64 ? launch<64>(maps, a, m_tiles, n_tiles, splits, s)
                      : launch<128>(maps, a, m_tiles, n_tiles, splits, s);
}

}  // extern "C"
