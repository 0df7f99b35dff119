// The s8 wgmma product machinery of the int8 MLP kernels
// (fused_ln_mlp_int8.cu, fused_rms_swiglu_int8.cu): a ring of shared-memory
// stages of 128 reduction bytes under full / empty mbarriers, fed by one
// producer warp with TMA copies in the 128-byte swizzle; two consumer
// warpgroups running s8 wgmma m64nNk32 with both operands K-major; clusters
// of CL blocks on neighbouring row tiles of one column tile, each block
// copying 1 / CL of a stage's B rows and multicasting them to all; a
// persistent grid, a block an SM, walking its cluster's tiles.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace ring {

constexpr int SMEM_LIMIT = 232448;
constexpr int KC = 128;             // reduction bytes a ring stage
constexpr int NC = 256;             // two consumer warpgroups
constexpr int NTHREADS = NC + 32;   // and one producer warp
constexpr int CL = 2;               // blocks a cluster
constexpr int MAX_STAGES = 8;

// A product block's shape: two consumer warpgroups of 64 rows x BNW
// columns, side by side (WN 2: 64 rows, 2 BNW columns) or stacked (WN 1:
// 128 rows, BNW columns); the CL blocks of a cluster take neighbouring row
// tiles of the same columns. A ring of stages, each the A rows then the B
// rows of KC reduction bytes (B in CL parts, one a block, multicast to
// all); EXTRA bytes after the ring, then the barriers.
template <int BNW, int WN, int EXTRA>
struct Ring {
  static constexpr int BM = 128 / WN, BN = BNW * WN;
  static constexpr int A_BYTES = BM * KC, B_BYTES = BN * KC;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int B_PART = BN / CL;   // B rows a block copies
  static constexpr int S0 =
      (SMEM_LIMIT - 1024 - EXTRA - 16 * MAX_STAGES) / STAGE;
  static constexpr int S = S0 < MAX_STAGES ? S0 : MAX_STAGES;
  static constexpr int EXTRA_OFF = S * STAGE;
  static constexpr int BAR_OFF = EXTRA_OFF + EXTRA;
  static constexpr int BYTES = 1024 + BAR_OFF + 16 * S;
  static_assert(S >= 2 && BYTES <= SMEM_LIMIT, "ring");
  static_assert(B_PART <= 256 && B_PART % 8 == 0, "a TMA box's rows");
};

// The tiles of a cluster: a band of CL neighbouring row tiles and one
// column tile. Bands come in groups of `band_group`; inside a group the
// bands change fastest, then the column tile, so that the clusters in
// flight share their column tiles' weights (band_group 1: the column tile
// fastest, sharing the rows). The cluster's tiles are strided over the
// grid's clusters; block `rank` takes row tile CL * band + rank.
struct Walk {
  int n_col, n_band, band_group, n_tiles, cluster, n_clusters, rank;
  template <class R>
  __device__ static Walk make(int M, int n_col, int band_group) {
    const int n_row = (M + R::BM - 1) / R::BM;
    const int n_band = (n_row + CL - 1) / CL;
    return {n_col, n_band, band_group, n_band * n_col,
            static_cast<int>(blockIdx.x) / CL,
            static_cast<int>(gridDim.x) / CL,
            static_cast<int>(wg::cluster_rank())};
  }
  __device__ int band(int p) const {
    const int span = band_group * n_col, first = p / span * band_group;
    const int bg = min(band_group, n_band - first);
    return first + (p - first * n_col) % bg;
  }
  __device__ int col(int p) const {
    const int span = band_group * n_col, first = p / span * band_group;
    const int bg = min(band_group, n_band - first);
    return (p - first * n_col) / bg;
  }
  __device__ int row_tile(int p) const { return band(p) * CL + rank; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f),
                                   127.f));
}

// Where a chunk's B part comes from: this block's part of the stage's B
// rows, read from `map` at row `row`.
struct BPart {
  const CUtensorMap* map;
  int row;
};

// the producer (lane 0 of the last warp): for every tile, `reps` passes of
// nk chunks, each chunk its A rows and this block's part of its B rows
// (b_of(p, pass)) into the ring (the B part into every block of the
// cluster). A stage is refilled once the consumer warps of all CL blocks
// released it: the part this block multicasts lands in all of them.
template <class R, class BOf>
__device__ void produce(const CUtensorMap* ma, unsigned char* smem,
                        uint64_t* full, uint64_t* empty, const Walk& wk,
                        int nk, int reps, BOf b_of) {
  int it = 0;
  for (int p = wk.cluster; p < wk.n_tiles; p += wk.n_clusters) {
    const int m0 = wk.row_tile(p) * R::BM;
    for (int v = 0; v < reps; ++v) {
      const BPart b = b_of(p, v);
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % R::S;
        if (it >= R::S)
          wg::mbar_wait(wg::smem_u32(empty + s), ((it / R::S) & 1) ^ 1);
        const uint32_t bar = wg::smem_u32(full + s);
        const uint32_t dst = wg::smem_u32(smem + s * R::STAGE);
        // the whole stage: own A rows, and every block's B part
        wg::arrive_expect_tx(bar, R::STAGE);
        wg::tma_2d(dst, ma, kc * KC, m0, bar);
        wg::tma_2d_multicast(dst + R::A_BYTES + wk.rank * R::B_PART * KC,
                             b.map, kc * KC, b.row, bar, (1u << CL) - 1);
      }
    }
  }
}

// one chunk of a warpgroup's products: its 64 A rows (wm) against its BNW B
// rows (wn), four k-steps of 32 bytes, into acc (afresh when `fresh`). The
// previous chunk's products complete here, and with `release` its stage is
// released in every block of the cluster (else it was released where its
// sums were read).
template <class R, int BNW>
__device__ __forceinline__ void mma_chunk(uint32_t (&acc)[BNW / 2],
                                          unsigned char* smem,
                                          const uint64_t* full,
                                          const uint64_t* empty, int it,
                                          bool fresh, bool release, int wm,
                                          int wn, int lane) {
  const int s = it % R::S;
  wg::mbar_wait(wg::smem_u32(full + s), (it / R::S) & 1);
  const uint32_t a = wg::smem_u32(smem + s * R::STAGE) + wm * 64 * KC;
  const uint32_t b =
      wg::smem_u32(smem + s * R::STAGE + R::A_BYTES) + wn * BNW * KC;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < KC / 32; ++kk)
    wg::ss_s8<BNW>(acc, wg::kmajor_s8(a, kk), wg::kmajor_s8(b, kk),
                   !fresh || kk > 0);
  wg::commit();
  wg::wait_one();
  const uint32_t bar = wg::smem_u32(empty + (it + R::S - 1) % R::S);
#pragma unroll
  for (int r = 0; r < CL; ++r)
    wg::arrive_cluster_if(bar, r, lane == 0 && release);
}

// every product issued so far complete (the sums in acc may be read); the
// last chunk's stage released
template <class R, int N>
__device__ __forceinline__ void drain(uint32_t (&acc)[N],
                                      const uint64_t* empty, int it,
                                      int lane) {
  wg::wait_all();
  wg::hold(acc);
  const uint32_t bar = wg::smem_u32(empty + (it - 1) % R::S);
#pragma unroll
  for (int r = 0; r < CL; ++r) wg::arrive_cluster_if(bar, r, lane == 0);
}

// the barriers, ready in every block of the cluster before any copy or
// arrival can reach them
template <class R>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < R::S; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), CL * NC / 32);
    }
    wg::mbar_fence_init();
  }
  wg::cluster_sync();
}

// an int8 [rows, inner] row-major matrix read in boxes of [box_rows, KC],
// in the 128-byte swizzle, zero-filled outside
inline bool make_map(CUtensorMap* map, const void* base, int inner,
                     long long rows, int box_rows) {
  return wg::tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, inner,
                           rows, inner, KC, box_rows,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// Bands a group of the Walk at K reduction bytes a row: as many as keep
// their A rows within half of the 50 MB L2 (the tiles in flight then share
// both their A rows and their column tiles' B rows), at least 1.
inline int band_group_for(int bm, int K) {
  const long long band_bytes = static_cast<long long>(CL) * bm * K;
  const long long g = 25000000LL / band_bytes;
  return g < 1 ? 1 : static_cast<int>(g);
}

// a persistent grid of CL-block clusters: as many as the card holds at
// once, or one a cluster tile
template <class K, class... Args>
int launch_clusters(K kernel, int bytes, int n_tiles, cudaStream_t st,
                    Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(sms / CL * CL);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(CL * (n_tiles < clusters ? n_tiles : clusters));
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ring
