// Fused int4 unpack + matmul for decode-shaped calls, for Hopper (sm_90a).
//
// Replaces: procyon_tpu/ops/int4_matmul.py::_kernel ("affine") and
// ::_kernel_dq, both reached through qmatvec4. The two TPU variants compute
// one function and differ only in how they get round Mosaic's missing int8
// vector shift; this one kernel is the counterpart of both.
//
// What it computes. x [rows, k] bf16; p [k/2, n] int8, split-half packed:
// the low nibble of packed row r holds weight row r biased by +8, the high
// nibble holds weight row r + k/2 signed; s [k/group, n] f32 group scales.
//   out[m, c] = sum over groups g of (x[m, g] . q[g, c]) * s[g, c]
// with the products of a group accumulated in f32 and the group's sum
// scaled after the dot, as the affine TPU kernel does. |q| <= 7 is exact in
// bf16, so the tensor-core product of bf16 x with the unpacked nibbles is
// exact up to the f32 accumulation order.
//
// What bounds it on the H100: at 16 rows the packed weights are read once
// (0.5 byte a weight) for 32 flops a byte: far under the ridge, so the
// bound is bytes, and at the narrow shapes (wk / wv: 2.1 MB, 0.7 us at
// 3.35 TB/s) the fixed cost of a launch. What the design does about it:
//   * one launch a call. A block owns NT columns of one row tile over one
//     k slice of whole groups; the S slices of a column tile form one
//     thread-block cluster, which adds its f32 partials through
//     distributed shared memory in slice order (no second kernel, no
//     scratch in device memory, no atomics: the result does not change
//     from run to run);
//   * bytes in flight without registers: one producer warp keeps a ring of
//     STAGES shared-memory stages full with TMA copies (the packed weights
//     [CH rows, NT bytes] in one box, the stage's x tiles of the low and
//     the high half of k, and each group's two scale rows), signalled by
//     mbarriers; rows of x past `rows` arrive as zeros;
//   * NT / 32 consumer warps each own 32 columns and run mma.sync
//     m16n8k16 (with x as wgmma's A, its M of 64 would be three quarters
//     padding at 16 rows; with the roles turned round, see below): a lane
//     reads one 32-bit word (four columns) of packed rows 2t, 2t + 1,
//     2t + 8, 2t + 9 of a k16 step, conflict-free through the TMA's
//     swizzle; byte j of the four words feeds n8 tile j, whose column c
//     stands for physical column 4c + j, so the C fragments of the four
//     tiles hold eight consecutive columns a lane: one 16-byte store. x's
//     A fragments come through ldmatrix from the swizzled x tiles;
//   * nibbles become bf16 with integer ops only: 0x4300 | v is 128 + v in
//     bf16, and one bf16x2 subtraction of 136 removes the bias (the high
//     nibble is first xor-ed with 8, which turns the signed nibble into
//     q + 8);
//   * the wrapper's plan (ops/int4_matmul.plan) picks the row tile (16 or
//     32 rows), NT (128 or 64 columns) and S (1 to 16 slices, a divisor of
//     the groups so that the slices are even; above 8 the cluster is
//     non-portable) from the shapes, so that narrow weights still spread
//     over the card's 132 SMs.
// rows, k, n and the group size are arguments; the last row tile is masked.
// What holds it back (PERF.md section 6): with the products and
// the shared-memory reads taken out, the same TMA ring streams the
// weights clearly faster than the kernel; deeper rings, releasing a
// stage before its arithmetic, two consumer warp sets on alternate groups,
// a biased unpack without the subtraction and wgmma with the roles turned
// round (the nibbles as A in registers, x as B) were each measured and
// were no faster. Fewer k slices stream faster, uneven ones lose.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "wgmma.cuh"

namespace {

constexpr int STAGES = 4;
constexpr int MAX_SLICES = 16;

// two nibble codes v (0..15) in bits 0..3 and 16..19 -> bf16x2 (v - 8)
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t v) {
  uint32_t biased = v | 0x43004300u;              // 128 + v, exact
  const uint32_t off = 0x43084308u;               // 136
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&biased),
                             *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&r);
}

// byte offset `off` of a tile of `rb`-byte rows (32, 64 or 128) as the TMA
// lays it out in the swizzle of the same width: 16-byte chunks xor-ed with
// address bits 7 and up (the tile is 1024-byte aligned)
template <int RB>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (RB / 16 - 1)) << 4);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

constexpr CUtensorMapSwizzle swizzle_of(int rb) {
  return rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
}

// MT: 16-row tiles of a block. NT: columns of a block (64 or 128: one
// TMA box row of NT bytes). CH: packed rows of a stage (64, or 16 for
// groups that are no multiple of 64; it divides the group, so groups start
// at stage boundaries).
template <int MT, int NT, int CH>
struct Layout {
  static constexpr int R = 16 * MT;              // rows of x a block
  static constexpr int WARPS = NT / 32;          // consumer warps
  static constexpr int THREADS = (WARPS + 1) * 32;
  static constexpr int W_BYTES = CH * NT;        // NT-byte rows
  static constexpr int XB = 2 * CH;              // bytes of an x tile row
  static constexpr int X_BYTES = R * XB;
  static constexpr int S_BYTES = 2 * NT * 4;     // a group's two scale rows
  static constexpr int STAGE =
      (W_BYTES + 2 * X_BYTES + S_BYTES + 1023) / 1024 * 1024;
  static constexpr int RED_LD = NT + 4;          // f32 row of the partials
  static constexpr int RED_BYTES = R * RED_LD * 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BODY = RING > RED_BYTES ? RING : RED_BYTES;
  static constexpr int BYTES = 1024 + BODY + 16 * STAGES;
  static_assert(W_BYTES % 1024 == 0 && X_BYTES % 256 == 0, "alignment");
  static_assert(BYTES <= 232448, "shared memory");
};

// out[m0 .. m0 + R, n0 .. n0 + NT) over k slice `blockIdx.x` of
// gridDim.x (the cluster); mw: p as uint8 [k/2, n], boxes [CH, NT]; mx: x
// bf16 [rows, k], boxes [R, CH]; ms: s f32 [k/group, n], boxes [1, NT].
template <int MT, int NT, int CH>
__global__ void __launch_bounds__(Layout<MT, NT, CH>::THREADS)
int4_matmul_kernel(const __grid_constant__ CUtensorMap mw,
                   const __grid_constant__ CUtensorMap mx,
                   const __grid_constant__ CUtensorMap ms,
                   __nv_bfloat16* __restrict__ out, int rows, int k, int n,
                   int group) {
  using L = Layout<MT, NT, CH>;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = wg::aligned_smem(raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BODY);
  uint64_t* empty = full + STAGES;

  const int slices = gridDim.x;
  const int slice = blockIdx.x;                  // the cluster rank
  const int n0 = blockIdx.y * NT;
  const int m0 = blockIdx.z * L::R;
  const int k2 = k >> 1;
  const int n_pg = k2 / group;                   // packed groups
  const int pg0 = static_cast<int>(static_cast<long long>(slice) * n_pg /
                                   slices);
  const int pg1 = static_cast<int>(static_cast<long long>(slice + 1) * n_pg /
                                   slices);
  const int cpg = group / CH;                    // stages a group
  const int n_chunks = (pg1 - pg0) * cpg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), L::WARPS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  float total[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) total[m][j][i] = 0.f;

  if (warp == L::WARPS) {
    // the producer: chunk q's weights, x tiles and (at a group's first
    // chunk) scale rows into stage q % STAGES, once its last use is released
    if (lane == 0) {
      for (int q = 0; q < n_chunks; ++q) {
        const int s = q % STAGES;
        if (q >= STAGES)
          wg::mbar_wait(wg::smem_u32(empty + s), ((q / STAGES) & 1) ^ 1);
        const int pg = pg0 + q / cpg, c = q % cpg;
        const int row0 = pg * group + c * CH;
        const uint32_t bar = wg::smem_u32(full + s);
        const uint32_t dst = wg::smem_u32(smem + s * L::STAGE);
        wg::arrive_expect_tx(
            bar, L::W_BYTES + 2 * L::X_BYTES + (c == 0 ? L::S_BYTES : 0));
        wg::tma_2d(dst, &mw, n0, row0, bar);
        wg::tma_2d(dst + L::W_BYTES, &mx, row0, m0, bar);
        wg::tma_2d(dst + L::W_BYTES + L::X_BYTES, &mx, k2 + row0, m0, bar);
        if (c == 0) {
          const uint32_t sd = dst + L::W_BYTES + 2 * L::X_BYTES;
          wg::tma_2d(sd, &ms, n0, pg, bar);
          wg::tma_2d(sd + NT * 4, &ms, n0, pg + n_pg, bar);
        }
      }
    }
    __syncwarp();
  } else {
    float acc_lo[MT][4][4], acc_hi[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_lo[m][j][i] = acc_hi[m][j][i] = 0.f;
    // a group's scales for the lane's eight columns n0 + 32 warp + 8t ..
    // + 7: fragment value 0 / 2 of tile j is column 8t + j, 1 / 3 is
    // 8t + 4 + j
    float sl[2][4], sh[2][4];
    const int w_col = warp * 32 + 4 * g;          // the lane's word
    const int mi = lane >> 3, mr = lane & 7;      // ldmatrix: matrix, row

    for (int q = 0; q < n_chunks; ++q) {
      const int s = q % STAGES, c = q % cpg;
      wg::mbar_wait(wg::smem_u32(full + s), (q / STAGES) & 1);
      const uint32_t st = wg::smem_u32(smem + s * L::STAGE);
      const uint32_t xlo = st + L::W_BYTES, xhi = xlo + L::X_BYTES;
      if (c == 0) {
        const uint32_t sp = xhi + L::X_BYTES + (warp * 32 + 8 * t) * 4;
        const float4 l0 = lds_f4(sp), l1 = lds_f4(sp + 16);
        const float4 h0 = lds_f4(sp + NT * 4), h1 = lds_f4(sp + NT * 4 + 16);
        sl[0][0] = l0.x; sl[0][1] = l0.y; sl[0][2] = l0.z; sl[0][3] = l0.w;
        sl[1][0] = l1.x; sl[1][1] = l1.y; sl[1][2] = l1.z; sl[1][3] = l1.w;
        sh[0][0] = h0.x; sh[0][1] = h0.y; sh[0][2] = h0.z; sh[0][3] = h0.w;
        sh[1][0] = h1.x; sh[1][1] = h1.y; sh[1][2] = h1.z; sh[1][3] = h1.w;
      }
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
        const int r0 = 16 * kk + 2 * t;
        uint32_t w[4];
        w[0] = lds32(st + swz<NT>(r0 * NT + w_col));
        w[1] = lds32(st + swz<NT>((r0 + 1) * NT + w_col));
        w[2] = lds32(st + swz<NT>((r0 + 8) * NT + w_col));
        w[3] = lds32(st + swz<NT>((r0 + 9) * NT + w_col));
        uint32_t a_lo[MT][4], a_hi[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int row = 16 * m + (mi & 1) * 8 + mr;
          const uint32_t off =
              swz<L::XB>(row * L::XB + (16 * kk + (mi >> 1) * 8) * 2);
          wg::ldsm_x4(a_lo[m], xlo + off);
          wg::ldsm_x4(a_hi[m], xhi + off);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // byte j of rows 2t, 2t + 1 (and 2t + 8, 2t + 9) in bits 0..7
          // and 16..23
          const uint32_t sel =
              j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
          const uint32_t b01 = __byte_perm(w[0], w[1], sel);
          const uint32_t b23 = __byte_perm(w[2], w[3], sel);
          const uint32_t lo0 = codes_to_bf16x2(b01 & 0x000F000Fu);
          const uint32_t lo1 = codes_to_bf16x2(b23 & 0x000F000Fu);
          const uint32_t hi0 =
              codes_to_bf16x2(((b01 >> 4) & 0x000F000Fu) ^ 0x00080008u);
          const uint32_t hi1 =
              codes_to_bf16x2(((b23 >> 4) & 0x000F000Fu) ^ 0x00080008u);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            wg::mma16816(acc_lo[m][j], a_lo[m], lo0, lo1);
            wg::mma16816(acc_hi[m][j], a_hi[m], hi0, hi1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(wg::smem_u32(empty + s));
      if (c + 1 < cpg) continue;
      // the group is complete: scale its two dots and add them
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            total[m][j][i] += acc_lo[m][j][i] * sl[i & 1][j] +
                              acc_hi[m][j][i] * sh[i & 1][j];
            acc_lo[m][j][i] = acc_hi[m][j][i] = 0.f;
          }
    }
  }

  const int col = warp * 32 + 8 * t;
  if (slices == 1) {
    if (warp == L::WARPS) return;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 16 * m + g + 8 * h;
        if (r >= rows) continue;
        const int i0 = 2 * h;
        uint4 v;
        v.x = wg::pack_bf16(total[m][0][i0], total[m][1][i0]);
        v.y = wg::pack_bf16(total[m][2][i0], total[m][3][i0]);
        v.z = wg::pack_bf16(total[m][0][i0 + 1], total[m][1][i0 + 1]);
        v.w = wg::pack_bf16(total[m][2][i0 + 1], total[m][3][i0 + 1]);
        *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * n + n0 +
                                  col) = v;
      }
    return;
  }

  // every copy has landed and been read: the ring takes the partials
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (warp < L::WARPS) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i0 = 2 * h;
        float* dst = red + (16 * m + g + 8 * h) * L::RED_LD + col;
        *reinterpret_cast<float4*>(dst) =
            make_float4(total[m][0][i0], total[m][1][i0], total[m][2][i0],
                        total[m][3][i0]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(total[m][0][i0 + 1], total[m][1][i0 + 1],
                        total[m][2][i0 + 1], total[m][3][i0 + 1]);
      }
  }
  wg::cluster_sync();
  // block `slice` adds every slice's partials, in slice order, for its
  // share of the tile's 8-column units
  constexpr int UNITS = L::R * NT / 8;
  for (int u = slice + slices * static_cast<int>(threadIdx.x); u < UNITS;
       u += slices * L::THREADS) {
    const int row = u / (NT / 8), cu = u % (NT / 8);
    if (m0 + row >= rows) continue;
    const uint32_t at = wg::smem_u32(red + row * L::RED_LD + cu * 8);
    float4 a = wg::ld_cluster_f4(at, 0), b = wg::ld_cluster_f4(at + 16, 0);
    for (int r = 1; r < slices; ++r) {
      const float4 c = wg::ld_cluster_f4(at, r);
      const float4 d = wg::ld_cluster_f4(at + 16, r);
      a.x += c.x; a.y += c.y; a.z += c.z; a.w += c.w;
      b.x += d.x; b.y += d.y; b.z += d.z; b.w += d.w;
    }
    uint4 v;
    v.x = wg::pack_bf16(a.x, a.y);
    v.y = wg::pack_bf16(a.z, a.w);
    v.z = wg::pack_bf16(b.x, b.y);
    v.w = wg::pack_bf16(b.z, b.w);
    *reinterpret_cast<uint4*>(out + static_cast<long long>(m0 + row) * n +
                              n0 + cu * 8) = v;
  }
  wg::cluster_sync();    // no block leaves while another reads its partials
}

// The tensor maps of p and s, which are a layer's weights and the same
// from call to call: encoded once for each address and layout, and kept in
// a direct-mapped table (a map holds nothing but these, so memory reused at
// one address with one layout rightly reuses its map). x's map is encoded
// at every call.
struct WeightMaps {
  const void* p;
  const void* s;
  long long n, k, group, ldp, lds;
  int nt, ch;
  CUtensorMap mw, ms;
};
constexpr int MAP_SLOTS = 1024;
WeightMaps weight_map_table[MAP_SLOTS];
std::mutex weight_map_lock;

template <int NT, int CH>
bool weight_maps(CUtensorMap* mw, CUtensorMap* ms, const void* p,
                 const void* s, int k, int n, int group, long long ldp,
                 long long lds) {
  const uint64_t h = (reinterpret_cast<uintptr_t>(p) ^
                      (reinterpret_cast<uintptr_t>(s) << 1) ^ NT ^ CH) *
                     0x9E3779B97F4A7C15ull;
  WeightMaps& e = weight_map_table[h >> 54];
  std::lock_guard<std::mutex> guard(weight_map_lock);
  if (e.p != p || e.s != s || e.n != n || e.k != k || e.group != group ||
      e.ldp != ldp || e.lds != lds || e.nt != NT || e.ch != CH) {
    e.p = nullptr;
    if (!wg::tensor_map_2d(&e.mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, p, n, k / 2,
                           ldp, NT, CH, swizzle_of(NT)) ||
        !wg::tensor_map_2d(&e.ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, n,
                           k / group, lds * 4, NT, 1,
                           CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
    e.s = s;
    e.n = n;
    e.k = k;
    e.group = group;
    e.ldp = ldp;
    e.lds = lds;
    e.nt = NT;
    e.ch = CH;
    e.p = p;
  }
  *mw = e.mw;
  *ms = e.ms;
  return true;
}

template <int MT, int NT, int CH>
int launch(const void* x, const void* p, const void* s, void* out, int rows,
           int k, int n, int group, long long ldx, long long ldp,
           long long lds, int slices, cudaStream_t st) {
  using L = Layout<MT, NT, CH>;
  CUtensorMap mw, mx, ms;
  if (!weight_maps<NT, CH>(&mw, &ms, p, s, k, n, group, ldp, lds) ||
      !wg::tensor_map_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, rows,
                         ldx * 2, CH, L::R, swizzle_of(L::XB)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int4_matmul_kernel<MT, NT, CH>;
  cudaError_t err = wg::set_attributes_once(
      reinterpret_cast<const void*>(kernel), L::BYTES, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = slices;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, n / NT, (rows + L::R - 1) / L::R);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mw, mx, ms,
                           static_cast<__nv_bfloat16*>(out), rows, k, n,
                           group);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, int NT>
int launch_ch(const void* x, const void* p, const void* s, void* out,
              int rows, int k, int n, int group, long long ldx, long long ldp,
              long long lds, int slices, cudaStream_t st) {
  return group % 64 == 0
             ? launch<MT, NT, 64>(x, p, s, out, rows, k, n, group, ldx, ldp,
                                  lds, slices, st)
             : launch<MT, NT, 16>(x, p, s, out, rows, k, n, group, ldx, ldp,
                                  lds, slices, st);
}

}  // namespace

// x [rows, k] bf16 (row stride ldx elements, a multiple of 8; 16-byte
// aligned), p [k/2, n] int8 (row stride ldp, a multiple of 16; 16-byte
// aligned), s [k/group, n] f32 (row stride lds, a multiple of 4; 16-byte
// aligned), out [rows, n] bf16 contiguous. The grid: row tiles of
// row_tile (16 or 32) rows, column tiles of col_tile (64 or 128) columns,
// each cut into `slices` k slices of whole groups (1 to 16, at most the
// k/2 / group packed groups), the slices of a tile one cluster.
// The group size is a multiple of 16 that divides k/2. Returns
// cudaGetLastError() after the one launch.
extern "C" int int4_matmul(const void* x, const void* p, const void* s,
                           void* out, int rows, int k, int n, int group,
                           long long ldx, long long ldp, long long lds,
                           int row_tile, int col_tile, int slices,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(p) |
       reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(out)) %
          16 == 0;
  if (rows <= 0 || k <= 0 || group <= 0 || group % 16 || (k / 2) % group ||
      k % 2 || n <= 0 || ldx % 8 || ldp % 16 || lds % 4 || !aligned ||
      (col_tile != 64 && col_tile != 128) ||
      n % col_tile || (row_tile != 16 && row_tile != 32) || slices < 1 ||
      slices > MAX_SLICES || slices > k / 2 / group)
    return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(MT, NT)                                                      \
  return launch_ch<MT, NT>(x, p, s, out, rows, k, n, group, ldx, ldp, lds, \
                           slices, st)
  if (row_tile == 16) {
    if (col_tile == 64) LAUNCH(1, 64);
    LAUNCH(1, 128);
  }
  if (col_tile == 64) LAUNCH(2, 64);
  LAUNCH(2, 128);
#undef LAUNCH
}
