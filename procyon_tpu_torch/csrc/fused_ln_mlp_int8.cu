// Fused LayerNorm -> int8 W1 -> GELU -> int8 W2 MLP (+ residual), and its
// two-pass form, for Hopper (sm_90a).
//
// Replaces three TPU kernels of procyon_tpu/ops/fused_mlp.py:
//   _kernel (through fused_ln_mlp_int8 -> _call): the one-pass MLP, here
//     the row pass, then the up and down kernels below, from one entry;
//   _ln_quant_kernel (through ln_quant_rows_pallas): steps 1-2 alone,
//     int8 rows and their f32 scale to device memory (ln_quant_rows_kernel);
//   _kernel_pq (through fused_mlp_int8_prequant): steps 3-4 on those rows,
//     without the residual (the caller adds it after the cast), with its
//     own group rule (the wrapper's prequant_group: block_n from 512).
// Numerics, step for step as the TPU kernel:
//   1. LayerNorm in f32: var = mean((x-mean)^2), rsqrt(var+eps), affine;
//   2. sx = max(amax, 1e-8)/127, xq = clip(rint(h / sx), -127, 127);
//   3. s8 x s8 -> s32 product with W1; h1 = acc * (sx * s1) + b1;
//      g = 0.5 h1 (1 + tanh(0.851 h1)); per (row, G columns) sg =
//      max(amax, 1e-8)/127, gq = clip(rint(g / sg), -127, 127), where G is
//      the wrapper's requantization group (the reference's block_n /
//      sub_tiles rule: numerics, not tuning);
//   4. per group the s8 x s8 -> s32 product of gq with W2's G rows, part =
//      acc2 * (sg * s2) in f32; the SPG groups of one block_n step summed in
//      order, then added to the accumulator (the reference's order of sums);
//      + b2, + x in f32 when add_residual (one-pass form), cast to bf16.
// Rounding is half to even (rintf), divisions are IEEE, and products and
// sums that the reference rounds separately are kept apart (__fmul_rn /
// __fadd_rn) so that no FMA contraction moves a rounding tie.
//
// What bounds it on the H100: int8 operations. At ESM2-650M (M = 32768
// rows, d = 1280, H = 5120) the two products are 4 M d H = 859 G int8
// operations against about 0.2 GB of x, out and weights: 0.434 ms at
// 1,979 TOP/s. Only wgmma reaches that rate (mma.sync m16n8k32, this file's
// first kernel, ran at 7.6% of it).
//
// The design. A wgmma tile of 64 rows cannot keep the one-pass kernel's
// [rows, d] f32 accumulator (327 KB at d 1280) in a block's shared memory
// or registers, so the MLP is three launches on one stream, no atomics:
//   row pass (ln_quant_rows_kernel): a warp a row, rows streamed through
//     a ring in shared memory ahead of it, xq int8 [M, d] and sx;
//   up (mlp_up_kernel): gq int8 [M, H] and sg f32 [M, H / G]. A block owns
//     one requantization group of G columns for 64 or 128 rows: two
//     consumer warpgroups of 64 rows x 256 columns side by side at G 512
//     (the group's row amax meets in shared memory), stacked at G 256 and
//     128 (a warpgroup's row amax is its own quad's). The epilogue turns
//     the s32 sums into GELU values in the same registers, then codes;
//   down (mlp_down_kernel): a block owns 128 rows x 128 output columns and
//     walks H; the groups of a block_n step go to their own s32 sums, so
//     the products drain once a step; then the groups' parts are summed in
//     order and added to the accumulator, which waits in shared memory, a
//     thread's own 64 values.
// Both product kernels (on the ring of int8_ring.cuh, which the RMSNorm +
// W8A8 SwiGLU kernels share): s8 wgmma m64nNk32 (N 256 or 128) with both
// operands K-major in shared memory, read through TMA in the 128-byte
// swizzle (the weights as [out, in] copies, which the ESM2 serving layout
// keeps, the codes as they lie), a ring of stages of 128 reduction bytes
// under full / empty mbarriers fed by one producer warp; clusters of two
// blocks on neighbouring row tiles, each block copying half of a stage's
// weight rows and multicasting it to both; a persistent grid, a block an
// SM, walking its tiles with the producer running ahead into the next tile
// while the consumers work an epilogue. Rows beyond M and columns beyond d
// are zero-filled by TMA and never stored, so M needs no padding. The
// hidden codes go to device memory (2 x 168 MB a layer at ESM2-650M), which
// the TPU kernel avoids.
// What holds it back (PERF.md section 6): the up kernel's epilogue (an IEEE
// tanh and division a hidden value, and the codes' stores) takes most of
// its time and overlaps none of its products; the down kernel's N 128
// products stay well under the up kernel's rate even without drains. A
// producer warp costs a warpgroup's registers (ptxas allots 168 a thread
// at 288 threads), which leaves room for two sets of sums and no more;
// scaling one set while the next group's products run made ptxas
// serialize every wgmma (C7514).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_ring.cuh"

namespace {

using namespace ring;

constexpr int SLAB = 64 * NC * 4;   // the down kernel's f32 accumulator

// The up kernel: gq = codes(GELU(xq W1 * (sx s1) + b1)) and sg, for one
// group of G = BNW * WN columns a tile. xq int8 [M, d] and w1t int8 [H, d]
// through their tensor maps; sx f32 [M]; s1, b1 f32 [H]; gq int8 [M, H];
// sg f32 [M, H / G].
template <int BNW, int WN>
__global__ void __launch_bounds__(NTHREADS, 1)
mlp_up_kernel(const __grid_constant__ CUtensorMap mx,
              const __grid_constant__ CUtensorMap mw,
              const float* __restrict__ sx, const float* __restrict__ s1,
              const float* __restrict__ b1, int8_t* __restrict__ gq,
              float* __restrict__ sg, int M, int d, int H) {
  using R = Ring<BNW, WN, WN == 2 ? 1024 : 0>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BAR_OFF);
  uint64_t* empty = full + R::S;
  const int nk = (d + KC - 1) / KC, n_col = H / R::BN;
  const Walk wk = Walk::make<R>(M, n_col, 1);
  init_ring<R>(full, empty);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == NC / 32) {
    if (lane == 0)
      produce<R>(&mx, smem, full, empty, wk, nk, 1, [&](int p, int) {
        return BPart{&mw, wk.col(p) * R::BN + wk.rank * R::B_PART};
      });
  } else {
    const int w = warp >> 2, wm = WN == 1 ? w : 0, wn = WN == 1 ? 0 : w;
    const int g = lane >> 2, t = lane & 3;
    const int rl = wm * 64 + (warp & 3) * 16 + g;   // and rl + 8
    // the side-by-side warpgroups' row amax, [tile parity][wn][64 rows]
    float* red = reinterpret_cast<float*>(smem + R::EXTRA_OFF);
    uint32_t acc[BNW / 2];
#pragma unroll
    for (int i = 0; i < BNW / 2; ++i) acc[i] = 0u;
    int it = 0, parity = 0;
    for (int p = wk.cluster; p < wk.n_tiles;
         p += wk.n_clusters, parity ^= 1) {
      const int m0 = wk.row_tile(p) * R::BM, grp = wk.col(p);
      for (int kc = 0; kc < nk; ++kc, ++it)
        mma_chunk<R, BNW>(acc, smem, full, empty, it, kc == 0, kc > 0, wm,
                          wn, lane);
      drain<R>(acc, empty, it, lane);

      // rescale, bias, GELU (kept as f32 bits in acc), the rows' amax
      const long long r0 = m0 + rl;
      const float sx0 = r0 < M ? sx[r0] : 0.f;
      const float sx1 = r0 + 8 < M ? sx[r0 + 8] : 0.f;
      const int c0 = grp * R::BN + wn * BNW + 2 * t;
      float amax[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BNW / 8; ++j) {
        const float2 sc =
            __ldg(reinterpret_cast<const float2*>(s1 + c0 + 8 * j));
        const float2 bi =
            __ldg(reinterpret_cast<const float2*>(b1 + c0 + 8 * j));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h1 = __fadd_rn(
              __fmul_rn(static_cast<float>(static_cast<int>(acc[4 * j + e])),
                        __fmul_rn(e < 2 ? sx0 : sx1, (e & 1) ? sc.y : sc.x)),
              (e & 1) ? bi.y : bi.x);
          const float gl =
              __fmul_rn(__fmul_rn(0.5f, h1),
                        __fadd_rn(1.f, tanhf(__fmul_rn(0.851f, h1))));
          acc[4 * j + e] = __float_as_uint(gl);
          amax[e >> 1] = fmaxf(amax[e >> 1], fabsf(gl));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 1));
        amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 2));
      }
      if constexpr (WN == 2) {
        // the other warpgroup's half of the group (a max: order-free);
        // two buffers, so a warpgroup a tile ahead cannot overwrite what
        // the other still reads
        float* rd = red + parity * 128;
        if (t == 0) {
          rd[wn * 64 + rl] = amax[0];
          rd[wn * 64 + rl + 8] = amax[1];
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
        amax[0] = fmaxf(amax[0], rd[(wn ^ 1) * 64 + rl]);
        amax[1] = fmaxf(amax[1], rd[(wn ^ 1) * 64 + rl + 8]);
      }
      float scale[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        scale[r] = __fmul_rn(fmaxf(amax[r], 1e-8f), 1.0f / 127.0f);
        if (t == 0 && wn == 0 && r0 + 8 * r < M)
          sg[(r0 + 8 * r) * n_col + grp] = scale[r];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r0 + 8 * r >= M) continue;
        int8_t* dst = gq + (r0 + 8 * r) * H + c0;
#pragma unroll
        for (int j = 0; j < BNW / 8; ++j) {
          char2 pair;
          pair.x = quant(__uint_as_float(acc[4 * j + 2 * r]), scale[r]);
          pair.y = quant(__uint_as_float(acc[4 * j + 2 * r + 1]), scale[r]);
          *reinterpret_cast<char2*>(dst + 8 * j) = pair;
        }
      }
    }
  }
  // no block leaves while a copy or an arrival of another may reach it
  wg::cluster_sync();
}

// The down kernel: out = bf16(acc + b2 (+ x)) for 128 rows x 128 columns a
// tile, over the H / G groups of G = CPG * KC codes in the reference's
// order. The SPG groups of a block_n step go to SPG sets of s32 sums, so
// the products drain once a step, not once a group; then each group's part
// (sums * (sg * s2)) is summed in order and added to the accumulator, which
// waits in shared memory (a thread's own 64 values). gq int8 [M, H] and
// w2t int8 [d, H] through their tensor maps; sg f32 [M, H / G]; s2, b2 f32
// [d]; xres bf16 [M, d] or null; out bf16 [M, d].
template <int CPG, int SPG>
__global__ void __launch_bounds__(NTHREADS, 1)
mlp_down_kernel(const __grid_constant__ CUtensorMap mg,
                const __grid_constant__ CUtensorMap mw,
                const float* __restrict__ sg, const float* __restrict__ s2,
                const float* __restrict__ b2,
                const __nv_bfloat16* __restrict__ xres,
                __nv_bfloat16* __restrict__ out, int M, int d, int H) {
  using R = Ring<128, 1, SLAB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BAR_OFF);
  uint64_t* empty = full + R::S;
  const int nk = H / KC, n_groups = H / (CPG * KC);
  const int n_col = (d + R::BN - 1) / R::BN;
  const Walk wk = Walk::make<R>(M, n_col, 1);
  init_ring<R>(full, empty);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == NC / 32) {
    if (lane == 0)
      produce<R>(&mg, smem, full, empty, wk, nk, 1, [&](int p, int) {
        return BPart{&mw, wk.col(p) * R::BN + wk.rank * R::B_PART};
      });
  } else {
    const int w = warp >> 2, ct = threadIdx.x;
    const int g = lane >> 2, t = lane & 3;
    const int rl = w * 64 + (warp & 3) * 16 + g;   // and rl + 8
    // a thread's 64 accumulators, element i at slab[i * NC + ct]
    float* slab = reinterpret_cast<float*>(smem + R::EXTRA_OFF);
    uint32_t acc[SPG][64];
#pragma unroll
    for (int q = 0; q < SPG; ++q)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[q][i] = 0u;
    int it = 0;
    for (int p = wk.cluster; p < wk.n_tiles; p += wk.n_clusters) {
      const long long r0 = static_cast<long long>(wk.row_tile(p)) * R::BM +
                           rl;
      const int c0 = wk.col(p) * R::BN + 2 * t;
      for (int grp = 0; grp < n_groups; grp += SPG) {
#pragma unroll
        for (int q = 0; q < SPG; ++q)
#pragma unroll
          for (int c = 0; c < CPG; ++c, ++it)
            mma_chunk<R, 128>(acc[q], smem, full, empty, it, c == 0,
                              q > 0 || c > 0, w, 0, lane);
        drain<R>(acc[SPG - 1], empty, it, lane);
#pragma unroll
        for (int q = 0; q < SPG - 1; ++q) wg::hold(acc[q]);
        float gs[SPG][2];
#pragma unroll
        for (int q = 0; q < SPG; ++q) {
          gs[q][0] = r0 < M ? sg[r0 * n_groups + grp + q] : 0.f;
          gs[q][1] = r0 + 8 < M ? sg[(r0 + 8) * n_groups + grp + q] : 0.f;
        }
        const bool first = grp == 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c0 + 8 * j;
          const float2 sc = col < d
              ? __ldg(reinterpret_cast<const float2*>(s2 + col))
              : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float total = 0.f;
#pragma unroll
            for (int q = 0; q < SPG; ++q) {
              const float part = __fmul_rn(
                  static_cast<float>(static_cast<int>(acc[q][i])),
                  __fmul_rn(gs[q][e >> 1], (e & 1) ? sc.y : sc.x));
              total = q == 0 ? part : __fadd_rn(total, part);
            }
            slab[i * NC + ct] =
                __fadd_rn(first ? 0.f : slab[i * NC + ct], total);
          }
        }
      }
      // + b2, + the residual, cast
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * j;
        if (col >= d) continue;
        const float2 bi = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r0 + 8 * r;
          if (row >= M) continue;
          float o0 = __fadd_rn(slab[(4 * j + 2 * r) * NC + ct], bi.x);
          float o1 = __fadd_rn(slab[(4 * j + 2 * r + 1) * NC + ct], bi.y);
          if (xres != nullptr) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                xres + row * d + col);
            o0 = __fadd_rn(o0, __low2float(xv));
            o1 = __fadd_rn(o1, __high2float(xv));
          }
          *reinterpret_cast<__nv_bfloat162*>(out + row * d + col) =
              __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
  wg::cluster_sync();
}

template <int BNW, int WN>
int launch_up(const int8_t* xq, const float* sx, const int8_t* w1t,
              const float* s1, const float* b1, int8_t* gq, float* sg, int M,
              int d, int H, cudaStream_t st) {
  using R = Ring<BNW, WN, WN == 2 ? 1024 : 0>;
  CUtensorMap mx, mw;
  if (!make_map(&mx, xq, d, M, R::BM) ||
      !make_map(&mw, w1t, d, H, R::B_PART))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_row = (M + R::BM - 1) / R::BM;
  return launch_clusters(mlp_up_kernel<BNW, WN>, R::BYTES,
                         (n_row + CL - 1) / CL * (H / R::BN), st, mx, mw, sx,
                         s1, b1, gq, sg, M, d, H);
}

template <int CPG, int SPG>
int launch_down(const int8_t* gq, const float* sg, const int8_t* w2t,
                const float* s2, const float* b2, const __nv_bfloat16* xres,
                __nv_bfloat16* out, int M, int d, int H, cudaStream_t st) {
  using R = Ring<128, 1, SLAB>;
  CUtensorMap mg, mw;
  if (!make_map(&mg, gq, H, M, R::BM) || !make_map(&mw, w2t, H, d, R::B_PART))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_row = (M + R::BM - 1) / R::BM;
  return launch_clusters(mlp_down_kernel<CPG, SPG>, R::BYTES,
                         (n_row + CL - 1) / CL * ((d + R::BN - 1) / R::BN),
                         st, mg, mw, sg, s2, b2, xres, out, M, d, H);
}

// steps 3-4 from the int8 rows: the up kernel, then the down kernel
int mlp_on_codes(const void* xq, const void* sx, const void* w1t,
                 const void* s1, const void* b1, const void* w2t,
                 const void* s2, const void* b2, const void* xres, void* gq,
                 void* sg, void* out, int M, int d, int H, int G, int SPG,
                 cudaStream_t st) {
  // (G, SPG): what requant_group and prequant_group give
  const bool groups = (G == 512 && SPG == 2) || (G == 256 && SPG == 2) ||
                      (G == 128 && (SPG == 1 || SPG == 2));
  if (M <= 0 || d <= 0 || d % 64 || H <= 0 || !groups || H % (G * SPG))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* sxf = static_cast<const float*>(sx);
  const int8_t* w1 = static_cast<const int8_t*>(w1t);
  const float* s1f = static_cast<const float*>(s1);
  const float* b1f = static_cast<const float*>(b1);
  int8_t* g8 = static_cast<int8_t*>(gq);
  float* sgf = static_cast<float*>(sg);
  int err;
  switch (G) {
    case 512: err = launch_up<256, 2>(x8, sxf, w1, s1f, b1f, g8, sgf, M, d, H, st); break;
    case 256: err = launch_up<256, 1>(x8, sxf, w1, s1f, b1f, g8, sgf, M, d, H, st); break;
    case 128: err = launch_up<128, 1>(x8, sxf, w1, s1f, b1f, g8, sgf, M, d, H, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  const int8_t* w2 = static_cast<const int8_t*>(w2t);
  const float* s2f = static_cast<const float*>(s2);
  const float* b2f = static_cast<const float*>(b2);
  const __nv_bfloat16* xr = static_cast<const __nv_bfloat16*>(xres);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (G == 512) return launch_down<4, 2>(g8, sgf, w2, s2f, b2f, xr, o, M, d, H, st);
  if (G == 256) return launch_down<2, 2>(g8, sgf, w2, s2f, b2f, xr, o, M, d, H, st);
  if (SPG == 2) return launch_down<1, 2>(g8, sgf, w2, s2f, b2f, xr, o, M, d, H, st);
  return launch_down<1, 1>(g8, sgf, w2, s2f, b2f, xr, o, M, d, H, st);
}

// The row pass (ln_quant_rows_kernel): LayerNorm and per-row int8 codes,
// xq int8 [M, d] and sx f32 [M]. What bounds it on the H100: bytes (2 d
// read and d written a row: 0.075 ms at M 32768, d 2560), with arithmetic
// of about the same length beside them. Its first version (a warp a row,
// h computed twice, an IEEE division a code, a one-shot grid) ran at 45% of
// that bound. This design overlaps the bytes with the arithmetic and cuts
// the arithmetic (PERF.md section 6 has the variants measured):
//   * a block of T threads owns a row at a time: thread t holds the row's
//     16-byte column vectors t, t + T, ... (V <= 5 of them; T the fewest
//     warps that hold the row so), with the LayerNorm weight and bias of
//     those columns in registers for the whole grid walk. A warp a row
//     would need them again for every row (8 bytes an element through the
//     L1, which took more time than the rows' own bytes), and more rows a
//     block spread the statistics' fixed cost over fewer values;
//   * a persistent grid; each block walks rows strided over the grid, a
//     ring of 3 rows in shared memory ahead of it, one bulk copy
//     (cp.async.bulk) a row completing on the slot's mbarrier; a slot is
//     refilled as soon as every thread holds its values, so the next rows'
//     bytes arrive while the block works;
//   * the values are read from shared memory once, into f32 registers,
//     centred in place and turned into h once; each statistic meets in one
//     block reduction (a warp's butterfly, then the warps in order);
//   * a code is rint(h r), r = 1 / s rounded, from one fma with 1.5 2^23
//     and one fma for its distance from the tie; where some h r of a
//     vector lies within 2^-14 of a rounding tie (or is no number), the
//     vector's codes are recomputed with the IEEE division, so every code
//     is clip(rint(h / s)) bit for bit (h r lies under 2^-16 from h / s,
//     and the division's rounding adds under 2^-17);
//   * a thread's 8 codes of a vector go out as one 8-byte store, a warp's
//     store 256 contiguous bytes.
// The statistics use the first version's operations (f32 sums, __fdiv_rn,
// __frsqrt_rn, __fmul_rn / __fadd_rn without FMA contraction) in another
// order of summation.
constexpr int ROW_SLOTS = 3;
constexpr int ROW_MAX_V = 5;
constexpr int ROW_MAX_T = 256;
constexpr int ROW_BAR_OFF = 3 * 8 * 4;    // after [3][8 warps] f32 partials
constexpr int ROW_RING_OFF = 128;         // after the slots' mbarriers
constexpr float TIE_GAP = 1.0f / 16384.0f;
static_assert(ROW_BAR_OFF + 8 * ROW_SLOTS <= ROW_RING_OFF, "row pass smem");

// `bytes` (a multiple of 16) at src into this block's shared memory at dst,
// completing on the mbarrier at bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the 8 bf16 of a 16-byte vector as f32
__device__ __forceinline__ void unpack8(const uint4& v, float (&e)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[2 * j] = __uint_as_float(w[j] << 16);
    e[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// the 8 codes rint(h r) of a vector, packed in 8 bytes: fma(h, r, 1.5 2^23)
// holds rint(h r) in its low bits, fma(h, r, -rint(h r)) is h r's distance
// from it; `near` is set where that distance is within 2^-14 of a tie (or
// no number)
__device__ __forceinline__ uint2 codes_by_reciprocal(const float (&h)[8],
                                                     float r, bool& near) {
  constexpr float MAGIC = 12582912.0f;
  uint32_t t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float m = __fmaf_rn(h[k], r, MAGIC);
    const float f = __fmaf_rn(h[k], r, -__fsub_rn(m, MAGIC));
    near |= !(fabsf(f) <= 0.5f - TIE_GAP);
    t[k] = __float_as_uint(m);
  }
  return make_uint2(
      __byte_perm(__byte_perm(t[0], t[1], 0x0040),
                  __byte_perm(t[2], t[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(t[4], t[5], 0x0040),
                  __byte_perm(t[6], t[7], 0x0040), 0x5410));
}

// the 8 codes clip(rint(h / s)) of a vector by the IEEE division
__device__ __forceinline__ uint2 codes_by_division(const float (&h)[8],
                                                   float s) {
  uint32_t t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = static_cast<uint8_t>(quant(h[k], s));
  return make_uint2(t[0] | t[1] << 8 | t[2] << 16 | t[3] << 24,
                    t[4] | t[5] << 8 | t[6] << 16 | t[7] << 24);
}

// the 8 lanes of a thread's partial sums, pairwise in a fixed order
__device__ __forceinline__ float sum8(const float (&a)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                   __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
}

// p over the block: the warp's butterfly, then the warps in order through
// red (this reduction's 8 partials in shared memory)
template <bool MAX>
__device__ __forceinline__ float block_reduce(float p, float* red,
                                              int warps) {
  p = MAX ? warp_max(p) : warp_sum(p);
  if (warps == 1) return p;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = p;
  __syncthreads();
  p = red[0];
  for (int w = 1; w < warps; ++w)
    p = MAX ? fmaxf(p, red[w]) : __fadd_rn(p, red[w]);
  return p;
}

// V 16-byte column vectors a thread (blockDim.x = T threads, a multiple of
// 32, T V >= d / 8).
template <int V>
__global__ void __launch_bounds__(ROW_MAX_T)
ln_quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ lnw,
                     const float* __restrict__ lnb, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int d, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const uint32_t bar0 = wg::smem_u32(smem + ROW_BAR_OFF);
  const unsigned char* ring = smem + ROW_RING_OFF;
  const uint32_t ring0 = wg::smem_u32(ring);
  const int T = blockDim.x, warps = T >> 5, tid = threadIdx.x;
  const int vecs = d / 8;
  const uint32_t row_bytes = 2u * d;
  // the LayerNorm affine of this thread's columns
  float w[V][8], b[V][8];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = tid + T * j;
    if (c < vecs) {
      const float4* wv = reinterpret_cast<const float4*>(lnw) + 2 * c;
      const float4* bv = reinterpret_cast<const float4*>(lnb) + 2 * c;
      const float4 w0 = __ldg(wv), w1 = __ldg(wv + 1);
      const float4 b0 = __ldg(bv), b1 = __ldg(bv + 1);
      const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        w[j][k] = ws[k];
        b[j][k] = bs[k];
      }
    }
  }
  // row `row` into slot s (none past the last row)
  auto fetch = [&](int s, long long row) {
    if (row < M) {
      wg::arrive_expect_tx(bar0 + 8 * s, row_bytes);
      bulk_copy(ring0 + s * row_bytes, x + row * d, row_bytes, bar0 + 8 * s);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < ROW_SLOTS; ++s) wg::mbar_init(bar0 + 8 * s, 1);
    wg::mbar_fence_init();
    for (int s = 0; s < ROW_SLOTS; ++s)
      fetch(s, blockIdx.x + static_cast<long long>(s) * gridDim.x);
  }
  __syncthreads();
  int s = 0;
  uint32_t parity = 0;
  for (long long row = blockIdx.x; row < M; row += gridDim.x) {
    wg::mbar_wait(bar0 + 8 * s, parity);
    const uint4* xs = reinterpret_cast<const uint4*>(ring + s * row_bytes);
    // a thread's sums run in 8 independent lanes (k), so that no chain of
    // dependent adds holds the row up
    float v[V][8], p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = tid + T * j;
      if (c < vecs) {
        unpack8(xs[c], v[j]);
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = __fadd_rn(p[k], v[j][k]);
      }
    }
    __syncthreads();                    // every thread holds its values
    if (tid == 0)
      fetch(s, row + static_cast<long long>(ROW_SLOTS) * gridDim.x);
    const float mean = __fdiv_rn(block_reduce<false>(sum8(p), red, warps),
                                 (float)d);
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (tid + T * j < vecs) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float cx = __fsub_rn(v[j][k], mean);
          v[j][k] = cx;
          p[k] = __fadd_rn(p[k], __fmul_rn(cx, cx));
        }
      }
    }
    const float rstd = __frsqrt_rn(__fadd_rn(
        __fdiv_rn(block_reduce<false>(sum8(p), red + 8, warps), (float)d),
        eps));
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (tid + T * j < vecs) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float h = __fadd_rn(
              __fmul_rn(__fmul_rn(v[j][k], rstd), w[j][k]), b[j][k]);
          v[j][k] = h;
          p[k] = fmaxf(p[k], fabsf(h));
        }
      }
    }
    const float amax = fmaxf(fmaxf(fmaxf(p[0], p[1]), fmaxf(p[2], p[3])),
                             fmaxf(fmaxf(p[4], p[5]), fmaxf(p[6], p[7])));
    const float sc = __fmul_rn(
        fmaxf(block_reduce<true>(amax, red + 16, warps), 1e-8f),
        1.0f / 127.0f);
    const float rc = __frcp_rn(sc);
    int8_t* out = xq + row * d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = tid + T * j;
      if (c < vecs) {
        bool near = false;
        uint2 codes = codes_by_reciprocal(v[j], rc, near);
        if (near) codes = codes_by_division(v[j], sc);
        *reinterpret_cast<uint2*>(out + 8 * c) = codes;
      }
    }
    if (tid == 0) sx[row] = sc;
    if (++s == ROW_SLOTS) {
      s = 0;
      parity ^= 1u;
    }
  }
}

template <int V>
int launch_ln_quant(const void* x, const void* lnw, const void* lnb, void* xq,
                    void* sx, int M, int d, int T, cudaStream_t stream,
                    float eps) {
  auto kernel = ln_quant_rows_kernel<V>;
  const int bytes = ROW_RING_OFF + ROW_SLOTS * 2 * d;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T,
                                                        bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = M < per_sm * sms ? M : per_sm * sms;
  kernel<<<grid, T, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 [M, d] -> xq int8 [M, d], sx f32 [M]; lnw, lnb f32 [d] (16-byte
// aligned). Needs d % 8 == 0, d <= 6144, 16-byte aligned rows. A block is
// the fewest warps whose threads hold the row at ROW_MAX_V vectors or fewer
// each (ESM2: d 1280 -> 32 threads x 5 vectors, 2560 -> 64 x 5; d 6144 ->
// 160 x 5).
extern "C" int ln_quant_rows_bf16(const void* x, const void* lnw,
                                  const void* lnb, void* xq, void* sx, int M,
                                  int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  if (d <= 0 || d % 8 || d > 6144)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = d / 8;
  const int T = (vecs + 32 * ROW_MAX_V - 1) / (32 * ROW_MAX_V) * 32;
  switch ((vecs + T - 1) / T) {
    case 1: return launch_ln_quant<1>(x, lnw, lnb, xq, sx, M, d, T, st, eps);
    case 2: return launch_ln_quant<2>(x, lnw, lnb, xq, sx, M, d, T, st, eps);
    case 3: return launch_ln_quant<3>(x, lnw, lnb, xq, sx, M, d, T, st, eps);
    case 4: return launch_ln_quant<4>(x, lnw, lnb, xq, sx, M, d, T, st, eps);
    default:
      return launch_ln_quant<5>(x, lnw, lnb, xq, sx, M, d, T, st, eps);
  }
}

// The one-pass form: the row pass, the up and the down kernel. x bf16
// [M, d] (16-byte aligned); lnw, lnb, s2, b2 f32 [d] (16-byte aligned);
// w1t int8 [H, d] and w2t int8 [d, H] (both k-major: contraction axis
// innermost); s1, b1 f32 [H]; scratch xq int8 [M, d], sx f32 [M], gq int8
// [M, H], sg f32 [M, H / G]; out bf16 [M, d]. Needs d % 64 == 0,
// d <= 6144, G in {128, 256, 512}, H % (G * SPG) == 0. Returns the first
// launch's cudaGetLastError() that is not 0.
extern "C" int fused_ln_mlp_int8_bf16(
    const void* x, const void* lnw, const void* lnb, const void* w1t,
    const void* s1, const void* b1, const void* w2t, const void* s2,
    const void* b2, void* xq, void* sx, void* gq, void* sg, void* out, int M,
    int d, int H, int G, int SPG, float eps, int add_residual,
    void* stream) {
  const int err = ln_quant_rows_bf16(x, lnw, lnb, xq, sx, M, d, eps, stream);
  if (err) return err;
  return mlp_on_codes(xq, sx, w1t, s1, b1, w2t, s2, b2,
                      add_residual ? x : nullptr, gq, sg, out, M, d, H, G,
                      SPG, static_cast<cudaStream_t>(stream));
}

// The two-pass form's MLP on ln_quant_rows_bf16's outputs xq, sx; weights,
// scales, biases and scratch as above; out bf16 [M, d] = MLP without the
// residual.
extern "C" int fused_mlp_int8_prequant_bf16(
    const void* xq, const void* sx, const void* w1t, const void* s1,
    const void* b1, const void* w2t, const void* s2, const void* b2, void* gq,
    void* sg, void* out, int M, int d, int H, int G, int SPG, void* stream) {
  return mlp_on_codes(xq, sx, w1t, s1, b1, w2t, s2, b2, nullptr, gq, sg, out,
                      M, d, H, G, SPG, static_cast<cudaStream_t>(stream));
}
