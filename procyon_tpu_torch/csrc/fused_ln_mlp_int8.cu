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
//   row pass (ln_quant_rows_kernel): a warp a row, xq int8 [M, d] and sx;
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

constexpr int NW = 8;               // warps of a row-pass block
constexpr int NT = NW * 32;
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

// h = (x - mean) * rstd * w + b for the 8 values of one 16-byte vector,
// rounded as the reference's separate operations are
__device__ __forceinline__ void ln_affine(const uint4& xv,
                                          const float* __restrict__ w,
                                          const float* __restrict__ b,
                                          float mean, float rstd,
                                          float (&h)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xv);
  const float4 w0 = __ldg(reinterpret_cast<const float4*>(w));
  const float4 w1 = __ldg(reinterpret_cast<const float4*>(w) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float cx = __fsub_rn(__bfloat162float(e[k]), mean);
    h[k] = __fadd_rn(__fmul_rn(__fmul_rn(cx, rstd), ws[k]), bs[k]);
  }
}

// LayerNorm + per-row int8 quantization, one warp a row, the row held in
// registers: VPL 16-byte vectors (8 bf16) a lane, d <= 256 * VPL.
template <int VPL>
__global__ void __launch_bounds__(NT)
ln_quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ lnw,
                     const float* __restrict__ lnb, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (row >= M) return;
  const int vecs = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 v[VPL];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < vecs) {
      v[i] = __ldg(xr + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += __bfloat162float(e[k]);
    }
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)d);
  float vs = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < vecs) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float cx = __fsub_rn(__bfloat162float(e[k]), mean);
        vs = __fadd_rn(vs, __fmul_rn(cx, cx));
      }
    }
  }
  const float rstd =
      __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(vs), (float)d), eps));
  // h is computed twice (for the row's amax, then for its codes) rather
  // than kept: the same operations give the same bits
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < vecs) {
      float h[8];
      ln_affine(v[i], lnw + c * 8, lnb + c * 8, mean, rstd, h);
#pragma unroll
      for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(h[k]));
    }
  }
  const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), 1.0f / 127.0f);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < vecs) {
      float h[8];
      ln_affine(v[i], lnw + c * 8, lnb + c * 8, mean, rstd, h);
      uint32_t codes[2] = {0u, 0u};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        codes[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                             quant(h[k], s))) << (8 * (k & 3));
      *reinterpret_cast<uint2*>(xq + row * d + c * 8) =
          make_uint2(codes[0], codes[1]);
    }
  }
  if (lane == 0) sx[row] = s;
}

template <int VPL>
int launch_ln_quant(const void* x, const void* lnw, const void* lnb, void* xq,
                    void* sx, int M, int d, float eps, cudaStream_t stream) {
  ln_quant_rows_kernel<VPL><<<(M + NW - 1) / NW, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 [M, d] -> xq int8 [M, d], sx f32 [M]; lnw, lnb f32 [d]. Needs
// d % 8 == 0, d <= 6144, 16-byte aligned rows. The row's registers are the
// fewest that hold it (ESM2: d 1280 -> 8 vectors a lane, 2560 -> 12):
// more registers a thread would leave fewer warps to hide the loads.
extern "C" int ln_quant_rows_bf16(const void* x, const void* lnw,
                                  const void* lnb, void* xq, void* sx, int M,
                                  int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  if (d % 8 || d > 256 * 24) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 256 * 4) return launch_ln_quant<4>(x, lnw, lnb, xq, sx, M, d, eps, st);
  if (d <= 256 * 8) return launch_ln_quant<8>(x, lnw, lnb, xq, sx, M, d, eps, st);
  if (d <= 256 * 12) return launch_ln_quant<12>(x, lnw, lnb, xq, sx, M, d, eps, st);
  if (d <= 256 * 16) return launch_ln_quant<16>(x, lnw, lnb, xq, sx, M, d, eps, st);
  return launch_ln_quant<24>(x, lnw, lnb, xq, sx, M, d, eps, st);
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
