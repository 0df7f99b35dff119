// RMSNorm -> W8A8 SwiGLU MLP -> residual for Hopper (sm_90a):
//   out = bf16(x + W8A8-SwiGLU(rms_norm(x)))
// with int8 gate / up [d, H] and down [H, d] in the JAX [in, out] layout,
// read here as K-major [out, in] copies (wgt, wut [H, d], wdt [d, H]: the
// [in, out] view of [out, in] storage is that copy), f32 per-column scales
// sg, su [H] and sd [d].
//
// Replaces: procyon_tpu/ops/fused_mlp.py::_kernel_swiglu (through
// fused_rms_swiglu_int8), the Llama W8A8 prefill's MLP, which no JAX path
// wires in.
//
// Numerics, step for step as the TPU kernel:
//   1. ms = mean(x^2) in f32, h = (x * (1 / sqrt(ms + eps))) * nw, never
//      rounded to bf16; sx = max(amax(h), 1e-8) / 127, xq = clip(rint(h /
//      sx)) (the exact forms: 1/sqrtf and a division, no rsqrtf);
//   2. s8 x s8 -> s32 products with Wg and Wu; g = acc * (sx * sg),
//      u = acc * (sx * su), a = (g * (1 / (1 + expf(-g)))) * u;
//   3. per (row, G columns) sa = max(amax(a), 1e-8) / 127, aq = clip(rint(
//      a / sa)); G is the wrapper's swiglu_group (the reference's block_n /
//      sub_tiles rule), data, not tuning;
//   4. per group the s8 x s8 -> s32 product of aq with Wd's G rows, part =
//      acc * (sa * sd) in f32; the SPG groups of one block_n step summed in
//      order, then added to the accumulator; + x in f32, one cast.
// Rounding is half to even (rintf), divisions are IEEE, products and sums
// the reference rounds apart stay apart (__fmul_rn / __fadd_rn).
//
// What bounds it on the H100: operations. At the ProCyon-Bind prefill
// (M 4096 rows, d 4096, H 11008) the three products are 6 M d H = 1.108 T
// int8 operations against about 0.20 GB (135 MB of weights, x and out):
// 0.560 ms at 1,979 TOP/s; at H 14336 (Llama-3-8B) 0.729 ms. Only s8
// wgmma reaches that rate (mma.sync m16n8k32, this file's first kernel, ran
// at 13% of it: 4.4386 ms at the Bind shape, chip_smoke.py on an H100 80GB
// HBM3 at 700 W).
//
// The design: three launches on one stream, no atomics, on the product
// machinery of row 4's kernels (int8_ring.cuh: a TMA ring of 128-byte
// stages fed by a producer warp, two consumer warpgroups of s8 wgmma
// m64nNk32, 2-block clusters multicasting the weight rows, a persistent
// grid):
//   row pass (rms_quant_rows_kernel): a warp a row, xq int8 [M, d] and sx;
//   up (swiglu_up_kernel): a tile is 128 rows and one group. At G 128 a
//     stage's 256 B rows are the group's 128 Wg rows, then its 128 Wu rows:
//     block 0 of the cluster copies the first, block 1 the second, each
//     multicast to both, and one m64n256 product a warpgroup yields g in
//     its sums 0-63 and u in 64-127 of the same thread (columns c and c +
//     128), so SiLU(g) * u needs no exchange and the group's row amax is a
//     quad shuffle. At G > 128 the tile walks the group's 128-column parts
//     twice, the first time for the amax only (no stash: the products of
//     the second pass give the same bits);
//   down (swiglu_down_kernel): a tile is 128 rows x 128 output columns over
//     H. The SR groups a drain covers have their own s32 sums (the block_n
//     step's SPG groups, SR = SPG up to 2); then each group's part is summed
//     in order and the step's total added to the accumulator, a thread's 64
//     values in shared memory (SPG above 2 keeps the step's running total in
//     a second slab). Sums of at most 256 codes (G <= 256) become f32 by
//     adding them to the bits of 1.5 * 2^23 (exact below 2^22 in
//     magnitude), not by the quarter-rate I2F.
// Tile order: the weights are larger than the L2 (gate and up 90 MB, down
// 45 MB at the Bind shape), so the clusters in flight must share weight
// tiles. The walk takes bands of row tiles fastest inside groups of bands
// whose A rows fit half the L2 (int8_ring.cuh, band_group_for): at the
// Bind shape the up kernel's one group is every band (xq, 16 MB, stays in
// L2 while the 66 clusters in flight cover some 4 column groups): its
// weights leave device memory once, 90 MB, where row 4's column-fastest
// order would read them once for each of the 16 bands, 1.44 GB. The down
// kernel's groups are 8 bands (22.5 MB of codes): Wd (45 MB) leaves device
// memory once a group, 90 MB, where column-fastest it would leave once a
// band (720 MB), and row-fastest over all 16 bands the codes (45 MB, more
// than the L2 keeps beside the weights) would leave once for every few
// column tiles.
// Rows beyond M are zero-filled by TMA and never stored. The hidden codes
// go to device memory (45 MB at the Bind shape), which the TPU kernel
// avoids.
// What holds it back (PERF.md section 6; 1.5294 ms at the Bind shape, 37%
// of the bound, chip_smoke.py on an H100 80GB HBM3 at 700 W): the up
// kernel's products alone run near the peak, but its epilogue (an expf and
// two IEEE divisions a hidden value, in the registers the 128 sums leave)
// overlaps none of them and takes about two fifths of its time; the down
// kernel's N 128 products stay under half the peak even without their
// group epilogue (both operands in shared memory beside the TMA writes),
// and the epilogue (a scale and an add for every sum of 128 codes at
// G 128, the accumulator in shared memory) adds about as much again.
// Draining once a tile, more groups in flight, other band groups and the
// two warpgroups taking turns at issuing were measured and gained nothing.
// Later work: the up epilogue beside the next tile's products (a warpgroup
// a tile in turns, at 1.5 times the L2 traffic of the weight rows); the
// down accumulator in registers (fewer sums a thread, or more registers
// for the consumers than the producer warp leaves).

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
using UpRing = Ring<256, 1, 0>;

// x bf16 [M, d] -> xq int8 [M, d], sx f32 [M]: RMSNorm in f32 and the
// row's int8 codes, a warp a row.
__global__ void __launch_bounds__(NT)
rms_quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ nw, int8_t* __restrict__ xq,
                      float* __restrict__ sx, int M, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (row >= M) return;
  const __nv_bfloat16* xr = x + row * d;
  float ss = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + c));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float f = __bfloat162float(e[k]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
  const float ms = __fdiv_rn(warp_sum(ss), (float)d);
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ms, eps)));
  float amax = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + c));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float h =
          __fmul_rn(__fmul_rn(__bfloat162float(e[k]), r), __ldg(nw + c + k));
      amax = fmaxf(amax, fabsf(h));
    }
  }
  const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), 1.0f / 127.0f);
  for (int c = lane * 8; c < d; c += 256) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + c));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint32_t codes[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float h =
          __fmul_rn(__fmul_rn(__bfloat162float(e[k]), r), __ldg(nw + c + k));
      codes[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                           quant(h, s))) << (8 * (k & 3));
    }
    *reinterpret_cast<uint2*>(xq + row * d + c) =
        make_uint2(codes[0], codes[1]);
  }
  if (lane == 0) sx[row] = s;
}

// The up kernel: aq = codes(SiLU(g) * u) and sa for 128 rows and one group
// of G columns a tile. xq int8 [M, d], wgt and wut int8 [H, d] through their
// tensor maps; sx f32 [M]; sg, su f32 [H]; aq int8 [M, H]; sa f32
// [M, H / G].
__global__ void __launch_bounds__(NTHREADS, 1)
swiglu_up_kernel(const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mg,
                 const __grid_constant__ CUtensorMap mu,
                 const float* __restrict__ sx, const float* __restrict__ sg,
                 const float* __restrict__ su, int8_t* __restrict__ aq,
                 float* __restrict__ sa, int M, int d, int H, int G,
                 int band_group) {
  using R = UpRing;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BAR_OFF);
  uint64_t* empty = full + R::S;
  const int nk = d / KC, n_col = H / G, nsub = G / 128;
  // passes over the group's 128-column parts: one at G 128, else two
  const int reps = nsub == 1 ? 1 : 2 * nsub;
  const Walk wk = Walk::make<R>(M, n_col, band_group);
  init_ring<R>(full, empty);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == NC / 32) {
    if (lane == 0)
      produce<R>(&mx, smem, full, empty, wk, nk, reps, [&](int p, int v) {
        return BPart{wk.rank == 0 ? &mg : &mu,
                     wk.col(p) * G + v % nsub * 128};
      });
  } else {
    const int wm = warp >> 2, g = lane >> 2, t = lane & 3;
    const int rl = wm * 64 + (warp & 3) * 16 + g;   // and rl + 8
    uint32_t acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0u;
    int it = 0;
    for (int p = wk.cluster; p < wk.n_tiles; p += wk.n_clusters) {
      const long long r0 =
          static_cast<long long>(wk.row_tile(p)) * R::BM + rl;
      const int grp = wk.col(p);
      const float sx0 = r0 < M ? sx[r0] : 0.f;
      const float sx1 = r0 + 8 < M ? sx[r0 + 8] : 0.f;
      float amax[2] = {0.f, 0.f}, scale[2] = {0.f, 0.f};
      for (int v = 0; v < reps; ++v) {
        for (int kc = 0; kc < nk; ++kc, ++it)
          mma_chunk<R, 256>(acc, smem, full, empty, it, kc == 0, kc > 0, wm,
                            0, lane);
        drain<R>(acc, empty, it, lane);

        // SiLU(g) * u into sums 0-63 (f32 bits), the rows' amax; a second
        // pass gives the same values, so adding them to the amax again
        // changes nothing
        const int c0 = grp * G + v % nsub * 128 + 2 * t;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 gs =
              __ldg(reinterpret_cast<const float2*>(sg + c0 + 8 * j));
          const float2 us =
              __ldg(reinterpret_cast<const float2*>(su + c0 + 8 * j));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sxr = e < 2 ? sx0 : sx1;
            const float gv = __fmul_rn(
                static_cast<float>(static_cast<int>(acc[4 * j + e])),
                __fmul_rn(sxr, (e & 1) ? gs.y : gs.x));
            const float uv = __fmul_rn(
                static_cast<float>(static_cast<int>(acc[64 + 4 * j + e])),
                __fmul_rn(sxr, (e & 1) ? us.y : us.x));
            const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gv)));
            const float av = __fmul_rn(__fmul_rn(gv, sig), uv);
            acc[4 * j + e] = __float_as_uint(av);
            amax[e >> 1] = fmaxf(amax[e >> 1], fabsf(av));
          }
        }
        if (v < reps - nsub) continue;   // the first of two passes
        if (v == reps - nsub) {
          // the group's amax a row: the quad holds its columns
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 1));
            amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 2));
            scale[r] = __fmul_rn(fmaxf(amax[r], 1e-8f), 1.0f / 127.0f);
            if (t == 0 && r0 + 8 * r < M)
              sa[(r0 + 8 * r) * n_col + grp] = scale[r];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r0 + 8 * r >= M) continue;
          int8_t* dst = aq + (r0 + 8 * r) * H + c0;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            char2 pair;
            pair.x = quant(__uint_as_float(acc[4 * j + 2 * r]), scale[r]);
            pair.y = quant(__uint_as_float(acc[4 * j + 2 * r + 1]), scale[r]);
            *reinterpret_cast<char2*>(dst + 8 * j) = pair;
          }
        }
      }
    }
  }
  // no block leaves while a copy or an arrival of another may reach it
  wg::cluster_sync();
}

// an s32 sum of at most 256 s8 x s8 products (|v| <= 2^22) as an exact
// f32: added to the bits of 1.5 * 2^23, whose ulp is 1, and 1.5 * 2^23
// taken off again (I2F runs at a quarter of the FP32 rate)
__device__ __forceinline__ float sum_to_f32(uint32_t v) {
  return __fsub_rn(__int_as_float(static_cast<int>(v) + 0x4B400000),
                   12582912.0f);
}

// one drain's SR groups into the accumulator: each group's part sums *
// (sa * sd), the parts of a block_n step summed in order (`head`: the
// step's first group is among them, `tail`: its last), the step's total
// added to the accumulator (`first`: the first step). slab and tot: a
// thread's 64 values, elements 4j .. 4j + 3 one float4 at [j * NC + ct].
template <bool WIDE, int SR, bool BIG>
__device__ __forceinline__ void add_groups(const uint32_t (&acc)[SR][64],
                                           const float (&gs)[SR][2],
                                           const float* __restrict__ sd,
                                           int c0, float4* slab, float4* tot,
                                           int ct, bool head, bool tail,
                                           bool first) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 sc = __ldg(reinterpret_cast<const float2*>(sd + c0 + 8 * j));
    float v[4];
    if (BIG && !head) {
      const float4 tv = tot[j * NC + ct];
      v[0] = tv.x; v[1] = tv.y; v[2] = tv.z; v[3] = tv.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
#pragma unroll
      for (int q = 0; q < SR; ++q) {
        const float s = WIDE
            ? static_cast<float>(static_cast<int>(acc[q][i]))
            : sum_to_f32(acc[q][i]);
        const float part =
            __fmul_rn(s, __fmul_rn(gs[q][e >> 1], (e & 1) ? sc.y : sc.x));
        v[e] = q == 0 && (!BIG || head) ? part : __fadd_rn(v[e], part);
      }
    }
    if (!BIG || tail) {
      float4 a = first ? make_float4(0.f, 0.f, 0.f, 0.f) : slab[j * NC + ct];
      a.x = __fadd_rn(a.x, v[0]);
      a.y = __fadd_rn(a.y, v[1]);
      a.z = __fadd_rn(a.z, v[2]);
      a.w = __fadd_rn(a.w, v[3]);
      slab[j * NC + ct] = a;
    } else {
      tot[j * NC + ct] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The down kernel: out = bf16(acc + x) for 128 rows x 128 columns a tile,
// over the H / G groups of G = cpg * KC codes in the reference's order, SR
// groups a drain (SR = SPG when SPG <= 2; BIG: SPG > 2, the step's running
// total in a second slab). aq int8 [M, H] and wdt int8 [d, H] through their
// tensor maps; sa f32 [M, H / G]; sd f32 [d]; x, out bf16 [M, d].
template <int SR, bool BIG>
__global__ void __launch_bounds__(NTHREADS, 1)
swiglu_down_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mw,
                   const float* __restrict__ sa, const float* __restrict__ sd,
                   const __nv_bfloat16* __restrict__ x,
                   __nv_bfloat16* __restrict__ out, int M, int d, int H,
                   int G, int SPG, int band_group) {
  using R = Ring<128, 1, BIG ? 2 * SLAB : SLAB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BAR_OFF);
  uint64_t* empty = full + R::S;
  const int nk = H / KC, cpg = G / KC, n_groups = H / G;
  const int n_col = d / R::BN;
  const Walk wk = Walk::make<R>(M, n_col, band_group);
  init_ring<R>(full, empty);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == NC / 32) {
    if (lane == 0)
      produce<R>(&ma, smem, full, empty, wk, nk, 1, [&](int p, int) {
        return BPart{&mw, wk.col(p) * R::BN + wk.rank * R::B_PART};
      });
  } else {
    const int w = warp >> 2, ct = threadIdx.x;
    const int g = lane >> 2, t = lane & 3;
    const int rl = w * 64 + (warp & 3) * 16 + g;   // and rl + 8
    float4* slab = reinterpret_cast<float4*>(smem + R::EXTRA_OFF);
    float4* tot = slab + 16 * NC;
    uint32_t acc[SR][64];
#pragma unroll
    for (int q = 0; q < SR; ++q)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[q][i] = 0u;
    int it = 0;
    for (int p = wk.cluster; p < wk.n_tiles; p += wk.n_clusters) {
      const long long r0 =
          static_cast<long long>(wk.row_tile(p)) * R::BM + rl;
      const int c0 = wk.col(p) * R::BN + 2 * t;
      for (int grp = 0; grp < n_groups; grp += SR) {
        // the groups' row scales, loaded while the products run
        float gs[SR][2];
#pragma unroll
        for (int q = 0; q < SR; ++q) {
          gs[q][0] = r0 < M ? sa[r0 * n_groups + grp + q] : 0.f;
          gs[q][1] = r0 + 8 < M ? sa[(r0 + 8) * n_groups + grp + q] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < SR; ++q)
          for (int c = 0; c < cpg; ++c, ++it)
            mma_chunk<R, 128>(acc[q], smem, full, empty, it, c == 0,
                              q > 0 || c > 0, w, 0, lane);
        drain<R>(acc[SR - 1], empty, it, lane);
#pragma unroll
        for (int q = 0; q < SR - 1; ++q) wg::hold(acc[q]);
        const int qs = grp % SPG;
        const bool head = qs == 0, tail = qs + SR == SPG, first = grp < SPG;
        if (G <= 256)
          add_groups<false, SR, BIG>(acc, gs, sd, c0, slab, tot, ct, head,
                                     tail, first);
        else
          add_groups<true, SR, BIG>(acc, gs, sd, c0, slab, tot, ct, head,
                                    tail, first);
      }
      // + the residual in f32, one cast
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * j;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r0 + 8 * r;
          if (row >= M) continue;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x + row * d + col);
          const float4 a = slab[j * NC + ct];
          const float o0 = __fadd_rn(r ? a.z : a.x, __low2float(xv));
          const float o1 = __fadd_rn(r ? a.w : a.y, __high2float(xv));
          *reinterpret_cast<__nv_bfloat162*>(out + row * d + col) =
              __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
  wg::cluster_sync();
}

int launch_up(const int8_t* xq, const float* sx, const int8_t* wgt,
              const float* sg, const int8_t* wut, const float* su, int8_t* aq,
              float* sa, int M, int d, int H, int G, cudaStream_t st) {
  using R = UpRing;
  CUtensorMap mx, mg, mu;
  if (!make_map(&mx, xq, d, M, R::BM) ||
      !make_map(&mg, wgt, d, H, R::B_PART) ||
      !make_map(&mu, wut, d, H, R::B_PART))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_row = (M + R::BM - 1) / R::BM;
  return launch_clusters(swiglu_up_kernel, R::BYTES,
                         (n_row + CL - 1) / CL * (H / G), st, mx, mg, mu, sx,
                         sg, su, aq, sa, M, d, H, G,
                         band_group_for(R::BM, d));
}

template <int SR, bool BIG>
int launch_down(const int8_t* aq, const float* sa, const int8_t* wdt,
                const float* sd, const __nv_bfloat16* x, __nv_bfloat16* out,
                int M, int d, int H, int G, int SPG, cudaStream_t st) {
  using R = Ring<128, 1, BIG ? 2 * SLAB : SLAB>;
  CUtensorMap ma, mw;
  if (!make_map(&ma, aq, H, M, R::BM) || !make_map(&mw, wdt, H, d, R::B_PART))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_row = (M + R::BM - 1) / R::BM;
  return launch_clusters(swiglu_down_kernel<SR, BIG>, R::BYTES,
                         (n_row + CL - 1) / CL * (d / R::BN), st, ma, mw, sa,
                         sd, x, out, M, d, H, G, SPG,
                         band_group_for(R::BM, H));
}

}  // namespace

// x bf16 [M, d]; nw f32 [d]; wgt, wut int8 [H, d] and wdt int8 [d, H]
// (K-major: the contraction axis innermost); sg, su f32 [H]; sd f32 [d];
// scratch xq int8 [M, d], sx f32 [M], aq int8 [M, H], sa f32 [M, H / G];
// out bf16 [M, d]. Needs d % 128 == 0, H % 128 == 0, G in {128, 256, 384,
// 512} dividing H, H % (G * SPG) == 0, 16-byte aligned tensors. Three
// launches on `stream`; returns the first cudaGetLastError() that is not 0.
extern "C" int fused_rms_swiglu_int8_bf16(
    const void* x, const void* nw, const void* wgt, const void* sg,
    const void* wut, const void* su, const void* wdt, const void* sd,
    void* xq, void* sx, void* aq, void* sa, void* out, int M, int d, int H,
    int G, int SPG, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  if (d <= 0 || d % 128 || H <= 0 || H % 128 || G <= 0 || G % 128 ||
      G > 512 || H % G || SPG < 1 || (H / G) % SPG)
    return static_cast<int>(cudaErrorInvalidValue);
  rms_quant_rows_kernel<<<(M + NW - 1) / NW, NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(nw),
      static_cast<int8_t*>(xq), static_cast<float*>(sx), M, d, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  int8_t* aq8 = static_cast<int8_t*>(aq);
  float* saf = static_cast<float*>(sa);
  err = launch_up(static_cast<const int8_t*>(xq),
                  static_cast<const float*>(sx),
                  static_cast<const int8_t*>(wgt),
                  static_cast<const float*>(sg),
                  static_cast<const int8_t*>(wut),
                  static_cast<const float*>(su), aq8, saf, M, d, H, G, st);
  if (err) return err;
  const int8_t* wd8 = static_cast<const int8_t*>(wdt);
  const float* sdf = static_cast<const float*>(sd);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (SPG == 1)
    return launch_down<1, false>(aq8, saf, wd8, sdf, xb, ob, M, d, H, G, SPG, st);
  if (SPG == 2)
    return launch_down<2, false>(aq8, saf, wd8, sdf, xb, ob, M, d, H, G, SPG, st);
  if (SPG % 2 == 0)
    return launch_down<2, true>(aq8, saf, wd8, sdf, xb, ob, M, d, H, G, SPG, st);
  return launch_down<1, true>(aq8, saf, wd8, sdf, xb, ob, M, d, H, G, SPG, st);
}
