// Fused decode MLP with int8 weights for Hopper (sm_90a): for M <= 16 rows
//   xn = bf16(x * rsqrt(mean(x^2) + eps) * nw)              (f32 statistics)
//   g  = (xn @ bf16(Wg.q)) * Wg.s,  u = (xn @ bf16(Wu.q)) * Wu.s   (f32)
//   a  = bf16(g * sigmoid(g) * u)
//   out = bf16(x + (a @ bf16(Wd.q)) * Wd.s)                  (f32 sum over I)
// with Wg, Wu int8 [d, I] and Wd int8 [I, d] in the JAX [in, out] layout.
//
// Replaces: scripts/probe_fused_decode.py::_kernel (through
// fused_decode_mlp), the Pallas probe of one decode layer's MLP.
//
// What bounds it on the H100: weight bytes. At Llama-3-8B (d 4096,
// I 14336) a layer's three int8 matrices are 176.2 MB, 52.6 us at
// 3.35 TB/s; the products are 5.6 GFLOP at M 16, 5.7 us of bf16 tensor
// cores. Every weight byte has to be read once and nothing else matters.
//
// What the design does about it. Two launches on one stream (gate / up,
// then down), each a grid of column tiles of NT = 128 columns cut into k
// slices (the plan, ops/fused_decode.plan, picks the slices from the
// shapes: at Llama-3-8B 112 x 2 and 32 x 7 blocks, every SM a block and
// every cluster resident at once); no atomics, so the result is bitwise the
// same run to run:
//   * weights through TMA: one producer warp keeps a ring of shared-memory
//     stages full, each a [64 rows, 128 bytes] box of every weight (rows as
//     they lie in the [in, out] layout, in the 128-byte swizzle) and the
//     stage's [16 rows, 64] bf16 box of the activations (x for gate / up, a
//     for down; rows past M arrive as zeros), under full / empty mbarriers;
//   * the k slices of a column tile form one thread-block cluster and add
//     their f32 partials through distributed shared memory in slice order
//     (no partials in device memory, no third launch), then the epilogue:
//     the scales, SiLU and the product (gate / up), the column scale and
//     the residual (down);
//   * the row norms once per slice: each block sums the squares of its own
//     k slice of x while its first weight boxes load, and the cluster adds
//     the slices' sums in slice order; the consumers then turn each stage's
//     x tile into xn in place, four values a thread, once a stage;
//   * consumer warps of 32 columns each (gate / up: two a column, taking
//     alternate k16 steps of a stage, their partials added in order with
//     the slices'). A lane reads one 32-bit word (four columns) of weight
//     rows 2t, 2t + 1, 2t + 8, 2t + 9 of a k16 step, conflict-free through
//     the swizzle; byte j feeds n8 tile j, whose column c stands for
//     physical column 4c + j, so the C fragments of the four tiles hold
//     eight consecutive columns a lane. Two codes become an exact bf16 pair
//     by a byte permute, two logic ops and a bf16x2 subtraction
//     (codes_to_bf16x2), no conversion instruction; mma.sync m16n8k16, bf16
//     in, f32 sums; the activations' A fragments come through ldmatrix;
//   * the down launch may start while gate / up drains (programmatic
//     dependent launch): its producer loads its first weight boxes, waits
//     for gate / up's grid (griddepcontrol.wait), then loads a.
// What holds it back (PERF.md section 6): the TMA ring alone, its consumers
// idle, streams the weights well under the memory's rate, 128-, 256- or
// 512-byte row pieces alike.
// The first version (cp.async rings a warp, one block a column tile, 32- and
// 64-byte row pieces) took 0.1099 ms a layer at M 16 (chip_smoke.py; H100
// 80GB HBM3, 700 W; PERF.md).
// Later work: tensor maps of the weights kept from call to call, as the
// int4 matmul does.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int NT = 128;            // columns a block: a 128-byte box row
constexpr int CH = 64;             // weight rows (k) a ring stage
constexpr int CW = NT / 32;        // column warps, 32 columns each
constexpr int MAX_SLICES = 16;
constexpr int W_BYTES = CH * NT;            // a weight box, 8 KB
constexpr int A_BYTES = 16 * CH * 2;        // an activation box, 2 KB
constexpr int RED_LD = NT + 4;              // f32 row of the partials

// A launch's block (GU: gate / up, else down): CW column warps times KW k
// warps (alternate k16 steps of a stage) and a producer warp; a ring of
// STAGES stages of NMAT weight boxes and an activation box; after the
// products, the block's partials [KW][NMAT][16][RED_LD] f32 in the ring's
// place; then the rows' sums of squares and their rstd (gate / up, 16 f32
// each), then the barriers. Gate / up splits a stage's four k16 steps
// between two warps a column (measured faster there, the down launch
// faster with one).
template <bool GU>
struct Cfg {
  static constexpr int NMAT = GU ? 2 : 1;
  static constexpr int KW = GU ? 2 : 1;
  static constexpr int WARPS = CW * KW;          // consumer warps
  static constexpr int THREADS = (WARPS + 1) * 32;
  static constexpr int STAGES = GU ? 5 : 8;
  static constexpr int STAGE = NMAT * W_BYTES + A_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = KW * NMAT * 16 * RED_LD * 4;
  static constexpr int BODY = RING > RED ? RING : RED;
  static constexpr int SS_OFF = BODY;
  static constexpr int RSTD_OFF = SS_OFF + 16 * 4;
  static constexpr int BAR_OFF = RSTD_OFF + 16 * 4;
  static constexpr int BYTES = 1024 + BAR_OFF + 16 * STAGES;
  static_assert(STAGE % 1024 == 0, "swizzled boxes 1024-byte aligned");
  static_assert(2 * BYTES <= 232448, "two blocks an SM");
};

// byte offset `off` of a tile of 128-byte rows as the TMA lays it out in
// the 128-byte swizzle (the tile 1024-byte aligned)
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// the consumer warps of a block (named barrier 1)
template <int WARPS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");
}

// the thread's arrival at / wait for the cluster's barrier, apart
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// bytes j of w0 and w1 (signed codes v) as the exact bf16 pair (v0, v1):
// 128 + (the byte's low 7 bits) (bf16 0x4300 | b & 0x7f: the ulp is 1 there)
// less 128 where the sign bit is clear and 256 where it is set; every term
// and the difference are exact in bf16. One byte permute, two logic ops
// and one bf16x2 subtraction for two codes.
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t w0, uint32_t w1,
                                                    int j) {
  // byte j of w0 in bits 0-7, of w1 in bits 16-23 (the others masked off)
  const uint32_t b =
      __byte_perm(w0, w1, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
  uint32_t m = (b & 0x007F007Fu) | 0x43004300u;
  uint32_t o = (b & 0x00800080u) ^ 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
              *reinterpret_cast<const __nv_bfloat162*>(&o));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// four bf16 x values of a stage's activation tile (row `row`, columns c ..
// c + 3, at shared address `at`) as xn = bf16((x * r) * nw), in place
__device__ __forceinline__ void scale_to_xn(uint32_t at, float r,
                                            const float (&w)[4]) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(at)
               : "memory");
  const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  v.x = wg::pack_bf16(__fmul_rn(__fmul_rn(__low2float(p0), r), w[0]),
                      __fmul_rn(__fmul_rn(__high2float(p0), r), w[1]));
  v.y = wg::pack_bf16(__fmul_rn(__fmul_rn(__low2float(p1), r), w[2]),
                      __fmul_rn(__fmul_rn(__high2float(p1), r), w[3]));
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(at), "r"(v.x),
               "r"(v.y)
               : "memory");
}

// nw at k .. k + 3 as f32, read in its own type
__device__ __forceinline__ void norm_weights(const void* nw, int nw_bf16,
                                             int k, float (&w)[4]) {
  if (nw_bf16) {
    const uint2 v =
        __ldg(reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(nw) + k));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
  } else {
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(nw) + k));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
}

__device__ __forceinline__ float sigmoid_silu_product(float g, float u) {
  const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, sig), u);
}

// One block: columns n0 .. n0 + NT of the weights over k slice blockIdx.x
// of gridDim.x (the slices of a column tile are one cluster). GU (gate /
// up): mw0, mw1 Wg, Wu uint8 [d, I]; ma x bf16 [M, d]; s0, s1 sg, su [I];
// out a bf16 [M, I]; K = d, N = I. Down: mw0 Wd uint8 [I, d] (mw1 unused);
// ma a bf16 [M, I]; s0 sd [d]; x the residual; out bf16 [M, d]; K = I,
// N = d.
template <bool GU>
__device__ __forceinline__ void decode_mlp_block(
    const CUtensorMap& mw0, const CUtensorMap& mw1, const CUtensorMap& ma,
    const __nv_bfloat16* __restrict__ x, const void* __restrict__ nw,
    int nw_bf16, const float* __restrict__ s0, const float* __restrict__ s1,
    __nv_bfloat16* __restrict__ out, int M, int K, int N, float eps) {
  using L = Cfg<GU>;
  constexpr int NMAT = L::NMAT, KW = L::KW, WARPS = L::WARPS;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = wg::aligned_smem(raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  float* ss = reinterpret_cast<float*>(smem + L::SS_OFF);
  float* rstd = reinterpret_cast<float*>(smem + L::RSTD_OFF);
  const int slices = gridDim.x, slice = blockIdx.x;   // the cluster rank
  const int n0 = blockIdx.y * NT;
  const int klen = K / slices, k0 = slice * klen, n_chunks = klen / CH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), WARPS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  float acc[NMAT][4][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  if (warp == WARPS) {
    // the producer; the norms' exchange needs nothing of this warp
    if constexpr (GU) cluster_arrive();
    if (lane == 0) {
      if constexpr (GU)
        asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
      // down: the first stages' weights before a, which gate / up writes
      const int early = GU ? 0 : (n_chunks < STAGES ? n_chunks : STAGES);
      for (int q = 0; q < n_chunks; ++q) {
        const int s = q % STAGES;
        if (q >= STAGES)
          wg::mbar_wait(wg::smem_u32(empty + s), ((q / STAGES) & 1) ^ 1);
        const uint32_t bar = wg::smem_u32(full + s);
        const uint32_t dst = wg::smem_u32(smem + s * L::STAGE);
        const int row = k0 + q * CH;
        wg::arrive_expect_tx(bar, L::STAGE);
        wg::tma_2d(dst, &mw0, n0, row, bar);
        if constexpr (GU) wg::tma_2d(dst + W_BYTES, &mw1, n0, row, bar);
        if (q >= early)
          wg::tma_2d(dst + NMAT * W_BYTES, &ma, row, 0, bar);
        if (q == early - 1) {
          asm volatile("griddepcontrol.wait;\n" ::: "memory");
          for (int r = 0; r < early; ++r)
            wg::tma_2d(wg::smem_u32(smem + r * L::STAGE) + NMAT * W_BYTES,
                       &ma, k0 + r * CH, 0, wg::smem_u32(full + r));
        }
      }
    }
    __syncwarp();
    if constexpr (GU) cluster_wait();
  } else {
    const int cw = warp % CW, kw = warp / CW;
    if constexpr (GU) {
      // the rows' sums of squares over this slice (a warp a row), then
      // over the cluster's slices in slice order
      for (int m = warp; m < 16; m += WARPS) {
        float s = 0.f;
        if (m < M) {
          const uint4* xr = reinterpret_cast<const uint4*>(
              x + static_cast<long long>(m) * K + k0);
          for (int v = lane; v < klen / 8; v += 32) {
            const uint4 xv = __ldg(xr + v);
            const __nv_bfloat16* e =
                reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float f = __bfloat162float(e[j]);
              s = __fadd_rn(s, __fmul_rn(f, f));
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        if (lane == 0) ss[m] = s;
      }
      cluster_arrive();
      cluster_wait();
      if (threadIdx.x < 16) {
        const int m = threadIdx.x;
        const uint32_t at = wg::smem_u32(ss + m);
        float tot = wg::ld_cluster_f32(at, 0);
        for (int r = 1; r < slices; ++r)
          tot = __fadd_rn(tot, wg::ld_cluster_f32(at, r));
        rstd[m] = m < M
            ? __frsqrt_rn(__fadd_rn(__fdiv_rn(tot, static_cast<float>(K)),
                                    eps))
            : 0.f;
      }
      consumers_sync<WARPS>();
    }
    // gate / up: the thread's four values of each stage's x tile (row
    // threadIdx.x / 16, columns 4 (threadIdx.x % 16) ..) turned into xn by
    // the consumers together, once a stage
    const int xr = threadIdx.x >> 4, xc = (threadIdx.x & 15) * 4;
    const float xr_rstd = GU ? rstd[xr] : 0.f;
    const int w_col = cw * 32 + 4 * g;              // the lane's word
    const int mi = lane >> 3, mr = lane & 7;        // ldmatrix: matrix, row
    const uint32_t a_off = ((mi & 1) * 8 + mr) * 128 + (mi >> 1) * 16;
    for (int q = 0; q < n_chunks; ++q) {
      const int s = q % STAGES;
      float w[4];
      if constexpr (GU) norm_weights(nw, nw_bf16, k0 + q * CH + xc, w);
      wg::mbar_wait(wg::smem_u32(full + s), (q / STAGES) & 1);
      const uint32_t st = wg::smem_u32(smem + s * L::STAGE);
      const uint32_t at = st + NMAT * W_BYTES;
      if constexpr (GU) {
        scale_to_xn(at + swz(xr * 128 + xc * 2), xr_rstd, w);
        // the next copy into this stage (async proxy) after these writes
        wg::fence_async_smem();
        consumers_sync<WARPS>();
      }
#pragma unroll
      for (int h = 0; h < CH / 16 / KW; ++h) {
        const int kk = h * KW + kw;                 // the stage's k16 step
        uint32_t a[4];
        wg::ldsm_x4(a, at + swz(a_off + kk * 32));
        const int r0 = 16 * kk + 2 * t;
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          const uint32_t wt = st + m * W_BYTES;
          const uint32_t w0 = lds32(wt + swz(r0 * NT + w_col));
          const uint32_t w1 = lds32(wt + swz((r0 + 1) * NT + w_col));
          const uint32_t w2 = lds32(wt + swz((r0 + 8) * NT + w_col));
          const uint32_t w3 = lds32(wt + swz((r0 + 9) * NT + w_col));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wg::mma16816(acc[m][j], a, codes_to_bf16x2(w0, w1, j),
                         codes_to_bf16x2(w2, w3, j));
        }
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(wg::smem_u32(empty + s));
    }
  }

  // every copy has landed and been read: the ring takes the partials,
  // a lane's eight consecutive columns of rows g and g + 8
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (warp < WARPS) {
    const int cw = warp % CW, kw = warp / CW;
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = red + ((kw * NMAT + m) * 16 + g + 8 * h) * RED_LD +
                     cw * 32 + 8 * t;
        const int e = 2 * h;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[m][0][e], acc[m][1][e], acc[m][2][e],
                        acc[m][3][e]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[m][0][e + 1], acc[m][1][e + 1], acc[m][2][e + 1],
                        acc[m][3][e + 1]);
      }
  }
  wg::cluster_sync();
  // block `slice` adds every slice's partials (and the k warps' inside a
  // slice) in that order for its share of the tile's 8-column units, then
  // the epilogue
  constexpr int UNITS = 16 * NT / 8;
  for (int u = slice + slices * static_cast<int>(threadIdx.x); u < UNITS;
       u += slices * L::THREADS) {
    const int row = u / (NT / 8), cu = u % (NT / 8);
    if (row >= M) continue;
    float sum[NMAT][8];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sum[m][i] = 0.f;
      for (int r = 0; r < slices; ++r)
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          const uint32_t at = wg::smem_u32(
              red + ((k * NMAT + m) * 16 + row) * RED_LD + cu * 8);
          const float4 lo = wg::ld_cluster_f4(at, r);
          const float4 hi = wg::ld_cluster_f4(at + 16, r);
          const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            sum[m][i] = r == 0 && k == 0 ? v[i] : __fadd_rn(sum[m][i], v[i]);
        }
    }
    const int c = n0 + cu * 8;
    const long long o = static_cast<long long>(row) * N + c;
    const float4 sa0 = __ldg(reinterpret_cast<const float4*>(s0 + c));
    const float4 sa1 = __ldg(reinterpret_cast<const float4*>(s0 + c) + 1);
    const float sc0[8] = {sa0.x, sa0.y, sa0.z, sa0.w,
                          sa1.x, sa1.y, sa1.z, sa1.w};
    uint4 res;
    __nv_bfloat16* re = reinterpret_cast<__nv_bfloat16*>(&res);
    if constexpr (GU) {
      const float4 sb0 = __ldg(reinterpret_cast<const float4*>(s1 + c));
      const float4 sb1 = __ldg(reinterpret_cast<const float4*>(s1 + c) + 1);
      const float sc1[8] = {sb0.x, sb0.y, sb0.z, sb0.w,
                            sb1.x, sb1.y, sb1.z, sb1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        re[i] = __float2bfloat16_rn(
            sigmoid_silu_product(__fmul_rn(sum[0][i], sc0[i]),
                                 __fmul_rn(sum[NMAT - 1][i], sc1[i])));
    } else {
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + o));
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        re[i] = __float2bfloat16_rn(__fadd_rn(
            __bfloat162float(xe[i]), __fmul_rn(sum[0][i], sc0[i])));
    }
    *reinterpret_cast<uint4*>(out + o) = res;
  }
  wg::cluster_sync();    // no block leaves while another reads its partials
}

__global__ void __launch_bounds__(Cfg<true>::THREADS, 2)
decode_gate_up_kernel(const __grid_constant__ CUtensorMap mg,
                      const __grid_constant__ CUtensorMap mu,
                      const __grid_constant__ CUtensorMap mx,
                      const __nv_bfloat16* __restrict__ x,
                      const void* __restrict__ nw, int nw_bf16,
                      const float* __restrict__ sg,
                      const float* __restrict__ su,
                      __nv_bfloat16* __restrict__ a, int M, int d, int I,
                      float eps) {
  decode_mlp_block<true>(mg, mu, mx, x, nw, nw_bf16, sg, su, a, M, d, I,
                         eps);
}

__global__ void __launch_bounds__(Cfg<false>::THREADS, 2)
decode_down_kernel(const __grid_constant__ CUtensorMap md,
                   const __grid_constant__ CUtensorMap unused,
                   const __grid_constant__ CUtensorMap ma,
                   const __nv_bfloat16* __restrict__ x,
                   const void* __restrict__ nw, int nw_bf16,
                   const float* __restrict__ sd,
                   const float* __restrict__ s1,
                   __nv_bfloat16* __restrict__ out, int M, int I, int d,
                   float eps) {
  decode_mlp_block<false>(md, unused, ma, x, nw, nw_bf16, sd, s1, out, M, I,
                          d, eps);
}

// an int8 [rows, inner] matrix (row stride inner bytes) in boxes of
// [CH rows, NT bytes]; a bf16 [rows, inner] one in boxes of [16 rows, CH]
bool weight_map(CUtensorMap* map, const void* base, int inner, int rows) {
  return wg::tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, inner,
                           rows, inner, NT, CH, CU_TENSOR_MAP_SWIZZLE_128B);
}
bool act_map(CUtensorMap* map, const void* base, int inner, int rows) {
  return wg::tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
                           inner, rows, 2ull * inner, CH, 16,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool GU>
int launch(const CUtensorMap& mw0, const CUtensorMap& mw1,
           const CUtensorMap& ma, const void* x, const void* nw,
           int nw_bf16, const void* s0, const void* s1, void* out, int M,
           int K, int N, float eps, int slices, bool dependent,
           cudaStream_t st) {
  using L = Cfg<GU>;
  auto kernel = GU ? decode_gate_up_kernel : decode_down_kernel;
  cudaError_t err = wg::set_attributes_once(
      reinterpret_cast<const void*>(kernel), L::BYTES, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = slices;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, N / NT);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = dependent ? 2 : 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, mw0, mw1, ma, static_cast<const __nv_bfloat16*>(x),
      nw, nw_bf16, static_cast<const float*>(s0),
      static_cast<const float*>(s1), static_cast<__nv_bfloat16*>(out), M, K,
      N, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 [M, d]; nw [d], bf16 (nw_bf16) or f32; wg, wu int8 [d, I]; sg,
// su f32 [I]; wd int8
// [I, d]; sd f32 [d]; a scratch bf16 [M, I]; out bf16 [M, d]. Needs
// 1 <= M <= 16, d % 128 == 0, I % 256 == 0, 16-byte aligned arrays, and k
// slices (gate / up: gu_slices of d, down: dn_slices of I; 1 to 16) of
// whole 64-row stages. The down launch may start while gate / up drains
// (programmatic dependent launch). Launches both kernels on `stream`;
// returns the first cudaGetLastError() that is not 0.
extern "C" int fused_decode_mlp_bf16(const void* x, const void* nw,
                                     const void* wg, const void* sg,
                                     const void* wu, const void* su,
                                     const void* wd, const void* sd, void* a,
                                     void* out, int M, int d, int I,
                                     float eps, int gu_slices, int dn_slices,
                                     int nw_bf16, void* stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(nw) |
       reinterpret_cast<uintptr_t>(wg) | reinterpret_cast<uintptr_t>(sg) |
       reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(su) |
       reinterpret_cast<uintptr_t>(wd) | reinterpret_cast<uintptr_t>(sd) |
       reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out)) %
          16 == 0;
  if (M < 1 || M > 16 || d <= 0 || d % 128 || I <= 0 || I % 256 ||
      !aligned || gu_slices < 1 || gu_slices > MAX_SLICES ||
      dn_slices < 1 || dn_slices > MAX_SLICES || (d / CH) % gu_slices ||
      (I / CH) % dn_slices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap mg, mu, md, mx, mact;
  if (!weight_map(&mg, wg, I, d) || !weight_map(&mu, wu, I, d) ||
      !weight_map(&md, wd, d, I) || !act_map(&mx, x, d, M) ||
      !act_map(&mact, a, I, M))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = launch<true>(mg, mu, mx, x, nw, nw_bf16, sg, su, a, M, d, I,
                         eps, gu_slices, false, st);
  if (err) return err;
  return launch<false>(md, md, mact, x, nullptr, 0, sd, nullptr, out, M, I,
                       d, eps, dn_slices, true, st);
}
