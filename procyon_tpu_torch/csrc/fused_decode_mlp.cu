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
// What the design does about it. Two launches on one stream, no atomics
// (results are bitwise the same run to run):
//   gate_up: a block per 64 columns of I (224 blocks at I 14336, all
//     resident at once), 8 warps splitting d; each block recomputes the row
//     norms (x is 128 KB and stays in L2) while its first weight tiles
//     load; each warp streams its [d/8, 64] slices of Wg and Wu once, and
//     the warps' partial sums are added in a fixed order in shared memory
//     before the scales, SiLU and the product; a [M, I] (458 KB at M 16)
//     goes to device memory.
//   down: a block per 32 output columns (128 blocks at d 4096), 16 warps
//     splitting I, a read from L2; the same fixed-order sum, then the
//     column scale and the residual.
// Each warp keeps its own ring of weight tiles in shared memory, filled by
// cp.async (16 bytes a copy, L1 bypassed) STAGES - 1 steps ahead of the
// products; a step is 16 weight rows of the block's columns. The
// activation rows of the next step are loaded into registers one step
// ahead.
// The products are mma.sync m16n8k16 (bf16 in, f32 accumulate): the int8
// -> bf16 conversion is exact. A lane takes CPL neighbouring columns (8 in
// gate_up, 4 in down) of each of 4 neighbouring weight rows of a tile; the
// mma's contraction and column indices are permuted to match (k: the lane
// of group t takes rows 4t..4t+3 of the 16-row step, for A and B alike;
// n: byte f of the lane of group g is column CPL g + f of fragment f).
// Rows of A past M are zero.
// The first version loaded the weights into registers a few steps ahead,
// 32 columns a block in both launches: 147.9 us a layer at M 16 against
// 109.9 for this one (chip_smoke.py; H100 80GB HBM3, 700 W; PERF.md).
// Later work: TMA bulk tiles, wider row segments in the down launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW_GU = 8;       // warps of the gate / up launch
constexpr int NW_DN = 16;      // warps of the down launch
constexpr int CPL_GU = 8;      // columns a lane: 64 a block, 224 blocks
constexpr int CPL_DN = 4;      // 32 a block, 128 blocks
// ring stages a warp: 64 KB of dynamic shared memory a block in the
// gate / up launch (two 1 KB tiles a step), 48 KB of static shared memory
// in the down launch (one 512-byte tile)
constexpr int STAGES_GU = 4;
constexpr int STAGES_DN = 6;
constexpr int SMEM_GU = NW_GU * STAGES_GU * 2 * 16 * 8 * CPL_GU;

template <int CPL>
struct Tile {
  static constexpr int COLS = 8 * CPL;       // columns of a block
  static constexpr int BYTES = 16 * COLS;    // 16 rows of one matrix
  static constexpr int CHUNKS = BYTES / 16;  // 16-byte copies
  // Row R of a step sits at (R % 4) * 4 * COLS + (R / 4) * COLS: the lanes
  // that read rows 4t + r at one column fall in distinct groups of banks
  // (two-way at most for 8-byte reads).
  __device__ static int row(int R) { return (R & 3) * 4 * COLS + (R >> 2) * COLS; }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The warp copies a step's tile (rows k .. k + 15, columns c0 .. c0 + COLS
// - 1 of a matrix of row stride ld) 16 bytes a lane and copy.
template <int CPL>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const int8_t* w, long long ld,
                                          int k, int c0, int lane) {
  using T = Tile<CPL>;
  constexpr int PER_ROW = T::COLS / 16;
#pragma unroll
  for (int c = lane; c < T::CHUNKS; c += 32) {
    const int R = c / PER_ROW, h = c % PER_ROW;
    cp_async16(tile + T::row(R) + 16 * h,
               w + (long long)(k + R) * ld + c0 + 16 * h);
  }
}

// The lane's words of a tile: w[r][j] holds columns CPL g + 4j .. + 3 of
// row 4t + r.
template <int CPL>
__device__ __forceinline__ void tile_words(const unsigned char* tile, int g,
                                           int t, uint32_t (&w)[4][CPL / 4]) {
  using T = Tile<CPL>;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const unsigned char* p = tile + T::row(4 * t + r) + CPL * g;
    if constexpr (CPL == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[r][0] = v.x;
      w[r][1] = v.y;
    } else {
      w[r][0] = *reinterpret_cast<const uint32_t*>(p);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Signed byte f of w as an exact float: 2^23 + (byte ^ 0x80) in the bits
// of a float, less 2^23 + 128.
__device__ __forceinline__ float byte_to_float(uint32_t w_biased, int f) {
  const uint32_t bits = __byte_perm(w_biased, 0x4B000000u, f | 0x7440);
  return __int_as_float(bits) - 8388736.0f;
}

// The lane's products with one matrix's step: fragment f takes byte f of
// the lane's columns (column CPL g + f), rows 4t .. 4t + 3.
template <int CPL>
__device__ __forceinline__ void mma_step(float (&acc)[CPL][4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&w)[4][CPL / 4]) {
#pragma unroll
  for (int j = 0; j < CPL / 4; ++j) {
    uint32_t u[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) u[r] = w[r][j] ^ 0x80808080u;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const uint32_t b0 = pack_bf16(byte_to_float(u[0], f),
                                    byte_to_float(u[1], f));
      const uint32_t b1 = pack_bf16(byte_to_float(u[2], f),
                                    byte_to_float(u[3], f));
      mma_bf16(acc[4 * j + f], a, b0, b1);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over warps, in warp order, of a [NWARPS][16][COLS] f32 buffer.
template <int NWARPS, int COLS>
__device__ __forceinline__ float warp_partials(const float* red, int m, int c) {
  float s = red[m * COLS + c];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) s = __fadd_rn(s, red[(w * 16 + m) * COLS + c]);
  return s;
}

// A warp's C fragments to red[16][COLS]: fragment f, position p (0..7) is
// column CPL p + f.
template <int CPL>
__device__ __forceinline__ void store_c(float* red, const float (&c)[CPL][4],
                                        int g, int t) {
  constexpr int COLS = Tile<CPL>::COLS;
#pragma unroll
  for (int f = 0; f < CPL; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = g + (e >> 1) * 8;
      const int p = t * 2 + (e & 1);
      red[m * COLS + CPL * p + f] = c[f][e];
    }
}

// xn of rows g and g + 8 at k .. k + 3 as an A fragment
__device__ __forceinline__ void xn_frag(uint2 xlo, uint2 xhi, float4 wn,
                                        float r_lo, float r_hi,
                                        uint32_t (&a)[4]) {
  const __nv_bfloat162 l0 = *reinterpret_cast<const __nv_bfloat162*>(&xlo.x);
  const __nv_bfloat162 l1 = *reinterpret_cast<const __nv_bfloat162*>(&xlo.y);
  const __nv_bfloat162 h0 = *reinterpret_cast<const __nv_bfloat162*>(&xhi.x);
  const __nv_bfloat162 h1 = *reinterpret_cast<const __nv_bfloat162*>(&xhi.y);
  a[0] = pack_bf16(__fmul_rn(__fmul_rn(__low2float(l0), r_lo), wn.x),
                   __fmul_rn(__fmul_rn(__high2float(l0), r_lo), wn.y));
  a[2] = pack_bf16(__fmul_rn(__fmul_rn(__low2float(l1), r_lo), wn.z),
                   __fmul_rn(__fmul_rn(__high2float(l1), r_lo), wn.w));
  a[1] = pack_bf16(__fmul_rn(__fmul_rn(__low2float(h0), r_hi), wn.x),
                   __fmul_rn(__fmul_rn(__high2float(h0), r_hi), wn.y));
  a[3] = pack_bf16(__fmul_rn(__fmul_rn(__low2float(h1), r_hi), wn.z),
                   __fmul_rn(__fmul_rn(__high2float(h1), r_hi), wn.w));
}

__global__ void __launch_bounds__(NW_GU * 32, 2)
decode_gate_up_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ nw,
                      const int8_t* __restrict__ wg,
                      const float* __restrict__ sg,
                      const int8_t* __restrict__ wu,
                      const float* __restrict__ su,
                      __nv_bfloat16* __restrict__ a_out, int M, int d, int I,
                      float eps) {
  using T = Tile<CPL_GU>;
  constexpr int COLS = T::COLS;
  constexpr int STAGE = 2 * T::BYTES;
  // the rings while the products run, the warps' partial sums after
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(NW_GU * STAGES_GU * STAGE == SMEM_GU, "ring");
  static_assert(NW_GU * 16 * COLS * 4 <= SMEM_GU, "red");
  __shared__ float rstd[16];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = blockIdx.x * COLS;
  const int kspan = d / NW_GU;
  const int kbeg = warp * kspan;
  const int nsteps = kspan / 16;
  unsigned char* ring = smem + warp * STAGES_GU * STAGE;

  // the first weight tiles load while the row norms are computed
#pragma unroll
  for (int s = 0; s < STAGES_GU - 1; ++s) {
    if (s < nsteps) {
      load_tile<CPL_GU>(ring + s * STAGE, wg, I, kbeg + 16 * s, c0, lane);
      load_tile<CPL_GU>(ring + s * STAGE + T::BYTES, wu, I, kbeg + 16 * s,
                        c0, lane);
    }
    cp_async_commit();
  }

  // the row norms: rstd = rsqrt(mean(x^2) + eps), one warp a row, 8
  // values a load
  for (int m = warp; m < M; m += NW_GU) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)m * d);
    float s = 0.f;
#pragma unroll 4
    for (int v = lane; v < d / 8; v += 32) {
      const uint4 xv = __ldg(xr + v);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(e[j]);
        s = __fadd_rn(s, __fmul_rn(f, f));
      }
    }
    s = warp_sum(s);
    if (lane == 0) rstd[m] = __frsqrt_rn(__fadd_rn(__fdiv_rn(s, (float)d), eps));
  }
  __syncthreads();

  const bool lo_ok = g < M, hi_ok = g + 8 < M;
  const float r_lo = lo_ok ? rstd[g] : 0.f;
  const float r_hi = hi_ok ? rstd[g + 8] : 0.f;
  const __nv_bfloat16* x_lo = x + (long long)(lo_ok ? g : 0) * d + 4 * t;
  const __nv_bfloat16* x_hi = x + (long long)(hi_ok ? g + 8 : 0) * d + 4 * t;
  const uint2 zero2 = make_uint2(0u, 0u);
  float accg[CPL_GU][4] = {}, accu[CPL_GU][4] = {};
  // the activation rows of step 0; each step loads the next one's
  int k = kbeg;
  uint2 xlo = lo_ok ? *reinterpret_cast<const uint2*>(x_lo + k) : zero2;
  uint2 xhi = hi_ok ? *reinterpret_cast<const uint2*>(x_hi + k) : zero2;
  float4 wn = *reinterpret_cast<const float4*>(nw + k + 4 * t);

  for (int i = 0; i < nsteps; ++i, k += 16) {
    uint32_t a[4];
    xn_frag(xlo, xhi, wn, r_lo, r_hi, a);
    if (i + 1 < nsteps) {
      xlo = lo_ok ? *reinterpret_cast<const uint2*>(x_lo + k + 16) : zero2;
      xhi = hi_ok ? *reinterpret_cast<const uint2*>(x_hi + k + 16) : zero2;
      wn = *reinterpret_cast<const float4*>(nw + k + 16 + 4 * t);
    }
    cp_async_wait<STAGES_GU - 2>();
    __syncwarp();
    const unsigned char* st = ring + (i % STAGES_GU) * STAGE;
    uint32_t wgw[4][CPL_GU / 4], wuw[4][CPL_GU / 4];
    tile_words<CPL_GU>(st, g, t, wgw);
    tile_words<CPL_GU>(st + T::BYTES, g, t, wuw);
    // the stage read one step ago is free for the step STAGES - 1 ahead
    const int ahead = i + STAGES_GU - 1;
    if (ahead < nsteps) {
      unsigned char* nx = ring + (ahead % STAGES_GU) * STAGE;
      load_tile<CPL_GU>(nx, wg, I, kbeg + 16 * ahead, c0, lane);
      load_tile<CPL_GU>(nx + T::BYTES, wu, I, kbeg + 16 * ahead, c0, lane);
    }
    cp_async_commit();
    mma_step<CPL_GU>(accg, a, wgw);
    mma_step<CPL_GU>(accu, a, wuw);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // the warps' sums of g, then of u, through one [NW_GU][16][COLS] buffer
  constexpr int PER_THREAD = 16 * COLS / (NW_GU * 32);
  float* red = reinterpret_cast<float*>(smem);
  float gv[PER_THREAD];
  store_c<CPL_GU>(red + warp * 16 * COLS, accg, g, t);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * NW_GU * 32;
    const int m = i / COLS, c = i % COLS;
    gv[j] = m < M ? __fmul_rn(warp_partials<NW_GU, COLS>(red, m, c), sg[c0 + c])
                  : 0.f;
  }
  __syncthreads();
  store_c<CPL_GU>(red + warp * 16 * COLS, accu, g, t);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * NW_GU * 32;
    const int m = i / COLS, c = i % COLS;
    if (m < M) {
      const float uv = __fmul_rn(warp_partials<NW_GU, COLS>(red, m, c),
                                 su[c0 + c]);
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gv[j])));
      a_out[(long long)m * I + c0 + c] =
          __float2bfloat16_rn(__fmul_rn(__fmul_rn(gv[j], sig), uv));
    }
  }
}

__global__ void __launch_bounds__(NW_DN * 32)
decode_down_kernel(const __nv_bfloat16* __restrict__ a_in,
                   const int8_t* __restrict__ wd,
                   const float* __restrict__ sd,
                   const __nv_bfloat16* __restrict__ x,
                   __nv_bfloat16* __restrict__ out, int M, int d, int I) {
  using T = Tile<CPL_DN>;
  constexpr int COLS = T::COLS;
  __shared__ __align__(16) unsigned char smem[NW_DN * STAGES_DN * T::BYTES];
  static_assert(NW_DN * 16 * COLS * 4 <= NW_DN * STAGES_DN * T::BYTES, "red");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = blockIdx.x * COLS;
  const bool lo_ok = g < M, hi_ok = g + 8 < M;
  const int kspan = I / NW_DN;
  const int kbeg = warp * kspan;
  const int nsteps = kspan / 16;
  unsigned char* ring = smem + warp * STAGES_DN * T::BYTES;

#pragma unroll
  for (int s = 0; s < STAGES_DN - 1; ++s) {
    if (s < nsteps)
      load_tile<CPL_DN>(ring + s * T::BYTES, wd, d, kbeg + 16 * s, c0, lane);
    cp_async_commit();
  }

  const __nv_bfloat16* a_lo = a_in + (long long)(lo_ok ? g : 0) * I + 4 * t;
  const __nv_bfloat16* a_hi = a_in + (long long)(hi_ok ? g + 8 : 0) * I + 4 * t;
  const uint2 zero2 = make_uint2(0u, 0u);
  float acc[CPL_DN][4] = {};
  int k = kbeg;
  uint2 alo = lo_ok ? *reinterpret_cast<const uint2*>(a_lo + k) : zero2;
  uint2 ahi = hi_ok ? *reinterpret_cast<const uint2*>(a_hi + k) : zero2;

  for (int i = 0; i < nsteps; ++i, k += 16) {
    const uint32_t a[4] = {alo.x, ahi.x, alo.y, ahi.y};
    if (i + 1 < nsteps) {
      alo = lo_ok ? *reinterpret_cast<const uint2*>(a_lo + k + 16) : zero2;
      ahi = hi_ok ? *reinterpret_cast<const uint2*>(a_hi + k + 16) : zero2;
    }
    cp_async_wait<STAGES_DN - 2>();
    __syncwarp();
    uint32_t ww[4][CPL_DN / 4];
    tile_words<CPL_DN>(ring + (i % STAGES_DN) * T::BYTES, g, t, ww);
    const int ahead = i + STAGES_DN - 1;
    if (ahead < nsteps)
      load_tile<CPL_DN>(ring + (ahead % STAGES_DN) * T::BYTES, wd, d,
                        kbeg + 16 * ahead, c0, lane);
    cp_async_commit();
    mma_step<CPL_DN>(acc, a, ww);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem);  // [NW_DN][16][COLS]
  store_c<CPL_DN>(red + warp * 16 * COLS, acc, g, t);
  __syncthreads();
  for (int i = threadIdx.x; i < M * COLS; i += NW_DN * 32) {
    const int m = i / COLS, c = i % COLS;
    const long long o = (long long)m * d + c0 + c;
    const float v = __fmul_rn(warp_partials<NW_DN, COLS>(red, m, c), sd[c0 + c]);
    out[o] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(x[o]), v));
  }
}

}  // namespace

// x bf16 [M, d]; nw f32 [d]; wg, wu int8 [d, I]; sg, su f32 [I]; wd int8
// [I, d]; sd f32 [d]; a scratch bf16 [M, I]; out bf16 [M, d]. Needs
// 1 <= M <= 16, d % 128 == 0, I % 256 == 0, 16-byte aligned arrays.
// Launches both kernels on `stream`; returns cudaGetLastError().
extern "C" int fused_decode_mlp_bf16(const void* x, const void* nw,
                                     const void* wg, const void* sg,
                                     const void* wu, const void* su,
                                     const void* wd, const void* sd, void* a,
                                     void* out, int M, int d, int I,
                                     float eps, void* stream) {
  if (M < 1 || M > 16 || d % 128 || I % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      decode_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_GU);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_gate_up_kernel<<<I / Tile<CPL_GU>::COLS, NW_GU * 32, SMEM_GU, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(nw),
      static_cast<const int8_t*>(wg), static_cast<const float*>(sg),
      static_cast<const int8_t*>(wu), static_cast<const float*>(su),
      static_cast<__nv_bfloat16*>(a), M, d, I, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_down_kernel<<<d / Tile<CPL_DN>::COLS, NW_DN * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const int8_t*>(wd),
      static_cast<const float*>(sd), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), M, d, I);
  return static_cast<int>(cudaGetLastError());
}
