// Fused LayerNorm -> int8 W1 -> GELU -> int8 W2 MLP (+ residual), for
// Hopper (sm_90a).
//
// Replaces: procyon_tpu/ops/fused_mlp.py::_kernel, reached through
// fused_ln_mlp_int8 -> _call. Per block of BM rows it mirrors the TPU
// kernel step for step:
//   1. LayerNorm in f32: var = mean((x-mean)^2), rsqrt(var+eps), affine;
//   2. sx = max(amax, 1e-8)/127, xq = clip(rint(h / sx), -127, 127);
//   3. for each hidden tile of width G (the requantization group, chosen by
//      the wrapper from the reference's block_n / sub_tiles rule):
//      a. s8 x s8 -> s32 product with W1[:, tile]  (mma.sync m16n8k32);
//      b. h1 = acc * (sx * s1) + b1;  g = 0.5 h1 (1 + tanh(0.851 h1));
//      c. per-row amax over the G columns, sg = max(amax, 1e-8)/127,
//         gq = clip(rint(g / sg), -127, 127);
//      d. s8 x s8 -> s32 product with W2[tile, :], then += acc2 * (sg*s2)
//         into an f32 accumulator;
//   4. + b2, + x when add_residual, cast to bf16.
// Rounding is half to even (rintf), divisions are IEEE, and products and
// sums that the reference rounds separately are kept apart (__fmul_rn /
// __fadd_rn) so that no FMA contraction moves a rounding tie.
//
// What bounds it on the H100: at ESM2-650M (M = 32768 rows, d = 1280,
// H = 5120) the two products are 859 G int8 ops per layer against 13 MB of
// weights, far above the ridge: it is bound by int8 tensor-core rate, and
// by how often each block re-reads the weights (from L2) per row it owns.
//
// What the design does about it: the [BM, G] hidden tile lives only in
// registers (int32 / f32) and shared memory (int8) and never goes to
// device memory, which is what the kernel is for. The [BM, d] f32 output
// accumulator stays in shared memory across all hidden tiles (BM = 32 at
// d = 1280 fits 227 KB with the int8 input rows; the wrapper drops to
// BM = 16 at d = 2560). 8 warps split each tile's W1 columns and then the
// output columns of W2. Operands are fed to mma.sync straight from shared
// memory (activations) and from global memory through L2 (weights, stored
// k-major so each lane loads 8 contiguous bytes). The contraction index
// inside each 32-wide step is permuted identically for A and B (lane t
// reads bytes 8t..8t+7), which leaves the product unchanged and allows the
// 8-byte loads. Later work: cp.async / TMA weight staging, wgmma, and a
// larger BM to cut the weight re-reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;
constexpr int NT = NW * 32;
constexpr int SMEM_LIMIT = 232448;

struct Layout {
  int lda, ldx, ldg;                       // row strides (floats, bytes)
  int off_sx, off_sg, off_red, off_xq, off_gq, total;  // byte offsets
};

__host__ __device__ inline int pad_int8_ld(int n) {
  // row stride in bytes with (stride / 4) % 32 == 8: the 8 rows of one
  // mma fragment load fall on distinct banks
  int words = n / 4;
  return n + 4 * ((8 - words % 32 + 32) % 32);
}

__host__ __device__ inline Layout layout(int BM, int d, int G) {
  Layout L;
  L.lda = d + 8;
  L.ldx = pad_int8_ld(d);
  L.ldg = pad_int8_ld(G);
  int off = BM * L.lda * 4;
  L.off_sx = off;
  off += BM * 4;
  L.off_sg = off;
  off += BM * 4;
  L.off_red = off;
  off += BM * NW * 4;
  off = (off + 15) & ~15;
  L.off_xq = off;
  off += BM * L.ldx;
  off = (off + 15) & ~15;
  L.off_gq = off;
  off += BM * L.ldg;
  L.total = (off + 15) & ~15;
  return L;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 32, row-major in shared memory, row stride ld bytes).
// Lane (g, t) takes bytes 8t..8t+7 of rows g and g+8: the first four
// stand for k = 4t..4t+3 of the instruction, the last four for
// k = 16+4t..16+4t+3; load_b uses the same correspondence.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* tile,
                                       int ld, int row0, int k0, int g,
                                       int t) {
  const uint2 lo =
      *reinterpret_cast<const uint2*>(tile + (row0 + g) * ld + k0 + t * 8);
  const uint2 hi = *reinterpret_cast<const uint2*>(tile + (row0 + g + 8) * ld +
                                                   k0 + t * 8);
  a[0] = lo.x;
  a[1] = hi.x;
  a[2] = lo.y;
  a[3] = hi.y;
}

// B fragment (32 x 8) from a k-major weight row: lane (g, t) reads bytes
// k0+8t..k0+8t+7 of output row n0+g.
__device__ __forceinline__ uint2 load_b(const int8_t* w, long long ld, int n0,
                                        int k0, int g, int t) {
  return __ldg(reinterpret_cast<const uint2*>(w + (long long)(n0 + g) * ld +
                                              k0 + t * 8));
}

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

// MT: 16-row m-tiles per block (BM = 16 * MT); NTL: n8-tiles of W1 columns
// per warp (G = 8 * NTL * NW).
template <int MT, int NTL>
__global__ void __launch_bounds__(NT, 1)
fused_ln_mlp_int8_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ lnw,
                         const float* __restrict__ lnb,
                         const int8_t* __restrict__ w1t,
                         const float* __restrict__ s1,
                         const float* __restrict__ b1,
                         const int8_t* __restrict__ w2t,
                         const float* __restrict__ s2,
                         const float* __restrict__ b2,
                         __nv_bfloat16* __restrict__ out, int d, int H,
                         float eps, int add_residual) {
  constexpr int BM = 16 * MT;
  constexpr int G = 8 * NTL * NW;
  const Layout L = layout(BM, d, G);
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  float* sx = reinterpret_cast<float*>(smem + L.off_sx);
  float* sg = reinterpret_cast<float*>(smem + L.off_sg);
  float* red = reinterpret_cast<float*>(smem + L.off_red);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + L.off_xq);
  int8_t* gq = reinterpret_cast<int8_t*>(smem + L.off_gq);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long m0 = (long long)blockIdx.x * BM;

  // 1-2: LayerNorm and per-row quantization, one warp per row
  for (int r = warp; r < BM; r += NW) {
    const __nv_bfloat16* xr = x + (m0 + r) * d;
    float* ar = acc + r * L.lda;
    float sum = 0.f;
    for (int c = lane; c < d; c += 32) sum += __bfloat162float(xr[c]);
    const float mean = __fdiv_rn(warp_sum(sum), (float)d);
    float vs = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float cx = __fsub_rn(__bfloat162float(xr[c]), mean);
      vs += cx * cx;
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(vs), (float)d),
                                        eps));
    float amax = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float cx = __fsub_rn(__bfloat162float(xr[c]), mean);
      const float h =
          __fadd_rn(__fmul_rn(__fmul_rn(cx, rstd), lnw[c]), lnb[c]);
      ar[c] = h;
      amax = fmaxf(amax, fabsf(h));
    }
    const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), 1.0f / 127.0f);
    for (int c = lane; c < d; c += 32) {
      xq[r * L.ldx + c] = quant(ar[c], s);
      ar[c] = 0.f;
    }
    if (lane == 0) sx[r] = s;
  }
  __syncthreads();

  const int n_tiles = H / G;
  for (int j = 0; j < n_tiles; ++j) {
    // 3a: this warp's NTL*8 columns of the hidden tile, all BM rows
    int acc1[MT][NTL][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[mt][nt][e] = 0;
    const int col0 = warp * NTL * 8;  // within the tile
    const int8_t* w1tile = w1t + (long long)(j * G + col0) * d;
    for (int k0 = 0; k0 < d; k0 += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a(a[mt], xq, L.ldx, mt * 16, k0, g, t);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const uint2 bw = load_b(w1tile, d, nt * 8, k0, g, t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc1[mt][nt], a[mt], bw.x, bw.y);
      }
    }

    // 3b: rescale, bias, GELU (kept as f32 bits in acc1), row amax
    float rmax[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      rmax[mt][0] = 0.f;
      rmax[mt][1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + (e >> 1) * 8;
          const int col = j * G + col0 + nt * 8 + t * 2 + (e & 1);
          const float h1 =
              __fadd_rn(__fmul_rn((float)acc1[mt][nt][e],
                                  __fmul_rn(sx[row], s1[col])),
                        b1[col]);
          const float gl = __fmul_rn(
              __fmul_rn(0.5f, h1),
              __fadd_rn(1.f, tanhf(__fmul_rn(0.851f, h1))));
          acc1[mt][nt][e] = __float_as_int(gl);
          rmax[mt][e >> 1] = fmaxf(rmax[mt][e >> 1], fabsf(gl));
        }
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        float v = rmax[mt][hlf];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (t == 0) red[(mt * 16 + g + hlf * 8) * NW + warp] = v;
      }
    }
    __syncthreads();

    // 3c: per-row scale over the whole G-wide tile, requantize into gq
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = mt * 16 + g + hlf * 8;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) v = fmaxf(v, red[row * NW + w]);
        const float s = __fmul_rn(fmaxf(v, 1e-8f), 1.0f / 127.0f);
        if (warp == 0 && t == 0) sg[row] = s;
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
          const int col = col0 + nt * 8 + t * 2;
          char2 pair;
          pair.x = quant(__int_as_float(acc1[mt][nt][hlf * 2]), s);
          pair.y = quant(__int_as_float(acc1[mt][nt][hlf * 2 + 1]), s);
          *reinterpret_cast<char2*>(gq + row * L.ldg + col) = pair;
        }
      }
    __syncthreads();

    // 3d: gq [BM, G] x W2[tile, :] -> f32 accumulator, 64 output columns
    // per warp and step
    for (int chunk = warp; chunk < d / 64; chunk += NW) {
      int acc2[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[mt][nt][e] = 0;
      const int8_t* w2tile = w2t + (long long)(chunk * 64) * H + j * G;
#pragma unroll 2
      for (int k0 = 0; k0 < G; k0 += 32) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a(a[mt], gq, L.ldg, mt * 16, k0, g, t);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint2 bw = load_b(w2tile, H, nt * 8, k0, g, t);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_s8(acc2[mt][nt], a[mt], bw.x, bw.y);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * 16 + g + (e >> 1) * 8;
            const int col = chunk * 64 + nt * 8 + t * 2 + (e & 1);
            float* p = acc + row * L.lda + col;
            *p = __fadd_rn(*p, __fmul_rn((float)acc2[mt][nt][e],
                                         __fmul_rn(sg[row], s2[col])));
          }
    }
    __syncthreads();  // gq, sg and red are rewritten by the next tile
  }

  // 4: + b2, + residual, cast
  for (int i = threadIdx.x; i < BM * d; i += NT) {
    const int r = i / d, c = i % d;
    float o = __fadd_rn(acc[r * L.lda + c], b2[c]);
    if (add_residual) o = __fadd_rn(o, __bfloat162float(x[(m0 + r) * d + c]));
    out[(m0 + r) * d + c] = __float2bfloat16_rn(o);
  }
}

template <int MT, int NTL>
int launch(const void* x, const void* lnw, const void* lnb, const void* w1t,
           const void* s1, const void* b1, const void* w2t, const void* s2,
           const void* b2, void* out, int M, int d, int H, float eps,
           int add_residual, cudaStream_t stream) {
  constexpr int BM = 16 * MT;
  constexpr int G = 8 * NTL * NW;
  const int bytes = layout(BM, d, G).total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_ln_mlp_int8_kernel<MT, NTL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ln_mlp_int8_kernel<MT, NTL><<<M / BM, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<const int8_t*>(w1t),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2t), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), d, H,
      eps, add_residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs, or -1 if it exceeds the limit.
extern "C" int fused_ln_mlp_int8_smem(int BM, int d, int G) {
  const int total = layout(BM, d, G).total;
  return total <= SMEM_LIMIT ? total : -1;
}

// x bf16 [M, d]; lnw, lnb, b2, s2 f32 [d]; w1t int8 [H, d] and w2t int8
// [d, H] (both k-major: contraction axis innermost); s1, b1 f32 [H];
// out bf16 [M, d]. Needs M % BM == 0, d % 64 == 0, H % G == 0,
// BM in {16, 32}, G in {256, 512}. Returns cudaGetLastError().
extern "C" int fused_ln_mlp_int8_bf16(const void* x, const void* lnw,
                                      const void* lnb, const void* w1t,
                                      const void* s1, const void* b1,
                                      const void* w2t, const void* s2,
                                      const void* b2, void* out, int M,
                                      int d, int H, int G, int BM, float eps,
                                      int add_residual, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BM == 32 && G == 512)
    return launch<2, 8>(x, lnw, lnb, w1t, s1, b1, w2t, s2, b2, out, M, d, H,
                        eps, add_residual, st);
  if (BM == 32 && G == 256)
    return launch<2, 4>(x, lnw, lnb, w1t, s1, b1, w2t, s2, b2, out, M, d, H,
                        eps, add_residual, st);
  if (BM == 16 && G == 512)
    return launch<1, 8>(x, lnw, lnb, w1t, s1, b1, w2t, s2, b2, out, M, d, H,
                        eps, add_residual, st);
  if (BM == 16 && G == 256)
    return launch<1, 4>(x, lnw, lnb, w1t, s1, b1, w2t, s2, b2, out, M, d, H,
                        eps, add_residual, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
