// RMSNorm -> W8A8 SwiGLU MLP -> residual for Hopper (sm_90a):
//   out = bf16(x + W8A8-SwiGLU(rms_norm(x)))
// with int8 gate / up [d, H] and down [H, d] in the JAX [in, out] layout,
// f32 per-column scales sg, su [H] and sd [d].
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
// 0.560 ms at 1,979 TOP/s; at H 14336 (Llama-3-8B) 0.729 ms.
//
// What the design does about it. Row 4's kernel keeps the [BM, d] f32
// output accumulator in shared memory; at d 4096 that is 256 KB at 16 rows,
// more than a block has. So three launches on one stream, no atomics:
//   rms_quant_rows: a warp a row, int8 rows and their scale to device memory;
//   gate_up: a block per (64 rows, one group of G hidden columns), the group
//     taken 128 columns at a time; its SiLU * u values wait in shared memory
//     until the group's amax over its 4 column warps (a fixed-order max in
//     shared memory) gives the scale; codes [M, H] and scales [M, H / G] go
//     to device memory (45 MB and 1.4 MB at the Bind shape);
//   down: a block per (64 rows, 128 output columns), over H in steps of 64;
//     at each group's end the int32 sums are scaled and summed as in step 4,
//     then the residual and the bf16 store.
// Products are mma.sync m16n8k32 (s8 in, s32 accumulate), 8 warps a block
// as 2 (rows) x 4 (32 columns). Tiles of 64 contraction bytes stream into a
// 3- or 4-stage ring of shared memory by cp.async (16 bytes a copy, rows
// past M zero-filled). The weights are read as they lie, [in, out], with no
// transposed copy: a lane reads one 32-bit word (4 columns at one k) from
// each of 4 neighbouring k rows and transposes the 4 x 4 bytes with
// __byte_perm, which gives its B fragments for 4 n8 tiles at once; so the
// fragment column n of n8 tile j is the chunk's column 4 n + j, and the
// epilogues map columns back. 16-byte chunks are XOR-swizzled by row so
// that the fragment reads of a warp fall on 32 distinct banks.
// Later work: wgmma and TMA, and the row pass folded into gate_up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;            // warps a block
constexpr int NT = NW * 32;
constexpr int BM = 64;           // rows a block
constexpr int BN = 128;          // columns a block (a tile of a group)
constexpr int BK = 64;           // contraction bytes a stage
constexpr int A_TILE = BM * BK;  // 4 KB
constexpr int B_TILE = BK * BN;  // 8 KB
constexpr int STAGES_GU = 3;
constexpr int STAGES_DN = 4;
constexpr int GU_STAGE = A_TILE + 2 * B_TILE;
constexpr int DN_STAGE = A_TILE + B_TILE;
constexpr int STASH_PER_SUB = 32 * NT * 4;   // 32 f32 values a thread
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ constexpr int gu_smem(int nsub) {
  return STAGES_GU * GU_STAGE + nsub * STASH_PER_SUB + BM * 4 * 4;
}
static_assert(gu_smem(4) <= SMEM_LIMIT, "gate_up at G 512 fits a block");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Byte offset of 16-byte chunk c of row r in an A tile (64-byte rows) and
// in a B tile (128-byte rows).
__device__ __forceinline__ int a_off(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}
__device__ __forceinline__ int b_off(int r, int c) {
  return r * BN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}

// A fragment of rows row0..row0+15 at contraction bytes kk..kk+31.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* As,
                                       int row0, int kk, int g, int t) {
  const int c = kk >> 4;
  a[0] = *reinterpret_cast<const uint32_t*>(As + a_off(row0 + g, c) + 4 * t);
  a[1] = *reinterpret_cast<const uint32_t*>(As + a_off(row0 + g + 8, c) +
                                            4 * t);
  a[2] = *reinterpret_cast<const uint32_t*>(As + a_off(row0 + g, c + 1) +
                                            4 * t);
  a[3] = *reinterpret_cast<const uint32_t*>(As + a_off(row0 + g + 8, c + 1) +
                                            4 * t);
}

// B fragments of the 4 n8 tiles of the 32-column chunk col0 at contraction
// rows k0 + 4t .. k0 + 4t + 3: word g of the chunk (its columns 4g..4g+3)
// from each row, transposed, so b[j] holds column 4g + j at the lane's 4 k.
__device__ __forceinline__ void load_b4(uint32_t (&b)[4], const int8_t* Bs,
                                        int k0, int col0, int g, int t) {
  const int c = (col0 >> 4) + (g >> 2);
  const int w = (g & 3) * 4;
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = *reinterpret_cast<const uint32_t*>(Bs + b_off(k0 + 4 * t + i, c) +
                                              w);
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  b[0] = __byte_perm(t0, t2, 0x5410);
  b[1] = __byte_perm(t0, t2, 0x7632);
  b[2] = __byte_perm(t1, t3, 0x5410);
  b[3] = __byte_perm(t1, t3, 0x7632);
}

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

// Gate / up for one group of G = 128 NSUB hidden columns and 64 rows:
// aq int8 [M, H] codes, sa f32 [M, H / G] scales.
template <int NSUB>
__global__ void __launch_bounds__(NT)
swiglu_gate_up_kernel(const int8_t* __restrict__ xq,
                      const float* __restrict__ sx,
                      const int8_t* __restrict__ wg,
                      const float* __restrict__ sg,
                      const int8_t* __restrict__ wu,
                      const float* __restrict__ su, int8_t* __restrict__ aq,
                      float* __restrict__ sa, int M, int d, int H) {
  constexpr int G = BN * NSUB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stash = reinterpret_cast<float*>(smem + STAGES_GU * GU_STAGE);
  float* red = stash + NSUB * 32 * NT;   // [BM][4]: the column warps' maxima

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int grp = blockIdx.y;
  const int KT = d / BK;
  const int total = NSUB * KT;

  auto load = [&](int slot, int it) {
    int8_t* As = reinterpret_cast<int8_t*>(smem + slot * GU_STAGE);
    int8_t* Bg = As + A_TILE;
    int8_t* Bu = Bg + B_TILE;
    const int sub = it / KT, kt = it % KT;
    {
      const int r = tid >> 2, c = tid & 3;
      const bool live = m0 + r < M;
      const int8_t* src = xq + (live ? m0 + r : 0) * d + kt * BK + c * 16;
      cp_async16(As + a_off(r, c), src, live ? 16 : 0);
    }
    const long long col0 = (long long)grp * G + sub * BN;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * NT;
      const int r = q >> 3, c = q & 7;
      const long long off = (long long)(kt * BK + r) * H + col0 + c * 16;
      cp_async16(Bg + b_off(r, c), wg + off, 16);
      cp_async16(Bu + b_off(r, c), wu + off, 16);
    }
  };

  int accg[2][4][4], accu[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[mt][j][e] = accu[mt][j][e] = 0;
  float rmax[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

#pragma unroll
  for (int s = 0; s < STAGES_GU - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES_GU - 2>();
    __syncthreads();
    {
      const int nx = it + STAGES_GU - 1;
      if (nx < total) load(nx % STAGES_GU, nx);
      cp_async_commit();
    }
    const int8_t* As =
        reinterpret_cast<const int8_t*>(smem + (it % STAGES_GU) * GU_STAGE);
    const int8_t* Bg = As + A_TILE;
    const int8_t* Bu = Bg + B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        load_a(a[mt], As, wm * 32 + mt * 16, kk, g, t);
      uint32_t b0[4], b1[4];
      load_b4(b0, Bg, kk, wn * 32, g, t);
      load_b4(b1, Bg, kk + 16, wn * 32, g, t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(accg[mt][j], a[mt], b0[j], b1[j]);
      load_b4(b0, Bu, kk, wn * 32, g, t);
      load_b4(b1, Bu, kk + 16, wn * 32, g, t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(accu[mt][j], a[mt], b0[j], b1[j]);
    }
    if (it % KT == KT - 1) {
      // this 128-column tile of the group: SiLU(g) * u into the stash
      const int sub = it / KT;
      float* st = stash + sub * 32 * NT;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = wm * 32 + mt * 16 + g + (e >> 1) * 8;
            const long long row = m0 + rl;
            const float sxr = row < M ? __ldg(sx + row) : 0.f;
            const long long col = (long long)grp * G + sub * BN + wn * 32 +
                                  8 * t + 4 * (e & 1) + j;
            const float gv = __fmul_rn((float)accg[mt][j][e],
                                       __fmul_rn(sxr, __ldg(sg + col)));
            const float uv = __fmul_rn((float)accu[mt][j][e],
                                       __fmul_rn(sxr, __ldg(su + col)));
            const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gv)));
            const float av = __fmul_rn(__fmul_rn(gv, sig), uv);
            st[((mt * 4 + j) * 4 + e) * NT + tid] = av;
            rmax[mt][e >> 1] = fmaxf(rmax[mt][e >> 1], fabsf(av));
            accg[mt][j][e] = 0;
            accu[mt][j][e] = 0;
          }
    }
  }

  // the group's amax a row: over the lane's 4 t, then over the 4 column
  // warps in shared memory
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rmax[mt][h];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) red[(wm * 32 + mt * 16 + g + h * 8) * 4 + wn] = v;
    }
  __syncthreads();
  const int n_groups = H / G;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 32 + mt * 16 + g + h * 8;
      const long long row = m0 + rl;
      float v = red[rl * 4];
#pragma unroll
      for (int w = 1; w < 4; ++w) v = fmaxf(v, red[rl * 4 + w]);
      const float s = __fmul_rn(fmaxf(v, 1e-8f), 1.0f / 127.0f);
      if (row >= M) continue;
      if (wn == 0 && t == 0) sa[row * n_groups + grp] = s;
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        const float* st = stash + sub * 32 * NT;
        uint32_t codes[2] = {0u, 0u};
#pragma unroll
        for (int lo = 0; lo < 2; ++lo)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = h * 2 + lo;
            const float av = st[((mt * 4 + j) * 4 + e) * NT + tid];
            codes[lo] |= static_cast<uint32_t>(static_cast<uint8_t>(
                             quant(av, s))) << (8 * j);
          }
        *reinterpret_cast<uint2*>(aq + row * H + (long long)grp * G +
                                  sub * BN + wn * 32 + 8 * t) =
            make_uint2(codes[0], codes[1]);
      }
    }
}

// Down product, scales and residual: out bf16 [M, d] for 64 rows and 128
// output columns.
__global__ void __launch_bounds__(NT)
swiglu_down_kernel(const int8_t* __restrict__ aq,
                   const float* __restrict__ sa,
                   const int8_t* __restrict__ wd,
                   const float* __restrict__ sd,
                   const __nv_bfloat16* __restrict__ x,
                   __nv_bfloat16* __restrict__ out, int M, int d, int H,
                   int G, int SPG) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int KT = H / BK;
  const int tiles_a_group = G / BK;
  const int n_groups = H / G;

  auto load = [&](int slot, int kt) {
    int8_t* As = reinterpret_cast<int8_t*>(smem + slot * DN_STAGE);
    int8_t* Bs = As + A_TILE;
    {
      const int r = tid >> 2, c = tid & 3;
      const bool live = m0 + r < M;
      const int8_t* src =
          aq + (live ? m0 + r : 0) * (long long)H + kt * BK + c * 16;
      cp_async16(As + a_off(r, c), src, live ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * NT;
      const int r = q >> 3, c = q & 7;
      cp_async16(Bs + b_off(r, c),
                 wd + (long long)(kt * BK + r) * d + n0 + c * 16, 16);
    }
  };

  int acc[2][4][4];
  float tot[2][4][4], accf[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][j][e] = 0;
        tot[mt][j][e] = 0.f;
        accf[mt][j][e] = 0.f;
      }
  float sdc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int lo = 0; lo < 2; ++lo)
      sdc[j][lo] = __ldg(sd + n0 + wn * 32 + 8 * t + 4 * lo + j);

#pragma unroll
  for (int s = 0; s < STAGES_DN - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES_DN - 2>();
    __syncthreads();
    {
      const int nx = kt + STAGES_DN - 1;
      if (nx < KT) load(nx % STAGES_DN, nx);
      cp_async_commit();
    }
    const int8_t* As =
        reinterpret_cast<const int8_t*>(smem + (kt % STAGES_DN) * DN_STAGE);
    const int8_t* Bs = As + A_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        load_a(a[mt], As, wm * 32 + mt * 16, kk, g, t);
      uint32_t b0[4], b1[4];
      load_b4(b0, Bs, kk, wn * 32, g, t);
      load_b4(b1, Bs, kk + 16, wn * 32, g, t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a[mt], b0[j], b1[j]);
    }
    if ((kt + 1) % tiles_a_group == 0) {
      // a group ends: part = acc * (sa * sd); the step's groups summed in
      // order, then into the accumulator
      const int grp = kt / tiles_a_group;
      const int q = grp % SPG;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = m0 + wm * 32 + mt * 16 + g + h * 8;
          const float sar =
              row < M ? __ldg(sa + row * n_groups + grp) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int lo = 0; lo < 2; ++lo) {
              const int e = h * 2 + lo;
              const float part = __fmul_rn((float)acc[mt][j][e],
                                           __fmul_rn(sar, sdc[j][lo]));
              tot[mt][j][e] = q == 0 ? part : __fadd_rn(tot[mt][j][e], part);
              if (q == SPG - 1)
                accf[mt][j][e] = __fadd_rn(accf[mt][j][e], tot[mt][j][e]);
              acc[mt][j][e] = 0;
            }
        }
    }
  }

  // + x in f32, one cast; a lane's 8 columns of a row are contiguous
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm * 32 + mt * 16 + g + h * 8;
      if (row >= M) continue;
      const long long base = row * d + n0 + wn * 32 + 8 * t;
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + base));
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
      uint4 ov;
      __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
      for (int lo = 0; lo < 2; ++lo)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * lo + j;
          oe[c] = __float2bfloat16_rn(
              __fadd_rn(accf[mt][j][h * 2 + lo], __bfloat162float(xe[c])));
        }
      *reinterpret_cast<uint4*>(out + base) = ov;
    }
}

template <int NSUB>
int launch_gate_up(const int8_t* xq, const float* sx, const int8_t* wg,
                   const float* sg, const int8_t* wu, const float* su,
                   int8_t* aq, float* sa, int M, int d, int H,
                   cudaStream_t st) {
  const int bytes = gu_smem(NSUB);
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_gate_up_kernel<NSUB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, H / (BN * NSUB));
  swiglu_gate_up_kernel<NSUB><<<grid, NT, bytes, st>>>(xq, sx, wg, sg, wu, su,
                                                       aq, sa, M, d, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 [M, d]; nw f32 [d]; wg, wu int8 [d, H] and wd int8 [H, d] ([in,
// out]); sg, su f32 [H]; sd f32 [d]; scratch xq int8 [M, d], sx f32 [M],
// aq int8 [M, H], sa f32 [M, H / G]; out bf16 [M, d]. Needs d % 128 == 0,
// H % 128 == 0, G in {128, 256, 384, 512} dividing H, H % (G * SPG) == 0,
// 16-byte aligned tensors. Three launches on `stream`; returns the first
// cudaGetLastError() that is not 0.
extern "C" int fused_rms_swiglu_int8_bf16(
    const void* x, const void* nw, const void* wg, const void* sg,
    const void* wu, const void* su, const void* wd, const void* sd, void* xq,
    void* sx, void* aq, void* sa, void* out, int M, int d, int H, int G,
    int SPG, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  if (d % 128 || H % 128 || G % 128 || G > 512 || H % G || SPG < 1 ||
      (H / G) % SPG)
    return static_cast<int>(cudaErrorInvalidValue);
  rms_quant_rows_kernel<<<(M + NW - 1) / NW, NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(nw),
      static_cast<int8_t*>(xq), static_cast<float*>(sx), M, d, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int8_t* xq8 = static_cast<const int8_t*>(xq);
  const float* sxf = static_cast<const float*>(sx);
  const int8_t* wg8 = static_cast<const int8_t*>(wg);
  const int8_t* wu8 = static_cast<const int8_t*>(wu);
  const float* sgf = static_cast<const float*>(sg);
  const float* suf = static_cast<const float*>(su);
  int8_t* aq8 = static_cast<int8_t*>(aq);
  float* saf = static_cast<float*>(sa);
  switch (G / BN) {
    case 1: err = launch_gate_up<1>(xq8, sxf, wg8, sgf, wu8, suf, aq8, saf, M, d, H, st); break;
    case 2: err = launch_gate_up<2>(xq8, sxf, wg8, sgf, wu8, suf, aq8, saf, M, d, H, st); break;
    case 3: err = launch_gate_up<3>(xq8, sxf, wg8, sgf, wu8, suf, aq8, saf, M, d, H, st); break;
    default: err = launch_gate_up<4>(xq8, sxf, wg8, sgf, wu8, suf, aq8, saf, M, d, H, st); break;
  }
  if (err) return err;
  const int bytes = STAGES_DN * DN_STAGE;
  cudaError_t e = cudaFuncSetAttribute(
      swiglu_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + BM - 1) / BM, d / BN);
  swiglu_down_kernel<<<grid, NT, bytes, st>>>(
      aq8, saf, static_cast<const int8_t*>(wd), static_cast<const float*>(sd),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      M, d, H, G, SPG);
  return static_cast<int>(cudaGetLastError());
}
