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
// bound is bytes. What the design does about it:
//   * one warp owns a [16 * MT rows, 32 columns] output tile over a slice
//     of k; lane (g, t) loads one 32-bit word of four packed columns
//     4g..4g+3 for each of its four k rows, so a warp's load covers whole
//     32-byte sectors of four rows, straight from device memory into
//     registers. A chunk of 16 * STEPS packed rows (a whole group of 128)
//     is loaded at once: 32 loads of 128 bytes in flight a warp;
//   * byte j of the four words feeds n8-tile j: tile j's column c stands
//     for physical column 4c + j. The C fragments of the four tiles then
//     hold eight consecutive physical columns a lane: one 16-byte store;
//   * inside a k16 step the contraction index is permuted identically for
//     A and B (the lane's mma slots 2t, 2t+1, 2t+8, 2t+9 stand for rows
//     4t..4t+3), which leaves the product unchanged and makes the x read
//     one 8-byte word a row;
//   * the eight warps of a block own neighbouring column tiles of one k
//     slice, so they need the same rows of x: the block copies each
//     chunk's two x tiles (low and high half of k) into shared memory with
//     cp.async, double buffered, rows 32 bytes apart in the banks. (The
//     first version read x from global memory in every warp: twice the
//     weights' traffic through L2, and 0.54 ms on the head against 0.15);
//   * nibbles become bf16 with integer ops only: 0x4300 | v is 128 + v in
//     bf16, and one bf16x2 subtraction of 136 removes the bias (the high
//     nibble is first xor-ed with 8, which turns the signed nibble into
//     q + 8);
//   * the grid is one warp per (column tile, k slice, row block). A grid
//     over column tiles alone underfills 132 SMs at n = 1024 or 4096, so
//     the wrapper splits k into slices of whole groups; each slice writes
//     an f32 partial and a second kernel adds the slices in a fixed order
//     (no atomics: the result does not change from run to run). With one
//     slice the first kernel writes bf16 itself.
// rows, k, n and the group size are arguments; the last row tile is masked.
// Later work: TMA for the packed words, a reduction of the k slices inside
// a cluster instead of through device memory, wgmma for the 256-row
// prefill chunks (a block of 32 rows re-reads the weights 8 times there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two nibble codes v (0..15) in bits 0..3 and 16..19 -> bf16x2 (v - 8)
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t v) {
  uint32_t biased = v | 0x43004300u;              // 128 + v, exact
  const uint32_t off = 0x43084308u;               // 136
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&biased),
                             *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// MT: 16-row tiles a warp owns. STEPS: k16 steps of one chunk; a chunk's
// 16 * STEPS packed rows lie inside one group.
template <int MT, int STEPS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ p,
                   const float* __restrict__ s,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   int rows, int k, int n, int group, long long ldx,
                   long long ldp, long long lds, int ksplit, int mblocks) {
  constexpr int R = 16 * MT;               // rows of the block's x tile
  constexpr int CH = 16 * STEPS;           // packed rows of a chunk
  constexpr int LDS = CH + 16;             // tile row stride: rows 32 B apart
                                           // in the banks, no conflicts
  // x tiles of the low and the high half of k, double buffered
  __shared__ __align__(16) __nv_bfloat16 xs[2][2][R][LDS];

  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = n >> 5;
  // tiles_n is a multiple of `warps`: a block's warps own neighbouring
  // column tiles of one (k slice, row block) and share its x tiles
  const long long item = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  const int col_tile = (int)(item % tiles_n);
  const long long rest = item / tiles_n;
  const int slice = (int)(rest % ksplit);
  const int mblock = (int)(rest / ksplit);

  const int k2 = k >> 1;
  const int n_pg = k2 / group;              // packed groups (= low groups)
  const int pg0 = (int)((long long)slice * n_pg / ksplit);
  const int pg1 = (int)((long long)(slice + 1) * n_pg / ksplit);
  const int n0 = col_tile << 5;
  const int row_base = mblock * R;
  const int chunks_per_group = group / CH;
  const int n_chunks = (pg1 - pg0) * chunks_per_group;

  // the block copies chunk q's x tiles: 16-byte pieces, rows past the end
  // filled with zeros
  auto stage = [&](int q, int buf) {
    const long long kx =
        (long long)(pg0 + q / chunks_per_group) * group +
        (q % chunks_per_group) * CH;
    constexpr int PER_ROW = CH / 8;
    for (int i = threadIdx.x; i < 2 * R * PER_ROW; i += blockDim.x) {
      const int half = i / (R * PER_ROW);
      const int row = (i / PER_ROW) % R;
      const int col = (i % PER_ROW) * 8;
      __nv_bfloat16* dst = &xs[buf][half][row][col];
      if (row_base + row < rows) {
        cp_async16(dst, x + (long long)(row_base + row) * ldx +
                            (half ? k2 : 0) + kx + col);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float total[MT][4][4], acc_lo[MT][4][4], acc_hi[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        total[m][j][i] = acc_lo[m][j][i] = acc_hi[m][j][i] = 0.f;

  const int8_t* pcol = p + n0 + 4 * g;
  // chunk q's packed words: 4 * STEPS loads of 128 bytes a warp, all in
  // flight before the first is used. (Loading them a chunk ahead as well
  // costs 32 registers and a resident block: measured slower.)
  auto load_words = [&](int q, uint32_t (&dst)[STEPS][4]) {
    const long long row0 =
        (long long)(pg0 + q / chunks_per_group) * group +
        (q % chunks_per_group) * CH + 4 * t;
    const int8_t* prow = pcol + row0 * ldp;
#pragma unroll
    for (int st = 0; st < STEPS; ++st)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[st][i] = __ldg(
            reinterpret_cast<const uint32_t*>(prow + (16 * st + i) * ldp));
  };
  uint32_t w[STEPS][4];
  if (n_chunks > 0) stage(0, 0);
  for (int q = 0; q < n_chunks; ++q) {
    const int buf = q & 1;
    const int pg = pg0 + q / chunks_per_group;
    const int ch = q % chunks_per_group;
    load_words(q, w);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();          // tile q has landed; tile q - 1 is done with
    if (q + 1 < n_chunks) stage(q + 1, buf ^ 1);

#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      uint32_t a_lo[MT][4], a_hi[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * m + g + 8 * h;
          const uint2 lo = *reinterpret_cast<const uint2*>(
              &xs[buf][0][row][16 * st + 4 * t]);
          const uint2 hi = *reinterpret_cast<const uint2*>(
              &xs[buf][1][row][16 * st + 4 * t]);
          a_lo[m][h] = lo.x;
          a_lo[m][h + 2] = lo.y;
          a_hi[m][h] = hi.x;
          a_hi[m][h + 2] = hi.y;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of rows 4t, 4t+1 (and 4t+2, 4t+3) in bits 0..7 and 16..23
        const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
        const uint32_t b01 = __byte_perm(w[st][0], w[st][1], sel);
        const uint32_t b23 = __byte_perm(w[st][2], w[st][3], sel);
        const uint32_t lo0 = codes_to_bf16x2(b01 & 0x000F000Fu);
        const uint32_t lo1 = codes_to_bf16x2(b23 & 0x000F000Fu);
        const uint32_t hi0 =
            codes_to_bf16x2(((b01 >> 4) & 0x000F000Fu) ^ 0x00080008u);
        const uint32_t hi1 =
            codes_to_bf16x2(((b23 >> 4) & 0x000F000Fu) ^ 0x00080008u);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc_lo[m][j], a_lo[m], lo0, lo1);
          mma_bf16(acc_hi[m][j], a_hi[m], hi0, hi1);
        }
      }
    }
    if (ch + 1 < chunks_per_group) continue;
    // the group is complete: scale its two dots and add them. The lane's
    // eight columns are n0 + 8t .. 8t + 7: fragment value 0 / 2 of tile j
    // is column 8t + j, value 1 / 3 is column 8t + 4 + j
    const float* s_lo = s + (long long)pg * lds + n0 + 8 * t;
    const float* s_hi = s + (long long)(pg + n_pg) * lds + n0 + 8 * t;
    const float4 l0 = __ldg(reinterpret_cast<const float4*>(s_lo));
    const float4 l1 = __ldg(reinterpret_cast<const float4*>(s_lo + 4));
    const float4 h0 = __ldg(reinterpret_cast<const float4*>(s_hi));
    const float4 h1 = __ldg(reinterpret_cast<const float4*>(s_hi + 4));
    const float sl[2][4] = {{l0.x, l0.y, l0.z, l0.w},
                            {l1.x, l1.y, l1.z, l1.w}};
    const float sh[2][4] = {{h0.x, h0.y, h0.z, h0.w},
                            {h1.x, h1.y, h1.z, h1.w}};
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

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row_base + 16 * m + g + 8 * h;
      if (r >= rows) continue;
      const long long at = r * n + n0 + 8 * t;
      const int i0 = 2 * h;
      if (ksplit == 1) {
        uint4 v;
        v.x = pack_bf16x2(total[m][0][i0], total[m][1][i0]);
        v.y = pack_bf16x2(total[m][2][i0], total[m][3][i0]);
        v.z = pack_bf16x2(total[m][0][i0 + 1], total[m][1][i0 + 1]);
        v.w = pack_bf16x2(total[m][2][i0 + 1], total[m][3][i0 + 1]);
        *reinterpret_cast<uint4*>(out + at) = v;
      } else {
        float* dst = part + (long long)slice * rows * n + at;
        *reinterpret_cast<float4*>(dst) =
            make_float4(total[m][0][i0], total[m][1][i0], total[m][2][i0],
                        total[m][3][i0]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(total[m][0][i0 + 1], total[m][1][i0 + 1],
                        total[m][2][i0 + 1], total[m][3][i0 + 1]);
      }
    }
}

// out = bf16(sum over slices, in slice order, of part[slice])
__global__ void int4_reduce_kernel(const float* __restrict__ part,
                                   __nv_bfloat16* __restrict__ out,
                                   int ksplit, long long quads,
                                   long long stride) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  float4 acc = *reinterpret_cast<const float4*>(part + 4 * i);
  for (int sl = 1; sl < ksplit; ++sl) {
    const float4 v =
        *reinterpret_cast<const float4*>(part + sl * stride + 4 * i);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  uint2 r;
  r.x = pack_bf16x2(acc.x, acc.y);
  r.y = pack_bf16x2(acc.z, acc.w);
  *reinterpret_cast<uint2*>(out + 4 * i) = r;
}

template <int MT, int STEPS>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* p, const float* s,
                   __nv_bfloat16* out, float* part, int rows, int k, int n,
                   int group, long long ldx, long long ldp, long long lds,
                   int ksplit, cudaStream_t st) {
  const int mblocks = (rows + 16 * MT - 1) / (16 * MT);
  const int tiles_n = n / 32;
  const int warps = tiles_n % MAX_WARPS == 0 ? MAX_WARPS : 4;
  const long long items = (long long)tiles_n * ksplit * mblocks;
  int4_matmul_kernel<MT, STEPS><<<(unsigned)(items / warps), warps * 32, 0,
                                  st>>>(x, p, s, out, part, rows, k, n, group,
                                        ldx, ldp, lds, ksplit, mblocks);
  return cudaGetLastError();
}

}  // namespace

// x [rows, k] bf16 (row stride ldx, rows 16-byte aligned), p [k/2, n] int8
// (row stride ldp), s [k/group, n] f32 (row stride lds), out [rows, n] bf16
// contiguous, part [ksplit, rows, n] f32 scratch (unused when ksplit == 1).
// n is a multiple of 128, the group size of 16. rows_per_warp is 16 or 32.
// Returns cudaGetLastError() after the launches.
extern "C" int int4_matmul(const void* x, const void* p, const void* s,
                           void* out, void* part, int rows, int k, int n,
                           int group, long long ldx, long long ldp,
                           long long lds, int ksplit, int rows_per_warp,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto pp = static_cast<const int8_t*>(p);
  auto sp = static_cast<const float*>(s);
  auto op = static_cast<__nv_bfloat16*>(out);
  auto fp = static_cast<float*>(part);
  if (n % 128 || group % 16 || (rows_per_warp != 16 && rows_per_warp != 32))
    return (int)cudaErrorInvalidValue;
  const int steps = group % 128 == 0 ? 8 : group % 64 == 0 ? 4 : 1;
  cudaError_t err;
#define LAUNCH(MT, STEPS)                                                   \
  err = launch<MT, STEPS>(xp, pp, sp, op, fp, rows, k, n, group, ldx, ldp, \
                          lds, ksplit, st)
  if (rows_per_warp == 16) {
    if (steps == 8) LAUNCH(1, 8);
    else if (steps == 4) LAUNCH(1, 4);
    else LAUNCH(1, 1);
  } else {
    if (steps == 8) LAUNCH(2, 8);
    else if (steps == 4) LAUNCH(2, 4);
    else LAUNCH(2, 1);
  }
#undef LAUNCH
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const long long quads = (long long)rows * n / 4;
  int4_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
      fp, op, ksplit, quads, (long long)rows * n);
  return (int)cudaGetLastError();
}
