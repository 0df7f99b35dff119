// Bidirectional row-block attention with fused rotate-half rotary, for
// Hopper (sm_90a).
//
// Replaces: procyon_tpu/ops/attention_rowblock.py::_rowblock_packed_kernel
// (reached through rowblock_packed_qkv_fwd and rowblock_packed_fwd), and
// serves the unpacked rowblock_fwd route of the same module for
// Hq == Hkv without log-sum-exp (rotary applied by the caller, scores
// scaled here).
//
// What it computes, per (batch b, head h, query row i):
//   q, k rotated in bf16: x*cos + x[rotate_half]*sin_signed, where the
//     q-side tables carry sm_scale*log2(e) already (the wrapper folds it);
//   s_ij = q_i . k_j * score_scale   (f32 sums; score_scale is 1 when the
//     scale is folded into the tables)
//   s_ij += 0 where seg[i] == seg[j] && seg[i] > 0, else -1e30
//   p_ij = exp2(s_ij - m_i), l_i = sum_j p_ij (f32)
//   out_i = (sum_j bf16(p_ij) v_j) / l_i, or exactly 0 for a dead row
//     (m_i <= -5e29 or l_i == 0).
//
// What bounds it on the H100: at ESM2-650M serving shapes (S=512, D=64)
// the score work is 4*S*D flops per query row against 6*D bytes read per
// key row per block, so it is compute-bound. This first version does the
// two products with f32 FMAs on the SIMT cores (no tensor cores), so its
// ceiling is the 67 TFLOP/s f32 rate, not the 989 TFLOP/s bf16 one.
//
// What the design does about it: the TPU kernel kept a whole [block_q,
// S] f32 score row in VMEM. A block here may use at most 227 KB of shared
// memory, and K and V of one head at S=1026 would alone take 262 KB in
// bf16, so keys are tiled by 64 with an online softmax (running max and
// sum, accumulator rescaled by exp2(m_old - m_new)); the result equals the
// single pass up to where bf16(p) is rounded. One block per (64-row query
// tile, head, batch), 256 threads as 16 x 16, each thread holding a 4 x 4
// score tile and 4 rows x D/16 output columns in registers; q/k/v are read
// with strides, so the packed [B, S, 3*H*D] projection feeds the kernel
// without copies. Rows beyond S are masked, so no padding is needed.
// Later work: mma.sync / wgmma products, cp.async staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float MASK = -1e30f;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// rotated value of element d of one head row, rounded to bf16 after each
// product and after the sum, as the reference computes in bf16
template <int D>
__device__ __forceinline__ float rope_elem(const __nv_bfloat16* row, int d,
                                           const __nv_bfloat16* cos_row,
                                           const __nv_bfloat16* sin_row) {
  float x = ld(row + d);
  if (cos_row == nullptr) return x;
  float xp = ld(row + (d + D / 2) % D);
  float a = bf16r(x * ld(cos_row + d));
  float c = bf16r(xp * ld(sin_row + d));
  return bf16r(a + c);
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) * 4 + BK * 4;
}

template <int D>
__global__ void __launch_bounds__(NT)
rowblock_attention_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ seg,
                          const __nv_bfloat16* __restrict__ cq,
                          const __nv_bfloat16* __restrict__ sq,
                          const __nv_bfloat16* __restrict__ ck,
                          const __nv_bfloat16* __restrict__ sk,
                          __nv_bfloat16* __restrict__ out, int S, int H,
                          long long row_stride, long long batch_stride,
                          float score_scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int E = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);         // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);         // [BK][D]
  float* Ps = Vs + BK * D;               // [BQ][BK+1]
  int* segk = reinterpret_cast<int*>(Ps + BQ * (BK + 1));  // [BK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int HD = H * D;
  const long long head_off = (long long)b * batch_stride + (long long)h * D;
  const int* segb = seg + (long long)b * S;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, s = q0 + r;
    float val = 0.f;
    if (s < S) {
      const long long t = (long long)s * HD + (long long)h * D;
      val = rope_elem<D>(q + head_off + (long long)s * row_stride, d,
                         cq ? cq + t : nullptr, sq ? sq + t : nullptr);
    }
    Qs[r * (D + 1) + d] = val;
  }
  int segq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    segq[i] = s < S ? segb[s] : 0;
  }
  float m[4], l[4], o[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // Q staged / previous tile's K, V, P consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, s = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const long long t = (long long)s * HD + (long long)h * D;
        const long long roff = head_off + (long long)s * row_stride;
        kv = rope_elem<D>(k + roff, d, ck ? ck + t : nullptr,
                          sk ? sk + t : nullptr);
        vv = ld(v + roff + d);
      }
      Ks[r * (D + 1) + d] = kv;
      Vs[r * D + d] = vv;
    }
    for (int i = tid; i < BK; i += NT) segk[i] = k0 + i < S ? segb[k0 + i] : 0;
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = (k0 + c < S) && segq[i] > 0 && segk[c] == segq[i];
        const float s = __fadd_rn(__fmul_rn(sc[i][j], score_scale),
                                  ok ? 0.f : MASK);
        sc[i][j] = s;
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mnew = fmaxf(m[i], rmax);
      const float alpha = exp2f(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(sc[i][j] - mnew);
        rs += p;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = bf16r(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int e = 0; e < E; ++e) o[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = Vs[c * D + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
        for (int e = 0; e < E; ++e) o[i][e] = fmaf(p, vv[e], o[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const bool dead = (m[i] <= MASK * 0.5f) || (l[i] == 0.f);
    const float scale = dead ? 0.f : 1.f / l[i];
    __nv_bfloat16* orow = out + ((long long)b * S + s) * HD + (long long)h * D;
#pragma unroll
    for (int e = 0; e < E; ++e)
      orow[tx + 16 * e] = __float2bfloat16_rn(o[i][e] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, const void* cq, const void* sq,
                   const void* ck, const void* sk, void* out, int B, int S,
                   int H, long long row_stride, long long batch_stride,
                   float score_scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      rowblock_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  rowblock_attention_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<const __nv_bfloat16*>(cq),
      static_cast<const __nv_bfloat16*>(sq),
      static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(sk),
      static_cast<__nv_bfloat16*>(out), S, H, row_stride, batch_stride,
      score_scale);
  return cudaGetLastError();
}

}  // namespace

// q/k/v: bf16 views with unit stride inside a row, row stride `row_stride`
// and batch stride `batch_stride` (elements), head h at column h*D.
// seg: int32 [B, S]. cq/sq/ck/sk: bf16 [S, H*D] tables, or all null for no
// rotary. out: bf16 [B, S, H*D]. Returns cudaGetLastError().
extern "C" int rowblock_attention_bf16(
    const void* q, const void* k, const void* v, const void* seg,
    const void* cq, const void* sq, const void* ck, const void* sk,
    void* out, int B, int S, int H, int D, long long row_stride,
    long long batch_stride, float score_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, seg, cq, sq, ck, sk, out, B, S, H,
                        row_stride, batch_stride, score_scale, st);
    case 32:
      return launch<32>(q, k, v, seg, cq, sq, ck, sk, out, B, S, H,
                        row_stride, batch_stride, score_scale, st);
    case 64:
      return launch<64>(q, k, v, seg, cq, sq, ck, sk, out, B, S, H,
                        row_stride, batch_stride, score_scale, st);
    case 128:
      return launch<128>(q, k, v, seg, cq, sq, ck, sk, out, B, S, H,
                         row_stride, batch_stride, score_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
