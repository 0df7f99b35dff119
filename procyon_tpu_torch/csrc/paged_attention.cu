// Paged decode attention for Hopper (sm_90a): one query token per slot
// against the slot's pages of the paged KV pool, bf16 pools or int8 pools
// with per-(token, kv-head) f32 scales.
//
// Replaces: procyon_tpu/ops/paged_attention.py::_kernel_fullpage and
// ::_kernel_fullpage_q8 (reached through paged_decode_attention_fullpage,
// the one-token decode step of models/llama.py::paged_forward).
//
// What it computes, per slot b and query head h, with the kv head
// hk = h / (Hq / Hkv) and the tokens t < seq_lens[b] of the pages
// page_table[b, 0..P):
//   s_t  = (q . k_t) * sm_scale [* k_scale_t]            f32
//   m    = max_t s_t,  p_t = exp(s_t - m),  l = sum_t p_t (f32, online
//          over pages: acc and l are rescaled by exp(m_old - m_new))
//   acc  = sum_t bf16(p_t [* v_scale_t]) * v_t           f32 sums
//   out  = acc / l (bf16),  lse = m + log(l)
//   a slot with seq_lens[b] == 0 gives out = 0 and lse = -1e30.
// On int8 pools k_t and v_t are the int8 codes (exact in bf16), the K scale
// multiplies the score, the V scale multiplies the unnormalised p before
// its cast, and l sums the unscaled exponentials, so out = acc / l is the
// attention over the dequantized rows.
//
// What bounds it on the H100: bytes. Every live K and V row is read once:
// at the caption path's shape (80 slots, 8 kv heads of 128, about 300
// cached tokens) that is 98 MB a layer, about 29 us at 3.35 TB/s, against
// 0.05 GFLOP.
//
// What the design does about it. The TPU kernel ran a sequential (slot,
// page) grid with the page table prefetched as scalars, carried m, l and
// the accumulator in lane-broadcast VMEM scratch, and folded all heads into
// one matrix-unit pass through block-diagonal queries [Hq, Hkv*D]; none of
// that is carried over. Here one block of 128 threads owns a (slot, kv
// head) pair: 640 blocks at 80 slots, about five resident on each SM, so
// one block's loads run under another's arithmetic. The block reads its own
// table row and length and loops over the slot's live pages only. For each
// page it copies the head's K and V tiles [page, D] into shared memory with
// 16-byte loads (rows padded by 16 bytes, so the row-per-thread reads below
// fall on distinct banks), and the Hq / Hkv query heads of the group share
// each tile:
//   scores   a thread takes one token (and, when the page has fewer tokens
//            than the block has threads, one slice of head_dim) and all the
//            group's heads: K row from shared memory 16 bytes at a time, q
//            in f32 from shared memory as broadcast reads;
//   softmax  one warp per head: page max and sum by shuffles, the running
//            m / l / rescale factor in shared memory, p rounded to bf16;
//   P.V      a thread owns one of the D output lanes for GROUP * D / 128
//            heads and walks the page's tokens, V read once for all heads.
// SIMT f32 arithmetic is enough while the bytes bound it (about 2 FLOP per
// byte). Known and not built: with few slots (8 slots are 64 blocks for 132
// SMs) the grid does not fill the card and the walk wants a split over
// pages with a log-sum-exp merge; cp.async or TMA prefetch of the next
// page under the arithmetic; mma.sync for the two products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // four warps
constexpr float MASK = -1e30f;
constexpr int MAX_PAGE = 128;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of a K row as floats: 8 bf16 values or 16 int8 codes
template <bool Q8>
__device__ __forceinline__ void unpack16(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (Q8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[i * 4 + j] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i * 2] = __uint_as_float(w[i] << 16);
      f[i * 2 + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <int D, int GROUP, bool Q8>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const unsigned char* __restrict__ k_pool,
                    const unsigned char* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Hkv, int page, int P, int n_rows, float sm_scale) {
  constexpr int ES = Q8 ? 1 : 2;     // bytes per pool element
  constexpr int EPC = 16 / ES;       // elements per 16-byte chunk
  constexpr int ROWB = D * ES;       // bytes of one head's row
  constexpr int LDB = ROWB + 16;     // padded shared-memory row stride
  constexpr int CPR = ROWB / 16;     // 16-byte chunks per row
  constexpr int ACC_N = GROUP * D / NT;  // outputs per thread
  constexpr int GSTEP = NT / D;      // head stride between a thread's outputs
  static_assert((GROUP * D) % NT == 0 && NT % D == 0, "unsupported shape");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_tile = smem;
  unsigned char* v_tile = k_tile + page * LDB;
  float* q_s = reinterpret_cast<float*>(v_tile + page * LDB);  // [GROUP][D]
  float* s_part = q_s + GROUP * D;     // [split][GROUP][page]
  float* p_s = s_part + NT * GROUP;    // [page][GROUP]
  float* ks_s = p_s + page * GROUP;    // [page]
  float* vs_s = ks_s + page;           // [page]
  float* m_s = vs_s + page;            // [GROUP] running max
  float* l_s = m_s + GROUP;            // [GROUP] running sum
  float* a_s = l_s + GROUP;            // [GROUP] this page's rescale factor

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * GROUP;
  const int h0 = kvh * GROUP;          // the group's first query head

  const int len = min(seq_lens[b], P * page);
  const int n_live = (len + page - 1) / page;

  for (int i = tid; i < GROUP * D; i += NT) {
    q_s[i] = __bfloat162float(
        q[(static_cast<size_t>(b) * Hq + h0) * D + i]);
  }
  if (tid < GROUP) {
    m_s[tid] = MASK;
    l_s[tid] = 0.f;
    a_s[tid] = 0.f;
  }
  float acc[ACC_N];
#pragma unroll
  for (int i = 0; i < ACC_N; ++i) acc[i] = 0.f;

  // score phase: thread -> (token, slice of head_dim)
  const int split = NT / page;
  const int ds = D / split;            // head_dim elements per slice
  const int tok = tid % page;
  const int sp = tid / page;
  // P.V phase: thread -> output lane d of heads g0, g0 + GSTEP, ...
  const int d = tid % D;
  const int g0 = tid / D;

  const size_t tok_stride = static_cast<size_t>(Hkv) * ROWB;  // bytes

  for (int j = 0; j < n_live; ++j) {
    __syncthreads();  // the tiles and p_s of the page before are done with
    int row = page_table[static_cast<size_t>(b) * P + j];
    row = max(0, min(row, n_rows - 1));
    const int n_tok = min(page, len - j * page);
    const size_t base = static_cast<size_t>(row) * page * tok_stride
        + static_cast<size_t>(kvh) * ROWB;
    for (int c = tid; c < n_tok * CPR; c += NT) {
      const int t = c / CPR, cc = c % CPR;
      const size_t off = base + t * tok_stride + cc * 16;
      *reinterpret_cast<uint4*>(k_tile + t * LDB + cc * 16) =
          __ldg(reinterpret_cast<const uint4*>(k_pool + off));
      *reinterpret_cast<uint4*>(v_tile + t * LDB + cc * 16) =
          __ldg(reinterpret_cast<const uint4*>(v_pool + off));
    }
    if constexpr (Q8) {
      for (int t = tid; t < n_tok; t += NT) {
        const size_t s_off =
            (static_cast<size_t>(row) * page + t) * Hkv + kvh;
        ks_s[t] = k_scale[s_off];
        vs_s[t] = v_scale[s_off];
      }
    }
    __syncthreads();

    // scores: partial dot products of this thread's slice, all heads
    if (tok < n_tok) {
      float sc[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) sc[g] = 0.f;
      const unsigned char* kr = k_tile + tok * LDB + sp * ds * ES;
      const float* qr = q_s + sp * ds;
      for (int c = 0; c < ds / EPC; ++c) {
        float kf[EPC];
        unpack16<Q8>(*reinterpret_cast<const uint4*>(kr + c * 16), kf);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const float4* q4 =
              reinterpret_cast<const float4*>(qr + g * D + c * EPC);
#pragma unroll
          for (int e = 0; e < EPC / 4; ++e) {
            const float4 qv = q4[e];
            sc[g] += qv.x * kf[e * 4] + qv.y * kf[e * 4 + 1]
                + qv.z * kf[e * 4 + 2] + qv.w * kf[e * 4 + 3];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        s_part[(sp * GROUP + g) * page + tok] = sc[g];
      }
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < GROUP; g += NT / 32) {
      const float m_prev = m_s[g];
      const float l_prev = l_s[g];
      float sv[MAX_PAGE / 32];
      float m_cur = MASK;
#pragma unroll
      for (int i = 0; i < MAX_PAGE / 32; ++i) {
        const int t = lane + 32 * i;
        float s = MASK;
        if (t < n_tok) {
          float dot = 0.f;
          for (int k = 0; k < split; ++k) {
            dot += s_part[(k * GROUP + g) * page + t];
          }
          s = dot * sm_scale;
          if constexpr (Q8) s *= ks_s[t];
        }
        sv[i] = s;
        m_cur = fmaxf(m_cur, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      }
      const float m_new = fmaxf(m_prev, m_cur);
      const float safe_m = m_new <= 0.5f * MASK ? 0.f : m_new;
      const float alpha =
          m_prev <= 0.5f * MASK ? 0.f : expf(m_prev - safe_m);
      float l_sum = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_PAGE / 32; ++i) {
        const int t = lane + 32 * i;
        if (t < n_tok) {
          float p = expf(sv[i] - safe_m);
          l_sum += p;
          if constexpr (Q8) p *= vs_s[t];
          p_s[t * GROUP + g] = bf16_round(p);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        l_sum += __shfl_xor_sync(0xffffffffu, l_sum, o);
      }
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = alpha * l_prev + l_sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P.V: rescale, then add this page's tokens
#pragma unroll
    for (int i = 0; i < ACC_N; ++i) acc[i] *= a_s[g0 + i * GSTEP];
    const unsigned char* vcol = v_tile + d * ES;
    for (int t = 0; t < n_tok; ++t) {
      float v;
      if constexpr (Q8) {
        v = static_cast<float>(
            *reinterpret_cast<const int8_t*>(vcol + t * LDB));
      } else {
        v = __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(vcol + t * LDB));
      }
      const float* pr = p_s + t * GROUP + g0;
#pragma unroll
      for (int i = 0; i < ACC_N; ++i) acc[i] += pr[i * GSTEP] * v;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < ACC_N; ++i) {
    const int g = g0 + i * GSTEP;
    const float l = l_s[g];
    const float val = l == 0.f ? 0.f : acc[i] / l;
    out[(static_cast<size_t>(b) * Hq + h0 + g) * D + d] =
        __float2bfloat16_rn(val);
  }
  if (tid < GROUP) {
    const float l = l_s[tid];
    lse[static_cast<size_t>(b) * Hq + h0 + tid] =
        l == 0.f ? MASK : m_s[tid] + logf(l);
  }
}

template <int D, int GROUP, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* seq_lens, void* out, void* lse, int B, int Hkv,
           int page, int P, int n_rows, float sm_scale,
           cudaStream_t stream) {
  constexpr int LDB = D * (Q8 ? 1 : 2) + 16;
  const size_t smem = static_cast<size_t>(2) * page * LDB
      + sizeof(float) * (GROUP * D + NT * GROUP + page * GROUP + 2 * page
                         + 3 * GROUP);
  auto kernel = paged_decode_kernel<D, GROUP, Q8>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(B, Hkv), NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const unsigned char*>(k_pool),
      static_cast<const unsigned char*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Hkv, page,
      P, n_rows, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PAGED_CASE(DD, GG)                                                  \
  if (D == DD && group == GG) {                                             \
    return quantized                                                        \
        ? launch<DD, GG, true>(q, k_pool, v_pool, k_scale, v_scale,         \
                               page_table, seq_lens, out, lse, B, Hkv,      \
                               page, P, n_rows, sm_scale, s)                \
        : launch<DD, GG, false>(q, k_pool, v_pool, k_scale, v_scale,        \
                                page_table, seq_lens, out, lse, B, Hkv,     \
                                page, P, n_rows, sm_scale, s);              \
  }

// q, out: bf16 [B, Hq, D]; pools: [n_rows, page, Hkv*D] bf16, or int8 with
// f32 scales [n_rows, page, Hkv] when `quantized`; page_table int32 [B, P];
// seq_lens int32 [B]; lse f32 [B, Hq]. All contiguous. The page size must
// divide 128 threads with 16-byte slices of a head row each (the wrapper
// checks it).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* seq_lens, void* out, void* lse, int B, int Hq, int Hkv, int D,
    int page, int P, int n_rows, int quantized, float sm_scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || page <= 0 || page > MAX_PAGE
      || NT % page || P <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int split = NT / page;
  if ((D * (quantized ? 1 : 2)) % (16 * split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = Hq / Hkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  PAGED_CASE(128, 1)
  PAGED_CASE(128, 2)
  PAGED_CASE(128, 4)
  PAGED_CASE(128, 8)
  PAGED_CASE(64, 2)
  PAGED_CASE(64, 4)
  PAGED_CASE(64, 8)
  return static_cast<int>(cudaErrorInvalidValue);
}
