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
// cached tokens) that is 124 MB a layer, 37 us at 3.35 TB/s, against
// 0.06 GFLOP; at serving's 16 slots a tenth of that, where the fixed cost
// of a launch weighs.
//
// What the design does about it. The TPU kernel ran a sequential (slot,
// page) grid with the page table prefetched as scalars, carried m, l and
// the accumulator in lane-broadcast VMEM scratch, and folded all heads into
// one matrix-unit pass through block-diagonal queries [Hq, Hkv*D]; none of
// that is carried over. Here:
//   * a block of four warps owns a (slot, kv head, chunk of pages): the
//     wrapper cuts the table's P pages into chunks from the shapes alone
//     (ops/paged_attention.chunk_plan; never from seq_lens, which stay on
//     the device), so that 8 or 16 slots fill the card as 80 do. The
//     chunks of a (slot, kv head) are one thread-block cluster: each
//     leaves its normalised output and log-sum-exp in shared memory, and
//     the cluster merges them through distributed shared memory in chunk
//     order, inside the launch. A chunk wholly past the slot's length
//     reads nothing and has lse -1e30: weight exactly 0 in the merge;
//   * the next pages' K and V tiles (tokens past the length zero-filled)
//     come with cp.async into a ring of STAGES stages while the current
//     page is computed;
//   * both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 sums): the group's query heads are the rows of the m16 tile
//     (the rest zeros), K through ldmatrix, V through ldmatrix.trans, from
//     tiles in wgmma.cuh's swizzled layout (conflict-free). Every warp
//     computes the page's scores and softmax for all heads (the same
//     values in each), so the probabilities pass from the score fragments
//     to P.V's A fragments in registers; a warp owns a quarter of the
//     head dimension in P.V. int8 tiles are converted to bf16 in shared
//     memory once a page.
// Measured times and what holds the kernel back: PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int NT = 128;              // four warps
constexpr int WARPS = NT / 32;
constexpr float MASK = -1e30f;
constexpr int MAX_CHUNKS = 8;
constexpr int MAX_GROUP = 8;
constexpr int STAGES = 2;            // the ring's stages (3 measured no faster)

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest STAGES - 1 has landed
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// D: head dim. TT: tokens of a tile (the page, at least 16; rows past the
// page are zeros). Q8: int8 pools.
template <int D, int TT, bool Q8>
struct Smem {
  using T = wg::Tile<D, TT>;                  // a [TT][D] bf16 tile
  static constexpr int ES = Q8 ? 1 : 2;       // bytes of a pool element
  static constexpr int LANDED = TT * D * ES;  // a tile as cp.async lands it
  static constexpr int RING = STAGES * 2 * LANDED;  // stages of (K, V)
  static constexpr int CONV = Q8 ? 2 * T::BYTES : 0;  // (K, V) in bf16
  static constexpr int SCALES = Q8 ? STAGES * 2 * TT * 4 : 0;
  static constexpr int MERGE = (MAX_GROUP * D + MAX_GROUP) * 4;
  static constexpr int BODY = RING + CONV + SCALES;
  static constexpr int BYTES = 1024 + (BODY > MERGE ? BODY : MERGE);
  static_assert(LANDED % 1024 == 0, "tile alignment");
};

// grid (chunks, Hkv, B), cluster (chunks, 1, 1): block c walks the live
// pages of table entries [c * chunk_pages, (c + 1) * chunk_pages)
template <int D, int TT, bool Q8>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const unsigned char* __restrict__ k_pool,
                    const unsigned char* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Hkv, int group, int page, int P, int n_rows,
                    int chunk_pages, float sm_scale) {
  using L = Smem<D, TT, Q8>;
  using T = typename L::T;
  constexpr int ES = L::ES;
  constexpr int CPR = D * ES / 16;           // 16-byte chunks of a row
  constexpr int KS = D / 16;                 // k16 steps of q . k
  constexpr int NS = TT / 8;                 // n8 token tiles of a page
  constexpr int DW = D / WARPS;              // head columns a warp owns
  constexpr int NO = DW / 8;                 // n8 tiles of a warp's output
  extern __shared__ unsigned char raw[];
  unsigned char* smem = wg::aligned_smem(raw);

  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, row
  const int Hq = Hkv * group;
  const int h0 = kvh * group;

  const int len = min(max(seq_lens[b], 0), P * page);
  const int p0 = chunk * chunk_pages;
  const int p_end = min(min(P, p0 + chunk_pages), (len + page - 1) / page);
  const int n_pages = max(0, p_end - p0);
  const size_t tok_stride = static_cast<size_t>(Hkv) * D * ES;   // bytes

  // the group's query rows as m16 A fragments (rows past the group zero)
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = qa[kk][1] = qa[kk][2] = qa[kk][3] = 0u;
    if (g < group) {
      const __nv_bfloat16* qr =
          q + (static_cast<size_t>(b) * Hq + h0 + g) * D + 16 * kk + 2 * t;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
    }
  }

  // page j of the chunk into stage `buf`: K and V rows of the kv head,
  // tokens past the slot's length zero-filled (never read)
  auto issue = [&](int j, int buf) {
    const int pj = p0 + j;
    int row = page_table[static_cast<size_t>(b) * P + pj];
    row = max(0, min(row, n_rows - 1));
    const int n_tok = min(page, len - pj * page);
    const size_t base = static_cast<size_t>(row) * page * tok_stride +
                        static_cast<size_t>(kvh) * D * ES;
    unsigned char* kt = smem + buf * 2 * L::LANDED;
    unsigned char* vt = kt + L::LANDED;
    for (int i = tid; i < TT * CPR; i += NT) {
      const int tok = i / CPR, c = i % CPR;
      const bool live = tok < n_tok;
      const size_t off = live ? base + tok * tok_stride + c * 16 : 0;
      // bf16 tiles land in the swizzled layout the products read; int8
      // codes land row by row and are converted below
      const uint32_t dst = Q8 ? static_cast<uint32_t>(tok * D + c * 16)
                              : T::offset(tok, c);
      wg::cp16(wg::smem_u32(kt + dst), k_pool + off, live);
      wg::cp16(wg::smem_u32(vt + dst), v_pool + off, live);
    }
    if constexpr (Q8) {
      float* sc = reinterpret_cast<float*>(smem + L::RING + L::CONV) +
                  buf * 2 * TT;
      for (int i = tid; i < 2 * TT; i += NT) {
        const int tok = i % TT;
        const bool live = tok < n_tok;
        const float* src = (i < TT ? k_scale : v_scale) +
                           (live ? (static_cast<size_t>(row) * page + tok) *
                                           Hkv + kvh
                                 : 0);
        wg::cp4(wg::smem_u32(sc + i), src, live);
      }
    }
    cp_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run = MASK, l_lane = 0.f;   // row g's running max; this lane's sum

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_pages) {
      issue(j, j);
    } else {
      cp_commit();
    }
  }
  for (int j = 0; j < n_pages; ++j) {
    const int buf = j % STAGES;
    const int ahead = j + STAGES - 1;
    if (ahead < n_pages) {
      issue(ahead, ahead % STAGES);
    } else {
      cp_commit();
    }
    cp_wait_ring();
    __syncthreads();                     // page j has landed in every thread
    const int n_tok = min(page, len - (p0 + j) * page);
    uint32_t kt = wg::smem_u32(smem + buf * 2 * L::LANDED);
    uint32_t vt = kt + L::LANDED;
    const float* sc = nullptr;
    if constexpr (Q8) {
      // codes -> bf16 tiles in the swizzled layout
      const unsigned char* kc = smem + buf * 2 * L::LANDED;
      unsigned char* conv = smem + L::RING;
      for (int i = tid; i < 2 * TT * (D / 16); i += NT) {
        const int which = i / (TT * (D / 16));        // 0: K, 1: V
        const int r = i % (TT * (D / 16));
        const int tok = r / (D / 16), c16 = r % (D / 16);
        const uint4 raw16 = *reinterpret_cast<const uint4*>(
            kc + which * L::LANDED + tok * D + c16 * 16);
        const uint32_t w[4] = {raw16.x, raw16.y, raw16.z, raw16.w};
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t word = w[e / 2];
          const int sh = (e % 2) * 16;
          const float lo = static_cast<float>(
              static_cast<int8_t>((word >> sh) & 0xffu));
          const float hi = static_cast<float>(
              static_cast<int8_t>((word >> (sh + 8)) & 0xffu));
          h[e] = wg::pack_bf16(lo, hi);
        }
        unsigned char* dst = conv + which * T::BYTES;
        *reinterpret_cast<uint4*>(dst + T::offset(tok, 2 * c16)) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(dst + T::offset(tok, 2 * c16 + 1)) =
            make_uint4(h[4], h[5], h[6], h[7]);
      }
      __syncthreads();
      kt = wg::smem_u32(conv);
      vt = kt + T::BYTES;
      sc = reinterpret_cast<const float*>(smem + L::RING + L::CONV) +
           buf * 2 * TT;
    }

    // scores of every token of the page for the group's heads
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t kb[4];
        wg::ldsm_x4(kb, kt + T::offset((2 * n2 + (mi >> 1)) * 8 + mr,
                                       2 * kk + (mi & 1)));
        wg::mma16816(s[2 * n2], qa[kk], kb[0], kb[1]);
        wg::mma16816(s[2 * n2 + 1], qa[kk], kb[2], kb[3]);
      }
    // online softmax of row g (and the padding row g + 8, never written)
    float pmax = MASK;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * n + 2 * t + (e & 1);
        float v = s[n][e] * sm_scale;
        if constexpr (Q8) v *= sc[tok];
        v = tok < n_tok ? v : MASK;
        s[n][e] = v;
        if (e < 2) pmax = fmaxf(pmax, v);
      }
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, 1));
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, 2));
    const float m_new = fmaxf(m_run, pmax);  // a live page: finite
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    l_lane *= alpha;
    uint32_t pa[NS / 2][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rows g + 8 are padding: their values are never used
        p[e] = e < 2 ? expf(s[n][e] - m_new) : 0.f;
      }
      l_lane += p[0] + p[1];
      if constexpr (Q8) {
        p[0] *= sc[TT + 8 * n + 2 * t];
        p[1] *= sc[TT + 8 * n + 2 * t + 1];
      }
      pa[n / 2][(n & 1) * 2] = wg::pack_bf16(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = wg::pack_bf16(p[2], p[3]);
    }
    // P . V for the warp's head columns
#pragma unroll
    for (int j2 = 0; j2 < NO; ++j2)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j2][e] *= alpha;
#pragma unroll
    for (int kk = 0; kk < TT / 16; ++kk)
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        uint32_t vb[4];
        wg::ldsm_x4_trans(vb, vt + T::offset(16 * kk + (mi & 1) * 8 + mr,
                                             warp * DW / 8 + 2 * j2 +
                                                 (mi >> 1)));
        wg::mma16816(o[2 * j2], pa[kk], vb[0], vb[1]);
        wg::mma16816(o[2 * j2 + 1], pa[kk], vb[2], vb[3]);
      }
    __syncthreads();               // the stage is free for page j + STAGES
  }

  // this chunk's normalised output and log-sum-exp of row g
  float l_row = l_lane;
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);
  const bool live = l_row > 0.f;
  const float lse_c = live ? m_run + logf(l_row) : MASK;
  float on[NO][2];                       // acc / l, 0 where nothing is live
#pragma unroll
  for (int j2 = 0; j2 < NO; ++j2) {
    on[j2][0] = live ? o[j2][0] / l_row : 0.f;
    on[j2][1] = live ? o[j2][1] / l_row : 0.f;
  }

  if (chunks == 1) {
    if (g < group) {
      __nv_bfloat16* orow =
          out + (static_cast<size_t>(b) * Hq + h0 + g) * D + warp * DW;
#pragma unroll
      for (int j2 = 0; j2 < NO; ++j2)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j2 + 2 * t) =
            __floats2bfloat162_rn(on[j2][0], on[j2][1]);
      if (warp == 0 && t == 0)
        lse[static_cast<size_t>(b) * Hq + h0 + g] = lse_c;
    }
    return;
  }

  // the cluster's chunks merge by log-sum-exp, in chunk order
  __syncthreads();                       // every stage is done with
  float* oc = reinterpret_cast<float*>(smem);     // [group][D]
  float* lc = oc + MAX_GROUP * D;                 // [group]
  if (g < group) {
#pragma unroll
    for (int j2 = 0; j2 < NO; ++j2)
      *reinterpret_cast<float2*>(oc + g * D + warp * DW + 8 * j2 + 2 * t) =
          make_float2(on[j2][0], on[j2][1]);
    if (warp == 0 && t == 0) lc[g] = lse_c;
  }
  wg::cluster_sync();
  for (int e = chunk * NT + tid; e < group * D; e += chunks * NT) {
    const int gh = e / D;
    const uint32_t la = wg::smem_u32(lc + gh);
    float w[MAX_CHUNKS];
    float mx = MASK;
    for (int c = 0; c < chunks; ++c) {
      w[c] = wg::ld_cluster_f32(la, c);
      mx = fmaxf(mx, w[c]);
    }
    float acc = 0.f, wsum = 0.f;
    const uint32_t oa = wg::smem_u32(oc + e);
    for (int c = 0; c < chunks; ++c) {
      // a chunk with nothing live weighs exactly 0 (no exp of -1e30 - -1e30)
      const float wc = w[c] <= 0.5f * MASK ? 0.f : expf(w[c] - mx);
      wsum += wc;
      if (wc != 0.f) acc += wc * wg::ld_cluster_f32(oa, c);
    }
    out[(static_cast<size_t>(b) * Hq + h0) * D + e] =
        __float2bfloat16_rn(wsum > 0.f ? acc / wsum : 0.f);
    if (e % D == 0)
      lse[static_cast<size_t>(b) * Hq + h0 + gh] =
          wsum > 0.f ? mx + logf(wsum) : MASK;
  }
  wg::cluster_sync();    // no block leaves while another reads its results
}

template <int D, int TT, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* seq_lens, void* out, void* lse, int B, int Hkv,
           int group, int page, int P, int n_rows, int chunk_pages,
           float sm_scale, cudaStream_t stream) {
  using L = Smem<D, TT, Q8>;
  auto kernel = paged_decode_kernel<D, TT, Q8>;
  const cudaError_t attr = wg::set_attributes_once(
      reinterpret_cast<const void*>(kernel), L::BYTES, false);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int chunks = (P + chunk_pages - 1) / chunk_pages;
  cudaLaunchAttribute cl;
  cl.id = cudaLaunchAttributeClusterDimension;
  cl.val.clusterDim.x = chunks;
  cl.val.clusterDim.y = 1;
  cl.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, Hkv, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cfg.attrs = &cl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const unsigned char*>(k_pool),
      static_cast<const unsigned char*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Hkv, group,
      page, P, n_rows, chunk_pages, sm_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool Q8>
int launch_tt(int tt, const void* q, const void* k_pool, const void* v_pool,
              const void* k_scale, const void* v_scale,
              const void* page_table, const void* seq_lens, void* out,
              void* lse, int B, int Hkv, int group, int page, int P,
              int n_rows, int chunk_pages, float sm_scale, cudaStream_t s) {
#define TT_CASE(TTV)                                                        \
  if (tt == TTV)                                                            \
    return launch<D, TTV, Q8>(q, k_pool, v_pool, k_scale, v_scale,          \
                              page_table, seq_lens, out, lse, B, Hkv, group, \
                              page, P, n_rows, chunk_pages, sm_scale, s);
  TT_CASE(16)
  TT_CASE(32)
  TT_CASE(64)
  TT_CASE(128)
#undef TT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: bf16 [B, Hq, D]; pools: [n_rows, page, Hkv*D] bf16, or int8 with
// f32 scales [n_rows, page, Hkv] when `quantized`; page_table int32 [B, P];
// seq_lens int32 [B]; lse f32 [B, Hq]. All contiguous. D is 64 or 128, the
// group Hq / Hkv 1 to 8, the page 8, 16, 32, 64 or 128 tokens; the table's
// P pages are walked in chunks of chunk_pages, at most 8 chunks.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* seq_lens, void* out, void* lse, int B, int Hq, int Hkv, int D,
    int page, int P, int n_rows, int quantized, int chunk_pages,
    float sm_scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > MAX_GROUP || P <= 0 ||
      n_rows <= 0 || chunk_pages <= 0 ||
      (P + chunk_pages - 1) / chunk_pages > MAX_CHUNKS ||
      (page != 8 && page != 16 && page != 32 && page != 64 && page != 128) ||
      (D != 64 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = Hq / Hkv;
  const int tt = page < 16 ? 16 : page;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define D_CASE(DD)                                                           \
  if (D == DD)                                                               \
    return quantized                                                         \
               ? launch_tt<DD, true>(tt, q, k_pool, v_pool, k_scale,         \
                                     v_scale, page_table, seq_lens, out, lse, \
                                     B, Hkv, group, page, P, n_rows,          \
                                     chunk_pages, sm_scale, s)               \
               : launch_tt<DD, false>(tt, q, k_pool, v_pool, k_scale,        \
                                      v_scale, page_table, seq_lens, out,    \
                                      lse, B, Hkv, group, page, P, n_rows,   \
                                      chunk_pages, sm_scale, s);
  D_CASE(64)
  D_CASE(128)
#undef D_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
