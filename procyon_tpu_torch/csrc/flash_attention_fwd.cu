// Blockwise (flash) attention forward for Hopper (sm_90a): causal or
// bidirectional, grouped-query heads, segment and positional masks,
// optional log-sum-exp.
//
// Replaces: procyon_tpu/ops/flash_attention.py::_fwd_kernel and
// ::_fwd_kernel_twophase (reached through _fwd / flash_attention, the
// Llama prefill), and procyon_tpu/ops/attention_rowblock.py::
// _rowblock_kernel (reached through rowblock_fwd: the same function on
// the same layout, taken by ESM2 where the packed kernel does not apply).
//
// What it computes, per (batch b, query head h, query row i), with the
// key/value head hk = h / (Hq / Hkv):
//   s_ij = (q_i . k_j) * scale2      f32 sums, scaled after the product;
//                                    scale2 = sm_scale * log2(e)
//   allowed_ij = seg_q[i] == seg_kv[j] && seg_q[i] > 0
//                && (!causal || q_pos[i] >= kv_pos[j])
//   s_ij = allowed_ij ? s_ij : -1e30
//   p_ij = exp2(s_ij - m_i), l_i = sum_j p_ij           (f32)
//   out_i = (sum_j bf16(p_ij) v_j) / l_i                (f32 sums)
//   lse_i = m_i * ln2 + ln(l_i)                         (natural log)
//   a dead row (m_i <= -5e29 or l_i == 0) gives out_i = 0, lse_i = -1e30.
//
// What bounds it on the H100: with each input read once the bytes win
// (at Llama-3-8B prefill shapes, B16 S512, 169 MB against 30 GFLOP: 0.05 ms
// by bytes, 0.03 ms by operations), but a kernel that re-reads K and V per
// query tile from L2 is held by how fast it feeds the two products.
//
// What the design does about it. Both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 out): a block of four warps owns a
// 64-row query tile, each warp 16 rows; Q K^T reads Q and K fragments from
// padded shared-memory rows (row stride D + 8 elements, so the eight rows
// of a fragment fall on distinct banks), the scores stay in registers,
// the online softmax runs on them (row max and sum across the four lanes
// of a quad), and the probabilities, rounded to bf16, are already laid
// out as the A operand of P V; V's fragments come through
// ldmatrix.trans. Nothing but the K and V tiles goes through shared
// memory. The TPU kernels kept a whole [block_q, Skv] score row
// (two-phase) or 512-wide key blocks in VMEM, padded both sequence axes
// to 128 and carried the masks as lane-broadcast arrays; here keys are
// tiled by 64, Sq and Skv are arguments and ragged edges are masked, and
// each thread reads the segment id and position of its own two rows. The
// Hq/Hkv query heads of a group read the same K/V head in place (no
// repeated copy), and their blocks are neighbours in launch order so the
// second reader finds the tile in L2. q, k and v come with (batch, row,
// head) strides, so the flat [B, S, H*D] projections and a
// [B, Smax, Hkv, D] cache are read without a transpose, 16 bytes a
// thread. Work that the data rules out is skipped: key tiles above the
// diagonal when the positions are the row indices (`bounded`), key tiles
// that hold only padding, and query tiles that hold only padding.
// A row whose first key tiles are fully masked accumulates garbage against
// m = -1e30; the first allowed key raises m, exp2(-1e30 - m) is exactly 0
// and wipes it, and no NaN can arise because every score is finite.
// A head_dim that is not a multiple of 16 (24) is zero-padded to one in
// shared memory.
// Later work: cp.async or TMA staging under the products, wgmma, sharing
// one K/V tile among the heads of a group inside a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block: 16 per warp
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // four warps
constexpr float MASK = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, r, h;  // batch, row, head; elements
};

// D = C + A * B for one m16n8k16 tile, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8x8 bf16 matrices: the B fragments (k = row, n = column)
// of two neighbouring n-tiles from row-major [k][n] storage
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;  // padded head_dim
  static constexpr int LD = DP + 8;              // shared-memory row stride
  static constexpr int bytes = (BQ + 2 * BK) * LD * 2 + 2 * BK * 4;
};

// rows [row0, row0 + 64) of a [rows, D] bf16 matrix with row stride `rs`
// into shared memory, 16 bytes a thread; rows beyond n_rows and the padded
// columns are zero
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long rs, int row0, int n_rows,
                                           int tid) {
  constexpr int CH = D / 8, CHP = Tile<D>::DP / 8, LD = Tile<D>::LD;
  for (int i = tid; i < 64 * CHP; i += NT) {
    const int r = i / CHP, c = i % CHP, s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < n_rows && c < CH)
      val = *reinterpret_cast<const uint4*>(src + (long long)s * rs + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv,
                 const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Skv, int Hq, int group, Strides sq, Strides sk,
                 Strides sv, float scale2, int causal, int bounded) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int DP = Tile<D>::DP;
  constexpr int LD = Tile<D>::LD;
  constexpr int KS = DP / 16;   // k-steps of Q K^T
  constexpr int ND = DP / 8;    // 8-wide column tiles of the output
  constexpr int NK = BK / 8;    // 8-wide key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                                // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;                                // [BK][LD]
  int* segk = reinterpret_cast<int*>(Vs + BK * LD);                // [BK]
  int* kpos = segk + BK;                                           // [BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row within 8
  const int t = lane & 3;    // fragment column pair
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const __nv_bfloat16* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const __nv_bfloat16* kb = k + (long long)b * sk.b + (long long)hk * sk.h;
  const __nv_bfloat16* vb = v + (long long)b * sv.b + (long long)hk * sv.h;
  const int* segq_b = seg_q + (long long)b * Sq;
  const int* qpos_b = q_pos + (long long)b * Sq;
  const int* segk_b = seg_kv + (long long)b * Skv;
  const int* kpos_b = kv_pos + (long long)b * Skv;

  // this thread's two query rows: r = 0 -> row g, r = 1 -> row g + 8
  const int wrow = warp * 16;
  int segq[2], qp[2];
  int live_rows = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + wrow + g + 8 * r;
    segq[r] = s < Sq ? segq_b[s] : 0;
    qp[r] = s < Sq ? qpos_b[s] : 0;
    live_rows |= segq[r] > 0;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  // the branch and everything inside it is uniform over the block
  if (__syncthreads_or(live_rows)) {
    stage_tile<D>(Qs, qb, sq.r, q0, Sq, tid);
    const int kv_hi = (causal && bounded) ? min(Skv, q0 + BQ) : Skv;

    for (int k0 = 0; k0 < kv_hi; k0 += BK) {
      __syncthreads();  // Q staged / previous tile's K, V, segk consumed
      int live_keys = 0;
      if (tid < BK) {
        const int s = k0 + tid;
        const int sg = s < Skv ? segk_b[s] : 0;
        segk[tid] = sg;
        kpos[tid] = s < Skv ? kpos_b[s] : 0;
        live_keys = sg > 0;
      }
      if (!__syncthreads_or(live_keys)) continue;  // a tile of padding
      stage_tile<D>(Ks, kb, sk.r, k0, Skv, tid);
      stage_tile<D>(Vs, vb, sv.r, k0, Skv, tid);
      __syncthreads();

      // scores of this warp's 16 rows against the 64 keys
      float sc[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* qa = Qs + (wrow + g) * LD + kk * 16 + 2 * t;
        const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * LD), ld_u32(qa + 8),
                               ld_u32(qa + 8 * LD + 8)};
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const __nv_bfloat16* kp = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(sc[n], a, ld_u32(kp), ld_u32(kp + 8));
        }
      }

      // mask, scale, online softmax; sc[n][e]: row g + 8 * (e >> 1),
      // key n * 8 + 2 * t + (e & 1)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int c = n * 8 + 2 * t;
        const int2 sg = *reinterpret_cast<const int2*>(segk + c);
        const int2 kp = *reinterpret_cast<const int2*>(kpos + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int ksg = (e & 1) ? sg.y : sg.x;
          const int kps = (e & 1) ? kp.y : kp.x;
          // keys beyond Skv carry segment 0 and fail the first test
          const bool ok = segq[r] > 0 && ksg == segq[r] &&
                          (!causal || qp[r] >= kps);
          sc[n][e] = ok ? __fmul_rn(sc[n][e], scale2) : MASK;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float rmax = -INFINITY;
#pragma unroll
        for (int n = 0; n < NK; ++n)
          rmax = fmaxf(rmax, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        const float mnew = fmaxf(m[r], rmax);
        const float alpha = exp2f(m[r] - mnew);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float p0 = exp2f(sc[n][2 * r] - mnew);
          const float p1 = exp2f(sc[n][2 * r + 1] - mnew);
          rs += p0 + p1;
          sc[n][2 * r] = p0;
          sc[n][2 * r + 1] = p1;
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[r] = l[r] * alpha + rs;
        m[r] = mnew;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          o[d][2 * r] *= alpha;
          o[d][2 * r + 1] *= alpha;
        }
      }

      // out += bf16(P) V: the score fragments of two key tiles are the A
      // fragment of one 16-key step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
        // lanes 0-7 / 8-15 address keys 0-7 / 8-15 of columns d..d+7,
        // lanes 16-31 the same keys of columns d+8..d+15
        const __nv_bfloat16* vp =
            Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
            (lane >> 4) * 8;
#pragma unroll
        for (int d2 = 0; d2 < ND / 2; ++d2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vp + d2 * 16);
          mma_bf16(o[2 * d2], a, bv[0], bv[1]);
          mma_bf16(o[2 * d2 + 1], a, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + wrow + g + 8 * r;
    if (s >= Sq) continue;
    const bool dead = (m[r] <= MASK * 0.5f) || (l[r] == 0.f);
    const float inv = dead ? 0.f : 1.f / l[r];
    __nv_bfloat16* orow = out + (((long long)b * Sq + s) * Hq + h) * D;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int c = d * 8 + 2 * t;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    }
    if (lse != nullptr && t == 0)
      lse[((long long)b * Hq + h) * Sq + s] =
          dead ? MASK : m[r] * LN2 + logf(l[r]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg_q, const void* seg_kv, const void* q_pos,
                   const void* kv_pos, void* out, void* lse, int B, int Sq,
                   int Skv, int Hq, int Hkv, Strides sq, Strides sk,
                   Strides sv, float scale2, int causal, int bounded,
                   cudaStream_t stream) {
  constexpr int bytes = Tile<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_kv), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Skv, Hq, Hq / Hkv, sq, sk, sv, scale2,
      causal, bounded);
  return cudaGetLastError();
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.r % 8 == 0 && s.h % 8 == 0;
}

}  // namespace

// q: bf16 [B, Sq, Hq, D] and k, v: bf16 [B, Skv, Hkv, D] as views with unit
// stride inside a head and the given (batch, row, head) strides in
// elements; every head row starts on a 16-byte boundary (pointers
// 16-byte aligned, strides multiples of 8). seg_q, q_pos: int32 [B, Sq];
// seg_kv, kv_pos: int32 [B, Skv], contiguous. out: bf16 [B, Sq, Hq, D]
// contiguous. lse: f32 [B, Hq, Sq] contiguous, or null. bounded: positions
// are the row indices and Sq == Skv, so causal key tiles above the diagonal
// are skipped. Returns cudaGetLastError().
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, const void* q_pos, const void* kv_pos, void* out,
    void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    long long q_bs, long long q_rs, long long q_hs, long long k_bs,
    long long k_rs, long long k_hs, long long v_bs, long long v_rs,
    long long v_hs, float scale2, int causal, int bounded, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq{q_bs, q_rs, q_hs}, sk{k_bs, k_rs, k_hs},
      sv{v_bs, v_rs, v_hs};
  if (!aligned16(q, sq) || !aligned16(k, sk) || !aligned16(v, sv))
    return static_cast<int>(cudaErrorMisalignedAddress);
#define FLASH_CASE(DIM)                                                     \
  case DIM:                                                                 \
    return launch<DIM>(q, k, v, seg_q, seg_kv, q_pos, kv_pos, out, lse, B,  \
                       Sq, Skv, Hq, Hkv, sq, sk, sv, scale2, causal,        \
                       bounded, st)
  switch (D) {
    FLASH_CASE(16);
    FLASH_CASE(24);
    FLASH_CASE(32);
    FLASH_CASE(64);
    FLASH_CASE(128);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}
