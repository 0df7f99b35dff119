// Blockwise (flash) attention backward for Hopper (sm_90a): causal or
// bidirectional, grouped-query heads, segment and positional masks. Two
// kernels, as in the reference: dq over key tiles, and dk / dv over query
// tiles in the transposed score space.
//
// Replaces: procyon_tpu/ops/flash_attention.py::_bwd_dq_kernel (pallas_call
// in _bwd) and ::_bwd_dkv_kernel (the second pallas_call in _bwd), reached
// through the custom VJP of flash_attention (_flash_bwd) by every gradient
// of the Llama decoder.
//
// What they compute, per (batch b, query head h, query row i, key j), with
// the key/value head hk = h / (Hq / Hkv), the forward's log-sum-exp in base
// 2 (lse2 = lse * log2(e)) and delta_i = sum_d do_id * out_id (f32, given):
//   s_ij  = (q_i . k_j) * scale2          f32 sums; scale2 = sm_scale*log2(e)
//   p_ij  = allowed_ij ? exp2(s_ij - lse2_i) : 0
//   dp_ij = do_i . v_j                     f32 sums
//   ds_ij = bf16(p_ij * (dp_ij - delta_i))
//   dq_i  = sm_scale * sum_j ds_ij k_j                       (f32 sums)
//   dk_j  = sm_scale * sum_{h in group(hk)} sum_i ds_ij q_i  (f32 sums)
//   dv_j  = sum_{h in group(hk)} sum_i bf16(p_ij) do_i       (f32 sums)
// with allowed_ij = seg_q[i] == seg_kv[j] && seg_q[i] > 0 && (!causal ||
// q_pos[i] >= kv_pos[j]). The outputs are rounded to bf16 once, at the end.
// A row or key that nothing allows gets exact zeros.
//
// What bounds them on the H100: the operations. At the training shape
// (B2, S2048, Hq 32, Hkv 8, D 128, causal) the least work is five products
// of 2 S^2 D / 2 per (b, h), 1.7e11 FLOP (0.17 ms at 989 TFLOP/s), against
// 168 MB of q, k, v, do, out and the three gradients (0.05 ms at
// 3.35 TB/s). The two-kernel split recomputes s and dp in both: seven
// products.
//
// What the design does about it. Every product runs on the tensor cores.
// No online softmax is needed: p is exact against the forward's lse, so
// the forward's trap of fully masked leading key tiles (a running max of
// -1e30) has no counterpart here.
//   dq kernel (mma.sync m16n8k16, bf16 in, f32 out, the fragment plumbing
//   of csrc/flash_attention_fwd.cu): a block of four warps owns 64 query
//   rows of one head; per 64-key tile it forms s = Q K^T and dp = dO V^T,
//   then ds, and adds ds K into a [16, D] f32 accumulator per warp; the
//   score fragments, rounded to bf16, are already the next product's A
//   operand, and [k][n] operands come through ldmatrix.trans.
//   dk / dv kernel (wgmma, csrc/wgmma.cuh): one warpgroup owns 64 keys of
//   one kv head (K and V copied once into shared memory in wgmma's swizzled
//   layout, D 24 zero-padded to 32) and walks the 64-row query tiles of
//   every query head of the group, in the transposed orientation. The
//   query tiles (Q, dO and their rows' segment ids, positions, lse2 and
//   delta) come through a two-stage cp.async ring whose copies arrive on
//   the stage's mbarrier, so tile j + 1 is in flight while tile j is
//   multiplied. Per tile: s^T = K Q^T and dp^T = V dO^T by wgmma
//   m64n64k16 with both operands K-major in shared memory; p and ds in
//   registers; then dv += bf16(p^T) dO and dk += ds^T Q with p^T / ds^T as
//   the register A operand and dO / Q read MN-major (transposed) from the
//   same tiles. The GQA sum over the group's heads happens in those f32
//   registers, inside the kernel, with no atomics and no [B, Hq, S, D]
//   intermediate, so the result is the same bit for bit on every launch.
//   At D 128 the two accumulators take 128 registers a thread and s^T /
//   dp^T 64 more (254 in all, two blocks an SM). The key tile is the
//   grid's slowest index: under the causal bound the first key tiles walk
//   the most query tiles, so they are issued first. Measured times:
//   PERF.md section 6.
// The TPU kernels padded both sequence axes to 128 and carried the masks as
// 8-sublane / 128-lane broadcast arrays for Mosaic; here Sq and Skv are
// arguments, ragged tiles are masked, and each thread reads the segment ids
// and positions it needs. Work the data rules out is skipped: with
// `bounded` (positions are the row indices, Sq == Skv) key tiles above the
// diagonal in dq and query tiles below it in dk / dv; tiles that hold only
// padding on either side.
// Later work: the dq kernel on wgmma; overlapping a warpgroup's products
// with its elementwise work (each product group is waited for before the
// next step); K/V tiles in shared memory across the dq blocks of a group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// dq kernel
constexpr int BQ = 64;    // query rows per block, 16 per warp
constexpr int BK = 64;    // keys per tile
constexpr int NT = 128;   // four warps

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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct Dims {
  static constexpr int DP = (D + 15) / 16 * 16;  // padded head_dim
  static constexpr int LD = DP + 8;              // shared-memory row stride
  static constexpr int KS = DP / 16;             // k-steps over head_dim
  static constexpr int ND = DP / 8;              // 8-wide column tiles
  static constexpr int dq_bytes = (2 * BQ + 2 * BK) * LD * 2 + 2 * BK * 4;
};

// rows [row0, row0 + ROWS) of a [n_rows, D] bf16 matrix with row stride
// `rs` into shared memory, 16 bytes a thread; rows beyond n_rows and the
// padded columns are zero
template <int D, int ROWS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long rs, int row0, int n_rows,
                                           int tid) {
  constexpr int CH = D / 8, CHP = Dims<D>::DP / 8, LD = Dims<D>::LD;
  for (int i = tid; i < ROWS * CHP; i += NT) {
    const int r = i / CHP, c = i % CHP, s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < n_rows && c < CH)
      val = *reinterpret_cast<const uint4*>(src + (long long)s * rs + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// c[n][.] += A(16 rows at `a_rows`) . B(rows at `b_rows`)^T over head_dim:
// the score-shaped product of two row-major [rows][D] tiles, NN 8-wide
// column tiles
template <int D, int NN>
__device__ __forceinline__ void rows_dot_rows(float (&c)[NN][4],
                                              const __nv_bfloat16* a_rows,
                                              const __nv_bfloat16* b_rows,
                                              int g, int t) {
  constexpr int LD = Dims<D>::LD;
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Dims<D>::KS; ++kk) {
    const __nv_bfloat16* ap = a_rows + g * LD + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld_u32(ap), ld_u32(ap + 8 * LD), ld_u32(ap + 8),
                           ld_u32(ap + 8 * LD + 8)};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const __nv_bfloat16* bp = b_rows + (n * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(c[n], a, ld_u32(bp), ld_u32(bp + 8));
    }
  }
}

// acc[d][.] += bf16(x) . M, where x [16, NN * 8] is a score-shaped fragment
// set and M the row-major [NN * 8][D] tile at `m_rows`
template <int D, int NN>
__device__ __forceinline__ void scores_dot_tile(float (&acc)[Dims<D>::ND][4],
                                                const float (&x)[NN][4],
                                                const __nv_bfloat16* m_rows,
                                                int lane) {
  constexpr int LD = Dims<D>::LD, ND = Dims<D>::ND;
#pragma unroll
  for (int kk = 0; kk < NN / 2; ++kk) {
    const uint32_t a[4] = {wg::pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           wg::pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           wg::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           wg::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    // lanes 0-7 / 8-15 address rows 0-7 / 8-15 of columns d..d+7, lanes
    // 16-31 the same rows of columns d+8..d+15
    const __nv_bfloat16* mp =
        m_rows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
        (lane >> 4) * 8;
#pragma unroll
    for (int d2 = 0; d2 < ND / 2; ++d2) {
      uint32_t bm[4];
      ldmatrix_x4_trans(bm, mp + d2 * 16);
      mma_bf16(acc[2 * d2], a, bm[0], bm[1]);
      mma_bf16(acc[2 * d2 + 1], a, bm[2], bm[3]);
    }
  }
}

// a warp's 16 rows of a [rows, D] accumulator, times `scale`, as bf16 into
// the contiguous [B, S, H, D] output at rows row0.. (rows >= S skipped)
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[Dims<D>::ND][4],
                                           float scale, int b, int row0, int S,
                                           int H, int h, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + g + 8 * r;
    if (s >= S) continue;
    __nv_bfloat16* orow = out + (((long long)b * S + s) * H + h) * D;
#pragma unroll
    for (int d = 0; d < Dims<D>::ND; ++d) {
      const int c = d * 8 + 2 * t;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ seg_kv,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq,
                    int group, Strides sq, Strides sk, Strides sv,
                    Strides sdo, float scale2, float sm_scale, int causal,
                    int bounded) {
  constexpr int LD = Dims<D>::LD, ND = Dims<D>::ND;
  constexpr int NK = BK / 8;    // 8-wide key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* dOs = Qs + BQ * LD;                               // [BQ][LD]
  __nv_bfloat16* Ks = dOs + BQ * LD;                               // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;                                // [BK][LD]
  int* segk = reinterpret_cast<int*>(Vs + BK * LD);                // [BK]
  int* kpos = segk + BK;                                           // [BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const __nv_bfloat16* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const __nv_bfloat16* dob = dout + (long long)b * sdo.b + (long long)h * sdo.h;
  const __nv_bfloat16* kb = k + (long long)b * sk.b + (long long)hk * sk.h;
  const __nv_bfloat16* vb = v + (long long)b * sv.b + (long long)hk * sv.h;
  const int* segk_b = seg_kv + (long long)b * Skv;
  const int* kpos_b = kv_pos + (long long)b * Skv;
  const long long row_base = ((long long)b * Hq + h) * Sq;

  // this thread's two query rows: r = 0 -> row g, r = 1 -> row g + 8
  const int wrow = warp * 16;
  int segq[2], qp[2];
  float lse_r[2], del_r[2];
  int live_rows = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + wrow + g + 8 * r;
    const bool in = s < Sq;
    segq[r] = in ? seg_q[(long long)b * Sq + s] : 0;
    qp[r] = in ? q_pos[(long long)b * Sq + s] : 0;
    lse_r[r] = in ? lse2[row_base + s] : 0.f;
    del_r[r] = in ? delta[row_base + s] : 0.f;
    live_rows |= segq[r] > 0;
  }
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  // the branch and everything inside it is uniform over the block
  if (__syncthreads_or(live_rows)) {
    stage_tile<D, BQ>(Qs, qb, sq.r, q0, Sq, tid);
    stage_tile<D, BQ>(dOs, dob, sdo.r, q0, Sq, tid);
    const int kv_hi = (causal && bounded) ? min(Skv, q0 + BQ) : Skv;

    for (int k0 = 0; k0 < kv_hi; k0 += BK) {
      __syncthreads();  // Q, dO staged / previous tile consumed
      int live_keys = 0;
      if (tid < BK) {
        const int s = k0 + tid;
        const int sg = s < Skv ? segk_b[s] : 0;
        segk[tid] = sg;
        kpos[tid] = s < Skv ? kpos_b[s] : 0;
        live_keys = sg > 0;
      }
      if (!__syncthreads_or(live_keys)) continue;  // a tile of padding
      stage_tile<D, BK>(Ks, kb, sk.r, k0, Skv, tid);
      stage_tile<D, BK>(Vs, vb, sv.r, k0, Skv, tid);
      __syncthreads();

      float sc[NK][4], dp[NK][4];
      rows_dot_rows<D, NK>(sc, Qs + wrow * LD, Ks, g, t);
      rows_dot_rows<D, NK>(dp, dOs + wrow * LD, Vs, g, t);

      // sc[n][e]: row g + 8 * (e >> 1), key n * 8 + 2 * t + (e & 1)
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
          const float p =
              ok ? exp2f(__fmul_rn(sc[n][e], scale2) - lse_r[r]) : 0.f;
          sc[n][e] = p * (dp[n][e] - del_r[r]);
        }
      }
      scores_dot_tile<D, NK>(acc, sc, Ks, lane);
    }
  }
  store_rows<D>(dq, acc, sm_scale, b, q0 + wrow, Sq, Hq, h, g, t);
}

// ---- dk / dv: one warpgroup of 64 keys, wgmma, a cp.async ring ----------

constexpr int KV_NT = 128;   // one warpgroup
constexpr int KV_NS = 2;     // stages of the query-tile ring
constexpr int KV_BQ = 64;    // query rows a tile

template <int D>
struct KvLayout {
  static constexpr int DP = D == 24 ? 32 : D;   // wgmma's k is 16
  using T = wg::Tile<DP, 64>;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = T::BYTES;
  static constexpr int RING = 2 * T::BYTES;
  // a stage: Q and dO (swizzled), then the tile's segment ids, positions,
  // lse2 and delta, 64 of each
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = T::BYTES;
  static constexpr int SEG_OFF = 2 * T::BYTES;
  static constexpr int POS_OFF = SEG_OFF + 4 * KV_BQ;
  static constexpr int LSE_OFF = POS_OFF + 4 * KV_BQ;
  static constexpr int DEL_OFF = LSE_OFF + 4 * KV_BQ;
  static constexpr int STAGE = (DEL_OFF + 4 * KV_BQ + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = RING + KV_NS * STAGE;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * KV_NS;
};

// rows [row0, row0 + 64) of a [n_rows, D] bf16 matrix with row stride rs
// into a swizzled [64][DP] tile; rows beyond n_rows and the padding
// columns of D 24 are zero-filled
template <int D>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int row0, int n_rows,
                                          int tid) {
  using T = typename KvLayout<D>::T;
  for (int i = tid; i < 64 * T::CHUNKS; i += KV_NT) {
    const int r = i / T::CHUNKS, c = i % T::CHUNKS, s = row0 + r;
    const bool in = s < n_rows && c < D / 8;
    wg::cp16(dst + T::offset(r, c), src + (in ? (long long)s * rs + c * 8 : 0),
             in);
  }
}

struct KvArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse2, *delta;
  const int *seg_q, *seg_kv, *q_pos, *kv_pos;
  __nv_bfloat16 *dk, *dv;
  int B, Sq, Skv, Hq, Hkv, group;
  Strides sq, sk, sv, sdo;
  float scale2, sm_scale;
  int causal, bounded;
};

// query tile q0 of query head h into a stage, then the stage's arrival
template <int D>
__device__ __forceinline__ void copy_query_tile(const KvArgs& a,
                                                unsigned char* st,
                                                uint32_t bar, int b, int h,
                                                int q0, int tid) {
  using L = KvLayout<D>;
  const uint32_t base = wg::smem_u32(st);
  copy_rows<D>(base + L::Q_OFF, a.q + (long long)b * a.sq.b + (long long)h * a.sq.h,
               a.sq.r, q0, a.Sq, tid);
  copy_rows<D>(base + L::DO_OFF,
               a.dout + (long long)b * a.sdo.b + (long long)h * a.sdo.h, a.sdo.r,
               q0, a.Sq, tid);
  const long long row = (long long)b * a.Sq, lrow = ((long long)b * a.Hq + h) * a.Sq;
  for (int i = tid; i < 4 * KV_BQ; i += KV_NT) {
    const int kind = i / KV_BQ, r = i % KV_BQ, s = q0 + r;
    const bool in = s < a.Sq;
    const int si = in ? s : 0;
    const void* src = kind == 0   ? (const void*)(a.seg_q + row + si)
                      : kind == 1 ? (const void*)(a.q_pos + row + si)
                      : kind == 2 ? (const void*)(a.lse2 + lrow + si)
                                  : (const void*)(a.delta + lrow + si);
    wg::cp4(base + L::SEG_OFF + kind * 4 * KV_BQ + 4 * r, src, in);
  }
  wg::cp_arrive(bar);
}

template <int D>
__global__ void __launch_bounds__(KV_NT, 1) flash_bwd_dkv_kernel(KvArgs a) {
  using L = KvLayout<D>;
  using T = typename L::T;
  constexpr int KS = L::DP / 16, NA = T::NATOM, A = T::A;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the key tile is the grid's slowest index: under the causal bound the
  // first key tiles walk the most query tiles, so they start first
  const int kt = blockIdx.x / (a.Hkv * a.B);
  const int hk = blockIdx.x % a.Hkv;
  const int b = (blockIdx.x / a.Hkv) % a.B;
  const int k0 = kt * 64;
  const int key0 = k0 + (tid >> 5) * 16 + g;   // this thread's keys: +0, +8
  int segk[2], kp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = key0 + 8 * r;
    segk[r] = s < a.Skv ? a.seg_kv[(long long)b * a.Skv + s] : 0;
    kp[r] = s < a.Skv ? a.kv_pos[(long long)b * a.Skv + s] : 0;
  }
  if (tid == 0) {
    for (int i = 0; i < KV_NS; ++i) wg::mbar_init(wg::smem_u32(bars + i), KV_NT);
    wg::mbar_fence_init();
  }
  const int live = __syncthreads_or(segk[0] > 0 || segk[1] > 0);
  // with the row indices as positions, query rows before k0 see none of
  // these keys
  const int q_lo = (a.causal && a.bounded) ? min(k0, a.Sq) : 0;
  const int nq = (a.Sq - q_lo + KV_BQ - 1) / KV_BQ;
  const int total = live ? a.group * nq : 0;
  unsigned char* ring = smem + L::RING;
  const uint32_t kbase = wg::smem_u32(smem + L::K_OFF);
  const uint32_t vbase = wg::smem_u32(smem + L::V_OFF);
  if (total > 0) {
    // K and V once; the first stage's arrival covers them too
    copy_rows<D>(kbase, a.k + (long long)b * a.sk.b + (long long)hk * a.sk.h,
                 a.sk.r, k0, a.Skv, tid);
    copy_rows<D>(vbase, a.v + (long long)b * a.sv.b + (long long)hk * a.sv.h,
                 a.sv.r, k0, a.Skv, tid);
    copy_query_tile<D>(a, ring, wg::smem_u32(bars), b, hk * a.group, q_lo, tid);
  }

  float dk[NA][A / 2], dv[NA][A / 2];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < A / 2; ++j) dk[i][j] = dv[i][j] = 0.f;
  float st[32], dp[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) st[j] = dp[j] = 0.f;
  uint32_t pf[4][4], df[4][4];

  for (int j = 0; j < total; ++j) {
    unsigned char* stage = ring + (j % KV_NS) * L::STAGE;
    wg::mbar_wait(wg::smem_u32(bars + j % KV_NS), (j / KV_NS) & 1);
    wg::fence_async_smem();
    const int* segq = reinterpret_cast<const int*>(stage + L::SEG_OFF);
    // also: every thread is past tile j - 1, whose stage is refilled next
    const int any = __syncthreads_or(tid < KV_BQ && segq[tid] > 0);
    if (j + 1 < total)
      copy_query_tile<D>(a, ring + ((j + 1) % KV_NS) * L::STAGE,
                         wg::smem_u32(bars + (j + 1) % KV_NS), b,
                         hk * a.group + (j + 1) / nq,
                         q_lo + ((j + 1) % nq) * KV_BQ, tid);
    if (!any) continue;   // a tile of padding

    const uint32_t qbase = wg::smem_u32(stage + L::Q_OFF);
    const uint32_t dobase = wg::smem_u32(stage + L::DO_OFF);
    // transposed scores: st[4 c + e] is key key0 + 8 (e >> 1) against
    // query 8 c + 2 t + (e & 1) of the tile
    wg::hold(st);
    wg::hold(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss64(st, T::kmajor(kbase, kk), T::kmajor(qbase, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss64(dp, T::kmajor(vbase, kk), T::kmajor(dobase, kk), kk > 0);
    wg::commit();
    wg::wait_all();
    wg::hold(st);
    wg::hold(dp);

    const int* qpos = reinterpret_cast<const int*>(stage + L::POS_OFF);
    const float* lse = reinterpret_cast<const float*>(stage + L::LSE_OFF);
    const float* del = reinterpret_cast<const float*>(stage + L::DEL_OFF);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * t;
      const int2 qs = *reinterpret_cast<const int2*>(segq + col);
      const int2 qp = *reinterpret_cast<const int2*>(qpos + col);
      const float2 ls = *reinterpret_cast<const float2*>(lse + col);
      const float2 de = *reinterpret_cast<const float2*>(del + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qsg = (e & 1) ? qs.y : qs.x;
        // rows beyond Sq carry segment 0 and fail the first test
        const bool ok = qsg > 0 && qsg == segk[r] &&
                        (!a.causal || ((e & 1) ? qp.y : qp.x) >= kp[r]);
        const float p = ok ? exp2f(__fmul_rn(st[4 * c + e], a.scale2) -
                                   ((e & 1) ? ls.y : ls.x))
                           : 0.f;
        st[4 * c + e] = p;
        dp[4 * c + e] = p * (dp[4 * c + e] - ((e & 1) ? de.y : de.x));
      }
    }
    wg::to_a(pf, st);   // bf16(p^T)
    wg::to_a(df, dp);   // ds^T = bf16(p^T (dp^T - delta))

#pragma unroll
    for (int i = 0; i < NA; ++i) {
      wg::hold(dk[i]);
      wg::hold(dv[i]);
    }
    wg::hold(pf);
    wg::hold(df);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        wg::rs<A>(dv[i], pf[kk], T::mnmajor(dobase, kk, i));
        wg::rs<A>(dk[i], df[kk], T::mnmajor(qbase, kk, i));
      }
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      wg::hold(dk[i]);
      wg::hold(dv[i]);
    }
    wg::hold(pf);
    wg::hold(df);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = key0 + 8 * r;
    if (s >= a.Skv) continue;
    const long long off = (((long long)b * a.Skv + s) * a.Hkv + hk) * D;
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int c = 0; c < A / 8; ++c) {
        const int col = i * A + 8 * c + 2 * t;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + off + col) =
              __floats2bfloat162_rn(dk[i][4 * c + 2 * r] * a.sm_scale,
                                    dk[i][4 * c + 2 * r + 1] * a.sm_scale);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + off + col) =
              __floats2bfloat162_rn(dv[i][4 * c + 2 * r],
                                    dv[i][4 * c + 2 * r + 1]);
        }
      }
  }
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.r % 8 == 0 && s.h % 8 == 0;
}

struct Args {
  const void *q, *k, *v, *dout, *lse2, *delta, *seg_q, *seg_kv, *q_pos,
      *kv_pos;
  int B, Sq, Skv, Hq, Hkv;
  Strides sq, sk, sv, sdo;
  float scale2, sm_scale;
  int causal, bounded;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  constexpr int bytes = Dims<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  flash_bwd_dq_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse2), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.seg_q), static_cast<const int*>(a.seg_kv),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_pos),
      static_cast<__nv_bfloat16*>(dq), a.Sq, a.Skv, a.Hq, a.Hq / a.Hkv, a.sq,
      a.sk, a.sv, a.sdo, a.scale2, a.sm_scale, a.causal, a.bounded);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv,
                       cudaStream_t stream) {
  constexpr int bytes = KvLayout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const KvArgs k{static_cast<const __nv_bfloat16*>(a.q),
                 static_cast<const __nv_bfloat16*>(a.k),
                 static_cast<const __nv_bfloat16*>(a.v),
                 static_cast<const __nv_bfloat16*>(a.dout),
                 static_cast<const float*>(a.lse2),
                 static_cast<const float*>(a.delta),
                 static_cast<const int*>(a.seg_q),
                 static_cast<const int*>(a.seg_kv),
                 static_cast<const int*>(a.q_pos),
                 static_cast<const int*>(a.kv_pos),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv),
                 a.B, a.Sq, a.Skv, a.Hq, a.Hkv, a.Hq / a.Hkv,
                 a.sq, a.sk, a.sv, a.sdo,
                 a.scale2, a.sm_scale, a.causal, a.bounded};
  const int grid = (a.Skv + 63) / 64 * a.Hkv * a.B;
  flash_bwd_dkv_kernel<D><<<grid, KV_NT, bytes, stream>>>(k);
  return cudaGetLastError();
}

int make_args(Args& a, const void* q, const void* k, const void* v,
              const void* dout, const void* lse2, const void* delta,
              const void* seg_q, const void* seg_kv, const void* q_pos,
              const void* kv_pos, int B, int Sq, int Skv, int Hq, int Hkv,
              const long long* strides, float scale2, float sm_scale,
              int causal, int bounded) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a = Args{q,     k,      v,     dout,   lse2, delta, seg_q,
           seg_kv, q_pos, kv_pos, B,     Sq,   Skv,   Hq,
           Hkv,   {strides[0], strides[1], strides[2]},
           {strides[3], strides[4], strides[5]},
           {strides[6], strides[7], strides[8]},
           {strides[9], strides[10], strides[11]},
           scale2, sm_scale, causal, bounded};
  if (!aligned16(q, a.sq) || !aligned16(k, a.sk) || !aligned16(v, a.sv) ||
      !aligned16(dout, a.sdo))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

}  // namespace

// Both entry points take: q, do: bf16 [B, Sq, Hq, D] and k, v: bf16
// [B, Skv, Hkv, D] as views with unit stride inside a head and the
// (batch, row, head) strides in elements given in `strides` (q, k, v, do:
// twelve numbers); every head row starts on a 16-byte boundary. lse2
// (the forward's natural log-sum-exp times log2(e)) and delta (sum over
// the head dim of do * out): f32 [B, Hq, Sq] contiguous. seg_q, q_pos:
// int32 [B, Sq]; seg_kv, kv_pos: int32 [B, Skv], contiguous. scale2 =
// sm_scale * log2(e). bounded: positions are the row indices and
// Sq == Skv. Each returns cudaGetLastError() after its launch.

// dq: bf16 [B, Sq, Hq, D] contiguous.
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, const void* seg_q,
    const void* seg_kv, const void* q_pos, const void* kv_pos, void* dq,
    int B, int Sq, int Skv, int Hq, int Hkv, int D, const long long* strides,
    float scale2, float sm_scale, int causal, int bounded, void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, dout, lse2, delta, seg_q, seg_kv,
                            q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, strides,
                            scale2, sm_scale, causal, bounded);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(a, dq, st);
    case 24: return launch_dq<24>(a, dq, st);
    case 32: return launch_dq<32>(a, dq, st);
    case 64: return launch_dq<64>(a, dq, st);
    case 128: return launch_dq<128>(a, dq, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dk, dv: bf16 [B, Skv, Hkv, D] contiguous, summed over the group's query
// heads.
extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, const void* seg_q,
    const void* seg_kv, const void* q_pos, const void* kv_pos, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    const long long* strides, float scale2, float sm_scale, int causal,
    int bounded, void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, dout, lse2, delta, seg_q, seg_kv,
                            q_pos, kv_pos, B, Sq, Skv, Hq, Hkv, strides,
                            scale2, sm_scale, causal, bounded);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(a, dk, dv, st);
    case 24: return launch_dkv<24>(a, dk, dv, st);
    case 32: return launch_dkv<32>(a, dk, dv, st);
    case 64: return launch_dkv<64>(a, dk, dv, st);
    case 128: return launch_dkv<128>(a, dk, dv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
