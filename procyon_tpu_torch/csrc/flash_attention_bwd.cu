// Blockwise (flash) attention backward for Hopper (sm_90a): causal or
// bidirectional, grouped-query heads, segment and positional masks. Two
// kernels, as in the reference: dq over key tiles, and dk / dv over query
// tiles in the transposed score space.
//
// Replaces: procyon_tpu/ops/flash_attention.py::_bwd_dq_kernel (pallas_call
// in _bwd) and ::_bwd_dkv_kernel (the second pallas_call in _bwd), reached
// through the custom VJP of flash_attention (_flash_bwd) by every gradient
// of the Llama decoder. The reference computes delta and the base-2 lse
// outside its kernels; here the dq kernel computes delta and both kernels
// scale the forward's natural lse as they load it.
//
// What they compute, per (batch b, query head h, query row i, key j), with
// the key/value head hk = h / (Hq / Hkv), the forward's log-sum-exp in base
// 2 (lse2 = lse * log2(e), f32) and delta_i = sum_d do_id * out_id (f32):
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
// products, three in dq (0.1043 ms), four in dk / dv (0.1390 ms).
//
// What the design does about it. Every product runs on wgmma
// (csrc/wgmma.cuh). No online softmax is needed: p is exact against the
// forward's lse, so the forward's trap of fully masked leading key tiles (a
// running max of -1e30) has no counterpart here. Both kernels have one
// shape: one warpgroup (128 threads, two blocks an SM) owns a 64-row tile
// and copies it once into shared memory in wgmma's swizzled layout (head
// dim 24 zero-filled to 32); the tiles it walks come through a two-stage
// cp.async ring whose copies arrive on the stage's mbarrier, so tile j + 1
// is in flight while tile j is multiplied. Per tile: two products with both
// operands K-major in shared memory; p and ds in registers; then one or two
// products with p / ds as the register A operand and the other side read
// MN-major (transposed) from the same tile layout. No atomics: every
// output element is summed by one thread in a fixed order, so the result is
// the same bit for bit on every launch.
//   dq kernel: the block owns 64 query rows of one head (Q and dO) and walks
//   the live key tiles of the kv head (K, V, the keys' segment ids and
//   positions): s = Q K^T and dp = dO V^T as two product groups, p formed
//   while dp runs (wgmma.wait_group 1), then dq += ds K. It first
//   computes delta for its 64 rows from the dO tile and one read of their
//   out rows, uses it, and writes it to an f32 [B, Hq, Sq] buffer that the
//   dk / dv kernel, launched next on the same stream, reads. Every row
//   below Sq gets a value, also in blocks that hold only padding (0 there),
//   so the buffer needs no initialisation. At D 128 dq's accumulator takes
//   64 registers a thread and s / dp 64 more.
//   dk / dv kernel: the block owns 64 keys of one kv head (K and V) and
//   walks the 64-row query tiles of every query head of the group (Q, dO
//   and their rows' segment ids, positions, lse and delta) in the
//   transposed orientation: s^T = K Q^T and dp^T = V dO^T, then
//   dv += bf16(p^T) dO and dk += ds^T Q. The GQA sum over the group's heads
//   happens in those f32 registers, inside the kernel, with no
//   [B, Hq, S, D] intermediate. At D 128 the two accumulators take 128
//   registers a thread and s^T / dp^T 64 more.
// Each kernel's 64-row tile is the grid's slowest index, in the order that
// puts the tiles with the most work under the causal bound first; in dq the
// heads of a group are neighbours, so they find the K / V tiles in L2.
// The TPU kernels padded both sequence axes to 128 and carried the masks as
// 8-sublane / 128-lane broadcast arrays for Mosaic; here Sq and Skv are
// arguments, rows beyond them are zero-filled by the copies and carry
// segment 0. Work the data rules out is skipped: with `bounded` (positions
// are the row indices, Sq == Skv) key tiles above the diagonal in dq and
// query tiles below it in dk / dv; tiles that hold only padding on either
// side (dq lists its live key tiles first).
// What still holds them back: a warpgroup waits for its product groups
// before each step of elementwise work, so the tensor cores idle then
// unless the SM's other block fills them; each 64-row block reads every K /
// V (or Q / dO) tile of its walk again from L2. Registers and measured
// times: PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int NT = 128;   // one warpgroup
constexpr int NS = 2;     // stages of the ring
constexpr int BT = 64;    // rows of a tile (query rows or keys)
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, r, h;  // batch, row, head; elements
};

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout, *out;
  const float* lse;   // the forward's, natural log, [B, Hq, Sq]
  float* delta;       // [B, Hq, Sq]: written by dq, read by dk / dv
  const int *seg_q, *seg_kv, *q_pos, *kv_pos;
  int B, Sq, Skv, Hq, Hkv, group;
  Strides sq, sk, sv, sdo, so;
  float scale2, sm_scale;
  int causal, bounded;
};

template <int D>
struct Pad {
  static constexpr int DP = D == 24 ? 32 : D;   // wgmma's k is 16
  using T = wg::Tile<DP, 64>;
};

// rows [row0, row0 + 64) of a [n_rows, D] bf16 matrix with row stride rs
// into a swizzled [64][DP] tile; rows beyond n_rows and the padding
// columns of D 24 are zero-filled. NT is a multiple of the chunks a row, so
// a thread always copies the same chunk column c, of rows r0, r0 + RS, ...:
// the swizzle of (r, c) depends on r % 8 only, so their offsets step by RS
// rows
template <int D>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int row0, int n_rows,
                                          int tid) {
  using T = typename Pad<D>::T;
  constexpr int RS = NT / T::CHUNKS;
  static_assert(NT % T::CHUNKS == 0 && RS % 8 == 0 && BT % RS == 0,
                "copy rows");
  const int c = tid % T::CHUNKS, r0 = tid / T::CHUNKS;
  const bool col = c < D / 8;
  dst += T::offset(r0, c);
  const __nv_bfloat16* p = src + (long long)(row0 + r0) * rs + c * 8;
#pragma unroll
  for (int u = 0; u < BT / RS; ++u) {
    const bool in = col && row0 + r0 + u * RS < n_rows;
    wg::cp16(dst + u * RS * T::RB, in ? p : src, in);
    p += (long long)RS * rs;
  }
}

// 64 int32 (or f32) of a row array at row0.. (beyond n: zero) into smem
__device__ __forceinline__ void copy_ints(uint32_t dst, const void* src,
                                          int row0, int n, int tid) {
  const int s = row0 + tid;
  if (tid < BT)
    wg::cp4(dst + 4 * tid,
            static_cast<const int*>(src) + (s < n ? s : 0), s < n);
}

// sum of the products of two rows of 8 bf16, in f32
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
    s = fmaf(fa.x, fb.x, s);
    s = fmaf(fa.y, fb.y, s);
  }
  return s;
}

// a [64, D] f32 accumulator of one warpgroup (rows row0 + 16 warp + g, + 8),
// times `scale`, as bf16 into the contiguous [B, S, H, D] output (rows >= S
// skipped)
template <int D>
__device__ __forceinline__ void store_rows(
    __nv_bfloat16* out, const float (&acc)[Pad<D>::T::NATOM][Pad<D>::T::A / 2],
    float scale, int b, int row0, int S, int H, int h, int t) {
  using T = typename Pad<D>::T;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    if (s >= S) continue;
    __nv_bfloat16* orow = out + (((long long)b * S + s) * H + h) * D;
#pragma unroll
    for (int i = 0; i < T::NATOM; ++i)
#pragma unroll
      for (int c = 0; c < T::A / 8; ++c) {
        const int col = i * T::A + 8 * c + 2 * t;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[i][4 * c + 2 * r] * scale,
                                    acc[i][4 * c + 2 * r + 1] * scale);
      }
  }
}

// ---- dq: 64 query rows, the key tiles through the ring -------------------

template <int D>
struct DqLayout {
  using T = typename Pad<D>::T;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = T::BYTES;
  static constexpr int RING = 2 * T::BYTES;
  // a stage: K, V (swizzled), then the keys' segment ids and positions
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = T::BYTES;
  static constexpr int SEG_OFF = 2 * T::BYTES;
  static constexpr int POS_OFF = SEG_OFF + 4 * BT;
  static constexpr int STAGE = (POS_OFF + 4 * BT + 1023) / 1024 * 1024;
  static constexpr int DEL_OFF = RING + NS * STAGE;   // the rows' delta
  static constexpr int BAR_OFF = DEL_OFF + 4 * BT;
  static constexpr int LIST_OFF = BAR_OFF + 8 * NS + 8;  // count, then list
  static int bytes(int n_tiles) { return 1024 + LIST_OFF + 4 * n_tiles; }
};

// the key tile at k0 of kv head hk into a stage, then the stage's arrival
template <int D>
__device__ __forceinline__ void copy_key_tile(const Args& a,
                                              unsigned char* st,
                                              uint32_t bar, int b, int hk,
                                              int k0, int tid) {
  using L = DqLayout<D>;
  const uint32_t base = wg::smem_u32(st);
  copy_rows<D>(base + L::K_OFF,
               a.k + (long long)b * a.sk.b + (long long)hk * a.sk.h, a.sk.r,
               k0, a.Skv, tid);
  copy_rows<D>(base + L::V_OFF,
               a.v + (long long)b * a.sv.b + (long long)hk * a.sv.h, a.sv.r,
               k0, a.Skv, tid);
  const long long row = (long long)b * a.Skv;
  copy_ints(base + L::SEG_OFF, a.seg_kv + row, k0, a.Skv, tid);
  copy_ints(base + L::POS_OFF, a.kv_pos + row, k0, a.Skv, tid);
  wg::cp_arrive(bar);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_kernel(Args a, __nv_bfloat16* __restrict__ dq) {
  using L = DqLayout<D>;
  using T = typename L::T;
  constexpr int KS = Pad<D>::DP / 16, NA = T::NATOM, A = T::A;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  float* dels = reinterpret_cast<float*>(smem + L::DEL_OFF);
  int* n_live = reinterpret_cast<int*>(smem + L::LIST_OFF - 8);
  int* list = reinterpret_cast<int*>(smem + L::LIST_OFF);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // (query tile, batch, head): the query tile slowest and the last first
  // (under the causal bound it walks the most key tiles); the heads of a
  // group are neighbours
  const int nqt = (a.Sq + BT - 1) / BT;
  const int h = blockIdx.x % a.Hq;
  const int b = (blockIdx.x / a.Hq) % a.B;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x) / (a.Hq * a.B)) * BT;
  const int hk = h / a.group;
  const long long row = (long long)b * a.Sq;
  const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
  const int lr = (tid >> 5) * 16 + g;   // this thread's rows: lr, lr + 8
  int segq[2], qp[2];
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + lr + 8 * r;
    const bool in = s < a.Sq;
    segq[r] = in ? a.seg_q[row + s] : 0;
    qp[r] = in ? a.q_pos[row + s] : 0;
    lse2[r] = in ? __fmul_rn(a.lse[lrow + s], LOG2E) : 0.f;
  }

  // the live key tiles: below the causal bound, holding a key that is not
  // padding
  const int kv_hi = (a.causal && a.bounded) ? min(a.Skv, q0 + BT) : a.Skv;
  const int n_tiles = (kv_hi + BT - 1) / BT;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) wg::mbar_init(wg::smem_u32(bars + i), NT);
    wg::mbar_fence_init();
  }
  for (int i = tid; i < n_tiles; i += NT) list[i] = 0;
  __syncthreads();
  const int* segk_b = a.seg_kv + (long long)b * a.Skv;
  for (int i0 = 0; i0 < kv_hi; i0 += 16 * NT) {
    int sg[16];   // sixteen loads in flight a thread
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = i0 + u * NT + tid;
      sg[u] = i < kv_hi ? segk_b[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (sg[u] > 0) list[(i0 + u * NT + tid) / BT] = 1;
  }
  const int live = __syncthreads_or(segq[0] > 0 || segq[1] > 0);
  if (tid < 32) {
    // the live tiles' indices, in order, by one warp
    int n = 0;
    for (int i0 = 0; i0 < n_tiles; i0 += 32) {
      const int i = i0 + tid;
      const bool on = i < n_tiles && list[i];
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      __syncwarp();
      if (on) list[n + __popc(mask & ((1u << tid) - 1))] = i;
      n += __popc(mask);
    }
    if (tid == 0) *n_live = n;
  }
  __syncthreads();
  const int n = live ? *n_live : 0;

  const uint32_t qbase = wg::smem_u32(smem + L::Q_OFF);
  const uint32_t dobase = wg::smem_u32(smem + L::DO_OFF);
  unsigned char* ring = smem + L::RING;
  if (live) {
    // Q and dO once; the first stage's arrival covers them (also when no
    // key tile is live: delta still needs dO)
    copy_rows<D>(qbase, a.q + (long long)b * a.sq.b + (long long)h * a.sq.h,
                 a.sq.r, q0, a.Sq, tid);
    copy_rows<D>(dobase,
                 a.dout + (long long)b * a.sdo.b + (long long)h * a.sdo.h,
                 a.sdo.r, q0, a.Sq, tid);
    if (n > 0) {
      copy_key_tile<D>(a, ring, wg::smem_u32(bars), b, hk, list[0] * BT, tid);
    } else {
      wg::cp_arrive(wg::smem_u32(bars));
    }
  }

  // delta of the block's rows: two threads a row, alternate 8-column chunks
  // of dO (the staged tile) and out (read once); 0 for a padded row
  {
    const int dr = tid >> 1, s = q0 + dr;
    float part = 0.f;
    if (live) {
      wg::mbar_wait(wg::smem_u32(bars), 0);
      if (s < a.Sq) {
        const __nv_bfloat16* orow = a.out + (long long)b * a.so.b +
                                    (long long)s * a.so.r +
                                    (long long)h * a.so.h;
        for (int c = tid & 1; c < D / 8; c += 2)
          part += dot8(*reinterpret_cast<const uint4*>(orow + 8 * c),
                       *reinterpret_cast<const uint4*>(
                           smem + L::DO_OFF + T::offset(dr, c)));
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((tid & 1) == 0) {
      const float d = (s < a.Sq && a.seg_q[row + s] > 0) ? part : 0.f;
      dels[dr] = d;
      if (s < a.Sq) a.delta[lrow + s] = d;
    }
  }
  __syncthreads();
  const float del[2] = {dels[lr], dels[lr + 8]};

  float acc[NA][A / 2];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < A / 2; ++j) acc[i][j] = 0.f;
  float sc[32], dp[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
  uint32_t df[4][4];

  for (int j = 0; j < n; ++j) {
    unsigned char* st = ring + (j % NS) * L::STAGE;
    wg::mbar_wait(wg::smem_u32(bars + j % NS), (j / NS) & 1);
    wg::fence_async_smem();
    // also: every thread is past tile j - 1, whose stage is refilled next
    __syncthreads();
    if (j + 1 < n)
      copy_key_tile<D>(a, ring + ((j + 1) % NS) * L::STAGE,
                       wg::smem_u32(bars + (j + 1) % NS), b, hk,
                       list[j + 1] * BT, tid);

    const uint32_t kbase = wg::smem_u32(st + L::K_OFF);
    const uint32_t vbase = wg::smem_u32(st + L::V_OFF);
    // scores: sc[4 c + e] is row lr + 8 (e >> 1) against key
    // 8 c + 2 t + (e & 1) of the tile
    wg::hold(sc);
    wg::hold(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss64(sc, T::kmajor(qbase, kk), T::kmajor(kbase, kk), kk > 0);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss64(dp, T::kmajor(dobase, kk), T::kmajor(vbase, kk), kk > 0);
    wg::commit();
    wg::wait_one();   // s; p is formed while dp = dO V^T runs
    wg::hold(sc);

    const int* segk = reinterpret_cast<const int*>(st + L::SEG_OFF);
    const int* kpos = reinterpret_cast<const int*>(st + L::POS_OFF);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * t;
      const int2 sk = *reinterpret_cast<const int2*>(segk + col);
      const int2 kp = *reinterpret_cast<const int2*>(kpos + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int ksg = (e & 1) ? sk.y : sk.x;
        // keys beyond Skv carry segment 0 and fail the first test
        const bool ok = segq[r] > 0 && ksg == segq[r] &&
                        (!a.causal || qp[r] >= ((e & 1) ? kp.y : kp.x));
        sc[4 * c + e] =
            ok ? exp2f(__fmul_rn(sc[4 * c + e], a.scale2) - lse2[r]) : 0.f;
      }
    }
    wg::wait_all();   // dp
    wg::hold(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - del[(i >> 1) & 1]);
    wg::to_a(df, dp);   // ds = bf16(p (dp - delta))

#pragma unroll
    for (int i = 0; i < NA; ++i) wg::hold(acc[i]);
    wg::hold(df);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < NA; ++i)
        wg::rs<A>(acc[i], df[kk], T::mnmajor(kbase, kk, i));
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int i = 0; i < NA; ++i) wg::hold(acc[i]);
    wg::hold(df);
  }
  store_rows<D>(dq, acc, a.sm_scale, b, q0 + lr, a.Sq, a.Hq, h, t);
}

// ---- dk / dv: 64 keys, the query tiles of the group through the ring -----

template <int D>
struct KvLayout {
  using T = typename Pad<D>::T;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = T::BYTES;
  static constexpr int RING = 2 * T::BYTES;
  // a stage: Q and dO (swizzled), then the tile's segment ids, positions,
  // lse and delta, 64 of each
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = T::BYTES;
  static constexpr int SEG_OFF = 2 * T::BYTES;
  static constexpr int POS_OFF = SEG_OFF + 4 * BT;
  static constexpr int LSE_OFF = POS_OFF + 4 * BT;
  static constexpr int DEL_OFF = LSE_OFF + 4 * BT;
  static constexpr int STAGE = (DEL_OFF + 4 * BT + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = RING + NS * STAGE;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * NS;
};

// query tile q0 of query head h into a stage, then the stage's arrival
template <int D>
__device__ __forceinline__ void copy_query_tile(const Args& a,
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
  for (int i = tid; i < 4 * BT; i += NT) {
    const int kind = i / BT, r = i % BT, s = q0 + r;
    const bool in = s < a.Sq;
    const int si = in ? s : 0;
    const void* src = kind == 0   ? (const void*)(a.seg_q + row + si)
                      : kind == 1 ? (const void*)(a.q_pos + row + si)
                      : kind == 2 ? (const void*)(a.lse + lrow + si)
                                  : (const void*)(a.delta + lrow + si);
    wg::cp4(base + L::SEG_OFF + kind * 4 * BT + 4 * r, src, in);
  }
  wg::cp_arrive(bar);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkv_kernel(Args a, __nv_bfloat16* __restrict__ dk_out,
                         __nv_bfloat16* __restrict__ dv_out) {
  using L = KvLayout<D>;
  using T = typename L::T;
  constexpr int KS = Pad<D>::DP / 16, NA = T::NATOM, A = T::A;
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
  const int k0 = kt * BT;
  const int key0 = k0 + (tid >> 5) * 16 + g;   // this thread's keys: +0, +8
  int segk[2], kp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = key0 + 8 * r;
    segk[r] = s < a.Skv ? a.seg_kv[(long long)b * a.Skv + s] : 0;
    kp[r] = s < a.Skv ? a.kv_pos[(long long)b * a.Skv + s] : 0;
  }
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) wg::mbar_init(wg::smem_u32(bars + i), NT);
    wg::mbar_fence_init();
  }
  const int live = __syncthreads_or(segk[0] > 0 || segk[1] > 0);
  // with the row indices as positions, query rows before k0 see none of
  // these keys
  const int q_lo = (a.causal && a.bounded) ? min(k0, a.Sq) : 0;
  const int nq = (a.Sq - q_lo + BT - 1) / BT;
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
    unsigned char* stage = ring + (j % NS) * L::STAGE;
    wg::mbar_wait(wg::smem_u32(bars + j % NS), (j / NS) & 1);
    wg::fence_async_smem();
    const int* segq = reinterpret_cast<const int*>(stage + L::SEG_OFF);
    float* lse = reinterpret_cast<float*>(stage + L::LSE_OFF);
    if (tid < BT) lse[tid] = __fmul_rn(lse[tid], LOG2E);   // base 2
    // also: every thread is past tile j - 1, whose stage is refilled next
    const int any = __syncthreads_or(tid < BT && segq[tid] > 0);
    if (j + 1 < total)
      copy_query_tile<D>(a, ring + ((j + 1) % NS) * L::STAGE,
                         wg::smem_u32(bars + (j + 1) % NS), b,
                         hk * a.group + (j + 1) / nq,
                         q_lo + ((j + 1) % nq) * BT, tid);
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

  store_rows<D>(dk_out, dk, a.sm_scale, b, key0, a.Skv, a.Hkv, hk, t);
  store_rows<D>(dv_out, dv, 1.f, b, key0, a.Skv, a.Hkv, hk, t);
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.r % 8 == 0 && s.h % 8 == 0;
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  const int bytes = DqLayout<D>::bytes((a.Skv + BT - 1) / BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int grid = (a.Sq + BT - 1) / BT * a.Hq * a.B;
  flash_bwd_dq_kernel<D><<<grid, NT, bytes, stream>>>(
      a, static_cast<__nv_bfloat16*>(dq));
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
  const int grid = (a.Skv + BT - 1) / BT * a.Hkv * a.B;
  flash_bwd_dkv_kernel<D><<<grid, NT, bytes, stream>>>(
      a, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv));
  return cudaGetLastError();
}

int make_args(Args& a, const void* q, const void* k, const void* v,
              const void* dout, const void* out, const void* lse,
              void* delta, const void* seg_q, const void* seg_kv,
              const void* q_pos, const void* kv_pos, int B, int Sq, int Skv,
              int Hq, int Hkv, const long long* s, float scale2,
              float sm_scale, int causal, int bounded) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a = Args{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           static_cast<const __nv_bfloat16*>(dout),
           static_cast<const __nv_bfloat16*>(out),
           static_cast<const float*>(lse),
           static_cast<float*>(delta),
           static_cast<const int*>(seg_q),
           static_cast<const int*>(seg_kv),
           static_cast<const int*>(q_pos),
           static_cast<const int*>(kv_pos),
           B, Sq, Skv, Hq, Hkv, Hq / Hkv,
           {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
           {s[9], s[10], s[11]}, {s[12], s[13], s[14]},
           scale2, sm_scale, causal, bounded};
  if (!aligned16(q, a.sq) || !aligned16(k, a.sk) || !aligned16(v, a.sv) ||
      !aligned16(dout, a.sdo) || !aligned16(out, a.so))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

}  // namespace

// Both entry points take: q, do, out: bf16 [B, Sq, Hq, D] and k, v: bf16
// [B, Skv, Hkv, D] as views with unit stride inside a head and the
// (batch, row, head) strides in elements given in `strides` (q, k, v, do,
// out: fifteen numbers); every head row starts on a 16-byte boundary. lse:
// the forward's natural log-sum-exp, f32 [B, Hq, Sq] contiguous. delta:
// f32 [B, Hq, Sq] contiguous, written by the dq kernel (no initial value
// needed) and read by the dk / dv kernel, launched after it. seg_q, q_pos:
// int32 [B, Sq]; seg_kv, kv_pos: int32 [B, Skv], contiguous. scale2 =
// sm_scale * log2(e). bounded: positions are the row indices and
// Sq == Skv. Each returns cudaGetLastError() after its launch.

// dq: bf16 [B, Sq, Hq, D] contiguous; also writes delta.
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const void* lse, void* delta, const void* seg_q,
    const void* seg_kv, const void* q_pos, const void* kv_pos, void* dq,
    int B, int Sq, int Skv, int Hq, int Hkv, int D, const long long* strides,
    float scale2, float sm_scale, int causal, int bounded, void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, dout, out, lse, delta, seg_q, seg_kv,
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
    const void* out, const void* lse, void* delta, const void* seg_q,
    const void* seg_kv, const void* q_pos, const void* kv_pos, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    const long long* strides, float scale2, float sm_scale, int causal,
    int bounded, void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, dout, out, lse, delta, seg_q, seg_kv,
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
