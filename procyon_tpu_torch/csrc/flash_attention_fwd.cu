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
// What bounds it on the H100: the operations at the training shape (B2
// S2048 Hq32 Hkv8 D128 causal: 68.8 GFLOP over the allowed pairs, 0.0695
// ms at 989 TFLOP/s, against 0.025 ms for its bytes), the bytes at the
// prefill shapes (B16 S512: 0.048 ms), and in between how fast an SM feeds
// both products from shared memory while it works the online softmax: the
// exponentials alone (one SFU op a score, 16 a clock an SM) take half the
// time of the two products at D 128.
//
// The design. A block of two consumer warpgroups (256 threads; one block an
// SM at D 64 / 128, two at D <= 32) owns 128 query rows of one head at a
// time, 64 a warpgroup, and walks key tiles of 128 (64 at D <= 32)
// through three rings in shared memory: K (2 stages), the keys' segment
// ids and positions (4) and V (3), each stage with a full and an empty
// mbarrier, so a stage is refilled as soon as both warpgroups are done
// with what it holds (the mask outlives its K tile: the softmax reads it
// after S = Q K^T has released K). The first warpgroup copies K and the
// mask, the second V and each its own Q rows, with cp.async, 16 bytes a
// thread, into wgmma's swizzled layout (csrc/wgmma.cuh), one tile ahead of
// the walk; rows beyond Sq / Skv and the padding columns of D 24 are
// zero-filled.
//   A warpgroup keeps its 64 query rows in shared memory (the K-major A
//   operand). Tile j's S = Q K^T (wgmma m64n128k16, f32 in registers) is
//   issued with O += P_{j-1} V_{j-1} (P rounded to bf16 as the register A
//   operand; V MN-major, one product a k-step over all of its columns,
//   across its two 64-column atoms at D 128), and the product of tile
//   j - 1 runs while the softmax of tile j is worked (wgmma.wait_group
//   1). The two warpgroups take turns at issuing (FlashAttention-3's
//   ping-pong; a named barrier each): one issues its products while the
//   other works its softmax.
//   Between the issue of a group and its wait there is no branch and no
//   register a pending product reads is rewritten (ptxas would otherwise
//   serialize every wgmma: C7513 / C7515 / C7520, printed by chip_smoke's
//   build): the mbarrier waits and the choice of the softmax's mask come
//   before the issue, and lane 0's arrivals are predicated.
//   The softmax takes the tile's maximum on the raw products (scale2 > 0
//   keeps their order) and folds the scale into the exponent's FMA,
//   p = ex2.approx.ftz(q.k * scale2 - m); a masked score is -inf there, so
//   a tile a row cannot see adds exactly 0, and a row no key reaches keeps
//   m = -1e30 and l = 0 (dead). A tile whose keys every row of the
//   warpgroup sees (one segment, the rows' own, every key position at most
//   the rows' least) takes no mask; one of the rows' own segment but not
//   wholly below the diagonal, the causal compare alone; any other the
//   segment and causal tests. O is rescaled only when a row's maximum
//   moved.
//   The grid is persistent: as many blocks as the card holds, block i
//   taking the items (query tile, batch, head) i, 2G - 1 - i, 2G + i, ...
//   of G blocks, ordered with the query tiles that walk the most keys
//   under the causal bound first and the heads of a group neighbours (they
//   read the same K / V tiles from L2). The rings and the turns run on
//   across a block's items. Each warpgroup lists an item's tiles for
//   itself, in one round of loads over the keys' segment ids and
//   positions (so no barrier joins the two warpgroups between items): the
//   live tiles below the causal bound, holding a key that is not padding
//   and not wholly after the block's last query position, and for each
//   its common segment and largest position. Key tile 0 is walked first
//   whether live or not, so that its copies and the item's Q rows are in
//   flight while the tiles are listed, and a warpgroup that finishes an
//   item starts the next while the other works its last tile. The output
//   is normalised into the warpgroup's Q tile (free once its last S has
//   completed) and written from there 16 bytes a thread.
// The listing takes 40 bytes a key tile of shared memory, which bounds Skv
// (at D 128 to 708 tiles, 90,624 keys; a longer one fails the launch).
// q, k and v come with (batch, row, head) strides, so the flat
// [B, S, H*D] projections and a [B, Smax, Hkv, D] cache are read in place.
// What holds it back: an item's first and last tiles and its listing and
// store leave the tensor cores idle for part of each item (about 5 us an
// item against 2 us a tile pair, chip_smoke.py --only=flash_fit), and
// registers (254 a thread at D 128) allow no third warpgroup or second
// block an SM. A producer warpgroup or warp that issued the copies (ptxas
// then kept 168 registers despite setmaxnreg), tile copies through TMA,
// and issuing the next item's first copies and listing loads before the
// store all measured slower. Times, registers and the earlier versions of
// this kernel (SIMT, then mma.sync): PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 128;   // query rows a block: two warpgroups of 64
constexpr int NC = 256;   // consumer threads
constexpr int KS = 2;     // stages of the K ring
constexpr int MS = 4;     // stages of the mask ring
constexpr int VS = 3;     // stages of the V ring
constexpr float MASK = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, r, h;  // batch, row, head; elements
};

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const int *seg_q, *seg_kv, *q_pos, *kv_pos;
  __nv_bfloat16* out;
  float* lse;
  int B, Sq, Skv, Hq, group;
  Strides sq, sk, sv;
  float scale2;
  int causal, bounded;
};

// per-tile summary of the keys: any key not padding, the common segment id
// (0 if the tile holds padding or two segments), the largest position, the
// least position of a key that is not padding
struct TileInfo {
  int live, seg, pmax, pmin;
};

template <int D>
struct Cfg {
  static constexpr int DP = D == 24 ? 32 : D;   // wgmma's k is 16
  static constexpr int BK = DP >= 64 ? 128 : 64;
  static constexpr int MIN_BLOCKS = DP >= 64 ? 1 : 2;
  using TQ = wg::Tile<DP, 64>;
  using TK = wg::Tile<DP, BK>;
  static constexpr int Q_OFF = 0;   // the two warpgroups' [64][DP] tiles
  static constexpr int K_OFF = 2 * TQ::BYTES;
  static constexpr int V_OFF = K_OFF + KS * TK::BYTES;
  static constexpr int M_OFF = V_OFF + VS * TK::BYTES;
  static constexpr int M_STAGE = 8 * BK;   // segment ids, then positions
  static constexpr int BAR_OFF = M_OFF + MS * M_STAGE;
  // qfull[2], then the full and empty barriers of the K, mask and V rings
  static constexpr int NBAR = 2 + 2 * (KS + MS + VS);
  // then each warpgroup's listing of its current item: per warp of it
  // (segment min, max, least position, largest position of a live row),
  // the block's 128 rows' segment ids and positions, the live tiles'
  // count, a TileInfo per key tile, the live tiles' indices
  static constexpr int LIST_OFF = BAR_OFF + 8 * NBAR;
  static constexpr int R_SEG = 64, R_POS = R_SEG + 4 * BQ;
  static constexpr int R_N = R_POS + 4 * BQ, R_INFO = R_N + 16;
  __host__ __device__ static int region(int n_tiles) {
    return (R_INFO + 20 * n_tiles + 15) / 16 * 16;
  }
  static int bytes(int n_tiles) {
    return 1024 + LIST_OFF + 2 * region(n_tiles);
  }
};

// one arrival on an mbarrier from lane 0 of the warp, predicated (no
// branch: it may sit between the issue of a wgmma group and its wait)
__device__ __forceinline__ void lane0_arrive(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}
// the full barriers of a ring of n stages count the 128 copying threads,
// the empty ones lane 0 of the 8 consumer warps
__device__ __forceinline__ void init_ring(uint64_t* ring, int n) {
  for (int i = 0; i < n; ++i) {
    wg::mbar_init(wg::smem_u32(ring + i), 128);
    wg::mbar_init(wg::smem_u32(ring + n + i), 8);
  }
}
// the ring stage of tile j is free once both warpgroups released the tile
// it held NSTAGES tiles earlier
__device__ __forceinline__ void wait_empty(const uint64_t* empty, int j,
                                           int nstages) {
  if (j >= nstages)
    wg::mbar_wait(wg::smem_u32(empty + j % nstages),
                  ((j / nstages) & 1) ^ 1);
}
__device__ __forceinline__ void wait_full(const uint64_t* full, int j,
                                          int nstages) {
  wg::mbar_wait(wg::smem_u32(full + j % nstages), (j / nstages) & 1);
}

// rows [row0, row0 + ROWS) of a [n_rows, D] bf16 matrix with row stride rs
// into a swizzled [ROWS][DP] tile by 128 threads; rows beyond n_rows and
// the padding columns of D 24 are zero-filled. A thread copies one chunk
// column c, of rows r0, r0 + RS, ...: the swizzle of (r, c) depends on
// r % 8 only, so their offsets step by RS rows
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int row0, int n_rows,
                                          int ct) {
  using T = wg::Tile<Cfg<D>::DP, ROWS>;
  constexpr int RS = 128 / T::CHUNKS;
  static_assert(128 % T::CHUNKS == 0 && RS % 8 == 0 && ROWS % RS == 0,
                "copy rows");
  const int c = ct % T::CHUNKS, r0 = ct / T::CHUNKS;
  const bool col = c < D / 8;
  dst += T::offset(r0, c);
  const __nv_bfloat16* p = src + (long long)(row0 + r0) * rs + c * 8;
#pragma unroll
  for (int u = 0; u < ROWS / RS; ++u) {
    const bool in = col && row0 + r0 + u * RS < n_rows;
    wg::cp16(dst + u * RS * T::RB, in ? p : src, in);
    p += (long long)RS * rs;
  }
}

// the copies of one ring stage by a warpgroup's 128 threads (ct: 0..127),
// then their arrival on the stage's full barrier
template <int D>
__device__ __forceinline__ void copy_k(const Args& a, unsigned char* smem,
                                       const uint64_t* bars, int b, int hk,
                                       int j, int k0, int ct) {
  using C = Cfg<D>;
  const uint64_t* kfull = bars + 2;
  wait_empty(kfull + KS, j, KS);
  copy_rows<D, C::BK>(
      wg::smem_u32(smem + C::K_OFF + (j % KS) * C::TK::BYTES),
      a.k + (long long)b * a.sk.b + (long long)hk * a.sk.h, a.sk.r, k0,
      a.Skv, ct);
  wg::cp_arrive(wg::smem_u32(kfull + j % KS));
}
template <int D>
__device__ __forceinline__ void copy_v(const Args& a, unsigned char* smem,
                                       const uint64_t* bars, int b, int hk,
                                       int j, int k0, int ct) {
  using C = Cfg<D>;
  const uint64_t* vfull = bars + 2 + 2 * KS + 2 * MS;
  wait_empty(vfull + VS, j, VS);
  copy_rows<D, C::BK>(
      wg::smem_u32(smem + C::V_OFF + (j % VS) * C::TK::BYTES),
      a.v + (long long)b * a.sv.b + (long long)hk * a.sv.h, a.sv.r, k0,
      a.Skv, ct);
  wg::cp_arrive(wg::smem_u32(vfull + j % VS));
}
template <int D>
__device__ __forceinline__ void copy_q(const Args& a, unsigned char* smem,
                                       const uint64_t* bars, int b, int h,
                                       int q0, int w, int ct) {
  using C = Cfg<D>;
  copy_rows<D, 64>(wg::smem_u32(smem + C::Q_OFF + w * C::TQ::BYTES),
                   a.q + (long long)b * a.sq.b + (long long)h * a.sq.h,
                   a.sq.r, q0 + 64 * w, a.Sq, ct);
  wg::cp_arrive(wg::smem_u32(bars + w));
}
// the keys' segment ids and positions by the warpgroup's 128 threads
template <int D>
__device__ __forceinline__ void copy_mask(const Args& a, unsigned char* smem,
                                          const uint64_t* bars, int b, int j,
                                          int k0, int ct) {
  using C = Cfg<D>;
  const uint64_t* mfull = bars + 2 + 2 * KS;
  wait_empty(mfull + MS, j, MS);
  const uint32_t dst = wg::smem_u32(smem + C::M_OFF + (j % MS) * C::M_STAGE);
  const long long row = (long long)b * a.Skv;
  for (int i = ct; i < 2 * C::BK; i += 128) {
    const int s = k0 + i % C::BK;
    const bool in = s < a.Skv;
    wg::cp4(dst + 4 * i,
            (i < C::BK ? a.seg_kv : a.kv_pos) + row + (in ? s : 0), in);
  }
  wg::cp_arrive(wg::smem_u32(mfull + j % MS));
}

// 2^x by the SFU, subnormal results flushed to 0 (a probability under
// 2^-126 of the row's largest adds nothing to a sum that is at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the online softmax of one tile in place: sc[4 c + e] is row g + 8 (e >> 1)
// against key 8 c + 2 t + (e & 1) of the tile, on entry the product q . k,
// on exit p = exp2(q . k * scale2 - m) (f32; 0 where masked); m, l
// updated, alpha the factor on O. The tile's largest score is taken on
// the products (scale2 > 0 keeps their order, and rounding is monotone),
// so the scale folds into the exponent's FMA; a row the tile masks whole
// has the tile maximum -1e30
// which mask a tile takes for a warpgroup
enum Mask { FREE, CAUSAL, FULL };

template <int BK, Mask MASK_MODE>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const int* segk, const int* kpos,
                                        const int (&segq)[2],
                                        const int (&qp)[2], int causal,
                                        float scale2, int t) {
  float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
    int2 sk = make_int2(0, 0), kp = make_int2(0, 0);
    if (MASK_MODE == FULL)
      sk = *reinterpret_cast<const int2*>(segk + 8 * c + 2 * t);
    if (MASK_MODE != FREE)
      kp = *reinterpret_cast<const int2*>(kpos + 8 * c + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int kpe = (e & 1) ? kp.y : kp.x;
      if (MASK_MODE == FULL) {
        // keys beyond Skv carry segment 0 and fail the first test
        const bool ok = segq[r] > 0 && ((e & 1) ? sk.y : sk.x) == segq[r] &&
                        (!causal || qp[r] >= kpe);
        sc[4 * c + e] = ok ? sc[4 * c + e] : -INFINITY;
      } else if (MASK_MODE == CAUSAL) {
        sc[4 * c + e] = qp[r] >= kpe ? sc[4 * c + e] : -INFINITY;
      }
      rmax[r] = fmaxf(rmax[r], sc[4 * c + e]);
    }
  }
  float nm[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
    rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
    const float tmax = rmax[r] == -INFINITY ? MASK : rmax[r] * scale2;
    const float mnew = fmaxf(m[r], tmax);
    alpha[r] = ex2(m[r] - mnew);
    m[r] = mnew;
    nm[r] = -mnew;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = ex2(fmaf(sc[i], scale2, nm[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += p;
    sc[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * alpha[r] + rs[r];
  }
}

// one consumer warpgroup's state and the steps of its walk
template <int D>
struct Consumer {
  using C = Cfg<D>;
  static constexpr int BK = C::BK, DP = C::DP;
  static constexpr int QS = C::DP / 16;   // k-steps of S = Q K^T
  static constexpr int PS = BK / 16;      // k-steps of O += P V
  int causal;
  float scale2;
  unsigned char* smem;
  const uint64_t* bars;
  const int* list;
  const TileInfo* info;
  int w, lane, t;
  int jbase;         // ring slot of the current item's first tile
  int segq[2], qp[2];
  int wseg, wqmin;   // the warpgroup's rows: common segment, least position
  float m[2], l[2], alpha[2];
  float o[DP / 2];   // as S: row g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
  float sc[BK / 2];
  uint32_t pf[PS][4];

  __device__ __forceinline__ const uint64_t* kfull() const { return bars + 2; }
  __device__ __forceinline__ const uint64_t* mfull() const {
    return bars + 2 + 2 * KS;
  }
  __device__ __forceinline__ const uint64_t* vfull() const {
    return bars + 2 + 2 * KS + 2 * MS;
  }
  // FREE: every row sees every key of tile j (one segment, the rows' own,
  // and under the causal mask every key position at most the rows' least);
  // CAUSAL: one segment, the rows' own, and the causal compare alone
  __device__ __forceinline__ Mask mask_mode(int j) const {
    const TileInfo ti = info[list[j]];
    if (wseg == 0 || ti.seg != wseg) return FULL;
    return !causal || wqmin >= ti.pmax ? FREE : CAUSAL;
  }
  // the turn at the tensor cores: named barrier 3 + w, which this
  // warpgroup's 128 threads sync on and the other's 128 arrive at
  __device__ __forceinline__ void take_turn() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(3 + w) : "memory");
  }
  __device__ __forceinline__ void pass_turn() const {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - w) : "memory");
  }

  // jr: a tile's ring slot, counted over the block's items
  __device__ __forceinline__ void issue_s(int jr) {
    const uint32_t qbase = wg::smem_u32(smem + C::Q_OFF + w * C::TQ::BYTES);
    const uint32_t kbase =
        wg::smem_u32(smem + C::K_OFF + (jr % KS) * C::TK::BYTES);
#pragma unroll
    for (int kk = 0; kk < QS; ++kk) {
      if constexpr (BK == 128)
        wg::ss128(sc, C::TQ::kmajor(qbase, kk), C::TK::kmajor(kbase, kk),
                  kk > 0);
      else
        wg::ss64(sc, C::TQ::kmajor(qbase, kk), C::TK::kmajor(kbase, kk),
                 kk > 0);
    }
    wg::commit();
  }
  __device__ __forceinline__ void issue_pv(int jr) {
    const uint32_t vbase =
        wg::smem_u32(smem + C::V_OFF + (jr % VS) * C::TK::BYTES);
    // one product a k-step over all DP columns of V (at D 128 two atoms)
#pragma unroll
    for (int kk = 0; kk < PS; ++kk)
      wg::rs<DP>(o, pf[kk], C::TK::mnmajor(vbase, kk, 0));
    wg::commit();
  }
  __device__ __forceinline__ void hold_all() {
    wg::hold(sc);
    wg::hold(pf);
    wg::hold(o);
  }

  // tile j: S_j (and O += P_{j-1} V_{j-1} after the first tile) issued in
  // this warpgroup's turn, the softmax of S_j while P V runs, then O
  // rescaled and P_j formed
  template <Mask MASK_MODE, bool FIRST>
  __device__ __forceinline__ void step(int j) {
    const int jr = jbase + j;
    wait_full(kfull(), jr, KS);
    wait_full(mfull(), jr, MS);
    if (!FIRST) wait_full(vfull(), jr - 1, VS);
    wg::fence_async_smem();
    hold_all();
    take_turn();
    wg::fence();
    issue_s(jr);
    if (!FIRST) issue_pv(jr - 1);
    pass_turn();
    if (FIRST)
      wg::wait_all();
    else
      wg::wait_one();   // S_j; P_{j-1} V_{j-1} may still read pf, o
    wg::hold(sc);
    lane0_arrive(wg::smem_u32(kfull() + KS + jr % KS), lane);   // K_j free
    const unsigned char* ms = smem + C::M_OFF + (jr % MS) * C::M_STAGE;
    softmax<BK, MASK_MODE>(sc, m, l, alpha, reinterpret_cast<const int*>(ms),
                        reinterpret_cast<const int*>(ms + 4 * BK), segq, qp,
                        causal, scale2, t);
    __syncwarp();
    lane0_arrive(wg::smem_u32(mfull() + MS + jr % MS), lane);   // mask free
    wg::wait_all();
    hold_all();
    if (!FIRST)
      lane0_arrive(wg::smem_u32(vfull() + VS + (jr - 1) % VS), lane);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {   // a row's maximum moved
#pragma unroll
      for (int jj = 0; jj < DP / 2; ++jj) o[jj] *= alpha[(jj >> 1) & 1];
    }
    wg::to_a(pf, sc);
  }

  // the last tile's P V
  __device__ __forceinline__ void finish(int n) {
    const int jr = jbase + n - 1;
    wait_full(vfull(), jr, VS);
    wg::fence_async_smem();
    hold_all();
    take_turn();
    wg::fence();
    issue_pv(jr);
    pass_turn();
    wg::wait_all();
    hold_all();
    lane0_arrive(wg::smem_u32(vfull() + VS + jr % VS), lane);
  }
};

// each warpgroup lists an item's key tiles for itself (no block-wide
// barrier between items): both see the same data and make the same list
template <int D>
__device__ __forceinline__ int list_tiles(const Args& a, unsigned char* reg,
                                          int max_tiles, int b, int q0,
                                          int n_tiles, int w, int ct) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  int* sum = reinterpret_cast<int*>(reg);
  int* rseg = reinterpret_cast<int*>(reg + C::R_SEG);
  int* rpos = reinterpret_cast<int*>(reg + C::R_POS);
  int* n_live = reinterpret_cast<int*>(reg + C::R_N);
  TileInfo* info = reinterpret_cast<TileInfo*>(reg + C::R_INFO);
  int* list = reinterpret_cast<int*>(info + max_tiles);
  const int lane = ct & 31, wwarp = ct >> 5;
  // one round of loads: a row of the block a thread, and the key tiles
  // below the causal bound, one a warp at a time (two a warp in flight)
  int rsg = 0, rps = 0;
  if (q0 + ct < a.Sq) {
    rsg = a.seg_q[(long long)b * a.Sq + q0 + ct];
    rps = a.q_pos[(long long)b * a.Sq + q0 + ct];
  }
  const int* segk = a.seg_kv + (long long)b * a.Skv;
  const int* posk = a.kv_pos + (long long)b * a.Skv;
  for (int i0 = wwarp; i0 < n_tiles; i0 += 8) {
    int sg[2][BK / 32], ps[2][BK / 32];
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int s = (i0 + 4 * v) * BK + 32 * u + lane;
        sg[v][u] = s < a.Skv ? segk[s] : 0;
        ps[v][u] = s < a.Skv ? posk[s] : 0;
      }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      int smin = INT_MAX, smax = INT_MIN, pmax = INT_MIN, pmin = INT_MAX;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        smin = min(smin, sg[v][u]);
        smax = max(smax, sg[v][u]);
        pmax = max(pmax, ps[v][u]);
        if (sg[v][u] > 0) pmin = min(pmin, ps[v][u]);
      }
      smin = __reduce_min_sync(0xffffffffu, smin);
      smax = __reduce_max_sync(0xffffffffu, smax);
      pmax = __reduce_max_sync(0xffffffffu, pmax);
      pmin = __reduce_min_sync(0xffffffffu, pmin);
      if (lane == 0 && i0 + 4 * v < n_tiles)
        info[i0 + 4 * v] = TileInfo{
            smax > 0, (smin == smax && smin > 0) ? smin : 0, pmax, pmin};
    }
  }
  {
    const int smin = __reduce_min_sync(0xffffffffu, rsg);
    const int smax = __reduce_max_sync(0xffffffffu, rsg);
    const int pmin = __reduce_min_sync(0xffffffffu, rps);
    const int plive = __reduce_max_sync(0xffffffffu, rsg > 0 ? rps : INT_MIN);
    if (lane == 0) {
      sum[4 * wwarp] = smin;
      sum[4 * wwarp + 1] = smax;
      sum[4 * wwarp + 2] = pmin;
      sum[4 * wwarp + 3] = plive;
    }
    rseg[ct] = rsg;
    rpos[ct] = rps;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if (wwarp == 0) {
    // the walk: key tile 0 first, whether it is live or not (its copies
    // are issued before the listing, and a tile of padding is masked whole
    // and changes nothing), then, if a row of the block is live, the live
    // tiles: a key that is not padding, and under the causal mask a key
    // position some live row reaches
    int qmax = INT_MIN, live_rows = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qmax = max(qmax, sum[4 * i + 3]);
      live_rows |= sum[4 * i + 1] > 0;
    }
    int n = 0;
    for (int i0 = 0; i0 < n_tiles; i0 += 32) {
      const int i = i0 + lane;
      bool on = false;
      if (i < n_tiles) {
        const TileInfo ti = info[i];
        on = i == 0 || (live_rows && ti.live &&
                        (!a.causal || ti.pmin <= qmax));
      }
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      if (on) list[n + __popc(mask & ((1u << lane) - 1))] = i;
      n += __popc(mask);
    }
    if (lane == 0) *n_live = n;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  return *n_live;
}

template <int D>
__global__ void __launch_bounds__(NC, Cfg<D>::MIN_BLOCKS)
    flash_fwd_kernel(const Args a) {
  using C = Cfg<D>;
  using TQ = typename C::TQ;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);

  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, warp-uniform for the compiler (broadcast from lane 0)
  const int w = __shfl_sync(0xffffffffu, tid / 128, 0), ct = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int lr = 64 * w + 16 * ((tid >> 5) & 3) + g;   // rows lr, lr + 8
  const int max_tiles = (a.Skv + BK - 1) / BK;
  unsigned char* reg = smem + C::LIST_OFF + w * C::region(max_tiles);
  const int* rseg = reinterpret_cast<const int*>(reg + C::R_SEG);
  const int* rpos = reinterpret_cast<const int*>(reg + C::R_POS);
  const TileInfo* info = reinterpret_cast<const TileInfo*>(reg + C::R_INFO);
  const int* list = reinterpret_cast<const int*>(info + max_tiles);

  if (tid == 0) {
    wg::mbar_init(wg::smem_u32(bars), 128);
    wg::mbar_init(wg::smem_u32(bars + 1), 128);
    init_ring(bars + 2, KS);
    init_ring(bars + 2 + 2 * KS, MS);
    init_ring(bars + 2 + 2 * (KS + MS), VS);
    wg::mbar_fence_init();
  }
  __syncthreads();

  Consumer<D> cs{a.causal, a.scale2, smem, bars, list, info, w, lane, t, 0};
  if (w == 1) cs.pass_turn();   // the first warpgroup takes the first turn
  // the items (query tile, batch, head), the query tile slowest and the
  // last first (under the causal bound it walks the most key tiles), the
  // heads of a group neighbours (they read the same K / V tiles from L2);
  // with G blocks, block i takes items i, 2G - 1 - i, 2G + i, 4G - 1 - i,
  // ...: a heavy and a light item in each pair of rounds
  const int nqt = (a.Sq + BQ - 1) / BQ;
  const int n_items = nqt * a.Hq * a.B;
  const int G = gridDim.x, i = blockIdx.x;
  int done = 0;   // items this block has walked
  for (int k = 0; k * G < n_items; ++k) {
    const int item = k * G + ((k & 1) ? G - 1 - i : i);
    if (item >= n_items) continue;
    const int h = item % a.Hq;
    const int b = (item / a.Hq) % a.B;
    const int q0 = (nqt - 1 - item / (a.Hq * a.B)) * BQ;
    const int hk = h / a.group;
    const int kv_hi = (a.causal && a.bounded) ? min(a.Skv, q0 + BQ) : a.Skv;
    const int n_tiles = (kv_hi + BK - 1) / BK;
    const int jb = cs.jbase;
    // the query rows and the first key tile are in flight while the
    // warpgroup lists the item's tiles: each warpgroup copies its own Q
    // rows, the first K and the mask, the second V
    copy_q<D>(a, smem, bars, b, h, q0, w, ct);
    if (w == 0) {
      copy_k<D>(a, smem, bars, b, hk, jb, 0, ct);
      copy_mask<D>(a, smem, bars, b, jb, 0, ct);
    } else {
      copy_v<D>(a, smem, bars, b, hk, jb, 0, ct);
    }
    const int n = list_tiles<D>(a, reg, max_tiles, b, q0, n_tiles, w, ct);
    if (n > 1) {   // the second tile, a tile ahead of the walk
      const int k0 = list[1] * BK;
      if (w == 0) {
        copy_k<D>(a, smem, bars, b, hk, jb + 1, k0, ct);
        copy_mask<D>(a, smem, bars, b, jb + 1, k0, ct);
      } else {
        copy_v<D>(a, smem, bars, b, hk, jb + 1, k0, ct);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cs.segq[r] = rseg[lr + 8 * r];   // 0 beyond Sq
      cs.qp[r] = rpos[lr + 8 * r];
      cs.m[r] = -INFINITY;
      cs.l[r] = 0.f;
    }
    {
      const int* r0 = reinterpret_cast<const int*>(reg) + 8 * w;
      const bool one = r0[0] == r0[1] && r0[4] == r0[5] && r0[0] == r0[4];
      cs.wseg = one && r0[0] > 0 ? r0[0] : 0;
      cs.wqmin = min(r0[2], r0[6]);
    }
#pragma unroll
    for (int jj = 0; jj < C::DP / 2; ++jj) cs.o[jj] = 0.f;

    wg::mbar_wait(wg::smem_u32(bars + w), done & 1);   // Q
    switch (cs.mask_mode(0)) {
      case FREE: cs.template step<FREE, true>(0); break;
      case CAUSAL: cs.template step<CAUSAL, true>(0); break;
      default: cs.template step<FULL, true>(0);
    }
    for (int j = 1; j < n; ++j) {
      if (j + 1 < n) {
        const int k0 = list[j + 1] * BK;
        if (w == 0) {
          copy_k<D>(a, smem, bars, b, hk, jb + j + 1, k0, ct);
          copy_mask<D>(a, smem, bars, b, jb + j + 1, k0, ct);
        } else {
          copy_v<D>(a, smem, bars, b, hk, jb + j + 1, k0, ct);
        }
      }
      switch (cs.mask_mode(j)) {
        case FREE: cs.template step<FREE, false>(j); break;
        case CAUSAL: cs.template step<CAUSAL, false>(j); break;
        default: cs.template step<FULL, false>(j);
      }
    }
    cs.finish(n);
    cs.jbase += n;
    ++done;

    // out, normalised and rounded to bf16, into this warpgroup's Q tile (no
    // longer read: its last S has completed), then from there 16 bytes a
    // thread into the rows of out; lse of the thread's two rows
    unsigned char* stage = smem + C::Q_OFF + w * TQ::BYTES;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lr - 64 * w + 8 * r, s = q0 + lr + 8 * r;
      const bool dead = (cs.m[r] <= MASK * 0.5f) || (cs.l[r] == 0.f);
      const float inv = dead ? 0.f : 1.f / cs.l[r];
#pragma unroll
      for (int c = 0; c < C::DP / 8; ++c)
        *reinterpret_cast<uint32_t*>(stage + TQ::offset(row, c) + 4 * t) =
            wg::pack_bf16(cs.o[4 * c + 2 * r] * inv,
                          cs.o[4 * c + 2 * r + 1] * inv);
      if (a.lse != nullptr && t == 0 && s < a.Sq)
        a.lse[((long long)b * a.Hq + h) * a.Sq + s] =
            dead ? MASK : cs.m[r] * LN2 + logf(cs.l[r]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
    for (int i = ct; i < 64 * (D / 8); i += 128) {
      const int row = i / (D / 8), c = i % (D / 8), s = q0 + 64 * w + row;
      if (s < a.Sq)
        *reinterpret_cast<uint4*>(
            a.out + (((long long)b * a.Sq + s) * a.Hq + h) * D + 8 * c) =
            *reinterpret_cast<const uint4*>(stage + TQ::offset(row, c));
    }
    // the Q tile is read out before the next item's rows are copied in
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<D>;
  const int bytes = C::bytes((a.Skv + C::BK - 1) / C::BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  // a persistent grid: as many blocks as the card holds at once, each
  // walking its share of the items
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int items = (a.Sq + BQ - 1) / BQ * a.Hq * a.B;
  const int grid = min(items, sms * C::MIN_BLOCKS);
  flash_fwd_kernel<D><<<grid, NC, bytes, stream>>>(a);
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
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const int*>(seg_q),
               static_cast<const int*>(seg_kv),
               static_cast<const int*>(q_pos),
               static_cast<const int*>(kv_pos),
               static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(lse),
               B, Sq, Skv, Hq, Hq / Hkv,
               {q_bs, q_rs, q_hs}, {k_bs, k_rs, k_hs}, {v_bs, v_rs, v_hs},
               scale2, causal, bounded};
  if (!aligned16(q, a.sq) || !aligned16(k, a.sk) || !aligned16(v, a.sv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, st);
    case 24: return launch<24>(a, st);
    case 32: return launch<32>(a, st);
    case 64: return launch<64>(a, st);
    case 128: return launch<128>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
