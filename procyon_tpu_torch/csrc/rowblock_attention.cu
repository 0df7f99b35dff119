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
// What bounds it on the H100: at ESM2-650M serving shapes (S 512, D 64)
// the two products are 4 S D flops per (query, key) pair against 6 D bytes
// read per key row, so the least time is set by the bytes (0.0996 ms at
// B64 S512 H20) with the operations close behind (0.087 ms at 989
// TFLOP/s): only the tensor cores keep it near either (the SIMT cores'
// f32 FMAs top out near 67 TFLOP/s). Measured times: PERF.md section 6.
//
// The design. One block per (128 query rows, head, batch), two an SM at
// D 64: two consumer warpgroups of 64 rows, 256 threads, each of which
// also issues a share of the copies (no producer warp: the tile copies are
// cp.async, 16 bytes a thread, the K and V rows of the packed
// [B, S, 3*H*D] projection read in place through its row stride). Key tiles of 64 go through a two-stage
// ring in shared memory in wgmma's swizzled layout (csrc/wgmma.cuh); each
// thread's copies arrive on the stage's mbarrier (cp.async.mbarrier.arrive),
// so tile j + 1 is in flight while tile j is multiplied. The k-side rotary
// tables and the 64 segment ids come in the same stage.
//   Q is rotated once, in registers, read in the m64k16 register-fragment
//   pattern, in which a thread holds columns c and c + D/2 of the same rows
//   (for D >= 32 the same slot one D/32 k-step away, for D = 16 the
//   neighbouring slot), so rotate-half needs no exchange; the rotated rows
//   go to a swizzled tile per warpgroup, read by wgmma from shared memory
//   (kept in registers they cost 16 of them at D 64, enough to spill at the
//   128 a thread that two blocks an SM allow).
//   Each K tile is rotated once per 128-row block, in place in shared
//   memory, chunk pairs (c, c + D/2) through the swizzle, then fenced for
//   the async proxy. S = Q K^T is wgmma m64n64k16 with Q and K as K-major
//   operands in shared memory; the online softmax (base 2, -1e30 masks) stays in registers;
//   P is rounded to bf16 in registers and is the A operand of O += P V,
//   with V read MN-major (tnsp) from the same tile layout, one product per
//   64-column atom. The output is normalised, staged in shared memory and
//   written with 16-byte stores.
// What still holds it back: each warpgroup waits for each product group
// before its next step, and the block's 256 threads meet at a barrier
// every key tile (the in-place rotation needs it), so the tensor cores
// idle during the softmax unless the SM's other block fills them; and each
// 128-row block copies and rotates every K tile again, with its two rotary
// tables (four times a head at S 512). A producer warpgroup that copies and
// rotates for two consumer warpgroups that never meet (and issue the next
// tile's S before this tile's softmax) leaves registers for one block an
// SM, two consumer warpgroups where this design has four, and measured
// slower (PERF.md section 6).
// Key tiles that hold only padding (segment 0) are never loaded: the block
// lists the live tiles of its row first. Keys and query rows beyond S are
// zero-filled by the copies and fail the segment test, so S needs no
// padding and a ragged last tile (S 1026: two keys) is masked by index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BK = 64;    // keys a tile
constexpr int NS = 2;     // stages of the key-tile ring
constexpr float MASK = -1e30f;

// rotate-half of two bf16 pairs: x * c + xp * s, each product and the sum
// rounded to bf16 (bf16x2 instructions, round to nearest even: the same
// numbers as the reference's bf16 arithmetic, which rounds an exact f32
// product or sum once)
__device__ __forceinline__ uint32_t rope2(uint32_t x, uint32_t xp, uint32_t c,
                                          uint32_t s) {
  uint32_t a, b, r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(a) : "r"(x), "r"(c));
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(b) : "r"(xp), "r"(s));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

template <int D, bool ROPE>
struct Layout {
  using T = wg::Tile<D, BK>;
  // query rows a block, 64 a warpgroup
  static constexpr int BQ = 128;
  static constexpr int NT = 2 * BQ;
  // at D 64 (ESM2) two blocks share an SM, so that one block's softmax
  // overlaps the other's products (121 registers a thread)
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
  // a stage: K, V (swizzled), cos, sin (plain [BK][D]), segment ids
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = T::BYTES;
  static constexpr int COS_OFF = 2 * T::BYTES;
  static constexpr int SIN_OFF = 3 * T::BYTES;
  static constexpr int SEG_OFF = (ROPE ? 4 : 2) * T::BYTES;
  static constexpr int STAGE = (SEG_OFF + BK * 4 + 1023) / 1024 * 1024;
  static constexpr int OUT_LD = D + 8;   // staged output row, elements
  // the output is staged over the ring once the last tile is consumed
  static_assert(BQ * OUT_LD * 2 <= NS * STAGE, "output staging");
  // each warpgroup's 64 rotated query rows, as the A operand of S = Q K^T
  static constexpr int Q_OFF = NS * STAGE;
  static constexpr int BAR_OFF = Q_OFF + (BQ / 64) * T::BYTES;
  static constexpr int LIST_OFF = BAR_OFF + 8 * NS + 8;  // count, then list
  static int bytes(int n_tiles) { return 1024 + LIST_OFF + 4 * n_tiles; }
};

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const int* seg;
  const __nv_bfloat16 *cq, *sq, *ck, *sk;
  __nv_bfloat16* out;
  int S, H;
  long long row_stride, batch_stride;
  float score_scale;
};

// issue the copies of key tile kt into stage `st` and arrive on its barrier
template <int D, bool ROPE>
__device__ __forceinline__ void load_tile(const Args& a, unsigned char* st,
                                          uint32_t bar, int kt, int b, int h,
                                          int tid) {
  using L = Layout<D, ROPE>;
  using T = typename L::T;
  const int k0 = kt * BK;
  const long long head = (long long)b * a.batch_stride + (long long)h * D;
  const long long HD = (long long)a.H * D;
  const uint32_t base = wg::smem_u32(st);
  for (int i = tid; i < BK * T::CHUNKS; i += L::NT) {
    const int r = i / T::CHUNKS, c = i % T::CHUNKS;
    const int s = k0 + r;
    const bool in = s < a.S;
    const long long src = head + (long long)(in ? s : 0) * a.row_stride + c * 8;
    wg::cp16(base + L::K_OFF + T::offset(r, c), a.k + src, in);
    wg::cp16(base + L::V_OFF + T::offset(r, c), a.v + src, in);
    if (ROPE) {
      const long long t = (long long)(in ? s : 0) * HD + (long long)h * D + c * 8;
      const uint32_t plain = (r * D + c * 8) * 2;
      wg::cp16(base + L::COS_OFF + plain, a.ck + t, in);
      wg::cp16(base + L::SIN_OFF + plain, a.sk + t, in);
    }
  }
  if (tid < BK) {
    const int s = k0 + tid;
    const bool in = s < a.S;
    wg::cp4(base + L::SEG_OFF + tid * 4, a.seg + (long long)b * a.S + (in ? s : 0),
            in);
  }
  wg::cp_arrive(bar);
}

// the staged K tile rotated in place: chunk pairs (c, c + D/2) of each key
template <int D, int NT>
__device__ __forceinline__ void rotate_tile(unsigned char* kt,
                                            const unsigned char* cosb,
                                            const unsigned char* sinb,
                                            int tid) {
  using T = wg::Tile<D, BK>;
  constexpr int HALF = T::CHUNKS / 2;
  for (int i = tid; i < BK * HALF; i += NT) {
    const int r = i / HALF, c = i % HALF;
    uint4* p1 = reinterpret_cast<uint4*>(kt + T::offset(r, c));
    uint4* p2 = reinterpret_cast<uint4*>(kt + T::offset(r, c + HALF));
    const uint4 x1 = *p1, x2 = *p2;
    const uint4 c1 = *reinterpret_cast<const uint4*>(cosb + (r * D + c * 8) * 2);
    const uint4 c2 =
        *reinterpret_cast<const uint4*>(cosb + (r * D + (c + HALF) * 8) * 2);
    const uint4 s1 = *reinterpret_cast<const uint4*>(sinb + (r * D + c * 8) * 2);
    const uint4 s2 =
        *reinterpret_cast<const uint4*>(sinb + (r * D + (c + HALF) * 8) * 2);
    *p1 = make_uint4(rope2(x1.x, x2.x, c1.x, s1.x), rope2(x1.y, x2.y, c1.y, s1.y),
                     rope2(x1.z, x2.z, c1.z, s1.z), rope2(x1.w, x2.w, c1.w, s1.w));
    *p2 = make_uint4(rope2(x2.x, x1.x, c2.x, s2.x), rope2(x2.y, x1.y, c2.y, s2.y),
                     rope2(x2.z, x1.z, c2.z, s2.z), rope2(x2.w, x1.w, c2.w, s2.w));
  }
}

template <int D, bool ROPE>
__global__ void __launch_bounds__(Layout<D, ROPE>::NT,
                                  Layout<D, ROPE>::MIN_BLOCKS)
    rowblock_attention_kernel(Args a) {
  using L = Layout<D, ROPE>;
  using T = typename L::T;
  constexpr int BQ = L::BQ, NT = L::NT;
  constexpr int KS = D / 16;          // k-steps of S = Q K^T
  constexpr int NA = T::NATOM, A = T::A;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  int* n_live = reinterpret_cast<int*>(smem + L::LIST_OFF - 8);
  int* list = reinterpret_cast<int*>(smem + L::LIST_OFF);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const int n_tiles = (S + BK - 1) / BK;
  const int* segb = a.seg + (long long)b * S;
  // this thread's two query rows
  const int row0 = q0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
  int segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    segq[r] = s < S ? segb[s] : 0;
  }

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) wg::mbar_init(wg::smem_u32(bars + i), NT);
    wg::mbar_fence_init();
  }
  for (int i = tid; i < n_tiles; i += NT) list[i] = 0;
  __syncthreads();
  for (int i = tid; i < S; i += NT)
    if (segb[i] > 0) list[i / BK] = 1;
  const int live_rows = __syncthreads_or(segq[0] > 0 || segq[1] > 0);
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (list[i]) list[n++] = i;
    *n_live = n;
  }
  __syncthreads();
  const int n = live_rows ? *n_live : 0;
  const long long HD = (long long)a.H * D;

  if (n > 0) load_tile<D, ROPE>(a, smem, wg::smem_u32(bars), list[0], b, h,
                                tid);

  // Q rotated once into this warpgroup's tile: the thread reads the
  // columns 8 u + 2 t, + 1 of its rows row0 and row0 + 8 for every 8-column
  // chunk u, the fragment layout of wgmma's A operand, so the rotate-half
  // partner of chunk u is chunk (u + D/16) mod D/8 of the same thread
  const uint32_t qbase = wg::smem_u32(smem + L::Q_OFF + (tid >> 7) * T::BYTES);
  {
    uint32_t x[2][D / 8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = row0 + 8 * r;
      const __nv_bfloat16* qrow =
          a.q + (long long)b * a.batch_stride + (long long)s * a.row_stride +
          (long long)h * D + 2 * t;
#pragma unroll
      for (int u = 0; u < D / 8; ++u)
        x[r][u] = (s < S && n > 0)
                      ? *reinterpret_cast<const uint32_t*>(qrow + 8 * u)
                      : 0u;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = row0 + 8 * r;
#pragma unroll
      for (int u = 0; u < D / 8; ++u) {
        uint32_t y = x[r][u];
        if (ROPE) {
          const long long off = (long long)s * HD + (long long)h * D + 8 * u + 2 * t;
          const bool in = s < S && n > 0;
          const uint32_t c = in ? *reinterpret_cast<const uint32_t*>(a.cq + off) : 0u;
          const uint32_t sn = in ? *reinterpret_cast<const uint32_t*>(a.sq + off) : 0u;
          y = rope2(x[r][u], x[r][(u + D / 16) % (D / 8)], c, sn);
        }
        *reinterpret_cast<uint32_t*>(
            smem + L::Q_OFF + (tid >> 7) * T::BYTES +
            T::offset(((tid >> 5) & 3) * 16 + g + 8 * r, u) + 4 * t) = y;
      }
    }
  }

  float o[NA][A / 2];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < A / 2; ++j) o[i][j] = 0.f;
  float sacc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) sacc[j] = 0.f;
  uint32_t pf[4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n; ++j) {
    unsigned char* st = smem + (j % NS) * L::STAGE;
    wg::mbar_wait(wg::smem_u32(bars + j % NS), (j / NS) & 1);
    if (ROPE) rotate_tile<D, NT>(st + L::K_OFF, st + L::COS_OFF, st + L::SIN_OFF, tid);
    wg::fence_async_smem();
    __syncthreads();   // tile j rotated; tile j - 1's stage free
    if (j + 1 < n)
      load_tile<D, ROPE>(a, smem + ((j + 1) % NS) * L::STAGE,
                         wg::smem_u32(bars + (j + 1) % NS), list[j + 1], b, h,
                         tid);

    const uint32_t kbase = wg::smem_u32(st + L::K_OFF);
    wg::hold(sacc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss64(sacc, T::kmajor(qbase, kk), T::kmajor(kbase, kk), kk > 0);
    wg::commit();
    wg::wait_all();
    wg::hold(sacc);

    // sacc[4 c + e]: row row0 + 8 (e >> 1), key 8 c + 2 t + (e & 1)
    const int* segk = reinterpret_cast<const int*>(st + L::SEG_OFF);
    float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int2 sk = *reinterpret_cast<const int2*>(segk + 8 * c + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int ks = (e & 1) ? sk.y : sk.x;
        const bool ok = segq[r] > 0 && ks == segq[r];
        const float s = __fadd_rn(__fmul_rn(sacc[4 * c + e], a.score_scale),
                                  ok ? 0.f : MASK);
        sacc[4 * c + e] = s;
        rmax[r] = fmaxf(rmax[r], s);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
      const float mnew = fmaxf(m[r], rmax[r]);
      alpha[r] = exp2f(m[r] - mnew);
      m[r] = mnew;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(sacc[i] - m[r]);
      rs[r] += p;
      sacc[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int jj = 0; jj < A / 2; ++jj) o[i][jj] *= alpha[(jj >> 1) & 1];
    wg::to_a(pf, sacc);

    const uint32_t vbase = wg::smem_u32(st + L::V_OFF);
#pragma unroll
    for (int i = 0; i < NA; ++i) wg::hold(o[i]);
    wg::hold(pf);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < NA; ++i)
        wg::rs<A>(o[i], pf[kk], T::mnmajor(vbase, kk, i));
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int i = 0; i < NA; ++i) wg::hold(o[i]);
    wg::hold(pf);
  }

  // normalise, stage as bf16 [BQ][OUT_LD] over the ring, store 16 bytes a
  // thread
  __syncthreads();   // every warpgroup's last products have read the ring
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lrow = row0 - q0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool dead = (m[r] <= MASK * 0.5f) || (l[r] == 0.f);
    const float scale = dead ? 0.f : 1.f / l[r];
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int c = 0; c < A / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + (lrow + 8 * r) * L::OUT_LD + i * A + 8 * c + 2 * t) =
            __floats2bfloat162_rn(o[i][4 * c + 2 * r] * scale,
                                  o[i][4 * c + 2 * r + 1] * scale);
  }
  __syncthreads();
  for (int i = tid; i < BQ * (D / 8); i += NT) {
    const int r = i / (D / 8), c = i % (D / 8);
    const int s = q0 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(a.out + ((long long)b * S + s) * HD +
                                (long long)h * D + 8 * c) =
          *reinterpret_cast<const uint4*>(ob + r * L::OUT_LD + 8 * c);
  }
}

template <int D, bool ROPE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int bytes = Layout<D, ROPE>::bytes((a.S + BK - 1) / BK);
  cudaError_t err = cudaFuncSetAttribute(
      rowblock_attention_kernel<D, ROPE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  using L = Layout<D, ROPE>;
  dim3 grid((a.S + L::BQ - 1) / L::BQ, a.H, B);
  rowblock_attention_kernel<D, ROPE><<<grid, L::NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Args& a, int B, cudaStream_t stream) {
  return a.cq ? launch<D, true>(a, B, stream) : launch<D, false>(a, B, stream);
}

}  // namespace

// q/k/v: bf16 views with unit stride inside a row, row stride `row_stride`
// and batch stride `batch_stride` (elements, multiples of 8), head h at
// column h*D, every base 16-byte aligned (the copies move 16 bytes).
// seg: int32 [B, S]. cq/sq/ck/sk: bf16 [S, H*D] tables, 16-byte aligned,
// or all null for no rotary. out: bf16 [B, S, H*D]. Returns
// cudaGetLastError().
extern "C" int rowblock_attention_bf16(
    const void* q, const void* k, const void* v, const void* seg,
    const void* cq, const void* sq, const void* ck, const void* sk,
    void* out, int B, int S, int H, int D, long long row_stride,
    long long batch_stride, float score_scale, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const int*>(seg),
               static_cast<const __nv_bfloat16*>(cq),
               static_cast<const __nv_bfloat16*>(sq),
               static_cast<const __nv_bfloat16*>(ck),
               static_cast<const __nv_bfloat16*>(sk),
               static_cast<__nv_bfloat16*>(out),
               S,
               H,
               row_stride,
               batch_stride,
               score_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(a, B, st);
    case 32: return launch_d<32>(a, B, st);
    case 64: return launch_d<64>(a, B, st);
    case 128: return launch_d<128>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
