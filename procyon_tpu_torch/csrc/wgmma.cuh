// Hopper (sm_90a) building blocks of the port's tensor-core kernels
// (rowblock_attention.cu, flash_attention_fwd.cu, flash_attention_bwd.cu,
// fused_ln_mlp_int8.cu and fused_rms_swiglu_int8.cu through int8_ring.cuh,
// int4_matmul.cu, paged_attention.cu, fused_decode_mlp.cu): the
// shared-memory tile layout wgmma and ldmatrix read, its matrix
// descriptors, the warpgroup products with A in registers (RS) or in
// shared memory (SS, bf16 and s8), cp.async and TMA tile copies, the
// mbarriers that signal them, and the host's TMA tensor maps.
//
// Tile layout. A [ROWS][D] bf16 tile is cut along its columns into atoms
// of A = min(D, 64) elements, so that an atom row is RB = 2A bytes: 32, 64
// or 128, the width of the 32 / 64 / 128-byte swizzle wgmma names by the
// same number. Atoms follow each other (atom-major), rows follow each other
// at RB bytes inside an atom, and the 16-byte chunks of a row are XOR-ed
// with address bits 7 and up (CUTLASS's Swizzle<log2(RB / 16), 4, 3>).
// The tile base is 1024-byte aligned, so the offset's bits are the
// address's. One layout serves both readings of wgmma's B operand:
//   * K-major ("rows . columns"): rows are M or N, columns are the
//     reduction; 8-row groups at SBO = 8 RB; a k-step of 16 columns starts
//     32 bytes further inside the atom (the swizzle is applied to the
//     address, so the offset composes with it);
//   * MN-major ("columns . rows", tnsp 1): rows are the reduction, an atom's
//     A columns are N; 8-row groups at SBO = 8 RB, a k-step of 16 rows
//     starts 16 RB further; the stride between atoms is the descriptor's
//     LBO, so one product covers one atom or, at N 128 (the forward's P V
//     at D 128), two.
// A tile written by cp.async (generic proxy) is read by wgmma (async
// proxy): every writer fences (fence.proxy.async) before the barrier that
// precedes the product.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int D, int ROWS>
struct Tile {
  static_assert(D % 16 == 0 && (D <= 64 || D % 64 == 0), "tile width");
  static_assert(ROWS % 8 == 0, "tile rows");
  static constexpr int A = D < 64 ? D : 64;        // atom width, elements
  static constexpr int RB = 2 * A;                 // atom row, bytes
  static constexpr int NATOM = D / A;
  static constexpr int CHUNKS = D / 8;             // 16-byte chunks a row
  static constexpr int ATOM_BYTES = ROWS * RB;
  static constexpr int BYTES = ROWS * D * 2;
  static constexpr uint64_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;

  // byte offset of chunk c (columns 8c .. 8c + 7) of row r
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t off = (c / (A / 8)) * ATOM_BYTES + r * RB + (c % (A / 8)) * 16;
    return off ^ (((off >> 7) & (RB / 16 - 1)) << 4);
  }

  __device__ static __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>(((8 * RB) >> 4) & 0x3FFF) << 32) |
           (MODE << 62);
  }
  // K-major operand, reduction columns 16 kk .. 16 kk + 15
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return desc(base + (kk * 16 / A) * ATOM_BYTES + (kk * 16 % A) * 2, 16);
  }
  // MN-major operand, reduction rows 16 kk .. 16 kk + 15, columns of atom a
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int kk,
                                                     int a) {
    return desc(base + a * ATOM_BYTES + kk * 16 * RB, ATOM_BYTES);
  }
};

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// every committed group but the newest has completed (groups complete in
// the order they were committed)
__device__ __forceinline__ void wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void hold(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_F8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_D16 WG_D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_D32                                                          \
  WG_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"

// d[m64 x N] += a[m64 x k16] (registers, the m16n8k16 A fragment of each
// warp's 16 rows) . B[k16 x N] (descriptor, MN-major: the form the kernels
// use; at N 128 the product spans two atoms, LBO apart); f32 accumulators,
// N / 2 a thread: d[4 j + e] is row g + 8 (e >> 1), column 8 j + 2 t +
// (e & 1)
template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t b);

template <>
__device__ __forceinline__ void rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void rs<128>(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D32
      ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24), WG_F8(d, 32),
        WG_F8(d, 40), WG_F8(d, 48), WG_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_D16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" WG_D8
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WG_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[m64 x n64] (+)= A[m64 x k16] . B[k16 x n64], both K-major descriptors
__device__ __forceinline__ void ss64(float (&d)[32], uint64_t a, uint64_t b,
                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[m64 x n128] (+)= A[m64 x k16] . B[k16 x n128], both K-major descriptors
__device__ __forceinline__ void ss128(float (&d)[64], uint64_t a, uint64_t b,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D32
      ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24), WG_F8(d, 32),
        WG_F8(d, 40), WG_F8(d, 48), WG_F8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// s8 products (int8_ring.cuh): d[m64 x N] (+)= A[m64 x k32] .
// B[k32 x N], both K-major descriptors over 128-byte rows, s32
// accumulators, N / 2 a thread laid out as the f32 ones above
#define WG_R8(d, i)                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define WG_D64                                                          \
  WG_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "    \
         "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_D128                                                         \
  WG_D64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
         "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "    \
         "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "    \
         "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
         "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "    \
         "%120, %121, %122, %123, %124, %125, %126, %127"

template <int N>
__device__ __forceinline__ void ss_s8(uint32_t (&d)[N / 2], uint64_t a,
                                      uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void ss_s8<128>(uint32_t (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WG_D64
      "}, %64, %65, p;\n}\n"
      : WG_R8(d, 0), WG_R8(d, 8), WG_R8(d, 16), WG_R8(d, 24), WG_R8(d, 32),
        WG_R8(d, 40), WG_R8(d, 48), WG_R8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void ss_s8<256>(uint32_t (&d)[128], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WG_D128
      "}, %128, %129, p;\n}\n"
      : WG_R8(d, 0), WG_R8(d, 8), WG_R8(d, 16), WG_R8(d, 24), WG_R8(d, 32),
        WG_R8(d, 40), WG_R8(d, 48), WG_R8(d, 56), WG_R8(d, 64),
        WG_R8(d, 72), WG_R8(d, 80), WG_R8(d, 88), WG_R8(d, 96),
        WG_R8(d, 104), WG_R8(d, 112), WG_R8(d, 120)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int R>
__device__ __forceinline__ void hold(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#undef WG_R8
#undef WG_D64
#undef WG_D128
#undef WG_F8
#undef WG_D8
#undef WG_D16
#undef WG_D32

// K-major descriptor of a tile of 128-byte rows (128 int8 codes of the
// reduction each) in the 128-byte swizzle, as a TMA copy with
// CU_TENSOR_MAP_SWIZZLE_128B lays it out: reduction bytes 32 kk .. 32 kk +
// 31 (one s8 k-step)
__device__ __forceinline__ uint64_t kmajor_s8(uint32_t base, int kk) {
  return Tile<64, 8>::desc(base + 32 * kk, 16);
}

// two f32 as the bf16 pair of one 32-bit A-fragment register (lo first)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the m64 x k16 A fragments of a score-shaped accumulator s[m64 x n16KS]
// (rounded to bf16): the product's output columns become the next
// product's reduction
template <int KS>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4],
                                     const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// 16 (or 4) bytes from global into shared memory, asynchronously; with
// full == false nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the barrier's arrival once every cp.async this thread issued has landed
// (the barrier counts one arrival per thread and phase)
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// wait for the phase of the given parity to complete; a barrier that never
// completes (a lost arrival) traps after about 2^26 polls instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (i == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the producer's arrival on a full barrier, with the bytes its TMA copies
// will complete
__device__ __forceinline__ void arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// a 2D tile of a tensor map (a CUtensorMap in kernel parameter space) at
// (inner, outer) into shared memory; completes bytes on bar. Elements
// outside the tensor are zero-filled.
__device__ __forceinline__ void tma_2d(uint32_t dst, const void* map,
                                       int inner, int outer, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer), "r"(bar)
      : "memory");
}
// the same tile into the shared memory of every block of the cluster in
// mask, at the same offset, completing bytes on each one's barrier at bar's
// offset
__device__ __forceinline__ void tma_2d_multicast(uint32_t dst,
                                                 const void* map, int inner,
                                                 int outer, uint32_t bar,
                                                 uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner),
      "r"(outer), "h"(mask)
      : "memory");
}

// thread block clusters
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster (not warp-aligned)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::
          : "memory");
}
// one arrival, where pred holds, on the mbarrier at the local address bar
// mapped into block `rank` of the cluster
__device__ __forceinline__ void arrive_cluster_if(uint32_t bar, uint32_t rank,
                                                  bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 remote;\nsetp.ne.u32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank), "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// 1024-byte aligned start of the dynamic shared memory (the launch asks for
// 1 KB more than the kernel's layout)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// one arrival on a barrier of this block
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// 16 bytes (four f32) at the address `local` has in block `rank` of the
// cluster (distributed shared memory)
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t local,
                                                uint32_t rank) {
  float4 v;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %4, %5;\n"
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [remote];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(local), "r"(rank)
      : "memory");
  return v;
}
// one f32 of block `rank` of the cluster
__device__ __forceinline__ float ld_cluster_f32(uint32_t local,
                                                uint32_t rank) {
  float v;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [remote];\n}\n"
      : "=f"(v)
      : "r"(local), "r"(rank)
      : "memory");
  return v;
}

// four 8 x 8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8); r[i] is matrix i's fragment, lane (g, t)
// holding its row g, columns 2t and 2t + 1 (.trans: column g, rows 2t and
// 2t + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d[m16 x n8] += a[m16 x k16] . b[k16 x n8], bf16 in, f32 sums (mma.sync;
// registers only, so the compiler may schedule it among other work)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- host side ----

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [outer, inner] matrix (rows `stride` bytes apart) read in
// boxes of [box_outer, box_inner] elements, zero-filled outside
inline bool tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, unsigned long long inner,
                          unsigned long long outer, unsigned long long stride,
                          unsigned box_inner, unsigned box_outer,
                          CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a kernel's dynamic shared memory (and, where asked, clusters of more than
// 8 blocks) set once a device rather than at every launch: the decode paths
// launch their kernels hundreds of times a step, and these calls cost host
// time each
inline cudaError_t set_attributes_once(const void* kernel, int smem_bytes,
                                       bool nonportable_clusters) {
  constexpr int KERNELS = 64;
  static std::mutex lock;
  static const void* kernels[KERNELS];
  static uint64_t devices_done[KERNELS];
  static int n_kernels = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  std::lock_guard<std::mutex> guard(lock);
  int i = 0;
  while (i < n_kernels && kernels[i] != kernel) ++i;
  if (i < n_kernels && (devices_done[i] & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err == cudaSuccess && nonportable_clusters)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess || i == KERNELS) return err;
  if (i == n_kernels) {
    kernels[i] = kernel;
    devices_done[i] = 0;
    ++n_kernels;
  }
  devices_done[i] |= bit;
  return cudaSuccess;
}

}  // namespace wg
