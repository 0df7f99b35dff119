// In-place page copy inside the paged KV pool for Hopper (sm_90a):
// pool[dst[i]] = pool[src[i]] for a list of page rows.
//
// Replaces: procyon_tpu/ops/page_move.py::_kernel_direct (reached through
// move_pages_direct, the beam copy-on-write of inference/paged_beam.py).
//
// What it computes: for every move i, the `row_bytes` bytes of row src[i]
// are copied onto row dst[i] of the same array. The src and dst sets are
// disjoint and dst rows are distinct (the caller's ping-pong page plan), so
// no block reads what another writes and the moves need no order; src rows
// may repeat.
//
// What bounds it on the H100: bytes alone. Each moved row is read once and
// written once; at the caption path's shape (2,560 rows of 128 KiB) that is
// 671 MB, 0.20 ms at 3.35 TB/s.
//
// What the design does about it. The TPU kernel was a sequential grid over
// the moves, one page DMA each, with src and dst prefetched as scalars.
// Here the grid is (move, chunk of the row): a block of 256 threads copies
// 16 KiB, each thread four 16-byte loads issued before the four stores, so
// a 128 KiB page is eight blocks and 2,560 moves are 20,480 blocks in
// flight over 132 SMs; every block reads its own src[i] and dst[i]. A row's
// byte length is an argument, so bf16 pages, int8 pages and the f32 scale
// slabs of an int8 pool (2 KiB a row) go through the same kernel.
// Later work: TMA bulk copies (cp.async.bulk) would free the threads'
// registers; at these sizes the loads above should already sit near the
// memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int VEC_PER_THREAD = 4;    // 16-byte vectors per thread
constexpr int CHUNK_VECS = NT * VEC_PER_THREAD;  // 16 KiB per block

__global__ void __launch_bounds__(NT)
page_move_kernel(uint4* pool, const int* __restrict__ src,
                 const int* __restrict__ dst, long long row_vecs) {
  const int move = blockIdx.x;
  const long long v0 = static_cast<long long>(blockIdx.y) * CHUNK_VECS
      + threadIdx.x;
  const uint4* from = pool + static_cast<long long>(src[move]) * row_vecs;
  uint4* to = pool + static_cast<long long>(dst[move]) * row_vecs;
  uint4 regs[VEC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < VEC_PER_THREAD; ++i) {
    const long long v = v0 + static_cast<long long>(i) * NT;
    if (v < row_vecs) regs[i] = from[v];
  }
#pragma unroll
  for (int i = 0; i < VEC_PER_THREAD; ++i) {
    const long long v = v0 + static_cast<long long>(i) * NT;
    if (v < row_vecs) to[v] = regs[i];
  }
}

}  // namespace

// pool: any array of rows of `row_bytes` bytes (a multiple of 16, the base
// 16-byte aligned); src, dst: int32 [n_moves] on the device.
extern "C" int page_move_direct(void* pool, const void* src, const void* dst,
                                long long row_bytes, int n_moves,
                                void* stream) {
  const long long row_vecs = row_bytes / 16;
  const long long chunks = (row_vecs + CHUNK_VECS - 1) / CHUNK_VECS;
  if (n_moves <= 0 || chunks <= 0) return 0;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_moves, static_cast<unsigned>(chunks));
  page_move_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool), static_cast<const int*>(src),
      static_cast<const int*>(dst), row_vecs);
  return static_cast<int>(cudaGetLastError());
}
