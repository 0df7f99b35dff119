// Page copies inside the paged KV pool for Hopper (sm_90a):
//   page_move_direct:  pool[dst[i]] = pool[src[i]]  (src, dst disjoint);
//   page_move_gather:  staged[i]    = pool[src[i]];
//   page_move_scatter: pool[dst[i]] = staged[i].
//
// Replaces: procyon_tpu/ops/page_move.py::_kernel_direct (reached through
// move_pages_direct, the beam copy-on-write of inference/paged_beam.py) and
// procyon_tpu/ops/page_move.py::_kernel (reached through move_pages, the
// staged move: its Pallas kernel is the scatter from a staged buffer, the
// staging an XLA gather before it; here both are this file's copy kernel).
//
// What it computes: for every move i, `row_bytes` bytes of one row are
// copied onto another. The direct move needs the src and dst sets disjoint
// (the caller's ping-pong page plan): no block reads what another writes,
// and the moves need no order. The staged move has no such condition: the
// gather reads every source into a separate buffer before the scatter
// (a second launch on the same stream) writes any destination, so chains,
// swaps and cycles move the OLD rows. dst rows are distinct in both; src
// rows may repeat.
//
// What bounds it on the H100: bytes alone. Each moved row is read once and
// written once (the staged move twice: the buffer is written and read
// back); at the caption path's shape (2,560 rows of 128 KiB) that is 671 MB,
// 0.20 ms at 3.35 TB/s for the direct move.
//
// What the design does about it. The TPU kernels were a sequential grid
// over the moves, one page DMA each, with the indices prefetched as
// scalars. Here the grid is (move, chunk of the row): a block of 256
// threads copies 16 KiB, each thread four 16-byte loads issued before the
// four stores, so a 128 KiB page is eight blocks and 2,560 moves are 20,480
// blocks in flight over 132 SMs; every block reads its own row indices (a
// null index array means row i). A row's byte length is an argument, so
// bf16 pages, int8 pages and the f32 scale slabs of an int8 pool (2 KiB a
// row) go through the same kernel.
// Later work: TMA bulk copies (cp.async.bulk) would free the threads'
// registers; at these sizes the loads above should already sit near the
// memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int VEC_PER_THREAD = 4;    // 16-byte vectors per thread
constexpr int CHUNK_VECS = NT * VEC_PER_THREAD;  // 16 KiB per block

// from and to may be the same array (the direct move): no __restrict__
__global__ void __launch_bounds__(NT)
page_copy_kernel(const uint4* from, const int* __restrict__ from_rows,
                 uint4* to, const int* __restrict__ to_rows,
                 long long row_vecs) {
  const int move = blockIdx.x;
  const long long v0 = static_cast<long long>(blockIdx.y) * CHUNK_VECS
      + threadIdx.x;
  const long long fr = from_rows ? from_rows[move] : move;
  const long long tr = to_rows ? to_rows[move] : move;
  const uint4* src = from + fr * row_vecs;
  uint4* dst = to + tr * row_vecs;
  uint4 regs[VEC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < VEC_PER_THREAD; ++i) {
    const long long v = v0 + static_cast<long long>(i) * NT;
    if (v < row_vecs) regs[i] = src[v];
  }
#pragma unroll
  for (int i = 0; i < VEC_PER_THREAD; ++i) {
    const long long v = v0 + static_cast<long long>(i) * NT;
    if (v < row_vecs) dst[v] = regs[i];
  }
}

int copy_rows(const void* from, const void* from_rows, void* to,
              const void* to_rows, long long row_bytes, int n_moves,
              void* stream) {
  const long long row_vecs = row_bytes / 16;
  const long long chunks = (row_vecs + CHUNK_VECS - 1) / CHUNK_VECS;
  if (n_moves <= 0 || chunks <= 0) return 0;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_moves, static_cast<unsigned>(chunks));
  page_copy_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(from), static_cast<const int*>(from_rows),
      static_cast<uint4*>(to), static_cast<const int*>(to_rows), row_vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every array is rows of `row_bytes` bytes (a multiple of 16, the base
// 16-byte aligned); src, dst: int32 [n_moves] on the device. Each returns
// cudaGetLastError() after its launch.
extern "C" int page_move_direct(void* pool, const void* src, const void* dst,
                                long long row_bytes, int n_moves,
                                void* stream) {
  return copy_rows(pool, src, pool, dst, row_bytes, n_moves, stream);
}

// staged [n_moves, row] receives pool[src[i]] in row i.
extern "C" int page_move_gather(const void* pool, const void* src,
                                void* staged, long long row_bytes,
                                int n_moves, void* stream) {
  return copy_rows(pool, src, staged, nullptr, row_bytes, n_moves, stream);
}

// pool[dst[i]] receives row i of staged.
extern "C" int page_move_scatter(const void* staged, void* pool,
                                 const void* dst, long long row_bytes,
                                 int n_moves, void* stream) {
  return copy_rows(staged, nullptr, pool, dst, row_bytes, n_moves, stream);
}
