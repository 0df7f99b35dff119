// Page copies inside the paged KV pool for Hopper (sm_90a):
//   page_move_direct: pool[dst[i]] = pool[src[i]]      (src, dst disjoint);
//   page_move_staged: pool[dst[i]] = old pool[src[i]]  (any overlap).
//
// Replaces: procyon_tpu/ops/page_move.py::_kernel_direct (reached through
// move_pages_direct, the beam copy-on-write of inference/paged_beam.py) and
// procyon_tpu/ops/page_move.py::_kernel (reached through move_pages, the
// staged move: its Pallas kernel is the scatter from a staged buffer, the
// staging an XLA gather of every source before it).
//
// What they compute: for every move i, `row_bytes` bytes of one row are
// copied onto another; dst rows are distinct, src rows may repeat. A row's
// byte length is an argument, so bf16 pages, int8 pages and the f32 scale
// slabs of an int8 pool go through the same kernels.
//
// What bounds them on the H100: bytes alone, each distinct source read
// once and each destination written once: at the caption path's shape
// (2,560 rows of 128 KiB) 0.13 ms at 3.35 TB/s when a quarter of the
// sources are distinct.
//
// The direct move (page_copy_kernel) needs the src and dst sets disjoint
// (the caller's ping-pong page plan): no block reads what another writes,
// and the moves need no order. Its grid is (move, chunk of the row): a
// block of 256 threads copies 16 KiB, each thread four 16-byte loads issued
// before the four stores, so 2,560 moves of 128 KiB are 20,480 blocks in
// flight over 132 SMs.
//
// The staged move (page_move_staged_kernel) is one cooperative launch, a
// persistent grid that meets at grid-wide barriers:
//   1. the plan, on the device (no host read): mark[dst[i]] = i; the
//      moves of each source row in a list (head[row], nxt[i], built by
//      atomic exchange), whose first move leads the source's group; a
//      group whose source is some move's destination is staged, and gets
//      a slot of the scratch;
//   2. the staged rows alone are copied into the scratch;
//   3. one pass of moves, a work unit a (source, 16 KiB of the row): the
//      unit reads its source once (its staged copy, or the pool, which no
//      move writes there) and writes it to every destination of the group
//      from the same registers.
// Staging ends before any destination is written, and only destinations
// are written, so chains, swaps and cycles move the OLD rows. The host
// cannot know how many rows are staged without reading the device, so the
// scratch is a fixed budget the wrapper allocates (at most all the moves'
// rows): when the staged rows do not fit it, steps 2 and 3 run on column
// slabs of the rows, a slab at a time, K staged rows x w bytes each. Data
// written by one block and read by another after a barrier is read through
// the L2 (ld.global.cg): the SMs' L1 caches are not coherent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int VEC_PER_THREAD = 4;    // 16-byte vectors per thread
constexpr int CHUNK_VECS = NT * VEC_PER_THREAD;  // 16 KiB per block

// src and dst rows of one pool: no __restrict__ on it
__global__ void __launch_bounds__(NT)
page_copy_kernel(uint4* pool, const int* __restrict__ src,
                 const int* __restrict__ dst, long long row_vecs) {
  const int move = blockIdx.x;
  const long long v0 = static_cast<long long>(blockIdx.y) * CHUNK_VECS
      + threadIdx.x;
  const uint4* from = pool + src[move] * row_vecs;
  uint4* to = pool + dst[move] * row_vecs;
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

constexpr int UNIT = CHUNK_VECS * 16;  // bytes of a row a work unit moves
constexpr int PLAN_HEAD = 4;      // barrier arrivals, staged rows, sources

// every block of the grid (all resident: a cooperative launch) meets here;
// `target` counts the arrivals of all barriers so far. A barrier that never
// completes traps after about 2^26 polls instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    for (uint32_t i = 0;; ++i) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
      if (v >= target) break;
      if (i == (1u << 26)) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// n bytes (a multiple of 16, at most UNIT) from `from` to registers, and
// from registers to `to`
__device__ __forceinline__ void load_unit(uint4 (&r)[VEC_PER_THREAD],
                                          const unsigned char* from, int n) {
#pragma unroll
  for (int q = 0; q < VEC_PER_THREAD; ++q) {
    const int v = threadIdx.x + q * NT;
    if (v * 16 < n) r[q] = __ldcg(reinterpret_cast<const uint4*>(from) + v);
  }
}
__device__ __forceinline__ void store_unit(const uint4 (&r)[VEC_PER_THREAD],
                                           unsigned char* to, int n) {
#pragma unroll
  for (int q = 0; q < VEC_PER_THREAD; ++q) {
    const int v = threadIdx.x + q * NT;
    if (v * 16 < n) reinterpret_cast<uint4*>(to)[v] = r[q];
  }
}

// plan: int32 [PLAN_HEAD + 2 n_rows + 4 n_moves], its head zeroed before
// the launch; scratch: scratch_bytes, at least 128 bytes a move (or every
// move's row).
__global__ void __launch_bounds__(NT)
page_move_staged_kernel(unsigned char* pool, const int* __restrict__ src,
                        const int* __restrict__ dst, long long row_bytes,
                        int n_moves, int n_rows, int* plan,
                        unsigned char* scratch, long long scratch_bytes) {
  unsigned* bar = reinterpret_cast<unsigned*>(plan);
  int* n_staged = plan + 1;
  int* n_groups = plan + 2;
  int* mark = plan + PLAN_HEAD;     // [n_rows] the move that writes the row
  int* head = mark + n_rows;        // [n_rows] the row's last move as source
  int* nxt = head + n_rows;         // [n_moves] the move before, same source
  int* leader = nxt + n_moves;      // [n_moves] a group's first move
  int* slot = leader + n_moves;     // [n_moves] a group's scratch slot or -1
  int* staged = slot + n_moves;     // [n_moves] a slot's row
  unsigned target = 0;
  const long long tid = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * NT;
  for (long long r = tid; r < n_rows; r += threads) {
    mark[r] = -1;
    head[r] = -1;
  }
  grid_sync(bar, target);
  for (long long i = tid; i < n_moves; i += threads) {
    mark[__ldg(dst + i)] = static_cast<int>(i);
    nxt[i] = atomicExch(head + __ldg(src + i), static_cast<int>(i));
  }
  grid_sync(bar, target);
  for (long long i = tid; i < n_moves; i += threads) {
    if (__ldcg(nxt + i) >= 0) continue;   // not its source's first move
    const int s = __ldg(src + i);
    const int g = atomicAdd(n_groups, 1);
    int k = -1;
    if (__ldcg(mark + s) >= 0) {          // some move overwrites the source
      k = atomicAdd(n_staged, 1);
      staged[k] = s;
    }
    leader[g] = static_cast<int>(i);
    slot[g] = k;
  }
  grid_sync(bar, target);
  const long long K = __ldcg(n_staged), G = __ldcg(n_groups);
  const long long w = K * row_bytes <= scratch_bytes
                          ? row_bytes
                          : (scratch_bytes / K) & ~127LL;
  for (long long b0 = 0; b0 < row_bytes; b0 += w) {
    const long long wb = row_bytes - b0 < w ? row_bytes - b0 : w;
    const long long units = (wb + UNIT - 1) / UNIT;
    if (K > 0) {
      for (long long u = blockIdx.x; u < K * units; u += gridDim.x) {
        const long long k = u / units, off = u % units * UNIT;
        const int n = static_cast<int>(wb - off < UNIT ? wb - off : UNIT);
        uint4 r[VEC_PER_THREAD];
        load_unit(r, pool + __ldcg(staged + k) * row_bytes + b0 + off, n);
        store_unit(r, scratch + k * w + off, n);
      }
      grid_sync(bar, target);
    }
    for (long long u = blockIdx.x; u < G * units; u += gridDim.x) {
      const long long g = u / units, off = u % units * UNIT;
      const int n = static_cast<int>(wb - off < UNIT ? wb - off : UNIT);
      const int i = __ldcg(leader + g), k = __ldcg(slot + g);
      const int s = __ldg(src + i);
      uint4 r[VEC_PER_THREAD];
      load_unit(r, k >= 0 ? scratch + k * w + off
                          : pool + s * row_bytes + b0 + off, n);
      for (int j = __ldcg(head + s); j >= 0; j = __ldcg(nxt + j))
        store_unit(r, pool + __ldg(dst + j) * row_bytes + b0 + off, n);
    }
    if (K > 0 && b0 + w < row_bytes) grid_sync(bar, target);
  }
}

}  // namespace

// The pool is rows of `row_bytes` bytes (a multiple of 16, the base 16-byte
// aligned); src, dst: int32 [n_moves] on the device. Each entry returns
// cudaGetLastError() after its launch.
extern "C" int page_move_direct(void* pool, const void* src, const void* dst,
                                long long row_bytes, int n_moves,
                                void* stream) {
  const long long row_vecs = row_bytes / 16;
  const long long chunks = (row_vecs + CHUNK_VECS - 1) / CHUNK_VECS;
  if (n_moves <= 0 || chunks <= 0) return 0;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_moves, static_cast<unsigned>(chunks));
  page_copy_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool), static_cast<const int*>(src),
      static_cast<const int*>(dst), row_vecs);
  return static_cast<int>(cudaGetLastError());
}

// The staged move on the pool: plan int32 [4 + 2 n_rows + 4 n_moves] and
// scratch (scratch_bytes, at least min(n_moves * row_bytes, 128 n_moves))
// are the wrapper's; the plan's head is zeroed on the stream first.
// Returns the first error of the memset or the launch.
extern "C" int page_move_staged(void* pool, const void* src, const void* dst,
                                long long row_bytes, int n_moves, int n_rows,
                                void* plan, void* scratch,
                                long long scratch_bytes, void* stream) {
  if (n_moves <= 0 || row_bytes <= 0) return 0;
  const long long need = row_bytes < 128 ? row_bytes : 128;
  if (row_bytes % 16 || scratch_bytes < need * n_moves)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(plan, 0, PLAN_HEAD * sizeof(int), st);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, page_move_staged_kernel, NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // no more blocks than work units of the first slab (at least one)
  const long long most = static_cast<long long>(n_moves) *
                         ((row_bytes + UNIT - 1) / UNIT);
  const int grid = static_cast<int>(
      most < static_cast<long long>(per_sm) * sms ? most : per_sm * sms);
  unsigned char* p = static_cast<unsigned char*>(pool);
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  int* pl = static_cast<int*>(plan);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  void* args[] = {&p, &s, &d, &row_bytes, &n_moves, &n_rows, &pl, &sc,
                  &scratch_bytes};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(page_move_staged_kernel), dim3(grid), dim3(NT),
      args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
