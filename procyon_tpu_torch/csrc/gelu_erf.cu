// Bias add and exact-form GELU for Hopper (sm_90a), forward and backward:
//   out = T(0.5 h (1 + erf(h / sqrt 2))),  h = T(x + b)
//   dx  = T(g * gelu'(h))
// for x [M, F] of T = bf16 or f32 and an optional bias b [F] of the same
// type, with erf(u) = tanh(xc * p(xc^2)), xc = clamp(u, -4.2, 4.2) and p
// the odd degree-13 polynomial's seven coefficients of
// ops/activations.erf_approx.
//
// Replaces no TPU kernel: the JAX package writes gelu_erf_fast as plain
// jnp, and XLA fuses its chain into one loop. Run eagerly in PyTorch, the
// same chain is 22 f32 passes over the MLP's [rows, ffn] tensor (the cast,
// the scaling, the clamp, the twelve Horner steps, tanh, the affine
// products, the cast back) and the bias add one more, and autograd keeps
// several f32 temporaries of it for the backward.
//
// What bounds it on the H100: bytes, and nearly as much the f32
// arithmetic. The forward reads x and writes out, 4 bytes an element in
// bf16 (ESM2-3B's MLP at 128 x 1,026 rows: 5.4 GB, 1.61 ms at 3.35 TB/s);
// the backward reads g and x and writes dx, 6 bytes (2.41 ms). Some 50
// instructions an element with an accurate tanhf take about as long on 132
// SMs: on an H100 80GB HBM3 at 700 W, chip_smoke.py's gelu phase times the
// forward at 2.18 ms there (the plain chain 92.6 ms, F.gelu(x + b) 5.22)
// and the backward at 3.42 ms (the plain chain's autograd 159 ms; F.gelu's
// backward, of its own erf and not this function, 2.60). Contracting the
// Horner steps into FMAs would round otherwise than the plain chain, so
// each step rounds on its own.
//
// The arithmetic is the plain chain's, operation for operation: every
// product and sum of the forward rounds to f32 on its own, as torch's
// separate passes do, the constants are the Python doubles rounded to f32 as torch rounds a
// scalar operand, tanhf is CUDA's accurate one (no fast math), the clamp
// passes NaN, and the result rounds once to T. The backward is the
// analytic derivative of the same function in f32:
//   gelu'(h) = 0.5 (1 + E) + 0.5 h (1 - E^2) (p(t) + 2 t p'(t)) / sqrt 2,
// t = xc^2, the second term zero where the clamp is active (torch's clamp
// passes the gradient at the bounds themselves and nowhere past them).
//
// The design: a grid-stride loop over 16-byte vectors (8 bf16 or 4 f32) of
// the flat tensor, as many blocks as are resident on the card at once, one
// vector a thread in flight; the bias comes through the L1 from the
// vector's column, which each thread steps along with its index instead of
// dividing. Where F is not a multiple of the vector or a pointer is not
// 16-byte aligned, the same loop runs one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 256;  // threads a block

// the Python doubles of ops/activations.py as torch rounds them to f32
constexpr float INV_SQRT2 = static_cast<float>(0.7071067811865476);
constexpr float LIM = static_cast<float>(4.2);
constexpr float C0 = static_cast<float>(1.1283793939e+00);
constexpr float C1 = static_cast<float>(1.0276775286e-01);
constexpr float C2 = static_cast<float>(-1.8844757103e-04);
constexpr float C3 = static_cast<float>(-6.2315751026e-04);
constexpr float C4 = static_cast<float>(8.9099016893e-05);
constexpr float C5 = static_cast<float>(-5.9358860429e-06);
constexpr float C6 = static_cast<float>(1.5851481176e-07);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch's clamp: NaN passes through
__device__ __forceinline__ float clamp_lim(float u) {
  return u < -LIM ? -LIM : (u > LIM ? LIM : u);
}

// p(t) in the reference's Horner order, each step rounded as its own pass
__device__ __forceinline__ float poly(float t) {
  float acc = __fadd_rn(__fmul_rn(C6, t), C5);
  acc = __fadd_rn(__fmul_rn(acc, t), C4);
  acc = __fadd_rn(__fmul_rn(acc, t), C3);
  acc = __fadd_rn(__fmul_rn(acc, t), C2);
  acc = __fadd_rn(__fmul_rn(acc, t), C1);
  return __fadd_rn(__fmul_rn(acc, t), C0);
}

__device__ __forceinline__ float gelu(float h) {
  const float xc = clamp_lim(__fmul_rn(h, INV_SQRT2));
  const float e = tanhf(__fmul_rn(xc, poly(__fmul_rn(xc, xc))));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, e));
}

__device__ __forceinline__ float gelu_grad(float h) {
  const float u = __fmul_rn(h, INV_SQRT2);
  const float xc = clamp_lim(u);
  const float t = __fmul_rn(xc, xc);
  const float p = poly(t);
  const float e = tanhf(__fmul_rn(xc, p));
  float d = 0.5f * (1.0f + e);
  if (u >= -LIM && u <= LIM) {
    const float dp = fmaf(fmaf(fmaf(fmaf(fmaf(6.0f * C6, t, 5.0f * C5), t,
                                         4.0f * C4), t, 3.0f * C3), t,
                               2.0f * C2), t, C1);
    d += 0.5f * h * fmaf(-e, e, 1.0f) * fmaf(2.0f * t, dp, p) * INV_SQRT2;
  }
  return d;
}

// N elements of T from / to 16-byte aligned memory (N * sizeof(T) == 16),
// or one element (N == 1)
template <int N, typename T>
__device__ __forceinline__ void load(T (&v)[N], const T* p) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(v, &raw, 16);
  } else {
    v[0] = p[0];
  }
}

template <int N, typename T>
__device__ __forceinline__ void store(T* p, const T (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 raw;
    memcpy(&raw, v, 16);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    p[0] = v[0];
  }
}

// h = T(x + b): the bias add rounds to x's type, as the plain `mm + b` does
template <typename T>
__device__ __forceinline__ float pre_activation(T x, const T* bias, T b) {
  return bias ? to_f32(from_f32<T>(__fadd_rn(to_f32(x), to_f32(b))))
              : to_f32(x);
}

// The loop both kernels share: unit u is N elements at u * N (a whole
// vector lies in one row, F % N == 0), its bias at column col * N; each
// thread steps col by the grid's stride modulo the row's units.
struct Walk {
  long long u, units, stride;
  int col, row_units, col_step;

  __device__ Walk(long long n, int f, int N) {
    units = n / N;
    row_units = f / N;
    u = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
    stride = static_cast<long long>(gridDim.x) * NT;
    col = static_cast<int>(u % row_units);
    col_step = static_cast<int>(stride % row_units);
  }
  __device__ bool more() const { return u < units; }
  __device__ void next() {
    u += stride;
    col += col_step;
    if (col >= row_units) col -= row_units;
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(NT)
gelu_erf_fwd_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                    T* __restrict__ out, long long n, int f) {
  for (Walk w(n, f, N); w.more(); w.next()) {
    T xv[N], bv[N] = {}, ov[N];
    load<N>(xv, x + w.u * N);
    if (bias) load<N>(bv, bias + static_cast<long long>(w.col) * N);
#pragma unroll
    for (int k = 0; k < N; ++k)
      ov[k] = from_f32<T>(gelu(pre_activation(xv[k], bias, bv[k])));
    store<N>(out + w.u * N, ov);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(NT)
gelu_erf_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const T* __restrict__ bias, T* __restrict__ dx,
                    long long n, int f) {
  for (Walk w(n, f, N); w.more(); w.next()) {
    T gv[N], xv[N], bv[N] = {}, dv[N];
    load<N>(gv, g + w.u * N);
    load<N>(xv, x + w.u * N);
    if (bias) load<N>(bv, bias + static_cast<long long>(w.col) * N);
#pragma unroll
    for (int k = 0; k < N; ++k)
      dv[k] = from_f32<T>(to_f32(gv[k]) *
                          gelu_grad(pre_activation(xv[k], bias, bv[k])));
    store<N>(dx + w.u * N, dv);
  }
}

// as many blocks as are resident at once, no more than the units need
template <typename K>
int grid_for(K kernel, long long units, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need = (units + NT - 1) / NT;
  const long long most = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(need < most ? need : most);
  return 0;
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) %
          16) == 0;
}

template <typename T, int N>
int launch_fwd(const void* x, const void* bias, void* out, long long n, int f,
               cudaStream_t st) {
  auto kernel = gelu_erf_fwd_kernel<T, N>;
  int grid = 0;
  if (int err = grid_for(kernel, n / N, &grid)) return err;
  kernel<<<grid, NT, 0, st>>>(static_cast<const T*>(x),
                              static_cast<const T*>(bias),
                              static_cast<T*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_bwd(const void* g, const void* x, const void* bias, void* dx,
               long long n, int f, cudaStream_t st) {
  auto kernel = gelu_erf_bwd_kernel<T, N>;
  int grid = 0;
  if (int err = grid_for(kernel, n / N, &grid)) return err;
  kernel<<<grid, NT, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(bias), static_cast<T*>(dx), n, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
constexpr int VEC = 16 / sizeof(T);

}  // namespace

// out = gelu(x + bias) over n elements of rows of f (n % f == 0); bias [f]
// or null; bf16 != 0 for bf16 tensors, else f32. All contiguous.
extern "C" int gelu_erf_fwd(const void* x, const void* bias, void* out,
                            long long n, int f, int bf16, void* stream) {
  if (n <= 0) return 0;
  if (f <= 0 || n % f) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a16 = aligned16(x, bias, out, nullptr);
  if (bf16) {
    using T = __nv_bfloat16;
    return a16 && f % VEC<T> == 0
               ? launch_fwd<T, VEC<T>>(x, bias, out, n, f, st)
               : launch_fwd<T, 1>(x, bias, out, n, f, st);
  }
  return a16 && f % VEC<float> == 0
             ? launch_fwd<float, VEC<float>>(x, bias, out, n, f, st)
             : launch_fwd<float, 1>(x, bias, out, n, f, st);
}

// dx = g * gelu'(x + bias), shapes and types as gelu_erf_fwd's
extern "C" int gelu_erf_bwd(const void* g, const void* x, const void* bias,
                            void* dx, long long n, int f, int bf16,
                            void* stream) {
  if (n <= 0) return 0;
  if (f <= 0 || n % f) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a16 = aligned16(g, x, bias, dx);
  if (bf16) {
    using T = __nv_bfloat16;
    return a16 && f % VEC<T> == 0
               ? launch_bwd<T, VEC<T>>(g, x, bias, dx, n, f, st)
               : launch_bwd<T, 1>(g, x, bias, dx, n, f, st);
  }
  return a16 && f % VEC<float> == 0
             ? launch_bwd<float, VEC<float>>(g, x, bias, dx, n, f, st)
             : launch_bwd<float, 1>(g, x, bias, dx, n, f, st);
}
