// Kernels 1 and 2: elementwise field binop (mul / add / sub) and Fermat
// inversion over Fr (NL = 8) or Fq (NL = 12), one thread per element.
//
// Kernel 1 replaces marlin_tpu/ops/pallas/field.py::_build_binop (:88, the
// pallas_call at :101, reached through binop :183); kernel 2 replaces
// _build_inv / _inv_kernel (:112 / :70, pallas_call at :126).
//
// What bounds them on the H100: the binop reads two elements and writes one
// (192 B per Fr element in the int32 API layout) against 160 integer
// multiply instructions for a Montgomery product (tools/sass_count.py), so
// it is bound by memory bandwidth; the design keeps it to one pass with
// 16-byte vector loads and stores and no shared memory.  The inversion does
// ~380 Montgomery products per element (255 squarings plus the multiplies
// for the set bits of N-2) on 128 bytes of traffic, so it is bound by
// integer multiply throughput; the exponent is uniform across threads, so
// the square-and-multiply loop never diverges, and the element stays in
// registers for the whole chain.  Both run on the compile-time moduli of
// mont.cuh (FrTraits for NL = 8, FqTraits for NL = 12); the entries refuse
// a context whose words do not match.
//
// C interface (ctypes): every entry returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

namespace {

constexpr int kThreads = 256;

template <class F, int KIND>
__global__ void __launch_bounds__(kThreads) binop_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                             int32_t* __restrict__ out, long long n) {
  constexpr int NL = F::NL;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NL], y[NL], r[NL];
  fe_load<NL>(x, a + i * 2 * NL);
  fe_load<NL>(y, b + i * 2 * NL);
  if (KIND == 0) {
    fe_mul<F>(r, x, y);
  } else if (KIND == 1) {
    fe_add<F>(r, x, y);
  } else {
    fe_sub<F>(r, x, y);
  }
  fe_store<NL>(out + i * 2 * NL, r);
}

template <class F>
__global__ void __launch_bounds__(kThreads) inv_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                           long long n) {
  constexpr int NL = F::NL;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t v[NL], r[NL];
  fe_load<NL>(v, x + i * 2 * NL);
  fe_inv<F>(r, v);
  fe_store<NL>(out + i * 2 * NL, r);
}

template <class F>
cudaError_t launch_binop(int kind, const int32_t* a, const int32_t* b, int32_t* out,
                         long long n, const ModParams& p, cudaStream_t s) {
  if (!params_match<F>(p)) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  switch (kind) {
    case 0: binop_kernel<F, 0><<<blocks, kThreads, 0, s>>>(a, b, out, n); break;
    case 1: binop_kernel<F, 1><<<blocks, kThreads, 0, s>>>(a, b, out, n); break;
    case 2: binop_kernel<F, 2><<<blocks, kThreads, 0, s>>>(a, b, out, n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int marlin_field_binop(int kind, int nl, const void* a, const void* b, void* out,
                                  long long n, const void* params, void* stream) {
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pa = static_cast<const int32_t*>(a);
  const int32_t* pb = static_cast<const int32_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  if (n <= 0) return 0;
  if (nl == 8) return (int)launch_binop<FrTraits>(kind, pa, pb, po, n, p, s);
  if (nl == 12) return (int)launch_binop<FqTraits>(kind, pa, pb, po, n, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int marlin_field_inv(int nl, const void* x, void* out, long long n,
                                const void* params, void* stream) {
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const int32_t* px = static_cast<const int32_t*>(x);
  int32_t* po = static_cast<int32_t*>(out);
  if (nl == 8 && params_match<FrTraits>(p)) {
    inv_kernel<FrTraits><<<blocks, kThreads, 0, s>>>(px, po, n);
  } else if (nl == 12 && params_match<FqTraits>(p)) {
    inv_kernel<FqTraits><<<blocks, kThreads, 0, s>>>(px, po, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
