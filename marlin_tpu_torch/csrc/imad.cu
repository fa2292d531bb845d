// Probes of the card's integer arithmetic for the bounds of PERF.md
// (tools/imad_rate.py):
//
// * imad_rate_kernel: the rate of the carry chains of the Montgomery
//   product (mont.cuh cmad_n: mad.lo.cc / madc.hi.cc pairs, which ptxas
//   fuses into IMAD.WIDE.U32 with carry) with every SM full: each thread
//   runs kChains independent chains of Fq's width (12 words, 8 for BN254), R
//   rows an iteration.  The
//   caller counts the multiplies of one row from the SASS of the R = 4 and
//   R = 8 instances (their difference is four rows), so the rate is in the
//   same unit as the product counts of the bounds.
// * product_chain_kernel: the latency of one dependent Montgomery product
//   (x = x y, iters times) on one thread of an idle card, for Fq and Fr.
//
// No TPU kernel corresponds; these measure the card for the others.
//
// C interface (ctypes): every entry returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

namespace {

constexpr int NL = FqTraits::NL;
constexpr int kChains = 4;
constexpr int kRateThreads = 256;

template <int R>
__global__ void __launch_bounds__(kRateThreads)
    imad_rate_kernel(const uint32_t* __restrict__ in, int iters, uint32_t* __restrict__ out,
                     long long* __restrict__ cycles) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[NL], acc[kChains][NL];
#pragma unroll
  for (int j = 0; j < NL; j++) {
    a[j] = in[j] ^ (uint32_t)t;
#pragma unroll
    for (int k = 0; k < kChains; k++) acc[k][j] = in[j] + (uint32_t)k;
  }
  const long long start = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int r = 0; r < R; r++) {
#pragma unroll
      for (int k = 0; k < kChains; k++) cmad_n<NL>(acc[k], Limbs{a, r & 1}, a[(r + 3 * k) % NL]);
    }
  }
  const long long stop = clock64();
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < kChains; k++) {
#pragma unroll
    for (int j = 0; j < NL; j++) v ^= acc[k][j];
  }
  out[t] = v;
  if (threadIdx.x == 0) cycles[blockIdx.x] = stop - start;
}

template <class F>
__global__ void product_chain_kernel(const int32_t* __restrict__ in, int iters,
                                     int32_t* __restrict__ out, long long* __restrict__ cycles) {
  uint32_t x[F::NL], y[F::NL];
  fe_load<F::NL>(x, in);
  fe_load<F::NL>(y, in + 2 * F::NL);
  const long long start = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; it++) fe_mul<F>(x, x, y);
  cycles[0] = clock64() - start;
  fe_store<F::NL>(out, x);
}

}  // namespace

// rows = 4 or 8 (the instance), blocks of kRateThreads threads; in: 12 words;
// out: one word a thread; cycles: one a block (clock64 over its loop).
extern "C" int marlin_imad_rate(int rows, const void* in, int blocks, int iters, void* out,
                                void* cycles, void* stream) {
  if ((rows != 4 && rows != 8) || blocks <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pin = static_cast<const uint32_t*>(in);
  uint32_t* pout = static_cast<uint32_t*>(out);
  long long* pc = static_cast<long long*>(cycles);
  if (rows == 4) {
    imad_rate_kernel<4><<<blocks, kRateThreads, 0, s>>>(pin, iters, pout, pc);
  } else {
    imad_rate_kernel<8><<<blocks, kRateThreads, 0, s>>>(pin, iters, pout, pc);
  }
  return (int)cudaGetLastError();
}

// Resident blocks of imad_rate_kernel<8> an SM, and its threads a block.
extern "C" int marlin_imad_rate_shape(int* blocks_per_sm, int* threads) {
  *threads = kRateThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, (const void*)imad_rate_kernel<8>, kRateThreads, 0);
}

// field: kFieldFq or kFieldFr; in: x then y in the API layout (2 NL words
// each); out: x y^iters; cycles: one word.
extern "C" int marlin_product_chain(int field, const void* in, int iters, void* out, void* cycles,
                                    void* stream) {
  if ((field != kFieldFq && field != kFieldFr) || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pin = static_cast<const int32_t*>(in);
  int32_t* pout = static_cast<int32_t*>(out);
  long long* pc = static_cast<long long*>(cycles);
  if (field == kFieldFq) {
    product_chain_kernel<FqTraits><<<1, 1, 0, s>>>(pin, iters, pout, pc);
  } else {
    product_chain_kernel<FrTraits><<<1, 1, 0, s>>>(pin, iters, pout, pc);
  }
  return (int)cudaGetLastError();
}
