// Kernel 3: radix-2 decimation-in-time NTT stages over Fr, in place on
// bit-reversed input, batched over any number of equal-size transforms laid
// end to end.
//
// Replaces marlin_tpu/ops/pallas/ntt.py::_build / _stages_kernel (:91 / :48,
// reached through fused_stages :101), which runs the first log2(B) stages
// with B = 2^13 elements resident in VMEM and leaves the wider stages to an
// XLA stage loop (marlin_tpu/ops/ntt.py:135-150, :226-250).  Here:
//
// (a) ntt_block_stages: one thread block owns B = 2^log_b contiguous
//     elements (B <= 1024, so 32 KB of Fr in shared memory -- the TPU's
//     2^13-element block would need 256 KB, more than a block's 227 KB) and
//     runs stages 0..log_b-1 on them with a __syncthreads() between stages;
//     256 threads, each doing B/512 butterflies per stage.
// (b) ntt_cross_stage: one launch per remaining stage s (butterfly stride
//     2^s >= B), one thread per butterfly, reading and writing global memory.
//
// Stage s pairs e = g*2m + j with o = e + m (m = 2^s, j < m) and computes
// x[e], x[o] = x[e] + w*x[o], x[e] - w*x[o] with w = TW_s[j] = w_{2m}^j, the
// twiddle convention of marlin_tpu/ops/ntt.py::_plan.  Twiddles arrive as
// data: one [n-1, 16] table per (n, direction), stage s at rows
// [2^s - 1, 2^(s+1) - 1), so one compiled kernel serves every size, forward
// and inverse.
//
// What bounds it on the H100: a butterfly is one Montgomery product (160
// integer multiply instructions) and an add and a sub on 128 bytes of
// element traffic per stage, so each cross-block stage is bound by memory
// bandwidth; (a) takes log2(B) = 10 stages per global round trip, which
// leaves log2(n) - 10 global passes (6 at the main path's 2^16).
//
// C interface (ctypes): every entry returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

namespace {

using F = FrTraits;
constexpr int NL = F::NL;
constexpr int kMaxLogB = 10;
constexpr int kThreads = 256;

__device__ __forceinline__ void butterfly(uint32_t xe[NL], uint32_t xo[NL],
                                          const int32_t* tw_row) {
  uint32_t w[NL], t[NL];
  fe_load<NL>(w, tw_row);
  fe_mul<F>(t, w, xo);
  fe_sub<F>(xo, xe, t);
  fe_add<F>(xe, xe, t);
}

__global__ void __launch_bounds__(kThreads) block_stages_kernel(int32_t* __restrict__ x, int log_b,
                                    const int32_t* __restrict__ tw) {
  extern __shared__ uint32_t sm[];
  const int B = 1 << log_b;
  const int half = B >> 1;
  int32_t* base = x + (long long)blockIdx.x * B * 2 * NL;
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
    uint32_t v[NL];
    fe_load<NL>(v, base + (long long)e * 2 * NL);
#pragma unroll
    for (int q = 0; q < NL; q++) sm[e * NL + q] = v[q];
  }
  __syncthreads();
  for (int s = 0; s < log_b; s++) {
    const int m = 1 << s;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int j = k & (m - 1);
      const int e = ((k >> s) << (s + 1)) + j;
      const int o = e + m;
      uint32_t xe[NL], xo[NL];
#pragma unroll
      for (int q = 0; q < NL; q++) {
        xe[q] = sm[e * NL + q];
        xo[q] = sm[o * NL + q];
      }
      butterfly(xe, xo, tw + (long long)(m - 1 + j) * 2 * NL);
#pragma unroll
      for (int q = 0; q < NL; q++) {
        sm[e * NL + q] = xe[q];
        sm[o * NL + q] = xo[q];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
    uint32_t v[NL];
#pragma unroll
    for (int q = 0; q < NL; q++) v[q] = sm[e * NL + q];
    fe_store<NL>(base + (long long)e * 2 * NL, v);
  }
}

__global__ void __launch_bounds__(kThreads) cross_stage_kernel(int32_t* __restrict__ x, long long half_total, int s,
                                   const int32_t* __restrict__ tw) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= half_total) return;
  const long long m = 1LL << s;
  const long long j = k & (m - 1);
  const long long e = ((k >> s) << (s + 1)) + j;
  const long long o = e + m;
  uint32_t xe[NL], xo[NL];
  fe_load<NL>(xe, x + e * 2 * NL);
  fe_load<NL>(xo, x + o * 2 * NL);
  butterfly(xe, xo, tw + (m - 1 + j) * 2 * NL);
  fe_store<NL>(x + e * 2 * NL, xe);
  fe_store<NL>(x + o * 2 * NL, xo);
}

}  // namespace

// x: [total, 16] int32, total a multiple of 2^log_b; in place.
extern "C" int marlin_ntt_block_stages(void* x, long long total, int log_b, const void* tw,
                                       const void* params, void* stream) {
  if (log_b < 1 || log_b > kMaxLogB || total <= 0 || (total & ((1LL << log_b) - 1)))
    return (int)cudaErrorInvalidValue;
  if (!params_match<F>(mod_params_from_words(static_cast<const uint32_t*>(params))))
    return (int)cudaErrorInvalidValue;
  const int B = 1 << log_b;
  const unsigned blocks = (unsigned)(total >> log_b);
  const int threads = B / 2 < kThreads ? B / 2 : kThreads;
  const size_t smem = (size_t)B * NL * sizeof(uint32_t);
  block_stages_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(x), log_b, static_cast<const int32_t*>(tw));
  return (int)cudaGetLastError();
}

// One DIT stage s over all of x ([total, 16] int32, 2^(s+1) | total); in place.
extern "C" int marlin_ntt_cross_stage(void* x, long long total, int s, const void* tw,
                                      const void* params, void* stream) {
  if (s < 0 || total <= 0 || (total & ((2LL << s) - 1))) return (int)cudaErrorInvalidValue;
  if (!params_match<F>(mod_params_from_words(static_cast<const uint32_t*>(params))))
    return (int)cudaErrorInvalidValue;
  const long long half_total = total / 2;
  const unsigned blocks = (unsigned)((half_total + kThreads - 1) / kThreads);
  cross_stage_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(x), half_total, s, static_cast<const int32_t*>(tw));
  return (int)cudaGetLastError();
}
