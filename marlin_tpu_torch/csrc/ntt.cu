// Kernel 3: radix-2 decimation-in-time NTT stages over Fr (8 words for every
// curve of the port), batched over any number of equal-size transforms laid
// end to end.  A mixed-radix transform of 3^s 2^k points (ops/ntt.py) runs
// its 3^s inner radix-2 transforms of 2^k points as one such batch.
//
// Replaces marlin_tpu/ops/pallas/ntt.py::_build / _stages_kernel (:91 / :48,
// reached through fused_stages :101), which runs the first log2(B) stages
// with B = 2^13 elements resident in VMEM and leaves the wider stages to an
// XLA stage loop (marlin_tpu/ops/ntt.py:135-150, :226-250), after a
// bit-reversal gather and before an n^-1 product for inverse transforms.
// Here:
//
// (a) ntt_block_stages: each B = 2^log_b consecutive outputs (B <= 1024:
//     the TPU's 2^13-element block would need 256 KB of shared memory, more
//     than a block's 227 KB) belong to one cluster of C = 1, 2, 4 or 8
//     CTAs.  It gathers them in bit-reversed order straight from the input
//     (x[rev(i)], rev computed with __brev, so no permuted copy and no
//     table), multiplies each by the optional scale (n^-1 of an inverse
//     transform: the transform is linear, so scaling its input equals
//     scaling its output, with no launch of its own), runs stages
//     0..log_b-1 in shared memory with one butterfly a thread, and writes
//     the block out.  With C > 1 each CTA first runs the stages inside its
//     B/C elements, then the CTAs trade elements through distributed shared
//     memory (a thread-block cluster) for the last log2(C) stages.  C is
//     picked from the grid and the SM count, so that a short grid (16-64
//     blocks at the 2^14 and 2^16 prove shapes) still spreads over the
//     card.  It works out of place, into the output the cross stages then
//     update.
// (b) ntt_cross_stage: one launch per remaining stage s (butterfly stride
//     2^s >= B), one thread per butterfly, reading and writing global memory
//     in place.
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
// bandwidth and (a), with log2(B) = 10 stages per global round trip, by
// integer multiplies: a 2^10 block's 5,120 products keep one SM busy for
// ~26 us on the H100, so (a) is as fast as the number of SMs its grid
// covers, which the clusters raise.  (a) keeps its elements and the twiddle
// rows of its CTA's own stages in shared memory as 32-bit limbs,
// limb-major ([NL][P]), so the 32 elements of a warp's butterflies fall on
// 32 banks (two ways at most in stages 0-4); 64 KB of dynamic shared memory
// at B = 2^10 and C = 1.  The cluster stages read their twiddles from
// global memory.
//
// C interface (ctypes): every entry returns the cudaError_t of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

namespace cg = cooperative_groups;

namespace {

using F = FrTraits;
constexpr int NL = F::NL;
constexpr int kMaxLogB = 10;
constexpr int kBlockThreads = 1 << (kMaxLogB - 1);
constexpr int kThreads = 256;
constexpr size_t kBlockSmem = 2 * NL * (1 << kMaxLogB) * sizeof(uint32_t);

__device__ __forceinline__ void butterfly(uint32_t xe[NL], uint32_t xo[NL], const uint32_t w[NL]) {
  uint32_t t[NL];
  fe_mul<F>(t, w, xo);
  fe_sub<F>(xo, xe, t);
  fe_add<F>(xe, xe, t);
}

// One 2^log_b block of outputs per cluster of C = 2^log_c CTAs; CTA `rank`
// holds P = B / C of them.  Phase 1: the CTA gathers positions rank*P + e
// (e < P) and runs stages 0..log2(P)-1 on them.  Phase 2 (C > 1): each CTA
// takes, through distributed shared memory, the positions h*P + rank*Q + l
// (h < C, l < Q = P / C), which the remaining log_c stages pair only among
// themselves, runs those stages and writes them out.
__global__ void __launch_bounds__(kBlockThreads, 1)
    block_stages_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y, int log_n, int log_b,
                        int log_c, const int32_t* __restrict__ tw, const int32_t* __restrict__ scale) {
  extern __shared__ uint32_t sm[];
  const int log_p = log_b - log_c;
  const int P = 1 << log_p;
  uint32_t* data = sm;                // [NL][P]: phase 1's elements
  uint32_t* tws = sm + NL * P;        // [NL][P]: twiddle rows 0 .. P-2 (stages 0 .. log_p-1)
  uint32_t* part = sm + 2 * NL * P;   // [NL][P]: phase 2's elements (C > 1)
  const int rank = (int)(blockIdx.x & ((1u << log_c) - 1));  // the cluster's CTAs are consecutive
  const long long first = (long long)(blockIdx.x >> log_c) << log_b;
  const long long row = (first >> log_n) << log_n;  // the transform this block lies in
  const unsigned off = (unsigned)(first - row) + (unsigned)(rank << log_p);
  const int rev_shift = 32 - log_n;
  uint32_t sc[NL];
  if (scale) fe_load<NL>(sc, scale);
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    uint32_t v[NL];
    fe_load<NL>(v, x + (row + (__brev(off + e) >> rev_shift)) * 2 * NL);
    if (scale) fe_mul<F>(v, v, sc);
#pragma unroll
    for (int q = 0; q < NL; q++) data[q * P + e] = v[q];
  }
  for (int r = threadIdx.x; r < P - 1; r += blockDim.x) {
    uint32_t w[NL];
    fe_load<NL>(w, tw + (long long)r * 2 * NL);
#pragma unroll
    for (int q = 0; q < NL; q++) tws[q * P + r] = w[q];
  }
  __syncthreads();
  const int half = P >> 1;
  for (int s = 0; s < log_p; s++) {
    const int m = 1 << s;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int j = k & (m - 1);
      const int e = ((k >> s) << (s + 1)) + j;
      const int o = e + m;
      uint32_t xe[NL], xo[NL], w[NL];
#pragma unroll
      for (int q = 0; q < NL; q++) {
        xe[q] = data[q * P + e];
        xo[q] = data[q * P + o];
        w[q] = tws[q * P + m - 1 + j];
      }
      butterfly(xe, xo, w);
#pragma unroll
      for (int q = 0; q < NL; q++) {
        data[q * P + e] = xe[q];
        data[q * P + o] = xo[q];
      }
    }
    __syncthreads();
  }
  if (log_c == 0) {
    int32_t* out = y + first * 2 * NL;
    for (int e = threadIdx.x; e < P; e += blockDim.x) {
      uint32_t v[NL];
#pragma unroll
      for (int q = 0; q < NL; q++) v[q] = data[q * P + e];
      fe_store<NL>(out + (long long)e * 2 * NL, v);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int log_q = log_p - log_c;
  const int Q = 1 << log_q;
  cluster.sync();  // every CTA's phase 1 is in its shared memory
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const uint32_t* src = cluster.map_shared_rank(data, e >> log_q);  // CTA h = e / Q
    const int at = rank * Q + (e & (Q - 1));
#pragma unroll
    for (int q = 0; q < NL; q++) part[q * P + e] = src[q * P + at];
  }
  cluster.sync();  // every read of `data` is done before any CTA goes on (or exits)
  for (int s = log_p; s < log_b; s++) {
    const int t = s - log_p;  // the bit of h that stage s pairs on
    const long long m = 1LL << s;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int l = k & (Q - 1);
      const int hh = k >> log_q;
      const int h = ((hh >> t) << (t + 1)) | (hh & ((1 << t) - 1));
      const int e = (h << log_q) + l;
      const int o = e + (Q << t);
      const long long j = ((long long)(h & ((1 << t) - 1)) << log_p) + rank * Q + l;  // position mod 2^s
      uint32_t xe[NL], xo[NL], w[NL];
#pragma unroll
      for (int q = 0; q < NL; q++) {
        xe[q] = part[q * P + e];
        xo[q] = part[q * P + o];
      }
      fe_load<NL>(w, tw + (m - 1 + j) * 2 * NL);
      butterfly(xe, xo, w);
#pragma unroll
      for (int q = 0; q < NL; q++) {
        part[q * P + e] = xe[q];
        part[q * P + o] = xo[q];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    uint32_t v[NL];
#pragma unroll
    for (int q = 0; q < NL; q++) v[q] = part[q * P + e];
    const long long pos = ((long long)(e >> log_q) << log_p) + rank * Q + (e & (Q - 1));
    fe_store<NL>(y + (first + pos) * 2 * NL, v);
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
  uint32_t xe[NL], xo[NL], w[NL];
  fe_load<NL>(xe, x + e * 2 * NL);
  fe_load<NL>(xo, x + o * 2 * NL);
  fe_load<NL>(w, tw + (m - 1 + j) * 2 * NL);
  butterfly(xe, xo, w);
  fe_store<NL>(x + e * 2 * NL, xe);
  fe_store<NL>(x + o * 2 * NL, xo);
}

}  // namespace

// The cluster size 2^log_c for `blocks` blocks of 2^log_b: the one that
// loads the busiest SM least (ceil(blocks C / SMs) / C CTAs' worth of a
// block), the smaller on a tie, with at least one element a CTA per
// cluster rank (log_b >= 2 log_c) and C <= 8.
static int cluster_log2(long long blocks, int log_b, int sms) {
  int best = 0;
  double best_load = (double)((blocks + sms - 1) / sms);
  for (int lc = 1; lc <= 3 && 2 * lc <= log_b; lc++) {
    const double load = (double)(((blocks << lc) + sms - 1) / sms) / (double)(1 << lc);
    if (load < best_load) {
      best = lc;
      best_load = load;
    }
  }
  return best;
}

// y = stages 0..log_b-1 of each 2^log_b block of the bit-reversed (within
// each 2^log_n transform) and scaled x.  x, y: [total, 16] int32, total a
// multiple of 2^log_n; scale: 16 int32 limbs, or null for none.
extern "C" int marlin_ntt_block_stages(const void* x, void* y, long long total, int log_n, int log_b,
                                       const void* tw, const void* scale, const void* params,
                                       void* stream) {
  if (log_b < 1 || log_b > kMaxLogB || log_n < log_b || log_n > 30 || total <= 0 ||
      (total & ((1LL << log_n) - 1)))
    return (int)cudaErrorInvalidValue;
  if (!params_match<F>(mod_params_from_words(static_cast<const uint32_t*>(params)), kFieldFr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(block_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kBlockSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = total >> log_b;
  const int log_c = cluster_log2(blocks, log_b, sms);
  const int P = 1 << (log_b - log_c);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(blocks << log_c));
  cfg.blockDim = dim3(P / 2 < kBlockThreads ? P / 2 : kBlockThreads);
  cfg.dynamicSmemBytes = (log_c ? 3 : 2) * (size_t)NL * P * sizeof(uint32_t);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1u << log_c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, block_stages_kernel, static_cast<const int32_t*>(x),
                           static_cast<int32_t*>(y), log_n, log_b, log_c,
                           static_cast<const int32_t*>(tw), static_cast<const int32_t*>(scale));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One DIT stage s over all of x ([total, 16] int32, 2^(s+1) | total); in place.
extern "C" int marlin_ntt_cross_stage(void* x, long long total, int s, const void* tw,
                                      const void* params, void* stream) {
  if (s < 0 || total <= 0 || (total & ((2LL << s) - 1))) return (int)cudaErrorInvalidValue;
  if (!params_match<F>(mod_params_from_words(static_cast<const uint32_t*>(params)), kFieldFr))
    return (int)cudaErrorInvalidValue;
  const long long half_total = total / 2;
  const unsigned blocks = (unsigned)((half_total + kThreads - 1) / kThreads);
  cross_stage_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(x), half_total, s, static_cast<const int32_t*>(tw));
  return (int)cudaGetLastError();
}
