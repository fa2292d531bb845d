// Kernel 3: radix-2 decimation-in-time NTT stages over Fr (8 words for every
// curve of the port, 24 for test_wide750), batched over any number of
// equal-size transforms laid end to end.  A mixed-radix transform of
// 3^s 2^k points (ops/ntt.py) runs its 3^s inner radix-2 transforms of 2^k
// points as one such batch.
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
// (b) ntt_cross_stages: the stages past the block, a group [s0, s1) of
//     consecutive stages a launch (redesigned for the H100; it was one launch
//     and one pass over global memory a stage).  The R = 2^(s1-s0) elements
//     low + 2^s0 t + 2^s1 high (t < R) are closed under those stages, so a
//     CTA loads T adjacent `low` positions of all R rows (each row T
//     contiguous elements) into shared memory with cp.async, runs the
//     group's stages there with one butterfly a thread a stage, its twiddles
//     read from the table through the read-only path, and writes the tile
//     back in place.  The tile is R T elements of 16-byte pieces, an odd
//     number of cells apart (mont.cuh fe_load_cells), so neither the
//     copies nor a warp's butterflies meet bank conflicts; R T <= 2^10 at
//     8 words and 2^9 at 24 (kCrossSmem, 64 and 96 KB of pieces) at
//     T = min(8, 2^s0).  The tile's
//     twiddles (T (R - 1) table rows) come into shared memory in the same
//     cp.async group, so no stage waits on a global load.
//     ops/ntt.py::cross_groups splits the stages into groups that fit, so
//     the six cross stages of a 2^16 transform (R = 64) are one launch, not
//     six; the host narrows T, down to 2 (128-byte rows at 8 words), until
//     the grid has two CTAs an SM.
//
// Stage s pairs e = g*2m + j with o = e + m (m = 2^s, j < m) and computes
// x[e], x[o] = x[e] + w*x[o], x[e] - w*x[o] with w = TW_s[j] = w_{2m}^j, the
// twiddle convention of marlin_tpu/ops/ntt.py::_plan.  Twiddles arrive as
// data: one [n-1, 2 NL] table per (n, direction), stage s at rows
// [2^s - 1, 2^(s+1) - 1), so one compiled kernel serves every size, forward
// and inverse.
//
// What bounds it on the H100: a butterfly is one Montgomery product (160
// integer multiply instructions at 8 words, 1,127 at 24) and an add and a
// sub on 128 bytes of element traffic per stage at 8 words, so a stage on
// its own is bound by memory bandwidth; (b) takes a group of stages for one
// read and one write of the elements.  (a), with log2(B) = 10 stages per
// global round trip, is bound by integer multiplies: a 2^10 block's 5,120
// products keep one SM busy for ~26 us on the H100, so (a) is as fast as
// the number of SMs its grid covers, which the clusters raise.  (a) keeps
// its elements and the twiddle rows of its CTA's own stages in shared
// memory as 32-bit limbs, limb-major ([NL][P]), so the 32 elements of a
// warp's butterflies fall on 32 banks (two ways at most in stages 0-4); 64
// KB of dynamic shared memory at B = 2^10 and C = 1.  The cluster stages
// read their twiddles from global memory.
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
// (a)'s threads, one butterfly each per pass, under __launch_bounds__(T, 1):
// 512 at 8 words (a 128-register cap, enough for a butterfly of 8 words);
// 256 at 24 words, whose butterfly holds xe, xo, w and t (96 words) and the
// product's two 24-word accumulators, more than 128 registers, under the
// 255-register cap of 256 threads.  The block size B = 2^log_b (<= 2^10) is
// the caller's (ops/ntt.py BLOCK_LOG2, by width).
constexpr int kBlockThreads = NL > 12 ? 256 : 512;
// (b)'s threads: a butterfly each at 8 words; two at 24, whose ~170
// registers a thread allow 2-3 CTAs of 128 an SM
constexpr int kCrossThreads = NL > 12 ? 128 : 256;
// (b)'s tile budget (ops/ntt.py CROSS_SMEM_BYTES): 2^10 elements at 8
// words (64 KB), 2^9 at 24 (96 KB), at T = min(8, 2^s0); the twiddles take
// up to as much again
constexpr size_t kCrossSmem = 96 * 1024;
constexpr int kPieces = NL / 2;  // 16-byte pieces an element
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

// Stages s0 .. s0+g-1 of one tile: 2^g rows of T = 2^log_t elements, row t
// at base + 2^s0 t, base = high 2^(s0+g) + T lowblock (the CTA's index).
// The tile's twiddles come in with its elements: stage s0 + sp needs rows
// m < 2^sp of T consecutive table rows, 2^(s0+sp) - 1 + low + 2^s0 m.
__global__ void __launch_bounds__(kCrossThreads)
    cross_stages_kernel(int32_t* __restrict__ x, int s0, int g, int log_t, const int32_t* __restrict__ tw) {
  constexpr int CS = cell_stride<NL>();
  extern __shared__ int4 cells[];  // [E][CS] elements, then [TWN][CS] twiddles (mont.cuh)
  const int log_e = g + log_t;
  const int E = 1 << log_e;
  const int T = 1 << log_t;
  const int TWN = ((1 << g) - 1) << log_t;
  int4* twc = cells + CS * E;
  const long long c = blockIdx.x;
  const long long low = (c & ((1LL << (s0 - log_t)) - 1)) << log_t;  // the tile's first low position
  const long long base = ((c >> (s0 - log_t)) << (s0 + g)) + low;
  for (int p = threadIdx.x; p < kPieces * E; p += blockDim.x) {
    const int pos = p / kPieces, q = p - pos * kPieces;
    const long long el = base + ((long long)(pos >> log_t) << s0) + (pos & (T - 1));
    cp_async16(cells + pos * CS + q, x + el * 2 * NL + 4 * q);
  }
  for (int p = threadIdx.x; p < kPieces * TWN; p += blockDim.x) {
    const int pos = p / kPieces, q = p - pos * kPieces;
    const int r = pos >> log_t;  // stage sp's rows are 2^sp - 1 .. 2^(sp+1) - 2
    const int sp = 31 - __clz(r + 1);
    const long long row = (1LL << (s0 + sp)) - 1 + low + ((long long)(r + 1 - (1 << sp)) << s0) + (pos & (T - 1));
    cp_async16(twc + pos * CS + q, tw + row * 2 * NL + 4 * q);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int sp = 0; sp < g; sp++) {
    for (int k = threadIdx.x; k < E / 2; k += blockDim.x) {
      const int l = k & (T - 1);
      const int h = k >> log_t;
      const int re = ((h >> sp) << (sp + 1)) | (h & ((1 << sp) - 1));  // the even row
      const int pe = (re << log_t) | l;
      const int po = pe + (1 << (sp + log_t));
      const int pw = (((1 << sp) - 1 + (re & ((1 << sp) - 1))) << log_t) | l;
      uint32_t xe[NL], xo[NL], w[NL];
      fe_load_cells<NL>(xe, cells + pe * CS);
      fe_load_cells<NL>(xo, cells + po * CS);
      fe_load_cells<NL>(w, twc + pw * CS);
      butterfly(xe, xo, w);
      fe_store_cells<NL>(cells + pe * CS, xe);
      fe_store_cells<NL>(cells + po * CS, xo);
    }
    __syncthreads();
  }
  int4* out = reinterpret_cast<int4*>(x);
  for (int p = threadIdx.x; p < kPieces * E; p += blockDim.x) {
    const int pos = p / kPieces, q = p - pos * kPieces;
    const long long el = base + ((long long)(pos >> log_t) << s0) + (pos & (T - 1));
    out[el * kPieces + q] = cells[pos * CS + q];
  }
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
// each 2^log_n transform) and scaled x.  x, y: [total, 2 NL] int32, total a
// multiple of 2^log_n; scale: 2 NL int32 limbs, or null for none.
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

// Stages [s0, s1) over all of x ([total, 2 NL] int32, 2^s1 | total), in
// place; tw the transform's twiddle table.  Refused (cudaErrorInvalidValue)
// unless 2^(s1-s0) rows of min(8, 2^s0) elements fit kCrossSmem.
extern "C" int marlin_ntt_cross_stages(void* x, long long total, int s0, int s1, const void* tw,
                                       const void* params, void* stream) {
  const int g = s1 - s0;
  const int min_log_t = s0 < 3 ? s0 : 3;
  if (s0 < 0 || g < 1 || s1 > 30 || total <= 0 || (total & ((1LL << s1) - 1)) ||
      ((size_t)1 << (g + min_log_t)) * kPieces * 16 > kCrossSmem)
    return (int)cudaErrorInvalidValue;
  if (!params_match<F>(mod_params_from_words(static_cast<const uint32_t*>(params)), kFieldFr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // T: the widest that fits, narrowed to two elements (a 128-byte row at 8
  // words) while there are fewer than two CTAs an SM
  int log_t = s0;
  while (((size_t)1 << (g + log_t)) * kPieces * 16 > kCrossSmem) log_t--;
  while (log_t > (s0 < 1 ? s0 : 1) && (total >> (g + log_t)) < 2LL * sms) log_t--;
  const int E = 1 << (g + log_t);
  const int TWN = ((1 << g) - 1) << log_t;
  const size_t smem = (size_t)(E + TWN) * cell_stride<NL>() * 16;  // <= 211 KB
  // dynamic shared memory past 48 KB, opened as far as a launch needs, a device at a time
  static size_t opened[64];
  if (smem > 48 * 1024 && (dev >= 64 || smem > opened[dev])) {
    err = cudaFuncSetAttribute(cross_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opened[dev] = smem;
  }
  const unsigned blocks = (unsigned)(total >> (g + log_t));
  const int threads = E / 2 < kCrossThreads ? E / 2 : kCrossThreads;
  cross_stages_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(x), s0, g, log_t, static_cast<const int32_t*>(tw));
  return (int)cudaGetLastError();
}
