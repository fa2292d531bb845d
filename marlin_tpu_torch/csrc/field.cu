// Kernels 1 and 2: elementwise field binop (mul / add / sub) and batch
// inversion over Fr or Fq of the curve the library is built for (mont.cuh:
// NL = 8 for every Fr and BN254's Fq, 12 for the other curves' Fq).
//
// Kernel 1 replaces marlin_tpu/ops/pallas/field.py::_build_binop (:88, the
// pallas_call at :101, reached through binop :183); kernel 2 replaces
// _build_inv / _inv_kernel (:112 / :70, pallas_call at :126), the TPU's
// Fermat chain x^(N-2), one element a lane.
//
// What bounds them on the H100: the binop reads two elements and writes one
// (192 B per Fr element in the int32 API layout) against 160 integer
// multiply instructions for a Montgomery product (tools/sass_count.py), so
// it is bound by memory bandwidth; the design keeps it to one pass with
// 16-byte vector loads and stores and no shared memory.
//
// The inversion.  A Fermat chain costs ~380 dependent products an element,
// and one thread's dependent Fr product takes ~0.7 us, so even one element
// took ~0.25 ms.  Kernel 2 is Montgomery's batch trick in one launch: each
// thread multiplies its elements (stride blockDim) into a running product,
// writing each prefix to `out` as scratch; the block multiplies the thread
// totals up a product tree in shared memory (limb-major, so a warp's nodes
// fall on distinct banks); one thread inverts the root with the binary
// extended Euclid of mont.cuh (fe_inv_binary: ~180 rounds of word
// subtractions and shifts for Fr, not 380 products); the inverse goes back
// down the tree (two products a node); and each thread walks its elements
// backwards, two products an element.  About 3 products an element plus one
// root a block: bound by operations at large n, and by the latency of the
// root and the tree's depth at the prove's sizes.  The grid is as many
// blocks as fit on the card at once (cudaOccupancy...), each thread taking
// as many elements as that needs, so a launch runs in one wave.  A zero
// enters the products as one and comes out as zero (the TPU's 0 -> 0).
// Both kernels run on the compile-time moduli of mont.cuh.  Each entry takes
// the field explicitly (kFieldFr or kFieldFq: BN254's Fr and Fq have the same
// width, so the width cannot say which) and refuses a context whose words,
// field or curve do not match the traits it would run.
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

constexpr int kInvThreads = 128;

// Element i of the thread's stride-T chunk; elements past n stand for one.
template <class F>
__global__ void __launch_bounds__(kInvThreads) batch_inv_kernel(const int32_t* __restrict__ x,
                                                                int32_t* __restrict__ out, long long n,
                                                                int per_thread) {
  constexpr int NL = F::NL;
  constexpr int T2 = 2 * kInvThreads;
  // the product tree, limb-major: node 1 is the root, node h + t (t < h)
  // the t-th of level h, nodes T .. 2T - 1 the thread totals
  __shared__ uint32_t tree[NL * T2];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * T * per_thread + t;

  // 1. running product of the thread's nonzero elements; the prefix through
  //    element j goes to out[j] for the backward walk
  uint32_t acc[NL], v[NL];
  fe_set_one<F>(acc);
  bool any = false;
#pragma unroll 1
  for (int j = 0; j < per_thread; j++) {
    const long long i = first + (long long)j * T;
    if (i >= n) break;
    fe_load<NL>(v, x + i * 2 * NL);
    if (!mp_is_zero<NL>(v)) {
      if (any) {
        fe_mul<F>(acc, acc, v);
      } else {
        fe_copy<NL>(acc, v);
      }
      any = true;
    }
    if (j + 1 < per_thread) fe_store<NL>(out + i * 2 * NL, acc);
  }

  // 2. up the tree, invert the root, back down: node T + t ends as acc^-1
#pragma unroll
  for (int q = 0; q < NL; q++) tree[q * T2 + T + t] = acc[q];
  __syncthreads();
#pragma unroll 1
  for (int h = T >> 1; h >= 1; h >>= 1) {
    if (t < h) {
      const int node = h + t;
      uint32_t a[NL], b[NL];
#pragma unroll
      for (int q = 0; q < NL; q++) {
        a[q] = tree[q * T2 + 2 * node];
        b[q] = tree[q * T2 + 2 * node + 1];
      }
      fe_mul<F>(a, a, b);
#pragma unroll
      for (int q = 0; q < NL; q++) tree[q * T2 + node] = a[q];
    }
    __syncthreads();
  }
  if (t == 0) {
    uint32_t root[NL];
#pragma unroll
    for (int q = 0; q < NL; q++) root[q] = tree[q * T2 + 1];
    fe_inv_binary<F>(root, root);
#pragma unroll
    for (int q = 0; q < NL; q++) tree[q * T2 + 1] = root[q];
  }
  __syncthreads();
#pragma unroll 1
  for (int h = 1; h < T; h <<= 1) {
    if (t < h) {
      const int node = h + t;
      uint32_t inv[NL], a[NL], b[NL];
#pragma unroll
      for (int q = 0; q < NL; q++) {
        inv[q] = tree[q * T2 + node];
        a[q] = tree[q * T2 + 2 * node];
        b[q] = tree[q * T2 + 2 * node + 1];
      }
      fe_mul<F>(a, inv, a);  // the right child's inverse
      fe_mul<F>(b, inv, b);  // the left child's inverse
#pragma unroll
      for (int q = 0; q < NL; q++) {
        tree[q * T2 + 2 * node] = b[q];
        tree[q * T2 + 2 * node + 1] = a[q];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NL; q++) acc[q] = tree[q * T2 + T + t];

  // 3. backwards: element j's inverse is (prefix j)^-1 * (prefix j-1); then
  //    acc becomes (prefix j-1)^-1
#pragma unroll 1
  for (int j = per_thread - 1; j >= 0; j--) {
    const long long i = first + (long long)j * T;
    if (i >= n) continue;
    fe_load<NL>(v, x + i * 2 * NL);
    uint32_t r[NL];
    if (mp_is_zero<NL>(v)) {
#pragma unroll
      for (int q = 0; q < NL; q++) r[q] = 0u;
    } else if (j == 0) {
      fe_copy<NL>(r, acc);
    } else {
      fe_load<NL>(r, out + (i - T) * 2 * NL);
      fe_mul<F>(r, acc, r);
      fe_mul<F>(acc, acc, v);
    }
    fe_store<NL>(out + i * 2 * NL, r);
  }
}

// Blocks of up to kInvThreads threads (a power of two), as many as are
// resident on the card at once, each thread taking enough elements for n.
template <class F>
cudaError_t launch_inv(const int32_t* x, int32_t* out, long long n, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, batch_inv_kernel<F>, kInvThreads, 0);
  if (err != cudaSuccess) return err;
  int threads = 1;
  while (threads < kInvThreads && threads < n) threads <<= 1;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long per_thread = (n + threads * resident - 1) / (threads * resident);
  const long long chunk = threads * per_thread;
  const unsigned blocks = (unsigned)((n + chunk - 1) / chunk);
  batch_inv_kernel<F><<<blocks, threads, 0, s>>>(x, out, n, (int)per_thread);
  return cudaGetLastError();
}

template <class F>
cudaError_t launch_binop(int kind, const int32_t* a, const int32_t* b, int32_t* out,
                         long long n, cudaStream_t s) {
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

// field: kFieldFr or kFieldFq.  A context (params) of another field, modulus
// or curve is refused with cudaErrorInvalidValue before any launch.
extern "C" int marlin_field_binop(int kind, int field, const void* a, const void* b, void* out,
                                  long long n, const void* params, void* stream) {
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pa = static_cast<const int32_t*>(a);
  const int32_t* pb = static_cast<const int32_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  if (field == kFieldFr && params_match<FrTraits>(p, kFieldFr))
    return n <= 0 ? 0 : (int)launch_binop<FrTraits>(kind, pa, pb, po, n, s);
  if (field == kFieldFq && params_match<FqTraits>(p, kFieldFq))
    return n <= 0 ? 0 : (int)launch_binop<FqTraits>(kind, pa, pb, po, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int marlin_field_inv(int field, const void* x, void* out, long long n,
                                const void* params, void* stream) {
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* px = static_cast<const int32_t*>(x);
  int32_t* po = static_cast<int32_t*>(out);
  if (field == kFieldFr && params_match<FrTraits>(p, kFieldFr))
    return n <= 0 ? 0 : (int)launch_inv<FrTraits>(px, po, n, s);
  if (field == kFieldFq && params_match<FqTraits>(p, kFieldFq))
    return n <= 0 ? 0 : (int)launch_inv<FqTraits>(px, po, n, s);
  return (int)cudaErrorInvalidValue;
}

// The curve this library was compiled for (-DMARLIN_CURVE_<NAME>): ops/cuda.py
// compares it with the active curve when it loads the library.
extern "C" const char* marlin_curve_id() { return MARLIN_CURVE_NAME; }
