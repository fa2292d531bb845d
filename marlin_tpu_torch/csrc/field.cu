// Kernels 1 and 2: elementwise field binop (mul / add / sub) and batch
// inversion over Fr or Fq of the curve the library is built for (mont.cuh:
// NL = 8 for every curve's Fr and BN254's Fq, 12 for the other curves' Fq;
// test_wide750 has an Fr of 24 words and no Fq, and its library instantiates
// the Fr kernels only).
//
// Kernel 1 replaces marlin_tpu/ops/pallas/field.py::_build_binop (:88, the
// pallas_call at :101, reached through binop :183); kernel 2 replaces
// _build_inv / _inv_kernel (:112 / :70, pallas_call at :126), the TPU's
// Fermat chain x^(N-2), one element a lane.
//
// What bounds the binop on the H100: it reads two elements and writes one
// (192 B per 8-word element in the int32 API layout, 576 B at 24 words)
// against 160 integer multiplies for an 8-word Montgomery product and 1,127
// for a 24-word one (tools/sass_count.py), so it is bound by memory
// bandwidth, at 24 words only just (the operations take 78% of the bytes'
// time).  Its design (redesigned for the H100):
// - Broadcast operands are read in place.  Each operand comes with a row
//   map: element i reads row (i / div) % period of it (period 0: row i), so
//   a [1, L] scalar, a [len, L] row against [m, len, L] or a [k, 1, L]
//   column against [k, m, L] is never copied to the full shape
//   (ops/bigint.py::row_map derives div and period from the shapes).
// - The grid is sized for the card: blocks of 32-128 threads (smaller for a
//   short launch, so that 4,096 elements still spread over ~128 SMs), as
//   many as are resident at once (cudaOccupancy..., the SM count), each
//   looping over tiles of one element a thread.
// - Two bodies.  binop_kernel loads each element into registers with
//   16-byte loads (a warp's load instruction touches 32 rows 8 NL bytes
//   apart).  binop_staged_kernel stages the operand tiles in shared memory
//   by cp.async, each warp instruction copying contiguous 16-byte pieces,
//   double-buffered across the tile loop where the blocks loop (the next
//   tile's copies in flight while this tile's products run), single-
//   buffered where every tile has a resident block of its own (the other
//   blocks on the SM overlap it, and the smaller tile lets more of them
//   reside); the results go back through shared memory and out in
//   coalesced pieces.  The caller picks the body
//   (ops/bigint.py::BINOP_STAGED_WORDS, by measurement at each width).
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

constexpr int kThreads = 256;        // the direct body's largest block
constexpr int kStagedThreads = 128;  // the staged body's

// Row `i` of an operand read through its row map (see the top of the file).
struct RowMap {
  uint32_t div, period;
};

__device__ __forceinline__ uint32_t map_row(RowMap m, uint32_t i) {
  return m.period == 0 ? i : m.period == 1 ? 0u : (i / m.div) % m.period;
}

template <class F, int KIND>
__device__ __forceinline__ void binop_apply(uint32_t r[F::NL], const uint32_t x[F::NL], const uint32_t y[F::NL]) {
  if (KIND == 0) {
    fe_mul<F>(r, x, y);
  } else if (KIND == 1) {
    fe_add<F>(r, x, y);
  } else {
    fe_sub<F>(r, x, y);
  }
}

// The Montgomery product a * b of mont.cuh's fe_mul with b read a word at
// a time from its shared-memory cells as the rows of the product take them
// (the staged body's b never occupies NL registers of its own).
template <class F>
__device__ __forceinline__ void fe_mul_cells(uint32_t r[F::NL], const uint32_t a[F::NL], const int4* b) {
  constexpr int NL = F::NL;
  const int32_t* w = reinterpret_cast<const int32_t*>(b);  // 16-bit limbs, two a word
  uint32_t even[NL], odd[NL];
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < NL; i += 2) {
    top = mad_n_redc<F>(even, odd, a, (uint32_t)w[2 * i] | ((uint32_t)w[2 * i + 1] << 16), top, i == 0);
    top = mad_n_redc<F>(odd, even, a, (uint32_t)w[2 * i + 2] | ((uint32_t)w[2 * i + 3] << 16), top, false);
  }
  even[0] = ptx::add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < NL - 1; k++) even[k] = ptx::addc_cc(even[k], odd[k + 1]);
  even[NL - 1] = ptx::addc(even[NL - 1], 0u);
  fe_reduce_once<F>(r, even);
}

// One element a thread in a grid-stride loop, operands into registers.
template <class F, int KIND>
__global__ void __launch_bounds__(kThreads) binop_kernel(const int32_t* __restrict__ a, RowMap am,
                                                         const int32_t* __restrict__ b, RowMap bm,
                                                         int32_t* __restrict__ out, uint32_t n) {
  constexpr int NL = F::NL;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    uint32_t x[NL], y[NL], r[NL];
    fe_load<NL>(x, a + (size_t)map_row(am, i) * 2 * NL);
    fe_load<NL>(y, b + (size_t)map_row(bm, i) * 2 * NL);
    binop_apply<F, KIND>(r, x, y);
    fe_store<NL>(out + (size_t)i * 2 * NL, r);
  }
}

// Shared memory of the staged body for T threads and nbuf buffers: both
// operands' tiles of T elements, [buffer][operand][T][cell_stride] 16-byte
// cells (mont.cuh), and one element a scalar operand (period 1) is read
// from.
template <int NL>
constexpr size_t staged_smem(int T, int nbuf) {
  return ((size_t)nbuf * 2 * T * cell_stride<NL>() + 2 * (NL / 2)) * 16;
}

// The tiles of T consecutive elements, tile blockIdx.x + k gridDim.x in
// iteration k.  With two buffers the copies of tile k+1 are issued before
// tile k's products; with one (a grid of one tile a block, where the other
// resident blocks are what overlaps) each tile's copies come first.
template <class F, int KIND>
__global__ void __launch_bounds__(kStagedThreads) binop_staged_kernel(const int32_t* __restrict__ a, RowMap am,
                                                                const int32_t* __restrict__ b, RowMap bm,
                                                                int32_t* __restrict__ out, uint32_t n,
                                                                int nbuf) {
  constexpr int NL = F::NL;
  constexpr int PC = NL / 2;  // 16-byte pieces an element
  constexpr int CS = cell_stride<NL>();
  extern __shared__ int4 cells[];
  const uint32_t T = blockDim.x;
  const int t = threadIdx.x;
  const uint32_t tiles = (n + T - 1) / T;
  int4* scalar = cells + nbuf * 2 * CS * T;  // [operand][piece]
  const int32_t* src[2] = {a, b};
  const RowMap map[2] = {am, bm};
#pragma unroll
  for (int op = 0; op < 2; op++)
    if (map[op].period == 1 && t < PC) cp_async16(scalar + op * PC + t, src[op] + 4 * t);
  auto issue = [&](uint32_t tile, int buf) {
    if (tile < tiles) {
#pragma unroll
      for (int op = 0; op < 2; op++) {
        if (map[op].period == 1) continue;
        int4* dst = cells + (2 * buf + op) * CS * T;
        for (uint32_t p = t; p < PC * T; p += T) {
          const uint32_t r = p / PC, q = p - r * PC;
          const uint32_t i = tile * T + r;
          if (i < n) cp_async16(dst + r * CS + q, src[op] + (size_t)map_row(map[op], i) * 2 * NL + 4 * q);
        }
      }
    }
    cp_async_commit();
  };
  if (nbuf == 2) issue(blockIdx.x, 0);
  int buf = 0;
  for (uint32_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= nbuf - 1) {
    if (nbuf == 2) {
      issue(tile + gridDim.x, buf ^ 1);
      cp_async_wait<1>();
    } else {
      issue(tile, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    int4* ta = cells + 2 * buf * CS * T;
    int4* tb = ta + CS * T;
    const uint32_t i = tile * T + t;
    if (i < n) {
      uint32_t x[NL], r[NL];
      fe_load_cells<NL>(x, map[0].period == 1 ? scalar : ta + t * CS);
      const int4* yc = map[1].period == 1 ? scalar + PC : tb + t * CS;
      if (KIND == 0) {
        fe_mul_cells<F>(r, x, yc);
      } else {
        uint32_t y[NL];
        fe_load_cells<NL>(y, yc);
        binop_apply<F, KIND>(r, x, y);
      }
      fe_store_cells<NL>(ta + t * CS, r);  // this thread's own cells of a
    }
    __syncthreads();
    int4* dst = reinterpret_cast<int4*>(out) + (size_t)tile * T * PC;
    for (uint32_t p = t; p < PC * T; p += T) {
      const uint32_t r = p / PC, q = p - r * PC;
      if (tile * T + r < n) dst[p] = ta[r * CS + q];
    }
    __syncthreads();  // the tile is out before the next copies into this buffer
  }
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

// Per device: the SM count, and whether each staged instance may take
// more than 48 KB of dynamic shared memory.
constexpr int kMaxDevices = 64;

inline cudaError_t sm_count(int* sms) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (cached[dev] == 0) err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  *sms = cached[dev];
  return err;
}

// Resident blocks an SM of `kernel` at T threads and `smem` bytes, into
// `slot` once (0: not yet asked); a kernel whose largest launch takes
// max_smem > 48 KB of dynamic shared memory is opened to it once a device.
template <class K>
cudaError_t occupancy(K kernel, int T, size_t smem, size_t max_smem, bool& opened, int& slot) {
  if (max_smem > 48 * 1024 && !opened) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
    if (err != cudaSuccess) return err;
    opened = true;
  }
  if (slot == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&slot, kernel, T, smem);
    if (err != cudaSuccess) return err;
    if (slot == 0) slot = 1;
  }
  return cudaSuccess;
}

// Resident blocks an SM of the binop body <F, KIND, STAGED> at T threads
// (and nbuf buffers), cached for each block size (32-256; the kernels run
// on one model of card).
template <class F, int KIND, bool STAGED>
cudaError_t resident_per_sm(int T, int nbuf, int* per_sm) {
  static int cached[4][2];
  static bool opened[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  bool unseen = false;  // a device past kMaxDevices is opened every call
  bool& open = dev < kMaxDevices ? opened[dev] : unseen;
  int& slot = cached[T >= 256 ? 3 : T >= 128 ? 2 : T >= 64 ? 1 : 0][nbuf - 1];
  if constexpr (STAGED) {
    err = occupancy(binop_staged_kernel<F, KIND>, T, staged_smem<F::NL>(T, nbuf),
                    staged_smem<F::NL>(kStagedThreads, 2), open, slot);
  } else {
    err = occupancy(binop_kernel<F, KIND>, T, 0, 0, open, slot);
  }
  *per_sm = slot;
  return err;
}

template <class F, int KIND, bool STAGED>
cudaError_t launch_body(const int32_t* a, RowMap am, const int32_t* b, RowMap bm, int32_t* out, uint32_t n,
                        cudaStream_t s) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // the block: a power of two in [32, kThreads] near n / sms elements
  int T = 32;
  while (T < (STAGED ? kStagedThreads : kThreads) && (long long)T * sms < n) T <<= 1;
  err = resident_per_sm<F, KIND, STAGED>(T, 1, &per_sm);
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)n + T - 1) / T;
  // two buffers where the resident blocks of one cannot take every tile at once
  const int nbuf = STAGED && tiles > (long long)sms * per_sm ? 2 : 1;
  if (nbuf == 2) {
    err = resident_per_sm<F, KIND, STAGED>(T, 2, &per_sm);
    if (err != cudaSuccess) return err;
  }
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  if constexpr (STAGED) {
    binop_staged_kernel<F, KIND><<<blocks, T, staged_smem<F::NL>(T, nbuf), s>>>(a, am, b, bm, out, n, nbuf);
  } else {
    binop_kernel<F, KIND><<<blocks, T, 0, s>>>(a, am, b, bm, out, n);
  }
  return cudaGetLastError();
}

template <class F, int KIND>
cudaError_t launch_kind(const int32_t* a, RowMap am, const int32_t* b, RowMap bm, int32_t* out, uint32_t n,
                        bool staged, cudaStream_t s) {
  return staged ? launch_body<F, KIND, true>(a, am, b, bm, out, n, s)
                : launch_body<F, KIND, false>(a, am, b, bm, out, n, s);
}

template <class F>
cudaError_t launch_binop(int kind, const int32_t* a, RowMap am, const int32_t* b, RowMap bm, int32_t* out,
                         uint32_t n, bool staged, cudaStream_t s) {
  switch (kind) {
    case 0: return launch_kind<F, 0>(a, am, b, bm, out, n, staged, s);
    case 1: return launch_kind<F, 1>(a, am, b, bm, out, n, staged, s);
    case 2: return launch_kind<F, 2>(a, am, b, bm, out, n, staged, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// field: kFieldFr or kFieldFq.  A context (params) of another field, modulus
// or curve is refused with cudaErrorInvalidValue before any launch, and so
// is every kFieldFq call to a library of a curve with no Fq (test_wide750).
// a_div, a_period, b_div, b_period: the operands' row maps (period 0: row
// i; else row (i / div) % period, div >= 1); n < 2^31.  staged: the body.
extern "C" int marlin_field_binop(int kind, int field, const void* a, const void* b, void* out, long long n,
                                  long long a_div, long long a_period, long long b_div, long long b_period,
                                  int staged, const void* params, void* stream) {
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  if (n < 0 || n >= (1LL << 31) || a_div < 1 || b_div < 1 || a_div >= (1LL << 31) || b_div >= (1LL << 31) ||
      a_period < 0 || b_period < 0 || a_period >= (1LL << 31) || b_period >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const RowMap am{(uint32_t)a_div, (uint32_t)a_period}, bm{(uint32_t)b_div, (uint32_t)b_period};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pa = static_cast<const int32_t*>(a);
  const int32_t* pb = static_cast<const int32_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  if (field == kFieldFr && params_match<FrTraits>(p, kFieldFr))
    return n == 0 ? 0 : (int)launch_binop<FrTraits>(kind, pa, am, pb, bm, po, (uint32_t)n, staged != 0, s);
#if MARLIN_HAS_FQ
  if (field == kFieldFq && params_match<FqTraits>(p, kFieldFq))
    return n == 0 ? 0 : (int)launch_binop<FqTraits>(kind, pa, am, pb, bm, po, (uint32_t)n, staged != 0, s);
#endif
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
#if MARLIN_HAS_FQ
  if (field == kFieldFq && params_match<FqTraits>(p, kFieldFq))
    return n <= 0 ? 0 : (int)launch_inv<FqTraits>(px, po, n, s);
#endif
  return (int)cudaErrorInvalidValue;
}

// The curve this library was compiled for (-DMARLIN_CURVE_<NAME>): ops/cuda.py
// compares it with the active curve when it loads the library.
extern "C" const char* marlin_curve_id() { return MARLIN_CURVE_NAME; }
