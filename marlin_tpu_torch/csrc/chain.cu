// The ladder (kernel 4's scalar multiple) and the window combine (kernel 6)
// of the G1 MSMs, as short chains of parallel steps, over the Fq of the
// curve the library is built for (group.cuh, mont.cuh).
//
// scalar_mul_kernel runs the MSB-first double-and-add of
// marlin_tpu/ops/curve_device.py::scalar_mul_batch (:282), which calls
// marlin_tpu/ops/pallas/curve.py::_build (pallas_call at :201) three times a
// bit, in one launch: from the identity (0, 1, 0), for bit k = num_bits-1
// down to 0, acc = double(acc) with the doubling kernel's rule, then
// acc = add(acc, P) where bit k is set (the TPU adds at every bit and
// selects; the limbs kept are the same).  combine_kernel replaces
// _build_combine / _combine_kernel (pallas_call at :476, body at :427-461):
// Σ_w 2^(c w) T_w over a classic Pippenger's W <= 128 window sums, window w
// doubled c w times with the doubling rule, then a halving tree of complete
// adds in shared memory (at level s, window w < s takes w + s if it exists).
//
// What bounds them on the H100: neither bytes nor the card's multiply rate,
// but the length of one chain of dependent steps on an SM that is almost
// idle: 255 doublings and about 128 adds a point for the ladder, 250
// doublings for the last window of the combine at c = 10, W = 26.  One Fq
// product is one thread's stream of instructions (~376 at NL = 12), most of
// them IMAD.WIDE with carry, and a warp issues them for all its lanes at once.
// The design shortens what a chain waits for:
// * each formula runs as levels of independent products: dbl-2009-l's 7
//   products in 3 levels ({X^2, Y^2, Y Z}, {B^2, (X + B)^2, (3A)^2},
//   {E (D - X3)}), the complete add-2007-bl's 16 in 5 ({Z1^2, Z2^2, Y1 Z2,
//   Y2 Z1}, {X1 Z2Z2, X2 Z1Z1, S1, S2}, {(Z1 + Z2)^2, (2H)^2, r^2},
//   {Z3, J, V}, {S1 J, r (V - X3)}); the adds and subs between levels run
//   on every lane alike;
// * four lanes run one chain (Chain): an aligned group of four lanes of a
//   warp holds one state (the point and the formula's values, alike in
//   every lane); lane k computes product k of a level and __shfl_sync hands
//   every lane all of them, so a level costs one product's instruction
//   stream.  The rare branches (an identity operand, P == Q, Y or Z = 0)
//   are decided on that common state, so a group never diverges within
//   itself; the shuffles name the group's four lanes only, so the groups of
//   a warp may.  One thread running a level's products in turn, for ptxas
//   to interleave, gains nothing: the PTX carry flag orders every chain
//   (PERF.md §6);
// * the ladder runs one warp a block and puts as few points in a warp as
//   leave one warp to each SM: a warp of several points adds at every bit
//   where any of them has the bit set, and a second warp on an SM slows
//   both, as measured (PERF.md §6); the likely cause is the SM's
//   instruction cache, which the kernel's ~200 KB of inlined code does not
//   fit.
// The formulas and their order are group.cuh's and the plain versions'
// (ops/curve.py: scalar_mul_plain, combine_windows_plain), and products are
// canonical, so the limbs are the same.  This source is built at -O3 with no
// register cap (ops/cuda.py): on the path the kernels run a few hundred
// threads, and a large ladder (the SRS's powers) loses little with three
// blocks an SM.
//
// C interface (ctypes): every entry returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "group.cuh"

namespace {

using namespace g1;
constexpr int kLanes = 4;           // lanes a chain (Chain)
constexpr int kLadderThreads = 32;  // one warp a block
constexpr int kCombineMax = 128;    // the most window sums (ops/curve.py COMBINE_MAX)
constexpr int kCombineGroups = 64;  // lane groups of the combine's block, one or two windows each
constexpr int kScalarLimbs = 2 * FrTraits::NL;  // Fr scalars: 16 limbs of 16 bits

// kLanes = 4 lanes a chain: lane k computes product min(k, K - 1) of the level,
// then every lane takes all K results from their lanes.
struct Chain {
  int k;          // this lane's place in its group
  unsigned mask;  // the group's four lanes
  __device__ explicit Chain(int tid) : k(tid & 3), mask(0xFu << ((tid & 31) & ~3)) {}
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  template <int K>
  __device__ __forceinline__ void level(uint32_t* const (&r)[K], const uint32_t* const (&a)[K],
                                        const uint32_t* const (&b)[K]) const {
    if constexpr (K == 1) {
      fe_mul<Fq>(r[0], a[0], b[0]);  // the same product on every lane
    } else {
      uint32_t x[NL], y[NL], t[NL];
#pragma unroll
      for (int j = 0; j < NL; j++) {
        x[j] = a[K - 1][j];
        y[j] = b[K - 1][j];
#pragma unroll
        for (int i = 0; i < K - 1; i++) {
          if (k == i) x[j] = a[i][j], y[j] = b[i][j];
        }
      }
      fe_mul<Fq>(t, x, y);
#pragma unroll
      for (int i = 0; i < K; i++) {
#pragma unroll
        for (int j = 0; j < NL; j++) r[i][j] = __shfl_sync(mask, t[j], i, 4);
      }
    }
  }
};

// One level of 1-4 independent products r_i = a_i b_i.  Every operand is
// read before any result is written, so a result may overwrite an operand.
__device__ __forceinline__ void mul(const Chain& ch, uint32_t* r0, const uint32_t* a0, const uint32_t* b0) {
  uint32_t* const r[1] = {r0};
  const uint32_t* const a[1] = {a0};
  const uint32_t* const b[1] = {b0};
  ch.level<1>(r, a, b);
}

__device__ __forceinline__ void mul(const Chain& ch, uint32_t* r0, const uint32_t* a0, const uint32_t* b0,
                                    uint32_t* r1, const uint32_t* a1, const uint32_t* b1) {
  uint32_t* const r[2] = {r0, r1};
  const uint32_t* const a[2] = {a0, a1};
  const uint32_t* const b[2] = {b0, b1};
  ch.level<2>(r, a, b);
}

__device__ __forceinline__ void mul(const Chain& ch, uint32_t* r0, const uint32_t* a0, const uint32_t* b0,
                                    uint32_t* r1, const uint32_t* a1, const uint32_t* b1,
                                    uint32_t* r2, const uint32_t* a2, const uint32_t* b2) {
  uint32_t* const r[3] = {r0, r1, r2};
  const uint32_t* const a[3] = {a0, a1, a2};
  const uint32_t* const b[3] = {b0, b1, b2};
  ch.level<3>(r, a, b);
}

__device__ __forceinline__ void mul(const Chain& ch, uint32_t* r0, const uint32_t* a0, const uint32_t* b0,
                                    uint32_t* r1, const uint32_t* a1, const uint32_t* b1,
                                    uint32_t* r2, const uint32_t* a2, const uint32_t* b2,
                                    uint32_t* r3, const uint32_t* a3, const uint32_t* b3) {
  uint32_t* const r[4] = {r0, r1, r2, r3};
  const uint32_t* const a[4] = {a0, a1, a2, a3};
  const uint32_t* const b[4] = {b0, b1, b2, b3};
  ch.level<4>(r, a, b);
}

// dbl-2009-l, a = 0 (curve.py:42-62; group.cuh jac_double) in three
// levels, in place.  RULE: Z3 = 0 where Y or Z is 0.
template <bool RULE>
__device__ __forceinline__ void chain_double(const Chain& ch, uint32_t X[NL], uint32_t Y[NL], uint32_t Z[NL]) {
  const bool y_zero = RULE && (fe_is_zero<NL>(Y) || fe_is_zero<NL>(Z));
  uint32_t A[NL], B[NL], C[NL], D[NL], E[NL];
  mul(ch, A, X, X, B, Y, Y, C, Y, Z);  // A = X^2, B = Y^2, Y Z
  fe_add<Fq>(Z, C, C);                 // Z3 = 2 Y Z
  if (y_zero) fe_set_zero(Z);
  fe_add<Fq>(D, X, B);
  fe_add<Fq>(E, A, A);
  fe_add<Fq>(E, E, A);                 // E = 3A
  mul(ch, C, B, B, D, D, D, X, E, E);  // C = B^2, (X + B)^2, F = E^2 (in X)
  fe_sub<Fq>(D, D, A);
  fe_sub<Fq>(D, D, C);
  fe_add<Fq>(D, D, D);                 // D = 2((X + B)^2 - A - C)
  fe_sub<Fq>(X, X, D);
  fe_sub<Fq>(X, X, D);                 // X3 = F - 2D
  fe_sub<Fq>(D, D, X);
  mul(ch, D, E, D);                    // E (D - X3)
  fe_add<Fq>(C, C, C);
  fe_add<Fq>(C, C, C);
  fe_add<Fq>(C, C, C);                 // 8C
  fe_sub<Fq>(Y, D, C);                 // Y3 = E (D - X3) - 8C
}

// (X1, Y1, Z1) += q, the complete add-2007-bl with its edge cases
// (curve.py:65-107; group.cuh jac_add) in five levels, in place; q is read
// through a point accessor where the formula uses it.
template <class PB>
__device__ __forceinline__ void chain_add(const Chain& ch, uint32_t X1[NL], uint32_t Y1[NL], uint32_t Z1[NL],
                                          const PB& q) {
  uint32_t Z1Z1[NL], Z2Z2[NL], S1[NL], R[NL], U1[NL], H[NL], T[NL];
  q.Z(T);  // Z2
  if (fe_is_zero<NL>(T)) return;  // q the identity: the sum is P (also when P is the identity)
  if (fe_is_zero<NL>(Z1)) {       // P the identity: the sum is q
    q.X(X1), q.Y(Y1);
    fe_copy<NL>(Z1, T);
    return;
  }
  q.Y(U1);                                                     // Y2
  mul(ch, Z1Z1, Z1, Z1, Z2Z2, T, T, S1, Y1, T, R, U1, Z1);     // Z1^2, Z2^2, Y1 Z2, Y2 Z1
  fe_add<Fq>(T, Z1, T);                                        // Z1 + Z2
  q.X(H);                                                      // X2
  mul(ch, U1, X1, Z2Z2, H, H, Z1Z1, S1, S1, Z2Z2, R, R, Z1Z1);  // U1, U2, S1, S2
  fe_sub<Fq>(H, H, U1);  // H = U2 - U1
  fe_sub<Fq>(R, R, S1);  // S2 - S1
  if (fe_is_zero<NL>(H) && fe_is_zero<NL>(R)) {  // P == Q
    chain_double<false>(ch, X1, Y1, Z1);
    return;
  }
  fe_add<Fq>(R, R, R);                      // r = 2 (S2 - S1)
  fe_add<Fq>(X1, H, H);                     // 2H
  mul(ch, T, T, T, X1, X1, X1, Y1, R, R);   // (Z1 + Z2)^2, I = (2H)^2, r^2
  fe_sub<Fq>(T, T, Z1Z1);
  fe_sub<Fq>(T, T, Z2Z2);
  mul(ch, Z1, T, H, H, H, X1, U1, U1, X1);  // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H, J = H I, V = U1 I
  fe_sub<Fq>(X1, Y1, H);
  fe_sub<Fq>(X1, X1, U1);
  fe_sub<Fq>(X1, X1, U1);                   // X3 = r^2 - J - 2V
  fe_sub<Fq>(U1, U1, X1);
  mul(ch, H, S1, H, U1, R, U1);             // S1 J, r (V - X3)
  fe_sub<Fq>(Y1, U1, H);
  fe_sub<Fq>(Y1, Y1, H);                    // Y3 = r (V - X3) - 2 S1 J
}

// s_i P_i, four lanes a point and per_warp points a warp (ladder_per_warp).
// scal: [n, 16] canonical 16-bit Fr limbs.
__global__ void __launch_bounds__(kLadderThreads)
    scalar_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                      const int32_t* __restrict__ z, const int32_t* __restrict__ scal,
                      int num_bits, int per_warp, int32_t* __restrict__ ox,
                      int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  const int slot = (threadIdx.x & 31) / kLanes;
  const long long i = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per_warp + slot;
  if (slot >= per_warp || i >= n) return;  // a whole group
  const Chain ch(threadIdx.x);
  const long long o = i * 2 * NL;
  const int32_t* s = scal + i * kScalarLimbs;
  const ApiPoint P{x + o, y + o, z + o};
  uint32_t X[NL], Y[NL], Z[NL];
  fe_set_zero(X);
  fe_set_one<Fq>(Y);
  fe_set_zero(Z);
  for (int k = num_bits - 1; k >= 0; k--) {
    chain_double<true>(ch, X, Y, Z);
    if ((__ldg(s + (k >> 4)) >> (k & 15)) & 1) chain_add(ch, X, Y, Z, P);
  }
  if (ch.k == 0) {
    fe_store<NL>(ox + o, X);
    fe_store<NL>(oy + o, Y);
    fe_store<NL>(oz + o, Z);
  }
}

__device__ __forceinline__ void store_words(uint32_t* w, const uint32_t X[NL], const uint32_t Y[NL],
                                            const uint32_t Z[NL]) {
#pragma unroll
  for (int j = 0; j < NL; j++) w[j] = X[j], w[NL + j] = Y[j], w[2 * NL + j] = Z[j];
}

// One block of min(W, kCombineGroups) groups of four lanes.  Group g
// doubles window g and, where W > kCombineGroups, window 2 groups - 1 - g
// (so the chains of a group add up to about the same length); then the
// halving tree, each group taking at most one add a level.
__global__ void __launch_bounds__(kCombineGroups * kLanes)
    combine_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const int32_t* __restrict__ z, int W, int c, int32_t* __restrict__ ox,
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz) {
  __shared__ uint32_t part[kCombineMax][3 * NL];
  const int g = threadIdx.x / kLanes;
  const int groups = blockDim.x / kLanes;
  const Chain ch(threadIdx.x);
  uint32_t X[NL], Y[NL], Z[NL];
  const int mine[2] = {g, 2 * groups - 1 - g};
#pragma unroll
  for (int m = 0; m < 2; m++) {
    const int w = mine[m];
    if (w >= W) continue;
    fe_load<NL>(X, x + w * 2 * NL);
    fe_load<NL>(Y, y + w * 2 * NL);
    fe_load<NL>(Z, z + w * 2 * NL);
    for (int i = 0; i < c * w; i++) chain_double<true>(ch, X, Y, Z);
    if (ch.k == 0) store_words(part[w], X, Y, Z);
  }
  __syncthreads();
  int s = 1;
  while (s < W) s <<= 1;
  for (s >>= 1; s >= 1; s >>= 1) {  // s <= groups: every window w < s has its group
    if (g < s && g + s < W) {
      const WordPoint acc{part[g]};
      acc.X(X), acc.Y(Y), acc.Z(Z);
      chain_add(ch, X, Y, Z, WordPoint{part[g + s]});
      ch.sync();  // every lane has read part[g] before lane 0 overwrites it
      if (ch.k == 0) store_words(part[g], X, Y, Z);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const WordPoint sum{part[0]};
    sum.X(X), sum.Y(Y), sum.Z(Z);
    fe_store<NL>(ox, X);
    fe_store<NL>(oy, Y);
    fe_store<NL>(oz, Z);
  }
}

// Points a warp of the ladder over `sms` SMs: as few as leave one warp (one
// block) to each SM, at most a full warp of groups.
int ladder_per_warp(long long n, int sms) {
  const long long per = (n + sms - 1) / sms;
  return (int)(per < 1 ? 1 : per > 32 / kLanes ? 32 / kLanes : per);
}

}  // namespace

extern "C" int marlin_g1_scalar_mul(const void* x, const void* y, const void* z, const void* scal,
                                    int num_bits, void* ox, void* oy, void* oz, long long n,
                                    void* stream) {
  if (num_bits < 0 || num_bits > 16 * kScalarLimbs) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  int dev = 0, sms = 0;  // the SMs of the current device, which the launch runs on
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int per_warp = ladder_per_warp(n, sms);
  const long long warps = (n + per_warp - 1) / per_warp;
  const unsigned blocks = (unsigned)((warps * 32 + kLadderThreads - 1) / kLadderThreads);
  scalar_mul_kernel<<<blocks, kLadderThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y), static_cast<const int32_t*>(z),
      static_cast<const int32_t*>(scal), num_bits, per_warp, static_cast<int32_t*>(ox),
      static_cast<int32_t*>(oy), static_cast<int32_t*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int marlin_combine_windows(const void* x, const void* y, const void* z, int W, int c,
                                      void* ox, void* oy, void* oz, void* stream) {
  if (W <= 0 || W > kCombineMax || c < 0) return (int)cudaErrorInvalidValue;
  const int threads = (W < kCombineGroups ? W : kCombineGroups) * kLanes;
  combine_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y), static_cast<const int32_t*>(z), W,
      c, static_cast<int32_t*>(ox), static_cast<int32_t*>(oy), static_cast<int32_t*>(oz));
  return (int)cudaGetLastError();
}

// Registers, local memory (stack frame and spills) and resident blocks an
// SM of each chain kernel, as the runtime reports them: which = 0 the
// ladder, 1 the combine.
extern "C" int marlin_chain_kernel_info(int which, int* regs, int* local_bytes, int* blocks_per_sm) {
  const void* fns[] = {(const void*)scalar_mul_kernel, (const void*)combine_kernel};
  const int threads[] = {kLadderThreads, kCombineGroups * kLanes};
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fns[which], threads[which], 0);
}
