// Kernels 4, 5 and 6: BLS12-381 G1 Jacobian add / double over Fq (NL = 12),
// the bucket fold of the MSMs, and the window combine of the classic
// Pippenger.
//
// Kernel 4 replaces marlin_tpu/ops/pallas/curve.py::_build (pallas_call at
// :201) with its _add_kernel / _double_kernel (:158-170): the complete
// add-2007-bl with its edge-case selects (:65-107) and dbl-2009-l (:42-62).
// Kernel 5 replaces _build_fold / _fold_kernel (pallas_call at :414, body at
// :320-384): the sum of a bucket's slots with the mixed add (:110-155, or the
// no-double variant :276-317 that reports degeneracy), then a roll-halving
// reduce of the partial sums with the complete add.  Kernel 6 replaces
// _build_combine / _combine_kernel (pallas_call at :476, body at :427-461):
// Σ_w 2^(c w) T_w over a classic Pippenger's W <= 128 window sums.
//
// Same formulas as the TPU kernels and as the plain versions in
// marlin_tpu_torch/ops/curve.py.  The TPU evaluates every branch of the group
// law and selects; here the rare branches (an identity operand, P == Q) are
// taken as branches, which gives the same limbs as the selects and leaves the
// common path with the registers of one branch.  Field products are the CIOS
// core of mont.cuh, canonical, so the grouping of a chain of adds and subs
// does not change the residue.
//
// What bounds them on the H100.  The add reads 6 and writes 3 Fq values
// (864 B per point in the int32 API layout) for 16 Fq products (~4,800 32-bit
// multiplies): bytes bound at the main path's sizes.  The fold reads one
// 96-byte packed table row and one 4-byte slot index per filled slot and
// does 11 Fq products on it: multiply bound.  The design gives one thread
// to each point, or to each bucket sub-row; the add keeps its Fq
// temporaries in registers and reads its operands only as the formula needs
// them, so that about eight Fq values are live; the fold gathers its rows
// straight from the table (no [slots, 24] gather in device memory), and an
// empty slot costs one index load.  The combine is bound by neither: its
// longest lane is a chain of c (W-1) dependent doublings (250 at c = 10,
// W = 26), 7 dependent Fq products each, on W threads of one block.  The
// TPU masks c (W-1) doubling steps over all 128 lanes; here thread w runs
// its own c w doublings, unmasked, and a halving tree of complete adds in
// shared memory joins the lanes.
//
// C interface (ctypes): every entry returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

namespace {

constexpr int NL = 12;         // Fq: 12 x 32-bit limbs
constexpr int kThreads = 128;  // 4 warps
constexpr int kSubRows = 32;   // fold sub-rows per bucket lane: one warp (ops/curve.py FOLD_SUBROWS)
constexpr int kCombineThreads = 128;  // the combine's largest window count (ops/curve.py COMBINE_MAX)

__device__ __forceinline__ bool fe_is_zero(const uint32_t a[NL]) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) o |= a[j];
  return o == 0;
}

__device__ __forceinline__ void fe_set_zero(uint32_t r[NL]) {
#pragma unroll
  for (int j = 0; j < NL; j++) r[j] = 0;
}

// Where the add reads an operand from.  Reading late, and again in the rare
// branches, keeps the operands out of the registers of the common path.
struct ApiPoint {  // three rows of the API layout: 24 int32 words of 16-bit limbs
  const int32_t* x;
  const int32_t* y;
  const int32_t* z;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { fe_load<NL>(r, x); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const { fe_load<NL>(r, y); }
  __device__ __forceinline__ void Z(uint32_t r[NL]) const { fe_load<NL>(r, z); }
};

struct WordPoint {  // X | Y | Z as 36 32-bit limbs (the fold's shared memory)
  const uint32_t* w;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { copy(r, 0); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const { copy(r, NL); }
  __device__ __forceinline__ void Z(uint32_t r[NL]) const { copy(r, 2 * NL); }
  __device__ __forceinline__ void copy(uint32_t r[NL], int o) const {
#pragma unroll
    for (int j = 0; j < NL; j++) r[j] = w[o + j];
  }
};

// dbl-2009-l, a = 0, in place (curve.py:42-62), without the identity select:
// the complete add's doubling branch takes it as it is.
__device__ __forceinline__ void jac_double_raw(uint32_t X[NL], uint32_t Y[NL], uint32_t Z[NL],
                                               const ModParams& p) {
  uint32_t A[NL], B[NL], C[NL], D[NL], t[NL];
  fe_mul<NL>(A, X, X, p);
  fe_mul<NL>(B, Y, Y, p);
  fe_mul<NL>(Z, Y, Z, p);
  fe_add<NL>(Z, Z, Z, p);  // Z3 = 2 Y Z
  fe_mul<NL>(C, B, B, p);
  fe_add<NL>(t, X, B, p);
  fe_mul<NL>(t, t, t, p);
  fe_sub<NL>(t, t, A, p);
  fe_sub<NL>(t, t, C, p);
  fe_add<NL>(D, t, t, p);  // D = 2((X + B)^2 - A - C)
  fe_add<NL>(t, A, A, p);
  fe_add<NL>(A, t, A, p);  // E = 3A
  fe_mul<NL>(t, A, A, p);  // F = E^2
  fe_add<NL>(X, D, D, p);
  fe_sub<NL>(X, t, X, p);  // X3 = F - 2D
  fe_sub<NL>(t, D, X, p);
  fe_mul<NL>(t, A, t, p);  // E (D - X3)
  fe_add<NL>(C, C, C, p);
  fe_add<NL>(C, C, C, p);
  fe_add<NL>(C, C, C, p);  // 8C
  fe_sub<NL>(Y, t, C, p);  // Y3 = E (D - X3) - 8C
}

// The complete add (curve.py:65-107); every read of a and b comes before the
// first write of an output.
template <class PA, class PB>
__device__ __forceinline__ void jac_add(const PA& a, const PB& b, uint32_t X3[NL],
                                        uint32_t Y3[NL], uint32_t Z3[NL], const ModParams& p) {
  uint32_t z1[NL], z2[NL], Z1Z1[NL], Z2Z2[NL], T[NL], S1[NL], R[NL], U1[NL], H[NL];
  a.Z(z1);
  b.Z(z2);
  const bool p_inf = fe_is_zero(z1);
  const bool q_inf = fe_is_zero(z2);
  fe_mul<NL>(Z1Z1, z1, z1, p);
  fe_mul<NL>(Z2Z2, z2, z2, p);
  fe_add<NL>(T, z1, z2, p);
  fe_mul<NL>(T, T, T, p);
  fe_sub<NL>(T, T, Z1Z1, p);
  fe_sub<NL>(T, T, Z2Z2, p);  // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
  a.Y(S1);
  fe_mul<NL>(S1, S1, z2, p);
  fe_mul<NL>(S1, S1, Z2Z2, p);  // S1 = Y1 Z2 Z2Z2
  b.Y(R);
  fe_mul<NL>(R, R, z1, p);
  fe_mul<NL>(R, R, Z1Z1, p);
  fe_sub<NL>(R, R, S1, p);  // S2 - S1
  a.X(U1);
  fe_mul<NL>(U1, U1, Z2Z2, p);  // U1 = X1 Z2Z2
  b.X(H);
  fe_mul<NL>(H, H, Z1Z1, p);
  fe_sub<NL>(H, H, U1, p);  // H = U2 - U1
  if (q_inf) {
    a.X(X3), a.Y(Y3), a.Z(Z3);
    return;
  }
  if (p_inf) {
    b.X(X3), b.Y(Y3), b.Z(Z3);
    return;
  }
  if (fe_is_zero(H) && fe_is_zero(R)) {  // P == Q
    a.X(X3), a.Y(Y3), a.Z(Z3);
    jac_double_raw(X3, Y3, Z3, p);
    return;
  }
  fe_add<NL>(R, R, R, p);   // r = 2 (S2 - S1)
  fe_mul<NL>(Z3, T, H, p);  // Z3
  fe_add<NL>(T, H, H, p);
  fe_mul<NL>(T, T, T, p);    // I = (2H)^2
  fe_mul<NL>(H, H, T, p);    // J = H I
  fe_mul<NL>(U1, U1, T, p);  // V = U1 I
  fe_mul<NL>(T, R, R, p);
  fe_sub<NL>(T, T, H, p);
  fe_sub<NL>(T, T, U1, p);
  fe_sub<NL>(X3, T, U1, p);  // X3 = r^2 - J - 2V
  fe_mul<NL>(H, S1, H, p);   // S1 J
  fe_sub<NL>(T, U1, X3, p);
  fe_mul<NL>(T, R, T, p);
  fe_sub<NL>(T, T, H, p);
  fe_sub<NL>(Y3, T, H, p);  // Y3 = r (V - X3) - 2 S1 J
}

// acc += (x2, y2, 1): the mixed add (curve.py:110-155; Z2 is one, so U1 = X1,
// S1 = Y1 and Z3 = 2 Z1 H).  EXACT takes the doubling branch on P == Q; the
// fast variant (:276-317) computes the formula there too (its result is then
// (0, 0, 0)) and returns true, which the fold reports.
//
// Not inlined, and neither is fold_join: CUDA 12.8's cicc crashes
// (segmentation fault) on the fold kernel with this function inlined into
// its slot loop.  As a call it takes its operands through the stack frame
// (392 bytes, no spills; PERF.md).
template <bool EXACT>
__device__ __noinline__ bool jac_madd(uint32_t X[NL], uint32_t Y[NL], uint32_t Z[NL],
                                         const uint32_t x2[NL], const uint32_t y2[NL],
                                         const ModParams& p) {
  if (fe_is_zero(Z)) {
    fe_copy<NL>(X, x2);
    fe_copy<NL>(Y, y2);
    fe_copy<NL>(Z, p.one);
    return false;
  }
  uint32_t Z1Z1[NL], H[NL], R[NL], T[NL], U[NL];
  fe_mul<NL>(Z1Z1, Z, Z, p);
  fe_mul<NL>(H, x2, Z1Z1, p);
  fe_sub<NL>(H, H, X, p);  // H = U2 - X1
  fe_mul<NL>(R, y2, Z, p);
  fe_mul<NL>(R, R, Z1Z1, p);
  fe_sub<NL>(R, R, Y, p);  // S2 - Y1
  const bool deg = fe_is_zero(H) && fe_is_zero(R);
  if (EXACT && deg) {
    jac_double_raw(X, Y, Z, p);
    return false;
  }
  fe_add<NL>(R, R, R, p);  // r
  fe_add<NL>(T, Z, Z, p);
  fe_mul<NL>(Z, T, H, p);  // Z3 = 2 Z1 H
  fe_add<NL>(T, H, H, p);
  fe_mul<NL>(T, T, T, p);   // I
  fe_mul<NL>(H, H, T, p);   // J
  fe_mul<NL>(U, X, T, p);   // V = X1 I
  fe_mul<NL>(T, R, R, p);
  fe_sub<NL>(T, T, H, p);
  fe_sub<NL>(T, T, U, p);
  fe_sub<NL>(T, T, U, p);   // X3 = r^2 - J - 2V
  fe_mul<NL>(H, Y, H, p);   // S1 J
  fe_sub<NL>(U, U, T, p);
  fe_mul<NL>(U, R, U, p);
  fe_sub<NL>(U, U, H, p);
  fe_sub<NL>(Y, U, H, p);   // Y3 = r (V - X3) - 2 S1 J
  fe_copy<NL>(X, T);
  return deg;
}

// One step of the fold's row reduce: mine += other, both X | Y | Z rows of
// shared memory (a call, see jac_madd).
__device__ __noinline__ void fold_join(uint32_t* mine, const uint32_t* other,
                                          const ModParams& p) {
  uint32_t X[NL], Y[NL], Z[NL];
  jac_add(WordPoint{mine}, WordPoint{other}, X, Y, Z, p);
#pragma unroll
  for (int j = 0; j < NL; j++) mine[j] = X[j], mine[NL + j] = Y[j], mine[2 * NL + j] = Z[j];
}

__global__ void __launch_bounds__(kThreads)
    add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
               const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
               const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
               long long n, ModParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * 2 * NL;
  uint32_t X[NL], Y[NL], Z[NL];
  jac_add(ApiPoint{x1 + o, y1 + o, z1 + o}, ApiPoint{x2 + o, y2 + o, z2 + o}, X, Y, Z, p);
  fe_store<NL>(ox + o, X);
  fe_store<NL>(oy + o, Y);
  fe_store<NL>(oz + o, Z);
}

// curve.py:165-170: the doubling with Z3 = 0 where Y or Z is zero.
__global__ void __launch_bounds__(kThreads)
    double_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, ModParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * 2 * NL;
  uint32_t X[NL], Y[NL], Z[NL];
  fe_load<NL>(X, x + o);
  fe_load<NL>(Y, y + o);
  fe_load<NL>(Z, z + o);
  const bool y_zero = fe_is_zero(Y) || fe_is_zero(Z);
  jac_double_raw(X, Y, Z, p);
  if (y_zero) fe_set_zero(Z);
  fe_store<NL>(ox + o, X);
  fe_store<NL>(oy + o, Y);
  fe_store<NL>(oz + o, Z);
}

// One warp per bucket lane.  Sub-row r folds the slots j = r, r + 32, ... of
// the lane's layout row (0 = empty, +k = table row k-1, -k = its negation)
// into an accumulator that starts at the identity (0, 1, 0); then the 32
// partial sums meet in shared memory through five levels of the complete add,
// row r taking row r + s (the TPU's roll-halving row reduce).  A warp reads
// 32 neighbouring slot indices at a time; the table rows it gathers are
// 96 B each (X then Y as 32-bit limbs, ops/curve.py::pack_points_xy).
template <bool EXACT>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ layout, int lanes,
                int cap, int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, int32_t* __restrict__ flags, ModParams p) {
  __shared__ uint32_t part[kThreads][3 * NL];
  const int r = threadIdx.x % kSubRows;
  const long long lane = (long long)blockIdx.x * (kThreads / kSubRows) + threadIdx.x / kSubRows;
  if (lane >= lanes) return;  // the whole warp
  uint32_t X[NL], Y[NL], Z[NL];
  fe_set_zero(X);
  fe_copy<NL>(Y, p.one);
  fe_set_zero(Z);
  bool deg = false;
  const int32_t* row = layout + lane * cap;
  for (int j = r; j < cap; j += kSubRows) {
    const int e = row[j];
    if (e == 0) continue;
    const long long k = (long long)(e < 0 ? -e : e) - 1;
    const int4* v = reinterpret_cast<const int4*>(table + k * 2 * NL);
    uint32_t x2[NL], y2[NL];
#pragma unroll
    for (int q = 0; q < 3; q++) {
      const int4 wx = v[q];
      const int4 wy = v[q + 3];
      x2[4 * q] = wx.x, x2[4 * q + 1] = wx.y, x2[4 * q + 2] = wx.z, x2[4 * q + 3] = wx.w;
      y2[4 * q] = wy.x, y2[4 * q + 1] = wy.y, y2[4 * q + 2] = wy.z, y2[4 * q + 3] = wy.w;
    }
    if (e < 0) {
      uint32_t zero[NL];
      fe_set_zero(zero);
      fe_sub<NL>(y2, zero, y2, p);
    }
    deg |= jac_madd<EXACT>(X, Y, Z, x2, y2, p);
  }
  uint32_t* mine = part[threadIdx.x];
#pragma unroll
  for (int j = 0; j < NL; j++) mine[j] = X[j], mine[NL + j] = Y[j], mine[2 * NL + j] = Z[j];
  __syncwarp();
  for (int s = kSubRows / 2; s >= 1; s >>= 1) {
    if (r < s) fold_join(mine, part[threadIdx.x + s], p);
    __syncwarp();
  }
  const bool any_deg = __any_sync(0xffffffffu, deg);
  if (r == 0) {
    WordPoint sum{mine};
    sum.X(X), sum.Y(Y), sum.Z(Z);
    fe_store<NL>(ox + lane * 2 * NL, X);
    fe_store<NL>(oy + lane * 2 * NL, Y);
    fe_store<NL>(oz + lane * 2 * NL, Z);
    flags[lane] = any_deg ? 1 : 0;
  }
}

// Kernel 6 (curve.py:427-461): thread w doubles window sum T_w c w times
// with the doubling kernel's rule (Y = 0 or Z = 0 gives Z3 = 0), then the
// lanes meet in shared memory: at each level s (a power of two, halving),
// lane w < s takes lane w + s if that lane exists.  Thread 0 writes the sum.
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const int32_t* __restrict__ z, int W, int c, int32_t* __restrict__ ox,
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz, ModParams p) {
  __shared__ uint32_t part[kCombineThreads][3 * NL];
  const int w = threadIdx.x;
  uint32_t* mine = part[w];
  if (w < W) {
    uint32_t X[NL], Y[NL], Z[NL];
    fe_load<NL>(X, x + w * 2 * NL);
    fe_load<NL>(Y, y + w * 2 * NL);
    fe_load<NL>(Z, z + w * 2 * NL);
    for (int i = 0; i < c * w; i++) {
      const bool y_zero = fe_is_zero(Y) || fe_is_zero(Z);
      jac_double_raw(X, Y, Z, p);
      if (y_zero) fe_set_zero(Z);
    }
#pragma unroll
    for (int j = 0; j < NL; j++) mine[j] = X[j], mine[NL + j] = Y[j], mine[2 * NL + j] = Z[j];
  }
  __syncthreads();
  int s = 1;
  while (s < W) s <<= 1;
  for (s >>= 1; s >= 1; s >>= 1) {
    if (w < s && w + s < W) fold_join(mine, part[w + s], p);
    __syncthreads();
  }
  if (w == 0) {
    WordPoint sum{mine};
    uint32_t X[NL], Y[NL], Z[NL];
    sum.X(X), sum.Y(Y), sum.Z(Z);
    fe_store<NL>(ox, X);
    fe_store<NL>(oy, Y);
    fe_store<NL>(oz, Z);
  }
}

unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" int marlin_g1_add(const void* x1, const void* y1, const void* z1, const void* x2,
                             const void* y2, const void* z2, void* ox, void* oy, void* oz,
                             long long n, const void* params, void* stream) {
  if (n <= 0) return 0;
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  add_kernel<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(y1),
      static_cast<const int32_t*>(z1), static_cast<const int32_t*>(x2),
      static_cast<const int32_t*>(y2), static_cast<const int32_t*>(z2),
      static_cast<int32_t*>(ox), static_cast<int32_t*>(oy), static_cast<int32_t*>(oz), n, p);
  return (int)cudaGetLastError();
}

extern "C" int marlin_g1_double(const void* x, const void* y, const void* z, void* ox, void* oy,
                                void* oz, long long n, const void* params, void* stream) {
  if (n <= 0) return 0;
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  double_kernel<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(z), static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz), n, p);
  return (int)cudaGetLastError();
}

extern "C" int marlin_bucket_fold(int exact, const void* table, const void* layout, int lanes,
                                  int cap, void* ox, void* oy, void* oz, void* flags,
                                  const void* params, void* stream) {
  if (lanes <= 0) return 0;
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  const unsigned blocks = blocks_for(lanes, kThreads / kSubRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(table);
  const int32_t* l = static_cast<const int32_t*>(layout);
  int32_t* px = static_cast<int32_t*>(ox);
  int32_t* py = static_cast<int32_t*>(oy);
  int32_t* pz = static_cast<int32_t*>(oz);
  int32_t* pf = static_cast<int32_t*>(flags);
  if (exact) {
    fold_kernel<true><<<blocks, kThreads, 0, s>>>(t, l, lanes, cap, px, py, pz, pf, p);
  } else {
    fold_kernel<false><<<blocks, kThreads, 0, s>>>(t, l, lanes, cap, px, py, pz, pf, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int marlin_combine_windows(const void* x, const void* y, const void* z, int W, int c,
                                      void* ox, void* oy, void* oz, const void* params,
                                      void* stream) {
  if (W <= 0 || W > kCombineThreads || c < 0) return (int)cudaErrorInvalidValue;
  const ModParams p = mod_params_from_words(static_cast<const uint32_t*>(params));
  combine_kernel<<<1, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(z), W, c, static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz), p);
  return (int)cudaGetLastError();
}
