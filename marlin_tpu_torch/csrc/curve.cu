// Kernels 4, 5 and 6: BLS12-381 G1 Jacobian add / double / scalar multiple
// over Fq, the bucket fold of the MSMs, and the window combine of the classic
// Pippenger.
//
// Kernel 4 replaces marlin_tpu/ops/pallas/curve.py::_build (pallas_call at
// :201) with its _add_kernel / _double_kernel (:158-170): the complete
// add-2007-bl with its edge-case selects (:65-107) and dbl-2009-l (:42-62).
// Its scalar_mul entry runs the whole MSB-first double-and-add of
// marlin_tpu/ops/curve_device.py::scalar_mul_batch (:282) in one launch.
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
// common path with the registers of one branch.  Field products are the
// constant-modulus carry-chain core of mont.cuh (FqTraits), canonical, so the
// grouping and order of a chain of adds, subs and products does not change a
// residue.  Every function is inlined: no call, no stack frame, no modulus
// limb in memory.  The group law reads each coordinate of an operand where
// the formula uses it and writes each coordinate of the result as soon as
// it is final (the accessors below), which keeps four or five Fq values live.
//
// What bounds them on the H100.  The add reads 6 and writes 3 Fq values
// (864 B per point in the int32 API layout) for 16 Fq products, the double
// 6 for 7: near the balance of bytes and integer multiplies at the main
// path's sizes.  Both stage nothing in registers they do not need, under a
// cap of 128 registers (four blocks of 128 threads an SM).  scalar_mul keeps
// the ladder's accumulator in registers for all 255 steps: one launch where
// the host loop took three per bit; one thread a point, so a small batch is
// bound by the latency of its chain of ~3,800 dependent products.
//
// The fold reads one 96-byte packed table row and one 4-byte slot index per
// filled slot and does 11 Fq products on it: multiply bound, with a random
// gather into a table larger than the L2.  Its design:
// * each bucket lane is S = 2^log_sub sub-rows (threads) of one warp; S
//   comes from the fold's shape (ops/curve.py::fold_subrows): 32 for the
//   table path's long lanes, 1-2 for the classic path's many short ones,
//   where a join tree would cost more than it spreads;
// * the next filled slot's row is in flight while the current mixed add
//   runs: cp.async copies it in 16-byte pieces into a per-thread double
//   buffer in shared memory, and the mixed add reads its affine operand
//   from there where it uses it;
// * the accumulator lives in shared memory too, in the thread's column of
//   16-byte cells (conflict-free), so the slot loop holds no Fq value in
//   registers between slots; the S partial sums meet through those cells,
//   log2 S levels of the complete add, row r taking row r + s (the TPU's
//   row reduce), synchronized by the warp alone;
// * 4 blocks of 128 threads an SM (110 registers, 43 KB of shared memory
//   each): the 2^14 prove's largest fold ([1539, 3552], 385 blocks of
//   four lanes) is one wave.
// No tensor cores: no product here is a matrix product, and an int8 mma over
// 381-bit limbs would need limb splitting and carry passes of its own.
//
// The combine is bound by neither: its longest lane is a chain of c (W-1)
// dependent doublings (250 at c = 10, W = 26), 7 dependent Fq products each,
// on W threads of one block.  Thread w runs its own c w doublings, unmasked,
// and a halving tree of complete adds in shared memory joins the lanes.
//
// C interface (ctypes): every entry returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "mont.cuh"

namespace {

using Fq = FqTraits;
constexpr int NL = Fq::NL;     // 12 x 32-bit limbs
constexpr int kThreads = 128;  // 4 warps
constexpr int kMinBlocks = 4;  // blocks of kThreads an SM: a cap of 128 registers
constexpr int kMaxLogSub = 5;  // at most 32 sub-rows: one warp per lane
constexpr int kRowCells = 6;   // a packed table row: 6 x 16 bytes (X then Y)
constexpr int kPointCells = 9; // a Jacobian point: 9 x 16 bytes (X, Y, Z)
constexpr int kCombineThreads = 128;  // the combine's largest window count (ops/curve.py COMBINE_MAX)
constexpr int kScalarLimbs = 16;      // Fr scalars: 16 limbs of 16 bits

template <int N>
__device__ __forceinline__ bool fe_is_zero(const uint32_t a[N]) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < N; j++) o |= a[j];
  return o == 0;
}

__device__ __forceinline__ void fe_set_zero(uint32_t r[NL]) {
#pragma unroll
  for (int j = 0; j < NL; j++) r[j] = 0;
}

// Where the group law reads an operand from and writes a result to.  It
// reads each coordinate where the formula needs it and writes each result
// as soon as it is final, so that few Fq values are live in registers;
// every read of a coordinate comes before the write of the same coordinate,
// so a result may overwrite its operand.
struct ApiPoint {  // global memory, the API layout: 24 int32 words of 16-bit limbs
  const int32_t* x;
  const int32_t* y;
  const int32_t* z;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { fe_load<NL>(r, x); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const { fe_load<NL>(r, y); }
  __device__ __forceinline__ void Z(uint32_t r[NL]) const { fe_load<NL>(r, z); }
};

struct ApiOut {
  int32_t* x;
  int32_t* y;
  int32_t* z;
  __device__ __forceinline__ void setX(const uint32_t v[NL]) const { fe_store<NL>(x, v); }
  __device__ __forceinline__ void setY(const uint32_t v[NL]) const { fe_store<NL>(y, v); }
  __device__ __forceinline__ void setZ(const uint32_t v[NL]) const { fe_store<NL>(z, v); }
};

struct RegPoint {  // registers (the ladder's accumulator, the combine's lanes)
  uint32_t* x;
  uint32_t* y;
  uint32_t* z;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { fe_copy<NL>(r, x); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const { fe_copy<NL>(r, y); }
  __device__ __forceinline__ void Z(uint32_t r[NL]) const { fe_copy<NL>(r, z); }
  __device__ __forceinline__ void setX(const uint32_t v[NL]) const { fe_copy<NL>(x, v); }
  __device__ __forceinline__ void setY(const uint32_t v[NL]) const { fe_copy<NL>(y, v); }
  __device__ __forceinline__ void setZ(const uint32_t v[NL]) const { fe_copy<NL>(z, v); }
};

struct WordPoint {  // X | Y | Z as 36 32-bit limbs (the combine's shared memory)
  const uint32_t* w;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { copy(r, 0); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const { copy(r, NL); }
  __device__ __forceinline__ void Z(uint32_t r[NL]) const { copy(r, 2 * NL); }
  __device__ __forceinline__ void copy(uint32_t r[NL], int o) const {
#pragma unroll
    for (int j = 0; j < NL; j++) r[j] = w[o + j];
  }
};

// Shared memory in columns of 16-byte cells: cell k of thread t at
// [k * kThreads + t], so a warp's 16-byte accesses to one cell index are
// conflict-free.  A point is 9 cells (X, Y, Z: 3 each) from `s`.
__device__ __forceinline__ void load_cells(uint32_t r[NL], const uint4* s, int col, int k0) {
#pragma unroll
  for (int q = 0; q < NL / 4; q++) {
    const uint4 v = s[(k0 + q) * kThreads + col];
    r[4 * q] = v.x, r[4 * q + 1] = v.y, r[4 * q + 2] = v.z, r[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store_cells(uint4* s, int col, int k0, const uint32_t a[NL]) {
#pragma unroll
  for (int q = 0; q < NL / 4; q++)
    s[(k0 + q) * kThreads + col] = make_uint4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
}

struct CellPoint {
  uint4* s;
  int col;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { load_cells(r, s, col, 0); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const { load_cells(r, s, col, 3); }
  __device__ __forceinline__ void Z(uint32_t r[NL]) const { load_cells(r, s, col, 6); }
  __device__ __forceinline__ void setX(const uint32_t v[NL]) const { store_cells(s, col, 0, v); }
  __device__ __forceinline__ void setY(const uint32_t v[NL]) const { store_cells(s, col, 3, v); }
  __device__ __forceinline__ void setZ(const uint32_t v[NL]) const { store_cells(s, col, 6, v); }
};

struct SlotRow {  // affine (x2, ±y2) of a filled slot: a packed row in shared memory
  const uint4* s;  // X then Y, 3 cells each
  int col;
  bool neg;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { load_cells(r, s, col, 0); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const {
    load_cells(r, s, col, 3);
    if (neg) {
      uint32_t zero[NL];
      fe_set_zero(zero);
      fe_sub<Fq>(r, zero, r);
    }
  }
};

// dbl-2009-l, a = 0 (curve.py:42-62).  RULE adds the doubling kernel's
// select (curve.py:165-170): Z3 = 0 where Y or Z is 0; the complete add's
// doubling branch takes the formula as it is.  Every value is canonical, so
// the order of the steps does not change a limb.
template <bool RULE, class PA, class Out>
__device__ __forceinline__ void jac_double(const PA& a, const Out& out) {
  uint32_t A[NL], B[NL], C[NL], t[NL];
  a.Y(t);
  a.Z(C);
  const bool y_zero = RULE && (fe_is_zero<NL>(t) || fe_is_zero<NL>(C));
  fe_mul<Fq>(B, t, t);
  fe_mul<Fq>(C, t, C);
  fe_add<Fq>(C, C, C);  // Z3 = 2 Y Z
  if (y_zero) fe_set_zero(C);
  out.setZ(C);
  a.X(A);
  fe_add<Fq>(t, A, B);
  fe_mul<Fq>(A, A, A);
  fe_mul<Fq>(C, B, B);
  fe_mul<Fq>(t, t, t);
  fe_sub<Fq>(t, t, A);
  fe_sub<Fq>(t, t, C);
  fe_add<Fq>(B, t, t);  // D = 2((X + B)^2 - A - C)
  fe_add<Fq>(t, A, A);
  fe_add<Fq>(A, t, A);  // E = 3A
  fe_mul<Fq>(t, A, A);  // F = E^2
  fe_sub<Fq>(t, t, B);
  fe_sub<Fq>(t, t, B);  // X3 = F - 2D
  out.setX(t);
  fe_sub<Fq>(B, B, t);
  fe_mul<Fq>(B, A, B);  // E (D - X3)
  fe_add<Fq>(C, C, C);
  fe_add<Fq>(C, C, C);
  fe_add<Fq>(C, C, C);  // 8C
  fe_sub<Fq>(B, B, C);  // Y3 = E (D - X3) - 8C
  out.setY(B);
}

// The complete add (curve.py:65-107).
template <class PA, class PB, class Out>
__device__ __forceinline__ void jac_add(const PA& a, const PB& b, const Out& out) {
  uint32_t z1[NL], z2[NL], Z1Z1[NL], Z2Z2[NL], T[NL], S1[NL], R[NL], U1[NL], H[NL];
  a.Z(z1);
  b.Z(z2);
  const bool p_inf = fe_is_zero<NL>(z1);
  const bool q_inf = fe_is_zero<NL>(z2);
  fe_mul<Fq>(Z1Z1, z1, z1);
  fe_mul<Fq>(Z2Z2, z2, z2);
  fe_add<Fq>(T, z1, z2);
  fe_mul<Fq>(T, T, T);
  fe_sub<Fq>(T, T, Z1Z1);
  fe_sub<Fq>(T, T, Z2Z2);  // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
  a.Y(S1);
  fe_mul<Fq>(S1, S1, z2);
  fe_mul<Fq>(S1, S1, Z2Z2);  // S1 = Y1 Z2 Z2Z2
  a.X(U1);
  fe_mul<Fq>(U1, U1, Z2Z2);  // U1 = X1 Z2Z2
  b.Y(R);
  fe_mul<Fq>(R, R, z1);
  fe_mul<Fq>(R, R, Z1Z1);
  fe_sub<Fq>(R, R, S1);  // S2 - S1
  b.X(H);
  fe_mul<Fq>(H, H, Z1Z1);
  fe_sub<Fq>(H, H, U1);  // H = U2 - U1
  if (q_inf || p_inf) {  // the other operand
    if (q_inf) {
      a.X(H), a.Y(R), a.Z(T);
    } else {
      b.X(H), b.Y(R), b.Z(T);
    }
    out.setX(H), out.setY(R), out.setZ(T);
    return;
  }
  if (fe_is_zero<NL>(H) && fe_is_zero<NL>(R)) {  // P == Q
    jac_double<false>(a, out);
    return;
  }
  fe_add<Fq>(R, R, R);  // r = 2 (S2 - S1)
  fe_mul<Fq>(T, T, H);
  out.setZ(T);          // Z3
  fe_add<Fq>(T, H, H);
  fe_mul<Fq>(T, T, T);    // I = (2H)^2
  fe_mul<Fq>(H, H, T);    // J = H I
  fe_mul<Fq>(U1, U1, T);  // V = U1 I
  fe_mul<Fq>(T, R, R);
  fe_sub<Fq>(T, T, H);
  fe_sub<Fq>(T, T, U1);
  fe_sub<Fq>(T, T, U1);
  out.setX(T);            // X3 = r^2 - J - 2V
  fe_mul<Fq>(H, S1, H);   // S1 J
  fe_sub<Fq>(T, U1, T);
  fe_mul<Fq>(T, R, T);
  fe_sub<Fq>(T, T, H);
  fe_sub<Fq>(T, T, H);
  out.setY(T);            // Y3 = r (V - X3) - 2 S1 J
}

// acc + (x2, y2, 1): the mixed add (curve.py:110-155; Z2 is one, so U1 = X1,
// S1 = Y1 and Z3 = 2 Z1 H).  EXACT takes the doubling branch on P == Q; the
// fast variant (:276-317) computes the formula there too (its result is then
// (0, 0, 0)) and returns true, which the fold reports.
template <bool EXACT, class PA, class Q, class Out>
__device__ __forceinline__ bool jac_madd(const PA& a, const Q& q, const Out& out) {
  uint32_t Z1Z1[NL], H[NL], R[NL], T[NL], U[NL];
  a.Z(T);  // Z1
  if (fe_is_zero<NL>(T)) {
    q.X(U);
    out.setX(U);
    q.Y(U);
    out.setY(U);
    fe_set_one<Fq>(U);
    out.setZ(U);
    return false;
  }
  fe_mul<Fq>(Z1Z1, T, T);
  q.X(H);
  fe_mul<Fq>(H, H, Z1Z1);
  a.X(U);
  fe_sub<Fq>(H, H, U);  // H = U2 - X1
  q.Y(R);
  fe_mul<Fq>(R, R, T);
  fe_mul<Fq>(R, R, Z1Z1);
  a.Y(U);
  fe_sub<Fq>(R, R, U);  // S2 - Y1
  const bool deg = fe_is_zero<NL>(H) && fe_is_zero<NL>(R);
  if (EXACT && deg) {
    jac_double<false>(a, out);
    return false;
  }
  fe_add<Fq>(R, R, R);  // r
  fe_add<Fq>(T, T, T);
  fe_mul<Fq>(T, T, H);
  out.setZ(T);          // Z3 = 2 Z1 H
  fe_add<Fq>(T, H, H);
  fe_mul<Fq>(T, T, T);  // I
  fe_mul<Fq>(H, H, T);  // J
  a.X(U);
  fe_mul<Fq>(U, U, T);  // V = X1 I
  fe_mul<Fq>(T, R, R);
  fe_sub<Fq>(T, T, H);
  fe_sub<Fq>(T, T, U);
  fe_sub<Fq>(T, T, U);
  out.setX(T);          // X3 = r^2 - J - 2V
  a.Y(Z1Z1);
  fe_mul<Fq>(H, Z1Z1, H);  // S1 J
  fe_sub<Fq>(U, U, T);
  fe_mul<Fq>(U, R, U);
  fe_sub<Fq>(U, U, H);
  fe_sub<Fq>(U, U, H);
  out.setY(U);          // Y3 = r (V - X3) - 2 S1 J
  return deg;
}

// The operands go through shared memory (9 cells for p, then 9 for q, in
// the thread's column) and the results straight to global memory as each
// is final: the formula holds few Fq values and one register of address,
// under the register cap of four blocks an SM.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
               const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
               const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
               long long n) {
  __shared__ uint4 cells[2 * kPointCells * kThreads];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tid = threadIdx.x;
  const long long o = i * 2 * NL;
  const int32_t* src[6] = {x1 + o, y1 + o, z1 + o, x2 + o, y2 + o, z2 + o};
#pragma unroll
  for (int c = 0; c < 6; c++) {
    uint32_t v[NL];
    fe_load<NL>(v, src[c]);
    store_cells(cells, tid, 3 * c, v);
  }
  jac_add(CellPoint{cells, tid}, CellPoint{cells + kPointCells * kThreads, tid},
          ApiOut{ox + o, oy + o, oz + o});
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    double_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * 2 * NL;
  jac_double<true>(ApiPoint{x + o, y + o, z + o}, ApiOut{ox + o, oy + o, oz + o});
}

// s_i P_i by the double-and-add of curve_device.scalar_mul_batch: from the
// identity (0, 1, 0), for bit k = num_bits-1 down to 0, acc = double(acc)
// (the doubling kernel's rule), then acc = add(acc, P) where bit k is set.
// The host loop computed the add for every bit and selected; the limbs kept
// are the same.  scal: [n, 16] canonical 16-bit Fr limbs.
__global__ void __launch_bounds__(kThreads)
    scalar_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                      const int32_t* __restrict__ z, const int32_t* __restrict__ scal,
                      int num_bits, int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                      int32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * 2 * NL;
  const int32_t* s = scal + i * kScalarLimbs;
  uint32_t X[NL], Y[NL], Z[NL];
  fe_set_zero(X);
  fe_set_one<Fq>(Y);
  fe_set_zero(Z);
  const RegPoint acc{X, Y, Z};
  for (int k = num_bits - 1; k >= 0; k--) {
    jac_double<true>(acc, acc);
    if ((__ldg(s + (k >> 4)) >> (k & 15)) & 1) jac_add(acc, ApiPoint{x + o, y + o, z + o}, acc);
  }
  fe_store<NL>(ox + o, X);
  fe_store<NL>(oy + o, Y);
  fe_store<NL>(oz + o, Z);
}

// ---------------------------------------------------------------------------
// kernel 5

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The next filled slot of this sub-row at or after slot j (j advances past
// it), or 0 when the row has none left.
__device__ __forceinline__ int next_slot(const int32_t* row, int& j, int cap, int step) {
  while (j < cap) {
    const int e = __ldg(row + j);
    j += step;
    if (e != 0) return e;
  }
  return 0;
}

// Start the copy of table row |e| - 1 into buffer `buf` of column `col`.
__device__ __forceinline__ void fetch_row(uint4* cells, int col, int buf,
                                          const int32_t* __restrict__ table, int e) {
  const int4* src = reinterpret_cast<const int4*>(table + (long long)((e < 0 ? -e : e) - 1) * 2 * NL);
#pragma unroll
  for (int q = 0; q < kRowCells; q++) cp_async16(&cells[(kRowCells * buf + q) * kThreads + col], src + q);
}

// Lanes of S = 2^log_sub sub-rows; block b takes lanes b kThreads / S, ...
// (kThreads / S of them).  Sub-row r of a lane folds the slots j = r,
// r + S, ... of its layout row (0 = empty, +k = table row k-1, -k = its
// negation) into an accumulator that starts at the identity (0, 1, 0);
// then the S partial sums meet, row r taking row r + s for s = S/2, ..., 1.
// The table rows are 96 B each (X then Y as 32-bit limbs,
// ops/curve.py::pack_points_xy).  A thread's column of shared memory holds
// its two row buffers (cells 0-11) and its accumulator (cells 12-20), which
// the join reads across the warp.
template <bool EXACT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fold_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ layout, int lanes,
                int cap, int log_sub, int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, int32_t* __restrict__ flags) {
  __shared__ uint4 cells[(2 * kRowCells + kPointCells) * kThreads];
  uint4* const acc_cells = cells + 2 * kRowCells * kThreads;
  const int tid = threadIdx.x;
  const int S = 1 << log_sub;
  const int r = tid & (S - 1);
  const int lane = blockIdx.x * (kThreads >> log_sub) + (tid >> log_sub);
  const bool active = lane < lanes;
  const CellPoint acc{acc_cells, tid};
  {
    uint32_t v[NL];
    fe_set_zero(v);
    acc.setX(v);
    acc.setZ(v);
    fe_set_one<Fq>(v);
    acc.setY(v);
  }
  bool deg = false;
  if (active) {
    const int32_t* row = layout + (long long)lane * cap;
    int j = r;
    int e = next_slot(row, j, cap, S);
    if (e) fetch_row(cells, tid, 0, table, e);
    cp_async_commit();
    int buf = 0;
    while (e) {
      const int next = next_slot(row, j, cap, S);
      if (next) fetch_row(cells, tid, buf ^ 1, table, next);
      cp_async_commit();
      cp_async_wait<1>();  // this slot's row has landed
      deg |= jac_madd<EXACT>(acc, SlotRow{cells + kRowCells * buf * kThreads, tid, e < 0}, acc);
      e = next;
      buf ^= 1;
    }
    cp_async_wait<0>();
  }
  // the join: all of a lane's sub-rows are in one warp
  for (int s = S >> 1; s >= 1; s >>= 1) {
    __syncwarp();
    if (active && r < s) jac_add(acc, CellPoint{acc_cells, tid + s}, acc);
  }
  // this lane's bits of the warp's ballot
  const uint32_t bits = (S == 32 ? 0xffffffffu : ((1u << S) - 1u)) << ((tid & 31) & ~(S - 1));
  const bool any_deg = (__ballot_sync(0xffffffffu, deg) & bits) != 0;
  if (active && r == 0) {
    const long long o = (long long)lane * 2 * NL;
    uint32_t v[NL];
    acc.X(v);
    fe_store<NL>(ox + o, v);
    acc.Y(v);
    fe_store<NL>(oy + o, v);
    acc.Z(v);
    fe_store<NL>(oz + o, v);
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
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz) {
  __shared__ uint32_t part[kCombineThreads][3 * NL];
  const int w = threadIdx.x;
  uint32_t* mine = part[w];
  uint32_t X[NL], Y[NL], Z[NL];
  if (w < W) {
    fe_load<NL>(X, x + w * 2 * NL);
    fe_load<NL>(Y, y + w * 2 * NL);
    fe_load<NL>(Z, z + w * 2 * NL);
    const RegPoint lane{X, Y, Z};
    for (int i = 0; i < c * w; i++) jac_double<true>(lane, lane);
#pragma unroll
    for (int j = 0; j < NL; j++) mine[j] = X[j], mine[NL + j] = Y[j], mine[2 * NL + j] = Z[j];
  }
  __syncthreads();
  int s = 1;
  while (s < W) s <<= 1;
  for (s >>= 1; s >= 1; s >>= 1) {
    if (w < s && w + s < W) {
      jac_add(WordPoint{mine}, WordPoint{part[w + s]}, RegPoint{X, Y, Z});
#pragma unroll
      for (int j = 0; j < NL; j++) mine[j] = X[j], mine[NL + j] = Y[j], mine[2 * NL + j] = Z[j];
    }
    __syncthreads();
  }
  if (w == 0) {
    WordPoint sum{mine};
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
                             long long n, void* stream) {
  if (n <= 0) return 0;
  add_kernel<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(y1),
      static_cast<const int32_t*>(z1), static_cast<const int32_t*>(x2),
      static_cast<const int32_t*>(y2), static_cast<const int32_t*>(z2),
      static_cast<int32_t*>(ox), static_cast<int32_t*>(oy), static_cast<int32_t*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int marlin_g1_double(const void* x, const void* y, const void* z, void* ox, void* oy,
                                void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  double_kernel<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(z), static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int marlin_g1_scalar_mul(const void* x, const void* y, const void* z,
                                    const void* scal, int num_bits, void* ox, void* oy, void* oz,
                                    long long n, void* stream) {
  if (num_bits < 0 || num_bits > 16 * kScalarLimbs) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  scalar_mul_kernel<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(scal), num_bits,
      static_cast<int32_t*>(ox), static_cast<int32_t*>(oy), static_cast<int32_t*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int marlin_bucket_fold(int exact, const void* table, const void* layout, int lanes,
                                  int cap, int log_sub, void* ox, void* oy, void* oz, void* flags,
                                  void* stream) {
  if (log_sub < 0 || log_sub > kMaxLogSub || cap < 0) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  const unsigned blocks = blocks_for(lanes, kThreads >> log_sub);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(table);
  const int32_t* l = static_cast<const int32_t*>(layout);
  int32_t* px = static_cast<int32_t*>(ox);
  int32_t* py = static_cast<int32_t*>(oy);
  int32_t* pz = static_cast<int32_t*>(oz);
  int32_t* pf = static_cast<int32_t*>(flags);
  if (exact) {
    fold_kernel<true><<<blocks, kThreads, 0, s>>>(t, l, lanes, cap, log_sub, px, py, pz, pf);
  } else {
    fold_kernel<false><<<blocks, kThreads, 0, s>>>(t, l, lanes, cap, log_sub, px, py, pz, pf);
  }
  return (int)cudaGetLastError();
}

extern "C" int marlin_combine_windows(const void* x, const void* y, const void* z, int W, int c,
                                      void* ox, void* oy, void* oz, void* stream) {
  if (W <= 0 || W > kCombineThreads || c < 0) return (int)cudaErrorInvalidValue;
  combine_kernel<<<1, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(z), W, c, static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz));
  return (int)cudaGetLastError();
}

// Registers, local memory (stack frame and spills) and resident blocks of
// 128 threads an SM of each curve kernel, as the runtime reports them:
// which = 0 add, 1 double, 2 scalar_mul, 3 fold (fast), 4 fold (exact),
// 5 combine.
extern "C" int marlin_curve_kernel_info(int which, int* regs, int* local_bytes,
                                        int* blocks_per_sm) {
  const void* fns[] = {(const void*)add_kernel,         (const void*)double_kernel,
                       (const void*)scalar_mul_kernel,  (const void*)fold_kernel<false>,
                       (const void*)fold_kernel<true>,  (const void*)combine_kernel};
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fns[which], kThreads, 0);
}
