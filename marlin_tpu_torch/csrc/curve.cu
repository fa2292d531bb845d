// Kernels 4 and 5: the G1 Jacobian add and double over Fq, and the bucket
// fold of the MSMs, for the curve the library is built for (mont.cuh; Fq of
// NL = 8 words for BN254, 12 for BLS12-381, BLS12-377 and
// synthetic_lowadic).  The ladder (kernel 4's scalar_mul) and the window
// combine (kernel 6) are in chain.cu; the group law is group.cuh.
//
// Kernel 4 replaces marlin_tpu/ops/pallas/curve.py::_build (pallas_call at
// :201) with its _add_kernel / _double_kernel (:158-170): the complete
// add-2007-bl with its edge-case selects (:65-107) and dbl-2009-l (:42-62).
// Kernel 5 replaces _build_fold / _fold_kernel (pallas_call at :414, body at
// :320-384): the sum of a bucket's slots with the mixed add (:110-155, or the
// no-double variant :276-317 that reports degeneracy), then a roll-halving
// reduce of the partial sums with the complete add.
//
// What bounds them on the H100.  The add reads 6 and writes 3 Fq values
// (576 B per point in the int32 API layout at NL = 8, 864 B at 12) for 16 Fq
// products, the double 6 for 7: near the balance of bytes and integer
// multiplies at the main path's sizes.  Both stage nothing in registers they do not need, under a
// cap of 128 registers (four blocks of 128 threads an SM).
//
// The fold reads one packed table row (8 NL bytes: 64 B at NL = 8, 96 B at
// 12) and one 4-byte slot index per filled slot and does 11 Fq products on it: multiply bound, with a random
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
// * 4 blocks of 128 threads an SM (110 registers at NL = 12; 43 KB of
//   shared memory each at NL = 12, 28 KB at 8): the 2^14 prove's largest
//   fold ([1539, 3552], 385 blocks of four lanes) is one wave.
// No tensor cores: no product here is a matrix product, and an int8 mma over
// 381-bit limbs would need limb splitting and carry passes of its own.
//
// C interface (ctypes): every entry returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "group.cuh"

namespace {

using namespace g1;
constexpr int kThreads = 128;  // 4 warps
constexpr int kMinBlocks = 4;  // blocks of kThreads an SM: a cap of 128 registers
constexpr int kMaxLogSub = 5;  // at most 32 sub-rows: one warp per lane
constexpr int kCoordCells = NL / 4;           // an Fq value: NL words, 16 bytes a cell
constexpr int kRowCells = 2 * kCoordCells;    // a packed table row (X then Y)
constexpr int kPointCells = 3 * kCoordCells;  // a Jacobian point (X, Y, Z)

// Shared memory in columns of 16-byte cells: cell k of thread t at
// [k * kThreads + t], so a warp's 16-byte accesses to one cell index are
// conflict-free.  A point is kPointCells cells from `s`: X, Y and Z of
// kCoordCells each (3 cells each at NL = 12, 2 at NL = 8).
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
  __device__ __forceinline__ void Y(uint32_t r[NL]) const { load_cells(r, s, col, kCoordCells); }
  __device__ __forceinline__ void Z(uint32_t r[NL]) const { load_cells(r, s, col, 2 * kCoordCells); }
  __device__ __forceinline__ void setX(const uint32_t v[NL]) const { store_cells(s, col, 0, v); }
  __device__ __forceinline__ void setY(const uint32_t v[NL]) const {
    store_cells(s, col, kCoordCells, v);
  }
  __device__ __forceinline__ void setZ(const uint32_t v[NL]) const {
    store_cells(s, col, 2 * kCoordCells, v);
  }
};

struct SlotRow {  // affine (x2, ±y2) of a filled slot: a packed row in shared memory
  const uint4* s;  // X then Y, kCoordCells each
  int col;
  bool neg;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { load_cells(r, s, col, 0); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const {
    load_cells(r, s, col, kCoordCells);
    if (neg) {
      uint32_t zero[NL];
      fe_set_zero(zero);
      fe_sub<Fq>(r, zero, r);
    }
  }
};

// The operands go through shared memory (kPointCells cells for p, then as
// many for q, in the thread's column) and the results straight to global memory as each
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
    store_cells(cells, tid, kCoordCells * c, v);
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

// ---------------------------------------------------------------------------
// kernel 5

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
// The table rows are 8 NL bytes each (X then Y as 32-bit limbs,
// ops/curve.py::pack_points_xy: 96 B at NL = 12, 64 B at 8).  A thread's
// column of shared memory holds its two row buffers (cells 0 to
// 2 kRowCells - 1: 0-11 at NL = 12, 0-7 at 8) and then its accumulator
// (kPointCells cells: 12-20, or 8-13), which the join reads across the warp.
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

// Registers, local memory (stack frame and spills) and resident blocks of
// 128 threads an SM of each curve kernel, as the runtime reports them:
// which = 0 add, 1 double, 2 fold (fast), 3 fold (exact).
extern "C" int marlin_curve_kernel_info(int which, int* regs, int* local_bytes,
                                        int* blocks_per_sm) {
  const void* fns[] = {(const void*)add_kernel, (const void*)double_kernel,
                       (const void*)fold_kernel<false>, (const void*)fold_kernel<true>};
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fns[which], kThreads, 0);
}
