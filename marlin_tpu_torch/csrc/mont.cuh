// Montgomery field arithmetic for the Hopper kernels: the __device__ core
// shared by field.cu (binop, inversion) and ntt.cu (butterfly stages).
//
// Replaces the in-kernel core of the TPU package,
// marlin_tpu/ops/pallas/core.py: mm_mul_cios (:32), _finalize (:158) and
// mm_add / mm_sub / mm_select (:188-229).  The TPU core works on 16 x 16-bit
// limbs in u32 lanes because the VPU has no widening multiply; here an element
// is NL 32-bit limbs (8 for Fr, 12 for Fq) and every limb product is one
// 32x32->64 multiply.  R stays 2^(32 NL) = 2^256 / 2^384, so the Montgomery
// residues are the same numbers, and the outputs are canonical (< N) like the
// TPU's _finalize, so they agree limb for limb.
//
// In global memory an element keeps the package's API layout: 2 NL int32
// words, each holding one 16-bit limb.  fe_load / fe_store pack and unpack
// with 16-byte vector accesses (rows are 64 B for Fr and 96 B for Fq).

#pragma once
#include <cstdint>

#define MARLIN_MAX_NL 12

// Per-modulus constants, passed by value to every kernel.  Layout matches
// ModCtx.kernel_params in marlin_tpu_torch/ops/bigint.py (38 words).
struct ModParams {
  uint32_t n[MARLIN_MAX_NL];    // modulus N
  uint32_t np0;                 // -N^{-1} mod 2^32
  uint32_t e[MARLIN_MAX_NL];    // N - 2, the Fermat exponent
  uint32_t one[MARLIN_MAX_NL];  // R mod N (Montgomery one)
  uint32_t ebits;               // bit length of N - 2
};

static inline ModParams mod_params_from_words(const uint32_t* w) {
  ModParams p;
  for (int i = 0; i < MARLIN_MAX_NL; i++) p.n[i] = w[i];
  p.np0 = w[MARLIN_MAX_NL];
  for (int i = 0; i < MARLIN_MAX_NL; i++) p.e[i] = w[MARLIN_MAX_NL + 1 + i];
  for (int i = 0; i < MARLIN_MAX_NL; i++) p.one[i] = w[2 * MARLIN_MAX_NL + 1 + i];
  p.ebits = w[3 * MARLIN_MAX_NL + 1];
  return p;
}

template <int NL>
__device__ __forceinline__ void fe_load(uint32_t r[NL], const int32_t* src) {
  const int4* v = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 0; q < NL / 2; q++) {
    int4 w = v[q];
    r[2 * q] = (uint32_t)w.x | ((uint32_t)w.y << 16);
    r[2 * q + 1] = (uint32_t)w.z | ((uint32_t)w.w << 16);
  }
}

template <int NL>
__device__ __forceinline__ void fe_store(int32_t* dst, const uint32_t r[NL]) {
  int4* v = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < NL / 2; q++) {
    v[q] = make_int4((int)(r[2 * q] & 0xFFFFu), (int)(r[2 * q] >> 16),
                     (int)(r[2 * q + 1] & 0xFFFFu), (int)(r[2 * q + 1] >> 16));
  }
}

template <int NL>
__device__ __forceinline__ void fe_copy(uint32_t r[NL], const uint32_t a[NL]) {
#pragma unroll
  for (int j = 0; j < NL; j++) r[j] = a[j];
}

// r = t - N if t (NL words plus a top word `hi`) is >= N, else t.
template <int NL>
__device__ __forceinline__ void fe_reduce_once(uint32_t r[NL], const uint32_t t[NL],
                                               uint32_t hi, const ModParams& p) {
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    uint64_t s = (uint64_t)t[j] - p.n[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool keep = hi < borrow;  // t - N < 0 over the full width
#pragma unroll
  for (int j = 0; j < NL; j++) r[j] = keep ? t[j] : d[j];
}

// Montgomery product a * b * 2^(-32 NL) mod N by CIOS.  Needs a * b < N R
// (true for canonical operands, and for a < R when b < N); the result is
// canonical.
template <int NL>
__device__ __forceinline__ void fe_mul(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL], const ModParams& p) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int j = 0; j < NL + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)s;
      c = s;
    }
    uint64_t s = (uint64_t)t[NL] + (c >> 32);
    t[NL] = (uint32_t)s;
    t[NL + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * p.np0;
    c = (uint64_t)m * p.n[0] + t[0];
#pragma unroll
    for (int j = 1; j < NL; j++) {
      s = (uint64_t)m * p.n[j] + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)s;
      c = s;
    }
    s = (uint64_t)t[NL] + (c >> 32);
    t[NL - 1] = (uint32_t)s;
    t[NL] = t[NL + 1] + (uint32_t)(s >> 32);
  }
  // t[0..NL] < 2N
  fe_reduce_once<NL>(r, t, t[NL], p);
}

template <int NL>
__device__ __forceinline__ void fe_add(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL], const ModParams& p) {
  uint32_t t[NL];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    c = (uint64_t)a[j] + b[j] + (c >> 32);
    t[j] = (uint32_t)c;
  }
  fe_reduce_once<NL>(r, t, (uint32_t)(c >> 32), p);
}

template <int NL>
__device__ __forceinline__ void fe_sub(uint32_t r[NL], const uint32_t a[NL],
                                       const uint32_t b[NL], const ModParams& p) {
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  // a < b: add N back (mod 2^(32 NL))
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    c = (uint64_t)d[j] + (p.n[j] & mask) + (c >> 32);
    r[j] = (uint32_t)c;
  }
}

// x^(N-2) by left-to-right square-and-multiply; 0 maps to 0.  The exponent
// is the same for every thread, so the branch never diverges.
template <int NL>
__device__ __forceinline__ void fe_inv(uint32_t r[NL], const uint32_t x[NL],
                                       const ModParams& p) {
  uint32_t acc[NL];
#pragma unroll
  for (int j = 0; j < NL; j++) acc[j] = p.one[j];
  for (int i = (int)p.ebits - 1; i >= 0; i--) {
    fe_mul<NL>(acc, acc, acc, p);
    if ((p.e[i >> 5] >> (i & 31)) & 1u) fe_mul<NL>(acc, acc, x, p);
  }
  fe_copy<NL>(r, acc);
}
