// The G1 group law in Jacobian coordinates over Fq (the FqTraits of the
// curve the library is built for, mont.cuh) for the kernels of curve.cu (add, double, the bucket fold): dbl-2009-l and the
// complete add-2007-bl with their edge cases, and the fold's mixed add, over
// the constant-modulus core of mont.cuh.  chain.cu runs the same formulas as
// levels of independent products and takes its helpers and point accessors
// from here.
//
// Same formulas as marlin_tpu/ops/pallas/curve.py (:42-155) and as the plain
// versions in marlin_tpu_torch/ops/curve.py.  The TPU evaluates every branch
// and selects; here the rare branches (an identity operand, P == Q) are
// taken as branches, which gives the same limbs as the selects.  Products
// are canonical, so the grouping and order of a chain of adds, subs and
// products does not change a residue.  Every function is inlined: no call,
// no stack frame.  The group law reads each coordinate of an operand where
// the formula uses it and writes each coordinate of the result as soon as it
// is final (the accessors below), which keeps four or five Fq values live
// under curve.cu's register cap.

#pragma once
#include <cstdint>

#include "mont.cuh"

namespace g1 {

using Fq = FqTraits;
constexpr int NL = Fq::NL;  // 32-bit limbs: 8 (BN254) or 12

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
struct ApiPoint {  // global memory, the API layout: 2 NL int32 words of 16-bit limbs
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

struct WordPoint {  // X | Y | Z as 3 NL 32-bit limbs (the combine's shared memory)
  const uint32_t* w;
  __device__ __forceinline__ void X(uint32_t r[NL]) const { copy(r, 0); }
  __device__ __forceinline__ void Y(uint32_t r[NL]) const { copy(r, NL); }
  __device__ __forceinline__ void Z(uint32_t r[NL]) const { copy(r, 2 * NL); }
  __device__ __forceinline__ void copy(uint32_t r[NL], int o) const {
#pragma unroll
    for (int j = 0; j < NL; j++) r[j] = w[o + j];
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

}  // namespace g1
