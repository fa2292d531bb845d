// Montgomery field arithmetic for the Hopper kernels: the __device__ core
// (kernel 0) shared by field.cu (binop, inversion), ntt.cu (butterfly
// stages) and curve.cu (group law, bucket fold, window combine).
//
// Replaces the in-kernel core of the TPU package,
// marlin_tpu/ops/pallas/core.py: mm_mul_cios (:32), _finalize (:158) and
// mm_add / mm_sub / mm_select (:188-229).  The TPU core works on 16 x 16-bit
// limbs in u32 lanes because the VPU has no widening multiply; here an element
// is NL 32-bit limbs: 8 for every curve's Fr, 8 for BN254's Fq, 12 for the
// other curves' Fq and 24 for the Fr of test_wide750 (a 750-bit field with
// no curve).  R stays 2^(32 NL) = 2^256 / 2^384 / 2^768, so the Montgomery
// residues are the same numbers, and the outputs are canonical (< N) like
// the TPU's _finalize, so they agree limb for limb.
//
// The modulus is a compile-time constant: a traits struct per field (FqTraits,
// FrTraits of the curve the library is built for: limbs, -N^{-1} mod 2^32,
// R mod N, R^3 mod N) templates every function, so
// no modulus limb is ever loaded from memory and none crosses a call; the
// limbs become immediates of the multiply-adds.  The products are CIOS in
// the even/odd form of Emmart and Weems (as in the sppark library's mont_t):
// the running sum is two NL-word accumulators, `even` for the products
// a_j b_i of even j and `odd` (one word up) for odd j, so that each product
// lands in two adjacent words of one accumulator and a whole row is one
// PTX carry chain of mad.lo.cc / madc.hi.cc pairs; each row also adds
// m N the same way and shifts by one word by swapping the accumulators'
// roles.  Every modulus leaves the top bit of its top limb clear (254-750
// bits in 8, 12 or 24 words; static_assert below).  The odd accumulator's
// carry out of its top word is kept as a word of its own (it is nonzero
// only when an operand is not canonical, as in to_mont of a raw 256-bit
// value); every other carry that the chains drop is zero, and the merged
// result is below 2N, for a * b < N R (checked word for word by an
// emulation of these chains against Python integers,
// tests/test_torch_curves.py, for every curve's Fr and Fq and for
// test_wide750's Fr, for canonical
// operands and for one operand below R); the final conditional
// subtraction keeps every output canonical.  The carry flag lives between
// `asm volatile` statements, which the compiler keeps in order; no PTX
// instruction between them touches it.
//
// In global memory an element keeps the package's API layout: 2 NL int32
// words, each holding one 16-bit limb.  fe_load / fe_store pack and unpack
// with 16-byte vector accesses (rows are 64 B for 8 words, 96 B for 12,
// 192 B for 24).

#pragma once
#include <cstdint>

#define MARLIN_MAX_NL 24

// The words that the Python side passes with every launch
// (ModCtx.kernel_params in marlin_tpu_torch/ops/bigint.py, 51 words).  The
// kernels compute with the traits below; the host entries of field.cu and
// ntt.cu check these words against them, so a context that does not match
// the compiled field of the compiled curve is refused.
struct ModParams {
  uint32_t n[MARLIN_MAX_NL];    // modulus N
  uint32_t np0;                 // -N^{-1} mod 2^32
  uint32_t one[MARLIN_MAX_NL];  // R mod N (Montgomery one)
  uint32_t field;               // kFieldFr or kFieldFq
  uint32_t curve;               // MARLIN_CURVE_ID of the context's curve
};

static inline ModParams mod_params_from_words(const uint32_t* w) {
  ModParams p;
  for (int i = 0; i < MARLIN_MAX_NL; i++) p.n[i] = w[i];
  p.np0 = w[MARLIN_MAX_NL];
  for (int i = 0; i < MARLIN_MAX_NL; i++) p.one[i] = w[MARLIN_MAX_NL + 1 + i];
  p.field = w[2 * MARLIN_MAX_NL + 1];
  p.curve = w[2 * MARLIN_MAX_NL + 2];
  return p;
}

// The field a host entry is asked for (its `field` argument).
enum : uint32_t { kFieldFr = 0, kFieldFq = 1 };

// One pair of traits, FqTraits (the base field of G1) and FrTraits (the
// scalar field), for the curve chosen at compile time by -DMARLIN_CURVE_<NAME>
// (ops/cuda.py builds one library per curve).  MARLIN_CURVE_NAME is what the
// library's marlin_curve_id entry returns; MARLIN_CURVE_ID the number that
// ModParams.curve must carry (ops/cuda.py CURVE_IDS).  The constants are
// those of marlin_tpu_torch/fields/<curve>.py (tests/test_torch_curves.py
// recomputes every one from there).
#if defined(MARLIN_CURVE_BLS12_381)
#define MARLIN_CURVE_NAME "bls12_381"
#define MARLIN_CURVE_ID 1
// BLS12-381 base field Fq (381 bits), R = 2^384.
struct FqTraits {
  static constexpr int NL = 12;
  static constexpr int BITS = 381;
  static constexpr uint32_t NP0 = 0xfffcfffdu;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0xffffaaabu;  case 1: return 0xb9feffffu;  case 2: return 0xb153ffffu;
      case 3: return 0x1eabfffeu;  case 4: return 0xf6b0f624u;  case 5: return 0x6730d2a0u;
      case 6: return 0xf38512bfu;  case 7: return 0x64774b84u;  case 8: return 0x434bacd7u;
      case 9: return 0x4b1ba7b6u;  case 10: return 0x397fe69au;  default: return 0x1a0111eau;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0x0002fffdu;  case 1: return 0x76090000u;  case 2: return 0xc40c0002u;
      case 3: return 0xebf4000bu;  case 4: return 0x53c758bau;  case 5: return 0x5f489857u;
      case 6: return 0x70525745u;  case 7: return 0x77ce5853u;  case 8: return 0xa256ec6du;
      case 9: return 0x5c071a97u;  case 10: return 0xfa80e493u;  default: return 0x15f65ec3u;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0xd94ca1e0u;  case 1: return 0xed48ac6bu;  case 2: return 0x03a7adf8u;
      case 3: return 0x315f831eu;  case 4: return 0x615e29ddu;  case 5: return 0x9a53352au;
      case 6: return 0x921e1761u;  case 7: return 0x34c04e5eu;  case 8: return 0x65724728u;
      case 9: return 0x2512d435u;  case 10: return 0x91755d4du;  default: return 0x0aa63460u;
    }
  }
};

// BLS12-381 scalar field Fr (255 bits), R = 2^256.
struct FrTraits {
  static constexpr int NL = 8;
  static constexpr int BITS = 255;
  static constexpr uint32_t NP0 = 0xffffffffu;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0x00000001u;  case 1: return 0xffffffffu;  case 2: return 0xfffe5bfeu;
      case 3: return 0x53bda402u;  case 4: return 0x09a1d805u;  case 5: return 0x3339d808u;
      case 6: return 0x299d7d48u;  default: return 0x73eda753u;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0xfffffffeu;  case 1: return 0x00000001u;  case 2: return 0x00034802u;
      case 3: return 0x5884b7fau;  case 4: return 0xecbc4ff5u;  case 5: return 0x998c4fefu;
      case 6: return 0xacc5056fu;  default: return 0x1824b159u;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0x439b73afu;  case 1: return 0xc62c1807u;  case 2: return 0x8cf06990u;
      case 3: return 0x1b3e0d18u;  case 4: return 0xc7b5f418u;  case 5: return 0x73d13c71u;
      case 6: return 0xc8db33e9u;  default: return 0x6e2a5bb9u;
    }
  }
};
#elif defined(MARLIN_CURVE_BN254)
#define MARLIN_CURVE_NAME "bn254"
#define MARLIN_CURVE_ID 2
// BN254 base field Fq (254 bits), R = 2^256.
struct FqTraits {
  static constexpr int NL = 8;
  static constexpr int BITS = 254;
  static constexpr uint32_t NP0 = 0xe4866389u;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0xd87cfd47u;  case 1: return 0x3c208c16u;  case 2: return 0x6871ca8du;
      case 3: return 0x97816a91u;  case 4: return 0x8181585du;  case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u;  default: return 0x30644e72u;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0xc58f0d9du;  case 1: return 0xd35d438du;  case 2: return 0xf5c70b3du;
      case 3: return 0x0a78eb28u;  case 4: return 0x7879462cu;  case 5: return 0x666ea36fu;
      case 6: return 0x9a07df2fu;  default: return 0x0e0a77c1u;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0xda1530dfu;  case 1: return 0xb1cd6dafu;  case 2: return 0xa7283db6u;
      case 3: return 0x62f210e6u;  case 4: return 0x0ada0afbu;  case 5: return 0xef7f0b0cu;
      case 6: return 0x2d592544u;  default: return 0x20fd6e90u;
    }
  }
};

// BN254 scalar field Fr (254 bits), R = 2^256.
struct FrTraits {
  static constexpr int NL = 8;
  static constexpr int BITS = 254;
  static constexpr uint32_t NP0 = 0xefffffffu;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0xf0000001u;  case 1: return 0x43e1f593u;  case 2: return 0x79b97091u;
      case 3: return 0x2833e848u;  case 4: return 0x8181585du;  case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u;  default: return 0x30644e72u;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0x4ffffffbu;  case 1: return 0xac96341cu;  case 2: return 0x9f60cd29u;
      case 3: return 0x36fc7695u;  case 4: return 0x7879462eu;  case 5: return 0x666ea36fu;
      case 6: return 0x9a07df2fu;  default: return 0x0e0a77c1u;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0xb4bf0040u;  case 1: return 0x5e94d8e1u;  case 2: return 0x1cfbb6b8u;
      case 3: return 0x2a489cbeu;  case 4: return 0xa19fcfedu;  case 5: return 0x893cc664u;
      case 6: return 0x7fcc657cu;  default: return 0x0cf8594bu;
    }
  }
};
#elif defined(MARLIN_CURVE_BLS12_377)
#define MARLIN_CURVE_NAME "bls12_377"
#define MARLIN_CURVE_ID 3
// BLS12-377 base field Fq (377 bits), R = 2^384.
struct FqTraits {
  static constexpr int NL = 12;
  static constexpr int BITS = 377;
  static constexpr uint32_t NP0 = 0xffffffffu;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0x00000001u;  case 1: return 0x8508c000u;  case 2: return 0x30000000u;
      case 3: return 0x170b5d44u;  case 4: return 0xba094800u;  case 5: return 0x1ef3622fu;
      case 6: return 0x00f5138fu;  case 7: return 0x1a22d9f3u;  case 8: return 0x6ca1493bu;
      case 9: return 0xc63b05c0u;  case 10: return 0x17c510eau;  default: return 0x01ae3a46u;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0xffffff68u;  case 1: return 0x02cdffffu;  case 2: return 0x7fffffb1u;
      case 3: return 0x51409f83u;  case 4: return 0x8a7d3ff2u;  case 5: return 0x9f7db3a9u;
      case 6: return 0x6e7c6305u;  case 7: return 0x7b4e97b7u;  case 8: return 0x803c84e8u;
      case 9: return 0x4cf495bfu;  case 10: return 0xe2fdf49au;  default: return 0x008d6661u;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0x8815de20u;  case 1: return 0x581f532fu;  case 2: return 0xbe329585u;
      case 3: return 0xe50f4148u;  case 4: return 0x0449f513u;  case 5: return 0x2be8b118u;
      case 6: return 0xc804a20eu;  case 7: return 0x6a2a9516u;  case 8: return 0x13590cb9u;
      case 9: return 0x3f725407u;  case 10: return 0xc0e7dda5u;  default: return 0x01065ab4u;
    }
  }
};

// BLS12-377 scalar field Fr (253 bits), R = 2^256.
struct FrTraits {
  static constexpr int NL = 8;
  static constexpr int BITS = 253;
  static constexpr uint32_t NP0 = 0xffffffffu;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0x00000001u;  case 1: return 0x0a118000u;  case 2: return 0xd0000001u;
      case 3: return 0x59aa76feu;  case 4: return 0x5c37b001u;  case 5: return 0x60b44d1eu;
      case 6: return 0x9a2ca556u;  default: return 0x12ab655eu;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0xfffffff3u;  case 1: return 0x7d1c7fffu;  case 2: return 0x6ffffff2u;
      case 3: return 0x7257f50fu;  case 4: return 0x512c0feeu;  case 5: return 0x16d81575u;
      case 6: return 0x2bbb9a9du;  default: return 0x0d4bda32u;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0x0f65454cu;  case 1: return 0x6a4295c9u;  case 2: return 0xae271699u;
      case 3: return 0x624d23ffu;  case 4: return 0xf1c9d713u;  case 5: return 0xb1e55ef6u;
      case 6: return 0x55c48ddau;  default: return 0x0601dfa5u;
    }
  }
};
#elif defined(MARLIN_CURVE_SYNTHETIC_LOWADIC)
#define MARLIN_CURVE_NAME "synthetic_lowadic"
#define MARLIN_CURVE_ID 4
// synthetic_lowadic base field Fq (381 bits), R = 2^384.
struct FqTraits {
  static constexpr int NL = 12;
  static constexpr int BITS = 381;
  static constexpr uint32_t NP0 = 0x7968afffu;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0xf268b001u;  case 1: return 0x150eb3efu;  case 2: return 0x0ff020d3u;
      case 3: return 0x5b235a47u;  case 4: return 0x26b8fa7fu;  case 5: return 0x35a03206u;
      case 6: return 0x5b03e863u;  case 7: return 0xa958dcf8u;  case 8: return 0x8604c111u;
      case 9: return 0x21c17dedu;  case 10: return 0x50d516ccu;  default: return 0x1a0111eau;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0x7a51cff7u;  case 1: return 0x427bac90u;  case 2: return 0x708ed894u;
      case 3: return 0xcbc1d380u;  case 4: return 0xa37f3185u;  case 5: return 0x1d5e3dc8u;
      case 6: return 0xccdcd483u;  case 7: return 0x0be03b44u;  case 8: return 0x49d53661u;
      case 9: return 0xd03292a6u;  case 10: return 0x288232d2u;  default: return 0x15f65ec3u;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0xbdd3523du;  case 1: return 0x8cc196b0u;  case 2: return 0x32d2a0ecu;
      case 3: return 0x6ff91b6au;  case 4: return 0x539cd9d4u;  case 5: return 0x54545032u;
      case 6: return 0xc7cdc26eu;  case 7: return 0x8dc0d483u;  case 8: return 0xd6564d3au;
      case 9: return 0xc9ed7eccu;  case 10: return 0x5fb3dd7fu;  default: return 0x1845aee7u;
    }
  }
};

// synthetic_lowadic scalar field Fr (255 bits), R = 2^256.
struct FrTraits {
  static constexpr int NL = 8;
  static constexpr int BITS = 255;
  static constexpr uint32_t NP0 = 0xb7d15fffu;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0x9bd16001u;  case 1: return 0x812ac7edu;  case 2: return 0x64dae870u;
      case 3: return 0xb74d4ad6u;  case 4: return 0xc945041cu;  case 5: return 0x08b6697au;
      case 6: return 0x6ef610c5u;  default: return 0x73eda753u;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0xc85d3ffeu;  case 1: return 0xfdaa7024u;  case 2: return 0x364a2f1eu;
      case 3: return 0x91656a53u;  case 4: return 0x6d75f7c6u;  case 5: return 0xee932d0au;
      case 6: return 0x2213de75u;  default: return 0x1824b159u;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0xeb1bc5cfu;  case 1: return 0xf6f80df4u;  case 2: return 0x287a404eu;
      case 3: return 0x6c75149du;  case 4: return 0xc59b6817u;  case 5: return 0x111cb4ebu;
      case 6: return 0xe284e87au;  default: return 0x73d554b3u;
    }
  }
};
#elif defined(MARLIN_CURVE_TEST_WIDE750)
#define MARLIN_CURVE_NAME "test_wide750"
#define MARLIN_CURVE_ID 5
#define MARLIN_HAS_FQ 0
// test_wide750 scalar field Fr (750 bits), R = 2^768.  A field with no
// curve: there is no FqTraits, and the library holds the field and NTT
// kernels only (field.cu, ntt.cu and imad.cu; ops/cuda.py).
struct FrTraits {
  static constexpr int NL = 24;
  static constexpr int BITS = 750;
  static constexpr uint32_t NP0 = 0x4ee29fffu;
  __host__ __device__ static constexpr uint32_t n(int j) {
    switch (j) {
      case 0: return 0x32e2a001u;  case 1: return 0x00000000u;  case 2: return 0x00000000u;
      case 3: return 0x00000000u;  case 4: return 0x00000000u;  case 5: return 0x00000000u;
      case 6: return 0x00000000u;  case 7: return 0x00000000u;  case 8: return 0x00000000u;
      case 9: return 0x00000000u;  case 10: return 0x00000000u;  case 11: return 0x00000000u;
      case 12: return 0x00000000u;  case 13: return 0x00000000u;  case 14: return 0x00000000u;
      case 15: return 0x00000000u;  case 16: return 0x00000000u;  case 17: return 0x00000000u;
      case 18: return 0x00000000u;  case 19: return 0x00000000u;  case 20: return 0x00000000u;
      case 21: return 0x00000000u;  case 22: return 0x00000000u;  default: return 0x00002000u;
    }
  }
  __host__ __device__ static constexpr uint32_t one(int j) {
    switch (j) {
      case 0: return 0x32daa001u;  case 1: return 0xfffe68ebu;  case 2: return 0xffffffffu;
      case 3: return 0xffffffffu;  case 4: return 0xffffffffu;  case 5: return 0xffffffffu;
      case 6: return 0xffffffffu;  case 7: return 0xffffffffu;  case 8: return 0xffffffffu;
      case 9: return 0xffffffffu;  case 10: return 0xffffffffu;  case 11: return 0xffffffffu;
      case 12: return 0xffffffffu;  case 13: return 0xffffffffu;  case 14: return 0xffffffffu;
      case 15: return 0xffffffffu;  case 16: return 0xffffffffu;  case 17: return 0xffffffffu;
      case 18: return 0xffffffffu;  case 19: return 0xffffffffu;  case 20: return 0xffffffffu;
      case 21: return 0xffffffffu;  case 22: return 0xffffffffu;  default: return 0x00001fffu;
    }
  }
  // R^3 mod N: a Montgomery product by it multiplies by R^2
  __host__ __device__ static constexpr uint32_t r3(int j) {
    switch (j) {
      case 0: return 0x32e2a001u;  case 1: return 0xfe000000u;  case 2: return 0x4576b03fu;
      case 3: return 0xb35ccef8u;  case 4: return 0xfffbfaa4u;  case 5: return 0xffffffffu;
      case 6: return 0xffffffffu;  case 7: return 0xffffffffu;  case 8: return 0xffffffffu;
      case 9: return 0xffffffffu;  case 10: return 0xffffffffu;  case 11: return 0xffffffffu;
      case 12: return 0xffffffffu;  case 13: return 0xffffffffu;  case 14: return 0xffffffffu;
      case 15: return 0xffffffffu;  case 16: return 0xffffffffu;  case 17: return 0xffffffffu;
      case 18: return 0xffffffffu;  case 19: return 0xffffffffu;  case 20: return 0xffffffffu;
      case 21: return 0xffffffffu;  case 22: return 0xffffffffu;  default: return 0x00001fffu;
    }
  }
};
#else
#error "define the curve: -DMARLIN_CURVE_BLS12_381, _BN254, _BLS12_377, _SYNTHETIC_LOWADIC or _TEST_WIDE750"
#endif

// Whether the library's curve has a base field (every curve but the
// Fr-only test_wide750): field.cu's Fq entries and imad.cu's Fq chains are
// compiled only where it has.
#ifndef MARLIN_HAS_FQ
#define MARLIN_HAS_FQ 1
#endif

// The even/odd product and the binary inversion below keep a spare top bit
// in the modulus's top word, so that a sum of two canonical values fits.
static_assert(FrTraits::n(FrTraits::NL - 1) < 0x80000000u, "Fr needs a spare top bit");
static_assert(FrTraits::NL <= MARLIN_MAX_NL, "limbs past MARLIN_MAX_NL");
static_assert(FrTraits::NL % 4 == 0, "elements of whole 16-byte cells");
#if MARLIN_HAS_FQ
static_assert(FqTraits::n(FqTraits::NL - 1) < 0x80000000u, "Fq needs a spare top bit");
static_assert(FqTraits::NL <= MARLIN_MAX_NL, "limbs past MARLIN_MAX_NL");
static_assert(FqTraits::NL % 4 == 0, "elements of whole 16-byte cells");
#endif

// Whether the words from the Python side describe field FIELD of the
// compiled curve, whose traits are F.
template <class F>
static inline bool params_match(const ModParams& p, uint32_t field) {
  bool ok = p.np0 == F::NP0 && p.field == field && p.curve == MARLIN_CURVE_ID;
  for (int j = 0; j < MARLIN_MAX_NL; j++) {
    const bool in = j < F::NL;
    ok = ok && p.n[j] == (in ? F::n(j) : 0u) && p.one[j] == (in ? F::one(j) : 0u);
  }
  return ok;
}

// ---------------------------------------------------------------------------
// PTX carry-chain primitives.  ".cc" sets the carry flag, "c" consumes it.

namespace ptx {
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// (lo, hi) += a b as one 64-bit word pair: starts a carry chain.  The low
// output is early-clobber: it is written before the second instruction
// reads the inputs.
__device__ __forceinline__ void mad_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+&r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
// (lo, hi) += a b + carry: continues the chain.
__device__ __forceinline__ void madc_wide_cc(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+&r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
// (lo, hi) = a b + (c0, c1) + carry: continues the chain.
__device__ __forceinline__ void madc_wide_cc_to(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b,
                                                uint32_t c0, uint32_t c1) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %4; madc.hi.cc.u32 %1, %2, %3, %5;"
               : "=&r"(lo), "=r"(hi) : "r"(a), "r"(b), "r"(c0), "r"(c1));
}
// (lo, hi) = a b + (0, c1) + carry: ends the chain (no carry out).
__device__ __forceinline__ void madc_wide_end(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b,
                                              uint32_t c1) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, 0; madc.hi.u32 %1, %2, %3, %4;"
               : "=&r"(lo), "=r"(hi) : "r"(a), "r"(b), "r"(c1));
}
// (lo, hi) = a b, no carry in or out.
__device__ __forceinline__ void mul_wide(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
  asm volatile("mul.lo.u32 %0, %2, %3; mul.hi.u32 %1, %2, %3;"
               : "=&r"(lo), "=r"(hi) : "r"(a), "r"(b));
}
}  // namespace ptx

// ---------------------------------------------------------------------------

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

// An element staged in shared memory: its NL/2 16-byte pieces of the API
// layout (as cp.async copies them), the elements of a tile cell_stride =
// NL/2 + 1 cells apart.  The odd stride puts the pieces that the 8 lanes of
// a quarter warp read at 8 neighbouring elements in 8 distinct 16-byte bank
// groups, and the copies of consecutive pieces on consecutive cells.  These
// pack and unpack the 16-bit limbs as fe_load / fe_store do.
template <int NL>
__host__ __device__ constexpr int cell_stride() {
  return NL / 2 + 1;
}

template <int NL>
__device__ __forceinline__ void fe_load_cells(uint32_t r[NL], const int4* cells) {
#pragma unroll
  for (int q = 0; q < NL / 2; q++) {
    int4 w = cells[q];
    r[2 * q] = (uint32_t)w.x | ((uint32_t)w.y << 16);
    r[2 * q + 1] = (uint32_t)w.z | ((uint32_t)w.w << 16);
  }
}

template <int NL>
__device__ __forceinline__ void fe_store_cells(int4* cells, const uint32_t r[NL]) {
#pragma unroll
  for (int q = 0; q < NL / 2; q++) {
    cells[q] = make_int4((int)(r[2 * q] & 0xFFFFu), (int)(r[2 * q] >> 16),
                         (int)(r[2 * q + 1] & 0xFFFFu), (int)(r[2 * q + 1] >> 16));
  }
}

// Asynchronous 16-byte copies from global to shared memory (sm_80+), in
// commit groups; wait_group N waits until at most N groups are in flight.
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

template <int NL>
__device__ __forceinline__ void fe_copy(uint32_t r[NL], const uint32_t a[NL]) {
#pragma unroll
  for (int j = 0; j < NL; j++) r[j] = a[j];
}

template <class F>
__device__ __forceinline__ void fe_set_one(uint32_t r[F::NL]) {
#pragma unroll
  for (int j = 0; j < F::NL; j++) r[j] = F::one(j);
}

// r = t - N if t >= N, else t (t < 2^(32 NL)).
template <class F>
__device__ __forceinline__ void fe_reduce_once(uint32_t r[F::NL], const uint32_t t[F::NL]) {
  constexpr int NL = F::NL;
  uint32_t d[NL];
  d[0] = ptx::sub_cc(t[0], F::n(0));
#pragma unroll
  for (int j = 1; j < NL; j++) d[j] = ptx::subc_cc(t[j], F::n(j));
  const uint32_t borrow = ptx::subc(0u, 0u);  // all ones where t < N
#pragma unroll
  for (int j = 0; j < NL; j++) r[j] = borrow ? t[j] : d[j];
}

// Limb sources of the even/odd chains: limbs off, off + 2, off + 4, ... of a
// register array, or of the modulus (immediates).
struct Limbs {
  const uint32_t* p;
  int off;
  __device__ __forceinline__ uint32_t operator()(int j) const { return p[off + j]; }
};
template <class F>
struct ModLimbs {
  int off;
  __device__ __forceinline__ uint32_t operator()(int j) const { return F::n(off + j); }
};

// acc = Σ_{j even} x(j) b 2^(32 j)
template <int NL, class X>
__device__ __forceinline__ void mul_n(uint32_t acc[NL], const X& x, uint32_t b) {
#pragma unroll
  for (int j = 0; j < NL; j += 2) ptx::mul_wide(acc[j], acc[j + 1], x(j), b);
}

// acc += Σ_{j even} x(j) b 2^(32 j), one carry chain; leaves its carry out
template <int NL, class X>
__device__ __forceinline__ void cmad_n(uint32_t acc[NL], const X& x, uint32_t b) {
  ptx::mad_wide_cc(acc[0], acc[1], x(0), b);
#pragma unroll
  for (int j = 2; j < NL; j += 2) ptx::madc_wide_cc(acc[j], acc[j + 1], x(j), b);
}

// acc = (acc + top 2^(32 NL)) / 2^64 + Σ_{j even} x(j) b 2^(32 j) + carry in
template <int NL, class X>
__device__ __forceinline__ void madc_n_rshift(uint32_t acc[NL], const X& x, uint32_t b,
                                              uint32_t top) {
#pragma unroll
  for (int j = 0; j < NL - 2; j += 2)
    ptx::madc_wide_cc_to(acc[j], acc[j + 1], x(j), b, acc[j + 2], acc[j + 3]);
  ptx::madc_wide_end(acc[NL - 2], acc[NL - 1], x(NL - 2), b, top);
}

// One row of the product.  The running sum is even + odd 2^32 + top
// 2^(32 (NL + 1)).  After the first row it enters as even + odd / 2^32 (and
// top 2^(32 NL)) with odd_0 = 0: the previous row's sum divided by 2^32,
// the accumulators' roles swapped by the caller.  Folding odd_1 into even_0,
// and odd / 2^64 and top into odd, restores the form; then the row adds
// a b_i and m N, which zeroes even_0.  -> the new top word.
template <class F>
__device__ __forceinline__ uint32_t mad_n_redc(uint32_t even[F::NL], uint32_t odd[F::NL],
                                               const uint32_t a[F::NL], uint32_t bi,
                                               uint32_t top, bool first) {
  constexpr int NL = F::NL;
  if (first) {
    mul_n<NL>(odd, Limbs{a, 1}, bi);
    mul_n<NL>(even, Limbs{a, 0}, bi);
  } else {
    even[0] = ptx::add_cc(even[0], odd[1]);
    madc_n_rshift<NL>(odd, Limbs{a, 1}, bi, top);
    cmad_n<NL>(even, Limbs{a, 0}, bi);
    odd[NL - 1] = ptx::addc(odd[NL - 1], 0u);
  }
  const uint32_t m = even[0] * F::NP0;
  cmad_n<NL>(odd, ModLimbs<F>{1}, m);
  top = ptx::addc(0u, 0u);
  cmad_n<NL>(even, ModLimbs<F>{0}, m);
  odd[NL - 1] = ptx::addc_cc(odd[NL - 1], 0u);
  return ptx::addc(top, 0u);
}

// Montgomery product a * b * 2^(-32 NL) mod N (see the top of the file).
// Needs a * b < N R (canonical operands, or one canonical and the other
// below R); the result is canonical.  r may alias a or b: every limb of
// both is read before r is written.
template <class F>
__device__ __forceinline__ void fe_mul(uint32_t r[F::NL], const uint32_t a[F::NL],
                                       const uint32_t b[F::NL]) {
  constexpr int NL = F::NL;
  uint32_t even[NL], odd[NL];
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < NL; i += 2) {
    top = mad_n_redc<F>(even, odd, a, b[i], top, i == 0);
    top = mad_n_redc<F>(odd, even, a, b[i + 1], top, false);
  }
  // T = odd + even 2^32 (top is 0) with odd_0 = 0: T / 2^32 = even + odd / 2^32 < 2N
  even[0] = ptx::add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < NL - 1; k++) even[k] = ptx::addc_cc(even[k], odd[k + 1]);
  even[NL - 1] = ptx::addc(even[NL - 1], 0u);
  fe_reduce_once<F>(r, even);
}

template <class F>
__device__ __forceinline__ void fe_add(uint32_t r[F::NL], const uint32_t a[F::NL],
                                       const uint32_t b[F::NL]) {
  constexpr int NL = F::NL;
  uint32_t t[NL];
  t[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) t[j] = ptx::addc_cc(a[j], b[j]);
  t[NL - 1] = ptx::addc(a[NL - 1], b[NL - 1]);  // a + b < 2N < 2^(32 NL)
  fe_reduce_once<F>(r, t);
}

template <class F>
__device__ __forceinline__ void fe_sub(uint32_t r[F::NL], const uint32_t a[F::NL],
                                       const uint32_t b[F::NL]) {
  constexpr int NL = F::NL;
  uint32_t d[NL];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NL; j++) d[j] = ptx::subc_cc(a[j], b[j]);
  const uint32_t mask = ptx::subc(0u, 0u);  // all ones where a < b: add N back
  r[0] = ptx::add_cc(d[0], F::n(0) & mask);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) r[j] = ptx::addc_cc(d[j], F::n(j) & mask);
  r[NL - 1] = ptx::addc(d[NL - 1], F::n(NL - 1) & mask);
}

// ---------------------------------------------------------------------------
// The binary inversion of one element (kernel 2's root, csrc/field.cu).
// Multi-word helpers on NL-word integers, not residues.

template <int NL>
__device__ __forceinline__ bool mp_is_zero(const uint32_t a[NL]) {
  uint32_t o = a[0];
#pragma unroll
  for (int j = 1; j < NL; j++) o |= a[j];
  return o == 0u;
}

// r = a - b; -> all ones if a < b (a borrow out of the top word), else 0.
// r may alias a or b.
template <int NL>
__device__ __forceinline__ uint32_t mp_sub(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  r[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NL; j++) r[j] = ptx::subc_cc(a[j], b[j]);
  return ptx::subc(0u, 0u);
}

// r = a + b, for a sum the caller knows to fit NL words
template <int NL>
__device__ __forceinline__ void mp_add(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  r[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) r[j] = ptx::addc_cc(a[j], b[j]);
  r[NL - 1] = ptx::addc(a[NL - 1], b[NL - 1]);
}

// w >>= c, for 0 < c < 32
template <int NL>
__device__ __forceinline__ void mp_shr(uint32_t w[NL], int c) {
#pragma unroll
  for (int j = 0; j < NL - 1; j++) w[j] = __funnelshift_r(w[j], w[j + 1], c);
  w[NL - 1] >>= c;
}

// z <<= c, for 0 < c < 32 and z's top c bits zero
template <int NL>
__device__ __forceinline__ void mp_shl(uint32_t z[NL], int c) {
#pragma unroll
  for (int j = NL - 1; j > 0; j--) z[j] = __funnelshift_l(z[j - 1], z[j], c);
  z[0] <<= c;
}

// Shifts the trailing zero bits out of w (nonzero) and as many into z;
// -> their count.
template <int NL>
__device__ __forceinline__ int mp_shift_out(uint32_t w[NL], uint32_t z[NL]) {
  int total = 0;
#pragma unroll 1
  while ((w[0] & 1u) == 0u) {
    const int c = w[0] ? __ffs(w[0]) - 1 : 31;
    mp_shr<NL>(w, c);
    mp_shl<NL>(z, c);
    total += c;
  }
  return total;
}

// x = x / 2^c mod N for canonical x and 0 < c < 32: with m = x (-N^-1)
// mod 2^c, x + m N is a multiple of 2^c and (x + m N) / 2^c < 2N.
template <class F>
__device__ __forceinline__ void fe_halve_bits(uint32_t x[F::NL], int c) {
  constexpr int NL = F::NL;
  const uint32_t m = (x[0] * F::NP0) & ((1u << c) - 1u);
  uint32_t y[NL + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    const uint64_t t = (uint64_t)m * F::n(j) + x[j] + carry;
    y[j] = (uint32_t)t;
    carry = t >> 32;
  }
  y[NL] = (uint32_t)carry;
#pragma unroll
  for (int j = 0; j < NL; j++) x[j] = __funnelshift_r(y[j], y[j + 1], c);
  fe_reduce_once<F>(x, x);
}

// x^-1 in Montgomery form (in and out) for a canonical x != 0, by
// Kaliski's almost-Montgomery inverse: a binary extended Euclid on u = N,
// v = x with r = 0, s = 1, keeping N = u s + v r, so r and s never exceed
// N and need no reduction.  Each round subtracts the smaller of u and v
// from the larger, adds r + s, and shifts all the new value's trailing
// zeros out at once (the other coefficient shifts up by as many); k counts
// the shifts.  It ends with r = -x^-1 2^k mod N, about 180 rounds for an
// 8-word Fr, 270 for a 12-word Fq and 530 for test_wide750's 750-bit Fr
// (k ~ 1.4 log2 N; about one round for every two shifts).  Then N - r is halved k times, 31 bits
// a step (fe_halve_bits), giving x^-1; a Montgomery product by R^3 makes
// it x^-1 R^2, which is (a R)^-1 R^2 = a^-1 R for the Montgomery form x = a R.
// Variable time, like the reference's ark-ff binary Euclid.
template <class F>
__device__ __forceinline__ void fe_inv_binary(uint32_t out[F::NL], const uint32_t x[F::NL]) {
  constexpr int NL = F::NL;
  uint32_t u[NL], v[NL], r[NL], s[NL], d[NL], w[NL];
#pragma unroll
  for (int j = 0; j < NL; j++) {
    u[j] = F::n(j);
    v[j] = x[j];
    r[j] = 0u;
    s[j] = j == 0 ? 1u : 0u;
  }
  int k = mp_shift_out<NL>(v, r);
#pragma unroll 1
  while (true) {  // u and v odd
    const uint32_t u_below_v = mp_sub<NL>(d, u, v);
    mp_add<NL>(w, r, s);
    if (!u_below_v) {
      if (d[0] == 0u && mp_is_zero<NL>(d)) {  // u == v == 1: v - u = 0 ends it
        mp_shl<NL>(r, 1);
        k += 1;
        break;
      }
      fe_copy<NL>(u, d);
      fe_copy<NL>(r, w);
      k += mp_shift_out<NL>(u, s);
    } else {
      mp_sub<NL>(v, v, u);
      fe_copy<NL>(s, w);
      k += mp_shift_out<NL>(v, r);
    }
  }
  // r <= N and r != 0 mod N (x is invertible), so N - (r mod N) is canonical
  fe_reduce_once<F>(r, r);
#pragma unroll
  for (int j = 0; j < NL; j++) u[j] = F::n(j);
  mp_sub<NL>(r, u, r);  // x^-1 2^k
#pragma unroll 1
  while (k > 0) {
    const int c = k < 31 ? k : 31;
    fe_halve_bits<F>(r, c);
    k -= c;
  }
#pragma unroll
  for (int j = 0; j < NL; j++) u[j] = F::r3(j);
  fe_mul<F>(out, r, u);
}
