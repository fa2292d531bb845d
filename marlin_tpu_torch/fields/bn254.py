"""BN254 (alt_bn128) curve constants — the framework's second live curve.

The reference is generic over the pairing engine and benches five curves
(reference benches/bench.rs:5-11); this module plays the role the
`ark-bn254`-style curve-config crates play there (reference Cargo.toml:37-41
pattern).  BN254 is chosen as the second configuration because

* its scalar field has a *small-subgroup* structure (r - 1 = 2^28 * 3^2 * m)
  and therefore genuinely exercises the mixed-radix evaluation-domain path
  (`GeneralEvaluationDomain`'s MixedRadix fallback — SURVEY.md §2b ark-poly
  row) that a purely 2-adic field like BLS12-381's Fr never reaches, and
* its parameters are independently verifiable offline (tests/test_bn254.py
  re-derives primality, subgroup orders, curve/twist membership, the full
  factorization of r-1, and pairing bilinearity from first principles).

Every constant below is checked by `tests/test_bn254.py`; none is trusted.

Layout mirrors :mod:`marlin_tpu_torch.fields.bls12_381` so the two modules are
drop-in interchangeable as the active-curve config.
"""

# --- Scalar field Fr -------------------------------------------------------
# r = order of G1/G2 (254 bits) — the alt_bn128 / BN254 group order.
R_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Multiplicative generator of Fr* (verified against the full factorization
# of r - 1 in tests/test_bn254.py).
FR_GENERATOR = 5

# r - 1 = 2^28 * 3^2 * 13 * 29 * 983 * 11003 * 237073 * 405928799
#         * 1670836401704629 * 13818364434197438864469338081
FR_TWO_ADICITY = 28
FR_TWO_ADIC_ROOT_OF_UNITY = pow(FR_GENERATOR, (R_MODULUS - 1) >> FR_TWO_ADICITY, R_MODULUS)

# Small-subgroup structure for mixed-radix domains: 3^2 divides r - 1, so
# evaluation domains of size 3^s * 2^k (s <= 2, k <= 28) exist.
FR_SMALL_SUBGROUP_BASE = 3
FR_SMALL_SUBGROUP_ADICITY = 2
# generator of the full 2^28 * 3^2 subgroup
FR_LARGE_SUBGROUP_ROOT_OF_UNITY = pow(
    FR_GENERATOR,
    (R_MODULUS - 1)
    // (
        (1 << FR_TWO_ADICITY)
        * FR_SMALL_SUBGROUP_BASE**FR_SMALL_SUBGROUP_ADICITY
    ),
    R_MODULUS,
)

FR_BITS = 254
FR_BYTES = 32
FR_MONT_R = (1 << 256) % R_MODULUS
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R_MODULUS
FR_MONT_INV = pow(-R_MODULUS, -1, 1 << 256)

# --- Base field Fq ---------------------------------------------------------
Q_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

FQ_BITS = 254
FQ_BYTES = 32
FQ_MONT_R = (1 << 256) % Q_MODULUS
FQ_MONT_R2 = (FQ_MONT_R * FQ_MONT_R) % Q_MODULUS
FQ_MONT_INV = pow(-Q_MODULUS, -1, 1 << 256)

# --- Curve E(Fq): y^2 = x^3 + 3 --------------------------------------------
CURVE_A = 0
CURVE_B = 3

G1_GENERATOR_X = 1
G1_GENERATOR_Y = 2

# --- Twist E'(Fq2): y^2 = x^3 + 3/(9+u)  (D-type twist) --------------------
# Fq2 = Fq[u]/(u^2 + 1); elements written as (c0, c1) = c0 + c1*u.
# b' = 3 / (9 + u); the exact Fq2 value is derived (and verified) in code:
_xi = (9, 1)  # 9 + u, the Fq6 non-residue


def _fq2_inv(a):
    a0, a1 = a
    d = pow((a0 * a0 + a1 * a1) % Q_MODULUS, -1, Q_MODULUS)
    return (a0 * d % Q_MODULUS, (-a1) * d % Q_MODULUS)


CURVE_B_TWIST = tuple(3 * c % Q_MODULUS for c in _fq2_inv(_xi))

G2_GENERATOR_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GENERATOR_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# --- Pairing parameters ----------------------------------------------------
# BN parameter x: q = 36x^4 + 36x^3 + 24x^2 + 6x + 1,
#                 r = 36x^4 + 36x^3 + 18x^2 + 6x + 1, trace t = 6x^2 + 1.
BN_X = 4965661367192848881
EMBEDDING_DEGREE = 12
TRACE = 6 * BN_X * BN_X + 1

# Fq2 quadratic non-residue used to build the tower (u^2 = QNR):
FQ2_NONRESIDUE = -1  # u^2 + 1
# Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v): same tower shape as
# BLS12-381 but with xi = 9 + u.
FQ6_NONRESIDUE = _xi

# Twist type: D-twist (the twist curve uses b/xi; untwisting multiplies
# coordinates by powers of w: psi(x, y) = (x * w^2, y * w^3)).
TWIST_TYPE = "D"

CURVE_NAME = "bn254"
