"""Synthetic low-2-adicity BLS12 curve — the MNT-753 capability analog.

The reference benches MNT4/6-753 whose Fr is not highly 2-adic, forcing
ark-poly's MixedRadix evaluation domains (reference benches/bench.rs:5-11;
src relies on GeneralEvaluationDomain).  Those exact MNT parameter sets
are unobtainable offline, so this curve reproduces the *defining
property* with the full pairing stack intact: Fr has 2-adicity 13 and a
3^3 small subgroup, so any domain larger than 2^13 (the outer K domain
passes that around 3k constraints) must take the mixed-radix path through
the whole prover/verifier/PC pipeline.

Found by tools/find_synthetic_bls.py (BLS12 family search over x with
x ≡ 2^12+1 mod 2^13 — v2(r-1) = v2(x-1) + v2(x+1) = 13 — and x ≡ 1 mod 27
— v3(r-1) = 3); every constant below derives from the single family
parameter ``x`` exactly as in bls12_377.py, and
tests/test_synthetic_lowadic.py re-derives each one from ``x`` alone.

Fq is 381-bit and Fr 255-bit — the same limb shapes as BLS12-381 (24- and
16-limb), but other moduli: the CUDA kernels are built for this curve's own
traits (marlin_tpu_torch/csrc/mont.cuh).  q ≡ 1 mod 4 (x ≡ 1 mod 4096
forces it), hence the BLS12-377-style tower Fq2 = Fq[u]/(u^2 + 5); the
twist is M-type with b' = b*xi = u.
"""

# --- BLS12 family parameter ------------------------------------------------
BLS_X = 0xD20100001F68B001
BLS_X_IS_NEGATIVE = False

# --- Scalar field Fr -------------------------------------------------------
R_MODULUS = BLS_X**4 - BLS_X**2 + 1

# verified primitive root: r - 1 = x^2 (x-1)(x+1) factors completely
# (all pieces <= 65-bit), so primitivity is checked against the full
# factorization in the tests
FR_GENERATOR = 11

FR_TWO_ADICITY = 13  # v2(r-1) = v2(x-1) + v2(x+1) = 12 + 1
FR_TWO_ADIC_ROOT_OF_UNITY = pow(FR_GENERATOR, (R_MODULUS - 1) >> FR_TWO_ADICITY, R_MODULUS)

FR_BITS = 255
FR_BYTES = 32
FR_MONT_R = (1 << 256) % R_MODULUS
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R_MODULUS
FR_MONT_INV = pow(-R_MODULUS, -1, 1 << 256)

FR_SMALL_SUBGROUP_BASE = 3
FR_SMALL_SUBGROUP_ADICITY = 3  # 27 | x - 1
FR_LARGE_SUBGROUP_ROOT_OF_UNITY = pow(
    FR_GENERATOR,
    (R_MODULUS - 1)
    // ((1 << FR_TWO_ADICITY) * FR_SMALL_SUBGROUP_BASE**FR_SMALL_SUBGROUP_ADICITY),
    R_MODULUS,
)

# --- Base field Fq ---------------------------------------------------------
Q_MODULUS = ((BLS_X - 1) ** 2 * R_MODULUS) // 3 + BLS_X

FQ_BITS = 381
FQ_BYTES = 48
FQ_MONT_R = (1 << 384) % Q_MODULUS
FQ_MONT_R2 = (FQ_MONT_R * FQ_MONT_R) % Q_MODULUS
FQ_MONT_INV = pow(-Q_MODULUS, -1, 1 << 384)

# --- Curve E(Fq): y^2 = x^3 + 1 --------------------------------------------
CURVE_A = 0
CURVE_B = 1

# cofactor-cleared from the smallest on-curve x (tests re-derive)
G1_GENERATOR_X = 1802627348603319251692280749487269124047876188736723495645341001350803300144462100493258536014080716731354356778586
G1_GENERATOR_Y = 3785344244818845914353419261823708165394316656888816018058186305886191805481820593745559079495605815121421520584770

# --- Tower / twist ---------------------------------------------------------
# q ≡ 1 mod 4 (so -1 is a square); -5 is the smallest non-residue.
# Fq2 = Fq[u]/(u^2 + 5), Fq6 = Fq2[v]/(v^3 - u), Fq12 = Fq6[w]/(w^2 - v).
FQ2_NONRESIDUE = -5
FQ6_NONRESIDUE = (0, 1)  # xi = u

# M-type sextic twist E'(Fq2): y^2 = x^3 + b*xi = x^3 + u
# (identified by r | #E' order annihilation over the CM twist orders)
TWIST_TYPE = "M"
CURVE_B_TWIST = (0, 1)

# cofactor-cleared twist point (derivation in tests/test_synthetic_lowadic.py)
G2_GENERATOR_X = (
    3031732512969263874892887328703804511992897177994911186085763319880449331393278087939002953538745732696165775524224,
    768395887569162996982545713380734080774775793914786771680866285081233658337863427868912538363200066134265098044990,
)
G2_GENERATOR_Y = (
    3611161226053396446600522373766614514773295454973827751767397542263630923194108117997184321743804885492975401545508,
    922095175466280444385788612216458124287073415087427766119253182039649262761838282660114336060693484427995470036035,
)

# --- Pairing metadata ------------------------------------------------------
EMBEDDING_DEGREE = 12
TRACE = BLS_X + 1  # #E(Fq) = q + 1 - t = ((x-1)^2/3) * r

CURVE_NAME = "synthetic_lowadic"
