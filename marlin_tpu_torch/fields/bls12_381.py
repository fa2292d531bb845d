"""BLS12-381 curve constants.

Rebuild of the parameters the reference consumes from the
`ark-bls12-381` crate (reference: Cargo.toml:37, src/test.rs:120).

All constants are plain Python ints; device code converts them to limb
arrays via :mod:`marlin_tpu_torch.ops.limbs`.
"""

# --- Scalar field Fr -------------------------------------------------------
# r = order of the BLS12-381 G1/G2 subgroups (255 bits).
R_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Multiplicative generator of Fr* (matches arkworks' GENERATOR = 7).
FR_GENERATOR = 7

# Fr is highly 2-adic: r - 1 = 2^32 * t with t odd.
FR_TWO_ADICITY = 32
FR_TWO_ADIC_ROOT_OF_UNITY = pow(FR_GENERATOR, (R_MODULUS - 1) >> FR_TWO_ADICITY, R_MODULUS)

# Montgomery parameters for Fr with R = 2^256 (mirrors arkworks' 4x64 repr).
FR_BITS = 255
FR_BYTES = 32
FR_MONT_R = (1 << 256) % R_MODULUS
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R_MODULUS
FR_MONT_INV = pow(-R_MODULUS, -1, 1 << 256)  # -r^{-1} mod 2^256

# --- Base field Fq ---------------------------------------------------------
Q_MODULUS = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

FQ_BITS = 381
FQ_BYTES = 48
FQ_MONT_R = (1 << 384) % Q_MODULUS
FQ_MONT_R2 = (FQ_MONT_R * FQ_MONT_R) % Q_MODULUS
FQ_MONT_INV = pow(-Q_MODULUS, -1, 1 << 384)

# --- Curve E(Fq): y^2 = x^3 + 4 -------------------------------------------
CURVE_A = 0
CURVE_B = 4

G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# --- Twist E'(Fq2): y^2 = x^3 + 4(u+1) -------------------------------------
# Fq2 = Fq[u]/(u^2 + 1); elements written as (c0, c1) = c0 + c1*u.
CURVE_B_TWIST = (4, 4)

G2_GENERATOR_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GENERATOR_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# BLS parameter: the curve is generated from x below; used by the Miller loop
# and (negated) final exponentiation.  x is negative for BLS12-381.
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

# --- Generic-engine metadata (fields.pairing_generic tower shape) ----------
# Fq2 = Fq[u]/(u^2 + 1); Fq6 = Fq2[v]/(v^3 - (1+u)); Fq12 = Fq6[w]/(w^2 - v).
FQ2_NONRESIDUE = -1
FQ6_NONRESIDUE = (1, 1)
EMBEDDING_DEGREE = 12
TWIST_TYPE = "M"
# trace of Frobenius: #E(Fq) = q + 1 - t with t = x + 1 (x negative above)
TRACE = -BLS_X + 1

# No small-subgroup structure is used for BLS12-381 domains (2-adicity 32
# covers every protocol size); mixed-radix machinery reads these as "none".
FR_SMALL_SUBGROUP_BASE = None
FR_SMALL_SUBGROUP_ADICITY = 0

CURVE_NAME = "bls12_381"
