"""BLS12-377 curve constants — third live curve, derived not transcribed.

The reference benches five curve configs via type aliases
(benches/bench.rs:5-11); this config follows `ark-bls12-377`'s curve
(the Zexe inner curve).  Unlike a transcribed constants file, everything
here derives from the single BLS12 family parameter ``x`` through the
family polynomials — r = x^4 - x^2 + 1, q = (x-1)^2 r / 3 + x, trace
t = x + 1 — and from numerical search (tower non-residues, twist type by
order annihilation, generators by cofactor clearing).
tests/test_bls12_377.py re-derives and re-verifies every constant from
``x`` alone, so a corrupted value cannot survive the suite.

Fq is 377-bit (24 x 16-bit limbs, Montgomery R = 2^384 — same limb shape
as BLS12-381's Fq); Fr is 253-bit with 2-adicity 47, the highest of the
three live curves.
"""

# --- BLS12 family parameter ------------------------------------------------
BLS_X = 0x8508C00000000001
BLS_X_IS_NEGATIVE = False

# --- Scalar field Fr -------------------------------------------------------
R_MODULUS = BLS_X**4 - BLS_X**2 + 1

# verified primitive root (smallest; factorization of r-1 = x^2 (x-1)(x+1)
# re-checked in tests) — coincides with ark-bls12-377's GENERATOR
FR_GENERATOR = 22

FR_TWO_ADICITY = 47
FR_TWO_ADIC_ROOT_OF_UNITY = pow(FR_GENERATOR, (R_MODULUS - 1) >> FR_TWO_ADICITY, R_MODULUS)

FR_BITS = 253
FR_BYTES = 32
FR_MONT_R = (1 << 256) % R_MODULUS
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R_MODULUS
FR_MONT_INV = pow(-R_MODULUS, -1, 1 << 256)

FR_SMALL_SUBGROUP_BASE = 3  # 3 | r - 1 (factor of x - 1)
FR_SMALL_SUBGROUP_ADICITY = 1
FR_LARGE_SUBGROUP_ROOT_OF_UNITY = pow(
    FR_GENERATOR,
    (R_MODULUS - 1) // ((1 << FR_TWO_ADICITY) * FR_SMALL_SUBGROUP_BASE),
    R_MODULUS,
)

# --- Base field Fq ---------------------------------------------------------
Q_MODULUS = ((BLS_X - 1) ** 2 * R_MODULUS) // 3 + BLS_X

FQ_BITS = 377
FQ_BYTES = 48
FQ_MONT_R = (1 << 384) % Q_MODULUS
FQ_MONT_R2 = (FQ_MONT_R * FQ_MONT_R) % Q_MODULUS
FQ_MONT_INV = pow(-Q_MODULUS, -1, 1 << 384)

# --- Curve E(Fq): y^2 = x^3 + 1 --------------------------------------------
CURVE_A = 0
CURVE_B = 1

# cofactor-cleared from the x0 = 1 point (even-y normalization)
G1_GENERATOR_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
G1_GENERATOR_Y = 17397676153253620270863855454307851802466321586312764156125140564607560990561071773762088186709545111705113293147

# --- Tower / twist ---------------------------------------------------------
# Fq2 = Fq[u]/(u^2 + 5) (-1 is a square mod q; -5 is the smallest
# non-residue), Fq6 = Fq2[v]/(v^3 - u), Fq12 = Fq6[w]/(w^2 - v).
FQ2_NONRESIDUE = -5
FQ6_NONRESIDUE = (0, 1)  # xi = u

# D-type sextic twist E'(Fq2): y^2 = x^3 + b/xi = x^3 - u/5
# (identified by r | #E' order annihilation)
TWIST_TYPE = "D"
CURVE_B_TWIST = (
    0,
    155198655607781456406391640216936120121836107652948796323930557600032281009004493664981332883744016074664192874906,
)

# cofactor-cleared twist point (derivation in tests/test_bls12_377.py)
G2_GENERATOR_X = (
    39292833563790338514455678255839969442444299076493345799525535236324569704972737101027043002275594504529645125033,
    97668274349181098911216378040700666521757961257997861327997265570326738925466145318868002777904267769221513117576,
)
G2_GENERATOR_Y = (
    12670168495311570839246849220246345469108307986667888010668101126790399240749545663887747620979098015764659835358,
    84432745052336413615082002597703423810618940985259643064855840274752478639694687962835382580467718604598437838768,
)

# --- Pairing metadata ------------------------------------------------------
EMBEDDING_DEGREE = 12
TRACE = BLS_X + 1  # #E(Fq) = q + 1 - t = q - x

CURVE_NAME = "bls12_377"
