"""ctypes bindings for the native curve runtime (csrc/marlin_curve.c).

The reference's SRS generation and small MSMs run through ark-ec's native
Rust fixed-base/variable-base routines (SURVEY.md §2b row 2); this is the
C equivalent for the host-side group work: powers-of-tau generation (G1 and
G2 — the latter feeds the trapdoor-free Sonic verifier key), small G1 MSMs,
and single scalar muls.  host_curve.py falls back to pure Python when the
library is unavailable.

ABI: canonical little-endian u64 limbs — Fq is 6 limbs, G1 affine 12, G2
affine 24 (x.c0, x.c1, y.c0, y.c1), scalars 4 limbs; identity via a
separate uint8 flag array.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

# the shared C sources live at the repository root; this package builds its
# own copy of the library into marlin_tpu_torch/build/
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "marlin_curve.c")
_BUILD_DIR = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD_DIR, "libmarlin_curve.so")

_U64P = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["cc", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)  # atomic: parallel test workers may race here
        lib = ctypes.CDLL(_SO)
        for name, argtypes in (
            ("marlin_g1_fixed_powers", [_U64P, _U64P, ctypes.c_size_t, _U64P, _U8P]),
            ("marlin_g2_fixed_powers", [_U64P, _U64P, ctypes.c_size_t, _U64P, _U8P]),
            ("marlin_g1_msm", [_U64P, _U8P, _U64P, ctypes.c_size_t, _U64P, _U8P]),
            ("marlin_g1_mul", [_U64P, _U64P, _U64P, _U8P]),
            ("marlin_g2_mul", [_U64P, _U64P, _U64P, _U8P]),
            ("marlin_miller_loop", [_U64P, ctypes.c_uint8, _U64P, ctypes.c_uint8, _U64P]),
            ("marlin_final_exp", [_U64P, _U64P, _U64P]),
            ("marlin_final_exp_x", [_U64P, _U64P]),
            ("marlin_g2_prepare", [_U64P, _U64P]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        mp = lib.marlin_multi_pairing
        mp.argtypes = [_U64P, _U8P, _U64P, _U8P, ctypes.c_size_t, _U64P]
        mp.restype = ctypes.c_int
        mpp = lib.marlin_multi_pairing_prepared
        mpp.argtypes = [_U64P, _U8P, _U64P, ctypes.c_size_t, _U64P]
        mpp.restype = ctypes.c_int
        ns = lib.marlin_g2_prepare_nsteps
        ns.argtypes = []
        ns.restype = ctypes.c_int
        _LIB = lib
    except Exception:  # pragma: no cover - missing toolchain
        _LIB = None
    return _LIB


def available() -> bool:
    # The C runtime hardcodes the BLS12-381 moduli (csrc/marlin_curve.c);
    # other active curves use the Python/generic host path.
    from . import active as P

    if getattr(P, "CURVE_NAME", "bls12_381") != "bls12_381":
        return False
    return _load() is not None


def _int_to_limbs(x: int, n: int) -> list:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def _limbs_to_int(a) -> int:
    out = 0
    for i, v in enumerate(a):
        out |= int(v) << (64 * i)
    return out


def _scalars_arr(scalars: list) -> np.ndarray:
    from . import bls12_381 as P

    arr = np.zeros((len(scalars), 4), dtype=np.uint64)
    for i, s in enumerate(scalars):
        arr[i] = _int_to_limbs(s % P.R_MODULUS, 4)
    return arr


def _g1_affine_arr(points: list) -> tuple[np.ndarray, np.ndarray]:
    arr = np.zeros((len(points), 12), dtype=np.uint64)
    inf = np.zeros(len(points), dtype=np.uint8)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = 1
        else:
            arr[i, :6] = _int_to_limbs(p[0], 6)
            arr[i, 6:] = _int_to_limbs(p[1], 6)
    return arr, inf


def _g1_out_to_list(out: np.ndarray, inf: np.ndarray) -> list:
    return [
        None if inf[i] else (_limbs_to_int(out[i, :6]), _limbs_to_int(out[i, 6:]))
        for i in range(out.shape[0])
    ]


def g1_fixed_base_powers(base: tuple, scalars: list) -> list:
    """[s*base] for canonical-int scalars -> affine (x, y) int tuples."""
    lib = _load()
    base_arr = np.asarray(
        _int_to_limbs(base[0], 6) + _int_to_limbs(base[1], 6), dtype=np.uint64
    )
    sc = _scalars_arr(scalars)
    out = np.zeros((len(scalars), 12), dtype=np.uint64)
    inf = np.zeros(len(scalars), dtype=np.uint8)
    lib.marlin_g1_fixed_powers(base_arr, sc, len(scalars), out, inf)
    return _g1_out_to_list(out, inf)


def g2_fixed_base_powers(base: tuple, scalars: list) -> list:
    """[s*base] for a G2 affine base ((x0,x1),(y0,y1)) -> same structure."""
    lib = _load()
    (x0, x1), (y0, y1) = base
    base_arr = np.asarray(
        _int_to_limbs(x0, 6) + _int_to_limbs(x1, 6) + _int_to_limbs(y0, 6) + _int_to_limbs(y1, 6),
        dtype=np.uint64,
    )
    sc = _scalars_arr(scalars)
    out = np.zeros((len(scalars), 24), dtype=np.uint64)
    inf = np.zeros(len(scalars), dtype=np.uint8)
    lib.marlin_g2_fixed_powers(base_arr, sc, len(scalars), out, inf)
    res = []
    for i in range(len(scalars)):
        if inf[i]:
            res.append(None)
        else:
            res.append(
                (
                    (_limbs_to_int(out[i, :6]), _limbs_to_int(out[i, 6:12])),
                    (_limbs_to_int(out[i, 12:18]), _limbs_to_int(out[i, 18:24])),
                )
            )
    return res


def g1_msm(points: list, scalars: list):
    """Σ s_i P_i over affine int tuples -> affine tuple or None."""
    lib = _load()
    pts, inf = _g1_affine_arr(points)
    sc = _scalars_arr(scalars)
    out = np.zeros((1, 12), dtype=np.uint64)
    oinf = np.zeros(1, dtype=np.uint8)
    lib.marlin_g1_msm(pts, inf, sc, len(points), out, oinf)
    return _g1_out_to_list(out, oinf)[0]


def g1_mul(p: tuple, k: int):
    """k * P for an affine int tuple (None = identity)."""
    if p is None:
        return None
    lib = _load()
    base = np.asarray(_int_to_limbs(p[0], 6) + _int_to_limbs(p[1], 6), dtype=np.uint64)
    sc = _scalars_arr([k])[0]
    out = np.zeros((1, 12), dtype=np.uint64)
    oinf = np.zeros(1, dtype=np.uint8)
    lib.marlin_g1_mul(base, sc, out, oinf)
    return _g1_out_to_list(out, oinf)[0]


def g2_mul(p: tuple, k: int):
    """k * Q for an affine G2 ((x0,x1),(y0,y1)) tuple (None = identity)."""
    if p is None:
        return None
    lib = _load()
    (x0, x1), (y0, y1) = p
    base = np.asarray(
        _int_to_limbs(x0, 6) + _int_to_limbs(x1, 6) + _int_to_limbs(y0, 6) + _int_to_limbs(y1, 6),
        dtype=np.uint64,
    )
    sc = _scalars_arr([k])[0]
    out = np.zeros(24, dtype=np.uint64)
    oinf = np.zeros(1, dtype=np.uint8)
    lib.marlin_g2_mul(base, sc, out, oinf)
    if oinf[0]:
        return None
    return (
        (_limbs_to_int(out[:6]), _limbs_to_int(out[6:12])),
        (_limbs_to_int(out[12:18]), _limbs_to_int(out[18:24])),
    )


# --- pairing (BLS12-381 only, like the rest of this runtime) -----------------

_FQ12_SLOTS = 6  # ((c00,c01,c02),(c10,c11,c12)), each an Fq2 pair


def _fq12_to_limbs(f) -> np.ndarray:
    out = np.zeros(72, dtype=np.uint64)
    k = 0
    for six in f:
        for a0, a1 in six:
            out[k * 12 : k * 12 + 6] = _int_to_limbs(a0, 6)
            out[k * 12 + 6 : k * 12 + 12] = _int_to_limbs(a1, 6)
            k += 1
    return out


def _limbs_to_fq12(arr: np.ndarray):
    vals = [
        (_limbs_to_int(arr[k * 12 : k * 12 + 6]), _limbs_to_int(arr[k * 12 + 6 : k * 12 + 12]))
        for k in range(6)
    ]
    return ((vals[0], vals[1], vals[2]), (vals[3], vals[4], vals[5]))


def _hard_digits_arr() -> np.ndarray:
    """Base-q digits of the hard exponent, derived by host_pairing (the C
    side takes them as input so no addition chain is hand-copied)."""
    from . import host_pairing as hp

    out = np.zeros(24, dtype=np.uint64)
    for i, d in enumerate(hp._HARD_DIGITS):
        out[i * 6 : (i + 1) * 6] = _int_to_limbs(d, 6)
    return out


def miller_loop(p_affine, q_affine):
    """Native ate Miller loop; returns the same nested Fq12 tuples as
    host_pairing.miller_loop (bit-identical, tested)."""
    lib = _load()
    out = np.zeros(72, dtype=np.uint64)
    if p_affine is None or q_affine is None:
        p_arr = np.zeros(12, dtype=np.uint64)
        q_arr = np.zeros(24, dtype=np.uint64)
        lib.marlin_miller_loop(p_arr, 1, q_arr, 1, out)
    else:
        p_arr = np.asarray(
            _int_to_limbs(p_affine[0], 6) + _int_to_limbs(p_affine[1], 6), dtype=np.uint64
        )
        (x0, x1), (y0, y1) = q_affine
        q_arr = np.asarray(
            _int_to_limbs(x0, 6) + _int_to_limbs(x1, 6) + _int_to_limbs(y0, 6) + _int_to_limbs(y1, 6),
            dtype=np.uint64,
        )
        lib.marlin_miller_loop(p_arr, 0, q_arr, 0, out)
    return _limbs_to_fq12(out)


def final_exponentiation(f):
    """Production x-chain final exponentiation (exact f^h; see
    csrc final_exp_x — h = u·(x+q)·(x²+q²-1)+1, u = (x-1)²/3)."""
    lib = _load()
    out = np.zeros(72, dtype=np.uint64)
    lib.marlin_final_exp_x(_fq12_to_limbs(f), out)
    return _limbs_to_fq12(out)


def final_exponentiation_digits(f):
    """Generic 4-digit base-q shared-chain path (differential oracle)."""
    lib = _load()
    out = np.zeros(72, dtype=np.uint64)
    lib.marlin_final_exp(_fq12_to_limbs(f), _hard_digits_arr(), out)
    return _limbs_to_fq12(out)


def multi_pairing_raw(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — full twist-loop path (parity oracle for the
    prepared variant below)."""
    lib = _load()
    k = len(pairs)
    g1s = np.zeros((k, 12), dtype=np.uint64)
    g1_inf = np.zeros(k, dtype=np.uint8)
    g2s = np.zeros((k, 24), dtype=np.uint64)
    g2_inf = np.zeros(k, dtype=np.uint8)
    for i, (p, q) in enumerate(pairs):
        if p is None:
            g1_inf[i] = 1
        else:
            g1s[i, :6] = _int_to_limbs(p[0], 6)
            g1s[i, 6:] = _int_to_limbs(p[1], 6)
        if q is None:
            g2_inf[i] = 1
        else:
            (x0, x1), (y0, y1) = q
            g2s[i, :6] = _int_to_limbs(x0, 6)
            g2s[i, 6:12] = _int_to_limbs(x1, 6)
            g2s[i, 12:18] = _int_to_limbs(y0, 6)
            g2s[i, 18:24] = _int_to_limbs(y1, 6)
    return bool(lib.marlin_multi_pairing(g1s, g1_inf, g2s, g2_inf, k, _hard_digits_arr()))


# prepared G2 tables (ark-ec G2Prepared analog): the verifier's G2 points
# are fixed per key, so the twist loop — and every Fq2 inversion in it —
# runs once per distinct point and is replayed as sparse multiplications
_PREPARED: dict = {}


def g2_prepare(q) -> np.ndarray:
    """Per-Miller-step (lam, mu) table for an affine G2 point (cached)."""
    key = q
    tab = _PREPARED.get(key)
    if tab is None:
        lib = _load()
        nsteps = lib.marlin_g2_prepare_nsteps()
        (x0, x1), (y0, y1) = q
        q_arr = np.asarray(
            _int_to_limbs(x0, 6) + _int_to_limbs(x1, 6) + _int_to_limbs(y0, 6) + _int_to_limbs(y1, 6),
            dtype=np.uint64,
        )
        tab = np.zeros(nsteps * 24, dtype=np.uint64)
        lib.marlin_g2_prepare(q_arr, tab)
        _PREPARED[key] = tab
    return tab


def multi_pairing(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 via prepared G2 tables and merged Miller loops
    (one shared square chain, one final exponentiation)."""
    lib = _load()
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return True
    k = len(live)
    nsteps = lib.marlin_g2_prepare_nsteps()
    g1s = np.zeros((k, 12), dtype=np.uint64)
    g1_inf = np.zeros(k, dtype=np.uint8)
    coeffs = np.zeros((k, nsteps * 24), dtype=np.uint64)
    for i, (p, q) in enumerate(live):
        g1s[i, :6] = _int_to_limbs(p[0], 6)
        g1s[i, 6:] = _int_to_limbs(p[1], 6)
        coeffs[i] = g2_prepare(q)
    return bool(
        lib.marlin_multi_pairing_prepared(
            g1s, g1_inf, np.ascontiguousarray(coeffs), k, _hard_digits_arr()
        )
    )
