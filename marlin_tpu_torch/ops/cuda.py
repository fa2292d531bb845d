"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The kernels compute with compile-time moduli (csrc/mont.cuh), so the
sources are compiled once per curve, with `-DMARLIN_CURVE_<NAME>`, for
`sm_90a` into `marlin_tpu_torch/build/<curve>/libmarlin_cuda.so`, which has
a plain C interface and is loaded with ctypes.  A curve's library holds the
kernels of its sources (`sources(curve)`): every source for a curve with a
group, the field and NTT kernels only for `test_wide750`, a field with no
curve.  `lib()` builds and loads the library of the active curve
(`fields.active`, chosen by `MARLIN_TPU_CURVE`) at first use, binds every
entry of its sources (a missing one raises) and no other, and refuses a
library whose `marlin_curve_id` names another curve.  `build(curves)`
compiles several curves' libraries at once: one `nvcc -c` per source and
curve, all started together, then one link each.  Nothing is built when the package is
imported, and nothing here is reached for CPU tensors.  A build or launch
failure raises; nothing falls back.

Every kernel entry returns the `cudaError_t` of its launch; `check` raises
on a nonzero code.  Each kernel keeps a launch counter in `LAUNCHES`,
incremented by its wrapper right where it launches, so a run can show which
kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = ("field.cu", "ntt.cu", "curve.cu", "chain.cu", "imad.cu")
# a field with no curve builds no group kernel
_FIELD_ONLY_SOURCES = ("field.cu", "ntt.cu", "imad.cu")
_HEADERS = ("mont.cuh", "group.cuh")
_BUILD_ROOT = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# the curves csrc/mont.cuh has traits for, and the number each context
# carries in its kernel_params (ModParams.curve, MARLIN_CURVE_ID)
CURVE_IDS = {"bls12_381": 1, "bn254": 2, "bls12_377": 3, "synthetic_lowadic": 4, "test_wide750": 5}
# the curves of CURVE_IDS with no group: an Fr and nothing else
FIELD_ONLY = ("test_wide750",)
# the field a host entry is asked for (csrc/mont.cuh kFieldFr, kFieldFq)
FIELD_IDS = {"fr": 0, "fq": 1}
# per-source flags.  curve.cu: ptxas's default (-O3) schedule interleaves the
# group law's independent Fq products and then spills under the register cap
# of four blocks an SM; its -O1 schedule keeps them in order (72-162
# registers at 12-word Fq, no spill) at the same speed on the H100
# (PERF.md).  chain.cu (the ladder and the window combine) takes ptxas's default
# -O3 and no register cap: its kernels hold a point and a level's operands
# in registers (155-186 of them at 12-word Fq, no spill; PERF.md §6).  The
# build records every kernel's registers and spills per curve
# (build/<curve>/<source>.ptxas.txt; chip_smoke.py fails on a spill).
_SOURCE_FLAGS = {"curve.cu": ["-Xptxas", "-O1"]}


def active_curve() -> str:
    from ..fields import active as P

    return P.CURVE_NAME


def build_dir(curve: str | None = None) -> str:
    return os.path.join(_BUILD_ROOT, curve or active_curve())


def lib_path(curve: str | None = None) -> str:
    return os.path.join(build_dir(curve), "libmarlin_cuda.so")


# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "field_binop": 0,
    "field_inv": 0,
    "ntt_block_stages": 0,
    "ntt_cross_stage": 0,
    "g1_add": 0,
    "g1_double": 0,
    "g1_scalar_mul": 0,
    "bucket_fold": 0,
    "combine_windows": 0,
}
# the field binop's launches split by (field, op), e.g. ("fr", "mul")
BINOP_LAUNCHES: dict[tuple, int] = {}
# the binop's operand copies before a launch: "broadcast", a broadcast its
# row map cannot express, made to the full shape; "layout", an operand that
# is not contiguous or not 16-byte aligned (ops/bigint.py::binop_kernel)
BINOP_COPIES: dict[str, int] = {"broadcast": 0, "layout": 0}

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# each source's entries and their argument types
_SIGNATURES = {
    "field.cu": {
        # (kind, field, a, b, out, n, a_div, a_period, b_div, b_period, staged, params, stream)
        "marlin_field_binop": [_I, _I, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _I, _P, _P],
        # (field, x, out, n, params, stream)
        "marlin_field_inv": [_I, _P, _P, _LL, _P, _P],
    },
    "ntt.cu": {
        # (x, y, total, log_n, log_b, twiddles, scale, params, stream)
        "marlin_ntt_block_stages": [_P, _P, _LL, _I, _I, _P, _P, _P, _P],
        # (x, total, s0, s1, twiddles, params, stream)
        "marlin_ntt_cross_stages": [_P, _LL, _I, _I, _P, _P, _P],
    },
    "curve.cu": {
        # (x1, y1, z1, x2, y2, z2, ox, oy, oz, n, stream)
        "marlin_g1_add": [_P] * 9 + [_LL, _P],
        # (x, y, z, ox, oy, oz, n, stream)
        "marlin_g1_double": [_P] * 6 + [_LL, _P],
        # (exact, table, layout, lanes, cap, log_sub, ox, oy, oz, flags, stream)
        "marlin_bucket_fold": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
        # (which, *regs, *local_bytes, *blocks_per_sm)
        "marlin_curve_kernel_info": [_I, _P, _P, _P],
    },
    "chain.cu": {
        # (x, y, z, scalars, num_bits, ox, oy, oz, n, stream)
        "marlin_g1_scalar_mul": [_P, _P, _P, _P, _I, _P, _P, _P, _LL, _P],
        # (x, y, z, W, c, ox, oy, oz, stream)
        "marlin_combine_windows": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
        # (which, *regs, *local_bytes, *blocks_per_sm)
        "marlin_chain_kernel_info": [_I, _P, _P, _P],
    },
    "imad.cu": {
        # (rows, in, blocks, iters, out, cycles, stream)
        "marlin_imad_rate": [_I, _P, _I, _I, _P, _P, _P],
        # (*blocks_per_sm, *threads)
        "marlin_imad_rate_shape": [_P, _P],
        # (field, in, iters, out, cycles, stream)
        "marlin_product_chain": [_I, _P, _I, _P, _P, _P],
    },
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BINOP_LAUNCHES.clear()
    for k in BINOP_COPIES:
        BINOP_COPIES[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources(curve: str) -> tuple:
    """The kernel sources of `curve`'s library."""
    return _FIELD_ONLY_SOURCES if curve in FIELD_ONLY else _SOURCES


def _stale(curve: str) -> bool:
    so = lib_path(curve)
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    return any(
        os.path.getmtime(os.path.join(_CSRC, f)) > built for f in sources(curve) + _HEADERS
    )


def build(curves=None) -> float:
    """Compile the kernel library of each curve (the active one by default)
    whose library is missing or stale, every source of every curve in one
    parallel round of `nvcc`; -> seconds."""
    start = time.perf_counter()
    todo = [c for c in (curves or [active_curve()]) if _stale(c)]
    for c in todo:
        if c not in CURVE_IDS:
            raise ValueError(f"no CUDA traits for curve {c!r} (csrc/mont.cuh)")
    if not todo:
        return time.perf_counter() - start
    nvcc = _nvcc()
    os.makedirs(_BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_ROOT) as tmp:
        procs = []
        for c in todo:
            os.makedirs(build_dir(c), exist_ok=True)
            for src in sources(c):
                obj = os.path.join(tmp, f"{c}.{src.replace('.cu', '.o')}")
                cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", f"-DMARLIN_CURVE_{c.upper()}",
                       "-Xcompiler", "-fPIC", "-Xptxas", "-v", *_SOURCE_FLAGS.get(src, []),
                       "-c", os.path.join(_CSRC, src), "-o", obj]
                procs.append((c, src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = None
        for c, src, _, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed = failed or f"nvcc failed on {src} for {c}:\n{out}"
                continue
            with open(os.path.join(build_dir(c), src + ".ptxas.txt"), "w") as f:
                f.write(out)
        if failed:
            raise RuntimeError(failed)
        for c in todo:
            so_tmp = os.path.join(tmp, f"{c}.so")
            objs = [obj for cc, _, obj, _ in procs if cc == c]
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", so_tmp, *objs],
                capture_output=True, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed for {c}:\n{link.stdout}{link.stderr}")
            os.replace(so_tmp, lib_path(c))
    return time.perf_counter() - start


def lib():
    """The loaded kernel library of the active curve (built on first call),
    with the entries of its sources bound; raises on a failed build, a
    missing entry or a library of another curve."""
    global _LIB
    if _LIB is None:
        curve = active_curve()
        build([curve])
        handle = ctypes.CDLL(lib_path(curve))
        for src in sources(curve):
            for name, argtypes in _SIGNATURES[src].items():
                try:
                    fn = getattr(handle, name)
                except AttributeError:
                    raise RuntimeError(f"{lib_path(curve)} lacks {name} of {src}") from None
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        handle.marlin_curve_id.argtypes = []
        handle.marlin_curve_id.restype = ctypes.c_char_p
        built_for = handle.marlin_curve_id().decode()
        if built_for != curve:
            raise RuntimeError(f"{lib_path(curve)} was built for {built_for!r}, not {curve!r}")
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_field_tensor(t, name: str, L: int) -> None:
    import torch

    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: on {t.device}, but kernels launch on the current device")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.shape[-1] != L:
        raise ValueError(f"{name}: expected {L} limbs, got shape {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor")
