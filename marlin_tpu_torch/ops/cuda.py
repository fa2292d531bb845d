"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with `nvcc` for `sm_90a` into
`marlin_tpu_torch/build/libmarlin_cuda.so`, which has a plain C interface
and is loaded with ctypes: one `nvcc -c` per source, all started together,
then one link.  Nothing is built when the package is imported, and nothing
here is reached for CPU tensors.

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
_HEADERS = ("mont.cuh", "group.cuh")
_BUILD_DIR = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD_DIR, "libmarlin_cuda.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# per-source flags.  curve.cu: ptxas's default (-O3) schedule interleaves the
# group law's independent Fq products and then spills under the register cap
# of four blocks an SM; its -O1 schedule keeps them in order (72-162
# registers, no spill) at the same speed on the H100 (PERF.md, PR 4).
# chain.cu (the ladder and the window combine) takes ptxas's default -O3 and
# no register cap: its kernels hold a point and a level's operands in
# registers (155-186 of them, no spill; PERF.md §6).
_SOURCE_FLAGS = {"curve.cu": ["-Xptxas", "-O1"]}

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

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # (kind, nl, a, b, out, n, params, stream)
    "marlin_field_binop": [_I, _I, _P, _P, _P, _LL, _P, _P],
    # (nl, x, out, n, params, stream)
    "marlin_field_inv": [_I, _P, _P, _LL, _P, _P],
    # (x, y, total, log_n, log_b, twiddles, scale, params, stream)
    "marlin_ntt_block_stages": [_P, _P, _LL, _I, _I, _P, _P, _P, _P],
    # (x, total, stage, twiddles, params, stream)
    "marlin_ntt_cross_stage": [_P, _LL, _I, _P, _P, _P],
    # (x1, y1, z1, x2, y2, z2, ox, oy, oz, n, stream)
    "marlin_g1_add": [_P] * 9 + [_LL, _P],
    # (x, y, z, ox, oy, oz, n, stream)
    "marlin_g1_double": [_P] * 6 + [_LL, _P],
    # (x, y, z, scalars, num_bits, ox, oy, oz, n, stream)
    "marlin_g1_scalar_mul": [_P, _P, _P, _P, _I, _P, _P, _P, _LL, _P],
    # (exact, table, layout, lanes, cap, log_sub, ox, oy, oz, flags, stream)
    "marlin_bucket_fold": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    # (x, y, z, W, c, ox, oy, oz, stream)
    "marlin_combine_windows": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    # (which, *regs, *local_bytes, *blocks_per_sm)
    "marlin_curve_kernel_info": [_I, _P, _P, _P],
    "marlin_chain_kernel_info": [_I, _P, _P, _P],
    # (rows, in, blocks, iters, out, cycles, stream)
    "marlin_imad_rate": [_I, _P, _I, _I, _P, _P, _P],
    # (*blocks_per_sm, *threads)
    "marlin_imad_rate_shape": [_P, _P],
    # (nl, in, iters, out, cycles, stream)
    "marlin_product_chain": [_I, _P, _I, _P, _P, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BINOP_LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    built = os.path.getmtime(_SO)
    return any(
        os.path.getmtime(os.path.join(_CSRC, f)) > built for f in _SOURCES + _HEADERS
    )


def build() -> float:
    """Compile the kernels (if the library is missing or stale); -> seconds."""
    start = time.perf_counter()
    if _stale():
        nvcc = _nvcc()
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            objs, procs = [], []
            for src in _SOURCES:
                obj = os.path.join(tmp, src.replace(".cu", ".o"))
                objs.append(obj)
                cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", *_SOURCE_FLAGS.get(src, []),
                       "-c", os.path.join(_CSRC, src), "-o", obj]
                procs.append((src, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            for src, p in procs:
                out, _ = p.communicate()
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src}:\n{out}")
                with open(os.path.join(_BUILD_DIR, src + ".ptxas.txt"), "w") as f:
                    f.write(out)
            so_tmp = os.path.join(tmp, "lib.so")
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", so_tmp, *objs],
                capture_output=True, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
            os.replace(so_tmp, _SO)
    return time.perf_counter() - start


def lib():
    """The loaded kernel library (built on first call); raises on failure."""
    global _LIB
    if _LIB is None:
        build()
        handle = ctypes.CDLL(_SO)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
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
