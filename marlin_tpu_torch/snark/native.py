"""ctypes bindings for the native host runtime (csrc/marlin_host.c).

The reference's transcript primitives are native Rust crates (`blake2`,
`rand_chacha` — SURVEY.md §2b rows 8-9); ours are C, auto-built on first
use with the system compiler and loaded via ctypes.  `available()`
reports whether the library is usable; fs.py falls back to hashlib /
pure-Python ChaCha when it is not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_LIB = None
_TRIED = False

# the shared C sources live at the repository root; this package builds its
# own copy of the library into marlin_tpu_torch/build/
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "marlin_host.c")
_BUILD_DIR = os.path.join(_PKG, "build")
_SO = os.path.join(_BUILD_DIR, "libmarlin_host.so")


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
                ["cc", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)  # atomic: parallel test workers may race here
        lib = ctypes.CDLL(_SO)
        lib.marlin_blake2s256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        lib.marlin_chacha20_block.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
        lib.marlin_fs_absorb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def blake2s256(data: bytes) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(32)
    lib.marlin_blake2s256(data, len(data), out)
    return out.raw


def chacha20_block(key: bytes, counter: int) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(64)
    lib.marlin_chacha20_block(key, counter, out)
    return out.raw


def fs_absorb(data: bytes, seed: bytes) -> bytes:
    lib = _load()
    buf = ctypes.create_string_buffer(seed, 32)
    lib.marlin_fs_absorb(data, len(data), buf)
    return buf.raw
