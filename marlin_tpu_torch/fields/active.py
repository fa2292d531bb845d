"""The active curve configuration.

As in the JAX package, `MARLIN_TPU_CURVE` names a config module of this
package (default `bls12_381`; also `bn254`, `bls12_377` and
`synthetic_lowadic`), and every curve-parameterized module imports
`from ..fields import active as P`.  Selection happens once, at the first
import in a process: changing the variable afterwards has no effect.  The
CUDA kernels are compiled per curve (ops/cuda.py builds one library for
the active curve).

`test_wide750` (a 750-bit Fr-only field with 24-word elements) is not
ported yet: the kernels' shared-memory plans stop at 12 words.
"""

import importlib
import os
import sys

_name = os.environ.get("MARLIN_TPU_CURVE", "bls12_381")
if _name == "test_wide750":
    raise NotImplementedError(
        "curve 'test_wide750' is not yet ported to marlin_tpu_torch: its 24-word Fr needs "
        "MARLIN_MAX_NL = 24 and a new shared-memory plan for the NTT block kernel"
    )
_mod = importlib.import_module(f"{__package__}.{_name}")
if not hasattr(_mod, "CURVE_NAME"):
    _mod.CURVE_NAME = _name
sys.modules[__name__] = _mod
