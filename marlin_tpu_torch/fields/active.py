"""The active curve configuration.

The JAX package selects its curve per process through `MARLIN_TPU_CURVE`.
This package has ported BLS12-381 only: the variable may be unset or name
`bls12_381`, and any other value raises at import.
"""

import os
import sys

from . import bls12_381 as _mod

_name = os.environ.get("MARLIN_TPU_CURVE", "bls12_381")
if _name != "bls12_381":
    raise NotImplementedError(
        f"curve {_name!r} is not yet ported to marlin_tpu_torch (only bls12_381)"
    )
sys.modules[__name__] = _mod
