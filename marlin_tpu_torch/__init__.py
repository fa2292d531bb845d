"""marlin_tpu_torch — the Marlin zkSNARK on PyTorch and CUDA (H100).

A port of the JAX package `marlin_tpu` beside it, module for module:
    snark.marlin      — driver: universal_setup / index / prove / verify
    snark.{indexer,prover,verifier,lc}  — the AHP over Fr tensors
    snark.kzg         — MarlinKZG10 commitments (host MSM route)
    ops.*             — field, NTT, polynomial and sparse ops; the CUDA
                        kernels live in csrc/ and are built at first use
    fields.*          — host golden-reference field/curve/pairing layer

It imports torch and numpy, never jax and nothing of `marlin_tpu`.  Entry
points run on the card unless the caller passes `device="cpu"`.
"""

from .snark.errors import (  # noqa: F401
    AHPError,
    IndexTooLargeError,
    MarlinError,
    PolynomialCommitmentError,
)


def __getattr__(name):
    if name == "Marlin":
        from .snark.marlin import Marlin

        return Marlin
    raise AttributeError(name)
