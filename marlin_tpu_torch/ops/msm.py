"""Multi-scalar multiplication: the host route.

Port of the `MARLIN_TPU_HOST_MSM=1` branches of `marlin_tpu/ops/msm.py`
(`msm` at :1064, `msm_many` at :1104-1112): the points come back to the
host as affine ints and the sum runs in the native C Pippenger
(csrc/marlin_curve.c).  The JAX package documents this route as giving
bit-identical proofs to its device MSM.  In this slice it is the port's
only MSM, with no switch; a later slice replaces it on the card with the
fixed-table MSM and its bucket-fold and Jacobian add/double kernels.
"""

from __future__ import annotations

import torch

from ..fields import host_curve as hc
from ..fields import native_curve as nc
from . import curve_device as cd
from . import fr


def _host_msm(points: cd.Point, scalars_mont: torch.Tensor) -> cd.Point:
    if not nc.available():
        raise RuntimeError("the native curve library (csrc/marlin_curve.c) failed to build")
    affs = cd.to_affine_ints_host(points)
    scals = fr.to_ints(scalars_mont)
    res = hc.g1_msm(affs, scals)
    return cd.from_affine_ints([res], scalars_mont.device)


def msm(points: cd.Point, scalars_mont: torch.Tensor) -> cd.Point:
    """Σ_i s_i P_i -> single Jacobian point (shape [1]).

    points: [n] Jacobian batch; scalars_mont: [n, 16] Fr Montgomery limbs."""
    return _host_msm(points, scalars_mont)


def msm_many(powers: cd.Point, jobs: list) -> list:
    """Several MSMs over slices of one point array.

    jobs: list of (offset, scalars_mont [n_j, 16]) — the points of job j are
    powers[offset : offset+n_j]."""
    return [
        _host_msm(tuple(powers[i][off : off + scal.shape[0]] for i in range(3)), scal)
        for off, scal in jobs
    ]
