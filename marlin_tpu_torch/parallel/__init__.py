"""The mesh layer: sharded NTTs and MSMs over a grid of devices.

Port of `marlin_tpu/parallel/`.  A mesh is a named grid of
`torch.device`s in one process (`multihost.Mesh`); inside
`context.use_mesh(mesh)` the NTT and MSM entry points of `ops/` route
large enough operands to the four-step NTT (`ntt_sharded.py`) and the
distributed Pippenger (`msm_sharded.py`), whose results equal the
single-device ones.
"""
