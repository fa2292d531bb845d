"""The mesh layer: sharded NTTs and MSMs over a grid of devices.

Port of `marlin_tpu/parallel/`.  A mesh is a named grid of
`torch.device`s, in one process or spanning several
(`multihost.Mesh`, `multihost.init_distributed`); inside
`context.use_mesh(mesh)` the NTT and MSM entry points of `ops/` route
large enough operands to the four-step NTT (`ntt_sharded.py`) and the
distributed Pippenger (`msm_sharded.py`), whose shards exchange through
`collectives.py` and whose results equal the single-device ones.
"""
