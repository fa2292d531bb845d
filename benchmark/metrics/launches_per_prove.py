"""Launches of the port's own CUDA kernels a prove: the program's counters
`ops/cuda.py::LAUNCHES`, summed over kernels and over the window."""


def read(rec: dict):
    return rec["counters"]["launches"] / rec["num_proves"] if rec["num_proves"] else None
