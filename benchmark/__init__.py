"""The benchmark of the PyTorch and CUDA port (`marlin_tpu_torch`) on an
NVIDIA H100: `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the repository root (see run.py)."""
