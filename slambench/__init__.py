"""Benchmark of the PyTorch and CUDA port (``refactored_orb_slam2_tpu_torch``)
on one NVIDIA GPU: ``python3 -m slambench.run --workload <cell> ...``."""
