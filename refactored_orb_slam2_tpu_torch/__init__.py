"""refactored_orb_slam2_tpu_torch — the PyTorch + CUDA port of the SLAM engine.

A second package beside ``refactored_orb_slam2_tpu`` (the JAX reference).
Each module keeps the path and function names of its JAX counterpart, so
``refactored_orb_slam2_tpu/ops/orb.py`` is ported by
``refactored_orb_slam2_tpu_torch/ops/orb.py``.  The port imports ``torch``
and never ``jax``; it reuses only the reference's JAX-free modules
(``utils/config.py``, ``utils/presets.py``, ``utils/telemetry.py``,
``ops/orb_pattern.py``).

Today it runs the RGB-D tracking slice (``system.SlamSystem.track_rgbd``)
with one hand-written CUDA kernel, the fused window matcher
(``ops/cuda_hamming.py`` over ``csrc/window_match.cu``).
"""

__version__ = "0.1.0"
