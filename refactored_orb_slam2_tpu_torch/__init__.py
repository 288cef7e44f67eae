"""refactored_orb_slam2_tpu_torch — the PyTorch + CUDA port of the SLAM engine.

A second package beside ``refactored_orb_slam2_tpu`` (the JAX reference).
Each module keeps the path and function names of its JAX counterpart, so
``refactored_orb_slam2_tpu/ops/orb.py`` is ported by
``refactored_orb_slam2_tpu_torch/ops/orb.py``.  The port imports ``torch``
and never ``jax``, and nothing of the JAX package: it keeps its own copies
of the config tree (``config.py``), the presets (``utils/presets.py``),
the telemetry counters (``utils/telemetry.py``) and the rBRIEF pattern
(``ops/orb_pattern.py``).

Today it runs RGB-D, stereo and monocular tracking with keyframe insertion
and synchronous local mapping, and localization-only mode
(``system.SlamSystem.track_rgbd`` / ``track_stereo`` / ``track_monocular``),
with two hand-written CUDA kernels: the fused window matcher and the masked
best-2 matcher (``ops/cuda_hamming.py`` over ``csrc/window_match.cu`` and
``csrc/masked_best2.cu``).
"""

__version__ = "0.1.0"
