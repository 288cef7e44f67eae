"""refactored_orb_slam2_tpu_torch — the PyTorch + CUDA port of the SLAM engine.

A second package beside ``refactored_orb_slam2_tpu`` (the JAX reference).
Each module keeps the path and function names of its JAX counterpart, so
``refactored_orb_slam2_tpu/ops/orb.py`` is ported by
``refactored_orb_slam2_tpu_torch/ops/orb.py``.  The port imports ``torch``
and never ``jax``, and nothing of the JAX package: it keeps its own copies
of the config tree (``config.py``), the presets (``utils/presets.py``),
the telemetry counters (``utils/telemetry.py``), the rBRIEF pattern
(``ops/orb_pattern.py``) and the vocabulary (``assets/vocab.npz``).

Today it runs RGB-D, stereo and monocular tracking with keyframe insertion
and synchronous local mapping, relocalization (``place/`` for the
vocabulary and the KeyFrameDB, ``solvers/epnp.py``) and localization-only
mode (``system.SlamSystem.track_rgbd`` / ``track_stereo`` / ``track_monocular``),
loop closing, map checkpoints in the JAX package's file format
(``io/checkpoint.py``), the dataset readers (``io/datasets.py``) and the
figures (``io/viz.py``), with two hand-written CUDA kernels: the fused
window matcher and the masked best-2 matcher (``ops/cuda_hamming.py`` over
``csrc/window_match.cu`` and ``csrc/masked_best2.cu``).  Its command-line
programs run with ``python -m``, the dataset driver among them
(``refactored_orb_slam2_tpu_torch.scripts.run_dataset``); the benchmark
that times it is ``python3 -m slambench.run``.
"""

__version__ = "0.1.0"
