"""The port's bench (``python -m refactored_orb_slam2_tpu_torch.bench``) on
the CPU, where it cannot time anything: without CUDA it exits non-zero
naming CUDA and prints no result.  Its parts are rehearsed here: the
configuration is the JAX ``bench.py``'s, the kernel self-check runs (the
plain versions on CPU tensors) and leaves the launch counts as they were,
one timed pass over 22 frames of the ``tests/test_torch_sequence.py``
scenario (320x240) in the JAX bench's mode (cooperative mapping, pipelined
at depth 3, read from its source) passes its own checks, and the JSON line
has the JAX bench's keys plus ``device``.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.utils import config as J
from refactored_orb_slam2_tpu_torch import bench
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
from refactored_orb_slam2_tpu_torch.system import SlamSystem
from test_torch_sequence import TCFG, lateral_traj, render

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX bench.py's JSON line
JAX_KEYS = ["metric", "value", "unit", "vs_baseline", "median_ms", "mean_ms",
            "mean_fps", "median_spread_pct"]


def test_bench_without_cuda_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the bench would run")
    res = subprocess.run([sys.executable, "-m", "refactored_orb_slam2_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and not res.stdout


def _jax_bench_mode() -> dict:
    """The keyword arguments of the ``SlamSystem(cfg, ...)`` call in the
    JAX bench (``bench.py:66-67``), read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "SlamSystem"]
    assert len(calls) == 1
    return {k.arg: ast.literal_eval(k.value) for k in calls[0].keywords}


def test_bench_config_is_the_jax_bench_config():
    """The configuration of ``bench.py:56-67``, and its cooperative,
    pipelined depth-3 mode."""
    assert bench.BENCH_MODE == _jax_bench_mode() == dict(
        cooperative_mapping=True, pipelined=True, pipeline_depth=3)
    ref = J.SystemConfig(
        sensor="rgbd",
        camera=J.CameraConfig(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0,
                              width=640, height=480, fps=30),
        orb=J.ORBConfig(n_features=1000, n_levels=8),
        map=J.MapConfig(max_keyframes=512, max_points=65536, max_obs_per_point=32),
    )
    assert bench.bench_config() == config_from_reference(ref)


def test_kernel_selfcheck_runs_and_leaves_the_counts():
    cuda_hamming.launches.update(window_match=3, hamming_best2=5)
    try:
        bench.kernel_selfcheck(bench.bench_config(), device="cpu")
        assert cuda_hamming.launches == {"window_match": 3, "hamming_best2": 5, "pose_lm": 0}
    finally:
        cuda_hamming.reset_launches()


def test_one_pass_on_the_cpu():
    frames = [(torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)),
               torch.from_numpy(np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)))
              for img, depth in render(lateral_traj(22))]
    slam = SlamSystem(TCFG, device="cpu", **bench.BENCH_MODE)
    slam.track_rgbd_device(*frames[0], 0.0)          # the pass resets the map first
    acc = {"t": 0.0}
    med, mean = bench.run_pass(slam, frames, 1, acc)
    assert med > 0 and mean > 0
    assert 4 <= slam.n_kf <= 64 and len(slam.tracked_logs()) == 22
    assert not slam._inflight and not slam._coop_busy()


def test_summary_has_the_jax_bench_keys():
    out = bench.summarize([(0.30, 0.35), (0.20, 0.25), (0.25, 0.27)], "card, 700.00 W")
    assert list(out) == JAX_KEYS + ["device"]
    assert out["median_ms"] == 250.0 and out["mean_ms"] == 270.0
    assert out["value"] == 4.0 and out["vs_baseline"] == round(4.0 / 30.0, 3)
    assert out["median_spread_pct"] == 40.0 and out["device"] == "card, 700.00 W"
    assert "cooperative mapping" in out["unit"] and "pipeline depth 3" in out["unit"]
    assert "3 passes" in out["unit"]
