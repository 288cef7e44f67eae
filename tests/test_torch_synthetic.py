"""The port's ``utils/synthetic.py`` and ``scripts/run_synthetic.py`` on the
CPU, against the JAX package's module of the same name.

- ``SyntheticWorld.create`` gives equal arrays for the same arguments, and
  ``render``, ``render_stereo`` and ``render_depth`` equal images from the
  same poses and noise generator (the same numpy code).
- ``smooth_trajectory`` within 1e-5 (its one twist exponential is the
  port's ``se3.exp`` in torch against JAX's), ``ate_rmse`` and
  ``ate_rmse_sim3`` equal on the same inputs.
- ``python -m refactored_orb_slam2_tpu_torch.scripts.run_synthetic --cpu``
  tracks a few frames of each sensor and prints the JAX driver's lines;
  without ``--cpu`` on a machine without CUDA it exits naming CUDA.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.utils import synthetic as JS
from refactored_orb_slam2_tpu.utils.config import CameraConfig
from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.utils import synthetic as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = camera_from_config(config_from_reference(CameraConfig(
    fx=112.5, fy=112.5, cx=80.0, cy=45.0, bf=56.25, width=160, height=90)))
WORLDS = [dict(seed=3, n_points=800, x_range=(-10, 10), y_range=(-3, 3),
               z_range=(3.0, 14.0), clear_tube=0.0),
          dict(seed=0), dict(seed=7, n_points=50, size_range=(0.02, 0.06), clear_tube=0.5)]


@pytest.mark.parametrize("kw", WORLDS)
def test_world_arrays_equal(kw):
    j, t = JS.SyntheticWorld.create(**kw), TS.SyntheticWorld.create(**kw)
    for name in ("points", "intensity", "size", "textures"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", WORLDS[:2])
def test_renders_equal_from_the_same_poses(kw):
    j, t = JS.SyntheticWorld.create(**kw), TS.SyntheticWorld.create(**kw)
    poses = JS.smooth_trajectory(4, step=0.3, yaw_rate=0.02, seed=0)
    jr, tr = np.random.default_rng(1), np.random.default_rng(1)
    for T in poses:
        np.testing.assert_array_equal(t.render(T, CAM, noise=2.0, rng=tr),
                                      j.render(T, CAM, noise=2.0, rng=jr))
        for a, b in zip(t.render_stereo(T, CAM, noise=2.0, rng=tr),
                        j.render_stereo(T, CAM, noise=2.0, rng=jr)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.render_depth(T, CAM), j.render_depth(T, CAM))


@pytest.mark.parametrize("n,step,yaw", [(30, 0.06, 0.004), (12, 0.1, 0.03), (1, 0.06, 0.0)])
def test_smooth_trajectory_within_1e5(n, step, yaw):
    t = TS.smooth_trajectory(n, step=step, yaw_rate=yaw)
    j = JS.smooth_trajectory(n, step=step, yaw_rate=yaw)
    assert t.shape == j.shape == (n, 4, 4) and t.dtype == j.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


def test_ate_functions_equal():
    rng = np.random.default_rng(4)
    gt = np.cumsum(rng.normal(0, 0.1, (50, 3)), axis=0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    est = 1.7 * (gt @ q.T) + rng.normal(0, 0.01, gt.shape) + [0.3, -2.0, 1.0]
    for name in ("ate_rmse", "ate_rmse_sim3"):
        assert getattr(TS, name)(est, gt) == getattr(JS, name)(est, gt)
    assert TS.ate_rmse_sim3(est, gt) < 0.05 < TS.ate_rmse(est, gt)


def _driver(args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "refactored_orb_slam2_tpu_torch.scripts.run_synthetic",
                           *args], capture_output=True, text=True, timeout=600, cwd=REPO, env=env)


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_run_synthetic_on_the_cpu(tmp_path, sensor):
    torch.set_num_threads(1)
    res = _driver(["--cpu", "--sensor", sensor, "--frames", "4",
                   "--out", str(tmp_path / "run")])
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    m = re.fullmatch(rf"sensor={sensor} frames=4 lost=(\d+) keyframes=(\d+) points=(\d+)", lines[-4])
    assert m and int(m.group(1)) == 0 and int(m.group(2)) >= 1 and int(m.group(3)) > 100, lines
    assert re.fullmatch(r"track time: median=[\d.]+ ms mean=[\d.]+ ms", lines[-3])
    ate = re.fullmatch(r"ATE RMSE: ([\d.]+) m over ([\d.]+) m path", lines[-2])
    assert ate and float(ate.group(1)) < 0.02 and float(ate.group(2)) == pytest.approx(0.24, abs=1e-3)
    for name in ("trajectory_tum.txt", "trajectory_kitti.txt"):
        assert len((tmp_path / "run" / name).read_text().splitlines()) == 4


def test_run_synthetic_without_cpu_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the driver would run on it")
    res = _driver(["--frames", "2", "--out", str(tmp_path / "run")])
    assert res.returncode != 0 and "CUDA" in res.stderr and "--cpu" in res.stderr
