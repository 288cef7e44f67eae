"""Pose-only LM problems for the tests of ``optimize_pose``: one camera's
edges against fixed map points, drawn from a seed with numpy (no JAX, so
the card tests can import it).

A case is the true pose, a start 2-3 cm and about a degree off, points
0.8-8 m in front of the camera seen with 1 px of noise at octaves 0-7
(``inv_sigma2`` 1.2^-2o), and the kinds a tracked frame meets: stereo
edges (uR from the TUM3 baseline), gross outliers (uniform over the
image), invalid slots, points behind the camera, no valid edge at all.
"""

from __future__ import annotations

import numpy as np
import torch

from refactored_orb_slam2_tpu_torch.geometry import camera as cam_mod

#: the cases' kinds: (share of stereo edges, of gross outliers, of invalid
#: edges, of points behind the camera, every edge invalid)
KINDS = {
    "mono": (0.0, 0.0, 0.0, 0.0, False),
    "stereo_mix": (0.5, 0.0, 0.0, 0.0, False),
    "outliers": (0.5, 0.2, 0.0, 0.0, False),
    "invalid": (0.5, 0.05, 0.3, 0.0, False),
    "behind": (0.5, 0.05, 0.0, 0.1, False),
    "none_valid": (0.5, 0.0, 0.0, 0.0, True),
}
#: the slot counts the port's presets give the LM (run_synthetic, TUM,
#: EuRoC, KITTI) and a small one
SIZES = (300, 800, 1000, 1200, 2000)


def camera():
    """The TUM3 RGB-D camera (640x480, bf 40)."""
    return cam_mod.Camera.create(fx=535.4, fy=539.2, cx=320.1, cy=247.6, bf=40.0,
                                 width=640, height=480)


def _exp(xi: np.ndarray) -> np.ndarray:
    """se(3) exponential in float64 (rotation by Rodrigues, translation as is:
    a start pose only needs to be a rigid motion)."""
    phi = xi[3:]
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    R = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, xi[:3]
    return T


def pose_case(kind: str, n: int, seed: int, device="cpu") -> dict:
    """Keyword arguments of ``optimize_pose`` (besides the camera) for one
    case, float32 and bool tensors on ``device``, and the true pose under
    ``T_true`` (numpy, float64)."""
    p_st, p_out, p_inv, p_behind, none_valid = KINDS[kind]
    rng = np.random.default_rng(seed)
    cam = camera()
    T_true = _exp(np.r_[rng.normal(0, 0.5, 3), rng.normal(0, 0.3, 3)])
    T0 = _exp(np.r_[rng.normal(0, 0.015, 3), rng.normal(0, 0.01, 3)]) @ T_true

    uv = rng.uniform([0, 0], [cam.width, cam.height], (n, 2))
    z = rng.uniform(0.8, 8.0, n)
    behind = rng.random(n) < p_behind
    z = np.where(behind, -rng.uniform(0.3, 3.0, n), z)
    pc = np.c_[(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z]
    R, t = T_true[:3, :3], T_true[:3, 3]
    pw = (pc - t) @ R                                    # R^T (pc - t), row by row

    stereo = rng.random(n) < p_st
    obs = np.c_[uv + rng.normal(0, 1.0, (n, 2)), np.full(n, -1.0)]
    obs[:, 2] = np.where(stereo, obs[:, 0] - cam.bf / z + rng.normal(0, 1.0, n), -1.0)
    gross = rng.random(n) < p_out
    obs[gross, :2] = rng.uniform([0, 0], [cam.width, cam.height], (int(gross.sum()), 2))
    octave = rng.integers(0, 8, n)
    valid = (rng.random(n) >= p_inv) & ~np.full(n, none_valid)

    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return dict(Tcw0=f32(T0), points_w=f32(pw), obs=f32(obs),
                inv_sigma2=f32(1.2 ** (-2.0 * octave)),
                valid=torch.from_numpy(valid).to(device),
                is_stereo=torch.from_numpy(stereo).to(device), T_true=T_true)
