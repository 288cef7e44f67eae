"""Reprojection residuals and analytic Jacobians for pose-only optimization
(port of optim/residuals.py; g2o's EdgeSE3ProjectXYZOnlyPose and
EdgeStereoSE3ProjectXYZOnlyPose as batched closed forms).

chi-square gates (95%): 5.991 for 2-DoF mono edges, 7.815 for 3-DoF stereo
edges (Optimizer.cc:365-372).
"""

from __future__ import annotations

import torch

from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-6, 1e-6, z)


def stereo_residual(cam, Tcw: torch.Tensor, pw: torch.Tensor, obs: torch.Tensor):
    """obs = (u, v, uR) -> residual obs - pred (N, 3), and camera points."""
    pc = se3.transform(Tcw, pw)
    z_safe = _safe_z(pc[..., 2])
    u = cam.fx * pc[..., 0] / z_safe + cam.cx
    v = cam.fy * pc[..., 1] / z_safe + cam.cy
    ur = u - cam.bf / z_safe
    return obs - torch.stack([u, v, ur], dim=-1), pc


def stereo_jacobian_pc(cam, pc: torch.Tensor) -> torch.Tensor:
    """d(u, v, uR)/d pc: (N, 3, 3)."""
    x, y = pc[..., 0], pc[..., 1]
    iz = 1.0 / _safe_z(pc[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    row_ur = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2], dim=-1)
    return torch.stack([row_u, row_v, row_ur], dim=-2)


def pc_jacobian_twist(pc: torch.Tensor) -> torch.Tensor:
    """d pc / d xi for a left-multiplicative twist: [I | -hat(pc)], (N, 3, 6)."""
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    return torch.cat([eye, -se3.hat(pc)], dim=-1)


def huber_weight(chi2: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """IRLS weight of g2o's Huber kernel: 1 inside delta^2, else
    delta / sqrt(chi2)."""
    e = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / e))
