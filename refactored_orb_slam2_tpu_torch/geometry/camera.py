"""Pinhole camera with OpenCV radial-tangential distortion (port of
geometry/camera.py).

Intrinsics are Python floats rounded to float32, so ``cam.fx * tensor`` is
the same float32 product the JAX package computes with its ``np.float32``
scalars.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


@dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics + distortion + stereo baseline (``bf`` =
    baseline(m) * fx; 0.0 for monocular)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0
    width: int = 640
    height: int = 480

    @classmethod
    def create(cls, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               bf=0.0, width=640, height=480) -> "Camera":
        return cls(_f32(fx), _f32(fy), _f32(cx), _f32(cy), _f32(k1), _f32(k2),
                   _f32(p1), _f32(p2), _f32(k3), _f32(bf), int(width),
                   int(height))


def camera_from_config(cfg) -> Camera:
    """Camera from a ``utils.config.CameraConfig``."""
    return Camera.create(
        cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.k1, cfg.k2, cfg.p1, cfg.p2,
        cfg.k3, cfg.bf, cfg.width, cfg.height,
    )


def undistort_normalized(cam: Camera, xd: torch.Tensor,
                         iters: int = 10) -> torch.Tensor:
    """Invert distortion by fixed-point iteration (cv::undistortPoints)."""
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy2 = 2.0 * x * y
        dx = cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p2 * xy2 + cam.p1 * (r2 + 2.0 * y * y)
        xn = torch.stack([(xd[..., 0] - dx) / radial,
                          (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def pixel_to_normalized(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def normalized_to_pixel(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    return torch.stack([xn[..., 0] * cam.fx + cam.cx,
                        xn[..., 1] * cam.fy + cam.cy], dim=-1)


def undistort_pixels(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Raw keypoint pixels -> undistorted pixels (Frame::UndistortKeyPoints)."""
    return normalized_to_pixel(
        cam, undistort_normalized(cam, pixel_to_normalized(cam, uv))
    )


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> undistorted pixel coords (..., 2),
    with the depth floored away from zero (callers gate on depth)."""
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * pc[..., 0] / z_safe + cam.cx
    v = cam.fy * pc[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1)
