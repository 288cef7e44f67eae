"""SE(3) Lie-group operations on torch tensors (port of geometry/se3.py).

Poses are ``(..., 4, 4)`` float32 world->camera matrices (``Tcw``); the
tangent space is the twist ``xi = [rho(3), phi(3)]`` with left-multiplicative
updates ``T <- Exp(xi) @ T``.  Every function broadcasts over leading batch
dimensions and uses Taylor fallbacks at small angles.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(Phi: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=Phi.dtype, device=Phi.device).expand(Phi.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    Phi = hat(phi)
    return _eye3_like(Phi) + a * Phi + b * (Phi @ Phi)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle, (..., 3, 3) -> (..., 3), through the
    quaternion (``to_quaternion``), stable at every angle including near pi.
    At the identity the small-angle branch is selected, so forward-mode
    derivatives (``torch.func.jacfwd``) stay finite there."""
    q = to_quaternion(R)
    v, w = q[..., :3], q[..., 3]
    # w >= 0 so that theta lies in [0, pi]
    sign = torch.where(w < 0, -1.0, 1.0)
    v = v * sign[..., None]
    w = w * sign
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    # phi = theta v / |v|, and theta / |v| -> 2 / w as theta -> 0
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5),
                        theta / torch.where(small, 1.0, vn))
    return v * scale[..., None]


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi), (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    Phi = hat(phi)
    return _eye3_like(Phi) + b * Phi + c * (Phi @ Phi)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    # fill_, not item assignment: assigning a Python scalar into a CUDA
    # tensor copies it from host memory and synchronizes
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: twist (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return from_rt(R, t)


def inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order.

    Branch-free Shepperd method (Converter::toQuaternion semantics).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s0 = s_of(tr + 1.0)
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0,
                      0.25 * s0], dim=-1)
    s1 = s_of(1.0 + m00 - m11 - m22)
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1,
                      (m21 - m12) / s1], dim=-1)
    s2 = s_of(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2,
                      (m02 - m20) / s2], dim=-1)
    s3 = s_of(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3,
                      (m10 - m01) / s3], dim=-1)
    q = torch.where(
        (tr > 0.0)[..., None], q0,
        torch.where(
            ((m00 >= m11) & (m00 >= m22))[..., None], q1,
            torch.where((m11 >= m22)[..., None], q2, q3),
        ),
    )
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
