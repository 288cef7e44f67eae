"""Batched two-view triangulation, linear DLT (port of
geometry/triangulation.py; Initializer::Triangulate, Initializer.cc:723-737,
and the triangulation inside LocalMapping::CreateNewMapPoints,
LocalMapping.cc:296-322), and the acceptance gates after it.
"""

from __future__ import annotations

import torch

from . import se3


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, xn1: torch.Tensor,
                    xn2: torch.Tensor) -> torch.Tensor:
    """Points from two (..., 3, 4) projections and (N, 2) normalized image
    coordinates in each view: the null vector of the 4x4 DLT system (its
    smallest right singular vector), dehomogenised.  Returns (..., N, 3) in
    the frame P1 and P2 project from; leading dimensions of the projections
    are a batch of camera pairs over the same correspondences."""
    row = lambda P, i: P[..., None, i, :]
    a0 = xn1[..., 0:1] * row(P1, 2) - row(P1, 0)
    a1 = xn1[..., 1:2] * row(P1, 2) - row(P1, 1)
    a2 = xn2[..., 0:1] * row(P2, 2) - row(P2, 0)
    a3 = xn2[..., 1:2] * row(P2, 2) - row(P2, 1)
    a0, a1, a2, a3 = torch.broadcast_tensors(a0, a1, a2, a3)
    A = torch.stack([a0, a1, a2, a3], dim=-2)                  # (N, 4, 4)
    ph = torch.linalg.svd(A).Vh[..., 3, :]
    w = ph[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return ph[..., :3] / w_safe[..., None]


def triangulation_checks(
    p3d: torch.Tensor,
    T1w: torch.Tensor,
    T2w: torch.Tensor,
    xn1: torch.Tensor,
    xn2: torch.Tensor,
    sigma2_1,
    sigma2_2,
    fx1,
    fy1,
    fx2,
    fy2,
    min_parallax_cos: float = 0.9998,
    chi2_th: float = 5.991,
) -> torch.Tensor:
    """Acceptance gates after triangulation (LocalMapping.cc:326-402).

    p3d in the world frame; T1w/T2w world->camera; xn normalized coords.
    Returns the bool mask of accepted points: finite, positive depth in both
    views, parallax below the cosine bound, reprojection chi2 in both views.
    (Scale consistency is applied by the caller, who knows the octaves.)
    """
    pc1 = se3.transform(T1w, p3d)
    pc2 = se3.transform(T2w, p3d)
    z1, z2 = pc1[..., 2], pc2[..., 2]

    finite = torch.all(torch.isfinite(p3d), dim=-1)
    pos = (z1 > 1e-6) & (z2 > 1e-6)

    # parallax: angle between the rays from each camera centre
    r1 = p3d - se3.translation(se3.inv(T1w))
    r2 = p3d - se3.translation(se3.inv(T2w))
    cosp = torch.sum(r1 * r2, dim=-1) / (
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12
    )
    parallax_ok = cosp < min_parallax_cos

    z1s = torch.where(pos, z1, 1.0)
    z2s = torch.where(pos, z2, 1.0)
    e1 = pc1[..., :2] / z1s[..., None] - xn1
    e2 = pc2[..., :2] / z2s[..., None] - xn2
    chi1 = ((e1[..., 0] * fx1) ** 2 + (e1[..., 1] * fy1) ** 2) / sigma2_1
    chi2 = ((e2[..., 0] * fx2) ** 2 + (e2[..., 1] * fy2) ** 2) / sigma2_2
    reproj_ok = (chi1 <= chi2_th) & (chi2 <= chi2_th)

    return finite & pos & parallax_ok & reproj_ok
