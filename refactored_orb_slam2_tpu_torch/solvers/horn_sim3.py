"""Batched Horn absolute-orientation Sim3 RANSAC for loop alignment (port of
solvers/horn_sim3.py; Sim3Solver.cc).

The closed-form Horn quaternion method on 3-point minimal sets
(ComputeSim3, Sim3Solver.cc:216-322), scale free for monocular, inside a
RANSAC gated by reprojection in both directions (CheckInliers,
Sim3Solver.cc:324-344, chi2 9.21 x sigma2).  All hypotheses are solved and
scored in one batch.  The minimal sets come from a CPU ``torch.Generator``
(``draw_sim3_sets``), as the initializer's and EPnP's do: the port cannot
reproduce ``jax.random``'s stream, so a parity test hands the JAX sets over
through ``sets=``.

``torch.linalg.eigh`` of the batched 4x4 Horn matrices is the one call here
that reads back to the host (its error check) on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .initializer import draw_sets


class Sim3Result(NamedTuple):
    success: torch.Tensor    # () bool
    R12: torch.Tensor        # (3, 3) rotation mapping frame-2 coords into frame 1
    t12: torch.Tensor        # (3,)
    s12: torch.Tensor        # ()
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _horn(a: torch.Tensor, b: torch.Tensor, mu1: torch.Tensor, mu2: torch.Tensor,
          fix_scale: bool):
    """Horn's solution from centred (weighted) rows a, b (..., M, 3) and the
    centroids (..., 3): (R, t, s) with p1 ~ s R p2 + t."""
    M = b.transpose(-1, -2) @ a                     # (..., 3, 3): maps 2 -> 1
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    q = torch.linalg.eigh(N).eigenvectors[..., :, 3]   # largest eigenvalue; (w, x, y, z)
    qw, qx, qy, qz = q.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                     2 * (qx * qz + qw * qy)], -1),
        torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qw * qx)], -1),
        torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)
    if fix_scale:
        s = torch.ones(a.shape[:-2], dtype=a.dtype, device=a.device)
    else:
        # s = D / sum |R b|^2 with D = sum a . R b (Sim3Solver.cc:281-296)
        rb = b @ R.transpose(-1, -2)
        s = torch.sum(a * rb, dim=(-1, -2)) / torch.clamp(torch.sum(rb * rb, dim=(-1, -2)),
                                                          min=1e-12)
    t = mu1 - s[..., None] * (R @ mu2[..., None])[..., 0]
    return R, t, s


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool):
    """Closed-form Horn alignment of (..., M, 3) sets: (R, t, s) with
    p1 ~ s R p2 + t."""
    mu1, mu2 = p1.mean(dim=-2), p2.mean(dim=-2)
    return _horn(p1 - mu1[..., None, :], p2 - mu2[..., None, :], mu1, mu2, fix_scale)


def horn_sim3_masked(p1: torch.Tensor, p2: torch.Tensor, mask: torch.Tensor,
                     fix_scale: bool):
    """Horn alignment over the masked rows of (N, 3) sets, with weight-zeroed
    rows in place of a compaction."""
    w = mask.to(p1.dtype)[:, None]
    n = torch.clamp(w.sum(), min=1.0)
    mu1 = (p1 * w).sum(dim=0) / n
    mu2 = (p2 * w).sum(dim=0) / n
    return _horn((p1 - mu1) * w, (p2 - mu2) * w, mu1, mu2, fix_scale)


def draw_sim3_sets(valid: torch.Tensor, generator: torch.Generator,
                   n_hyps: int = 128) -> torch.Tensor:
    """(n_hyps, 3) int64 sets, uniform without replacement over the valid
    matches (``initializer.draw_sets``)."""
    return draw_sets(valid, n_hyps, 3, generator)


def sim3_ransac(
    p1: torch.Tensor,
    p2: torch.Tensor,
    xn1: torch.Tensor,
    xn2: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    sets: Optional[torch.Tensor] = None,
    fix_scale: bool,
    n_hyps: int = 128,
    chi2_th1=9.21,
    chi2_th2=9.21,
    min_inliers: int = 20,
) -> Sim3Result:
    """RANSAC Horn alignment between matched 3-D point sets of two
    keyframes.  p1, p2: (N, 3) camera-frame positions in keyframe 1 and 2;
    xn1, xn2: (N, 2) normalized observations in each; the chi2 gates are
    already scaled by each point's sigma2 (tensors for per-point gates, as
    the reference's 9.21 x sigma2, Sim3Solver.cc:85-86).  The sets are
    ``sets`` or drawn from ``generator``.  Nothing is read back but eigh's
    check."""
    if sets is None:
        sets = draw_sim3_sets(valid, generator, n_hyps)
    sets = sets.to(p1.device)
    Rs, ts, ss = horn_sim3(p1[sets], p2[sets], fix_scale)         # (H, ...)

    # p2 through S12 into camera 1 against xn1; p1 through S21 into camera 2
    # against xn2
    p2in1 = ss[:, None, None] * (p2 @ Rs.transpose(-1, -2)) + ts[:, None, :]
    z1 = p2in1[..., 2]
    ok1 = z1 > 1e-6
    e1 = torch.sum((p2in1[..., :2] / torch.where(ok1, z1, 1.0)[..., None] - xn1) ** 2, dim=-1)
    s21 = 1.0 / torch.clamp(ss, min=1e-12)
    p1in2 = s21[:, None, None] * ((p1[None] - ts[:, None, :]) @ Rs)
    z2 = p1in2[..., 2]
    ok2 = z2 > 1e-6
    e2 = torch.sum((p1in2[..., :2] / torch.where(ok2, z2, 1.0)[..., None] - xn2) ** 2, dim=-1)
    inl = valid & ok1 & ok2 & (e1 <= chi2_th1) & (e2 <= chi2_th2)
    n_in = inl.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(n_in).reshape(1)                            # first of equals
    pick = lambda x: x.index_select(0, best)[0]
    n_best = pick(n_in)
    return Sim3Result(success=n_best >= min_inliers, R12=pick(Rs), t12=pick(ts),
                      s12=pick(ss), inliers=pick(inl), n_inliers=n_best)
