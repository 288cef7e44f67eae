"""Motion-only pose optimization, Optimizer::PoseOptimization
(port of optim/pose_opt.py; Optimizer.cc:233-435).

- 4 outer rounds x 10 LM iterations;
- after every round, edges are re-classified at chi2 5.991 (mono) / 7.815
  (stereo); outliers sit out the next round but are re-tested every round;
- Huber kernel in rounds 0-1 only (Optimizer.cc:412);
- per-edge information = invSigma2 of the keypoint's octave;
- edges behind the camera are dropped for the round.

``optimize_pose`` runs the plain version, ``optimize_pose_reference``, on
CPU tensors; on CUDA tensors it launches the hand-written kernel
``csrc/pose_lm.cu`` (one thread block runs the whole solve) or raises.  In
the plain version the LM accept/reject is ``torch.where`` on the device:
the loop has a fixed trip count and reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..ops import cuda_hamming
from . import residuals as res

N_ROUNDS = 4
N_ITERS = 10


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor        # (4, 4) optimized pose
    inlier: torch.Tensor     # (N,) bool final inlier classification
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # (N,) final per-edge chi2


def _build_normal_eqs(cam, Tcw, pw, obs, inv_sigma2, active, is_stereo,
                      use_huber: bool):
    """H (6, 6), g (6,), robustified total error, per-edge chi2 and the
    positive-depth mask.  One 3-row residual per edge; mono edges zero the
    uR row through the row weights and use the 2-DoF chi2."""
    n = pw.shape[0]
    r, pc = res.stereo_residual(cam, Tcw, pw, obs)                  # (N, 3)
    J = -res.stereo_jacobian_pc(cam, pc) @ res.pc_jacobian_twist(pc)  # (N, 3, 6)

    chi2_m = torch.sum(r[..., :2] * r[..., :2], dim=-1) * inv_sigma2
    chi2_s = torch.sum(r * r, dim=-1) * inv_sigma2
    chi2 = torch.where(is_stereo, chi2_s, chi2_m)

    pos_depth = pc[..., 2] > 1e-3
    act = active & pos_depth

    if use_huber:
        th = torch.where(is_stereo, res.CHI2_STEREO, res.CHI2_MONO)
        w_huber = res.huber_weight(chi2, th)
    else:
        w_huber = torch.ones_like(chi2)
    w_edge = torch.where(act, w_huber * inv_sigma2, 0.0)

    w_row = w_edge[:, None] * torch.cat(
        [torch.ones((n, 2), dtype=r.dtype, device=r.device),
         is_stereo[:, None].to(r.dtype)], dim=1,
    )
    Jf = J.reshape(3 * n, 6)
    wJf = w_row.reshape(3 * n, 1) * Jf
    H = Jf.T @ wJf
    g = wJf.T @ r.reshape(3 * n)
    err = torch.sum(torch.where(act, w_huber * chi2, 0.0))
    return H, g, err, chi2, pos_depth


def optimize_pose(cam, Tcw0: torch.Tensor, points_w: torch.Tensor,
                  obs: torch.Tensor, inv_sigma2: torch.Tensor,
                  valid: torch.Tensor, is_stereo: torch.Tensor) -> PoseOptResult:
    """Optimize one camera pose against fixed map points.

    Tcw0: (4, 4) float32; points_w: (N, 3) float32; obs: (N, 3) float32 as
    (u, v, uR), uR ignored for mono edges; inv_sigma2: (N,) float32;
    valid: (N,) bool edge mask; is_stereo: (N,) bool.  All on one device:
    the CPU runs ``optimize_pose_reference``, a GPU one launch of
    ``csrc/pose_lm.cu`` (``cuda_hamming.pose_lm``).  Raises on another
    dtype or shape, or on mixed devices.
    """
    args = (Tcw0, points_w, obs, inv_sigma2, valid, is_stereo)
    if cuda_hamming.check_pose_lm(*args).type == "cpu":
        return optimize_pose_reference(cam, *args)
    return PoseOptResult(*cuda_hamming.pose_lm(cam, *args))


def optimize_pose_reference(cam, Tcw0: torch.Tensor, points_w: torch.Tensor,
                            obs: torch.Tensor, inv_sigma2: torch.Tensor,
                            valid: torch.Tensor, is_stereo: torch.Tensor) -> PoseOptResult:
    """Plain PyTorch version of ``optimize_pose``, on any device."""
    eye6 = torch.eye(6, dtype=points_w.dtype, device=points_w.device)
    th = torch.where(is_stereo, res.CHI2_STEREO, res.CHI2_MONO)

    def build(T, active, use_huber):
        return _build_normal_eqs(cam, T, points_w, obs, inv_sigma2, active,
                                 is_stereo, use_huber)

    Tcw, inlier = Tcw0, valid
    for rnd in range(N_ROUNDS):
        use_huber = rnd < 2
        H, g, err, _, _ = build(Tcw, inlier, use_huber)
        lam = torch.full((), 1e-4, dtype=points_w.dtype, device=points_w.device)
        for _ in range(N_ITERS):
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
            # r = obs - pred and J = -dpred/dxi, so the step is -H^-1 g
            dx = -torch.linalg.solve_ex(Hd, g)[0]
            T_new = se3.exp(dx) @ Tcw
            H_new, g_new, err_new, _, _ = build(T_new, inlier, use_huber)
            accept = err_new < err
            Tcw = torch.where(accept, T_new, Tcw)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
            H = torch.where(accept, H_new, H)
            g = torch.where(accept, g_new, g)
            err = torch.where(accept, err_new, err)
        # re-classify at the round's pose (Optimizer.cc:389-409)
        _, _, _, chi2, pos_depth = build(Tcw, valid, False)
        inlier = valid & (chi2 <= th) & pos_depth

    _, _, _, chi2, _ = build(Tcw, valid, False)
    return PoseOptResult(Tcw=Tcw, inlier=inlier,
                         n_inliers=inlier.sum(dtype=torch.int32), chi2=chi2)
