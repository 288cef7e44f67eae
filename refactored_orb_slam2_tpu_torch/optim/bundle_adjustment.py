"""Schur-complement bundle adjustment: local, global and init BA (port of
optim/bundle_adjustment.py; g2o's BlockSolver_6_3 + LM as driven by
Optimizer::BundleAdjustment and LocalBundleAdjustment, Optimizer.cc:52-231
and 437-744).

Observations come per point in padded slots (P, O), each naming its
keyframe.  Point blocks are marginalised, and the reduced camera system
``S = U - W V^-1 W^T`` is solved one of two ways:

- ``solver="dense"``: S built densely (K <= ~100 for a compacted local
  window) and solved with ``torch.linalg.solve_ex``, which leaves its
  status on the device;
- ``solver="pcg"``: matrix-free preconditioned conjugate gradients, ``S x``
  as gathers, small products and one segment sum per matvec, with 6x6
  block-Jacobi preconditioning: global BA over the whole map, whose dense
  fill-in would be gigabytes.

Huber robustification and per-octave information follow the reference;
fixed cameras are masked out of the system.  Sums over observations into
camera blocks are one-hot matrix products (``_seg_sum_oh``), as in the JAX
package: they are deterministic on the card, where an ``index_add_`` of
floats adds in the order its atomics land.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from . import residuals as res


class BAResult(NamedTuple):
    kf_poses: torch.Tensor
    points: torch.Tensor
    obs_valid: torch.Tensor     # observation mask after the final outlier gate
    total_chi2: torch.Tensor


class BAProblem(NamedTuple):
    """Padded BA problem: K camera slots, P point slots, O obs slots/point."""

    kf_poses: torch.Tensor        # (K, 4, 4) Tcw
    kf_fixed: torch.Tensor        # (K,) bool, poses held constant
    kf_valid: torch.Tensor        # (K,) bool
    points: torch.Tensor          # (P, 3) world positions
    point_valid: torch.Tensor     # (P,) bool
    obs_kf: torch.Tensor          # (P, O) int32 camera row of each obs (-1 pad)
    obs_uvr: torch.Tensor         # (P, O, 3) measurement (u, v, uR)
    obs_inv_sigma2: torch.Tensor  # (P, O)
    obs_is_stereo: torch.Tensor   # (P, O) bool
    obs_valid: torch.Tensor       # (P, O) bool


def _edge_terms(cam, prob: BAProblem, poses, points, use_huber: bool):
    """Residuals, Jacobians and weights of every (P, O) observation slot.

    Returns r (P,O,3), Jc (P,O,3,6), Jp (P,O,3,3), w (P,O,3) row weights
    (information x Huber x validity, third row zeroed for mono), chi2 (P,O),
    pos_depth (P,O) and the robustified total error."""
    kf = torch.clamp(prob.obs_kf, min=0).long()
    T = poses[kf]                                             # (P, O, 4, 4)
    pc = se3.transform(T, points[:, None, :].expand(prob.obs_uvr.shape))
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * pc[..., 0] / z_safe + cam.cx
    v = cam.fy * pc[..., 1] / z_safe + cam.cy
    ur = u - cam.bf / z_safe
    r = prob.obs_uvr - torch.stack([u, v, ur], dim=-1)

    Jpc = res.stereo_jacobian_pc(cam, pc)                     # d(u,v,ur)/dpc
    Jc = -Jpc @ res.pc_jacobian_twist(pc)                     # (P, O, 3, 6)
    Jp = -Jpc @ T[..., :3, :3]                                # (P, O, 3, 3)

    stereo_row = prob.obs_is_stereo.to(torch.float32)
    row_mask = torch.stack([torch.ones_like(stereo_row), torch.ones_like(stereo_row),
                            stereo_row], dim=-1)
    chi2 = torch.sum(r * r * row_mask, dim=-1) * prob.obs_inv_sigma2
    pos_depth = z > 1e-3
    active = (prob.obs_valid & (prob.obs_kf >= 0) & prob.point_valid[:, None]
              & pos_depth)
    if use_huber:
        delta2 = torch.where(prob.obs_is_stereo, res.CHI2_STEREO, res.CHI2_MONO)
        hw = res.huber_weight(chi2, delta2)
    else:
        hw = torch.ones_like(chi2)
    w = torch.where(active, hw * prob.obs_inv_sigma2, 0.0)[..., None] * row_mask
    err = torch.sum(torch.where(active, hw * chi2, 0.0))
    return r, Jc, Jp, w, chi2, pos_depth, err


def _det_inv3x3(M: torch.Tensor):
    """Closed-form determinant and inverse (adjugate / det) of batched 3x3
    blocks; ``torch.linalg.det`` and ``inv`` run an LU per block."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return det, adj / det[..., None, None]


def _seg_sum_oh(vals: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """Segment sum (N, ...) + (N,) -> (K, ...) as one-hot matrix products,
    in chunks that keep the one-hot matrix near 2^24 elements."""
    N = vals.shape[0]
    v = vals.reshape(N, -1)
    n_chunks = max(1, -(-N * K // (1 << 24)))
    while N % n_chunks:
        n_chunks += 1
    step = N // n_chunks
    out = torch.zeros((K, v.shape[1]), dtype=v.dtype, device=v.device)
    for s in range(0, N, step):
        # written as floats: ``one_hot`` builds int64 first, three times the
        # bytes of a chunk that the global BA's matvec rebuilds 64 times
        oh = torch.zeros((step, K), dtype=v.dtype, device=v.device)
        oh.scatter_(1, idx[s:s + step, None].long(), 1.0)
        out = out + oh.T @ v[s:s + step]
    return out.reshape((K,) + vals.shape[1:])


def _diag_of(X: torch.Tensor) -> torch.Tensor:
    """Batched diag(diag(X))."""
    return torch.diag_embed(torch.diagonal(X, dim1=-2, dim2=-1))


def _assemble(cam, prob: BAProblem, poses, points, lam, use_huber: bool) -> dict:
    """U/V/W/Y blocks and the reduced right-hand side of one LM step."""
    K = poses.shape[0]
    P, O = prob.obs_kf.shape
    r, Jc, Jp, w, _, _, err = _edge_terms(cam, prob, poses, points, use_huber)
    eye3 = torch.eye(3, dtype=poses.dtype, device=poses.device)
    eye6 = torch.eye(6, dtype=poses.dtype, device=poses.device)

    V = torch.einsum("pori,por,porj->pij", Jp, w, Jp)          # (P, 3, 3)
    b_p = torch.einsum("pori,por,por->pi", Jp, w, r)          # (P, 3)
    V_damp = V + (lam * _diag_of(V) + 1e-9 * eye3)
    det, _ = _det_inv3x3(V_damp)
    Vd = V_damp + torch.where((torch.abs(det) < 1e-12)[:, None, None], eye3, 0.0)
    _, V_inv = _det_inv3x3(Vd)

    kf_idx = torch.clamp(prob.obs_kf, min=0).long()
    Uc_e = torch.einsum("pori,por,porj->poij", Jc, w, Jc).reshape(P * O, 36)
    bc_e = torch.einsum("pori,por,por->poi", Jc, w, r).reshape(P * O, 6)
    Wb = torch.einsum("pori,por,porj->poij", Jc, w, Jp)       # (P, O, 6, 3)
    Y = torch.einsum("poij,pjk->poik", Wb, V_inv)
    red_e = torch.einsum("poij,pj->poi", Y, b_p).reshape(P * O, 6)

    seg = _seg_sum_oh(torch.cat([Uc_e, bc_e, red_e], dim=1), kf_idx.reshape(-1), K)
    U = seg[:, :36].reshape(K, 6, 6)
    U_damped = U + (lam * _diag_of(U) + 1e-9 * eye6)
    b_red = seg[:, 36:42] - seg[:, 42:48]

    free = (prob.kf_valid & ~prob.kf_fixed).to(poses.dtype)
    return dict(V_inv=V_inv, b_p=b_p, U_damped=U_damped, b_red=b_red * free[:, None],
                Wb=Wb, Y=Y, kf_idx=kf_idx, free=free, err=err)


def _solve_dense(a: dict, K: int) -> torch.Tensor:
    """Dense Schur solve; the camera-pair fill-in is one contraction over
    per-point camera bins of the Y and W blocks."""
    oh = torch.nn.functional.one_hot(a["kf_idx"], K).to(a["Y"].dtype)   # (P, O, K)
    binsA = torch.einsum("poij,pok->pkij", a["Y"], oh)
    binsB = torch.einsum("poij,pok->pkij", a["Wb"], oh)
    S = -torch.einsum("paij,pbkj->abik", binsA, binsB)        # (K, K, 6, 6)
    diag = torch.arange(K, device=S.device)
    S[diag, diag] = S[diag, diag] + a["U_damped"]
    free = a["free"]
    S = S * (free[:, None] * free[None, :])[:, :, None, None]
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    S[diag, diag] = S[diag, diag] + (1.0 - free)[:, None, None] * eye6
    S_dense = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    dx = torch.linalg.solve_ex(S_dense, a["b_red"].reshape(6 * K))[0]
    return -dx.reshape(K, 6) * free[:, None]


def _solve_pcg(a: dict, K: int, n_cg: int) -> torch.Tensor:
    """Matrix-free PCG on the Schur system with the block-Jacobi
    preconditioner: ``S x = U_damped x - W V^-1 W^T x`` per matvec, S never
    built.  A fixed number of iterations, so nothing is read back."""
    free, Wb, V_inv, kf_idx = a["free"], a["Wb"], a["V_inv"], a["kf_idx"]
    kf_flat = kf_idx.reshape(-1)
    P, O = kf_idx.shape

    def matvec(x):                                            # (K, 6)
        xf = x * free[:, None]
        ux = (a["U_damped"] @ xf[..., None])[..., 0]
        wtx = torch.einsum("poij,poi->pj", Wb, xf[kf_idx])    # (P, 3)
        vy = (V_inv @ wtx[..., None])[..., 0]
        wy = _seg_sum_oh(torch.einsum("poij,pj->poi", Wb, vy).reshape(P * O, 6), kf_flat, K)
        # free rows get S x; fixed and invalid rows act as the identity
        return (ux - wy) * free[:, None] + (x - xf)

    eye6 = torch.eye(6, dtype=Wb.dtype, device=Wb.device)
    M = a["U_damped"] * free[:, None, None] + (1.0 - free)[:, None, None] * eye6
    M_inv = torch.linalg.inv_ex(M + 1e-8 * eye6)[0]
    precond = lambda v: (M_inv @ v[..., None])[..., 0]

    b = -a["b_red"]
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(n_cg):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-20, 1e-20, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz) * p
        rz = rz_new
    return x * free[:, None]


def _lm_step(cam, prob: BAProblem, poses, points, lam, use_huber: bool,
             solver: str = "dense", n_cg: int = 0):
    """One LM solve: (new poses, new points, error before the step)."""
    K = poses.shape[0]
    a = _assemble(cam, prob, poses, points, lam, use_huber)
    # a singular solve must give a rejectable zero step, not NaNs
    dx_c = _solve_dense(a, K) if solver == "dense" else _solve_pcg(a, K, n_cg)
    dx_c = torch.where(torch.isfinite(dx_c), dx_c, 0.0)
    # back-substitute points: dx_p = V^-1 (-b_p - sum over obs of W^T dx_c)
    wt_dxc = torch.einsum("poij,poi->pj", a["Wb"], dx_c[a["kf_idx"]])
    dx_p = torch.einsum("pij,pj->pi", a["V_inv"], -(a["b_p"] + wt_dxc))
    dx_p = dx_p * prob.point_valid[:, None].to(poses.dtype)
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)
    return se3.exp(dx_c) @ poses, points + dx_p, a["err"]


def lm_chunk(cam, prob: BAProblem, poses, points, lam, *, n_iters: int,
             use_huber: bool, solver: str = "dense", n_cg: int = 0):
    """``n_iters`` LM iterations carrying the damping ``lam`` (a 0-dim
    tensor); a step is kept when it lowers the robustified error, which is
    decided on the device."""
    for _ in range(n_iters):
        new_poses, new_points, err_old = _lm_step(cam, prob, poses, points, lam,
                                                  use_huber, solver, n_cg)
        err_new = _edge_terms(cam, prob, new_poses, new_points, use_huber)[-1]
        accept = err_new < err_old
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
    return poses, points, lam


def classify_outliers(cam, prob: BAProblem, poses, points) -> torch.Tensor:
    """chi2 and depth gate per observation (Optimizer.cc:660-694)."""
    _, _, _, _, chi2, pos_depth, _ = _edge_terms(cam, prob, poses, points, False)
    th = torch.where(prob.obs_is_stereo, res.CHI2_STEREO, res.CHI2_MONO)
    return prob.obs_valid & (chi2 <= th) & pos_depth


def _run_lm(cam, prob: BAProblem, poses, points, n_iters: int, use_huber: bool,
            solver: str, n_cg: int):
    lam = torch.full((), 1e-4, dtype=poses.dtype, device=poses.device)
    poses, points, _ = lm_chunk(cam, prob, poses, points, lam, n_iters=n_iters,
                                use_huber=use_huber, solver=solver, n_cg=n_cg)
    return poses, points


def run(cam, prob: BAProblem, *, iters_phase1: int = 5, iters_phase2: int = 10,
        solver: str = "dense", n_cg: int = 80) -> BAResult:
    """Two-phase BA with the reference's outlier drop between the phases:
    20/0 iterations for the monocular-init BA (Tracking.cc:618), 10/0 for
    the loop-closing GBA (LoopClosing.cc:622), 5/10 for local BA
    (Optimizer.cc:650-693).  ``solver`` is "dense" (compact windows) or
    "pcg" (the whole map), with ``n_cg`` CG iterations per LM step."""
    poses, points = _run_lm(cam, prob, prob.kf_poses, prob.points, iters_phase1, True,
                            solver, n_cg)
    if iters_phase2 > 0:
        prob = prob._replace(obs_valid=classify_outliers(cam, prob, poses, points))
        poses, points = _run_lm(cam, prob, poses, points, iters_phase2, True, solver, n_cg)
    final_valid = classify_outliers(cam, prob, poses, points)
    err = _edge_terms(cam, prob, poses, points, False)[-1]
    return BAResult(kf_poses=poses, points=points, obs_valid=final_valid, total_chi2=err)
