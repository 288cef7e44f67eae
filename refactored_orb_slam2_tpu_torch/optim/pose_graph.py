"""Essential-graph pose optimization over Sim3 (monocular) or SE3 (stereo,
RGB-D) (port of optim/pose_graph.py; Optimizer::OptimizeEssentialGraph,
Optimizer.cc:763-1043 and :1052-1362).

Nodes are keyframe Sim3 poses ``S_iw``; an edge carries the relative
measurement ``M_ji = S_jw S_iw^-1`` taken when it was made (a loop edge
carries the corrected relative pose).  The residual of an edge is

    r = log(M_ji S_i S_j^-1)  in R^7 (rho, phi, sigma),

zero when the graph agrees with the measurement.  Its Jacobians are
forward-mode derivatives along the tangent perturbations at zero
(``torch.func.jvp``, vmapped over the 7 directions, all edges at once).
Sums over edges into node blocks are one-hot matrix products (``bundle_adjustment._seg_sum_oh`` and
``_pair_sum_oh``), so the card adds them in a fixed order, as the BA does.

Two solvers of the damped normal equations:

- ``solver="dense"``: the (K, K, 7, 7) matrix, one (7K, 7K) ``solve_ex``;
- ``solver="pcg"``: matrix-free block-Jacobi preconditioned CG over the
  per-edge 7x7 blocks (memory O(E 49 + K 49)).

20 LM iterations, as the reference's (Optimizer.cc:989 and :1305).  The
step is accepted or rejected on the device; nothing is read back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import sim3
from .bundle_adjustment import _seg_sum_oh


class PoseGraphEdges(NamedTuple):
    """Edge list.  i, j: (E,) int node ids; the measurement M_ji is
    (R (E, 3, 3), t (E, 3), s (E,))."""

    i: torch.Tensor
    j: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    weight: torch.Tensor   # (E,) information scale
    valid: torch.Tensor    # (E,) bool


def make_edges_from_poses(i, j, poses_R, poses_t, poses_s, valid) -> PoseGraphEdges:
    """Measurements M_ji = S_j S_i^-1 from the current node poses."""
    ic = torch.clamp(i, min=0).long()
    jc = torch.clamp(j, min=0).long()
    Rii, tii, sii = sim3.inverse(poses_R[ic], poses_t[ic], poses_s[ic])
    Rm, tm, sm = sim3.compose(poses_R[jc], poses_t[jc], poses_s[jc], Rii, tii, sii)
    return PoseGraphEdges(i=i, j=j, R=Rm, t=tm, s=sm, weight=torch.ones_like(sm),
                          valid=valid)


def _edge_residual(dz_i, dz_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log(M exp(dz_i) S_i (exp(dz_j) S_j)^-1), (..., 7)."""
    R1, t1, s1 = sim3.compose(*sim3.exp(dz_i), Ri, ti, si)
    R2, t2, s2 = sim3.compose(*sim3.exp(dz_j), Rj, tj, sj)
    Ra, ta, sa = sim3.compose(R1, t1, s1, *sim3.inverse(R2, t2, s2))
    return sim3.log(*sim3.compose(Rm, tm, sm, Ra, ta, sa))


def _pair_sum_oh(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 K: int) -> torch.Tensor:
    """(E, d, d) blocks summed into a (K, K, d, d) block matrix at (rows,
    cols), repeated pairs adding up: sum_e onehot(rows)_e^T vals_e
    onehot(cols)_e as one batched product over the d*d entries."""
    E, d = vals.shape[0], vals.shape[-1]
    A = torch.nn.functional.one_hot(rows, K).to(vals.dtype)          # (E, K)
    B = torch.nn.functional.one_hot(cols, K).to(vals.dtype)
    v = vals.reshape(E, d * d).T                                      # (d*d, E)
    out = (A.T[None] * v[:, None, :]) @ B                             # (d*d, K, K)
    return out.reshape(d, d, K, K).permute(2, 3, 0, 1)


def optimize_pose_graph(
    poses_R: torch.Tensor,     # (K, 3, 3) S_iw rotations
    poses_t: torch.Tensor,     # (K, 3)
    poses_s: torch.Tensor,     # (K,)
    node_valid: torch.Tensor,  # (K,) bool
    node_fixed: torch.Tensor,  # (K,) bool
    edges: PoseGraphEdges,
    *,
    fix_scale: bool,
    n_iters: int = 20,
    solver: str = "dense",
    n_cg: int | None = None,
):
    """LM over the pose graph; returns the updated (R, t, s).

    ``fix_scale`` freezes the scale coordinate (SE3 mode, the reference's
    stereo and RGB-D variant, Optimizer.cc:1057-1067).  ``solver="pcg"``
    never builds the (K, K, 7, 7) matrix; ``n_cg`` defaults to
    max(64, K // 4)."""
    K = poses_R.shape[0]
    dtype, dev = poses_t.dtype, poses_t.device
    ic = torch.clamp(edges.i, min=0).long()
    jc = torch.clamp(edges.j, min=0).long()
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    # fill_, not item assignment, which synchronizes on the card
    keep = torch.ones(7, dtype=dtype, device=dev)
    keep[6:].fill_(0.0)
    keep7 = torch.diag(keep)
    sel7 = eye7 - keep7
    free = (node_valid & ~node_fixed).to(dtype)
    w = edges.valid.to(dtype) * edges.weight
    if n_cg is None:
        n_cg = max(64, K // 4)

    E = ic.shape[0]
    zeros = torch.zeros((E, 7), dtype=dtype, device=dev)
    basis = eye7[:, None, :].expand(7, E, 7)

    def residuals(R, t, s, dz_i=zeros, dz_j=zeros):
        return _edge_residual(dz_i, dz_j, R[ic], t[ic], s[ic], R[jc], t[jc], s[jc],
                              edges.R, edges.t, edges.s)

    def jacobians(R, t, s):
        """(E, 7, 7) derivatives of each edge's residual by its two end
        nodes' tangents at zero: forward mode along the 7 basis directions,
        all edges at once.  (``jacfwd`` per edge would differentiate 0-dim
        scales, and forward mode of a 0-dim tensor with a Python scalar
        gives float64 tangents in PyTorch.)"""
        along = lambda f: torch.func.vmap(
            lambda v: torch.func.jvp(f, (zeros,), (v,))[1])(basis).permute(1, 2, 0)
        return (along(lambda d: residuals(R, t, s, dz_i=d)),
                along(lambda d: residuals(R, t, s, dz_j=d)))

    def node_sum(vi, vj):
        """Per-edge values at both ends summed per node."""
        return _seg_sum_oh(vi, ic, K) + _seg_sum_oh(vj, jc, K)

    def proj(x):
        """Gauge and scale projection around the normal operator (the dense
        path's masking)."""
        x = x * free[:, None]
        return x @ keep7 if fix_scale else x

    def solve_dense(Hii, Hjj, Hij, g, lamD):
        H = (_pair_sum_oh(Hii, ic, ic, K) + _pair_sum_oh(Hjj, jc, jc, K)
             + _pair_sum_oh(Hij, ic, jc, K) + _pair_sum_oh(Hij.transpose(1, 2), jc, ic, K))
        diag = torch.arange(K, device=dev)
        H[diag, diag] += lamD
        H = H * (free[:, None] * free[None, :])[:, :, None, None]
        H[diag, diag] += (1.0 - free)[:, None, None] * eye7
        g = g * free[:, None]
        if fix_scale:
            H = keep7 @ H @ keep7
            H[diag, diag] += sel7
            g = g @ keep7
        Hd = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        return -torch.linalg.solve_ex(Hd, g.reshape(7 * K))[0].reshape(K, 7)

    def solve_pcg(Hii, Hjj, Hij, g, lamD):
        """Block-Jacobi PCG on the system the dense path builds:
        A = P (H_edges + lamD) P + (I - P)."""
        D = node_sum(Hii, Hjj) + lamD

        def matvec(x):
            xp = proj(x)
            xi, xj = xp[ic], xp[jc]
            yi = (Hii @ xi[..., None])[..., 0] + (Hij @ xj[..., None])[..., 0]
            yj = (Hij.transpose(1, 2) @ xi[..., None])[..., 0] + (Hjj @ xj[..., None])[..., 0]
            y = node_sum(yi, yj) + (lamD @ xp[..., None])[..., 0]
            # identity on the projected-out subspace keeps A positive
            # definite (fixed nodes and frozen scales solve to 0)
            return proj(y) + (x - xp)

        Dp = keep7 @ D @ keep7 + sel7 if fix_scale else D
        Dp = free[:, None, None] * Dp + (1.0 - free)[:, None, None] * eye7
        Minv = torch.linalg.inv_ex(Dp + 1e-6 * eye7)[0]
        apply_m = lambda v: (Minv @ v[..., None])[..., 0]

        b = proj(-g)
        x = torch.zeros_like(b)
        r = b
        z = apply_m(r)
        p = z
        rz = torch.sum(r * z)
        for _ in range(n_cg):
            Ap = matvec(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 0, rz / torch.clamp(pAp, min=1e-30), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = apply_m(r)
            rz_new = torch.sum(r * z)
            beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-30), 0.0)
            p = z + beta * p
            rz = rz_new
        return x

    R, t, s = poses_R, poses_t, poses_s
    lam = torch.full((), 1e-6, dtype=dtype, device=dev)
    for _ in range(n_iters):
        Ji, Jj = jacobians(R, t, s)
        r = residuals(R, t, s)
        Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
        Hii = Jiw.transpose(1, 2) @ Ji
        Hjj = Jjw.transpose(1, 2) @ Jj
        Hij = Jiw.transpose(1, 2) @ Jj
        g = node_sum((Jiw.transpose(1, 2) @ r[..., None])[..., 0],
                     (Jjw.transpose(1, 2) @ r[..., None])[..., 0])
        # LM damping blocks from the diagonal of the Hessian's node blocks
        Dblk = node_sum(Hii, Hjj)
        lamD = lam * torch.diag_embed(torch.diagonal(Dblk, dim1=-2, dim2=-1)) + 1e-8 * eye7
        dz = (solve_pcg if solver == "pcg" else solve_dense)(Hii, Hjj, Hij, g, lamD)
        dz = dz * free[:, None]
        if fix_scale:
            dz = dz @ keep7

        R_new, t_new, s_new = sim3.compose(*sim3.exp(dz), R, t, s)
        err_old = torch.sum(w[:, None] * r * r)
        r_new = residuals(R_new, t_new, s_new)
        accept = torch.sum(w[:, None] * r_new * r_new) < err_old
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        s = torch.where(accept, s_new, s)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-12, 1e8)
    return R, t, s


def correct_points_after_pose_graph(pt_pos, pt_ref_kf, old_R, old_t, old_s,
                                    new_R, new_t, new_s):
    """Move every point with its reference keyframe's correction:
    p' = S_new_wr(S_old_rw(p)) (Optimizer.cc:1030-1042)."""
    kc = torch.clamp(pt_ref_kf, min=0).long()
    p_cam = sim3.apply(old_R[kc], old_t[kc], old_s[kc], pt_pos)
    p_new = sim3.apply(*sim3.inverse(new_R[kc], new_t[kc], new_s[kc]), p_cam)
    return torch.where((pt_ref_kf >= 0)[:, None], p_new, pt_pos)
