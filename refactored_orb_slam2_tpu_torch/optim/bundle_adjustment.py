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

A problem may also come cut along the point axis (``ShardedBAProblem``,
made by ``parallel/dist_ba.py`` in one process and ``parallel/multihost.py``
across processes).  The point-major work (residuals, Jacobians, the point
blocks ``V``, the back-substitution, the outlier gate) stays on each shard;
the sums onto cameras (``_assemble``'s segment sum, the PCG matvec's, the
dense fill-in and the robust error) go through the problem's ``reduce``,
the counterpart of the psum XLA inserts for the JAX package.  The camera
algebra after them is computed alike on every shard from the same totals.
One unsharded problem runs the same ops as before, with no reduction.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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


class ShardedBAProblem(NamedTuple):
    """A BAProblem cut along the point axis: one BAProblem per shard, each
    with its contiguous point slice on its device and the camera arrays
    replicated there.  ``reduce`` takes one partial sum per shard, in shard
    order, and returns the total on each shard's device, a tensor of its
    own for each.  What the BA functions take and return per point or per
    camera (poses, points, damping, masks, error) is then a tuple with one
    entry per shard."""

    shards: tuple
    reduce: Callable

    @property
    def kf_poses(self) -> tuple:
        return tuple(s.kf_poses for s in self.shards)

    @property
    def points(self) -> tuple:
        return tuple(s.points for s in self.shards)


def _shards(prob, *state):
    """The problem's shards, its reduction (None for one unsharded problem)
    and each of ``state`` as a list with one entry per shard."""
    if isinstance(prob, ShardedBAProblem):
        return prob.shards, prob.reduce, [list(x) for x in state]
    return (prob,), None, [[x] for x in state]


def _joined(prob, *lists):
    """Per-shard lists back in the caller's form: tuples for a sharded
    problem, the one entry for an unsharded one."""
    sharded = isinstance(prob, ShardedBAProblem)
    out = tuple(tuple(x) if sharded else x[0] for x in lists)
    return out if len(out) > 1 else out[0]


def _total(reduce, parts: list) -> list:
    """Each shard's partial sum onto the cameras -> the total on each
    shard's device; one unsharded problem keeps its own."""
    return parts if reduce is None else list(reduce(parts))


def per_shard(prob, fn):
    """``fn(shard)`` for every shard of ``prob``, in the problem's form."""
    shards, _, _ = _shards(prob)
    return _joined(prob, [fn(s) for s in shards])


def initial_damping(prob):
    """LM's starting damping, 1e-4, on the problem's device(s)."""
    return per_shard(prob, lambda s: torch.full((), 1e-4, dtype=s.kf_poses.dtype,
                                                device=s.kf_poses.device))


def with_obs_valid(prob, obs_valid):
    """``prob`` with another observation mask (a tuple for a sharded one)."""
    if isinstance(prob, ShardedBAProblem):
        return prob._replace(shards=tuple(s._replace(obs_valid=v)
                                          for s, v in zip(prob.shards, obs_valid)))
    return prob._replace(obs_valid=obs_valid)


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


def _assemble(cam, shards, reduce, poses, points, lam, use_huber: bool) -> list:
    """U/V/W/Y blocks and the reduced right-hand side of one LM step, a dict
    per shard: the point blocks from the shard's own observations, the
    camera blocks from the segment sum and the error totalled over shards."""
    A = []
    for prob, T, X, l in zip(shards, poses, points, lam):
        K = T.shape[0]
        P, O = prob.obs_kf.shape
        r, Jc, Jp, w, _, _, err = _edge_terms(cam, prob, T, X, use_huber)
        eye3 = torch.eye(3, dtype=T.dtype, device=T.device)

        V = torch.einsum("pori,por,porj->pij", Jp, w, Jp)          # (P, 3, 3)
        b_p = torch.einsum("pori,por,por->pi", Jp, w, r)          # (P, 3)
        V_damp = V + (l * _diag_of(V) + 1e-9 * eye3)
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
        A.append(dict(V_inv=V_inv, b_p=b_p, Wb=Wb, Y=Y, kf_idx=kf_idx, seg=seg, err=err))

    segs = _total(reduce, [a.pop("seg") for a in A])
    errs = _total(reduce, [a["err"] for a in A])
    for a, prob, T, l, seg, err in zip(A, shards, poses, lam, segs, errs):
        K = T.shape[0]
        eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
        U = seg[:, :36].reshape(K, 6, 6)
        U_damped = U + (l * _diag_of(U) + 1e-9 * eye6)
        b_red = seg[:, 36:42] - seg[:, 42:48]
        free = (prob.kf_valid & ~prob.kf_fixed).to(T.dtype)
        a.update(U_damped=U_damped, b_red=b_red * free[:, None], free=free, err=err)
    return A


def _solve_dense(A: list, reduce, K: int) -> list:
    """Dense Schur solve per shard; the camera-pair fill-in is one
    contraction over per-point camera bins of the Y and W blocks, totalled
    over shards."""
    fill = []
    for a in A:
        oh = torch.nn.functional.one_hot(a["kf_idx"], K).to(a["Y"].dtype)   # (P, O, K)
        binsA = torch.einsum("poij,pok->pkij", a["Y"], oh)
        binsB = torch.einsum("poij,pok->pkij", a["Wb"], oh)
        fill.append(-torch.einsum("paij,pbkj->abik", binsA, binsB))      # (K, K, 6, 6)
    dx = []
    for a, S in zip(A, _total(reduce, fill)):
        diag = torch.arange(K, device=S.device)
        S[diag, diag] = S[diag, diag] + a["U_damped"]
        free = a["free"]
        S = S * (free[:, None] * free[None, :])[:, :, None, None]
        eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
        S[diag, diag] = S[diag, diag] + (1.0 - free)[:, None, None] * eye6
        S_dense = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        d = torch.linalg.solve_ex(S_dense, a["b_red"].reshape(6 * K))[0]
        dx.append(-d.reshape(K, 6) * free[:, None])
    return dx


def _solve_pcg(A: list, reduce, K: int, n_cg: int) -> list:
    """Matrix-free PCG on the Schur system with the block-Jacobi
    preconditioner: ``S x = U_damped x - W V^-1 W^T x`` per matvec, S never
    built, its ``W V^-1 W^T x`` totalled over shards.  A fixed number of
    iterations, so nothing is read back."""
    n = len(A)

    def matvec(xs):                                           # (K, 6) per shard
        local, wy = [], []
        for a, x in zip(A, xs):
            Wb, kf_idx = a["Wb"], a["kf_idx"]
            P, O = kf_idx.shape
            xf = x * a["free"][:, None]
            ux = (a["U_damped"] @ xf[..., None])[..., 0]
            wtx = torch.einsum("poij,poi->pj", Wb, xf[kf_idx])    # (P, 3)
            vy = (a["V_inv"] @ wtx[..., None])[..., 0]
            wy.append(_seg_sum_oh(torch.einsum("poij,pj->poi", Wb, vy).reshape(P * O, 6),
                                  kf_idx.reshape(-1), K))
            local.append((xf, ux))
        # free rows get S x; fixed and invalid rows act as the identity
        return [(ux - w) * a["free"][:, None] + (x - xf)
                for a, x, (xf, ux), w in zip(A, xs, local, _total(reduce, wy))]

    M_inv = []
    for a in A:
        free = a["free"]
        eye6 = torch.eye(6, dtype=free.dtype, device=free.device)
        M = a["U_damped"] * free[:, None, None] + (1.0 - free)[:, None, None] * eye6
        M_inv.append(torch.linalg.inv_ex(M + 1e-8 * eye6)[0])
    precond = lambda i, v: (M_inv[i] @ v[..., None])[..., 0]

    b = [-a["b_red"] for a in A]
    x = [torch.zeros_like(v) for v in b]
    r = [bi - Ax for bi, Ax in zip(b, matvec(x))]
    z = [precond(i, r[i]) for i in range(n)]
    p = list(z)
    rz = [torch.sum(r[i] * z[i]) for i in range(n)]
    for _ in range(n_cg):
        Ap = matvec(p)
        for i in range(n):
            pAp = torch.sum(p[i] * Ap[i])
            alpha = rz[i] / torch.where(torch.abs(pAp) < 1e-20, 1e-20, pAp)
            x[i] = x[i] + alpha * p[i]
            r[i] = r[i] - alpha * Ap[i]
            zi = precond(i, r[i])
            rz_new = torch.sum(r[i] * zi)
            p[i] = zi + rz_new / torch.where(torch.abs(rz[i]) < 1e-20, 1e-20, rz[i]) * p[i]
            rz[i] = rz_new
    return [xi * a["free"][:, None] for xi, a in zip(x, A)]


def _lm_step(cam, shards, reduce, poses, points, lam, use_huber: bool,
             solver: str = "dense", n_cg: int = 0):
    """One LM solve: per-shard lists of new poses, new points and the error
    before the step."""
    K = poses[0].shape[0]
    A = _assemble(cam, shards, reduce, poses, points, lam, use_huber)
    dxs = _solve_dense(A, reduce, K) if solver == "dense" else _solve_pcg(A, reduce, K, n_cg)
    new_poses, new_points = [], []
    for a, prob, T, X, dx_c in zip(A, shards, poses, points, dxs):
        # a singular solve must give a rejectable zero step, not NaNs
        dx_c = torch.where(torch.isfinite(dx_c), dx_c, 0.0)
        # back-substitute points: dx_p = V^-1 (-b_p - sum over obs of W^T dx_c)
        wt_dxc = torch.einsum("poij,poi->pj", a["Wb"], dx_c[a["kf_idx"]])
        dx_p = torch.einsum("pij,pj->pi", a["V_inv"], -(a["b_p"] + wt_dxc))
        dx_p = dx_p * prob.point_valid[:, None].to(T.dtype)
        dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)
        new_poses.append(se3.exp(dx_c) @ T)
        new_points.append(X + dx_p)
    return new_poses, new_points, [a["err"] for a in A]


def lm_chunk(cam, prob, poses, points, lam, *, n_iters: int,
             use_huber: bool, solver: str = "dense", n_cg: int = 0):
    """``n_iters`` LM iterations carrying the damping ``lam`` (a 0-dim
    tensor); a step is kept when it lowers the robustified error, which is
    decided on the device.  ``prob`` is a BAProblem or a ShardedBAProblem
    (then poses, points, lam and the results are per-shard tuples)."""
    shards, reduce, (poses, points, lam) = _shards(prob, poses, points, lam)
    for _ in range(n_iters):
        new_poses, new_points, err_old = _lm_step(cam, shards, reduce, poses, points, lam,
                                                  use_huber, solver, n_cg)
        err_new = _total(reduce, [_edge_terms(cam, s, T, X, use_huber)[-1]
                                  for s, T, X in zip(shards, new_poses, new_points)])
        for i in range(len(shards)):
            accept = err_new[i] < err_old[i]
            poses[i] = torch.where(accept, new_poses[i], poses[i])
            points[i] = torch.where(accept, new_points[i], points[i])
            lam[i] = torch.clamp(torch.where(accept, lam[i] * 0.5, lam[i] * 4.0), 1e-10, 1e8)
    return _joined(prob, poses, points, lam)


def classify_outliers(cam, prob, poses, points):
    """chi2 and depth gate per observation (Optimizer.cc:660-694), on each
    shard's own observations."""
    shards, _, (poses, points) = _shards(prob, poses, points)
    valid = []
    for s, T, X in zip(shards, poses, points):
        _, _, _, _, chi2, pos_depth, _ = _edge_terms(cam, s, T, X, False)
        th = torch.where(s.obs_is_stereo, res.CHI2_STEREO, res.CHI2_MONO)
        valid.append(s.obs_valid & (chi2 <= th) & pos_depth)
    return _joined(prob, valid)


def total_error(cam, prob, poses, points, use_huber: bool = False):
    """The (robustified) error over every shard's observations."""
    shards, reduce, (poses, points) = _shards(prob, poses, points)
    return _joined(prob, _total(reduce, [_edge_terms(cam, s, T, X, use_huber)[-1]
                                         for s, T, X in zip(shards, poses, points)]))


def _run_lm(cam, prob, poses, points, n_iters: int, use_huber: bool, solver: str, n_cg: int):
    poses, points, _ = lm_chunk(cam, prob, poses, points, initial_damping(prob),
                                n_iters=n_iters, use_huber=use_huber, solver=solver, n_cg=n_cg)
    return poses, points


def run(cam, prob, *, iters_phase1: int = 5, iters_phase2: int = 10,
        solver: str = "dense", n_cg: int = 80) -> BAResult:
    """Two-phase BA with the reference's outlier drop between the phases:
    20/0 iterations for the monocular-init BA (Tracking.cc:618), 10/0 for
    the loop-closing GBA (LoopClosing.cc:622), 5/10 for local BA
    (Optimizer.cc:650-693).  ``solver`` is "dense" (compact windows) or
    "pcg" (the whole map), with ``n_cg`` CG iterations per LM step.  A
    ShardedBAProblem gives a BAResult of per-shard tuples."""
    poses, points = _run_lm(cam, prob, prob.kf_poses, prob.points, iters_phase1, True,
                            solver, n_cg)
    if iters_phase2 > 0:
        prob = with_obs_valid(prob, classify_outliers(cam, prob, poses, points))
        poses, points = _run_lm(cam, prob, poses, points, iters_phase2, True, solver, n_cg)
    final_valid = classify_outliers(cam, prob, poses, points)
    err = total_error(cam, prob, poses, points)
    return BAResult(kf_poses=poses, points=points, obs_valid=final_valid, total_chi2=err)
