"""Batched EPnP + RANSAC for relocalization (port of solvers/epnp.py, which
replaces PnPsolver.cc).

All hypotheses are solved at once: the minimal sets are a leading batch
dimension of every step, so one call launches the same kernels for 256
hypotheses as for one.

- ``_epnp``: the four-control-point EPnP (choose_control_points,
  compute_barycentric, the M matrix, PnPsolver.cc:355-800): all three beta
  approximations (find_betas_approx_1/2/3), each polished by the betas
  Gauss-Newton, the one with the lowest reprojection error kept;
- ``_gn_polish``: a short pose Gauss-Newton on the hypothesis's own set;
- ``epnp_ransac``: every hypothesis scored against every correspondence
  (chi2 gate), the best refined by one more EPnP on up to 64 inliers.

Minimal sets come from ``draw_pnp_sets`` (a seeded ``torch.Generator``,
uniform without replacement over the valid correspondences), or handed in
as ``sets``: ``jax.random``'s draws cannot be reproduced.  ``eigh`` and
``svd`` give vectors up to sign; the flips of the M matrix's null vectors
cancel in the pose, those of the control directions move it at the level
of the data's noise.  Solves use ``solve_ex``, which reads nothing back; a
degenerate set gives a non-finite pose, which scores no inlier, as in the
JAX package (the SVDs get zeros in its place, since they raise on
non-finite input).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from .initializer import draw_sets


class PnPResult(NamedTuple):
    success: torch.Tensor    # () bool
    Tcw: torch.Tensor        # (4, 4)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32


def draw_pnp_sets(valid: torch.Tensor, generator: torch.Generator, n_hyps: int = 256,
                  sample_size: int = 6) -> torch.Tensor:
    """(n_hyps, sample_size) int64 sets, uniform without replacement over
    the valid correspondences (``initializer.draw_sets``)."""
    return draw_sets(valid, n_hyps, sample_size, generator)


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant index vector on ``device``, built once per device:
    indexing a CUDA tensor with a Python list copies the list to the device
    and synchronizes on every call."""
    return torch.tensor(values, dtype=torch.int64).to(device)


def _take(x: torch.Tensor, dim: int, values: tuple) -> torch.Tensor:
    """``x`` indexed along ``dim`` by the constant ``values``."""
    return x.index_select(dim, _index(values, x.device))


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b).result


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _finite_or_zero(x: torch.Tensor):
    """(x with non-finite entries zeroed, per-matrix all-finite flag)."""
    ok = torch.isfinite(x).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], x, 0.0), ok


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by the triple product (no LU)."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :]), dim=-1)


def _kabsch(A: torch.Tensor, B: torch.Tensor):
    """Rigid transform aligning point sets A -> B, (..., M, 3) each.
    Returns (R, t, finite)."""
    muA, muB = A.mean(dim=-2), B.mean(dim=-2)
    H, ok = _finite_or_zero((A - muA[..., None, :]).mT @ (B - muB[..., None, :]))
    U, _, Vt = torch.linalg.svd(H)
    d = _det3(Vt.mT @ U.mT)
    s = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (Vt.mT * s[..., None, :]) @ U.mT
    t = muB - (R @ muA[..., None])[..., 0]
    return R, t, ok


_II = (0, 0, 0, 1, 1, 2)
_JJ = (1, 2, 3, 2, 3, 3)


def _betas10(b: torch.Tensor) -> torch.Tensor:
    b0, b1, b2, b3 = b.unbind(-1)
    return torch.stack([b0 * b0, b0 * b1, b1 * b1, b0 * b2, b1 * b2, b2 * b2,
                        b0 * b3, b1 * b3, b2 * b3, b3 * b3], dim=-1)


def _gn_betas(L: torch.Tensor, rho: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """5 Gauss-Newton steps on ||L betas10(b) - rho|| (PnPsolver.cc:800-820);
    L (..., 6, 10), rho (..., 6), b (..., 4)."""
    c = L.unbind(-1)
    for _ in range(5):
        r = (L @ _betas10(b)[..., None])[..., 0] - rho
        b0, b1, b2, b3 = (x[..., None] for x in b.unbind(-1))
        J = torch.stack([
            2 * b0 * c[0] + b1 * c[1] + b2 * c[3] + b3 * c[6],
            b0 * c[1] + 2 * b1 * c[2] + b2 * c[4] + b3 * c[7],
            b0 * c[3] + b1 * c[4] + 2 * b2 * c[5] + b3 * c[8],
            b0 * c[6] + b1 * c[7] + b2 * c[8] + 2 * b3 * c[9],
        ], dim=-1)                                                  # (..., 6, 4)
        H = J.mT @ J + 1e-10 * _eye(4, J)
        b = b - _solve(H, J.mT @ r[..., None])[..., 0]
    return b


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    AtA = A.mT @ A + 1e-10 * _eye(A.shape[-1], A)
    return _solve(AtA, A.mT @ b[..., None])[..., 0]


def _epnp(pw: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """EPnP for a batch of sets: pw (..., M, 3) world points, xn (..., M, 2)
    normalized observations, M >= 6 -> (..., 4, 4) world -> camera."""
    m = pw.shape[-2]
    # control points: the centroid and the principal directions scaled by
    # the square root of their eigenvalue (eigh sorts them ascending)
    c0 = pw.mean(dim=-2)
    Ac = pw - c0[..., None, :]
    w, v = torch.linalg.eigh(Ac.mT @ Ac / m)
    dirs = (torch.sqrt(torch.clamp(_take(w, -1, (2, 1, 0)), min=1e-12))[..., None]
            * _take(v, -1, (2, 1, 0)).mT)
    C = torch.cat([c0[..., None, :], c0[..., None, :] + dirs], dim=-2)      # (..., 4, 3)

    # barycentric coordinates: pw = alpha @ C with each row summing to 1
    ones = torch.ones(pw.shape[:-2] + (1, 4), dtype=pw.dtype, device=pw.device)
    Ch = torch.cat([C.mT, ones], dim=-2)                                      # (..., 4, 4)
    Pwh = torch.cat([pw.mT, ones[..., :1].expand(pw.shape[:-2] + (1, m))], dim=-2)
    alpha = _solve(Ch, Pwh).mT                                                # (..., M, 4)

    # M matrix, two rows per correspondence (fill_M with fx = fy = 1, c = 0)
    zeros = torch.zeros_like(alpha)
    rows_u = torch.cat([alpha, zeros, -alpha * xn[..., 0:1]], dim=-1)
    rows_v = torch.cat([zeros, alpha, -alpha * xn[..., 1:2]], dim=-1)
    Mm, ok_m = _finite_or_zero(torch.cat([rows_u, rows_v], dim=-2))        # (..., 2M, 12)
    vt = torch.linalg.svd(Mm, full_matrices=False).Vh
    # the four right-singular vectors of the smallest singular values, the
    # smallest first; unknowns packed [c1x..c4x, c1y..c4y, c1z..c4z]
    r = vt.shape[-2]
    Vn = _take(vt, -2, (r - 1, r - 2, r - 3, r - 4))                          # (..., 4, 12)
    Vc = torch.stack([Vn[..., 0:4], Vn[..., 4:8], Vn[..., 8:12]], dim=-1)    # (..., 4, 4, 3)

    # squared control-point distances (rho) and the 6 x 10 system L
    rho = torch.sum((_take(C, -2, _II) - _take(C, -2, _JJ)) ** 2, dim=-1)    # (..., 6)
    dv = _take(Vc, -2, _II) - _take(Vc, -2, _JJ)                              # (..., 4, 6, 3)

    def dot(a, b):
        return torch.sum(dv[..., a, :, :] * dv[..., b, :, :], dim=-1)        # (..., 6)

    L = torch.stack([dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2),
                     dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3)],
                    dim=-1)                                                   # (..., 6, 10)

    def sgn(x):
        return torch.where(x < 0, -1.0, 1.0)

    zero = torch.zeros_like(rho[..., 0])
    # find_betas_approx_1 (PnPsolver.cc:451): [b11 b12 b13 b14]
    x1 = _lstsq(_take(L, -1, (0, 1, 3, 6)), rho)
    b1_1 = torch.sqrt(torch.abs(x1[..., 0]))
    q = sgn(x1[..., 0]) / torch.clamp(b1_1, min=1e-12)
    betas_c1 = torch.stack([b1_1, q * x1[..., 1], q * x1[..., 2], q * x1[..., 3]], dim=-1)
    # find_betas_approx_2 (PnPsolver.cc:478): [b11 b12 b22]
    x2 = _lstsq(L[..., 0:3], rho)
    b1_2 = torch.sqrt(torch.abs(x2[..., 0]))
    b2_2 = torch.where((x2[..., 2] < 0) == (x2[..., 0] < 0), torch.sqrt(torch.abs(x2[..., 2])), 0.0)
    b1_2 = torch.where(x2[..., 1] < 0, -b1_2, b1_2)
    betas_c2 = torch.stack([b1_2, b2_2, zero, zero], dim=-1)
    # find_betas_approx_3 (PnPsolver.cc:503): [b11 b12 b22 b13 b23]
    x3 = _lstsq(L[..., 0:5], rho)
    b1_3 = torch.sqrt(torch.abs(x3[..., 0]))
    b2_3 = torch.where((x3[..., 2] < 0) == (x3[..., 0] < 0), torch.sqrt(torch.abs(x3[..., 2])), 0.0)
    b1_3 = torch.where(x3[..., 1] < 0, -b1_3, b1_3)
    b3_3 = x3[..., 3] / torch.clamp(torch.abs(b1_3), min=1e-12) * sgn(b1_3)
    betas_c3 = torch.stack([b1_3, b2_3, b3_3, zero], dim=-1)

    # the three candidates side by side: a dimension of 3 before the set's
    cands = _gn_betas(L[..., None, :, :], rho[..., None, :],
                      torch.stack([betas_c1, betas_c2, betas_c3], dim=-2))  # (..., 3, 4)
    cc = torch.einsum("...ck,...kij->...cij", cands, Vc)                     # (..., 3, 4, 3)
    pc = alpha[..., None, :, :] @ cc                                          # (..., 3, M, 3)
    pc = pc * sgn(pc[..., 2].sum(dim=-1))[..., None, None]
    pw3 = pw[..., None, :, :].expand(pc.shape)
    R, t, ok_k = _kabsch(pw3, pc)
    T = se3.from_rt(R, t)
    pcx = se3.transform(T[..., None, :, :], pw3)
    z = torch.where(torch.abs(pcx[..., 2]) < 1e-6, 1e-6, pcx[..., 2])
    err = torch.sum((pcx[..., :2] / z[..., None] - xn[..., None, :, :]) ** 2, dim=(-1, -2))
    best = torch.argmin(err, dim=-1)                                          # (...)
    T = torch.take_along_dim(T, best[..., None, None, None], dim=-3)[..., 0, :, :]
    ok = ok_m & torch.take_along_dim(ok_k, best[..., None], dim=-1)[..., 0]
    return torch.where(ok[..., None, None], T, float("nan"))


def _gn_polish(T: torch.Tensor, pw: torch.Tensor, xn: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Gauss-Newton pose steps on the reprojection residual of the
    hypothesis's own set (the closed form is only a seed); batched like
    ``_epnp``."""
    for _ in range(iters):
        pc = se3.transform(T[..., None, :, :], pw)                          # (..., M, 3)
        z = torch.where(torch.abs(pc[..., 2]) < 1e-6, 1e-6, pc[..., 2])
        r = (xn - pc[..., :2] / z[..., None]).flatten(-2)                   # (..., 2M)
        iz = 1.0 / z
        iz2 = iz * iz
        zero = torch.zeros_like(z)
        row_u = torch.stack([iz, zero, -pc[..., 0] * iz2], dim=-1)
        row_v = torch.stack([zero, iz, -pc[..., 1] * iz2], dim=-1)
        Jpc = torch.stack([row_u, row_v], dim=-2)                           # (..., M, 2, 3)
        Jtw = torch.cat([_eye(3, pc).expand(pc.shape + (3,)), -se3.hat(pc)], dim=-1)
        J = (-Jpc @ Jtw).flatten(-3, -2)                                     # (..., 2M, 6)
        H = J.mT @ J + 1e-8 * _eye(6, J)
        dx = -_solve(H, J.mT @ r[..., None])[..., 0]
        T = se3.exp(dx) @ T
    return T


def epnp_ransac(
    pw: torch.Tensor,
    xn: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    sets: Optional[torch.Tensor] = None,
    n_hyps: int = 256,
    sample_size: int = 6,
    chi2_th: float = 5.991,
    sigma2: float = 1.0,
    focal: float = 1.0,
    min_inliers: int = 10,
) -> PnPResult:
    """Batched EPnP RANSAC.  pw (N, 3) world points, xn (N, 2) normalized
    observations, valid (N,); ``sigma2`` in the units of ``xn`` times
    ``focal`` (the reference gates at chi2 5.991 x sigma2,
    PnPsolver::CheckInliers).  The sets are ``sets`` or drawn from
    ``generator``.  Nothing is read back."""
    if sets is None:
        sets = draw_pnp_sets(valid, generator, n_hyps, sample_size)
    sets = sets.to(pw.device)
    pw_s, xn_s = pw[sets], xn[sets]
    hyp_T = _gn_polish(_epnp(pw_s, xn_s), pw_s, xn_s)                       # (H, 4, 4)

    def score(T):
        pc = se3.transform(T[..., None, :, :], pw)                          # (..., N, 3)
        z = pc[..., 2]
        z_ok = z > 1e-6
        proj = pc[..., :2] / torch.where(z_ok, z, 1.0)[..., None]
        err2 = torch.sum((proj - xn) ** 2, dim=-1) * focal * focal
        ok = valid & z_ok & (err2 / sigma2 <= chi2_th)
        return ok.sum(dim=-1, dtype=torch.int32), ok

    n_in, inl = score(hyp_T)
    best = torch.argmax(n_in).reshape(1)                                     # first of equals
    T_best = hyp_T.index_select(0, best)[0]
    inliers = inl.index_select(0, best)[0]
    n_best = n_in.index_select(0, best)[0]

    # refine on the inlier set (PnPsolver::Refine): one EPnP on up to 64
    # inliers, the rest of the 64 rows repeating the first inlier
    k_ref = min(64, pw.shape[0])
    order = torch.argsort(torch.where(inliers, 0.0, 1.0), stable=True)
    take = order[:k_ref]
    take = torch.where(inliers[take], take, take[:1])
    T_ref = _epnp(pw[take], xn[take])
    n_ref, inl_ref = score(T_ref)
    better = n_ref >= n_best
    n_fin = torch.where(better, n_ref, n_best)
    return PnPResult(
        success=n_fin >= min_inliers,
        Tcw=torch.where(better, T_ref, T_best),
        inliers=torch.where(better, inl_ref, inliers),
        n_inliers=n_fin,
    )
