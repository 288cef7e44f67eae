"""Monocular two-view initialization: batched H/F RANSAC + reconstruction
(port of solvers/initializer.py, which replaces Initializer.cc).

All hypotheses of both models are solved and scored in one batch:

- minimal sets from ``draw_minimal_sets`` (deterministic under a seeded
  ``torch.Generator``, as the reference seeds DUtils::Random,
  Initializer.cc:78), or handed in ready-made as ``sets``;
- 8-point normalized DLT for F and H by batched SVD (ComputeH21/ComputeF21,
  Initializer.cc:218-292);
- symmetric-transfer chi2 scoring of every hypothesis against every
  correspondence (CheckHomography / CheckFundamental, Initializer.cc:294-459);
- model selection RH = SH/(SH+SF) > 0.40 (Initializer.cc:110-119);
- reconstruction: F -> E -> 4 (R, t) candidates (ReconstructF,
  Initializer.cc:461-560); H -> Faugeras 8 candidates (ReconstructH,
  Initializer.cc:562-721); cheirality/parallax/reprojection voting by
  batched triangulation (CheckRT, Initializer.cc:785-899).

Every solver and score function broadcasts over leading batch dimensions,
so the JAX package's ``vmap`` over hypotheses is a batched call here.
Singular vectors come with the sign the SVD routine chooses; scores, inlier
masks and the chosen (R, t) do not depend on it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.triangulation import triangulate_dlt
from ..ops.image import scale_table as _const

TH_F = 3.841       # chi2 line-distance gate (Initializer.cc:438)
TH_SCORE = 5.991   # score saturation (both models)
N_HYPS = 200       # reference mMaxIterations (Initializer.cc:40)


class InitResult(NamedTuple):
    success: torch.Tensor    # () bool
    R21: torch.Tensor        # (3, 3) rotation cam1 -> cam2
    t21: torch.Tensor        # (3,) unit-norm translation
    points3d: torch.Tensor   # (N, 3) triangulated points in cam-1 frame
    is_h: torch.Tensor       # () bool — homography model chosen
    inliers: torch.Tensor    # (N,) bool good triangulated correspondences
    n_good: torch.Tensor     # () int32


def _pick(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-dim index tensor with no host read (indexing with a
    0-dim tensor reads it back to select a view)."""
    return t.index_select(0, i.reshape(1))[0]


def draw_minimal_sets(valid: torch.Tensor, n_hyps: int,
                      generator: torch.Generator) -> torch.Tensor:
    """(n_hyps, 8) int64 indices: per hypothesis 8 distinct valid
    correspondences, uniformly without replacement (the 8 largest of one
    uniform key per correspondence).  The keys are drawn on the generator's
    device, so a seeded CPU generator gives the same sets for a CPU and a
    CUDA ``valid``."""
    keys = torch.rand((n_hyps, valid.shape[0]), generator=generator,
                      device=generator.device).to(valid.device)
    keys = torch.where(valid[None, :], keys, -1.0)
    return torch.topk(keys, 8, dim=1).indices


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Mean/abs-dev normalization (Initializer.cc:739-783)."""
    n = torch.clamp(valid.sum(), min=1)
    mean = torch.where(valid[:, None], pts, 0.0).sum(dim=0) / n
    d = torch.abs(pts - mean)
    mdev = torch.where(valid[:, None], d, 0.0).sum(dim=0) / n
    s = 1.0 / torch.clamp(mdev, min=1e-9)
    pn = (pts - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return pn, T


def _h_rows(x1: torch.Tensor, x2: torch.Tensor):
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    return r1, r2


def _f_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)


def _null_vector_3x3(A: torch.Tensor, full: bool) -> torch.Tensor:
    """The right singular vector of the smallest singular value of a
    (..., M, 9) system, as (..., 3, 3)."""
    vt = torch.linalg.svd(A, full_matrices=full).Vh
    return vt[..., 8, :].reshape(A.shape[:-2] + (3, 3))


def _rank2(F: torch.Tensor) -> torch.Tensor:
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (u * s[..., None, :]) @ vt


def _solve_h(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """8-point homography DLT: (..., 8, 2) x (..., 8, 2) -> (..., 3, 3)."""
    r1, r2 = _h_rows(x1, x2)
    return _null_vector_3x3(torch.cat([r1, r2], dim=-2), full=False)   # (16, 9)


def _solve_f(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental DLT with rank-2 projection."""
    return _rank2(_null_vector_3x3(_f_rows(x1, x2), full=True))        # (8, 9)


def _solve_h_masked(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Homography DLT over all masked correspondences (rows zeroed out)."""
    r1, r2 = _h_rows(x1, x2)
    m = mask.to(x1.dtype)[:, None]
    return _null_vector_3x3(torch.cat([r1 * m, r2 * m], dim=0), full=False)


def _solve_f_masked(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fundamental DLT over all masked correspondences + rank-2 projection."""
    A = _f_rows(x1, x2) * mask.to(x1.dtype)[:, None]
    return _rank2(_null_vector_3x3(A, full=False))


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def _saturated_score(chi1, chi2, valid, th):
    ok = valid & (chi1 <= th) & (chi2 <= th)
    score = torch.where(ok, (TH_SCORE - chi1) + (TH_SCORE - chi2), 0.0)
    return score.sum(dim=-1), ok


def _score_h(H21, H12, p1, p2, valid, sigma2):
    """Symmetric transfer score (CheckHomography, Initializer.cc:294-364);
    H21, H12: (..., 3, 3); returns (score (...,), inliers (..., N))."""
    def transfer(H, a, b):
        bh = _homogeneous(a) @ H.transpose(-1, -2)
        w = bh[..., 2]
        w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
        proj = bh[..., :2] / w_safe[..., None]
        return torch.sum((proj - b) ** 2, dim=-1)

    chi1 = transfer(H12, p2, p1) / sigma2
    chi2 = transfer(H21, p1, p2) / sigma2
    return _saturated_score(chi1, chi2, valid, TH_SCORE)


def _score_f(F21, p1, p2, valid, sigma2):
    """Epipolar-distance score (CheckFundamental, Initializer.cc:366-459)."""
    p1h, p2h = _homogeneous(p1), _homogeneous(p2)
    l2 = p1h @ F21.transpose(-1, -2)          # epiline in image 2
    l1 = p2h @ F21                            # epiline in image 1
    d2 = torch.sum(p2h * l2, dim=-1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(p1h * l1, dim=-1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return _saturated_score(d1 / sigma2, d2 / sigma2, valid, TH_F)


def _check_rt(R, t, p1, p2, valid, sigma2, th2=4.0 * TH_SCORE / 4.0):
    """Cheirality + parallax + reprojection vote for (R, t) candidates
    (CheckRT, Initializer.cc:785-899), R: (..., 3, 3), t: (..., 3), in
    normalized coordinates.  Returns (n_good (...,), the 50th-smallest
    parallax cosine among the good (...,), points3d (..., N, 3), good mask
    (..., N))."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P1 = torch.cat([eye, torch.zeros((3, 1), dtype=R.dtype, device=R.device)], dim=1)
    P2 = torch.cat([R, t[..., None]], dim=-1)
    p3d = triangulate_dlt(P1, P2, p1, p2)
    finite = torch.all(torch.isfinite(p3d), dim=-1)
    z1 = p3d[..., 2]
    pc2 = p3d @ R.transpose(-1, -2) + t[..., None, :]
    z2 = pc2[..., 2]
    # parallax between rays
    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r1n = torch.linalg.norm(p3d, dim=-1)
    r2 = p3d - C2[..., None, :]
    r2n = torch.linalg.norm(r2, dim=-1)
    cosp = torch.sum(p3d * r2, dim=-1) / torch.clamp(r1n * r2n, min=1e-12)
    pos = (z1 > 0) & (z2 > 0)
    # reprojection error in normalized coords
    e1 = torch.sum((p3d[..., :2] / torch.where(z1 == 0, 1e-12, z1)[..., None] - p1) ** 2, dim=-1)
    e2 = torch.sum((pc2[..., :2] / torch.where(z2 == 0, 1e-12, z2)[..., None] - p2) ** 2, dim=-1)
    reproj_ok = (e1 <= th2 * sigma2) & (e2 <= th2 * sigma2)
    good = valid & finite & pos & reproj_ok & (cosp < 0.99998)
    n_good = good.sum(dim=-1, dtype=torch.int32)
    # 50th-smallest parallax cosine among good (reference takes idx 50)
    cos_sorted = torch.sort(torch.where(good, cosp, 1.0), dim=-1).values
    idx = torch.clamp(torch.clamp(n_good - 1, min=0), max=50).long()
    par_cos = torch.gather(cos_sorted, -1, idx[..., None])[..., 0]
    return n_good, par_cos, p3d, good


def _decompose_essential(E: torch.Tensor):
    """The 4 (R, t) candidates of an essential matrix (ReconstructF,
    Initializer.cc:461-560): (4, 3, 3), (4, 3)."""
    u, _, vt = torch.linalg.svd(E)
    W = _const((0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0), E.device).reshape(3, 3)
    R1 = u @ W @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = u @ W.T @ vt
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tu = u[:, 2]
    tu = tu / torch.clamp(torch.linalg.norm(tu), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([tu, -tu, tu, -tu])


def _decompose_homography(H: torch.Tensor):
    """Faugeras SVD homography decomposition -> 8 (R, t) candidates
    (ReconstructH, Initializer.cc:562-721): (8, 3, 3), (8, 3)."""
    U, w, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    # guard near-degenerate (d1~d2~d3): candidates will fail CheckRT anyway
    span = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / span, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / span, min=0.0))
    x1s = _const((1.0, 1.0, -1.0, -1.0), H.device) * aux1
    x3s = _const((1.0, -1.0, 1.0, -1.0), H.device) * aux3
    sin_signs = _const((1.0, -1.0, -1.0, 1.0), H.device)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    z, o = torch.zeros_like(x1s), torch.ones_like(x1s)

    def candidates(Rp, tp):
        R = (s * U) @ Rp @ Vt
        t = tp @ U.T
        return R, t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)

    # case d' > 0
    den = torch.clamp((d1 + d3) * d2, min=1e-12)
    c = ((d2 * d2 + d1 * d3) / den).expand(4)
    sn = sin_signs * (root / den)
    R_pos, t_pos = candidates(
        torch.stack([torch.stack([c, z, -sn], dim=-1),
                     torch.stack([z, o, z], dim=-1),
                     torch.stack([sn, z, c], dim=-1)], dim=-2),
        torch.stack([x1s, z, -x3s], dim=-1) * (d1 - d3))

    # case d' < 0
    den = torch.clamp((d1 - d3) * d2, min=1e-12)
    c = ((d1 * d3 - d2 * d2) / den).expand(4)
    sn = sin_signs * (root / den)
    R_neg, t_neg = candidates(
        torch.stack([torch.stack([c, z, sn], dim=-1),
                     torch.stack([z, -o, z], dim=-1),
                     torch.stack([sn, z, -c], dim=-1)], dim=-2),
        torch.stack([x1s, z, x3s], dim=-1) * (d1 + d3))
    return torch.cat([R_pos, R_neg]), torch.cat([t_pos, t_neg])


def initialize_two_view(
    xn1: torch.Tensor,
    xn2: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    sigma_px: float = 1.0,
    focal: float = 500.0,
    *,
    sets: Optional[torch.Tensor] = None,
) -> InitResult:
    """Two-view bootstrap from matched *normalized* coordinates.

    xn1/xn2: (N, 2) normalized camera coords of the matches in frame 1/2;
    valid: (N,) mask; sigma_px/focal: pixel noise scale mapped into
    normalized units for the chi2 gates.  The minimal sets are ``sets``
    ((H, 8) indices) when given, else drawn with ``generator``.
    """
    sigma2 = (sigma_px / focal) ** 2
    if sets is None:
        if generator is None:
            raise ValueError("initialize_two_view needs a torch.Generator or ready-made sets")
        sets = draw_minimal_sets(valid, N_HYPS, generator)
    sets = sets.long()

    # --- solve + score both models ----------------------------------------
    p1n, T1 = _normalize(xn1, valid)
    p2n, T2 = _normalize(xn2, valid)
    g1n, g2n = p1n[sets], p2n[sets]                  # (H, 8, 2)
    T2inv = torch.linalg.inv_ex(T2).inverse
    H_hyps = T2inv @ _solve_h(g1n, g2n) @ T1
    F_hyps = T2.T @ _solve_f(g1n, g2n) @ T1

    # inv_ex: a degenerate hypothesis gives non-finite entries and scores 0,
    # it does not raise
    sH, okH = _score_h(H_hyps, torch.linalg.inv_ex(H_hyps).inverse, xn1, xn2, valid, sigma2)
    sF, okF = _score_f(F_hyps, xn1, xn2, valid, sigma2)
    bestH = torch.argmax(sH)
    bestF = torch.argmax(sF)
    SH, SF = _pick(sH, bestH), _pick(sF, bestF)
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    # refit each model on its full inlier set (masked-row DLT): the
    # minimal-set estimate is too noisy to decompose reliably
    H = T2inv @ _solve_h_masked(p1n, p2n, _pick(okH, bestH)) @ T1
    F = T2.T @ _solve_f_masked(p1n, p2n, _pick(okF, bestF)) @ T1
    _, inliersH = _score_h(H, torch.linalg.inv_ex(H).inverse, xn1, xn2, valid, sigma2)
    _, inliersF = _score_f(F, xn1, xn2, valid, sigma2)

    # --- reconstruct: E = F in normalized coords (4 candidates, listed
    # twice), H by Faugeras (8 candidates) ----------------------------------
    f_cands_R, f_cands_t = _decompose_essential(F)
    h_cands_R, h_cands_t = _decompose_homography(H)
    cand_R = torch.where(use_h, h_cands_R, torch.cat([f_cands_R, f_cands_R]))
    cand_t = torch.where(use_h, h_cands_t, torch.cat([f_cands_t, f_cands_t]))
    first4 = torch.arange(8, device=xn1.device) < 4
    inliers_model = torch.where(use_h, inliersH, inliersF)

    n_goods, par_cos, p3ds, goods = _check_rt(cand_R, cand_t, xn1, xn2,
                                              inliers_model, sigma2)
    n_goods = torch.where(use_h | first4, n_goods, -1)
    best = torch.argmax(n_goods)
    n_best = _pick(n_goods, best)
    n_inliers = inliers_model.sum(dtype=torch.int32)
    # acceptance (Initializer.cc:522-559): clear winner, enough points,
    # enough parallax
    second = torch.sort(n_goods).values[-2]
    ok = (
        (n_best > 0.9 * n_inliers.to(torch.float32))
        & (second < 0.75 * n_best)
        & (n_best >= 50)
        & (_pick(par_cos, best) < 0.9998)
    )
    return InitResult(
        success=ok,
        R21=_pick(cand_R, best),
        t21=_pick(cand_t, best),
        points3d=_pick(p3ds, best),
        is_h=use_h,
        inliers=_pick(goods, best),
        n_good=n_best,
    )
