"""A plain reference of the monocular two-view initializer, the benchmark's
copy and the repository's one: ORB-SLAM2's ``Initializer::Initialize``
(Initializer.cc, github.com/raulmur/ORB_SLAM2; line numbers of its master
branch) written out one hypothesis and one candidate at a time, in plain
``torch``, with nothing of the program or of JAX.

    out = two_view(xn1, xn2, valid, sets, sigma_px=1.0, focal=535.4)

- ``xn1``, ``xn2``: (N, 2) normalized camera coordinates of match ``i`` in
  the reference frame and in the current one; ``valid``: (N,) the matches;
  ``sets``: (H, 8) indices of the minimal sets (200 in ORB-SLAM2,
  Initializer.cc:40 and 76-93).
- ``out``: ``SH``, ``SF`` (H,) every hypothesis's score; ``is_h`` the model
  chosen; ``R21``, ``t21`` (unit norm); ``inliers`` (N,) the triangulated
  correspondences kept; ``points3d`` (N, 3) in the reference camera;
  ``n_good``; ``success``; ``valid``, the matches again.
- ``compare(got, ref)``: the port's solve against this one's, under
  ``TOLERANCES``.

float32, with TF32 off while it runs (a float32 product on an H100 may
otherwise run in TF32).  ``dtype=torch.bfloat16`` computes every step in
bfloat16 instead, for the precision control; the SVDs, determinants and
inverses, which torch computes in float32 only, are then rounded to it.

Where the port departs from Initializer.cc, this reference does as the
port does, in a step of its own, so that the two compare exactly:

1. Coordinates (all steps): normalized camera coordinates, with the pixel
   sigma taken to them through one focal length, sigma / focal; ORB-SLAM2
   works in pixels with K (fx and fy).
2. Minimal sets (``sets``): handed in.  ORB-SLAM2 draws them with
   ``DUtils::Random`` seeded once with 0 (Initializer.cc:78); the port
   draws them from a generator seeded with the frame id.
3. ``normalize``: the mean and mean absolute deviation are over the valid
   matches; Initializer.cc:739-783 takes them over every keypoint of each
   frame.
4. ``check_homography`` / ``check_fundamental``: a correspondence scores
   only when both of its directions pass the gate; Initializer.cc:294-459
   add the score of each direction that passes.
5. ``refit``: the best H and the best F are solved again by DLT on all of
   their hypothesis's inliers, and those are scored again; Initializer.cc:
   110-119 reconstruct from the best minimal-set hypothesis and its
   inliers as they are.
6. ``reconstruct_h``: no refusal when two singular values nearly coincide
   (Initializer.cc:562-721 returns false when d1/d2 or d2/d3 < 1.00001);
   such candidates fail ``check_rt`` instead.
7. ``check_rt``: a point counts only with parallax (cosine < 0.99998) and
   a reprojection chi2 within 5.991 sigma^2 in both views;
   Initializer.cc:785-899 counts points without parallax too (they only
   stay out of the good mask) and gates at 4 sigma^2.
8. ``accept``: both models take ReconstructH's test (Initializer.cc:
   562-721: second best < 0.75 best, best > 0.9 inliers), with best >= 50
   and the 50th parallax cosine < 0.9998 (1.15 degrees); ReconstructF
   (Initializer.cc:461-560) asks maxGood >= max(0.9 N, 50), at most one
   solution above 0.7 maxGood (nsimilar), and more than 1 degree.
"""

from __future__ import annotations

import torch

TH_H = 5.991          # CheckHomography's chi2 gate, 2 dof at 95% (Initializer.cc:294-364)
TH_F = 3.841          # CheckFundamental's gate, 1 dof at 95% (Initializer.cc:366-459)
TH_SCORE = 5.991      # what a passing direction adds: TH_SCORE - chi2
RH_MIN = 0.40         # homography when SH / (SH + SF) > 0.40 (Initializer.cc:110-119)
TH_RT = 5.991         # check_rt's reprojection gate, sigma^2 units (departure 7)
COS_GOOD = 0.99998    # a point has parallax below this cosine (Initializer.cc:785-899)
COS_ACCEPT = 0.9998   # departure 8
MIN_GOOD = 50         # minTriangulated, handed to ReconstructH/F (Initializer.cc:110-119)


def _f32(fn, *a):
    """``fn`` of tensors in float32, its results back in the inputs' dtype:
    torch has no SVD, determinant or inverse in bfloat16."""
    dtype = a[0].dtype
    out = fn(*(x.float() for x in a))
    if isinstance(out, torch.Tensor):
        return out.to(dtype)
    return tuple(x.to(dtype) for x in out)


def _svd(A):
    """U, S, Vh with Vh square: a minimal F system has 8 rows and 9 columns."""
    return _f32(lambda m: tuple(torch.linalg.svd(m, full_matrices=m.shape[-2] < m.shape[-1])), A)


def _det(A):
    return _f32(torch.linalg.det, A)


def _inv(A):
    return _f32(lambda m: torch.linalg.inv_ex(m).inverse, A)


def normalize(pts, valid):
    """Initializer::Normalize (Initializer.cc:739-783): translate to the
    mean, scale each axis by one over its mean absolute deviation;
    departure 3: over the valid matches."""
    p = pts[valid]
    mean = p.mean(dim=0)
    dev = (p - mean).abs().mean(dim=0)
    s = 1.0 / dev
    T = torch.zeros((3, 3), dtype=pts.dtype, device=pts.device)
    T[0, 0], T[1, 1], T[2, 2] = s[0], s[1], 1.0
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (pts - mean) * s, T


def compute_h21(p1, p2):
    """ComputeH21 (Initializer.cc:218-252): two rows of the DLT a match, the
    right singular vector of the smallest singular value."""
    (u1, v1), (u2, v2) = p1.T, p2.T
    o, z = torch.ones_like(u1), torch.zeros_like(u1)
    A = torch.cat([torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=1),
                   torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=1)])
    return _svd(A)[2][8].reshape(3, 3)


def compute_f21(p1, p2):
    """ComputeF21 (Initializer.cc:254-292): one row a match, the null
    vector, then the rank-2 projection (the smallest singular value set to
    zero)."""
    (u1, v1), (u2, v2) = p1.T, p2.T
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)],
                    dim=1)
    u, w, vt = _svd(_svd(A)[2][8].reshape(3, 3))
    w = torch.stack([w[0], w[1], torch.zeros_like(w[2])])
    return u @ torch.diag(w) @ vt


def _hom(p):
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def _transfer(H, a, b):
    """Squared distance of ``b`` to ``a`` mapped by H."""
    q = _hom(a) @ H.T
    w = torch.where(q[:, 2].abs() < 1e-12, torch.full_like(q[:, 2], 1e-12), q[:, 2])
    return ((q[:, :2] / w[:, None] - b) ** 2).sum(dim=1)


def _scored(chi1, chi2, valid, th):
    """Departure 4: both directions within ``th``, then each adds
    TH_SCORE - chi2."""
    ok = valid & (chi1 <= th) & (chi2 <= th)
    return torch.where(ok, (TH_SCORE - chi1) + (TH_SCORE - chi2), torch.zeros_like(chi1)).sum(), ok


def check_homography(H21, H12, x1, x2, valid, sigma2):
    """CheckHomography (Initializer.cc:294-364): the symmetric transfer
    error of every match in both images, in sigma^2 units."""
    return _scored(_transfer(H12, x2, x1) / sigma2, _transfer(H21, x1, x2) / sigma2, valid, TH_H)


def check_fundamental(F21, x1, x2, valid, sigma2):
    """CheckFundamental (Initializer.cc:366-459): the squared distance of
    each point to the other's epipolar line."""
    h1, h2 = _hom(x1), _hom(x2)
    l2 = h1 @ F21.T
    l1 = h2 @ F21
    tiny = torch.tensor(1e-12, dtype=x1.dtype, device=x1.device)
    d2 = (h2 * l2).sum(dim=1) ** 2 / torch.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, tiny)
    d1 = (h1 * l1).sum(dim=1) ** 2 / torch.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, tiny)
    return _scored(d1 / sigma2, d2 / sigma2, valid, TH_F)


def refit(p1n, p2n, inliers, T1, T2, model):
    """Departure 5: the model solved again by DLT on every inlier of its
    best hypothesis, in the normalized frame, and denormalized."""
    a, b = p1n[inliers], p2n[inliers]
    if model == "h":
        return _inv(T2) @ compute_h21(a, b) @ T1
    return T2.T @ compute_f21(a, b) @ T1


def triangulate(P1, P2, x1, x2):
    """Initializer::Triangulate (Initializer.cc:723-737), for every match at
    once: the null vector of the 4 x 4 DLT, dehomogenized."""
    A = torch.stack([x1[:, 0:1] * P1[2] - P1[0], x1[:, 1:2] * P1[2] - P1[1],
                     x2[:, 0:1] * P2[2] - P2[0], x2[:, 1:2] * P2[2] - P2[1]], dim=1)
    _, _, vt = _svd(A)
    X = vt[:, 3]
    w = torch.where(X[:, 3].abs() < 1e-12, torch.full_like(X[:, 3], 1e-12), X[:, 3])
    return X[:, :3] / w[:, None]


def check_rt(R, t, x1, x2, inliers, sigma2):
    """CheckRT (Initializer.cc:785-899) with departure 7: (n_good, the 50th
    smallest parallax cosine of the good points, points, good mask)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P1 = torch.cat([eye, torch.zeros((3, 1), dtype=R.dtype, device=R.device)], dim=1)
    P2 = torch.cat([R, t[:, None]], dim=1)
    X = triangulate(P1, P2, x1, x2)
    finite = torch.isfinite(X).all(dim=1)
    O2 = -R.T @ t                                  # the second camera's centre
    n1, n2 = X, X - O2
    tiny = torch.tensor(1e-12, dtype=R.dtype, device=R.device)
    cos = (n1 * n2).sum(dim=1) / torch.maximum(n1.norm(dim=1) * n2.norm(dim=1), tiny)
    X2 = X @ R.T + t
    z1, z2 = X[:, 2], X2[:, 2]
    nz = lambda z: torch.where(z == 0, tiny, z)
    e1 = ((X[:, :2] / nz(z1)[:, None] - x1) ** 2).sum(dim=1)
    e2 = ((X2[:, :2] / nz(z2)[:, None] - x2) ** 2).sum(dim=1)
    good = (inliers & finite & (z1 > 0) & (z2 > 0) & (e1 <= TH_RT * sigma2)
            & (e2 <= TH_RT * sigma2) & (cos < COS_GOOD))
    n_good = int(good.sum())
    cos_good = torch.sort(cos[good]).values
    par_cos = cos_good[min(n_good - 1, 50)] if n_good else torch.ones_like(cos[0])
    return n_good, par_cos, X, good


def reconstruct_f(F21):
    """ReconstructF's candidates (Initializer.cc:461-560, DecomposeE at
    :901-923): E = F21, as K is the identity in normalized coordinates;
    (R1, t), (R2, t), (R1, -t), (R2, -t)."""
    u, _, vt = _svd(F21)
    t = u[:, 2] / u[:, 2].norm()
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=F21.dtype, device=F21.device)
    R1 = u @ W @ vt
    R1 = -R1 if _det(R1) < 0 else R1
    R2 = u @ W.T @ vt
    R2 = -R2 if _det(R2) < 0 else R2
    return [(R1, t), (R2, t), (R1, -t), (R2, -t)]


def reconstruct_h(H21):
    """ReconstructH's 8 candidates, Faugeras' decomposition
    (Initializer.cc:562-721), with departure 6."""
    U, w, Vt = _svd(H21)
    s = _det(U) * _det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    span = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / span, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / span, min=0.0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    x1 = [aux1, aux1, -aux1, -aux1]
    x3 = [aux3, -aux3, aux3, -aux3]
    signs = [1.0, -1.0, -1.0, 1.0]
    out = []
    for positive in (True, False):
        if positive:      # d' = d2
            den = torch.clamp((d1 + d3) * d2, min=1e-12)
            c, sn_abs, flip, scale = (d2 * d2 + d1 * d3) / den, root / den, 1.0, d1 - d3
        else:             # d' = -d2
            den = torch.clamp((d1 - d3) * d2, min=1e-12)
            c, sn_abs, flip, scale = (d1 * d3 - d2 * d2) / den, root / den, -1.0, d1 + d3
        for i in range(4):
            sn = signs[i] * sn_abs
            Rp = torch.zeros((3, 3), dtype=H21.dtype, device=H21.device)
            Rp[0, 0], Rp[1, 1], Rp[2, 2] = c, flip, flip * c
            Rp[0, 2], Rp[2, 0] = -flip * sn, sn
            tp = torch.stack([x1[i], torch.zeros_like(x1[i]), -flip * x3[i]]) * scale
            t = U @ tp
            out.append((s * U @ Rp @ Vt, t / torch.clamp(t.norm(), min=1e-12)))
    return out


def accept(n_goods, n_best, par_cos, n_inliers):
    """Departure 8: a clear winner among the candidates, enough points,
    enough parallax."""
    second = sorted(n_goods)[-2]
    return (n_best > 0.9 * n_inliers and second < 0.75 * n_best and n_best >= MIN_GOOD
            and float(par_cos) < COS_ACCEPT)


def two_view(xn1, xn2, valid, sets, sigma_px=1.0, focal=500.0, dtype=torch.float32) -> dict:
    """Initializer::Initialize (Initializer.cc:45-121) on the matches, with
    TF32 off while it runs; see the module's docstring."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _two_view(xn1.to(dtype), xn2.to(dtype), valid.bool(), sets.long(),
                         (sigma_px / focal) ** 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _two_view(x1, x2, valid, sets, sigma2) -> dict:
    p1n, T1 = normalize(x1, valid)
    p2n, T2 = normalize(x2, valid)
    T2inv = _inv(T2)
    SH, SF, inH, inF = [], [], [], []
    # FindHomography and FindFundamental (Initializer.cc:123-216), one
    # hypothesis at a time over the same minimal sets
    for s in sets:
        H = T2inv @ compute_h21(p1n[s], p2n[s]) @ T1
        score, ok = check_homography(H, _inv(H), x1, x2, valid, sigma2)
        SH.append(score)
        inH.append(ok)
        F = T2.T @ compute_f21(p1n[s], p2n[s]) @ T1
        score, ok = check_fundamental(F, x1, x2, valid, sigma2)
        SF.append(score)
        inF.append(ok)
    SH, SF = torch.stack(SH), torch.stack(SF)
    bestH, bestF = int(torch.argmax(SH)), int(torch.argmax(SF))   # the first best, as `>`
    sh, sf = SH[bestH], SF[bestF]
    is_h = bool(sh / torch.clamp(sh + sf, min=1e-9) > RH_MIN)

    if is_h:
        H = refit(p1n, p2n, inH[bestH], T1, T2, "h")
        _, inliers = check_homography(H, _inv(H), x1, x2, valid, sigma2)
        candidates = reconstruct_h(H)
    else:
        F = refit(p1n, p2n, inF[bestF], T1, T2, "f")
        _, inliers = check_fundamental(F, x1, x2, valid, sigma2)
        candidates = reconstruct_f(F)
    checked = [check_rt(R, t, x1, x2, inliers, sigma2) for R, t in candidates]
    n_goods = [c[0] for c in checked]
    best = max(range(len(checked)), key=lambda i: (n_goods[i], -i))     # the first best
    n_best, par_cos, points, good = checked[best]
    R21, t21 = candidates[best]
    return dict(SH=SH, SF=SF, is_h=is_h, R21=R21, t21=t21, inliers=good, points3d=points,
                n_good=n_best, success=accept(n_goods, n_best, par_cos, int(inliers.sum())),
                valid=valid)


#: how far the port's solve may lie from this reference's on the same
#: matches and minimal sets, each with its reason; float32 on both sides
TOLERANCES = dict(
    # a score sums up to 2N float32 terms, in another order and from
    # matrices whose SVDs differ in the last bits: 1e-3 of the score (2e-4
    # measured on the CPU where no correspondence crosses a gate) ...
    score_rtol=1e-3,
    # ... and a correspondence that sits on a gate may land on either side,
    # which moves a score by both of its terms, at most 2 x TH_SCORE: two
    # such a hypothesis
    score_atol=4 * TH_SCORE,
    # the chosen rotation: Faugeras' decomposition takes square roots of
    # differences of nearby singular values (0.12 degree between the JAX
    # package and the port on a planar scene, tests/test_torch_initializer.py)
    rotation_deg=0.2,
    # the unit translation, per component, as the port's test against JAX
    translation=2e-3,
    # a match whose reprojection or chi2 sits on a gate may land on either
    # side: 1% of the valid matches, and at least 2 (a flip is one match,
    # whatever their count; the card flipped 1 of 165, PERF.md), and n_good
    # moves by no more than the masks differ
    mask_share=0.01,
    mask_least=2,
)


def rotation_deg(Ra, Rb) -> float:
    """The angle between two rotations, in degrees, in float64 (arccos of
    the trace loses half the digits near zero)."""
    d = (Ra.double().cpu() - Rb.double().cpu()).norm().item()
    return float(torch.rad2deg(2 * torch.asin(torch.tensor(min(1.0, d / 8 ** 0.5)))))


def compare(got: dict, ref: dict) -> dict:
    """Each of ``TOLERANCES``' readings of the port's solve ``got`` against
    this reference's ``ref`` (both with ``two_view``'s keys): name ->
    (value, limit, within).  Scores are compared by their worst hypothesis,
    as the excess over the score's own limit (<= 0 is within); the model,
    ``success`` and ``n_good`` exactly or against the masks' difference."""
    tol = TOLERANCES
    host = lambda x: torch.as_tensor(x).detach().double().cpu()
    out = {}
    for key in ("SH", "SF"):
        a, b = host(got[key]), host(ref[key])
        excess = ((a - b).abs() - (tol["score_rtol"] * b.abs() + tol["score_atol"])).max()
        out[key] = (float(excess), 0.0)
    mask = int((host(got["inliers"]).bool() != host(ref["inliers"]).bool()).sum())
    out["mask"] = (mask, max(tol["mask_least"], tol["mask_share"] * int(host(ref["valid"]).sum())))
    out["n_good"] = (abs(int(got["n_good"]) - int(ref["n_good"])), mask)
    out["is_h"] = (int(bool(got["is_h"]) != bool(ref["is_h"])), 0)
    out["success"] = (int(bool(got["success"]) != bool(ref["success"])), 0)
    out["rotation_deg"] = (rotation_deg(host(got["R21"]), host(ref["R21"])), tol["rotation_deg"])
    out["translation"] = (float((host(got["t21"]) - host(ref["t21"])).abs().max()),
                          tol["translation"])
    return {k: (v, lim, v <= lim) for k, (v, lim) in out.items()}
