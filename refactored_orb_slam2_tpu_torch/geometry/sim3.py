"""Sim(3) similarity transforms on torch tensors (port of geometry/sim3.py;
g2o's ``Sim3`` / ``VertexSim3Expmap`` of the reference's monocular loop
closure, Sim3Solver.cc:216-322 and Optimizer.cc:763-1043).

An element is the tuple ``(R (..., 3, 3), t (..., 3), s (...))``; as a
matrix it is ``[[sR, t], [0, 1]]``, which composes by matmul.  The tangent
is ``zeta = [rho(3), phi(3), sigma(1)]`` with left-multiplicative updates
(the scale update is multiplicative: s <- exp(sigma) s).

Every function broadcasts over leading dimensions and reads nothing back to
the host.  Determinants and the 3x3 solve of ``log`` are closed forms
(``torch.linalg.det`` and ``solve`` run an LU, and ``solve`` checks its
pivots on the host), and the small-angle and small-sigma branches are
``torch.where`` over safe denominators, so ``torch.func.jacfwd`` at zero
gives finite derivatives.
"""

from __future__ import annotations

import torch

from . import se3


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) blocks by cofactors."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _solve3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M^-1 b for (..., 3, 3) blocks and (..., 3) vectors (adjugate / det)."""
    a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b_ * i, b_ * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b_ * g - a * h, a * e - b_ * d
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    det = a * A + b_ * D + c * G
    return (adj @ b[..., None])[..., 0] / det[..., None]


def to_matrix(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(R, t, s) -> (..., 4, 4) matrix [[sR, t], [0, 1]]."""
    return se3.from_rt(R * s[..., None, None], t)


def _cbrt_det(sR: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.clamp(_det3(sR), min=1e-30), 1.0 / 3.0)


def from_matrix(S: torch.Tensor):
    """(..., 4, 4) -> (R, t, s); the scale is the cube root of det(sR)."""
    sR = S[..., :3, :3]
    s = _cbrt_det(sR)
    return sR / s[..., None, None], S[..., :3, 3], s


def inverse(R, t, s):
    """Inverse of a Sim3: (R, t, s) -> (R', t', s') with S' S = I."""
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * (Rt @ t[..., None])[..., 0]
    return Rt, t_inv, s_inv


def compose(Ra, ta, sa, Rb, tb, sb):
    """S_a o S_b (b applied first)."""
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def apply(R, t, s, p):
    """Map points: s R p + t."""
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def exp(zeta: torch.Tensor):
    """Sim(3) exponential with the exact W matrix for the translation
    (Strasdat's thesis)."""
    rho, phi, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    W = _sim3_W(phi, sigma)
    return se3.so3_exp(phi), (W @ rho[..., None])[..., 0], torch.exp(sigma)


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W of the Sim3 exponential (t = W rho): C I + A hat(phi) + B hat(phi)^2
    with Strasdat's scalar coefficients, and Taylor limits for small sigma
    and/or small theta."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-16))
    s = torch.exp(sigma)
    eps = 1e-5
    sig_small = torch.abs(sigma) < eps
    th_small = theta < eps
    sigma_safe = torch.where(sig_small, 1.0, sigma)
    theta_safe = torch.where(th_small, 1.0, theta)

    # C = (s - 1) / sigma, -> 1 as sigma -> 0
    C = torch.where(sig_small, 1.0 + sigma / 2.0, (s - 1.0) / sigma_safe)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    # both sigma and theta away from 0
    a = s * sin_t
    b = s * cos_t
    c2 = theta2 + sigma * sigma
    c2_safe = torch.where(c2 < 1e-16, 1.0, c2)
    theta2_safe = torch.clamp(theta2, min=1e-16)
    A_gen = (a * sigma + (1.0 - b) * theta) / (theta_safe * c2_safe)
    B_gen = (C - ((b - 1.0) * sigma + a * theta) / c2_safe) / theta2_safe

    # sigma -> 0
    A_sig0 = (1.0 - cos_t) / theta2_safe
    B_sig0 = (theta - sin_t) / torch.clamp(theta2 * theta_safe, min=1e-16)
    # theta -> 0
    A_th0 = torch.where(sig_small, 0.5 + sigma / 6.0,
                        ((sigma - 1.0) * s + 1.0) / (sigma_safe * sigma_safe))
    B_th0 = torch.where(sig_small, torch.full_like(sigma, 1.0 / 6.0),
                        (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0) / sigma_safe ** 3)
    A = torch.where(th_small, A_th0, torch.where(sig_small, A_sig0, A_gen))
    B = torch.where(th_small, B_th0, torch.where(sig_small, B_sig0, B_gen))

    Phi = se3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    return (C[..., None, None] * eye + A[..., None, None] * Phi
            + B[..., None, None] * (Phi @ Phi))


def log(R, t, s):
    """Sim(3) logarithm, the inverse of ``exp``."""
    phi = se3.so3_log(R)
    sigma = torch.log(s)
    rho = _solve3(_sim3_W(phi, sigma), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
