"""Batched two-view triangulation, linear DLT (port of
geometry/triangulation.py::triangulate_dlt; the triangulation inside
LocalMapping::CreateNewMapPoints, LocalMapping.cc:296-322).

``triangulation_checks`` has no counterpart: local mapping applies its
gates inline (``backend/local_mapping.py``), and the monocular initializer
that calls it arrives with ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, xn1: torch.Tensor,
                    xn2: torch.Tensor) -> torch.Tensor:
    """Points from two (3, 4) projections and (N, 2) normalized image
    coordinates in each view: the null vector of the 4x4 DLT system (its
    smallest right singular vector), dehomogenised.  Returns (N, 3) in the
    frame P1 and P2 project from."""
    a0 = xn1[..., 0:1] * P1[2] - P1[0]
    a1 = xn1[..., 1:2] * P1[2] - P1[1]
    a2 = xn2[..., 0:1] * P2[2] - P2[0]
    a3 = xn2[..., 1:2] * P2[2] - P2[1]
    A = torch.stack([a0, a1, a2, a3], dim=-2)                  # (N, 4, 4)
    ph = torch.linalg.svd(A).Vh[..., 3, :]
    w = ph[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return ph[..., :3] / w_safe[..., None]
