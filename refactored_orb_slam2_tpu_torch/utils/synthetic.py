"""Synthetic textured-world generator for end-to-end SLAM tests and benches
(port of utils/synthetic.py: its numpy code, with the one twist
exponential taken by the port's ``geometry/se3.py``).

No real datasets ship with this environment, so integration tests and the
benchmark render controllable scenes: a cloud of 3D "billboard" squares with
per-square intensity and size, rendered with a painter's z-order into
mono/stereo/RGB-D frames along a smooth ground-truth trajectory.  FAST
fires on the square corners; descriptors are stable across views, so the
full pipeline (extract -> match -> optimize) exercises realistically.

Host-side numpy: dataset generation is offline, not part of the compute path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from ..geometry import se3


TEX_RES = 24  # per-billboard texture resolution


@dataclass
class SyntheticWorld:
    points: np.ndarray       # (M, 3) world positions
    intensity: np.ndarray    # (M,) base brightness
    size: np.ndarray         # (M,) world-space square half-size
    textures: np.ndarray     # (M, TEX_RES, TEX_RES) per-square texture

    @classmethod
    def create(
        cls, seed=0, n_points=600,
        x_range=(-8.0, 8.0), y_range=(-3.0, 3.0), z_range=(2.0, 30.0),
        clear_tube: float = 1.5,
        size_range=(0.15, 0.45),
    ):
        """``clear_tube`` keeps a corridor around the z-axis free of
        billboards (the camera path must not collide with the scene —
        street-scene geometry, like the real benchmarks).  ``size_range``
        scales billboard half-sizes to the scene scale (desk-scale worlds
        need cm-size squares)."""
        rng = np.random.default_rng(seed)
        pts = np.stack(
            [
                rng.uniform(*x_range, n_points),
                rng.uniform(*y_range, n_points),
                rng.uniform(*z_range, n_points),
            ],
            axis=1,
        ).astype(np.float32)
        if clear_tube > 0:
            inside = (np.abs(pts[:, 0]) < clear_tube) & (np.abs(pts[:, 1]) < clear_tube)
            # push tube-interior billboards out sideways
            pts[inside, 0] = np.sign(pts[inside, 0] + 1e-3) * (
                clear_tube + np.abs(pts[inside, 0])
            )
        inten = rng.uniform(110, 250, n_points).astype(np.float32)
        size = rng.uniform(*size_range, n_points).astype(np.float32)
        # unique blocky texture per square: rBRIEF descriptors must differ
        # between squares (a flat square would alias every corner
        # descriptor), and blocks must be coarse enough that neighbouring
        # block corners don't alias inside the tracker's +/-7 px projection
        # search window
        base = rng.uniform(0.25, 1.0, (n_points, 4, 4)).astype(np.float32)
        tex = np.repeat(np.repeat(base, TEX_RES // 4, axis=1), TEX_RES // 4, axis=2)
        return cls(pts, inten, size, tex)

    def _render_pass(self, Tcw: np.ndarray, cam, want_depth: bool):
        """Shared sub-pixel rasterizer.

        Billboards are drawn with anti-aliased (coverage-weighted) edges at
        float coordinates and bilinear world-anchored texture sampling, so
        corner/texel features localize consistently to sub-pixel precision
        across views — integer-snapped rendering puts correlated ±1 px
        jumps on every observation and caps achievable ATE.
        """
        h, w = cam.height, cam.width
        img = np.full((h, w), 25.0, np.float32)
        depth = np.zeros((h, w), np.float32)
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        pc = self.points @ R.T + t
        z = pc[:, 2]
        vis = z > 0.3
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)
        u = fx * pc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * pc[:, 1] / np.maximum(z, 1e-6) + cy
        s_px = fx * self.size / np.maximum(z, 1e-6)
        order = np.argsort(-z)  # far first (painter's algorithm)
        for i in order:
            if not vis[i] or s_px[i] < 1.5:
                continue
            su = float(s_px[i])
            u0f, u1f = u[i] - su, u[i] + su
            v0f, v1f = v[i] - su, v[i] + su
            x0, x1 = max(0, int(np.floor(u0f))), min(w, int(np.ceil(u1f)) + 1)
            y0, y1 = max(0, int(np.floor(v0f))), min(h, int(np.ceil(v1f)) + 1)
            if y1 <= y0 or x1 <= x0:
                continue
            xs = np.arange(x0, x1, dtype=np.float32)
            ys = np.arange(y0, y1, dtype=np.float32)
            # pixel coverage along each axis (pixel p covers [p-0.5, p+0.5))
            cov_x = (np.minimum(xs + 0.5, u1f) - np.maximum(xs - 0.5, u0f)).clip(0, 1)
            cov_y = (np.minimum(ys + 0.5, v1f) - np.maximum(ys - 0.5, v0f)).clip(0, 1)
            alpha = cov_y[:, None] * cov_x[None, :]
            # bilinear texture lookup at world-anchored float coords
            txf = ((xs - u0f) / (2 * su) * (TEX_RES - 1)).clip(0, TEX_RES - 1)
            tyf = ((ys - v0f) / (2 * su) * (TEX_RES - 1)).clip(0, TEX_RES - 1)
            tx0 = np.floor(txf).astype(np.int32)
            ty0 = np.floor(tyf).astype(np.int32)
            ax = (txf - tx0)[None, :]
            ay = (tyf - ty0)[:, None]
            tx1 = np.minimum(tx0 + 1, TEX_RES - 1)
            ty1 = np.minimum(ty0 + 1, TEX_RES - 1)
            T = self.textures[i]
            tex = (
                T[np.ix_(ty0, tx0)] * (1 - ax) * (1 - ay)
                + T[np.ix_(ty0, tx1)] * ax * (1 - ay)
                + T[np.ix_(ty1, tx0)] * (1 - ax) * ay
                + T[np.ix_(ty1, tx1)] * ax * ay
            )
            patch = self.intensity[i] * tex
            img[y0:y1, x0:x1] = (1 - alpha) * img[y0:y1, x0:x1] + alpha * patch
            if want_depth:
                dp = depth[y0:y1, x0:x1]
                depth[y0:y1, x0:x1] = np.where(alpha > 0.5, z[i], dp)
        return img, depth

    def render(self, Tcw: np.ndarray, cam, noise=0.0, rng=None) -> np.ndarray:
        """Render a grayscale (H, W) image from camera pose Tcw."""
        img, _ = self._render_pass(Tcw, cam, want_depth=False)
        if noise > 0:
            rng = rng or np.random.default_rng(0)
            img = img + rng.normal(0, noise, img.shape).astype(np.float32)
        return np.clip(img, 0, 255)

    def render_stereo(self, Tcw: np.ndarray, cam, noise=0.0, rng=None):
        """Left/right pair; right camera displaced by baseline along +x."""
        baseline = float(cam.bf) / float(cam.fx)
        T_rl = np.eye(4, dtype=np.float32)
        T_rl[0, 3] = -baseline
        left = self.render(Tcw, cam, noise, rng)
        right = self.render(T_rl @ Tcw, cam, noise, rng)
        return left, right

    def render_depth(self, Tcw: np.ndarray, cam) -> np.ndarray:
        """Ideal depth map (z of the nearest billboard at each painted pixel;
        background = 0 -> invalid)."""
        _, depth = self._render_pass(Tcw, cam, want_depth=True)
        return depth


def smooth_trajectory(n_frames: int, step=0.06, yaw_rate=0.004, seed=0):
    """Ground-truth Tcw sequence: forward motion with gentle yaw (KITTI-like).

    Returns (n, 4, 4) float32 world->camera poses.
    """
    poses = [np.eye(4, dtype=np.float32)]
    motion = se3.exp(
        torch.tensor([0.0, 0.0, -step, 0.0, yaw_rate, 0.0], dtype=torch.float32)
    ).numpy()
    for _ in range(n_frames - 1):
        poses.append(motion @ poses[-1])
    return np.stack(poses)


def ate_rmse(traj_est: np.ndarray, traj_gt: np.ndarray) -> float:
    """Absolute trajectory error after SE3 (Umeyama, no scale) alignment.

    traj_*: (n, 3) camera-centre positions.  Mirrors the evo/TUM ATE metric
    used by the reference's evaluation path (Evaluation/kitti_to_tum.py).
    """
    mu_e = traj_est.mean(0)
    mu_g = traj_gt.mean(0)
    E = traj_est - mu_e
    G = traj_gt - mu_g
    C = G.T @ E / len(E)
    U, _, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    aligned = E @ R.T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - traj_gt) ** 2, axis=1))))


def ate_rmse_sim3(traj_est: np.ndarray, traj_gt: np.ndarray) -> float:
    """ATE with similarity (scale-corrected) alignment, for monocular runs."""
    mu_e = traj_est.mean(0)
    mu_g = traj_gt.mean(0)
    E = traj_est - mu_e
    G = traj_gt - mu_g
    C = G.T @ E / len(E)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (E ** 2).sum() / len(E)
    scale = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
    aligned = scale * E @ R.T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - traj_gt) ** 2, axis=1))))
