"""Headless visualization: trajectory and map figures (port of io/viz.py).

Replaces the Pangolin GL viewer (Viewer/MapDrawer/FrameDrawer — explicitly
optional in the reference, System.cc:151) with offline matplotlib renders:
top-down trajectory vs ground truth, the map's landmarks and keyframes,
and a per-frame keypoint overlay with the tracking-state line.  matplotlib
is imported inside each function (Agg backend), so importing this module
needs neither it nor a display; each call reads the tensors it draws back
from the system's device once.
"""

from __future__ import annotations

import numpy as np
import torch


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(
    path: str,
    est_centers: np.ndarray,
    gt_centers: np.ndarray | None = None,
    title: str = "trajectory (top-down)",
):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(est_centers[:, 0], est_centers[:, 2], "-", lw=1.5, label="estimate")
    if gt_centers is not None:
        ax.plot(gt_centers[:, 0], gt_centers[:, 2], "--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def draw_frame(path: str, system, image: np.ndarray, frame_no: int | None = None):
    """FrameDrawer parity (FrameDrawer.cc:38-120): keypoint overlay on the
    current frame plus the status text line.

    Tracked map points (landmarks with >= 1 keyframe observation) are drawn
    as green squares, "visual odometry" points (matched landmarks with no
    keyframe observation yet) as blue squares, unmatched keypoints as faint
    dots; the footer reproduces the reference's DrawTextInfo fields (mode,
    keyframe / landmark / match counts, or the LOST / INITIALIZING banner).

    ``image`` is the grayscale frame that was passed to track_* (raw pixel
    coordinates; keypoints are drawn at their raw positions like the
    reference's cv::rectangle on mvCurrentKeys).  The last frame's keypoints,
    its point associations and those points' observation rows are read
    from the device once.
    """
    from ..system import TrackState

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6.6))
    ax.imshow(np.asarray(image), cmap="gray", vmin=0, vmax=255)

    state = system.state
    n_map = n_vo = 0
    if system.last_frame is not None and state == TrackState.OK:
        fr = system.last_frame
        pt_dev = (system.last_pt_idx if system.last_pt_idx is not None
                  else torch.full((fr.n_slots,), -1, dtype=torch.int32, device=fr.xy.device))
        obs = system.map.pt_obs_kf.index_select(0, torch.clamp(pt_dev, min=0).long())
        xy = fr.xy_raw.cpu().numpy()
        valid = fr.valid.cpu().numpy()
        pt = pt_dev.cpu().numpy()
        n_obs = (obs >= 0).sum(dim=1).cpu().numpy()
        matched = (pt >= 0) & valid
        is_map = matched & (n_obs >= 1)
        is_vo = matched & (n_obs < 1)
        n_map, n_vo = int(is_map.sum()), int(is_vo.sum())
        loose = valid & ~matched
        ax.scatter(xy[loose, 0], xy[loose, 1], s=4, c="0.6", alpha=0.5,
                   linewidths=0)
        ax.scatter(xy[is_map, 0], xy[is_map, 1], s=36, marker="s",
                   facecolors="none", edgecolors="lime", linewidths=1.0)
        ax.scatter(xy[is_vo, 0], xy[is_vo, 1], s=36, marker="s",
                   facecolors="none", edgecolors="deepskyblue", linewidths=1.0)

    if state == TrackState.OK:
        mode = "LOCALIZATION" if system.localization_only else "SLAM"
        txt = (f"{mode} MODE | KFs: {system.n_kf}, MPs: {system.n_pt}, "
               f"Matches: {n_map}")
        if n_vo:
            txt += f", + VO matches: {n_vo}"
    elif state == TrackState.LOST:
        txt = "TRACK LOST. TRYING TO RELOCALIZE"
    elif state == TrackState.NOT_INITIALIZED:
        txt = "TRYING TO INITIALIZE"
    else:
        txt = "WAITING FOR IMAGES"
    if frame_no is not None:
        txt = f"frame {frame_no} | " + txt
    ax.text(0.01, -0.04, txt, transform=ax.transAxes, fontsize=9,
            family="monospace", va="top")
    ax.set_xlim(0, image.shape[1])
    ax.set_ylim(image.shape[0], 0)
    ax.axis("off")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return {"matches": n_map, "vo_matches": n_vo, "state": str(state)}


def plot_map(path: str, system, max_points: int = 20000):
    """Top-down map: landmarks + keyframe positions."""
    plt = _pyplot()
    m = system.map
    pts = m.pt_pos.cpu().numpy()
    valid = m.pt_valid.cpu().numpy()
    pts = pts[valid][:max_points]
    kf_poses = m.kf_pose.cpu().numpy()
    kf_valid = m.kf_valid.cpu().numpy()
    centers = np.stack(
        [-(T[:3, :3].T @ T[:3, 3]) for T in kf_poses[kf_valid]]
    ) if kf_valid.any() else np.zeros((0, 3))

    fig, ax = plt.subplots(figsize=(8, 8))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="k", alpha=0.4, label="landmarks")
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 2], "b.-", ms=4, lw=0.8, label="keyframes")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(f"map: {valid.sum()} landmarks, {kf_valid.sum()} keyframes")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
