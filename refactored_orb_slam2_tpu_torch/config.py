"""Typed configuration for the SLAM engine (the port's own config tree).

The same classes, field names and defaults as
``refactored_orb_slam2_tpu/utils/config.py``, kept as a copy so that the
port imports nothing of the JAX package; ``io/convert.py::
config_from_reference`` turns that package's ``SystemConfig`` into this
one, and ``tests/test_torch_config.py`` holds the two trees equal.

The reference scatters settings across per-dataset OpenCV YAML files
(Tracking.cc:52-147 parses Camera.*, ORBextractor.*, ThDepth,
DepthMapFactor) and hardcoded constants (ORBmatcher.cc:38-40 TH_LOW/TH_HIGH,
chi-square gates 5.991/7.815/9.21, covisibility threshold 15 KeyFrame.cc:310,
loop consistency 3 LoopClosing.cc:45).  Here everything lives in one typed
config tree; the OpenCV-YAML loader maps the reference's exact keys onto it
so the stock TUM/KITTI/EuRoC settings files work unchanged.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class CameraConfig:
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0          # baseline * fx (stereo/RGB-D)
    fps: float = 30.0
    rgb: bool = True          # color channel order of input images
    width: int = 640
    height: int = 480


@dataclass(frozen=True)
class ORBConfig:
    """ORBextractor settings (Tracking.cc:106-134, ORBextractor ctor)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # capacity: padded keypoint slots per frame (>= n_features).
    max_keypoints: int = 0   # 0 -> derived as next multiple of 256 >= n_features

    @property
    def padded_keypoints(self) -> int:
        if self.max_keypoints:
            return self.max_keypoints
        return ((self.n_features + 255) // 256) * 256


@dataclass(frozen=True)
class MatcherConfig:
    """ORBmatcher constants (ORBmatcher.cc:38-40 and call sites)."""

    th_low: int = 50
    th_high: int = 100
    histo_length: int = 30
    nn_ratio_tracking: float = 0.9    # TrackWithMotionModel (Tracking.cc:784)
    nn_ratio_ref_kf: float = 0.7      # TrackReferenceKeyFrame (Tracking.cc:688)
    nn_ratio_reloc: float = 0.75


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking-loop thresholds (Tracking.cc call sites)."""

    th_depth: float = 35.0            # close/far split in BASELINE units
                                      # (metric th = th_depth * bf / fx,
                                      # Tracking.cc:139-147)
    depth_map_factor: float = 1.0     # RGB-D depth scaling (DepthMapFactor)
    min_inliers_track: int = 10       # TrackWithMotionModel/RefKF (Tracking.cc:770)
    min_inliers_local_map: int = 30   # TrackLocalMap pass bar (Tracking.cc:875)
    min_inliers_local_map_reloc: int = 50
    min_matches_ref_kf: int = 15      # TrackReferenceKeyFrame bar (Tracking.cc:694)
    min_inliers_reloc: int = 50       # Relocalization accept bar (Tracking.cc:1356)
    max_local_keyframes: int = 80     # UpdateLocalKeyFrames cap (Tracking.cc:1167)
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30   # = fps in the reference (Tracking.cc:148)
    # pose-only LM seed in TrackWithMotionModel: False = last frame's pose
    # (this engine's default; see the experiment in
    # scripts/exp_pose_seed.py), True = the velocity-extrapolated
    # prediction (the reference's seed, Tracking.cc:787)
    seed_pose_opt_from_prediction: bool = False


@dataclass(frozen=True)
class MapConfig:
    """Static array capacities for the SoA map (padded banks)."""

    max_keyframes: int = 512
    max_points: int = 65536
    max_obs_per_point: int = 32
    covis_threshold: int = 15         # KeyFrame::UpdateConnections (KeyFrame.cc:310)
    ess_graph_min_weight: int = 100   # OptimizeEssentialGraph (Optimizer.cc:796)
    # local-BA window compaction (gather_ba_window): dense Schur solve over
    # at most this many keyframes (window + fixed boundary) / points
    local_ba_max_kfs: int = 64
    # 4096 covers the ~20-keyframe covisibility window with margin at TUM
    # densities (~2-4k window points measured on the room orbit; a
    # local_ba_point_overflow warning fires if a window exceeds it) and
    # halves the LM assembly cost, which is linear in the point budget
    local_ba_max_points: int = 4096
    # obs slots per gathered point inside the local-BA window: LM cost is
    # linear in P*O edge slots (profile_lm.py); window-KF observations are
    # kept preferentially when a point's subgraph obs exceed this
    local_ba_max_obs: int = 16
    # CG iterations per LM step for the matrix-free global-BA solver
    gba_cg_iters: int = 80
    # essential-graph solver: "auto" picks dense for small banks and the
    # matrix-free block-Jacobi PCG (optim/pose_graph.py) when
    # max_keyframes > pose_graph_dense_max — dense (K,K,7,7) assembly at
    # K=2048 would be 822 MB/iteration
    pose_graph_solver: str = "auto"   # "auto" | "dense" | "pcg"
    pose_graph_dense_max: int = 512
    pose_graph_cg_iters: int = 0      # 0 = max(64, K // 4)
    # covisible-neighbor counts for SearchInNeighbors / CreateNewMapPoints
    # (LocalMapping.cc:189-192, 430-433); 0 = the reference's 10 (20 mono)
    fuse_neighbors: int = 0
    triangulate_neighbors: int = 0


@dataclass(frozen=True)
class LoopConfig:
    covisibility_consistency_th: int = 3  # LoopClosing.cc:45
    min_bow_matches: int = 20             # LoopClosing.cc ComputeSim3
    min_total_matches: int = 40
    kf_gap: int = 10                      # >=10 KFs since last loop (LoopClosing.cc:99)


@dataclass(frozen=True)
class SystemConfig:
    sensor: str = "monocular"   # "monocular" | "stereo" | "rgbd"
    # visual-vocabulary asset path; empty -> packaged assets/vocab.npz.
    # A missing asset is a hard error (the reference cannot run without
    # ORBvoc either, System.cc:74-83) unless allow_vocab_fallback opts in
    # to lazy one-frame training (degraded loop/reloc recall).
    vocab_path: str = ""
    allow_vocab_fallback: bool = False
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    map: MapConfig = field(default_factory=MapConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# OpenCV-YAML loader (reads the reference's unmodified settings files)
# ---------------------------------------------------------------------------

def _parse_opencv_yaml(text: str) -> dict:
    """Parse an OpenCV FileStorage YAML into a flat dict.

    Handles the '%YAML:1.0' directive and '!!opencv-matrix' tags that stock
    pyyaml rejects.  Matrices come back as numpy arrays.
    """
    import yaml

    text = re.sub(r"^%YAML:.*$", "", text, flags=re.M)
    text = text.replace("!!opencv-matrix", "")
    data = yaml.safe_load(text) or {}
    out = {}
    for k, v in data.items():
        if isinstance(v, dict) and {"rows", "cols", "data"} <= set(v):
            out[k] = np.asarray(v["data"], dtype=np.float64).reshape(
                int(v["rows"]), int(v["cols"])
            )
        else:
            out[k] = v
    return out


def load_settings(path: str, sensor: str = "monocular") -> SystemConfig:
    """Build a SystemConfig from a reference-format settings YAML file."""
    with open(path) as f:
        d = _parse_opencv_yaml(f.read())

    def g(key, default):
        return d.get(key, default)

    cam = CameraConfig(
        fx=float(g("Camera.fx", 500.0)),
        fy=float(g("Camera.fy", 500.0)),
        cx=float(g("Camera.cx", 320.0)),
        cy=float(g("Camera.cy", 240.0)),
        k1=float(g("Camera.k1", 0.0)),
        k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)),
        p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        bf=float(g("Camera.bf", 0.0)),
        fps=float(g("Camera.fps", 30.0)),
        rgb=bool(g("Camera.RGB", 1)),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
    )
    orb = ORBConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    tracking = TrackingConfig(
        th_depth=float(g("ThDepth", 35.0)),
        depth_map_factor=float(g("DepthMapFactor", 1.0)),
        max_frames_between_kf=int(g("Camera.fps", 30.0)),
    )
    return SystemConfig(sensor=sensor, camera=cam, orb=orb, tracking=tracking)


__all__ = [
    "CameraConfig", "LoopConfig", "MapConfig", "MatcherConfig", "ORBConfig",
    "SystemConfig", "TrackingConfig", "load_settings",
]
