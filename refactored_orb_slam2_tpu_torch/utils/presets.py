"""Named per-dataset configuration presets (the port's own copy of
utils/presets.py, so that the port imports nothing of the JAX package;
``tests/test_torch_config.py`` holds it equal to the original, preset by
preset).

The reference ships one OpenCV-YAML settings file per dataset/sensor
(Source/Examples/{Monocular,Stereo,RGB-D}/*.yaml, parsed by
Tracking.cc:52-147).  Those files still load through
``utils.config.load_settings``; the presets here bake the same calibration
constants into typed configs so no settings asset is needed:

    cfg = get_preset("rgbd_tum1")
    slam = SlamSystem(cfg, device="cuda")

Calibration facts per dataset (camera intrinsics/distortion, baseline*fx,
fps, ORB feature budget, depth thresholds) match the reference settings
files; image sizes come from the datasets themselves (the engine needs
static shapes).  EuRoC stereo additionally carries the cam0/cam1
rectification matrices (reference stereo_euroc.cc:70-115 reads LEFT.*/
RIGHT.* from the YAML).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import CameraConfig, ORBConfig, SystemConfig, TrackingConfig

_TUM_INTRINSICS = {
    # fx, fy, cx, cy, k1, k2, p1, p2, k3, depth_map_factor
    "tum1": (517.306408, 516.469215, 318.643040, 255.313989,
             0.262383, -0.953104, -0.005358, 0.002628, 1.163314, 5000.0),
    "tum2": (520.908620, 521.007327, 325.141442, 249.701764,
             0.231222, -0.784899, -0.003257, -0.000105, 0.917205, 5208.0),
    "tum3": (535.4, 539.2, 320.1, 247.6, 0.0, 0.0, 0.0, 0.0, 0.0, 5000.0),
}

_KITTI_INTRINSICS = {
    # fx, fy, cx, cy, bf, th_depth, width, height
    "kitti00": (718.856, 718.856, 607.1928, 185.2157, 386.1448, 35.0, 1241, 376),
    "kitti03": (721.5377, 721.5377, 609.5593, 172.854, 387.5744, 40.0, 1242, 375),
    "kitti04": (707.0912, 707.0912, 601.8873, 183.1104, 379.8145, 40.0, 1226, 370),
}

# EuRoC cam0/cam1 rectification (K, D, R, P per side; P encodes the
# rectified pinhole + stereo baseline).  Same numbers the reference's
# Stereo/EuRoC.yaml feeds to cv::initUndistortRectifyMap.
EUROC_RECTIFICATION = {
    "LEFT.K": np.array([[458.654, 0.0, 367.215],
                        [0.0, 457.296, 248.375],
                        [0.0, 0.0, 1.0]]),
    "LEFT.D": np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
    "LEFT.R": np.array([
        [0.999966347530033, -0.001422739138722922, 0.008079580483432283],
        [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
        [-0.008089410156878961, -0.007044357138835809, 0.9999424675829176]]),
    "LEFT.P": np.array([
        [435.2046959714599, 0.0, 367.4517211914062, 0.0],
        [0.0, 435.2046959714599, 252.2008514404297, 0.0],
        [0.0, 0.0, 1.0, 0.0]]),
    "RIGHT.K": np.array([[457.587, 0.0, 379.999],
                         [0.0, 456.134, 255.238],
                         [0.0, 0.0, 1.0]]),
    "RIGHT.D": np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]),
    "RIGHT.R": np.array([
        [0.9999633526194376, -0.003625811871560086, 0.007755443660172947],
        [0.003680398547259526, 0.9999684752771629, -0.007035845251224894],
        [-0.007729688520722713, 0.007064130529506649, 0.999945173484644]]),
    "RIGHT.P": np.array([
        [435.2046959714599, 0.0, 367.4517211914062, -47.90639384423901],
        [0.0, 435.2046959714599, 252.2008514404297, 0.0],
        [0.0, 0.0, 1.0, 0.0]]),
}


def _tum(variant: str, sensor: str) -> SystemConfig:
    fx, fy, cx, cy, k1, k2, p1, p2, k3, dmf = _TUM_INTRINSICS[variant]
    cam = CameraConfig(
        fx=fx, fy=fy, cx=cx, cy=cy, k1=k1, k2=k2, p1=p1, p2=p2, k3=k3,
        bf=40.0 if sensor == "rgbd" else 0.0,
        fps=30.0, width=640, height=480,
    )
    tr = TrackingConfig(
        th_depth=40.0,
        depth_map_factor=dmf if sensor == "rgbd" else 1.0,
        max_frames_between_kf=30,
    )
    return SystemConfig(sensor=sensor, camera=cam, orb=ORBConfig(n_features=1000),
                        tracking=tr)


def _kitti(variant: str, sensor: str) -> SystemConfig:
    fx, fy, cx, cy, bf, th_depth, w, h = _KITTI_INTRINSICS[variant]
    cam = CameraConfig(
        fx=fx, fy=fy, cx=cx, cy=cy,
        bf=bf if sensor == "stereo" else 0.0,
        fps=10.0, width=w, height=h,
    )
    tr = TrackingConfig(th_depth=th_depth, max_frames_between_kf=10)
    return SystemConfig(sensor=sensor, camera=cam, orb=ORBConfig(n_features=2000),
                        tracking=tr)


def _euroc(sensor: str) -> SystemConfig:
    if sensor == "stereo":
        # Rectified pinhole from LEFT.P; images are remapped before tracking.
        cam = CameraConfig(
            fx=435.2046959714599, fy=435.2046959714599,
            cx=367.4517211914062, cy=252.2008514404297,
            bf=47.90639384423901, fps=20.0, width=752, height=480,
        )
        n_features = 1200
    else:
        cam = CameraConfig(
            fx=458.654, fy=457.296, cx=367.215, cy=248.375,
            k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05,
            fps=20.0, width=752, height=480,
        )
        n_features = 1000
    tr = TrackingConfig(th_depth=35.0, max_frames_between_kf=20)
    return SystemConfig(sensor=sensor, camera=cam,
                        orb=ORBConfig(n_features=n_features), tracking=tr)


_PRESETS = {
    # reference Monocular/*.yaml
    "mono_tum1": lambda: _tum("tum1", "monocular"),
    "mono_tum2": lambda: _tum("tum2", "monocular"),
    "mono_tum3": lambda: _tum("tum3", "monocular"),
    "mono_kitti00": lambda: _kitti("kitti00", "monocular"),
    "mono_kitti03": lambda: _kitti("kitti03", "monocular"),
    "mono_kitti04": lambda: _kitti("kitti04", "monocular"),
    "mono_euroc": lambda: _euroc("monocular"),
    # reference Stereo/*.yaml
    "stereo_kitti00": lambda: _kitti("kitti00", "stereo"),
    "stereo_kitti03": lambda: _kitti("kitti03", "stereo"),
    "stereo_kitti04": lambda: _kitti("kitti04", "stereo"),
    "stereo_euroc": lambda: _euroc("stereo"),
    # reference RGB-D/*.yaml
    "rgbd_tum1": lambda: _tum("tum1", "rgbd"),
    "rgbd_tum2": lambda: _tum("tum2", "rgbd"),
    "rgbd_tum3": lambda: _tum("tum3", "rgbd"),
}


def preset_names() -> list[str]:
    return sorted(_PRESETS)


def get_preset(name: str, **overrides) -> SystemConfig:
    """Return the named preset config; keyword overrides are applied with
    ``dataclasses.replace`` on the top-level SystemConfig."""
    try:
        cfg = _PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {preset_names()}")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def kitti_preset_for_sequence(seq: int, sensor: str = "stereo") -> SystemConfig:
    """Pick the right KITTI calibration group for an odometry sequence id
    (00-02 / 03 / 04-12, mirroring the reference's three settings files)."""
    if 0 <= seq <= 2:
        variant = "kitti00"
    elif seq == 3:
        variant = "kitti03"
    else:
        variant = "kitti04"
    return _kitti(variant, sensor)
