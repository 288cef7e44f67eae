"""The ``tests/test_e2e.py`` stereo scenario on both packages: the JAX and
the port ``SlamSystem`` on the same 10 rendered stereo pairs
(``SyntheticWorld`` seed 4, noise seed 2, 320x240, bf 80, 500 features, 4
levels, map 24 x 4096 x 8), synchronous mapping, loop closing off on both.

Asserted: no frame lost and ATE < 0.05 m on both; the same keyframes at the
same frame ids; every frame on the motion-model path (the 7 px stereo
window); per-frame poses within 1 mm and 0.1 degree.  ``n_pt`` within 1%:
on frame 3 one keypoint above pyramid level 0 differs between the packages
(levels above 0 are float32 products summed in another order), which moves
one match and so one point (measured: 546 and 547).
"""

import numpy as np
import pytest

from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld, ate_rmse
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam
from test_torch_sequence import assert_poses_close, gt_centers, lateral_traj

CFG = SystemConfig(
    sensor="stereo",
    camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=80.0,
                        width=320, height=240, fps=10),
    orb=ORBConfig(n_features=500, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8,
                  fuse_neighbors=4, triangulate_neighbors=4),
)
TCFG = config_from_reference(CFG)


@pytest.fixture(scope="module")
def sequence():
    world = SyntheticWorld.create(seed=4, n_points=500, x_range=(-6, 6),
                                  y_range=(-2.5, 2.5), z_range=(2.5, 10.0), clear_tube=0.0)
    traj = lateral_traj(10)
    cam = TSlam(TCFG, device="cpu").cam
    rng = np.random.default_rng(2)
    frames = [world.render_stereo(T, cam, noise=2.0, rng=rng) for T in traj]
    # (N1, N2) of every masked best-2 search of the port
    shapes, best2 = [], cuda_hamming.hamming_best2
    out = {}
    for name in ("jax", "port"):
        slam = JSlam(CFG) if name == "jax" else TSlam(TCFG, device="cpu")
        slam.loop_closing_enabled = False
        if name == "port":
            cuda_hamming.hamming_best2 = lambda *a: shapes.append(tuple(a[2].shape)) or best2(*a)
        try:
            returned = [slam.track_stereo(left, right, i * 0.1)
                        for i, (left, right) in enumerate(frames)]
        finally:
            cuda_hamming.hamming_best2 = best2
        out[name] = (slam, returned)
    return traj, out, shapes


def test_stereo_sequence_tracks_every_frame(sequence):
    traj, out, _ = sequence
    for name, (slam, returned) in out.items():
        assert all(r is not None for r in returned), name
        assert len(slam.tracked_logs()) == len(traj)
        assert ate_rmse(slam.camera_centers(), gt_centers(traj)) < 0.05, name


def test_stereo_sequence_keyframes_and_points_match(sequence):
    _, out, _ = sequence
    j, t = out["jax"][0], out["port"][0]
    assert t.n_kf == j.n_kf >= 3
    np.testing.assert_array_equal(t.map.kf_frame_id[:t.n_kf].numpy(),
                                  np.asarray(j.map.kf_frame_id)[:j.n_kf])
    assert abs(t.n_pt - j.n_pt) <= 0.01 * j.n_pt
    assert t.stats["motion_tracks"] == j.stats["motion_tracks"] == 9
    assert t.stats["ref_kf_tracks"] == j.stats["ref_kf_tracks"] == 0


def test_stereo_sequence_poses_within_1mm_and_0p1deg(sequence):
    _, out, _ = sequence
    j, t = out["jax"][0], out["port"][0]
    assert_poses_close(t.frame_poses(), j.frame_poses())
    assert_poses_close(np.stack(out["port"][1]), np.stack(out["jax"][1]))


def test_every_stereo_frame_runs_one_left_right_search(sequence):
    """The stereo matcher gives the masked best-2 wrapper one (N, N) search
    per frame, besides local mapping's searches."""
    traj, out, shapes = sequence
    n = out["port"][0].n_feat_slots
    assert shapes.count((n, n)) >= len(traj)
    assert len(shapes) > len(traj)            # and mapping's own


def test_device_entry_point_gives_the_same_pose(sequence):
    """``track_stereo_device`` on the wire encoding equals ``track_stereo``
    on the host arrays (frame 0: initialization from stereo depth)."""
    import torch

    from refactored_orb_slam2_tpu_torch.system import _encode_img

    traj, out, _ = sequence
    world = SyntheticWorld.create(seed=4, n_points=500, x_range=(-6, 6),
                                  y_range=(-2.5, 2.5), z_range=(2.5, 10.0), clear_tube=0.0)
    slam = TSlam(TCFG, device="cpu")
    left, right = world.render_stereo(traj[0], slam.cam, noise=2.0,
                                      rng=np.random.default_rng(2))
    pose = slam.track_stereo_device(torch.from_numpy(_encode_img(left)),
                                    torch.from_numpy(_encode_img(right)), 0.0)
    np.testing.assert_array_equal(pose, out["port"][1][0])
    assert slam.n_kf == 1 and slam.n_pt > 100
