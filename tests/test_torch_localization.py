"""Localization-only mode: the ``tests/test_e2e.py`` facade scenario on both
packages (``SyntheticWorld`` seed 6, noise seed 4, 8 lateral RGB-D frames of
5 cm, 320x240, 400 features, 4 levels).  Four frames of SLAM, then
``activate_localization_mode`` and four more frames, loop closing off.

Asserted on both: every frame tracked, the map frozen (n_kf, n_pt, the point
and keyframe banks unchanged), the keyframe export, ``reset``.  Between
them: the same n_kf and n_pt, poses within 1 mm and 0.1 degree, the same
tracking-path counters.  A localization-only frame takes the decomposed
path with the temporal points of ``match_vo_points``; after
``deactivate_localization_mode`` the fused path and keyframes come back.
"""

import contextlib

import numpy as np
import pytest

from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from refactored_orb_slam2_tpu_torch import system as tsystem
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam, TrackState
from test_torch_epnp import jax_sets_injected
from test_torch_sequence import assert_poses_close, lateral_traj

CFG = SystemConfig(
    sensor="rgbd",
    camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                        width=320, height=240, fps=10),
    orb=ORBConfig(n_features=400, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8,
                  fuse_neighbors=4, triangulate_neighbors=4),
)
TCFG = config_from_reference(CFG)
N_SLAM = 4


@pytest.fixture(scope="module")
def frames():
    world = SyntheticWorld.create(seed=6, n_points=450, z_range=(2.5, 9.0), clear_tube=0.0)
    cam = TSlam(TCFG, device="cpu").cam
    rng = np.random.default_rng(4)
    return [(world.render(T, cam, noise=2.0, rng=rng), world.render_depth(T, cam))
            for T in lateral_traj(8, step=0.05)]


@pytest.fixture(scope="module")
def runs(frames):
    vo_calls, match_vo = [], tsystem.TK.match_vo_points
    tsystem.TK.match_vo_points = lambda *a, **k: vo_calls.append(k["th"]) or match_vo(*a, **k)
    out = {}
    try:
        for name in ("jax", "port"):
            slam = JSlam(CFG) if name == "jax" else TSlam(TCFG, device="cpu")
            slam.loop_closing_enabled = False
            returned, before = [], None
            for i, (img, depth) in enumerate(frames):
                if i == N_SLAM:
                    before = (slam.n_kf, slam.n_pt, np.asarray(slam.map.pt_pos).copy(),
                              np.asarray(slam.map.kf_pose).copy(),
                              np.asarray(slam.map.pt_valid).copy())
                    slam.activate_localization_mode()
                returned.append(slam.track_rgbd(img, depth, i * 0.1))
            out[name] = (slam, returned, before)
    finally:
        tsystem.TK.match_vo_points = match_vo
    return out, vo_calls


def test_every_frame_tracked_and_map_frozen(runs, frames):
    out, _ = runs
    for name, (slam, returned, before) in out.items():
        assert all(r is not None for r in returned), name
        n_kf, n_pt, pt_pos, kf_pose, pt_valid = before
        assert (slam.n_kf, slam.n_pt) == (n_kf, n_pt), name
        np.testing.assert_array_equal(np.asarray(slam.map.pt_pos), pt_pos)
        np.testing.assert_array_equal(np.asarray(slam.map.kf_pose), kf_pose)
        np.testing.assert_array_equal(np.asarray(slam.map.pt_valid), pt_valid)
        assert slam.localization_only and not slam.mb_vo
    assert len(out["port"][0].tracked_logs()) == len(frames)


def test_both_packages_agree(runs):
    out, _ = runs
    j, t = out["jax"][0], out["port"][0]
    assert (t.n_kf, t.n_pt) == (j.n_kf, j.n_pt)
    assert_poses_close(t.frame_poses(), j.frame_poses())
    assert_poses_close(np.stack(out["port"][1]), np.stack(out["jax"][1]))
    for key in ("motion_tracks", "ref_kf_tracks", "vo_tracks"):
        assert t.stats[key] == j.stats[key], key
    # the fused path counted frames 1-3; the localization frames do not add
    assert t.stats["motion_tracks"] == N_SLAM - 1


def test_localization_frames_take_the_vo_matcher(runs, frames):
    """One ``match_vo_points`` per localization-only frame, with twice the
    motion-model window (15 px for RGB-D)."""
    _, vo_calls = runs
    assert vo_calls == [30.0] * (len(frames) - N_SLAM)


def test_keyframe_export_and_reset(runs, tmp_path):
    out, _ = runs
    slam = out["port"][0]
    path = tmp_path / "kf.txt"
    slam.export_keyframe_trajectory_tum(str(path))
    assert len(path.read_text().strip().split("\n")) == slam.n_kf


def test_deactivate_brings_keyframes_back_and_reset_clears(frames):
    slam = TSlam(TCFG, device="cpu")
    slam.loop_closing_enabled = False
    fused = []
    track_fused = slam._track_fused
    slam._track_fused = lambda *a: fused.append(slam.frame_id) or track_fused(*a)
    for i, (img, depth) in enumerate(frames):
        if i == 2:
            slam.activate_localization_mode()
        if i == 4:
            slam.deactivate_localization_mode()
        assert slam.track_rgbd(img, depth, i * 0.1) is not None
    assert fused == [1, 4, 5, 6, 7]       # frame 0 initializes, 2-3 localize only
    assert not slam.localization_only
    slam.reset()
    assert slam.n_kf == 0 and slam.n_pt == 0
    assert not bool(slam.map.kf_valid.any())
    assert slam.state == TrackState.NOT_INITIALIZED and not slam.mb_vo


def test_lost_in_localization_mode_names_relocalization(frames):
    """With the map frozen a lost frame does not reset the system: the next
    frame goes to ``_relocalize`` (here with one keyframe in the database)
    on both packages, which agree with the JAX package's EPnP sets injected:
    relocalized or not, the state, ``stats``, the map unchanged, and a
    relocalized pose within 1 mm and 0.1 degree."""
    out = {}
    for name in ("jax", "port"):
        slam = JSlam(CFG) if name == "jax" else TSlam(TCFG, device="cpu")
        slam.loop_closing_enabled = False
        for i, (img, depth) in enumerate(frames[:3]):
            slam.track_rgbd(img, depth, i * 0.1)
        slam.activate_localization_mode()
        blank = np.full_like(frames[0][0], 128.0), np.full_like(frames[0][1], 2.0)
        assert slam.track_rgbd(*blank, 0.3) is None
        assert slam.state == TrackState.LOST and slam.n_kf == 1
        calls, reloc = [], slam._relocalize
        slam._relocalize = lambda frame: calls.append(frame) or reloc(frame)
        with (jax_sets_injected() if name == "port" else contextlib.nullcontext()):
            pose = slam.track_rgbd(*frames[4], 0.4)
        out[name] = (pose, slam.state, {k: slam.stats[k] for k in ("relocs", "reloc_rejects")},
                     len(calls), (slam.n_kf, slam.n_pt))
    (pj, sj, statj, cj, mapj), (pt, st, statt, ct, mapt) = out["jax"], out["port"]
    assert cj == ct == 1
    assert (pt is None) == (pj is None) and st == sj
    assert statt == statj and mapt == mapj and mapt[0] == 1
    if pt is not None:
        assert statt["relocs"] == 1
        assert_poses_close(pt[None], pj[None])
