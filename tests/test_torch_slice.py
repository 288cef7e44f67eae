"""The RGB-D tracking slice end to end: the JAX and the port ``SlamSystem``
track the same 6 rendered 320x240 frames of the room fixture (500 features,
4 levels, map 24 keyframes x 4096 points x 8 observations).

Asserted: the same frames tracked and one keyframe on both; the same 6
per-frame scalars of the fused step (motion matches, inliers of both LMs,
close counts, reference-tracked), with no slack since the ORB test found
every keyframe and descriptor equal; poses within 1 mm and 0.1 degree; the
TUM export readable; the local-map matching of every fused step going
through ``cuda_hamming.window_match`` (its plain branch on the CPU).
"""

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam
from refactored_orb_slam2_tpu_torch.utils import world3d as W

# One intra-op thread: at these sizes PyTorch's threads gain nothing, and
# several test workers with a thread per core each spin against one another.
# Every file that runs the port's whole system sets it, so the setting holds
# whichever files a run selects.
torch.set_num_threads(1)

CFG = SystemConfig(
    sensor="rgbd",
    camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                        width=320, height=240),
    orb=ORBConfig(n_features=500, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
)
TCFG = config_from_reference(CFG)        # the port's own config tree
N_FRAMES = 6


def _record_scalars(slam, store):
    """Keep the (6,) scalar vector of every fused step: the JAX facade's
    ``_dispatch_fused`` record holds it as ``sc``, the port's ``_fused_step``
    returns it last."""
    name, scalars_of = (("_fused_step", lambda out: out[-1]) if isinstance(slam, TSlam)
                        else ("_dispatch_fused", lambda rec: rec["sc"]))
    step = getattr(slam, name)

    def recorded(*args, **kw):
        out = step(*args, **kw)
        store.append(np.array(scalars_of(out)))
        return out

    setattr(slam, name, recorded)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:N_FRAMES]
    rng = np.random.default_rng(0)
    port = TSlam(TCFG, device="cpu")
    frames = [world.render(T, port.cam, want_depth=True, noise=2.0, rng=rng)
              for T in poses]
    ref = JSlam(CFG)
    out = {}
    for name, slam in (("jax", ref), ("port", port)):
        scalars, returned = [], []
        _record_scalars(slam, scalars)
        calls = cuda_hamming.window_match
        n_calls = [0]

        def counted(*a, **k):
            n_calls[0] += 1
            return calls(*a, **k)

        cuda_hamming.window_match = counted
        try:
            for i, (img, depth) in enumerate(frames):
                returned.append(slam.track_rgbd(img, depth, i / 30.0))
        finally:
            cuda_hamming.window_match = calls
        path = tmp_path_factory.mktemp(name) / "traj.txt"
        slam.export_trajectory_tum(str(path))
        out[name] = dict(slam=slam, scalars=np.array(scalars), returned=returned,
                         window_calls=n_calls[0], tum=path)
    return poses, out


def test_same_frames_tracked_one_keyframe(runs):
    _, out = runs
    j, t = out["jax"]["slam"], out["port"]["slam"]
    np.testing.assert_array_equal(t.tracked_frame_ids(), j.tracked_frame_ids())
    assert len(t.tracked_frame_ids()) == N_FRAMES
    assert t.n_kf == j.n_kf == 1
    assert t.n_pt == j.n_pt
    assert all(p is not None and p.shape == (4, 4) for p in out["port"]["returned"])


def test_fused_step_scalars_equal(runs):
    _, out = runs
    js, ts = out["jax"]["scalars"], out["port"]["scalars"]
    assert ts.shape == (N_FRAMES - 1, 6)
    np.testing.assert_array_equal(ts, js)
    assert (ts[:, 2] >= 30).all()          # local-map inliers pass the bar


def test_poses_within_1mm_and_0p1deg(runs):
    poses, out = runs
    pj = out["jax"]["slam"].frame_poses()
    pt = out["port"]["slam"].frame_poses()
    assert np.isfinite(pt).all()
    for a, b in zip(pt, pj):
        d = a @ np.linalg.inv(b)
        angle = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        assert angle < 0.1
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=1e-3)
    # the trajectory itself is right: camera centres against the rendered
    # poses, in the first camera's frame
    centres = out["port"]["slam"].camera_centers()
    gt = np.stack([(poses[0] @ np.linalg.inv(T))[:3, 3] for T in poses])
    assert np.sqrt(np.mean(np.sum((centres - gt) ** 2, axis=1))) < 0.005


def test_tum_export_readable(runs):
    _, out = runs
    t = np.loadtxt(out["port"]["tum"])
    j = np.loadtxt(out["jax"]["tum"])
    assert t.shape == (N_FRAMES, 8)
    np.testing.assert_allclose(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(t[:, 4:], axis=1), 1.0, atol=1e-5)


def test_fused_step_goes_through_window_match(runs):
    _, out = runs
    assert out["port"]["window_calls"] == N_FRAMES - 1
    assert out["jax"]["window_calls"] == 0


def test_outside_the_slice_raises():
    """The stereo and monocular sensors and relocalization are inside the
    port; an unknown sensor and the async modes are not.  A system that has
    inserted no keyframe has no KeyFrameDB, so ``_relocalize`` finds no
    candidate, as the JAX package's does, and reads nothing."""
    for sensor in ("stereo", "monocular"):
        assert TSlam(TCFG.replace(sensor=sensor), device="cpu").sensor == sensor
    with pytest.raises(ValueError, match="sensor"):
        TSlam(TCFG.replace(sensor="imu"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        TSlam(TCFG, device="cpu", pipelined=True)
    slam, ref = TSlam(TCFG, device="cpu"), JSlam(CFG)
    frame = slam._build_frame(torch.zeros((240, 320), dtype=torch.uint8),
                              torch.zeros((240, 320), dtype=torch.int32).to(torch.uint16))
    assert slam.db is None and ref.db is None
    assert slam._relocalize(frame) == (False, None, None)
    assert ref._relocalize(None) == (False, None, None)
    assert slam.reloc_log == [] and slam.stats["relocs"] == slam.stats["reloc_rejects"] == 0


def test_motion_failure_raises_naming_item_7():
    """A frame without texture after initialization fails motion-model
    tracking.  Item 7 brought its fallback: TrackReferenceKeyFrame finds no
    match either, the frame is lost, and the next frame resets the system
    (n_kf <= 5) instead of raising.  Localization-only mode (item 7b) came
    after it: there the map is frozen and a lost system does not reset.
    Relocalization (item 10) came last: on the map made again from the same
    view, every lost localization-only frame goes to ``_relocalize``; the
    blank one finds no feature to match and stays lost, the view of
    keyframe 0 relocalizes at keyframe 0's pose."""
    world = W.scene_room(seed=11)
    slam = TSlam(TCFG, device="cpu")
    T = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[0]
    view = world.render(T, slam.cam, want_depth=True)
    assert slam.track_rgbd(*view, 0.0) is not None
    assert slam.db is not None and bool(slam.db.valid[0])   # keyframe 0's signature
    blank = torch.full((240, 320), 128, dtype=torch.uint8)
    depth = torch.full((240, 320), 2000).to(torch.uint16)
    assert slam.track_rgbd_device(blank, depth, 1 / 30.0) is None
    assert slam.state == 2 and slam.trajectory[-1].lost
    assert slam.track_rgbd(*view, 2 / 30.0) is None
    assert slam.state == 0 and slam.n_kf == 0 and not slam.trajectory
    assert slam.db is None and slam.vocab is None and slam.last_reloc_frame_id == -1
    assert slam.track_rgbd(*view, 3 / 30.0) is not None       # initialized again
    slam.activate_localization_mode()
    assert slam.localization_only
    calls = []
    reloc = slam._relocalize
    slam._relocalize = lambda frame: calls.append(int(frame.valid.sum())) or reloc(frame)
    assert slam.track_rgbd_device(blank, depth, 4 / 30.0) is None   # lost, the map frozen
    assert slam.state == 2 and slam.n_kf == 1 and not calls
    assert slam.track_rgbd_device(blank, depth, 5 / 30.0) is None   # no feature to match
    assert calls == [0] and slam.state == 2 and slam.stats["relocs"] == 0
    pose = slam.track_rgbd(*view, 6 / 30.0)
    assert len(calls) == 2 and slam.state == 1 and slam.stats["relocs"] == 1
    assert slam.last_reloc_frame_id == slam.frame_id and slam.velocity is None
    np.testing.assert_allclose(pose, np.eye(4), atol=1e-3)
    assert slam.n_kf == 1
    slam.deactivate_localization_mode()
    assert not slam.localization_only
