"""Whole sequences with synchronous local mapping: the JAX and the port
``SlamSystem`` on the same frames, loop closing off on both.

- The ``tests/test_e2e.py`` RGB-D scenario (SyntheticWorld seed 3, 12 lateral
  frames, 320x240, 500 features, 4 levels, map 24 x 4096 x 8,
  ``fuse_neighbors=4``, ``triangulate_neighbors=4``): it inserts keyframes at
  frames 0, 4, 6, 8 and 11, so triangulation, both fuse directions, three
  local BAs and the keyframe-culling evaluation all run.  Asserted: lost 0
  on both and ATE < 0.02 m on the port; n_kf and the keyframe frame ids
  equal; n_pt within 1%; per-frame poses within 1 mm and 0.1 degree; both
  descriptor searches of every mapped keyframe through
  ``cuda_hamming.hamming_best2``; the exports readable.
- LOST: a blank frame after 6 tracked ones is lost, the next frame resets
  the system (n_kf <= 5) and the one after initializes it again.
- Fallback: the camera turns 0.15 rad between two frames, the motion model
  fails and TrackReferenceKeyFrame carries the frames.
- Loop closing is off here; ``test_torch_lost_fallback.py`` runs the
  scenario with it on, past 12 keyframes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.geometry import se3 as jse3
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld, ate_rmse
from refactored_orb_slam2_tpu_torch import system as tsystem
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam

# One intra-op thread: at these sizes PyTorch's threads gain nothing, and
# several test workers with a thread per core each spin against one another.
# Every file that runs the port's whole system sets it, so the setting holds
# whichever files a run selects.
torch.set_num_threads(1)

CFG = SystemConfig(
    sensor="rgbd",
    camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                        width=320, height=240, fps=10),
    orb=ORBConfig(n_features=500, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8,
                  fuse_neighbors=4, triangulate_neighbors=4),
)
TCFG = config_from_reference(CFG)        # the port's own config tree
WORLD = dict(seed=3, n_points=500, x_range=(-6, 6), y_range=(-2.5, 2.5),
             z_range=(2.5, 10.0), clear_tube=0.0)


def lateral_traj(n, step=0.06):
    motion = np.asarray(jse3.exp(jnp.asarray([step, 0, 0, 0, 0, 0], jnp.float32)))
    out = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        out.append(motion @ out[-1])
    return np.stack(out)


def gt_centers(traj):
    return np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in traj])


def render(traj, blank=()):
    """Host frames (image, metric depth) of the scenario; frames in
    ``blank`` are a flat grey image at 2 m."""
    world = SyntheticWorld.create(**WORLD)
    cam = TSlam(TCFG, device="cpu").cam
    rng = np.random.default_rng(1)
    frames = []
    for i, T in enumerate(traj):
        img, depth = world.render(T, cam, noise=2.0, rng=rng), world.render_depth(T, cam)
        if i in blank:
            img, depth = np.full_like(img, 128.0), np.full_like(depth, 2.0)
        frames.append((img, depth))
    return frames


def run_both(frames):
    out = {}
    for name in ("jax", "port"):
        slam = JSlam(CFG) if name == "jax" else TSlam(TCFG, device="cpu")
        slam.loop_closing_enabled = False
        returned = [slam.track_rgbd(img, depth, i * 0.1)
                    for i, (img, depth) in enumerate(frames)]
        out[name] = (slam, returned)
    return out


def assert_poses_close(a, b):
    """Within 1 mm and 0.1 degree, frame by frame."""
    assert a.shape == b.shape and np.isfinite(a).all()
    for x, y in zip(a, b):
        d = x @ np.linalg.inv(y)
        angle = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        assert angle < 0.1
        np.testing.assert_allclose(x[:3, 3], y[:3, 3], atol=1e-3)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    traj = lateral_traj(12)
    frames = render(traj)
    # per mapped keyframe of the port: masked-kernel calls, points
    # triangulated, local BAs
    calls, per_kf, tri, ba = [0], [], [], []
    best2, steps = cuda_hamming.hamming_best2, tsystem.SlamSystem._mapping_core
    triangulate, local_ba = (tsystem.LM.triangulate_with_neighbors,
                             tsystem.SlamSystem._windowed_ba_steps)

    def counted_best2(*a, **k):
        calls[0] += 1
        return best2(*a, **k)

    def counted_steps(self, kf_slot):
        before = calls[0]
        steps(self, kf_slot)
        per_kf.append((kf_slot, calls[0] - before))

    def counted_triangulate(*a, **k):
        state, n_new = triangulate(*a, **k)
        tri.append(int(n_new))
        return state, n_new

    def counted_ba(self, *a, **k):
        ba.append(self.n_kf)
        yield from local_ba(self, *a, **k)

    cuda_hamming.hamming_best2 = counted_best2
    tsystem.SlamSystem._mapping_core = counted_steps
    tsystem.LM.triangulate_with_neighbors = counted_triangulate
    tsystem.SlamSystem._windowed_ba_steps = counted_ba
    try:
        out = run_both(frames)
    finally:
        cuda_hamming.hamming_best2 = best2
        tsystem.SlamSystem._mapping_core = steps
        tsystem.LM.triangulate_with_neighbors = triangulate
        tsystem.SlamSystem._windowed_ba_steps = local_ba
    paths = {}
    for name, (slam, _) in out.items():
        d = tmp_path_factory.mktemp(name)
        paths[name] = (d / "traj.txt", d / "kf.txt", d / "kitti.txt")
        slam.export_trajectory_tum(str(paths[name][0]))
        slam.export_keyframe_trajectory_tum(str(paths[name][1]))
        slam.export_trajectory_kitti(str(paths[name][2]))
    return traj, out, dict(per_kf=per_kf, tri=tri, ba=ba), paths


def test_sequence_tracks_every_frame_with_small_ate(sequence):
    traj, out, _, _ = sequence
    for name, (slam, returned) in out.items():
        assert all(r is not None for r in returned), name
        assert len(slam.tracked_logs()) == len(traj)
    port = out["port"][0]
    assert ate_rmse(port.camera_centers(), gt_centers(traj)) < 0.02


def test_sequence_keyframes_and_points_match(sequence):
    _, out, _, _ = sequence
    j, t = out["jax"][0], out["port"][0]
    assert t.n_kf == j.n_kf >= 5          # local BA runs from the third keyframe
    np.testing.assert_array_equal(t.map.kf_frame_id[:t.n_kf].numpy(),
                                  np.asarray(j.map.kf_frame_id)[:j.n_kf])
    np.testing.assert_array_equal(t.map.kf_valid.numpy(), np.asarray(j.map.kf_valid))
    assert abs(t.n_pt - j.n_pt) <= 0.01 * j.n_pt
    assert t.culled_chain.keys() == j.culled_chain.keys()
    assert t.stats["motion_tracks"] == j.stats["motion_tracks"]


def test_sequence_poses_within_1mm_and_0p1deg(sequence):
    _, out, _, _ = sequence
    j, t = out["jax"][0], out["port"][0]
    assert_poses_close(t.frame_poses(), j.frame_poses())
    # the poses track_rgbd returned, before any later BA moved them
    assert_poses_close(np.stack(out["port"][1]), np.stack(out["jax"][1]))
    np.testing.assert_allclose(t.map.kf_pose.numpy(), np.asarray(j.map.kf_pose), atol=1e-3)


def test_every_mapped_keyframe_uses_the_masked_matcher(sequence):
    """Each mapped keyframe triangulates against at least one neighbour and
    fuses in both directions, all through the masked best-2 wrapper; every
    triangulation created points, and local BA ran from the third
    keyframe on."""
    _, out, mapped, _ = sequence
    t = out["port"][0]
    per_kf = mapped["per_kf"]
    assert [kf for kf, _ in per_kf] == list(range(1, t.n_kf))
    assert all(n >= 3 for _, n in per_kf), per_kf
    assert len(mapped["tri"]) == t.n_kf - 1 and min(mapped["tri"]) > 0
    assert mapped["ba"] == list(range(3, t.n_kf + 1))


def test_exports_readable_and_equal(sequence):
    traj, _, _, paths = sequence
    (tj, kj, xj), (tt, kt, xt) = paths["jax"], paths["port"]
    a, b = np.loadtxt(tt), np.loadtxt(tj)
    assert a.shape == (len(traj), 8)
    np.testing.assert_allclose(a[:, :4], b[:, :4], atol=1e-3)
    a, b = np.loadtxt(kt), np.loadtxt(kj)
    assert a.shape == b.shape == (5, 8)
    np.testing.assert_allclose(a[:, :4], b[:, :4], atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(a[:, 4:], axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.loadtxt(xt), np.loadtxt(xj), atol=1e-3)
