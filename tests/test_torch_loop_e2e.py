"""The port's counterpart of ``tests/test_loop_e2e.py`` (marked slow: tens
of minutes each on the CPU): the street circuit through the port's whole
``SlamSystem`` on the CPU, rendered with the true camera by the port's
renderer and tracked with the +4 px miscalibrated one, loop closing on.

- Stereo (``make_cfg`` of the JAX test, map 160 x 24576 x 12): at most 2
  frames lost, a loop edge, a global BA, ATE under 1% of the path, as the
  JAX test asserts.
- Monocular (150 frames, map 160 x 16384 x 12): the JAX test's scale-drift
  measure before and after the correction, on the JAX package and on the
  port given the JAX package's minimal sets (the initializer's and the Sim3
  RANSAC's), over the same frames.  The JAX package's correction makes the
  drift worse on its own test (0.0733 -> 0.1392, VERDICT.md, "What's
  weak" 1), which therefore fails; the port is held to the JAX package, not
  to a smaller drift: tracking OK at the end, at most 12 frames lost, a loop
  closed and a GBA run, drift before the correction > 0.01, the applied
  s_cm within 5% of JAX's, each drift within 25% (+ 0.01) of JAX's, and the
  Sim3-aligned keyframe ATE under 2% of the path.  Measured on these frames:
  JAX 0.1148 -> 0.0216 with s_cm 1.185 (its correction shrinks the drift
  here), the port 0.1006 -> 0.0081 with s_cm 1.140; the two runs part ways
  (130 and 116 keyframes) even with the same minimal sets.
"""

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.system import SlamSystem, TrackState
from refactored_orb_slam2_tpu_torch.utils import world3d as W
from test_loop_e2e import BLOCK, ROAD_W, _windowed_scale_drift, make_cfg

import chip_smoke

torch.set_num_threads(1)


def _true_camera():
    from refactored_orb_slam2_tpu_torch.config import CameraConfig

    return camera_from_config(CameraConfig(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=120.0,
                                           width=320, height=240))


def _centres(poses):
    return np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses])


@pytest.mark.slow
def test_street_circuit_closes_loop():
    slam = SlamSystem(config_from_reference(make_cfg()), device="cpu")
    world, cam = W.scene_street(seed=41, block=BLOCK, road_w=ROAD_W), _true_camera()
    poses = W.traj_street_loop(140, block=BLOCK, road_w=ROAD_W, seed=41, laps=140 / 110.0)
    rng = np.random.default_rng(6)
    lost = sum(slam.track_stereo(*world.render_stereo(T, cam, noise=2.0, rng=rng), i * 0.1)
               is None for i, T in enumerate(poses))
    gt = _centres(poses)
    ate = chip_smoke.ate_rmse_se3(slam.camera_centers(), gt[slam.tracked_frame_ids()])
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    edges = slam.map.kf_loop_edges.numpy()
    print(f"\nport on the CPU, stereo circuit: lost {lost}, n_kf {slam.n_kf}, loop edges at "
          f"{np.argwhere(edges >= 0).tolist()}, paths {slam.stats}, ATE {ate:.4f} m over "
          f"{path:.1f} m")
    assert lost <= 2
    assert (edges >= 0).any(), "no loop edge was ever added"
    assert slam.stats["gba_runs"] >= 1
    assert ate < 0.01 * path


def _mono_run(slam, frames, gt_all):
    """Track the monocular circuit; returns the loop-closure record: frames
    lost, the scale drift before and after the first correction, the
    applied s_cm, the Sim3-aligned keyframe ATE and the loop edges."""
    pre, correct = {}, slam._correct_loop

    def snapping(kf_cur, kf_loop, R_cm, t_cm, s_cm):
        if not pre:
            m = slam.map
            pre.update(kf_pose=np.array(m.kf_pose), kf_valid=np.array(m.kf_valid),
                       kf_fid=np.array(m.kf_frame_id), s_cm=float(s_cm))
        return correct(kf_cur, kf_loop, R_cm, t_cm, s_cm)

    slam._correct_loop = snapping
    lost = sum(slam.track_monocular(img, i * 0.1) is None for i, img in enumerate(frames))

    def kf_centres(kf_pose, kf_valid, kf_fid):
        sel = np.where(kf_valid)[0]
        sel = sel[np.argsort(kf_fid[sel])]
        cs = np.stack([-(kf_pose[k][:3, :3].T @ kf_pose[k][:3, 3]) for k in sel])
        # the JAX test's frame-id convention
        return cs, gt_all[np.clip(kf_fid[sel] - 1, 0, len(gt_all) - 1)]

    m = slam.map
    post = kf_centres(np.array(m.kf_pose), np.array(m.kf_valid), np.array(m.kf_frame_id))
    edges = np.array(m.kf_loop_edges)
    return dict(
        lost=lost, state=slam.state, n_kf=slam.n_kf, gba_runs=slam.stats["gba_runs"],
        loops=sorted({tuple(sorted((k, int(x)))) for k in range(edges.shape[0])
                      for x in edges[k] if x >= 0}),
        s_cm=pre.get("s_cm"), ate=chip_smoke.ate_rmse_sim3(*post),
        drift=None if not pre else (
            _windowed_scale_drift(*kf_centres(pre["kf_pose"], pre["kf_valid"], pre["kf_fid"])),
            _windowed_scale_drift(*post)))


@pytest.mark.slow
def test_mono_circuit_scale_drift_as_jax():
    from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
    from refactored_orb_slam2_tpu.utils.config import MapConfig as JMapConfig
    from refactored_orb_slam2_tpu_torch.solvers import horn_sim3, initializer
    from test_torch_initializer import jax_sets
    from test_torch_pose_graph import jax_sim3_sets

    import jax

    jcfg = make_cfg()
    jcfg = jcfg.replace(sensor="monocular", map=JMapConfig(
        max_keyframes=160, max_points=16384, max_obs_per_point=12, fuse_neighbors=4,
        triangulate_neighbors=4))
    world, cam = W.scene_street(seed=41, block=BLOCK, road_w=ROAD_W), _true_camera()
    n_frames = 150
    poses = W.traj_street_loop(n_frames, block=BLOCK, road_w=ROAD_W, seed=41,
                               laps=n_frames / 110.0)
    rng = np.random.default_rng(6)
    frames = [world.render(T, cam, noise=2.0, rng=rng) for T in poses]
    gt_all = _centres(poses)

    out = {"jax": _mono_run(JSlam(jcfg), frames, gt_all)}
    # the port with the JAX package's minimal sets: the initializer's and
    # the Sim3 RANSAC's, both seeded with the frame id
    draw_init, draw_sim3 = initializer.draw_minimal_sets, horn_sim3.draw_sim3_sets
    initializer.draw_minimal_sets = lambda valid, n_hyps, gen: torch.from_numpy(
        jax_sets(valid.numpy(), gen.initial_seed()))
    horn_sim3.draw_sim3_sets = lambda valid, gen, n_hyps=128: jax_sim3_sets(
        valid.numpy(), jax.random.PRNGKey(gen.initial_seed()), n_hyps)
    try:
        out["port"] = _mono_run(SlamSystem(config_from_reference(jcfg), device="cpu"), frames,
                                gt_all)
    finally:
        initializer.draw_minimal_sets, horn_sim3.draw_sim3_sets = draw_init, draw_sim3
    path = float(np.linalg.norm(np.diff(gt_all, axis=0), axis=1).sum())
    for name, r in out.items():
        print(f"\n{name} on the CPU, monocular circuit: {r}, path {path:.1f} m")
    j, t = out["jax"], out["port"]
    assert t["state"] == TrackState.OK and t["lost"] <= 12
    assert t["loops"] and t["gba_runs"] >= 1 and t["drift"] is not None
    assert t["drift"][0] > 0.01
    assert t["ate"] < 0.02 * path
    # held to the JAX package's correction, whichever way it moves the drift
    assert abs(t["s_cm"] - j["s_cm"]) <= 0.05 * j["s_cm"]
    for a, b in zip(t["drift"], j["drift"]):
        assert abs(a - b) <= 0.25 * b + 0.01
