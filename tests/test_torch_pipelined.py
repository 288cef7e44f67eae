"""Pipelined dispatch and cooperative mapping, on the CPU, on the
``tests/test_torch_sequence.py`` RGB-D scenario (12 lateral frames, 320x240,
500 features, 4 levels, map 24 x 4096 x 8; loop closing off, as there).

- ``pipelined=True, pipeline_depth=1`` against the port's synchronous mode
  (the pipeline at depth 0) on RGB-D, stereo and monocular: the poses each
  call returned and the trajectory bit for bit, the same n_kf, keyframe
  frames and n_pt, and every map bank torch.equal (the JAX docstring's
  "bit-identical to sync mode"), the keyframes' frame ids aside (a
  pipelined commit stamps its keyframe with the id of the call's frame, as
  the JAX package does); and with a blank frame that loses the tracker and
  a relocalization after it.
- The JAX bench's mode, ``cooperative_mapping=True, pipelined=True,
  pipeline_depth=3``, on both packages: n_kf and the keyframe frames equal,
  n_pt within 1%, the per-frame poses each call returned within 1 mm and
  0.1 degree (the logged trajectory of the port has an error under JAX's,
  whose logging of this mode is at fault: ROADMAP.md), the same
  mapping backlog and ``abort_ba`` after every frame, and the same number of
  ``_pump_mapping`` steps per keyframe (a wrapper generator around
  ``_coop_steps`` counts them on both).
- A blank frame in the middle of a depth-3 pipeline: the same frames lost on
  both packages, and the frames that were in flight behind it reprocessed
  through the decomposed path ``_track`` with their own frame ids.
- ``wait_mapping_idle`` and ``shutdown`` drain the cooperative pipeline.
- The stereo and monocular scenarios in the JAX bench's mode, through
  ``track_stereo_device`` and ``track_monocular_device``.
- The graph-safe fused step, with explicit velocity, ``have_vel``,
  ``ref_kf`` and ``min_obs`` tensors, equals its old form (Python reference
  keyframe, ``velocity is None`` branch) exactly and JAX's
  ``_jit_fused_track`` on the same inputs (scalars and associations equal,
  the counters the commit applies equal to the ones JAX's step returns,
  poses within 1e-4).

The card's side (the graph replay equal to the eager step, one capture per
system and sensor, the launches of every replay) is in
``tests/test_torch_cuda.py``, which imports no JAX and so runs where the
card is.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import keyframe_frames
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.synthetic import ate_rmse
from refactored_orb_slam2_tpu_torch import system as tsystem
from refactored_orb_slam2_tpu_torch.backend import local_mapping as LM
from refactored_orb_slam2_tpu_torch.frontend.fused_graph import flat_tensors
from refactored_orb_slam2_tpu_torch.geometry import se3
from refactored_orb_slam2_tpu_torch.models import map_ops
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam
from test_torch_sequence import (
    CFG, TCFG, assert_poses_close, gt_centers, lateral_traj, render,
)

torch.set_num_threads(1)

COOP = dict(cooperative_mapping=True, pipelined=True, pipeline_depth=3)


@pytest.fixture(scope="module")
def frames():
    return render(lateral_traj(12))


def observed_run(slam, frames):
    """Track every frame, commit the frames in flight and drain the
    mapping; returns what each call
    returned, the (backlog, abort_ba) after each call and the pump steps
    per keyframe."""
    steps_per_kf = []
    inner = slam._coop_steps

    def counted(kf_slot):
        n = 0
        for _ in inner(kf_slot):
            n += 1
            yield
        steps_per_kf.append((kf_slot, n))

    slam._coop_steps = counted
    returned, after = [], []
    for i, (img, depth) in enumerate(frames):
        returned.append(slam.track_rgbd(img, depth, i * 0.1))
        after.append((slam._coop_backlog(), bool(slam.abort_ba)))
    slam.flush_pipeline()
    assert slam.wait_mapping_idle(timeout=60)
    return returned, after, steps_per_kf


def _system(package, tcfg=TCFG, **kw):
    slam = JSlam(CFG, **kw) if package == "jax" else TSlam(tcfg, device="cpu", **kw)
    slam.loop_closing_enabled = False
    return slam


def _sensor_scenario(sensor):
    """The stereo or monocular scenario of ``test_torch_stereo_sequence.py``
    and ``test_torch_mono_sequence.py``: (the port's config, the trajectory,
    the frames encoded for ``track_stereo_device`` or
    ``track_monocular_device``)."""
    from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
    import test_torch_mono_sequence as mono
    import test_torch_stereo_sequence as stereo

    tcfg, seed, n, noise_seed = ((stereo.TCFG, 4, 10, 2) if sensor == "stereo"
                                 else (mono.TCFG, 7, 14, 5))
    world = SyntheticWorld.create(seed=seed, n_points=500, x_range=(-6, 6), y_range=(-2.5, 2.5),
                                  z_range=(2.5, 10.0), clear_tube=0.0)
    traj = lateral_traj(n, step=0.06)
    cam = TSlam(tcfg, device="cpu").cam
    rng = np.random.default_rng(noise_seed)
    enc = lambda a: torch.from_numpy(tsystem._encode_img(a))
    if sensor == "stereo":
        frames = [tuple(map(enc, world.render_stereo(T, cam, noise=2.0, rng=rng))) for T in traj]
    else:
        frames = [(enc(world.render(T, cam, noise=2.0, rng=rng)),) for T in traj]
    return tcfg, traj, frames


def _feed(slam, frames):
    """What each call of the sensor's entry point returned, the frames fed
    in order (RGB-D as host frames, the others on the device)."""
    entry = {"rgbd": slam.track_rgbd, "stereo": slam.track_stereo_device,
             "monocular": slam.track_monocular_device}[slam.sensor]
    return [entry(*f, i * 0.1) for i, f in enumerate(frames)]


def _assert_maps_equal(pipe, sync):
    """Every bank torch.equal but the keyframes' frame ids: a pipelined
    commit runs in a later frame's call and stamps its keyframe with that
    frame's id, as the JAX package does (the frame that made each keyframe
    is compared through the logs, ``keyframe_frames``)."""
    for f in dataclasses.fields(sync):
        a, b = getattr(pipe, f.name), getattr(sync, f.name)
        if f.name == "kf_frame_id":
            assert bool(((a == b) | (a == b + 1)).all()), (a, b)
        else:
            assert torch.equal(a, b), f.name


@pytest.mark.parametrize("sensor", ["rgbd", "stereo", "monocular"])
def test_pipelined_depth_1_equals_sync(frames, sensor):
    tcfg, seq = (TCFG, frames) if sensor == "rgbd" else _sensor_scenario(sensor)[::2]
    sync = _system("port", tcfg)
    pipe = _system("port", tcfg, pipelined=True, pipeline_depth=1)
    out = {name: _feed(slam, seq) for name, slam in (("sync", sync), ("pipe", pipe))}
    # the pipelined mode returns each pose as a tensor at its dispatch
    first = next(i for i, p in enumerate(out["sync"]) if p is not None)
    assert all(isinstance(p, torch.Tensor) for p in out["pipe"][first + 1:])
    for a, b in zip(out["sync"], out["pipe"]):
        assert (a is None and b is None) or torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert np.array_equal(sync.frame_poses(), pipe.frame_poses())
    assert pipe.n_kf == sync.n_kf >= (5 if sensor == "rgbd" else 3) and pipe.n_pt == sync.n_pt
    assert keyframe_frames(pipe) == keyframe_frames(sync)
    _assert_maps_equal(pipe.map, sync.map)
    assert not pipe._inflight


@pytest.fixture(scope="module")
def coop(frames):
    out = {}
    for package in ("jax", "port"):
        slam = _system(package, **COOP)
        out[package] = (slam, *observed_run(slam, frames))
    return out


def test_coop_depth_3_keyframes_as_jax(coop):
    j, t = coop["jax"][0], coop["port"][0]
    assert t.n_kf == j.n_kf >= 3
    np.testing.assert_array_equal(t.map.kf_frame_id[:t.n_kf].numpy(),
                                  np.asarray(j.map.kf_frame_id)[:j.n_kf])
    assert keyframe_frames(t) == keyframe_frames(j)
    assert abs(t.n_pt - j.n_pt) <= 0.01 * j.n_pt
    assert t.culled_chain.keys() == j.culled_chain.keys()


def test_coop_depth_3_poses_as_jax(coop, frames):
    """What each call returned (the frame's tracked pose) within 1 mm and
    0.1 degree of the JAX package's, and the keyframe poses within 1 mm.
    The logged trajectories are not compared frame by frame: in this mode
    the JAX package logs a frame that makes a keyframe with the newest
    dispatched frame's pose, and a frame dispatched before a younger
    keyframe against that keyframe (ROADMAP.md, faults in the reference);
    the port logs each frame's own pose against its own reference, so its
    trajectory error stays under JAX's."""
    (j, jr, _, _), (t, tr, _, _) = coop["jax"], coop["port"]
    assert len(t.tracked_logs()) == len(j.tracked_logs()) == 12
    assert_poses_close(np.stack([np.asarray(p) for p in tr]), np.stack([np.asarray(p) for p in jr]))
    np.testing.assert_allclose(t.map.kf_pose.numpy(), np.asarray(j.map.kf_pose), atol=1e-3)
    gt = gt_centers(lateral_traj(len(frames)))
    ate_t, ate_j = (ate_rmse(s.camera_centers(), gt) for s in (t, j))
    assert ate_t < 0.02 and ate_t <= ate_j


def test_coop_depth_3_backlog_and_abort_as_jax(coop):
    (_, _, ja, _), (_, _, ta, _) = coop["jax"], coop["port"]
    assert ta == ja
    assert max(b for b, _ in ta) >= 1          # mapping ran behind the frames


def test_coop_depth_3_pump_steps_per_keyframe_as_jax(coop):
    (j, _, _, js), (t, _, _, ts) = coop["jax"], coop["port"]
    assert ts == js
    assert [k for k, _ in ts] == list(range(1, t.n_kf))


def test_blank_frame_in_depth_3_pipeline(frames):
    """Frame 7 blank: its commit, three calls later, loses it.  The frames in
    flight behind it then go through the decomposed path ``_track`` with
    their own frame ids: frame 8 finds the system lost with 4 keyframes and
    resets it (Tracking.cc:421-428), which drops frame 9, and the call's own
    frame 10 initializes a new map; alike on both packages."""
    blank = list(frames)
    blank[7] = (np.full_like(frames[7][0], 128.0), np.full_like(frames[7][1], 2.0))
    out = {}
    for package in ("jax", "port"):
        slam = _system(package, **COOP)
        decomposed, lost, track, log = [], [], slam._track, slam._log_frame

        def tracked(frame, timestamp, slam=slam, inner=track, seen=decomposed):
            seen.append((slam.frame_id, slam.state, slam.n_kf))
            return inner(frame, timestamp)

        def logged(timestamp, lost, slam=slam, inner=log, seen=lost, **kw):
            if lost:
                seen.append(slam.frame_id if kw.get("frame_id") is None else kw["frame_id"])
            return inner(timestamp, lost, **kw)

        slam._track, slam._log_frame = tracked, logged
        for i, (img, depth) in enumerate(blank):
            slam.track_rgbd(img, depth, i * 0.1)
        out[package] = (decomposed, lost, slam.tracked_frame_ids().tolist(), slam.n_kf)
    assert out["port"] == out["jax"]
    decomposed, lost, tracked_ids, n_kf = out["port"]
    assert lost == [7]
    lost_state = tsystem.TrackState.LOST
    assert [fid for fid, state, _ in decomposed if state == lost_state] == [8]
    assert decomposed[-1][0] == 10 and tracked_ids == [10, 11] and n_kf >= 1


def _watched_run(slam, frames):
    """Track ``frames`` through ``track_rgbd``; returns the decomposed
    ``_track`` calls (frame id, state, n_kf at the call), the frames logged
    lost and the tracked frame ids once the frames in flight are committed."""
    decomposed, lost, track, log = [], [], slam._track, slam._log_frame

    def tracked(frame, timestamp):
        decomposed.append((slam.frame_id, slam.state, slam.n_kf))
        return track(frame, timestamp)

    def logged(timestamp, **kw):
        if kw["lost"]:
            lost.append(slam.frame_id if kw.get("frame_id") is None else kw["frame_id"])
        return log(timestamp, **kw)

    slam._track, slam._log_frame = tracked, logged
    for i, (img, depth) in enumerate(frames):
        slam.track_rgbd(img, depth, i * 0.1)
    return decomposed, lost, slam.tracked_frame_ids().tolist()


# the later blank frame: the tests/test_torch_reloc.py scenario (8 cm
# steps, a keyframe every frame or two), whose system holds more than 5
# keyframes at frame 12, so that a loss there relocalizes instead of
# resetting
LATE_BLANK, N_LATE = 12, 20


def _late_blank_frames():
    from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
    from test_torch_reloc import TCFG as RTCFG, WORLD as RWORLD, lateral

    world = SyntheticWorld.create(**RWORLD)
    cam = TSlam(RTCFG, device="cpu").cam
    rng = np.random.default_rng(9)
    frames = []
    for i, T in enumerate(lateral(N_LATE)):
        img, depth = world.render(T, cam, noise=2.0, rng=rng), world.render_depth(T, cam)
        if i == LATE_BLANK:
            img, depth = np.full_like(img, 128.0), np.full_like(depth, 2.0)
        frames.append((img, depth))
    return frames


def test_later_blank_frame_in_depth_3_pipeline_relocalizes():
    """Frame 12 blank: its commit at frame 15's call loses it, and frame 13,
    in flight behind it, finds the system lost with more than 5 keyframes
    and relocalizes (Tracking.cc:421-428 resets only a younger map).  The
    state is OK again when the flush reaches frame 14, so its record is
    committed as it was dispatched (ROADMAP.md, faults in the reference),
    frame 15, the call's own, takes the decomposed path, and frame 16 is a
    fused one again.  Alike on both packages, the port with the JAX
    package's EPnP sets."""
    from test_torch_epnp import jax_sets_injected
    from test_torch_reloc import CFG as RCFG, TCFG as RTCFG

    frames = _late_blank_frames()
    out = {}
    for package in ("jax", "port"):
        slam = JSlam(RCFG, **COOP) if package == "jax" else TSlam(RTCFG, device="cpu", **COOP)
        slam.loop_closing_enabled = False
        with jax_sets_injected():
            decomposed, lost, tracked_ids = _watched_run(slam, frames)
        out[package] = (decomposed, lost, tracked_ids, slam.stats["relocs"],
                        slam.stats["reloc_rejects"])
    assert out["port"] == out["jax"]
    decomposed, lost, tracked_ids, relocs, rejects = out["port"]
    assert lost == [LATE_BLANK] and relocs == 1 and rejects == 0
    lost_state = tsystem.TrackState.LOST
    assert [fid for fid, state, n_kf in decomposed if state == lost_state] == [LATE_BLANK + 1]
    # frame 0 initialized the map
    assert [fid for fid, _, _ in decomposed] == [0, LATE_BLANK + 1, LATE_BLANK + 3]
    assert min(n_kf for _, _, n_kf in decomposed[1:]) > 5
    assert tracked_ids == [i for i in range(N_LATE) if i != LATE_BLANK]


def test_later_blank_frame_sync_equals_depth_1():
    """Frame 12 blank in synchronous mode and at depth 1: the same frames
    lost and the same relocalization, the same logs (the lost frame's pose
    is the tracker's after the rollback of its commit) and the same map."""
    from test_torch_reloc import TCFG as RTCFG

    frames = _late_blank_frames()
    out = {}
    for name, kw in (("sync", {}), ("pipe", dict(pipelined=True, pipeline_depth=1))):
        slam = _system("port", RTCFG, **kw)
        out[name] = (slam, _watched_run(slam, frames))
    (sync, watched), (pipe, watched_pipe) = out["sync"], out["pipe"]
    assert watched_pipe == watched and watched[1] == [LATE_BLANK]
    assert pipe.stats == sync.stats and sync.stats["relocs"] == 1
    assert len(pipe.trajectory) == len(sync.trajectory) == N_LATE
    for a, b in zip(pipe.trajectory, sync.trajectory):
        assert (a.frame_id, a.ref_kf, a.lost) == (b.frame_id, b.ref_kf, b.lost)
        assert np.array_equal(a.Tcr, b.Tcr)
    _assert_maps_equal(pipe.map, sync.map)


def test_wait_mapping_idle_and_shutdown_drain(frames):
    slam = _system("port", **COOP)
    for i, (img, depth) in enumerate(frames[:9]):
        slam.track_rgbd(img, depth, i * 0.1)
    assert slam._inflight and slam._coop_busy()
    n_kf = slam.n_kf
    assert slam.wait_mapping_idle(timeout=60)
    assert not slam._coop_busy() and slam.n_kf == n_kf
    for i, (img, depth) in enumerate(frames[9:], start=9):
        slam.track_rgbd(img, depth, i * 0.1)
    slam.shutdown()
    assert not slam._inflight and not slam._coop_busy() and slam.abort_ba in (False, True)
    assert len(slam.trajectory) == len(frames) and not any(log.lost for log in slam.trajectory)


@pytest.mark.parametrize("sensor", ["stereo", "monocular"])
def test_bench_mode_on_every_sensor(sensor):
    """The stereo and monocular scenarios of ``test_torch_stereo_sequence.py``
    and ``test_torch_mono_sequence.py`` through ``track_*_device`` in the
    JAX bench's mode: every frame from the first tracked one tracked, the
    mapping drained, the trajectory right."""
    import test_torch_mono_sequence as mono

    tcfg, traj, frames = _sensor_scenario(sensor)
    n = len(traj)
    slam = _system("port", tcfg, **COOP)
    out = _feed(slam, frames)
    slam.flush_pipeline()
    assert slam.wait_mapping_idle(timeout=60) and not slam._inflight
    first = next(i for i, p in enumerate(out) if p is not None)
    tracked = slam.tracked_frame_ids().tolist()
    assert tracked == list(range(first, n)) and slam.n_kf >= 3
    centres = slam.camera_centers()
    gt = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in traj])[tracked]
    if sensor == "stereo":
        assert np.sqrt(np.mean(np.sum((centres - gt) ** 2, axis=1))) < 0.02
    else:
        assert mono._ate(slam, traj) < mono.ATE_BOUND_M


# ------------------------------------------------------------------ the step
def _old_step(slam, raw_a, raw_b):
    """The fused step as it read the tracker before it was made graph-safe:
    the velocity's ``None`` branch in Python, the reference keyframe and the
    observation bar as Python ints."""
    from refactored_orb_slam2_tpu_torch.frontend import tracking_kernels as TK
    from refactored_orb_slam2_tpu_torch.optim.pose_opt import optimize_pose

    cam, cfg, m = slam.cam, slam.cfg, slam.map
    P, n_levels = m.pt_pos.shape[0], cfg.orb.n_levels
    frame, last = slam._build_frame(raw_a, raw_b), slam.last_frame
    pose0 = slam.velocity @ slam.last_pose if slam.velocity is not None else slam.last_pose

    def motion(win):
        return TK.match_motion_model(cam, pose0, frame, slam.last_pt_idx, last.octave,
                                     m.pt_pos, m.pt_valid, m.pt_desc, last.angle, th=win,
                                     scale_factors=slam.scale_factors, nn_max_dist=75)

    th = slam._motion_window
    r1, rw = motion(th), motion(2 * th)
    retry = r1.n_matches < 20
    pt_idx = torch.where(retry, rw.pt_idx, r1.pt_idx)
    n_m = torch.where(retry, rw.n_matches, r1.n_matches)
    inv_s2 = slam.inv_sigma2_table[torch.clamp(frame.octave, 0, n_levels - 1).long()]
    is_st = frame.uvr[:, 2] >= 0
    o1 = optimize_pose(cam, slam.last_pose, m.pt_pos[torch.clamp(pt_idx, min=0).long()],
                       frame.uvr, inv_s2, pt_idx >= 0, is_st)
    pt1 = torch.where(o1.inlier, pt_idx, -1)
    already = map_ops.set_rows(torch.zeros(P, dtype=torch.bool), torch.where(pt1 >= 0, pt1, P),
                               True)
    local = TK.select_local_points(cam, o1.Tcw, m.pt_pos, m.pt_valid, m.pt_normal,
                                   m.pt_min_dist, m.pt_max_dist, already, budget=4096,
                                   scale_factor=cfg.orb.scale_factor, n_levels=n_levels)
    r2 = TK.match_local_points(frame, local, m.pt_desc, pt1, th=1.0,
                               scale_factors=slam.scale_factors)
    o2 = optimize_pose(cam, o1.Tcw, m.pt_pos[torch.clamp(r2.pt_idx, min=0).long()],
                       frame.uvr, inv_s2, r2.pt_idx >= 0, is_st)
    pt2 = torch.where(o2.inlier, r2.pt_idx, -1)
    close = (frame.depth > 0) & (frame.depth < slam.th_depth_m) & frame.valid
    min_obs = 3 if slam.n_kf > 2 else 2
    n_obs = (m.pt_obs_kf >= 0).sum(dim=1, dtype=torch.int32)
    ref_pt = m.kf_point_idx[slam.ref_kf]
    rp = torch.clamp(ref_pt, min=0).long()
    ref_has = ((ref_pt >= 0) & m.kf_feat_valid[slam.ref_kf] & m.pt_valid[rp]
               & (n_obs[rp] >= min_obs))
    sc = torch.stack([n_m, o1.n_inliers, o2.n_inliers,
                      (close & (pt2 >= 0)).sum(dtype=torch.int32),
                      (close & (pt2 < 0)).sum(dtype=torch.int32),
                      ref_has.sum(dtype=torch.int32)]).to(torch.int32)
    Tcr = o2.Tcw @ se3.inv(m.kf_pose[slam.ref_kf])
    return frame, torch.stack([o2.Tcw, Tcr]), pt2, local.idx, sc


@pytest.fixture(scope="module")
def lockstep(frames):
    """Both packages in synchronous mode over frames 0-5 (keyframes at 0 and
    4: the reference keyframe moved), then frame 6's raw inputs."""
    j, t = _system("jax"), _system("port")
    for i, (img, depth) in enumerate(frames[:6]):
        j.track_rgbd(img, depth, i * 0.1)
        t.track_rgbd(img, depth, i * 0.1)
    assert j.n_kf == t.n_kf == 2 and j.ref_kf == t.ref_kf == 1
    img, depth = frames[6]
    raw = (tsystem._encode_img(img), tsystem._encode_depth(depth))
    return j, t, raw


CASES = {"as tracked": {}, "no velocity": dict(velocity=None),
         "keyframe 0, bar 3": dict(ref_kf=0, n_kf=3)}


@pytest.mark.parametrize("case", list(CASES))
def test_graph_safe_step_equals_old_form_and_jax(lockstep, case):
    j, t, raw = lockstep
    saved = [(s, k, getattr(s, k)) for s in (j, t) for k in CASES[case]]
    try:
        for s in (j, t):
            for k, v in CASES[case].items():
                setattr(s, k, v)
        _compare_steps(j, t, *raw)
    finally:
        for s, k, v in saved:
            setattr(s, k, v)


def _compare_steps(j, t, img_u8, depth_u16):
    raw = (torch.from_numpy(img_u8), torch.from_numpy(depth_u16))
    new = t._fused_step(**t._fused_inputs(*raw))
    old = _old_step(t, *raw)
    for a, b in zip(flat_tensors(new), flat_tensors(old)):
        assert torch.equal(a, b)

    m, last = j.map, j.last_frame
    have_vel = j.velocity is not None
    jout = j._jit_fused_track(
        jnp.asarray(img_u8), jnp.asarray(depth_u16), last.xy, j.last_pt_idx, last.octave,
        last.angle, j.last_pose, jnp.asarray(j.velocity) if have_vel else jnp.eye(4),
        jnp.asarray(have_vel), jnp.int32(j.ref_kf), jnp.int32(3 if j.n_kf > 2 else 2),
        m.kf_pose, m.kf_valid, m.kf_point_idx, m.kf_feat_valid, m.pt_pos, m.pt_valid,
        m.pt_desc, m.pt_normal, m.pt_min_dist, m.pt_max_dist, m.pt_visible, m.pt_found,
        m.pt_obs_kf)
    _, j_poses, j_pt2, j_local, j_vis, j_fnd, j_sc = jout
    _, poses, pt2, local, sc = new
    # the port's commit applies the counters that JAX's step returns
    counted = LM.update_visibility(t.map, local, pt2)
    vis, fnd = counted.pt_visible, counted.pt_found
    np.testing.assert_array_equal(sc.numpy(), np.asarray(j_sc))
    for a, b in ((pt2, j_pt2), (local, j_local), (vis, j_vis), (fnd, j_fnd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(poses.numpy(), np.asarray(j_poses), atol=1e-4)

