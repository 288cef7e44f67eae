"""The async mode on the CPU: ``SlamSystem(cfg, device="cpu",
async_mapping=True)`` with its mapping and loop-closing threads and the
global-BA thread (the port's counterparts of ``tests/test_async.py``), and
its deterministic pieces against the JAX package on one map.

- Async tracking over ``test_torch_sequence.py``'s lateral RGB-D frames:
  none lost, ATE < 0.02 m, every thread stopped after ``shutdown``.
- A GBA whose epoch moves mid-flight (``_abort_running_gba``, a slowed LM
  chunk) is dropped: ``gba_aborted == 1``, the keyframe poses
  ``torch.equal`` to those before.
- Keyframes made while a slowed GBA runs: at least one; the merge then
  moves them along the spanning tree, the poses stay finite and tracking
  goes on.
- On one map, a port run's banks carried to the JAX package by
  ``io/convert.py``: ``_merge_gba_result`` with keyframes and points newer
  than the snapshot (poses and points within 1e-5, float32) and
  ``_run_ba_chunked``, full and stopped after one chunk (the global BA
  tolerances of ``test_torch_loop_closing.py``: rotations 1e-4, translations
  1e-3, points 2e-3); the inline GBA ``torch.equal`` to ``BA.run``'s.
- The tear repair: a loop correction run between a local BA's gather and
  its scatter, which is then dropped (``local_ba_discarded``) and leaves the
  corrected poses standing; without the correction the scatter moves them.
- ``stopped()``, the hold around the graph capture, with the workers idle
  and with the mapping worker busy; a worker's exception raised at
  ``shutdown``; the 500 ms backpressure window with its ``mapping_backlog``
  warning.

Every join and wait has a timeout, so that a test fails rather than hangs.
"""

import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.models.map_state import MapState as JMapState
from refactored_orb_slam2_tpu.optim import bundle_adjustment as JBA
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld, ate_rmse
from refactored_orb_slam2_tpu_torch.geometry import se3 as tse3
from refactored_orb_slam2_tpu_torch.io.convert import map_state_to_numpy
from refactored_orb_slam2_tpu_torch.models import map_ops
from refactored_orb_slam2_tpu_torch.optim import bundle_adjustment as TBA
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam
from refactored_orb_slam2_tpu_torch.utils import telemetry
from test_torch_sequence import CFG, TCFG, gt_centers, lateral_traj, render

torch.set_num_threads(1)

TIMEOUT = 120.0


def _track(slam, frames, t0=0):
    return [slam.track_rgbd(img, depth, (t0 + i) * 0.1) for i, (img, depth) in enumerate(frames)]


def _shutdown(slam):
    mapper = slam.mapper
    threads = mapper.threads()
    slam.shutdown()
    assert slam.mapper is None
    assert not any(t.is_alive() for t in threads), [t.name for t in threads if t.is_alive()]


def _slow_chunk(slam, delay):
    """Each LM chunk sleeps ``delay`` s first, so that the GBA thread is
    still running when the test acts on it."""
    orig = slam._lm_chunk

    def slowed(*args, **kwargs):
        time.sleep(delay)
        return orig(*args, **kwargs)

    slam._lm_chunk = slowed
    return orig


def _world_frames(world_kw, traj, seed):
    world = SyntheticWorld.create(**world_kw)
    cam = TSlam(TCFG, device="cpu").cam
    rng = np.random.default_rng(seed)
    return [(world.render(T, cam, noise=2.0, rng=rng), world.render_depth(T, cam))
            for T in traj]


def test_async_tracking_lateral():
    traj = lateral_traj(12)
    slam = TSlam(TCFG, device="cpu", async_mapping=True)
    assert slam.mapper is not None and slam.mapper.idle
    out = _track(slam, render(traj))
    assert slam.wait_mapping_idle(timeout=TIMEOUT)
    _shutdown(slam)
    assert all(p is not None for p in out) and slam.n_kf >= 3
    ate = ate_rmse(slam.camera_centers(), gt_centers(traj)[slam.tracked_frame_ids()])
    assert ate < 0.02, ate
    assert slam.stats["local_ba_discarded"] == 0 and not slam._pending_vis


@pytest.fixture(scope="module")
def async_warm():
    """Frames of tests/test_async.py's abort scenario (world seed 22) for
    an async system: 14 frames give 3 or more keyframes."""
    world = dict(seed=22, n_points=450, x_range=(-4.0, 4.0), y_range=(-2.5, 2.5),
                 z_range=(2.5, 9.0), clear_tube=0.0)
    return _world_frames(world, lateral_traj(14), seed=3)


def test_gba_abort_by_epoch(async_warm):
    slam = TSlam(TCFG, device="cpu", async_mapping=True)
    assert all(p is not None for p in _track(slam, async_warm))
    assert slam.mapper.wait_idle(timeout=TIMEOUT) and slam.n_kf >= 3
    before = slam.map.kf_pose.clone()
    _slow_chunk(slam, 0.3)
    slam._launch_gba(slam.ref_kf, iters=10)
    assert slam._gba_thread.is_alive()
    slam._abort_running_gba()           # what a newer loop's correction does
    slam._gba_thread.join(timeout=TIMEOUT)
    assert not slam._gba_thread.is_alive()
    assert slam.stats["gba_runs"] == 1 and slam.stats["gba_aborted"] == 1
    assert torch.equal(before, slam.map.kf_pose), "an aborted GBA reached the map"
    _shutdown(slam)


def test_keyframes_made_while_gba_runs():
    world = dict(seed=23, n_points=550, x_range=(-8, 8), y_range=(-2.5, 2.5),
                 z_range=(2.5, 10.0), clear_tube=0.0)
    frames = _world_frames(world, lateral_traj(26, step=0.07), seed=4)
    slam = TSlam(TCFG, device="cpu", async_mapping=True)
    assert all(p is not None for p in _track(slam, frames[:14]))
    assert slam.mapper.wait_idle(timeout=TIMEOUT)
    n_kf_at_launch = slam.n_kf
    assert n_kf_at_launch >= 3
    orig = _slow_chunk(slam, 1.5)
    slam._launch_gba(slam.ref_kf, iters=10)
    assert slam._gba_thread.is_alive()
    grew = False
    for i, (img, depth) in enumerate(frames[14:]):
        assert slam.track_rgbd(img, depth, (14 + i) * 0.1) is not None
        grew |= slam.n_kf > n_kf_at_launch and slam._gba_thread.is_alive()
    slam._lm_chunk = orig
    slam._gba_thread.join(timeout=TIMEOUT)
    assert not slam._gba_thread.is_alive()
    assert grew, "no keyframe was made while the GBA ran"
    assert slam.stats["gba_runs"] == 1 and slam.stats["gba_aborted"] == 0
    assert slam._pending_pose_jump is not None or slam.frame_id > 25
    assert torch.isfinite(slam.map.kf_pose[:slam.n_kf]).all()
    assert slam.track_rgbd(*frames[-1], 9.9) is not None
    _shutdown(slam)


# ------------------------------------------------------- parity on one map
@pytest.fixture(scope="module")
def lateral_map():
    """A synchronous port run over the lateral frames (keyframes at frames
    0, 4, 6, 8 and 11), loop closing off: its banks and counters."""
    slam = TSlam(TCFG, device="cpu")
    slam.loop_closing_enabled = False
    assert all(p is not None for p in _track(slam, render(lateral_traj(12))))
    assert slam.n_kf == 5
    return dict(map=slam.map, n_kf=slam.n_kf, n_pt=slam.n_pt, ref_kf=slam.ref_kf)


def _port_system(rec):
    slam = TSlam(TCFG, device="cpu")
    slam.loop_closing_enabled = False
    slam.map = rec["map"]
    slam.n_kf, slam.n_pt, slam.ref_kf = rec["n_kf"], rec["n_pt"], rec["ref_kf"]
    slam.last_pose = slam.map.kf_pose[slam.ref_kf]
    return slam


def _jax_map(m):
    return JMapState(**{k: jnp.asarray(v) for k, v in map_state_to_numpy(m).items()})


def test_merge_gba_result_with_newer_keyframes_and_points(lateral_map):
    rec = lateral_map
    t = _port_system(rec)
    j = JSlam(CFG)
    j.map = _jax_map(rec["map"])
    j.n_kf, j.n_pt, j.ref_kf = rec["n_kf"], rec["n_pt"], rec["ref_kf"]
    n_kf_snap, n_pt_snap = 3, rec["n_pt"] // 2
    parents = rec["map"].kf_parent[n_kf_snap:rec["n_kf"]].tolist()
    assert parents[0] < n_kf_snap and parents[1] == n_kf_snap   # a chain through a new one
    # a GBA result: every snapshot pose and point moved a little
    rng = np.random.default_rng(5)
    K, P = rec["map"].kf_pose.shape[0], rec["map"].pt_pos.shape[0]
    turn = torch.from_numpy(rng.normal(0, 0.01, (K, 3)).astype(np.float32))
    jolt = tse3.from_rt(tse3.so3_exp(turn), torch.from_numpy(
        rng.normal(0, 0.02, (K, 3)).astype(np.float32)))
    res_poses = jolt @ rec["map"].kf_pose
    res_points = rec["map"].pt_pos + torch.from_numpy(rng.normal(0, 0.01, (P, 3)).astype(np.float32))
    t._merge_gba_result(rec["map"], types.SimpleNamespace(kf_poses=res_poses, points=res_points),
                        n_kf_snap, n_pt_snap)
    j._merge_gba_result(_jax_map(rec["map"]),
                        types.SimpleNamespace(kf_poses=jnp.asarray(res_poses.numpy()),
                                              points=jnp.asarray(res_points.numpy())),
                        n_kf_snap, n_pt_snap)
    np.testing.assert_allclose(t.map.kf_pose.numpy(), np.asarray(j.map.kf_pose), atol=1e-5)
    np.testing.assert_allclose(t.map.pt_pos.numpy(), np.asarray(j.map.pt_pos), atol=1e-5)
    # the newer keyframes and points did move
    for k in range(n_kf_snap, rec["n_kf"]):
        assert (t.map.kf_pose[k] - rec["map"].kf_pose[k]).abs().max() > 1e-3
    newer = rec["map"].pt_valid.clone()
    newer[:n_pt_snap] = False
    assert int(newer.sum()) > 50
    assert float((t.map.pt_pos[newer] - rec["map"].pt_pos[newer]).abs().max()) > 1e-3
    assert t.map_epoch == 2 and t.last_pose is not None


def _problem(rec, slam):
    K = rec["map"].kf_pose.shape[0]
    slots = torch.arange(K)
    return map_ops.build_ba_problem(rec["map"], rec["map"].kf_valid & (slots != 0), slots == 0,
                                    slam.inv_sigma2_table)


@pytest.mark.parametrize("stop_after_one", [False, True])
def test_run_ba_chunked_against_jax(lateral_map, stop_after_one):
    t = _port_system(lateral_map)
    j = JSlam(CFG)
    tprob = _problem(lateral_map, t)
    jprob = JBA.BAProblem(**{f: jnp.asarray(getattr(tprob, f).numpy())
                             for f in tprob._fields})
    n_cg = TCFG.map.gba_cg_iters
    stop = (lambda: True) if stop_after_one else None
    tr, ts = t._run_ba_chunked(tprob, 4, 0, solver="pcg", n_cg=n_cg, chunk=2, should_stop=stop)
    jr, js = j._run_ba_chunked(jprob, 4, 0, solver="pcg", n_cg=n_cg, chunk=2, should_stop=stop)
    assert ts == js == stop_after_one
    n = lateral_map["n_kf"]
    tp, jp = tr.kf_poses.numpy()[:n], np.asarray(jr.kf_poses)[:n]
    np.testing.assert_allclose(tp[:, :3, :3], jp[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], atol=1e-3)
    ok = tprob.point_valid.numpy()
    np.testing.assert_allclose(tr.points.numpy()[ok], np.asarray(jr.points)[ok], atol=2e-3)
    assert np.abs(tp - tprob.kf_poses.numpy()[:n]).max() > 1e-6       # the LM moved
    # the outlier gate agrees but for edges at its threshold
    differ = (tr.obs_valid.numpy() != np.asarray(jr.obs_valid)).sum()
    assert differ <= 0.001 * tprob.obs_valid.numpy().sum(), differ


def test_inline_gba_equal_to_ba_run(lateral_map):
    """Synchronous mode: ``_launch_gba`` (chunks of 2 LM iterations carrying
    the damping) gives today's ``BA.run`` merge bit for bit."""
    t = _port_system(lateral_map)
    prob = _problem(lateral_map, t)
    ref = TBA.run(t.cam, prob, iters_phase1=10, iters_phase2=0, solver="pcg",
                  n_cg=TCFG.map.gba_cg_iters)
    m = lateral_map["map"]
    K, P = m.kf_pose.shape[0], m.pt_pos.shape[0]
    in_kf = m.kf_valid & (torch.arange(K) < lateral_map["n_kf"])
    in_pt = m.pt_valid & (torch.arange(P) < lateral_map["n_pt"])
    t._launch_gba(lateral_map["n_kf"] - 1)
    assert t.stats["gba_runs"] == 1 and t.stats["gba_aborted"] == 0 and t._gba_thread is None
    assert torch.equal(t.map.kf_pose, torch.where(in_kf[:, None, None], ref.kf_poses, m.kf_pose))
    assert torch.equal(t.map.pt_pos, torch.where(in_pt[:, None], ref.points, m.pt_pos))
    assert torch.equal(t.last_pose, t.map.kf_pose[t.ref_kf])


# ------------------------------------------------------------- tear repair
def test_local_ba_scatter_dropped_after_a_correction(lateral_map):
    """The local BA of a keyframe's mapping gathers its window, a loop
    correction lands before its scatter (as the loop thread's can in async
    mode), and the scatter is dropped: the corrected poses stand."""
    rec = lateral_map
    kf_cur, kf_loop = rec["n_kf"] - 1, 0

    def run(correct: bool):
        slam = _port_system(rec)
        gathered = []
        steps = slam._windowed_ba_steps

        def watched(*args, **kwargs):
            gen = steps(*args, **kwargs)
            yield next(gen)                     # the gather
            gathered.append(True)
            yield from gen

        slam._windowed_ba_steps = watched
        corrected = None
        for _ in slam._mapping_steps(kf_cur):
            if correct and gathered and corrected is None:
                T = slam.map.kf_pose
                rel = (T[kf_cur] @ torch.linalg.inv(T[kf_loop])).numpy()
                R = rel[:3, :3].astype(np.float32)
                tr = (rel[:3, 3] + np.float32([0.05, 0.0, 0.03])).astype(np.float32)
                slam._correct_loop(kf_cur, kf_loop, R, tr, 1.0)
                corrected = slam.map.kf_pose.clone()
        assert gathered
        return slam, corrected

    control, _ = run(correct=False)
    assert control.stats["local_ba_discarded"] == 0
    assert (control.map.kf_pose - rec["map"].kf_pose).abs().max() > 1e-6   # the scatter moved poses
    slam, corrected = run(correct=True)
    assert corrected is not None and (corrected - rec["map"].kf_pose).abs().max() > 1e-3
    assert slam.stats["local_ba_discarded"] == 1 and slam.map_epoch == 2
    assert torch.equal(slam.map.kf_pose, corrected)


def test_stopped_parks_the_mapping_worker():
    """``stopped()`` (the tracker's hold around its graph capture) returns
    at once while both workers wait for work, parks a busy mapping worker
    at its next yield until the block ends, and lets it finish after."""
    slam = TSlam(TCFG, device="cpu", async_mapping=True)
    t0 = time.monotonic()
    with slam.mapper.stopped(timeout=10):
        pass
    assert time.monotonic() - t0 < 5
    steps = []

    def busy(kf_slot):
        for k in range(200):
            time.sleep(0.005)
            steps.append(k)
            yield

    slam._mapping_steps = busy
    slam.mapper.submit(1)
    deadline = time.monotonic() + 10
    while not steps and time.monotonic() < deadline:
        time.sleep(0.005)
    with slam.mapper.stopped(timeout=10):
        held = len(steps)
        time.sleep(0.2)
        assert len(steps) == held and 0 < held < 200 and slam.mapper._parked
    assert slam.wait_mapping_idle(timeout=TIMEOUT) and len(steps) == 200
    _shutdown(slam)


# ------------------------------------------------- exceptions, backpressure
def test_worker_exception_raised_at_shutdown():
    slam = TSlam(TCFG, device="cpu", async_mapping=True)

    def broken(kf_slot):
        yield
        raise RuntimeError(f"mapping keyframe {kf_slot} failed")

    slam._mapping_steps = broken
    slam.mapper.submit(1)
    assert slam.mapper.wait_idle(timeout=TIMEOUT)
    threads = slam.mapper.threads()
    with pytest.raises(RuntimeError, match="mapping keyframe 1 failed"):
        slam.shutdown()
    assert slam.mapper is None and not any(t.is_alive() for t in threads)


def test_backpressure_waits_500_ms_then_warns():
    slam = TSlam(TCFG, device="cpu", async_mapping=True)
    gate = threading.Event()

    def blocked(kf_slot):
        gate.wait(TIMEOUT)
        yield

    slam._mapping_steps = blocked
    # a needed keyframe: c1a (frames since the last one), c2 (few inliers)
    slam.n_kf, slam.last_kf_frame_id, slam._ref_matches = 3, 0, 1000
    need = lambda: slam._need_new_keyframe(None, None, 100, close_counts=(200, 0),
                                           frame_id=100)
    for kf in range(4):                 # one mapping, three queued
        slam.mapper.submit(kf)
    deadline = time.monotonic() + 10
    while slam.mapper.queue_len() != 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert slam.mapper.queue_len() == 3 and not slam.mapper.idle
    warned = telemetry.get("warn.mapping_backlog")
    t0 = time.monotonic()
    assert need() is False
    waited = time.monotonic() - t0
    assert 0.5 <= waited < 5.0, waited
    assert slam.abort_ba and telemetry.get("warn.mapping_backlog") == warned + 1
    # the queue drains inside the window: the keyframe goes in
    threading.Timer(0.1, gate.set).start()
    t0 = time.monotonic()
    assert need() is True
    assert time.monotonic() - t0 < 0.5
    assert telemetry.get("warn.mapping_backlog") == warned + 1
    assert slam.wait_mapping_idle(timeout=TIMEOUT)
    _shutdown(slam)
