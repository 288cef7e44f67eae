"""The async mode on the stereo and monocular sensors, on the CPU: the
scenarios of ``tests/test_torch_stereo_sequence.py`` (seed 4, bf 80, 500
features) and ``tests/test_torch_mono_sequence.py`` (seed 7, 600 features),
both 320x240, 4 levels, map 24 x 4096 x 8, over 24 lateral frames of 6 cm
(a keyframe a frame fills the keyframe bank at frame 22), loop closing off
on both packages, as there.

- Lockstep: the JAX and the port ``SlamSystem(async_mapping=True)`` on the
  same frames, each waiting for its workers after every frame
  (``wait_mapping_idle``), so that every keyframe decision meets an idle
  mapper and nothing depends on the threads' timing.  Each run is read
  after frames 20 and 24 (``CHECKPOINTS``).  The same frames are tracked
  and the keyframes made at the same frame ids on both, and ``n_pt`` is
  within 1%.  Stereo: every frame tracked and the poses within 1 mm and
  0.1 degree (``test_torch_sequence.assert_poses_close``).  Monocular, with
  the JAX initializer's minimal sets handed to the port's sampler: the
  Sim3-aligned ATE of both under 0.05 m.  The monocular ATEs are not held
  within 0.5 mm of each other, as the synchronous
  ``test_torch_mono_sequence.py`` holds them: in async mode they part by
  0.03-1.4 mm from frame 5 on (0.548 mm after frame 20, 1.398 mm after
  frame 24).  The cause is float rounding, not a step of the port
  (ROADMAP.md, known differences): from the same map each keyframe's
  triangulation gives the JAX package's count, but two candidates whose
  chi2 sums differ by 4e-9 (kf 3) take their point slots in the other
  order under XLA's compiled arithmetic, and later lowest-slot tie-breaks
  follow the slots.
- Free-running: the port alone, the frames fed as fast as it tracks them,
  the workers left to run behind (a monocular keyframe needed while mapping
  is busy is refused).  Held, as nothing here depends on the threads'
  timing: the workers drained, no thread alive after ``shutdown``, finite
  poses, ``n_kf >= 3``, monocular initialized within its first 4 frames;
  stereo, which waits up to 500 ms for a busy mapper before it refuses a
  keyframe, every frame tracked.
"""

import numpy as np
import pytest
import torch

import test_torch_mono_sequence as mono
import test_torch_stereo_sequence as stereo
from refactored_orb_slam2_tpu.solvers import initializer as jinit
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld, ate_rmse_sim3
from refactored_orb_slam2_tpu_torch.solvers import initializer as tinit
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam
from test_torch_initializer import jax_sets
from test_torch_sequence import assert_poses_close, gt_centers, lateral_traj

torch.set_num_threads(1)

N_FRAMES = 24
CHECKPOINTS = (20, 24)
TIMEOUT = 120.0
# sensor -> (JAX config, port config, world seed, noise seed)
SENSORS = {"stereo": (stereo.CFG, stereo.TCFG, 4, 2), "monocular": (mono.CFG, mono.TCFG, 7, 5)}


def _frames(sensor):
    _, tcfg, seed, noise_seed = SENSORS[sensor]
    world = SyntheticWorld.create(seed=seed, n_points=500, x_range=(-6, 6), y_range=(-2.5, 2.5),
                                  z_range=(2.5, 10.0), clear_tube=0.0)
    traj = lateral_traj(N_FRAMES, step=0.06)
    cam = TSlam(tcfg, device="cpu").cam
    rng = np.random.default_rng(noise_seed)
    if sensor == "stereo":
        return traj, [world.render_stereo(T, cam, noise=2.0, rng=rng) for T in traj]
    return traj, [(world.render(T, cam, noise=2.0, rng=rng),) for T in traj]


def _track(slam, sensor, frame, i):
    entry = slam.track_stereo if sensor == "stereo" else slam.track_monocular
    return entry(*frame, i * 0.1)


def _read(slam, returned):
    """What the lockstep tests hold of a run after its latest frame."""
    return dict(returned=list(returned), n_kf=slam.n_kf, n_pt=slam.n_pt,
                kf_frames=np.array(slam.map.kf_frame_id[:slam.n_kf]),
                centers=np.array(slam.camera_centers()),
                tracked=np.array(slam.tracked_frame_ids()),
                poses=np.array(slam.frame_poses()), n_logs=len(slam.tracked_logs()),
                discarded=slam.stats.get("local_ba_discarded", 0))


def _shutdown(slam):
    threads = slam.mapper.threads()
    slam.shutdown()
    return [t.name for t in threads if t.is_alive()]


@pytest.fixture(scope="module", params=sorted(SENSORS))
def lockstep(request):
    sensor = request.param
    cfg, tcfg, _, _ = SENSORS[sensor]
    traj, frames = _frames(sensor)

    def sets_of_jax(valid, n_hyps, generator):
        assert n_hyps == jinit.N_HYPS
        return torch.from_numpy(jax_sets(valid.numpy(), generator.initial_seed()))

    draw = tinit.draw_minimal_sets
    tinit.draw_minimal_sets = sets_of_jax
    out = {}
    try:
        for name in ("jax", "port"):
            slam = (JSlam(cfg, async_mapping=True) if name == "jax"
                    else TSlam(tcfg, device="cpu", async_mapping=True))
            slam.loop_closing_enabled = False
            returned, reads = [], {}
            for i, frame in enumerate(frames):
                returned.append(_track(slam, sensor, frame, i))
                assert slam.wait_mapping_idle(timeout=TIMEOUT), (name, i)
                if i + 1 in CHECKPOINTS:
                    reads[i + 1] = _read(slam, returned)
            slam.shutdown()
            out[name] = reads
    finally:
        tinit.draw_minimal_sets = draw
    return sensor, traj, out


@pytest.mark.parametrize("n", CHECKPOINTS)
def test_lockstep_keyframes_as_jax(lockstep, n):
    _, _, out = lockstep
    j, t = out["jax"][n], out["port"][n]
    assert [p is None for p in t["returned"]] == [p is None for p in j["returned"]]
    np.testing.assert_array_equal(t["tracked"], j["tracked"])
    assert t["n_kf"] == j["n_kf"] >= 3
    np.testing.assert_array_equal(t["kf_frames"], j["kf_frames"])
    assert abs(t["n_pt"] - j["n_pt"]) <= 0.01 * j["n_pt"]
    assert t["discarded"] == 0


@pytest.mark.parametrize("n", CHECKPOINTS)
def test_lockstep_poses_as_jax(lockstep, n):
    sensor, traj, out = lockstep
    j, t = out["jax"][n], out["port"][n]
    if sensor == "stereo":
        assert all(p is not None for p in t["returned"]) and t["n_logs"] == n
        assert_poses_close(t["poses"], j["poses"])
        assert_poses_close(np.stack(t["returned"]),
                           np.stack([np.asarray(p) for p in j["returned"]]))
        return
    ate = {name: ate_rmse_sim3(r["centers"], gt_centers(traj)[r["tracked"]])
           for name, r in (("jax", j), ("port", t))}
    assert ate["jax"] < mono.ATE_BOUND_M and ate["port"] < mono.ATE_BOUND_M, ate


@pytest.mark.parametrize("sensor", sorted(SENSORS))
def test_free_running_tracks_every_frame(sensor):
    _, tcfg, _, _ = SENSORS[sensor]
    traj, frames = _frames(sensor)
    slam = TSlam(tcfg, device="cpu", async_mapping=True)
    slam.loop_closing_enabled = False
    out = [_track(slam, sensor, frame, i) for i, frame in enumerate(frames)]
    assert slam.wait_mapping_idle(timeout=TIMEOUT)
    assert _shutdown(slam) == [] and slam.mapper is None
    first = next(i for i, p in enumerate(out) if p is not None)
    assert slam.n_kf >= 3 and np.isfinite(slam.frame_poses()).all()
    if sensor == "stereo":
        assert first == 0 and slam.tracked_frame_ids().tolist() == list(range(N_FRAMES))
    else:
        assert first <= 3
