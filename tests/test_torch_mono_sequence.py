"""The ``tests/test_e2e.py`` monocular scenario on both packages: 14 lateral
frames of 6 cm (``SyntheticWorld`` seed 7, noise seed 5, 320x240, 600
features, 4 levels, map 24 x 4096 x 8), synchronous mapping, loop closing
off on both.

The JAX package draws the initializer's minimal sets with ``jax.random``
from ``PRNGKey(frame_id)``; PyTorch cannot reproduce those draws.  So the
port runs twice:

- with the JAX package's sets handed to its sampler (``draw_minimal_sets``
  replaced by the JAX package's own two calls, seeded with the port
  generator's seed, which is the frame id).  Asserted: initialization at
  the same frame with the same model (``is_h``), the same keyframes at the
  same frame ids, ``n_pt`` within 1%, the Sim3-aligned ATE of both under
  0.05 m and within 0.5 mm of each other (measured: 0.00486 and 0.00492 m,
  n_pt 1011 on both);
- with its own sampler (a CPU ``torch.Generator`` seeded with the frame
  id): state OK, at least 10 frames tracked, ATE under 0.05 m (measured:
  13 frames, 0.0036 m).

A monocular keyframe gets no depth points, so every point after the
initial map comes from triangulation through the masked best-2 search.

The port's two runs are traced (``telemetry.tracing``), one pass each: the
initializer's spans and counters, and the benchmark's readers of them
(``slambench/metrics/init.*``) on those readings.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.solvers import initializer as jinit
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld, ate_rmse_sim3
from refactored_orb_slam2_tpu_torch import system as tsystem
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.solvers import initializer as tinit
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam, TrackState
from refactored_orb_slam2_tpu_torch.utils import telemetry
from slambench import registry
from test_torch_initializer import jax_sets
from test_torch_sequence import gt_centers, lateral_traj

CFG = SystemConfig(
    sensor="monocular",
    camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                        width=320, height=240, fps=10),
    orb=ORBConfig(n_features=600, n_levels=4),
    map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8,
                  fuse_neighbors=4, triangulate_neighbors=4),
)
TCFG = config_from_reference(CFG)
ATE_BOUND_M = 0.05
ATE_APART_M = 5e-4


def _ate(slam, traj):
    return ate_rmse_sim3(slam.camera_centers(), gt_centers(traj)[slam.tracked_frame_ids()])


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld.create(seed=7, n_points=500, x_range=(-6, 6),
                                  y_range=(-2.5, 2.5), z_range=(2.5, 10.0), clear_tube=0.0)
    traj = lateral_traj(14, step=0.06)
    cam = TSlam(TCFG, device="cpu").cam
    rng = np.random.default_rng(5)
    frames = [world.render(T, cam, noise=2.0, rng=rng) for T in traj]

    inits = {"jax": [], "injected": [], "own": []}
    j_init, t_init, t_draw = (jinit.initialize_two_view, tsystem.initialize_two_view,
                              tinit.draw_minimal_sets)

    def recorded(fn, log):
        def run(*a, **k):
            res = fn(*a, **k)
            log.append((bool(res.success), bool(res.is_h), int(res.n_good)))
            return res
        return run

    def sets_of_jax(valid, n_hyps, generator):
        assert n_hyps == jinit.N_HYPS
        return torch.from_numpy(jax_sets(valid.numpy(), generator.initial_seed()))

    out = {}
    telemetry.spans()
    try:
        for name in inits:
            slam = JSlam(CFG) if name == "jax" else TSlam(TCFG, device="cpu")
            slam.loop_closing_enabled = False
            jinit.initialize_two_view = recorded(j_init, inits["jax"])
            tsystem.initialize_two_view = recorded(t_init, inits[name])
            tinit.draw_minimal_sets = sets_of_jax if name == "injected" else t_draw
            # the port's runs are traced, as a traced benchmark window is:
            # each frame's id and host stamps, the spans and the counters'
            # change over the pass
            telemetry.tracing(name != "jax")
            counters0 = telemetry.snapshot()["counters"]
            n_pt_init = []
            returned = []
            stamps = []
            for i, img in enumerate(frames):
                t0 = time.time_ns()
                returned.append(slam.track_monocular(img, i * 0.1))
                stamps.append((slam.frame_id, t0, time.time_ns()))
                if returned[-1] is not None and not n_pt_init:
                    n_pt_init.append(slam.n_pt)
            telemetry.tracing(False)
            counters = {k: v - counters0.get(k, 0)
                        for k, v in telemetry.snapshot()["counters"].items()}
            readings = dict(spans=telemetry.spans(), counters=counters, frame_stamps=stamps)
            out[name] = (slam, returned, n_pt_init[0], readings)
    finally:
        telemetry.tracing(False)
        jinit.initialize_two_view = j_init
        tsystem.initialize_two_view = t_init
        tinit.draw_minimal_sets = t_draw
    return traj, out, inits


def test_mono_initializes_at_the_same_frame_with_the_same_model(runs):
    _, out, inits = runs
    first = {name: [r is not None for r in returned].index(True)
             for name, (_, returned, _, _) in out.items()}
    assert first["injected"] == first["jax"]
    # the accepted attempt is the last one; both chose the same model
    assert inits["jax"][-1][0] and inits["injected"][-1][0]
    assert inits["injected"][-1][1] == inits["jax"][-1][1]
    assert len(inits["injected"]) == len(inits["jax"])
    assert abs(inits["injected"][-1][2] - inits["jax"][-1][2]) <= 0.01 * inits["jax"][-1][2]


def test_mono_with_the_jax_sets_agrees_with_jax(runs):
    traj, out, _ = runs
    j, t = out["jax"][0], out["injected"][0]
    assert t.state == TrackState.OK and j.state == 1
    assert [r is None for r in out["injected"][1]] == [r is None for r in out["jax"][1]]
    assert t.n_kf == j.n_kf >= 3
    np.testing.assert_array_equal(t.map.kf_frame_id[:t.n_kf].numpy(),
                                  np.asarray(j.map.kf_frame_id)[:j.n_kf])
    assert abs(t.n_pt - j.n_pt) <= 0.01 * j.n_pt
    assert t.stats["motion_tracks"] == j.stats["motion_tracks"]
    ate_j, ate_t = _ate(j, traj), _ate(t, traj)
    assert ate_j < ATE_BOUND_M and ate_t < ATE_BOUND_M
    assert abs(ate_j - ate_t) < ATE_APART_M, (ate_j, ate_t)


def test_mono_with_its_own_sampler_tracks(runs):
    traj, out, _ = runs
    slam, returned, _, _ = out["own"]
    assert slam.state == TrackState.OK, "monocular init never succeeded"
    assert sum(r is not None for r in returned) >= 10
    assert _ate(slam, traj) < ATE_BOUND_M
    assert np.isfinite(slam.frame_poses()).all()


@pytest.mark.parametrize("name", ["injected", "own"])
def test_mono_map_grows_by_triangulation_only(runs, name):
    """No feature of a monocular frame has depth, so keyframes add no depth
    points; the map still grows after the initial two-view map."""
    _, out, _ = runs
    slam, _, n_pt_init, _ = out[name]
    assert n_pt_init >= 50
    assert slam.n_pt > n_pt_init + 100
    assert (slam.last_frame.depth < 0).all() and (slam.last_frame.uvr[:, 2] < 0).all()
    # a point is triangulated from two keyframes, so it has two observations
    n_obs = (slam.map.pt_obs_kf >= 0).sum(dim=1)
    assert int(n_obs[slam.map.pt_valid].min()) >= 2


def test_mono_branches_of_the_facade():
    slam = TSlam(TCFG, device="cpu")
    frame = slam._build_frame(torch.zeros((240, 320), dtype=torch.uint8), None)
    assert not slam._initialize_depth(frame)          # refuses monocular
    assert slam._motion_window == 15.0
    assert TSlam(TCFG.replace(sensor="stereo"), device="cpu")._motion_window == 7.0
    with pytest.raises(ValueError, match="sensor"):
        TSlam(TCFG.replace(sensor="lidar"), device="cpu")
    async_slam = TSlam(TCFG, device="cpu", async_mapping=True)
    assert async_slam.mapper is not None and async_slam.sensor == "monocular"
    async_slam.shutdown()
    assert async_slam.mapper is None
    for kwargs in (dict(pipelined=True), dict(cooperative_mapping=True)):
        slam = TSlam(TCFG, device="cpu", **kwargs)
        assert (slam.pipeline_depth, slam.cooperative) == (int(kwargs.get("pipelined", False)),
                                                           kwargs.get("cooperative_mapping", False))


INIT_STEPS = {"init.match", "init.two_view", "init.map", "init.ba"}
INIT_READERS = ("init.ms_per_pass", "init.attempts_per_pass")


@pytest.mark.parametrize("name", ["injected", "own"])
def test_mono_init_spans_and_counters(runs, name):
    """Every ``init`` span is keyed by its frame's id; the accepted one
    holds the four steps; each pass runs at least one solve and accepts
    once, and every solve is counted in the span of its frame."""
    _, out, _ = runs
    _, returned, _, r = out[name]
    first = [p is not None for p in returned].index(True)
    fed = [frame for frame, _, _ in r["frame_stamps"]]
    init = [s for s in r["spans"] if s["name"] == "init"]
    # the initializer runs on every frame up to the first tracked one
    assert [s["key"] for s in init] == fed[:first + 1]
    children = {}
    for s in r["spans"]:
        children.setdefault(s["parent"], []).append(s)
    accepted = [s for s in init if s["counts"].get("init.accepted")]
    assert len(accepted) == 1 and accepted[0]["key"] == fed[first]
    assert {c["name"] for c in children[accepted[0]["id"]]} == INIT_STEPS
    assert all(c["key"] == fed[first] for c in children[accepted[0]["id"]])
    c = r["counters"]
    assert c.get("init.accepted") == 1
    assert c.get("init.attempts", 0) >= 1
    assert c["init.attempts"] == sum(s["counts"].get("init.attempts", 0) for s in init)
    assert c["init.attempts"] >= c.get("init.refused", 0) + 1


@pytest.mark.parametrize("name", ["injected", "own"])
def test_mono_init_readers(runs, name):
    """Both readers give finite values on a pass that initialized, and
    nothing on readings with no initialization in them."""
    _, out, _ = runs
    r = out[name][3]
    readers = {m: registry.metric_reader(m) for m in INIT_READERS}
    ms = readers["init.ms_per_pass"](r)
    solved = {s["key"] for s in r["spans"]
              if s["name"] == "init" and s["counts"].get("init.attempts")}
    frame_ms = {f: (t1 - t0) * 1e-6 for f, t0, t1 in r["frame_stamps"]}
    assert np.isfinite(ms) and ms == pytest.approx(sum(frame_ms[f] for f in solved))
    assert readers["init.attempts_per_pass"](r) == r["counters"]["init.attempts"] >= 1
    later = dict(spans=[s for s in r["spans"] if not s["name"].startswith("init")],
                 counters={k: v for k, v in r["counters"].items() if not k.startswith("init.")},
                 frame_stamps=r["frame_stamps"])
    for read in readers.values():
        assert read(later) is None and read({}) is None


@pytest.mark.parametrize("name", ["injected", "own"])
def test_ba_graph_pct_reader_on_cpu(runs, name):
    """On the CPU every local-BA chunk runs eagerly, the initializer's four
    among them: ``mapping.ba_graph_pct`` reads 0, and nothing on readings
    without a chunk."""
    _, out, _ = runs
    r = out[name][3]
    c = r["counters"]
    assert c.get("mapping.ba_graph_replays", 0) == 0
    # 20 iterations at initialization, then 3 chunks a mapped keyframe
    assert c["mapping.ba_eager_chunks"] >= 4 and (c["mapping.ba_eager_chunks"] - 4) % 3 == 0
    read = registry.metric_reader("mapping.ba_graph_pct")
    assert read(r) == 0.0
    assert read(dict(r, counters={"mapping.ba_graph_replays": 3,
                                  "mapping.ba_eager_chunks": 1})) == 75.0
    assert read({}) is None and read(dict(r, counters={})) is None
