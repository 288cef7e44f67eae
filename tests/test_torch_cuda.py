"""Card-only checks of the port, in a file that imports no JAX so that it
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test here needs an NVIDIA GPU and skips without one.  The CPU parity
tests (``test_torch_*.py``) hold the port against the JAX package; these
hold the CUDA kernels against their plain versions, and the port on the
card against the port on the CPU.
"""

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu_torch.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
from refactored_orb_slam2_tpu_torch.system import SlamSystem
from refactored_orb_slam2_tpu_torch.utils import world3d as W

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _random_case(seed, n1, n2, radius_range, band, p_valid, device):
    rng = np.random.default_rng(seed)
    words = lambda n: rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (
        t(words(n1)), t(words(n2)),
        t(rng.uniform(0, 640, (n1, 2)).astype(np.float32)),
        t(rng.uniform(0, 640, (n2, 2)).astype(np.float32)),
        t(rng.uniform(*radius_range, n1).astype(np.float32)),
        t(rng.integers(0, 8, n1).astype(np.int32)),
        t(rng.integers(0, 8, n2).astype(np.int32)),
        t(rng.random(n1) < p_valid), t(rng.random(n2) < p_valid),
    ), band


def _assert_equal_to_plain(got, ref, n1):
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.shape == (n1,)
        assert torch.equal(g, r)


@pytest.mark.parametrize("n1,n2,radius,band,p_valid", [
    (512, 1024, (60.0, 60.0), (-1, 0), 1.0),      # JAX run_selfcheck shape
    (256, 384, (30.0, 120.0), (-1, 1), 0.9),      # JAX run_golden shape
    (4096, 1000, (4.0, 20.0), (-1, 0), 0.9),      # the tracking shape
    (4096, 2000, (2.5, 14.4), (-1, 0), 0.9),      # the KITTI preset's (2000 slots)
    (4096, 800, (2.5, 14.4), (-1, 0), 0.9),       # run_synthetic's (800 slots)
    (70, 33, (50.0, 300.0), (-2, 2), 0.8),        # ragged edges on both sides
])
def test_window_match_kernel_equals_plain(cuda, n1, n2, radius, band, p_valid):
    args, band = _random_case(n1 + n2, n1, n2, radius, band, p_valid, cuda)
    before = cuda_hamming.launches["window_match"]
    got = cuda_hamming.window_match(*args, band)
    assert cuda_hamming.launches["window_match"] == before + 1
    _assert_equal_to_plain(got, cuda_hamming.window_match_reference(*args, band), n1)


def test_window_match_kernel_on_cpu_copies(cuda):
    """The same inputs on the CPU take the plain path and give the kernel's
    answer."""
    args, band = _random_case(7, 300, 500, (20.0, 80.0), (-1, 0), 0.9, cuda)
    got = cuda_hamming.window_match(*args, band)
    ref = cuda_hamming.window_match(*(a.cpu() for a in args), band)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("n1,n2,radius,p_valid", [
    (500, 1031, (20.0, 60.0), 0.9),       # column counts off every alignment
    (500, 1001, (20.0, 60.0), 0.9),
    (300, 7, (100.0, 400.0), 0.9),
    (700, 1, (300.0, 700.0), 0.9),        # one column
    (1, 1000, (40.0, 80.0), 0.9),         # one row
    (1, 1, (700.0, 700.0), 1.0),
    (20000, 1000, (4.0, 20.0), 0.9),      # more rows than one pass of the grid
    (512, 6000, (10.0, 40.0), 0.9),       # a long bank
    (300, 20000, (10.0, 40.0), 0.9),      # more columns than a block holds at once
    (900, 1000, (20.0, 60.0), 0.0),       # nothing valid: no row has a candidate
])
def test_window_match_kernel_edges_equal_plain(cuda, n1, n2, radius, p_valid):
    args, band = _random_case(n1 + n2, n1, n2, radius, (-1, 1), p_valid, cuda)
    _assert_equal_to_plain(cuda_hamming.window_match(*args, band),
                           cuda_hamming.window_match_reference(*args, band), n1)


def test_window_match_kernel_takes_views(cuda):
    """Every argument as a non-contiguous view of the same values."""
    args, band = _random_case(11, 640, 1001, (20.0, 60.0), (-1, 1), 0.9, cuda)
    views = tuple(t.repeat_interleave(2, dim=0)[::2] for t in args)
    assert not any(v.is_contiguous() for v in views)
    _assert_equal_to_plain(cuda_hamming.window_match(*views, band),
                           cuda_hamming.window_match_reference(*args, band), 640)


def _masked_case(seed, n1, n2, density, device):
    """Random descriptors with twins (ties at the best), a random mask with
    some all-false rows."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    b[n2 // 2:2 * (n2 // 2)] = b[:n2 // 2]
    a = np.concatenate([b[rng.choice(n2, n1 // 2)],
                        rng.integers(0, 2**32, (n1 - n1 // 2, 8), dtype=np.uint32)])
    mask = rng.random((n1, n2)) < density
    mask[rng.choice(n1, n1 // 10, replace=False)] = False
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t(a.view(np.int32)), t(b.view(np.int32)), t(mask)


@pytest.mark.parametrize("n1,n2,density", [
    (2048, 1000, 0.02),      # the fuse shape
    (1000, 1000, 0.05),      # the triangulation shape
    (2048, 2000, 0.02),      # the KITTI preset's fuse
    (2000, 2000, 0.05),      # its triangulation, stereo and rescue
    (2048, 800, 0.02),       # run_synthetic's fuse
    (800, 800, 0.05),        # its triangulation and stereo
    (1000, 1500, 0.3),       # a dense mask
    (777, 1031, 0.5),        # ragged edges on both sides
    (5, 3, 0.5),             # fewer rows than a block, fewer columns than a warp
])
def test_hamming_best2_kernel_equals_plain(cuda, n1, n2, density):
    args = _masked_case(n1 + n2, n1, n2, density, cuda)
    before = cuda_hamming.launches["hamming_best2"]
    got = cuda_hamming.hamming_best2(*args)
    assert cuda_hamming.launches["hamming_best2"] == before + 1
    _assert_equal_to_plain(got, cuda_hamming.hamming_best2_reference(*args), n1)
    cpu = cuda_hamming.hamming_best2(*(a.cpu() for a in args))
    for g, r in zip(got, cpu):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("n1,n2,density", [
    (500, 1031, 0.05), (500, 1001, 0.05), (300, 7, 0.5),   # off every alignment
    (700, 1, 0.7), (1, 1000, 0.3), (1, 1, 1.0),            # one column, one row
    (20000, 1000, 0.02),     # more rows than one pass of the grid
    (512, 6000, 0.05),       # long rows
    (600, 9000, 0.3),        # several queue groups a row, dense
    (900, 1000, 0.0),        # every row masked out
])
def test_hamming_best2_kernel_edges_equal_plain(cuda, n1, n2, density):
    args = _masked_case(n1 + n2, n1, n2, density, cuda)
    got = cuda_hamming.hamming_best2(*args)
    _assert_equal_to_plain(got, cuda_hamming.hamming_best2_reference(*args), n1)
    if density == 0.0:
        d1, i1, d2 = got
        assert bool((d1 == 1 << 20).all() and (i1 == 0).all() and (d2 == 1 << 20).all())


@pytest.mark.parametrize("layout", ["strided", "transposed", "odd offset"])
@pytest.mark.parametrize("n2", [1000, 1013])
def test_hamming_best2_kernel_takes_any_mask_layout(cuda, layout, n2):
    """The mask as a strided view, a transposed view (both copied by the
    wrapper) and a contiguous tensor that starts 3 bytes into its storage
    (read in place, from 16-byte words aligned down)."""
    n1 = 333
    a, b, mask = _masked_case(n2, n1, n2, 0.1, cuda)
    if layout == "strided":
        view = mask.repeat_interleave(2, dim=1)[:, ::2]
    elif layout == "transposed":
        view = mask.t().contiguous().t()
    else:
        flat = torch.cat([torch.zeros(3, dtype=torch.bool, device=cuda), mask.reshape(-1)])
        view = flat[3:].view(n1, n2)
        assert view.is_contiguous() and view.data_ptr() % 16 == 3
    assert layout == "odd offset" or not view.is_contiguous()
    assert torch.equal(view, mask)
    _assert_equal_to_plain(cuda_hamming.hamming_best2(a, b, view),
                           cuda_hamming.hamming_best2_reference(a, b, mask), n1)


def test_slice_on_card_agrees_with_cpu(cuda):
    """The port tracks the same 6 rendered 320x240 frames on the card and on
    the CPU.  Reductions and products run in another order on the card, so
    pyramid levels above 0 may differ in the last float32 bits: the six
    per-frame counters may differ by 2% and poses by 1 mm."""
    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
    )
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:6]
    out = {}
    for dev in ("cpu", "cuda"):
        slam = SlamSystem(cfg, device=dev)
        rng = np.random.default_rng(0)
        scalars = []
        commit = slam._commit_fused

        def recorded(rec, **k):
            scalars.append(rec["sc"].cpu().numpy())
            return commit(rec, **k)

        slam._commit_fused = recorded
        before = cuda_hamming.launches["window_match"]
        for i, T in enumerate(poses):
            img, depth = world.render_device(T, slam.cam, want_depth=True, noise=2.0,
                                             rng=rng, device=dev)
            assert slam.track_rgbd_device(img, depth, i / 30.0) is not None
        out[dev] = (slam.frame_poses(), np.array(scalars),
                    cuda_hamming.launches["window_match"] - before, slam.n_kf)
    (p_cpu, s_cpu, l_cpu, k_cpu), (p_gpu, s_gpu, l_gpu, k_gpu) = out["cpu"], out["cuda"]
    assert l_cpu == 0 and l_gpu == len(poses) - 1
    assert k_cpu == k_gpu == 1
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=0.02, atol=2)
    np.testing.assert_allclose(p_gpu, p_cpu, atol=1e-3)


def test_relocalization_on_card_agrees_with_cpu(cuda):
    """The 320x240 room frames 0-5 on the card and on the CPU, then
    localization-only mode, two grey frames (lost, and a relocalization
    attempt with no feature) and frame 0's view again: both relocalize
    at keyframe 0 with the same EPnP sets (drawn from a seeded CPU
    generator on either device), poses within 1 mm; on the card the
    relocalized frame's local map launches the window kernel and a rescue
    round the masked kernel, whose associations equal the CPU's."""
    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
    )
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:6]
    out = {}
    for dev in ("cpu", "cuda"):
        slam = SlamSystem(cfg, device=dev)
        slam.loop_closing_enabled = False
        rng = np.random.default_rng(0)
        frames = [world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                      device=dev) for T in poses]
        for i, f in enumerate(frames):
            assert slam.track_rgbd_device(*f, i / 30.0) is not None
        slam.activate_localization_mode()
        grey = (torch.full((240, 320), 128, dtype=torch.uint8, device=dev),
                torch.full((240, 320), 2000, dtype=torch.int32, device=dev).to(torch.uint16))
        assert slam.track_rgbd_device(*grey, 0.2) is None
        assert slam.track_rgbd_device(*grey, 0.3) is None and slam.state == 2
        before = dict(cuda_hamming.launches)
        pose = slam.track_rgbd_device(*frames[0], 0.4)
        assert pose is not None and slam.stats["relocs"] == 1
        window = cuda_hamming.launches["window_match"] - before["window_match"]
        rec = [r for r in slam.reloc_log if r["accepted"]][0]
        half = torch.where(torch.arange(rec["pt_idx"].shape[0], device=dev) % 2 == 0,
                           rec["pt_idx"], -1)
        before = cuda_hamming.launches["hamming_best2"]
        pt_idx, n_add = slam._reloc_rescue(rec["frame"], rec["pose"], rec["cand"], half, 10.0, 100)
        out[dev] = (pose, rec["cand"], window, pt_idx.cpu().numpy(), n_add,
                    cuda_hamming.launches["hamming_best2"] - before)
    (p_cpu, c_cpu, w_cpu, i_cpu, n_cpu, m_cpu) = out["cpu"]
    (p_gpu, c_gpu, w_gpu, i_gpu, n_gpu, m_gpu) = out["cuda"]
    assert c_cpu == c_gpu == 0
    np.testing.assert_allclose(p_gpu, p_cpu, atol=1e-3)
    assert (w_cpu, m_cpu) == (0, 0) and w_gpu >= 1 and m_gpu == 1
    assert n_gpu > 0 and abs(n_gpu - n_cpu) <= 0.02 * n_cpu + 2
    assert (i_gpu == i_cpu).mean() > 0.98


# ------------------------------------------------- the fused step's graph
def _graph_run(n_frames=21, compare=True, slam=None):
    """The 320x240 room frames on the card: from the second tracked frame
    on, each one through the graph and the eager step on the same inputs
    (``compare``) before it is tracked, on ``slam`` or a new system.
    Returns the system, the frames compared and those whose outputs
    differed."""
    from refactored_orb_slam2_tpu_torch.frontend.fused_graph import flat_tensors
    from refactored_orb_slam2_tpu_torch.system import TrackState

    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
    )
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:n_frames]
    rng = np.random.default_rng(0)
    slam = slam or SlamSystem(cfg, device="cuda")
    compared, unequal = 0, []
    for i, T in enumerate(poses):
        img, depth = world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                         device="cuda")
        if compare and slam._graph is not None and slam.state == TrackState.OK:
            inputs = slam._fused_inputs(img, depth)
            eager, graph = slam._fused_step(**inputs), slam._graph.run(inputs)
            compared += 1
            if not all(torch.equal(a, b) for a, b in zip(flat_tensors(eager), flat_tensors(graph))):
                unequal.append(i)
        assert slam.track_rgbd_device(img, depth, i / 30.0) is not None
    return slam, compared, unequal


def test_fused_graph_replay_equals_eager_step(cuda):
    """20 tracked frames: every output of the replay torch.equal to the
    eager step's on the same inputs."""
    _, compared, unequal = _graph_run()
    assert compared == 19 and unequal == []


def test_fused_graph_captured_once_per_system_and_sensor(cuda):
    slam, _, _ = _graph_run(compare=False)
    assert slam._graph.captures == 1 and slam._graph.replays == 19
    slam.reset()                          # the shapes stay, and so does the graph
    _graph_run(n_frames=5, compare=False, slam=slam)
    assert slam._graph.captures == 1 and slam._graph.replays == 23
    assert SlamSystem(slam.cfg, device="cuda")._graph is None


def test_pose_lm_captures_in_a_cuda_graph(cuda):
    """The pose-only LM, ``torch.linalg.solve_ex`` of its 6x6 systems
    included, captured in a CUDA graph: its replay equals the eager run,
    also after the inputs change."""
    from refactored_orb_slam2_tpu_torch.geometry import camera as cam_mod, se3
    from refactored_orb_slam2_tpu_torch.optim.pose_opt import optimize_pose

    cam = cam_mod.camera_from_config(CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0,
                                                  bf=40.0, width=320, height=240))
    g = torch.Generator().manual_seed(3)
    pw = torch.cat([torch.rand(300, 2, generator=g) * 4 - 2,
                    torch.rand(300, 1, generator=g) * 6 + 2], dim=1).to(cuda)
    T0 = se3.exp(torch.tensor([0.02, -0.01, 0.03, 0.01, 0.02, -0.01])).to(cuda)
    obs = torch.cat([cam_mod.project(cam, pw) + torch.randn(300, 2, generator=g).to(cuda),
                     torch.full((300, 1), -1.0, device=cuda)], dim=1)
    args = dict(Tcw0=T0, points_w=pw, obs=obs, inv_sigma2=torch.ones(300, device=cuda),
                valid=torch.ones(300, dtype=torch.bool, device=cuda),
                is_stereo=torch.zeros(300, dtype=torch.bool, device=cuda))
    static = {k: v.clone() for k, v in args.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        optimize_pose(cam, **static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = optimize_pose(cam, **static)
    for shift in (0.0, 0.5):
        static["obs"].copy_(args["obs"] + shift)
        graph.replay()
        eager = optimize_pose(cam, **dict(args, obs=args["obs"] + shift))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_fused_graph_capture_outlives_a_dead_graph(cuda):
    """A dropped system whose graph sits in a reference cycle (the graph
    holds the system's bound step) is collected before the next system's
    capture, never during it, where freeing the dead graph's memory would
    invalidate the capture."""
    import gc

    first, _, _ = _graph_run(n_frames=3, compare=False)
    del first
    threshold = gc.get_threshold()
    gc.set_threshold(1)                   # collect at nearly every allocation
    try:
        second, _, _ = _graph_run(n_frames=3, compare=False)
    finally:
        gc.set_threshold(*threshold)
    assert second._graph.captures == 1 and second._graph.replays == 1


def test_fused_graph_replay_adds_its_launches(cuda):
    slam, _, _ = _graph_run(n_frames=4, compare=False)
    graph = slam._graph
    assert graph.launches == {"window_match": 1}
    before = dict(cuda_hamming.launches)
    out = graph.run({name: t for name, (t, _) in graph.copied.items()})
    assert cuda_hamming.launches == dict(before, window_match=before["window_match"] + 1)
    assert out[-1].shape == (6,)


# ----------------------------------------------------------- the async mode
def test_async_tracking_on_card(cuda):
    """The 320x240 room frames through the async mode on the card: every
    frame tracked, the masked kernel launched from the mapping thread on its
    stream, every thread stopped by shutdown, the ATE under twice the
    synchronous run's on the same frames (or 1 cm)."""
    runs = {}
    for async_mapping in (False, True):
        cfg = SystemConfig(
            sensor="rgbd",
            camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                                width=320, height=240),
            orb=ORBConfig(n_features=500, n_levels=4),
            map=MapConfig(max_keyframes=128, max_points=32768, max_obs_per_point=8),
        )
        world = W.scene_room(seed=11)
        poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:100]
        rng = np.random.default_rng(0)
        slam = SlamSystem(cfg, device="cuda", async_mapping=async_mapping)
        threads = slam.mapper.threads() if async_mapping else []
        cuda_hamming.reset_launches()
        for i, T in enumerate(poses):
            img, depth = world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                             device="cuda")
            assert slam.track_rgbd_device(img, depth, i / 30.0) is not None, i
        assert slam.wait_mapping_idle(timeout=300)
        by_thread = {k: dict(v) for k, v in cuda_hamming.launches_by_thread.items()}
        slam.shutdown()
        assert not any(t.is_alive() for t in threads)
        runs[async_mapping] = (slam, by_thread)
    slam, by_thread = runs[True]
    assert slam.n_kf >= 2 and by_thread["local-mapping"]["hamming_best2"] >= 1
    assert by_thread["MainThread"]["window_match"] >= 99
    gt = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses])
    ate = {k: float(np.sqrt(((s.camera_centers() - gt[s.tracked_frame_ids()]) ** 2)
                            .sum(axis=1).mean())) for k, (s, _) in runs.items()}
    assert ate[True] < max(2 * ate[False], 0.01), ate


def test_mono_async_lockstep_on_card_agrees_with_cpu(cuda):
    """The 320x240 room frames 0-23 without depth through the async mode on
    the card and on the CPU, in lockstep (``wait_mapping_idle`` after every
    frame, so that no keyframe decision depends on the threads' timing):
    the two-view initializer accepts at the same frame (its minimal sets
    come from a CPU generator seeded with the frame id on either device) and
    the keyframes are made at the same frames; on the card the initializer's
    map writes and BA run on the tracker's stream beside the live workers,
    and the mapping thread launches the masked kernel on its own stream."""
    cfg = SystemConfig(
        sensor="monocular",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=0.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=64, max_points=16384, max_obs_per_point=8),
    )
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:24]
    out = {}
    for dev in ("cpu", "cuda"):
        slam = SlamSystem(cfg, device=dev, async_mapping=True)
        slam.loop_closing_enabled = False
        threads = slam.mapper.threads()
        rng = np.random.default_rng(0)
        cuda_hamming.reset_launches()
        tracked = []
        for i, T in enumerate(poses):
            img = world.render_device(T, slam.cam, noise=2.0, rng=rng, device=dev)
            tracked.append(slam.track_monocular_device(img, i / 30.0) is not None)
            assert slam.wait_mapping_idle(timeout=300), (dev, i)
        by_thread = {k: dict(v) for k, v in cuda_hamming.launches_by_thread.items()}
        slam.shutdown()
        assert not any(t.is_alive() for t in threads)
        out[dev] = (tracked, slam.map.kf_frame_id[:slam.n_kf].tolist(), slam, by_thread)
    (t_cpu, k_cpu, s_cpu, _), (t_gpu, k_gpu, s_gpu, by_thread) = out["cpu"], out["cuda"]
    assert t_gpu == t_cpu and sum(t_gpu) >= 0.9 * (len(poses) - t_gpu.index(True))
    assert k_gpu == k_cpu and len(k_gpu) >= 3
    assert by_thread["local-mapping"]["hamming_best2"] >= 1
    assert np.isfinite(s_gpu.frame_poses()).all()


def test_rescue_rounds_on_card_equal_plain(cuda):
    """``_relocalize`` on the 320x240 room map (frames 0-5) with frame 5's
    view, against keyframe 0 (frame 0's own view keeps all its matches and
    leaves a rescue nothing to add), called
    again with the accept bar one above its first pose-LM's inliers, as
    chip_smoke.py's phase 17 (b) raises it: a rescue round runs, its masked
    searches launch the kernel at (keyframe slots x frame slots) with
    candidate pairs, and the kernel equals its plain version on the tensors
    each round gave it."""
    import dataclasses

    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
    )
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:6]
    slam = SlamSystem(cfg, device="cuda")
    slam.loop_closing_enabled = False
    rng = np.random.default_rng(0)
    frames = [world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                  device="cuda") for T in poses]
    for i, f in enumerate(frames):
        assert slam.track_rgbd_device(*f, i / 30.0) is not None
    frame = slam._build_frame(*frames[5])
    ok, _, _ = slam._relocalize(frame)
    acc = [r for r in slam.reloc_log if r["accepted"]]
    assert ok and acc
    slam.cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(
        cfg.tracking, min_inliers_reloc=acc[0]["lm_inliers"][0] + 1))
    kept, best2 = [], cuda_hamming.hamming_best2
    cuda_hamming.hamming_best2 = lambda *a: kept.append(a) or best2(*a)
    before = cuda_hamming.launches["hamming_best2"]
    try:
        slam._relocalize(frame)
    finally:
        cuda_hamming.hamming_best2 = best2
    rounds = max(r["rescue_rounds"] for r in slam.reloc_log)
    assert rounds >= 1 and len(kept) == rounds
    assert cuda_hamming.launches["hamming_best2"] - before == rounds
    n = slam.n_feat_slots
    assert sum(int(mask.sum()) for *_, mask in kept) > 0
    for a, b, mask in kept:
        assert (a.shape[0], b.shape[0]) == (n, n)
        _assert_equal_to_plain(best2(a, b, mask), cuda_hamming.hamming_best2_reference(a, b, mask),
                               n)


def test_masked_kernel_from_a_worker_thread_on_a_side_stream(cuda):
    """hamming_best2 launched from another thread under its own stream, as
    the async mode's workers launch it: equal to its plain version, counted
    once on that thread."""
    import threading

    args = _masked_case(7, 2048, 1000, 0.02, cuda)
    stream, got = torch.cuda.Stream(), []
    stream.wait_stream(torch.cuda.current_stream())

    def work():
        with torch.cuda.stream(stream):
            got.append(cuda_hamming.hamming_best2(*args))
        stream.synchronize()

    cuda_hamming.reset_launches()
    worker = threading.Thread(target=work, name="side-stream-worker")
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and got
    assert cuda_hamming.launches_by_thread["side-stream-worker"]["hamming_best2"] == 1
    _assert_equal_to_plain(got[0], cuda_hamming.hamming_best2_reference(*args), 2048)


def test_fused_graph_captured_while_the_mapping_worker_is_busy(cuda):
    """The first fused frame's capture comes while the mapping worker runs
    steps that allocate and launch on its stream: the worker parks at its
    next yield around the capture (thread-local capture mode), the capture
    holds, the replays equal the eager step, and the worker finishes its
    steps afterwards."""
    import threading

    slam = SlamSystem(SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
    ), device="cuda", async_mapping=True)
    started, done = threading.Event(), []

    def busy(kf_slot):
        for step in range(400):
            x = torch.randn(512, 512, device="cuda")
            (x @ x).sum().item()             # a host sync on the worker's stream
            started.set()
            yield
        done.append(kf_slot)

    slam._mapping_steps = busy
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:6]
    rng = np.random.default_rng(0)
    frames = [world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                  device="cuda") for T in poses]
    assert slam.track_rgbd_device(*frames[0], 0.0) is not None      # initialization
    slam.mapper.submit(0)
    assert started.wait(60)
    assert slam.track_rgbd_device(*frames[1], 1 / 30.0) is not None  # the capture
    assert slam._graph.captures == 1 and not done
    from refactored_orb_slam2_tpu_torch.frontend.fused_graph import flat_tensors

    for i in range(2, 6):
        inputs = slam._fused_inputs(*frames[i])
        eager, graph = slam._fused_step(**inputs), slam._graph.run(inputs)
        assert all(torch.equal(a, b) for a, b in zip(flat_tensors(eager), flat_tensors(graph)))
        assert slam.track_rgbd_device(*frames[i], i / 30.0) is not None
    assert slam.wait_mapping_idle(timeout=300) and done == [0]
    slam.shutdown()


# ------------------------------------------------------------- distribution
def test_two_shards_on_card_match_one(cuda):
    """``run_distributed_ba`` over cuda:0 twice against the one-shard run,
    which is ``torch.equal`` to ``BA.run``, on the JAX bench's problem."""
    from refactored_orb_slam2_tpu_torch.geometry.camera import Camera
    from refactored_orb_slam2_tpu_torch.optim import bundle_adjustment as BA
    from refactored_orb_slam2_tpu_torch.parallel.dist_ba import make_mesh, run_distributed_ba
    from refactored_orb_slam2_tpu_torch.scripts.bench_dist_ba import make_problem

    torch.backends.cuda.matmul.allow_tf32 = False
    cam = Camera.create(500.0, 500.0, 320.0, 240.0, bf=40.0)
    prob = make_problem(8, 1024, 4, device=cuda)
    ref = BA.run(cam, prob, iters_phase1=3, iters_phase2=0, solver="pcg", n_cg=80)
    one = run_distributed_ba(cam, prob, make_mesh(devices=[cuda]), iters_phase1=3)
    assert all(torch.equal(a, b) for a, b in zip(ref, one))
    two = run_distributed_ba(cam, prob, make_mesh(devices=[cuda] * 2), iters_phase1=3)
    assert two.points.is_cuda and two.points.shape == prob.points.shape
    assert float((two.kf_poses - one.kf_poses).abs().max()) <= 5e-4
    assert float((two.points - one.points).abs().max()) <= 5e-3
    assert float((one.kf_poses - prob.kf_poses).abs().max()) > 1e-4      # the LM moved


def test_multihost_one_rank_under_nccl(cuda, tmp_path):
    """One rank of ``scripts/multihost_ba.py`` under NCCL (a subprocess with
    a timeout): the camera error halves, the rank holds all 64 points."""
    from refactored_orb_slam2_tpu_torch.scripts import multihost_ba as W

    out = tmp_path / "out"
    W.launch(1, f"file://{tmp_path / 'rendezvous'}", ["cuda:0"], str(out), timeout=180.0)
    assert np.load(f"{out}.points.0.npy").shape == (64, 3)
    assert np.isfinite(np.load(f"{out}.poses.0.npy")).all()
