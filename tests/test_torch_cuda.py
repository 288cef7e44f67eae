"""Card-only checks of the port, in a file that imports no JAX so that it
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test here needs an NVIDIA GPU and skips without one.  The CPU parity
tests (``test_torch_*.py``) hold the port against the JAX package; these
hold the CUDA kernels against their plain versions, and the port on the
card against the port on the CPU.
"""

import dataclasses

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
    """The pose-only LM, one launch of ``csrc/pose_lm.cu`` on the card,
    captured in a CUDA graph: its replay equals the eager run, also after
    the inputs change."""
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


# ------------------------------------------------------ the pose-only LM
POSE_ARGS = ("Tcw0", "points_w", "obs", "inv_sigma2", "valid", "is_stereo")


@pytest.mark.parametrize("n", [300, 1000, 1200, 2000, 3000])
@pytest.mark.parametrize("kind", ["mono", "stereo_mix", "outliers", "invalid", "behind",
                                  "none_valid"])
def test_pose_lm_kernel_equals_plain(cuda, kind, n):
    """``csrc/pose_lm.cu`` against ``optimize_pose_reference`` on the card,
    at the presets' slot counts and past the 2048 edges the kernel holds in
    registers.  Both sum in float32, in other orders, so the pose is held
    to 1e-4 (the JAX parity tolerance of test_torch_tracking.py) and chi2
    to 1e-3; the inlier classification must be equal."""
    from pose_cases import camera, pose_case
    from refactored_orb_slam2_tpu_torch.optim import pose_opt

    case = pose_case(kind, n, seed=n + len(kind), device=cuda)
    args = {k: case[k] for k in POSE_ARGS}
    before = cuda_hamming.launches["pose_lm"]
    got = pose_opt.optimize_pose(camera(), **args)
    assert cuda_hamming.launches["pose_lm"] == before + 1
    ref = pose_opt.optimize_pose_reference(camera(), **args)
    torch.cuda.synchronize()
    assert got.Tcw.shape == (4, 4) and got.inlier.dtype == torch.bool
    assert got.n_inliers.shape == () and got.n_inliers.dtype == torch.int32
    torch.testing.assert_close(got.Tcw, ref.Tcw, rtol=0, atol=1e-4)
    assert torch.equal(got.inlier, ref.inlier)
    assert int(got.n_inliers) == int(ref.n_inliers) == int(got.inlier.sum())
    torch.testing.assert_close(got.chi2, ref.chi2, rtol=1e-3, atol=1e-3)
    if kind == "none_valid":
        assert torch.equal(got.Tcw, args["Tcw0"]) and int(got.n_inliers) == 0
    else:
        assert int(got.n_inliers) > 0


def test_pose_lm_kernel_is_deterministic(cuda):
    """Two launches on the same inputs agree bit for bit (a fixed reduction
    order, no atomics), and each is one counted launch."""
    from pose_cases import camera, pose_case
    from refactored_orb_slam2_tpu_torch.optim import pose_opt

    case = pose_case("outliers", 1200, seed=5, device=cuda)
    args = {k: case[k] for k in POSE_ARGS}
    before = cuda_hamming.launches["pose_lm"]
    first = pose_opt.optimize_pose(camera(), **args)
    second = pose_opt.optimize_pose(camera(), **args)
    torch.cuda.synchronize()
    assert cuda_hamming.launches["pose_lm"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_every_card_pose_lm_goes_through_the_kernel(cuda):
    """Over a tracked run on the card, the kernel's launches are two a
    graph replay plus one an eager call (the warm-up before the capture,
    and any decomposed frame)."""
    from refactored_orb_slam2_tpu_torch.optim import pose_opt

    calls = {"eager": 0, "plain": 0}
    launch, plain = cuda_hamming.pose_lm, pose_opt.optimize_pose_reference

    def counted(*a, **k):
        calls["eager"] += not torch.cuda.is_current_stream_capturing()
        return launch(*a, **k)

    def plain_counted(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)

    cuda_hamming.pose_lm, pose_opt.optimize_pose_reference = counted, plain_counted
    try:
        before = cuda_hamming.launches["pose_lm"]
        slam, _, _ = _graph_run(n_frames=8, compare=False)
        launched = cuda_hamming.launches["pose_lm"] - before
    finally:
        cuda_hamming.pose_lm, pose_opt.optimize_pose_reference = launch, plain
    assert slam._graph.launches["pose_lm"] == 2
    assert calls["plain"] == 0 and calls["eager"] >= 2
    assert launched == 2 * slam._graph.replays + calls["eager"]


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
    assert graph.launches == {"window_match": 1, "pose_lm": 2}
    before = dict(cuda_hamming.launches)
    out = graph.run({name: t for name, (t, _) in graph.copied.items()})
    assert cuda_hamming.launches == dict(before, window_match=before["window_match"] + 1,
                                         pose_lm=before["pose_lm"] + 2)
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


# ------------------------------------------------- the local BA's graph
BA_COUNTERS = ("mapping.ba_eager_chunks", "mapping.ba_graph_replays")


def _mapped_room(min_kfs=4, snapshots=None):
    """A system on the card that tracked and mapped the 320x240 room frames
    (synchronous mapping, loop closing off) until it held ``min_kfs``
    keyframes; ``snapshots``, where given, gets (keyframe, map, n_pt) as
    each keyframe's mapping starts."""
    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
    )
    world = W.scene_room(seed=11)
    slam = SlamSystem(cfg, device="cuda")
    slam.loop_closing_enabled = False
    if snapshots is not None:
        core = slam._mapping_core

        def snapped(kf_slot):
            snapshots.append((kf_slot, slam.map, slam.n_pt))
            core(kf_slot)
        slam._mapping_core = snapped
    rng = np.random.default_rng(0)
    for i, T in enumerate(W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)):
        img, depth = world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                         device="cuda")
        assert slam.track_rgbd_device(img, depth, i / 30.0) is not None
        if slam.n_kf >= min_kfs:
            return slam
    raise AssertionError(f"{slam.n_kf} keyframes after 160 frames")


def _ba_counts():
    from refactored_orb_slam2_tpu_torch.utils import telemetry

    return {name: telemetry.get(name) for name in BA_COUNTERS}


def _counted(before):
    return {name: n - before[name] for name, n in _ba_counts().items()}


def test_local_ba_chunks_replay_equal_eager(cuda):
    """Windows gathered from a map the card built: every 5-iteration chunk
    through ``_ba_chunk`` is ``torch.equal`` to an eager ``BA.lm_chunk`` on
    the same inputs, in phase 1 (the chunk that captures), in phase 2 after
    ``classify_outliers`` replaced ``obs_valid``, and on a second window
    copied into the same graph; one capture, one replay a later chunk."""
    from refactored_orb_slam2_tpu_torch.models import map_ops
    from refactored_orb_slam2_tpu_torch.optim import bundle_adjustment as BA

    src = _mapped_room()
    m, mcfg = src.map, src.cfg.map
    slam = SlamSystem(src.cfg, device=cuda)          # no BA graph yet
    slots = torch.arange(m.kf_valid.shape[0], device=cuda)
    lam0 = lambda: torch.full((), 1e-4, dtype=torch.float32, device=cuda)

    def gather(window, fixed):
        return map_ops.gather_ba_window(m, window, fixed, slam.inv_sigma2_table,
                                        max_kfs=mcfg.local_ba_max_kfs,
                                        max_points=mcfg.local_ba_max_points,
                                        max_obs=mcfg.local_ba_max_obs)[0]

    replays = []

    def chunk(prob, poses, points, lam):
        want = BA.lm_chunk(slam.cam, prob, poses, points, lam, n_iters=5, use_huber=True)
        got = slam._ba_chunk(prob, poses, points, lam, 5)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        replays.append(sum(g.replays for g in slam._ba_graphs.values()))
        return got

    before = _ba_counts()
    prob = gather(m.kf_valid & (slots > 0), slots == 0)
    # the map was adjusted while it was built: points moved by up to 1 cm
    # give the LM steps to take
    noise = torch.randn(prob.points.shape, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    prob = prob._replace(points=prob.points + 0.01 * noise.clamp(-1, 1))
    poses, points, _ = chunk(prob, prob.kf_poses, prob.points, lam0())
    assert not torch.equal(points, prob.points)                      # the LM moved
    prob = prob._replace(obs_valid=BA.classify_outliers(slam.cam, prob, poses, points))
    lam = lam0()
    for _ in range(2):
        poses, points, lam = chunk(prob, poses, points, lam)
    prob = gather(m.kf_valid & (slots > 1), slots <= 1)
    poses, points, lam = chunk(prob, prob.kf_poses, prob.points, lam0())
    chunk(prob, poses, points, lam)
    graph, = slam._ba_graphs.values()
    assert graph.captures == 1 and replays == [0, 1, 2, 3, 4]
    assert _counted(before) == {"mapping.ba_eager_chunks": 1, "mapping.ba_graph_replays": 4}


def test_first_local_ba_replays_a_graph_captured_before_it(cuda):
    """The chunk's graph is captured while the second keyframe is mapped,
    before any local BA runs (three keyframes are needed): every chunk of
    the local BAs that follow is a replay.  It is a ``StepGraph``, not a
    ``FusedGraph``."""
    from refactored_orb_slam2_tpu_torch.frontend.fused_graph import FusedGraph

    before = _ba_counts()
    src = _mapped_room()
    graph, = src._ba_graphs.values()
    counted = _counted(before)
    # not the tracked frame's class, whose replays are timed as frames
    assert not isinstance(graph, FusedGraph)
    assert graph.captures == 1 and counted["mapping.ba_eager_chunks"] == 0
    assert counted["mapping.ba_graph_replays"] == graph.replays >= 6


def test_local_ba_and_initializer_ba_graphed_equal_eager(cuda):
    """``_windowed_ba`` on a map the card built, on a system whose chunks
    replay a graph and on one whose ``_lm_chunk`` is replaced (which runs
    eagerly): a 5/10 local BA, then the monocular initializer's 20/0 BA
    (one keyframe free, one fixed) on the result, write the same maps to
    the bit; the second BA replays the first's graph."""
    from refactored_orb_slam2_tpu_torch.optim import bundle_adjustment as BA

    src = _mapped_room()
    slots = torch.arange(src.map.kf_valid.shape[0], device=cuda)
    maps, counts, graphs = {}, {}, {}
    for graphed in (True, False):
        slam = SlamSystem(src.cfg, device=cuda)
        if not graphed:
            slam._lm_chunk = lambda *a, **k: BA.lm_chunk(*a, **k)
        slam.map = src.map
        before = _ba_counts()
        slam._windowed_ba(src.map.kf_valid & (slots > 0), slots == 0, 5, 10)
        slam._windowed_ba(slots == 1, slots == 0, 20, 0)
        maps[graphed], counts[graphed], graphs[graphed] = slam.map, _counted(before), slam._ba_graphs
    for f in dataclasses.fields(maps[True]):
        assert torch.equal(getattr(maps[True], f.name), getattr(maps[False], f.name)), f.name
    assert not torch.equal(maps[True].kf_pose, src.map.kf_pose)
    graph, = graphs[True].values()
    assert graph.captures == 1 and graph.replays == 6 and graphs[False] == {}
    assert counts == {True: {"mapping.ba_eager_chunks": 1, "mapping.ba_graph_replays": 6},
                      False: {"mapping.ba_eager_chunks": 7, "mapping.ba_graph_replays": 0}}


def test_local_ba_chunk_eager_where_no_graph_applies(cuda):
    """A sharded problem, the PCG solver, a chunk short of 5 iterations and
    a replaced ``_lm_chunk`` run eagerly, equal to ``BA.lm_chunk``, and
    capture nothing."""
    from refactored_orb_slam2_tpu_torch.frontend.fused_graph import flat_tensors
    from refactored_orb_slam2_tpu_torch.models import map_ops
    from refactored_orb_slam2_tpu_torch.optim import bundle_adjustment as BA
    from refactored_orb_slam2_tpu_torch.parallel.dist_ba import make_mesh, shard_ba_problem

    src = _mapped_room()
    m, mcfg = src.map, src.cfg.map
    slam = SlamSystem(src.cfg, device=cuda)
    slots = torch.arange(m.kf_valid.shape[0], device=cuda)
    prob = map_ops.gather_ba_window(m, m.kf_valid & (slots > 0), slots == 0,
                                    slam.inv_sigma2_table, max_kfs=mcfg.local_ba_max_kfs,
                                    max_points=mcfg.local_ba_max_points,
                                    max_obs=mcfg.local_ba_max_obs)[0]
    sharded = shard_ba_problem(prob, make_mesh(devices=[cuda]))
    before = _ba_counts()
    cases = [(sharded, 5, dict()), (prob, 5, dict(solver="pcg", n_cg=20)), (prob, 3, dict())]
    for p, n, kw in cases:
        got = slam._ba_chunk(p, p.kf_poses, p.points, BA.initial_damping(p), n, **kw)
        want = BA.lm_chunk(slam.cam, p, p.kf_poses, p.points, BA.initial_damping(p),
                           n_iters=n, use_huber=True, **kw)
        got, want = flat_tensors(got), flat_tensors(want)
        assert len(got) == len(want) == 3 and all(map(torch.equal, got, want))
    calls = []
    slam._lm_chunk = lambda *a, **k: calls.append(k) or BA.lm_chunk(*a, **k)
    got = slam._ba_chunk(prob, prob.kf_poses, prob.points, BA.initial_damping(prob), 5)
    want = BA.lm_chunk(slam.cam, prob, prob.kf_poses, prob.points, BA.initial_damping(prob),
                       n_iters=5, use_huber=True)
    assert len(calls) == 1 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert slam._ba_graphs == {}
    assert _counted(before) == {"mapping.ba_eager_chunks": 4, "mapping.ba_graph_replays": 0}


# ------------------------------------- triangulation and fusion as graph replays
TRI_FUSE_COUNTERS = ("mapping.tri_fuse_eager_calls", "mapping.tri_fuse_graph_replays")


def _tri_fuse_counts():
    from refactored_orb_slam2_tpu_torch.utils import telemetry

    return {name: telemetry.get(name) for name in TRI_FUSE_COUNTERS}


def _map_keyframe(slam, m, kf, run, pt_base):
    """Keyframe ``kf`` of map ``m`` triangulated against its covisible
    neighbours from ``pt_base`` on, then fused in both directions, each step
    through ``run``: (state after each step, triangulated count)."""
    from refactored_orb_slam2_tpu_torch.backend import local_mapping as LM

    orb = slam.cfg.orb
    kw = dict(scale_factor=orb.scale_factor, n_levels=orb.n_levels)
    tri, fuse, *_ = LM.mapping_work_sets(m, kf, 0, nn=10, t_cap=32, n_neighbors=10)
    s1, n_new = LM.triangulate_with_neighbors(m, kf, tri.tolist(), slam.cam, pt_base, max_new=64,
                                              min_baseline_ratio=0.005, run=run, **kw)
    s2 = LM.fuse_into_keyframes(s1, fuse.tolist(), slam.cam, budget=1024,
                                cand_idx=s1.kf_point_idx[kf], run=run, **kw)
    s3 = run(LM.fuse_targets_gen, s2, kf, fuse, slam.cam, budget=2048, **kw)
    return (s1, s2, s3), n_new


def _maps_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def test_mapping_graphs_captured_at_the_first_mapped_keyframe(cuda):
    """The first mapped keyframe captures the three graphs (a neighbour's
    triangulation, a direction-1 and a direction-2 fuse); every later call
    is a replay."""
    before = _tri_fuse_counts()
    src = _mapped_room()
    counted = {k: n - before[k] for k, n in _tri_fuse_counts().items()}
    graphs = list(src._tri_fuse_graphs.values())
    assert len(graphs) == 3 and all(g.captures == 1 for g in graphs)
    assert counted["mapping.tri_fuse_eager_calls"] == 3
    assert counted["mapping.tri_fuse_graph_replays"] == sum(g.replays for g in graphs) >= 6
    src.shutdown()


def test_triangulation_and_fusion_replay_equal_eager(cuda):
    """On maps the card built, as keyframes' mappings started: triangulation
    over a keyframe's neighbours and both fuse directions, replayed, are
    ``torch.equal`` to the same steps run eagerly with the same kernels: for
    the keyframe that triangulates most (the calls that capture), for the
    next (inputs copied into the same graphs), and for the first from 64
    slots before the bank's end, where the stop drops every neighbour after
    the first."""
    from refactored_orb_slam2_tpu_torch.backend import local_mapping as LM

    snaps = []
    src = _mapped_room(min_kfs=6, snapshots=snaps)
    slam = SlamSystem(src.cfg, device=cuda)          # no graph yet
    orb = src.cfg.orb
    made = [int(LM.triangulate_with_neighbors(
        m, kf, LM.mapping_work_sets(m, kf, 0, nn=10, t_cap=32, n_neighbors=10)[0].tolist(),
        slam.cam, n_pt, max_new=64, scale_factor=orb.scale_factor, n_levels=orb.n_levels,
        min_baseline_ratio=0.005)[1]) for kf, m, n_pt in snaps]
    first, second = np.argsort(made)[::-1][:2]
    kf, m, n_pt = snaps[first]
    P = m.pt_pos.shape[0]
    tri = LM.mapping_work_sets(m, kf, 0, nn=10, t_cap=32, n_neighbors=10)[0]
    assert made[first] > 0 and int((tri >= 0).sum()) >= 2
    for kf, m, base in (snaps[first], snaps[second], snaps[first][:2] + (P - 64,)):
        got, n_got = _map_keyframe(slam, m, kf, slam._mapping_run, base)
        want, n_want = _map_keyframe(slam, m, kf, LM.run_eager, base)
        assert torch.equal(n_got, n_want)
        for step, (a, b) in enumerate(zip(got, want)):
            assert _maps_equal(a, b), (kf, base, step)
    assert 0 < int(n_want) <= 64
    graphs = list(slam._tri_fuse_graphs.values())
    assert len(graphs) == 3 and all(g.captures == 1 and g.replays >= 2 for g in graphs)
    src.shutdown()


def test_mapping_steps_eager_where_no_graph_applies(cuda):
    """A replaced step and a system on the CPU run eagerly, equal to the
    stock step, and capture nothing."""
    from refactored_orb_slam2_tpu_torch.backend import local_mapping as LM

    src = _mapped_room()
    kf = src.n_kf - 1
    want, _ = _map_keyframe(src, src.map, kf, LM.run_eager, src.n_pt)
    stock = {name: getattr(LM, name) for name in
             ("triangulate_neighbor_gen", "fuse_gen", "fuse_targets_gen")}
    slam = SlamSystem(src.cfg, device=cuda)
    before = _tri_fuse_counts()
    try:
        for name, fn in stock.items():
            setattr(LM, name, lambda *a, _fn=fn, **k: _fn(*a, **k))
        got, _ = _map_keyframe(slam, src.map, kf, slam._mapping_run, src.n_pt)
    finally:
        for name, fn in stock.items():
            setattr(LM, name, fn)
    assert all(_maps_equal(a, b) for a, b in zip(got, want))
    assert slam._tri_fuse_graphs == {}
    counted = {k: n - before[k] for k, n in _tri_fuse_counts().items()}
    assert counted["mapping.tri_fuse_graph_replays"] == 0
    assert counted["mapping.tri_fuse_eager_calls"] > 3
    cpu = SlamSystem(src.cfg, device="cpu")
    m_cpu = dataclasses.replace(src.map, **{f.name: getattr(src.map, f.name).cpu()
                                            for f in dataclasses.fields(src.map)})
    _map_keyframe(cpu, m_cpu, kf, cpu._mapping_run, src.n_pt)
    assert cpu._tri_fuse_graphs == {}
    src.shutdown()


def test_async_mapping_graphs_captured_before_the_workers_start(cuda):
    """In async mode the triangulation, fusion and local BA graphs are
    captured on the mapping worker's stream when the system is made, before
    its threads start; the worker only replays them."""
    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=128, max_points=32768, max_obs_per_point=8),
    )
    slam = SlamSystem(cfg, device="cuda", async_mapping=True)
    graphs = dict(slam._tri_fuse_graphs)
    stream = slam._streams["mapping"].cuda_stream
    assert len(graphs) == 3 and all(key[0] == stream and g.captures == 1
                                    for key, g in graphs.items())
    ba_graphs = dict(slam._ba_graphs)
    assert len(ba_graphs) == 1 and all(key[0] == stream for key in ba_graphs)
    before = _tri_fuse_counts()
    world = W.scene_room(seed=11)
    rng = np.random.default_rng(0)
    for i, T in enumerate(W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:100]):
        img, depth = world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                         device="cuda")
        assert slam.track_rgbd_device(img, depth, i / 30.0) is not None, i
    assert slam.wait_mapping_idle(timeout=300)
    slam.shutdown()
    assert slam.n_kf >= 3 and slam._tri_fuse_graphs == graphs and slam._ba_graphs == ba_graphs
    assert all(g.captures == 1 and g.replays > 0
               for g in list(graphs.values()) + list(ba_graphs.values()))
    counted = {k: n - before[k] for k, n in _tri_fuse_counts().items()}
    assert counted["mapping.tri_fuse_eager_calls"] == 0
    assert counted["mapping.tri_fuse_graph_replays"] == sum(g.replays for g in graphs.values())


def _dlt_case(n, seed, device):
    """``n`` correspondences of points 3-8 m ahead, seen by the identity
    camera and one 0.3 m to the side, with 1e-3 of noise (as
    ``tests/test_torch_mapping.py::test_triangulate_dlt_within_1e4``)."""
    from refactored_orb_slam2_tpu_torch.geometry import se3

    rng = np.random.default_rng(seed)
    pw = rng.uniform([-2, -2, 3], [2, 2, 8], (n, 3)).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = se3.exp(torch.tensor([0.3, 0.05, 0, 0.01, 0.05, 0], dtype=torch.float32)).numpy()
    proj = lambda T: (pw @ T[:3, :3].T + T[:3, 3])[:, :2] / (pw @ T[:3, :3].T + T[:3, 3])[:, 2:]
    x1 = (proj(T1) + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    x2 = (proj(T2) + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    return [torch.from_numpy(a.copy()).to(device) for a in (T1[:3], T2[:3], x1, x2)]


@pytest.mark.parametrize("n", [200, 1000, 1200])
def test_dlt_nullvec_kernel_within_1e4_of_svd(cuda, n):
    """The DLT kernel against the plain version (``torch.linalg.svd`` on
    the card), at the CPU test's atol; one launch a call."""
    from refactored_orb_slam2_tpu_torch.geometry.triangulation import triangulate_dlt

    args = _dlt_case(n, seed=2 + n, device=cuda)
    before = cuda_hamming.launches["dlt_nullvec"]
    got = cuda_hamming.dlt_nullvec(*args)
    want = triangulate_dlt(*args)
    assert cuda_hamming.launches["dlt_nullvec"] == before + 1
    assert got.shape == (n, 3) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < 1e-4


def _gate_margins(p3d, Ta, Tb, xa, xb_m, oct_a, oct_bm, cam, scale_factor, n_levels,
                  min_baseline_ratio):
    """Each of ``LM.triangulation_gates``' thresholds, as the row's signed
    distance from it relative to the threshold's scale (positive: passes)."""
    from refactored_orb_slam2_tpu_torch.geometry import se3

    sf = scale_factor ** torch.arange(n_levels, dtype=torch.float32, device=p3d.device)
    Ca, Cb = se3.translation(se3.inv(Ta)), se3.translation(se3.inv(Tb))
    pca, pcb = se3.transform(Ta, p3d), se3.transform(Tb, p3d)
    za, zb = pca[:, 2], pcb[:, 2]
    ra, rb = p3d - Ca, p3d - Cb
    cosp = (ra * rb).sum(1) / (ra.norm(dim=1) * rb.norm(dim=1) + 1e-12)
    chi = lambda pc, z, x, o: (((pc[:, :2] / z[:, None] - x) * cam.fx) ** 2).sum(1) / sf[o] ** 2
    ratio_dist = ra.norm(dim=1) / rb.norm(dim=1).clamp(min=1e-9)
    ratio_oct = sf[oct_a] / sf[oct_bm]
    limit = min_baseline_ratio * torch.minimum(za, zb).clamp(min=1e-6)
    return dict(depth_a=(za - 1e-3) / 1e-3, depth_b=(zb - 1e-3) / 1e-3,
                parallax=(0.9998 - cosp) / 0.9998,
                chi2_a=(5.991 - chi(pca, za, xa, oct_a)) / 5.991,
                chi2_b=(5.991 - chi(pcb, zb, xb_m, oct_bm)) / 5.991,
                scale_high=(ratio_oct * 1.5 * scale_factor - ratio_dist) / ratio_oct,
                scale_low=(ratio_dist * 1.5 * scale_factor - ratio_oct) / ratio_oct,
                baseline=((Cb - Ca).norm() - limit) / limit)


def _gate_flips(slam, frames, feed, max_calls):
    """Feed ``frames`` to ``slam`` (its triangulation eager), all of them or
    until ``max_calls`` neighbour calls were made; at each, the gates on the
    kernel's points against the gates on the plain version's.  Returns the
    calls and the flipped rows (call, row, gate margins)."""
    from refactored_orb_slam2_tpu_torch.backend import local_mapping as LM
    from refactored_orb_slam2_tpu_torch.geometry.triangulation import triangulate_dlt

    gates, gen = LM.triangulation_gates, LM.triangulate_neighbor_gen
    calls, flips = [], []

    def compared(matched, p3d, Ta, Tb, xa, xb_m, oct_a, oct_bm, cam, **kw):
        good, chi = gates(matched, p3d, Ta, Tb, xa, xb_m, oct_a, oct_bm, cam, **kw)
        plain = triangulate_dlt(Ta[:3], Tb[:3], xa, xb_m)
        good_plain, _ = gates(matched, plain, Ta, Tb, xa, xb_m, oct_a, oct_bm, cam, **kw)
        calls.append(int(good.sum()))
        rows = torch.nonzero(good != good_plain).flatten().tolist()
        if rows:
            margins = _gate_margins(plain, Ta, Tb, xa, xb_m, oct_a, oct_bm, cam, **kw)
            flips.extend((len(calls) - 1, r, {k: float(v[r]) for k, v in margins.items()})
                         for r in rows)
        return good, chi

    LM.triangulation_gates = compared
    # a replaced step runs eagerly, so that every call goes through ``compared``
    LM.triangulate_neighbor_gen = lambda *a, **k: gen(*a, **k)
    try:
        for i, frame in enumerate(frames):
            feed(*frame, i / 30.0)
            if max_calls is not None and len(calls) >= max_calls:
                break
    finally:
        LM.triangulation_gates, LM.triangulate_neighbor_gen = gates, gen
    return calls, flips


def test_dlt_kernel_gates_equal_svd_on_mapped_keyframes(cuda):
    """The triangulation's ``good`` mask with the kernel's points equals the
    mask with ``torch.linalg.svd``'s on every neighbour call of the room
    frames and on 200 calls of the desk pass (the benchmark's RGB-D cell:
    TUM3 at 640x480, 1000 features); a row that flips lies within 1e-3 of
    a gate (printed, with its gate)."""
    from refactored_orb_slam2_tpu_torch.utils.presets import get_preset

    world = W.scene_room(seed=11)
    room_cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
    )
    for name, cfg, traj, want in (
            ("room", room_cfg, W.traj_room_orbit(160, seed=5, span=0.45 * np.pi), None),
            ("desk", get_preset("rgbd_tum3"), W.traj_room_orbit(600, seed=11), 200)):
        slam = SlamSystem(cfg, device=cuda)
        slam.loop_closing_enabled = False
        rng = np.random.default_rng(0)
        frames = (world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                      device="cuda") for T in traj)
        calls, flips = _gate_flips(slam, frames, slam.track_rgbd_device, want)
        slam.shutdown()
        print(f"{name}: {len(calls)} neighbour calls, {sum(calls)} points passed the gates, "
              f"{len(flips)} rows flipped")
        for call, row, margins in flips:
            gate = min(margins, key=lambda k: abs(margins[k]))
            print(f"  call {call} row {row}: gate {gate}, relative margin {margins[gate]:.3g}")
            assert abs(margins[gate]) <= 1e-3, (name, call, row, margins)
        assert len(calls) >= (want or 10) and sum(calls) > 0


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


def _graph_launch_events(prof) -> list:
    """Per ``cudaGraphLaunch`` of a profile, in launch order: the device
    events that carry its correlation id (every node the replay ran), in
    start order."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launches = sorted((e for e in events if e.device_type() != DeviceType.CUDA
                       and e.name() == "cudaGraphLaunch"), key=lambda e: e.start_ns())
    linked = {e.correlation_id(): [] for e in launches}
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.correlation_id() in linked:
            linked[e.correlation_id()].append(e)
    return [sorted(linked[e.correlation_id()], key=lambda d: d.start_ns()) for e in launches]


def test_fused_graph_stages_split_every_replay(cuda):
    """The fused step's seven stage marks at the capture, in order, over a
    graph that is one chain, and their node total equal to the device
    events that carry each replay's ``cudaGraphLaunch`` correlation id in
    the profiler: so the marks split a replay's device events by stage."""
    from torch.profiler import ProfilerActivity, profile

    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=500, n_levels=4),
        map=MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
    )
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:9]
    slam = SlamSystem(cfg, device=cuda)
    rng = np.random.default_rng(0)
    frames = [world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                  device=cuda) for T in poses]
    for i, f in enumerate(frames[:6]):
        assert slam.track_rgbd_device(*f, i / 30.0) is not None
    stages = slam._graph.stages
    names = [name for name, _ in stages["marks"]]
    assert names == ["track.build", "track.motion", "track.pose1", "track.local_select",
                     "track.local_match", "track.pose2", "track.counts"]
    counts = [n for _, n in stages["marks"]]
    assert 0 < counts[0] and counts == sorted(counts) and counts[-1] == stages["nodes"]
    assert stages["chain"] is True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, f in enumerate(frames[6:], start=6):
            assert slam.track_rgbd_device(*f, i / 30.0) is not None
        torch.cuda.synchronize()
    replays = _graph_launch_events(prof)
    assert len(replays) == 3
    assert [len(r) for r in replays] == [stages["nodes"]] * 3
