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
        step = slam._fused_step

        def recorded(*a, **k):
            out = step(*a, **k)
            scalars.append(out[-1].cpu().numpy())
            return out

        slam._fused_step = recorded
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
