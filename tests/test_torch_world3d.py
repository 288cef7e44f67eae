"""The port's fixture renderer against the JAX module's: identical numpy
scene and trajectory builders, an exact lattice hash, and a 160x120 render
that agrees given the same numpy noise image (intensity within 1 on >= 99.5%
of pixels — a float32 ray/plane product in another order can move a texel
edge by a fraction of a pixel — and depth within 1e-4 m where both hit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.utils import world3d as JW
from refactored_orb_slam2_tpu.utils.config import CameraConfig
from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.utils import world3d as TW

CAM = camera_from_config(config_from_reference(
    CameraConfig(fx=129.3, fy=129.1, cx=79.6, cy=63.8, width=160, height=120)))


@pytest.mark.parametrize("seed", [11, 3])
def test_scene_room_surfaces_identical(seed):
    js, ts = JW.scene_room(seed=seed), TW.scene_room(seed=seed)
    assert len(js.surfaces) == len(ts.surfaces)
    for a, b in zip(js.surfaces, ts.surfaces):
        for name in ("p0", "eu", "ev", "normal"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        assert (a.seed, a.albedo) == (b.seed, b.albedo)
    np.testing.assert_array_equal(ts.light, js.light)
    assert ts.ambient == js.ambient


def test_trajectory_builders_identical():
    for n, seed, span in ((160, 5, 0.45 * np.pi), (30, 7, 0.9 * np.pi)):
        np.testing.assert_array_equal(TW.traj_room_orbit(n, seed=seed, span=span),
                                      JW.traj_room_orbit(n, seed=seed, span=span))
    np.testing.assert_array_equal(TW._smooth_noise(50, 2.0, seed=3),
                                  JW._smooth_noise(50, 2.0, seed=3))
    np.testing.assert_array_equal(TW._look_at([1, 2, 3], [0, 0, 0.5], [0, 0, 1]),
                                  JW._look_at([1, 2, 3], [0, 0, 0.5], [0, 0, 1]))


def test_hash2_exact():
    rng = np.random.default_rng(0)
    ix = rng.integers(-2**31, 2**31, 4000, dtype=np.int64).astype(np.int32)
    iy = rng.integers(-2**31, 2**31, 4000, dtype=np.int64).astype(np.int32)
    seed = rng.integers(0, 10**6, 4000).astype(np.int32)
    ref = np.array(JW._hash2(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(seed)))
    got = TW._hash2(torch.from_numpy(ix), torch.from_numpy(iy), torch.from_numpy(seed))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.fixture(scope="module")
def renders():
    T = JW.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[3]
    jimg, jdepth = JW.scene_room(seed=11).render(
        T, CAM, want_depth=True, noise=2.0, rng=np.random.default_rng(4))
    world = TW.scene_room(seed=11)
    timg, tdepth = world.render(T, CAM, want_depth=True, noise=2.0,
                                rng=np.random.default_rng(4))
    tu8, tu16 = world.render_device(T, CAM, want_depth=True, noise=2.0,
                                    rng=np.random.default_rng(4), device="cpu")
    return (jimg, jdepth), (timg, tdepth), (tu8.numpy(), tu16.numpy())


def test_render_matches_jax(renders):
    (jimg, jdepth), (timg, tdepth), _ = renders
    assert timg.shape == jimg.shape == (120, 160) and timg.dtype == np.float32
    close = np.abs(timg - jimg) <= 1.0
    assert close.mean() >= 0.995, close.mean()
    both = (jdepth > 0) & (tdepth > 0)
    assert both.mean() > 0.99
    np.testing.assert_array_equal(jdepth > 0, tdepth > 0)
    np.testing.assert_allclose(tdepth[both], jdepth[both], atol=1e-4)


def test_render_device_wire_encoding(renders):
    (jimg, jdepth), _, (u8, u16) = renders
    assert u8.dtype == np.uint8 and u16.dtype == np.uint16
    ref8 = np.clip(jimg, 0, 255).astype(np.uint8)
    assert (np.abs(u8.astype(int) - ref8.astype(int)) <= 1).mean() >= 0.995
    ref16 = np.clip(jdepth * 1000.0, 0, 65535).astype(np.uint16)
    assert (np.abs(u16.astype(int) - ref16.astype(int)) <= 1).all()
