"""ORB extraction and the RGB-D frame build against the JAX package, on one
rendered 320x240 frame of the room fixture (500 features, 4 levels).

Level 0 is integer-valued, so its FAST score map, NMS and cell fallback must
be equal.  Above level 0 the pyramid is a float32 product whose summation
order differs between the two libraries (within 1e-4 of 255), which can move
a FAST score across a threshold; keypoints and descriptors are therefore
held to >= 99% equal slots.  Measured on this frame: 100% of valid slots
equal in (octave, integer x, integer y) and 100% of descriptors bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.frontend import frame as jframe
from refactored_orb_slam2_tpu.geometry.camera import Camera as JCamera
from refactored_orb_slam2_tpu.ops import fast as jfast
from refactored_orb_slam2_tpu.ops import image as jimage
from refactored_orb_slam2_tpu.ops import orb as jorb
from refactored_orb_slam2_tpu.ops import stereo as jstereo
from refactored_orb_slam2_tpu.utils.config import ORBConfig
from refactored_orb_slam2_tpu_torch.frontend import frame as tframe
from refactored_orb_slam2_tpu_torch.geometry.camera import Camera as TCamera
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.ops import fast as tfast
from refactored_orb_slam2_tpu_torch.ops import image as timage
from refactored_orb_slam2_tpu_torch.ops import orb as torb
from refactored_orb_slam2_tpu_torch.ops import stereo as tstereo
from refactored_orb_slam2_tpu_torch.utils import world3d as W

CAM = dict(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0, width=320, height=240)
ORB = ORBConfig(n_features=500, n_levels=4)
T_ORB = config_from_reference(ORB)       # the port's own ORBConfig
# the float32 pyramid: products of 320 weights in another order (units of
# intensity, range 0-255)
PYR_TOL = 1e-4
MIN_EQUAL_SHARE = 0.99


@pytest.fixture(scope="module")
def scene():
    cam = TCamera.create(**CAM)
    world = W.scene_room(seed=11)
    T = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[0]
    img, depth = world.render(T, cam, want_depth=True, noise=2.0,
                              rng=np.random.default_rng(0))
    img = np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)
    build = jax.jit(lambda im, d: jframe.build_frame_rgbd(im, d, JCamera.create(**CAM), ORB))
    jf = jax.tree.map(np.array, build(jnp.asarray(img), jnp.asarray(depth)))
    tf = tframe.build_frame_rgbd(torch.from_numpy(img), torch.from_numpy(depth), cam, T_ORB)
    tf = {k: v.numpy() for k, v in vars(tf).items()}
    return img, depth, jf, tf


def test_level_quotas_match():
    for args in ((1000, 8, 1.2), (500, 4, 1.2), (1200, 8, 1.2)):
        assert torb.level_quotas(*args) == jorb.level_quotas(*args)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_pyramid_and_blur_within_tolerance(scene, level):
    img = scene[0]
    jp = jimage.build_pyramid(jnp.asarray(img), 4, 1.2)[level]
    tp = timage.build_pyramid(torch.from_numpy(img), 4, 1.2)[level]
    assert tuple(tp.shape) == jp.shape
    np.testing.assert_allclose(tp.numpy(), np.array(jp), atol=PYR_TOL)
    np.testing.assert_allclose(timage.gaussian_blur(tp).numpy(),
                               np.array(jimage.gaussian_blur(jp)), atol=PYR_TOL)
    if level == 0:
        np.testing.assert_array_equal(tp.numpy(), np.array(jp))


def test_level0_fast_nms_and_fallback_equal(scene):
    img = scene[0]
    js = np.array(jfast.fast_score(jnp.asarray(img)))
    ts = tfast.fast_score(torch.from_numpy(img))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tfast.nonmax_suppress_3x3(ts).numpy(),
                                  np.array(jfast.nonmax_suppress_3x3(jnp.asarray(js))))
    np.testing.assert_array_equal(
        tfast.cell_fallback_mask(ts > 20, ts > 7).numpy(),
        np.array(jfast.cell_fallback_mask(jnp.asarray(js > 20), jnp.asarray(js > 7))))


def test_stack_pyramid_and_uright_match(scene):
    img = scene[0]
    jp = jimage.build_pyramid(jnp.asarray(img), 4, 1.2)
    js, joff = jstereo.stack_pyramid(jp)
    ts, toff = tstereo.stack_pyramid([torch.from_numpy(np.array(p)) for p in jp])
    np.testing.assert_array_equal(ts.numpy(), np.array(js))
    np.testing.assert_array_equal(toff, joff)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    d = np.where(rng.random(50) < 0.7, rng.uniform(0.3, 5, 50), -1).astype(np.float32)
    # one float32 division, which XLA may lower differently: 1 ulp
    np.testing.assert_allclose(
        tstereo.depth_to_uright(torch.from_numpy(xy), torch.from_numpy(d), 20.0).numpy(),
        np.array(jstereo.depth_to_uright(jnp.asarray(xy), jnp.asarray(d), np.float32(20.0))),
        rtol=2e-7, atol=1e-5)


def _same_keypoint(jf, tf):
    return ((jf.octave == tf["octave"])
            & (np.floor(jf.xy_raw) == np.floor(tf["xy_raw"])).all(axis=1))


def test_keypoints_match(scene):
    _, _, jf, tf = scene
    np.testing.assert_array_equal(tf["valid"], jf.valid)
    v = jf.valid
    assert v.sum() > 0.9 * 500
    same = _same_keypoint(jf, tf)
    assert same[v].mean() >= MIN_EQUAL_SHARE, same[v].mean()
    # level 0 is integer-exact
    lv0 = v & (jf.octave == 0)
    assert same[lv0].all()
    np.testing.assert_allclose(tf["xy_raw"][v & same], jf.xy_raw[v & same], atol=1e-3)


def test_descriptors_and_angles_match(scene):
    _, _, jf, tf = scene
    v = jf.valid & _same_keypoint(jf, tf)
    desc_eq = (tf["desc"].view(np.uint32) == jf.desc).all(axis=1)
    assert desc_eq[v].mean() >= MIN_EQUAL_SHARE, desc_eq[v].mean()
    lv0 = v & (jf.octave == 0)
    assert desc_eq[lv0].all()
    np.testing.assert_array_equal(tf["angle"][lv0], jf.angle[lv0])
    # degrees; float32 moments summed in another order above level 0
    np.testing.assert_allclose(tf["angle"][v], jf.angle[v], atol=1e-2)


def test_frame_depth_and_edge_rejection_equal(scene):
    _, depth, jf, tf = scene
    v = _same_keypoint(jf, tf)
    np.testing.assert_array_equal(tf["depth"][v], jf.depth[v])
    assert (jf.depth[v & jf.valid] > 0).mean() > 0.5
    # some features sit on occlusion edges and are rejected on both sides
    ys = np.clip(np.round(jf.xy_raw[:, 1]).astype(int), 0, 239)
    xs = np.clip(np.round(jf.xy_raw[:, 0]).astype(int), 0, 319)
    rejected = jf.valid & (depth[ys, xs] > 0) & (jf.depth < 0)
    assert rejected.sum() > 0
    np.testing.assert_allclose(tf["uvr"][v], jf.uvr[v], atol=1e-3)
    np.testing.assert_allclose(tf["xy"][v], jf.xy[v], atol=1e-3)
