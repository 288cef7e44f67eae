"""``ops.stereo.stereo_match`` and ``build_frame_stereo`` against the JAX
package on one rendered 320x240 stereo pair (``SyntheticWorld`` seed 4,
noise seed 2: the ``tests/test_e2e.py`` stereo scenario's first frame; 500
features, 4 levels, bf 80).

Two ways in:

- the same inputs through both ``stereo_match`` (the JAX package's feature
  banks and stacked pyramids, carried across by ``io/convert.py``): the
  ``valid`` mask must be equal, ``u_right`` within 1e-3 px and ``depth``
  within 1e-4 relative.  ``u_right`` moves by a whole pixel of its level
  when the matched column or the best SAD shift differs, so these bounds
  also hold the descriptor match and ``best_inc`` equal;
- each package's own ``build_frame_stereo`` from the two images.  Pyramid
  levels above 0 are float32 products summed in another order (within 1e-4
  of 255), so a SAD value can differ in its last digits and flip an
  ``argmin`` or the median gate on a near tie: at most 1% of the features
  may differ in ``valid`` or by more than the bounds above.  Measured on
  this pair: none differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.frontend import frame as jframe
from refactored_orb_slam2_tpu.geometry.camera import Camera as JCamera
from refactored_orb_slam2_tpu.ops import image as jimage
from refactored_orb_slam2_tpu.ops import orb as jorb
from refactored_orb_slam2_tpu.ops import stereo as jstereo
from refactored_orb_slam2_tpu.utils.config import ORBConfig
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from refactored_orb_slam2_tpu_torch.frontend import frame as tframe
from refactored_orb_slam2_tpu_torch.geometry.camera import Camera as TCamera
from refactored_orb_slam2_tpu_torch.io.convert import (
    config_from_reference, orb_features_from_numpy,
)
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
from refactored_orb_slam2_tpu_torch.ops import stereo as tstereo

CAM = dict(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=80.0, width=320, height=240)
ORB = ORBConfig(n_features=500, n_levels=4)
T_ORB = config_from_reference(ORB)
U_TOL_PX = 1e-3
DEPTH_RTOL = 1e-4
MAX_DIFFERENT_SHARE = 0.01


@pytest.fixture(scope="module")
def pair():
    world = SyntheticWorld.create(seed=4, n_points=500, x_range=(-6, 6),
                                  y_range=(-2.5, 2.5), z_range=(2.5, 10.0), clear_tube=0.0)
    left, right = world.render_stereo(np.eye(4, dtype=np.float32), JCamera.create(**CAM),
                                      noise=2.0, rng=np.random.default_rng(2))
    u8 = lambda im: np.clip(im, 0, 255).astype(np.uint8).astype(np.float32)
    return u8(left), u8(right)


@pytest.fixture(scope="module")
def jax_parts(pair):
    """The JAX package's banks, stacks and match result for the pair."""
    kw = dict(n_features=ORB.n_features, n_levels=ORB.n_levels,
              scale_factor=ORB.scale_factor, ini_th=ORB.ini_th_fast, min_th=ORB.min_th_fast)
    extract = jax.jit(lambda im: jorb.extract_orb(im, **kw))
    feats = [extract(jnp.asarray(im)) for im in pair]
    stacks, offs = [], None
    for im in pair:
        stack, offs = jstereo.stack_pyramid(
            jimage.build_pyramid(jnp.asarray(im), ORB.n_levels, ORB.scale_factor))
        stacks.append(stack)
    sf = jimage.scale_factors(ORB.n_levels, ORB.scale_factor)
    res = jstereo.stereo_match(feats[0], feats[1], stacks[0], stacks[1], offs, sf,
                               fx=CAM["fx"], bf=CAM["bf"], min_z=CAM["bf"] / CAM["fx"])
    to_np = lambda x: jax.tree.map(np.asarray, x)
    return ([to_np(f)._asdict() for f in feats], [np.asarray(s) for s in stacks], offs, sf,
            to_np(res))


def _different(j_valid, j_u, j_depth, t_valid, t_u, t_depth):
    """Per-feature mask: valid differs, or a value is outside its bound."""
    both = j_valid & t_valid
    return ((j_valid != t_valid)
            | (both & (np.abs(j_u - t_u) > U_TOL_PX))
            | (both & (np.abs(j_depth - t_depth) > DEPTH_RTOL * np.abs(j_depth))))


def test_stereo_match_equal_on_the_same_inputs(jax_parts):
    feats, stacks, offs, sf, ref = jax_parts
    left, right = (orb_features_from_numpy(f) for f in feats)
    calls = []
    best2 = cuda_hamming.hamming_best2
    cuda_hamming.hamming_best2 = lambda *a: calls.append(a[2].shape) or best2(*a)
    try:
        got = tstereo.stereo_match(left, right, torch.from_numpy(stacks[0].copy()),
                                   torch.from_numpy(stacks[1].copy()), offs, sf,
                                   fx=CAM["fx"], bf=CAM["bf"], min_z=CAM["bf"] / CAM["fx"])
    finally:
        cuda_hamming.hamming_best2 = best2
    n = feats[0]["xy"].shape[0]
    assert calls == [(n, n)]          # one masked best-2 search per stereo frame
    assert int(ref.valid.sum()) > 100
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    diff = _different(ref.valid, ref.u_right, ref.depth,
                      got.valid.numpy(), got.u_right.numpy(), got.depth.numpy())
    assert not diff.any()
    # invalid slots carry -1 in both
    assert (got.u_right.numpy()[~ref.valid] == -1).all()
    assert (got.depth.numpy()[~ref.valid] == -1).all()


def test_patch_gather_clamps_like_dynamic_slice():
    """A start index past the last full patch is clamped so the patch stays
    inside the stack, as ``jax.lax.dynamic_slice`` does (``stereo_match``
    clips negative starts to 0 before either gather)."""
    stack = np.arange(40 * 50, dtype=np.float32).reshape(40, 50)
    ys, xs = np.array([38, 0, 35, 29]), np.array([49, 45, 0, 39])
    ref = jax.vmap(lambda y, x: jstereo._gather_patch(jnp.asarray(stack), y, x, 11, 11))(
        jnp.asarray(ys), jnp.asarray(xs))
    y0 = torch.clamp(torch.from_numpy(ys), 0, 40 - 11)
    x0 = torch.clamp(torch.from_numpy(xs), 0, 50 - 11)
    got = tstereo._gather_patches(torch.from_numpy(stack), y0, x0, 11, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_build_frame_stereo_matches_jax(pair):
    jcam, tcam = JCamera.create(**CAM), TCamera.create(**CAM)
    build = jax.jit(lambda l, r: jframe.build_frame_stereo(l, r, jcam, ORB))
    jf = jax.tree.map(np.asarray, build(jnp.asarray(pair[0]), jnp.asarray(pair[1])))
    tf = tframe.build_frame_stereo(torch.from_numpy(pair[0]), torch.from_numpy(pair[1]),
                                   tcam, T_ORB)
    np.testing.assert_array_equal(tf.valid.numpy(), jf.valid)
    np.testing.assert_array_equal(tf.octave.numpy(), jf.octave)
    j_ok, t_ok = jf.depth > 0, tf.depth.numpy() > 0
    diff = _different(j_ok, jf.uvr[:, 2], jf.depth, t_ok, tf.uvr[:, 2].numpy(), tf.depth.numpy())
    n_valid = int(jf.valid.sum())
    assert int(j_ok.sum()) > 100
    print(f"build_frame_stereo: {int(diff.sum())} of {n_valid} features differ")
    assert diff.sum() <= MAX_DIFFERENT_SHARE * n_valid, (int(diff.sum()), n_valid)
    # a stereo frame's right coordinate and depth go together
    u_r = tf.uvr[:, 2].numpy()
    assert ((u_r >= 0) == t_ok).all()
    np.testing.assert_allclose(tf.xy.numpy()[jf.valid], jf.xy[jf.valid], atol=1e-4)


def test_build_frame_mono_matches_jax(pair):
    jcam, tcam = JCamera.create(**CAM), TCamera.create(**CAM)
    jf = jax.tree.map(np.asarray, jax.jit(
        lambda im: jframe.build_frame_mono(im, jcam, ORB))(jnp.asarray(pair[0])))
    tf = tframe.build_frame_mono(torch.from_numpy(pair[0]), tcam, T_ORB)
    np.testing.assert_array_equal(tf.valid.numpy(), jf.valid)
    np.testing.assert_array_equal(tf.desc.numpy().view(np.uint32)[jf.valid], jf.desc[jf.valid])
    np.testing.assert_allclose(tf.xy.numpy()[jf.valid], jf.xy[jf.valid], atol=1e-4)
    assert (tf.depth.numpy() == -1).all() and (tf.uvr[:, 2].numpy() == -1).all()
    assert (jf.depth == -1).all() and (jf.uvr[:, 2] == -1).all()
