"""Parity of the port's primitives with the JAX package: SE(3), camera,
packed descriptors and every function of ops/matching.py.

Inputs come from numpy with a fixed seed and go through both packages on the
CPU.  Integer results must be equal; float results agree within float32
rounding of a few operations (tolerances below).
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.geometry import camera as jcam
from refactored_orb_slam2_tpu.geometry import se3 as jse3
from refactored_orb_slam2_tpu.ops import descriptors as jdesc
from refactored_orb_slam2_tpu.ops import matching as jm
from refactored_orb_slam2_tpu_torch.geometry import camera as tcam
from refactored_orb_slam2_tpu_torch.geometry import se3 as tse3
from refactored_orb_slam2_tpu_torch.ops import descriptors as tdesc
from refactored_orb_slam2_tpu_torch.ops import matching as tm

# One intra-op thread.  At the tests' sizes PyTorch's threads gain nothing,
# and six workers with a thread per core each spin against one another: the
# port's tests took 893 s on 6 workers of an 8-core host with the default
# and 120 s with one thread.  The files that run the port's whole system
# (test_torch_sequence.py and those that import it, test_torch_slice.py,
# test_torch_mapping.py, test_torch_tracking.py) set it themselves.
torch.set_num_threads(1)

# float32 results of a handful of operations in another order: a few ulp
F32_TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return np.array(a)


# ------------------------------------------------------------------ SE(3)
def test_se3_exp_inv_transform_match_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (16, 6)).astype(np.float32)
    xi[0, 3:] = 0.0                       # the small-angle Taylor branch
    xi[1, 3:] = 1e-5
    pts = rng.normal(0, 2, (16, 3)).astype(np.float32)
    Tj = _j(jse3.exp(jnp.asarray(xi)))
    Tt = tse3.exp(_t(xi)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=F32_TOL)
    np.testing.assert_allclose(tse3.inv(_t(Tj)).numpy(), _j(jse3.inv(jnp.asarray(Tj))),
                               atol=F32_TOL * 4)
    np.testing.assert_allclose(
        tse3.transform(_t(Tj), _t(pts)).numpy(),
        _j(jse3.transform(jnp.asarray(Tj), jnp.asarray(pts))), atol=F32_TOL * 8,
    )
    np.testing.assert_array_equal(tse3.hat(_t(xi[:, 3:])).numpy(),
                                  _j(jse3.hat(jnp.asarray(xi[:, 3:]))))
    np.testing.assert_allclose(tse3.so3_exp(_t(xi[:, 3:])).numpy(),
                               _j(jse3.so3_exp(jnp.asarray(xi[:, 3:]))), atol=F32_TOL)
    np.testing.assert_array_equal(tse3.rotation(_t(Tj)).numpy(), Tj[:, :3, :3])
    np.testing.assert_array_equal(tse3.translation(_t(Tj)).numpy(), Tj[:, :3, 3])


def test_se3_to_quaternion_all_branches():
    rng = np.random.default_rng(1)
    phi = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    # rotations by ~pi about each axis hit the three non-trace branches
    phi[:3] = np.eye(3, dtype=np.float32) * 3.1
    R = _j(jse3.so3_exp(jnp.asarray(phi)))
    np.testing.assert_allclose(tse3.to_quaternion(_t(R)).numpy(),
                               _j(jse3.to_quaternion(jnp.asarray(R))), atol=F32_TOL)


# ----------------------------------------------------------------- camera
def test_camera_undistort_and_project_match_jax():
    rng = np.random.default_rng(2)
    kw = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, k1=0.26, k2=-0.95,
              p1=-0.005, p2=0.004, k3=1.16, bf=40.0, width=640, height=480)
    cj, ct = jcam.Camera.create(**kw), tcam.Camera.create(**kw)
    uv = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.undistort_pixels(ct, _t(uv)).numpy(),
                               _j(jcam.undistort_pixels(cj, jnp.asarray(uv))),
                               atol=1e-3)   # px; 10 fixed-point rounds in f32
    pc = rng.normal(0, 1, (200, 3)).astype(np.float32)
    pc[:, 2] = np.abs(pc[:, 2]) + 0.5
    pc[0, 2] = 0.0                        # the z floor
    np.testing.assert_allclose(tcam.project(ct, _t(pc)).numpy(),
                               _j(jcam.project(cj, jnp.asarray(pc))), rtol=F32_TOL)


# ------------------------------------------------------------ descriptors
def _words(rng, n):
    w = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    w[0] = 0xFFFFFFFF                     # sign bit set in every word
    w[1] = 0
    return w


def test_descriptor_int32_view_round_trip_and_unpack():
    rng = np.random.default_rng(3)
    w = _words(rng, 64)
    bits_j = _j(jdesc.unpack_bits(jnp.asarray(w)))
    packed = tdesc.pack_bits(_t(bits_j))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), w)
    np.testing.assert_array_equal(tdesc.unpack_bits(_t(w.view(np.int32))).numpy(), bits_j)
    np.testing.assert_array_equal(
        tdesc.unpack_pm1(_t(w.view(np.int32))).numpy(),
        _j(jdesc.unpack_pm1(jnp.asarray(w), dtype=jnp.float32)),
    )


def test_hamming_and_rowwise_match_jax_popcount():
    rng = np.random.default_rng(4)
    a, b = _words(rng, 70), _words(rng, 90)
    ref = _j(jdesc.hamming_popcount(jnp.asarray(a), jnp.asarray(b)))
    got = tdesc.hamming(_t(a.view(np.int32)), _t(b.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tdesc.hamming_rowwise(_t(a.view(np.int32)), _t(b[:70].view(np.int32))).numpy(),
        _j(jdesc.hamming_rowwise(jnp.asarray(a), jnp.asarray(b[:70]))),
    )


# --------------------------------------------------------------- matching
def _dist_and_mask(seed, n1=60, n2=80, hi=12):
    """Small distance range so ties are frequent."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, hi, (n1, n2)).astype(np.int32)
    mask = rng.random((n1, n2)) < 0.3
    mask[0] = False                       # a row with no candidate
    return rng, dist, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_best2_matches_jax(seed):
    _, dist, mask = _dist_and_mask(seed)
    ref = jm.masked_best2(jnp.asarray(dist), jnp.asarray(mask))
    got = tm.masked_best2(_t(dist), _t(mask))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), _j(r))


@pytest.mark.parametrize("mutual,ratio", [(False, 1.0), (True, 0.9), (True, 1.0)])
def test_nn_match_matches_jax(mutual, ratio):
    rng, dist, mask = _dist_and_mask(5, hi=40)
    rv, cv = rng.random(60) < 0.9, rng.random(80) < 0.9
    kw = dict(max_dist=30, ratio=ratio, mutual=mutual)
    ref = jm.nn_match(jnp.asarray(dist), row_valid=jnp.asarray(rv),
                      col_valid=jnp.asarray(cv), extra_mask=jnp.asarray(mask), **kw)
    got = tm.nn_match(_t(dist), row_valid=_t(rv), col_valid=_t(cv),
                      extra_mask=_t(mask), **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), _j(r))


def _match_result(seed, n1=80, n2=20):
    """Many rows on few columns with tied distances."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n1) < 0.7
    idx = np.where(mask, rng.integers(0, n2, n1), -1).astype(np.int32)
    dist = np.where(mask, rng.integers(0, 5, n1), jm.BIG).astype(np.int32)
    return rng, idx, dist, mask


def test_resolve_duplicates_lowest_row_wins_ties():
    _, idx, dist, mask = _match_result(6)
    ref = jm.resolve_duplicates(jm.MatchResult(jnp.asarray(idx), jnp.asarray(dist),
                                               jnp.asarray(mask)), 20)
    got = tm.resolve_duplicates(tm.MatchResult(_t(idx), _t(dist), _t(mask)), 20)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), _j(r))


@pytest.mark.parametrize("spread", [360.0, 40.0])
def test_rotation_consistency_mask_matches_jax(spread):
    rng, idx, dist, mask = _match_result(7, n1=200, n2=200)
    a = rng.uniform(0, spread, 200).astype(np.float32)
    b = rng.uniform(0, spread, 200).astype(np.float32)
    a[:3] = [0.0, 354.0, 6.0]             # bins at the wrap-around
    ref = jm.rotation_consistency_mask(
        jnp.asarray(a), jnp.asarray(b),
        jm.MatchResult(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(mask)))
    got = tm.rotation_consistency_mask(_t(a), _t(b),
                                       tm.MatchResult(_t(idx), _t(dist), _t(mask)))
    np.testing.assert_array_equal(got.numpy(), _j(ref))


def test_window_and_octave_band_masks_match_jax():
    rng = np.random.default_rng(8)
    uq = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    ut = rng.uniform(0, 100, (70, 2)).astype(np.float32)
    ut[0] = uq[0] + 10.0                  # exactly on the window edge
    r = rng.uniform(5, 30, 50).astype(np.float32)
    r[0] = 10.0
    for radius in (r, np.float32(12.0)):
        np.testing.assert_array_equal(
            tm.window_mask(_t(uq), _t(ut), _t(np.asarray(radius))).numpy(),
            _j(jm.window_mask(jnp.asarray(uq), jnp.asarray(ut), jnp.asarray(radius))))
    lq, lt = rng.integers(0, 8, 50).astype(np.int32), rng.integers(0, 8, 70).astype(np.int32)
    for lo, hi in ((-1, 0), (-1, 1)):
        np.testing.assert_array_equal(
            tm.octave_band_mask(_t(lq), _t(lt), lo, hi).numpy(),
            _j(jm.octave_band_mask(jnp.asarray(lq), jnp.asarray(lt), lo, hi)))


# ---------------------------------------------------------------- imports
def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax or any module of the JAX package, nor cv2 or matplotlib
    (the card's machine has neither: the dataset readers and the fixture
    writer use the port's own PNG codec, ``io/png.py``, and the figures
    import matplotlib inside their functions)."""
    import refactored_orb_slam2_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for module in ("system", "solvers.initializer", "utils.presets", "ops.stereo",
                   "geometry.triangulation", "place.vocab", "place.keyframe_db",
                   "solvers.epnp", "geometry.sim3", "solvers.horn_sim3", "optim.pose_graph",
                   "backend.loop_closing", "io.checkpoint", "io.datasets", "io.viz",
                   "scripts.run_dataset", "bench", "parallel.dist_ba", "parallel.multihost",
                   "scripts.multihost_ba", "scripts.run_scale_demo", "scripts.bench_dist_ba",
                   "scripts.bench_pose_graph", "io.png", "scripts.make_fixture",
                   "scripts.run_synthetic", "utils.synthetic"):
        assert f"refactored_orb_slam2_tpu_torch.{module}" in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = sorted(m for m in sys.modules if m == 'refactored_orb_slam2_tpu'"
        " or m.startswith('refactored_orb_slam2_tpu.'))\n"
        "assert not ref, ref\n"
        "late = sorted(m for m in ('cv2', 'matplotlib') if m in sys.modules)\n"
        "assert not late, late\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
