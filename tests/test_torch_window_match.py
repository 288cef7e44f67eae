"""The fused window matcher: ``cuda_hamming.window_match`` against the JAX
package's masked dense Hamming best-2, on the cases of
``ops/pallas_selfcheck.py`` (run_selfcheck, run_golden), and the port's
``match_local_points`` against the JAX non-Pallas path.

On the CPU the wrapper runs its plain version; the kernel itself is checked
against that plain version on the card (``tests/test_torch_cuda.py`` and
chip_smoke.py).  All results are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.frontend import tracking_kernels as JTK
from refactored_orb_slam2_tpu.frontend.frame import FrameData as JFrame
from refactored_orb_slam2_tpu.ops import descriptors as jdesc
from refactored_orb_slam2_tpu.ops import matching as jm
from refactored_orb_slam2_tpu_torch.frontend import tracking_kernels as TTK
from refactored_orb_slam2_tpu_torch.io.convert import frame_from_numpy
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming


def _case(name):
    """(args as numpy, band) for the JAX self-check cases."""
    if name == "selfcheck":      # pallas_selfcheck.run_selfcheck
        rng = np.random.default_rng(1)
        nq, nt = 512, 1024
        q = rng.integers(0, 2**32, (nq, 8), dtype=np.uint32)
        t = rng.integers(0, 2**32, (nt, 8), dtype=np.uint32)
        uv_q = rng.uniform(0, 640, (nq, 2)).astype(np.float32)
        uv_t = rng.uniform(0, 640, (nt, 2)).astype(np.float32)
        radius = np.full(nq, 60.0, np.float32)
        lq = rng.integers(0, 8, nq).astype(np.int32)
        lt = rng.integers(0, 8, nt).astype(np.int32)
        return (q, t, uv_q, uv_t, radius, lq, lt, np.ones(nq, bool),
                np.ones(nt, bool)), (-1, 0)
    rng = np.random.default_rng(0)  # pallas_selfcheck.run_golden
    n1, n2 = 256, 384
    a = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    uvq = rng.uniform(0, 640, (n1, 2)).astype(np.float32)
    uvt = rng.uniform(0, 640, (n2, 2)).astype(np.float32)
    rad = rng.uniform(30, 120, n1).astype(np.float32)
    oq = rng.integers(0, 8, n1).astype(np.int32)
    ot = rng.integers(0, 8, n2).astype(np.int32)
    vq = rng.random(n1) < 0.9
    vt = rng.random(n2) < 0.9
    return (a, b, uvq, uvt, rad, oq, ot, vq, vt), (-1, 1)


def _torch_args(args, device="cpu"):
    out = [torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(device) for a in args]
    return tuple(out)


def _jax_best2(args, band):
    q, t, uq, ut, r, lq, lt, vq, vt = (jnp.asarray(a) for a in args)
    geo = jm.window_mask(uq, ut, r) & jm.octave_band_mask(lq, lt, *band)
    mask = geo & vq[:, None] & vt[None, :]
    return tuple(np.array(x) for x in jm.masked_best2(jdesc.hamming(q, t), mask))


@pytest.mark.parametrize("name", ["selfcheck", "golden"])
def test_window_match_cpu_equals_jax_masked_best2(name):
    args, band = _case(name)
    d1r, i1r, d2r = _jax_best2(args, band)
    d1, i1, d2 = (x.numpy() for x in cuda_hamming.window_match(*_torch_args(args), band))
    np.testing.assert_array_equal(d1, d1r)
    np.testing.assert_array_equal(d2, d2r)
    uniq = d1r < d2r
    np.testing.assert_array_equal(i1[uniq], i1r[uniq])
    # the lowest column wins ties on both sides, so i1 is equal everywhere
    np.testing.assert_array_equal(i1, i1r)
    for ratio in (0.7, 0.9):
        gate = lambda a, b: (a <= 256) & (a.astype(np.float32) < ratio * b.astype(np.float32))
        np.testing.assert_array_equal(gate(d1, d2), gate(d1r, d2r))
    assert (d1r < jm.BIG).sum() > 0


def test_window_match_checks_its_inputs():
    args, band = _case("golden")
    targs = list(_torch_args(args))
    bad = list(targs)
    bad[4] = bad[4].double()
    with pytest.raises(TypeError):
        cuda_hamming.window_match(*bad, band)
    bad = list(targs)
    bad[6] = bad[6][:-1]
    with pytest.raises(ValueError):
        cuda_hamming.window_match(*bad, band)
    with pytest.raises(ValueError):
        cuda_hamming.window_match(*(a.to("meta") for a in targs), band)


def test_window_match_counts_only_kernel_launches():
    args, band = _case("golden")
    before = cuda_hamming.launches["window_match"]
    cuda_hamming.window_match(*_torch_args(args), band)
    assert cuda_hamming.launches["window_match"] == before


def _local_problem(seed=3, n_feat=300, budget=512, n_pts=1000):
    """Local points projected near frame features whose descriptors are a
    few bits away from the points' — a matching problem with real hits."""
    rng = np.random.default_rng(seed)
    pt_desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    idx = rng.choice(n_pts, budget, replace=False).astype(np.int32)
    valid = rng.random(budget) < 0.9
    idx = np.where(valid, idx, -1).astype(np.int32)
    uv = rng.uniform(20, 300, (budget, 2)).astype(np.float32)
    pred = rng.integers(0, 4, budget).astype(np.int32)
    view_cos = rng.uniform(0.99, 1.0, budget).astype(np.float32)
    # features: the first n_feat local points seen again with a few flipped bits
    src = np.arange(n_feat)
    desc = pt_desc[np.clip(idx[src], 0, None)].copy()
    flips = rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint32) & \
        rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint32) & \
        rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint32)
    desc ^= flips
    xy = (uv[src] + rng.normal(0, 2.0, (n_feat, 2))).astype(np.float32)
    octave = np.clip(pred[src] - rng.integers(0, 2, n_feat), 0, 3).astype(np.int32)
    f_valid = rng.random(n_feat) < 0.95
    existing = np.where(rng.random(n_feat) < 0.2, rng.integers(0, n_pts, n_feat), -1)
    frame = dict(
        xy=xy, xy_raw=xy, uvr=np.concatenate([xy, -np.ones((n_feat, 1), np.float32)], 1),
        depth=-np.ones(n_feat, np.float32), octave=octave,
        angle=np.zeros(n_feat, np.float32), response=np.zeros(n_feat, np.float32),
        desc=desc, valid=f_valid,
    )
    local = (idx, valid, uv, pred, view_cos)
    return frame, local, pt_desc, existing.astype(np.int32)


def test_match_local_points_equals_jax_xla_path():
    frame, local, pt_desc, existing = _local_problem()
    sf = np.asarray([1.2 ** i for i in range(4)], np.float32)
    jframe = JFrame(**{k: jnp.asarray(v) for k, v in frame.items()})
    jlocal = JTK.LocalPoints(*(jnp.asarray(a) for a in local))
    ref = JTK.match_local_points(jframe, jlocal, jnp.asarray(pt_desc),
                                 jnp.asarray(existing), th=1.0, scale_factors=sf,
                                 use_pallas=False)
    tframe = frame_from_numpy(frame)
    tlocal = TTK.LocalPoints(*(torch.from_numpy(a) for a in local))
    got = TTK.match_local_points(tframe, tlocal,
                                 torch.from_numpy(pt_desc.view(np.int32)),
                                 torch.from_numpy(existing), th=1.0, scale_factors=sf)
    np.testing.assert_array_equal(got.pt_idx.numpy(), np.array(ref.pt_idx))
    assert int(got.n_matches) == int(ref.n_matches)
    assert int(ref.n_matches) > 50      # the problem has real matches
