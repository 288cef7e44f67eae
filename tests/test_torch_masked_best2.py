"""The masked best-2 matcher: ``cuda_hamming.hamming_best2`` (the port of
``pallas_hamming.py::hamming_best2_pallas``) against the JAX package's
``masked_best2(hamming(a, b), mask)``, which is what that kernel computes
off the TPU, on random, banded, empty-row, ragged and tie cases; and
``matching.nn_match_desc`` against the JAX non-mutual ``nn_match``.

On the CPU the wrapper runs its plain version; the kernel itself is held
against that plain version on the card (``tests/test_torch_cuda.py`` and
chip_smoke.py).  All results are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.ops import descriptors as jdesc
from refactored_orb_slam2_tpu.ops import matching as jm
from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
from refactored_orb_slam2_tpu_torch.ops import matching as tm


def masked_case(name: str, seed: int = 0):
    """(desc_a uint32 (N1, 8), desc_b uint32 (N2, 8), mask (N1, N2) bool)."""
    rng = np.random.default_rng(seed)
    words = lambda n: rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    if name == "random":                        # a 30%-dense mask
        a, b = words(300), words(500)
        mask = rng.random((300, 500)) < 0.3
    elif name == "banded":                      # like an epipolar band
        a, b = words(400), words(400)
        i, j = np.meshgrid(np.arange(400), np.arange(400), indexing="ij")
        mask = np.abs(i - j + rng.integers(-5, 6, (400, 1))) <= 20
    elif name == "empty_rows":                  # rows and columns with no candidate
        a, b = words(200), words(300)
        mask = rng.random((200, 300)) < 0.5
        mask[rng.choice(200, 30, replace=False)] = False
        mask[:, rng.choice(300, 40, replace=False)] = False
    elif name == "ragged":                      # sizes off every tile
        a, b = words(77), words(131)
        mask = rng.random((77, 131)) < 0.5
    elif name == "ties":                        # duplicated descriptors
        b = words(64)
        b = np.concatenate([b, b, b[:30]])      # every column has twins
        a = np.concatenate([b[rng.choice(64, 50)], words(40)])
        a[50:60] ^= np.uint32(1)                # one bit away from a twin pair
        mask = rng.random((90, 158)) < 0.7
    else:
        raise ValueError(name)
    return a, b, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a))


CASES = ["random", "banded", "empty_rows", "ragged", "ties"]


@pytest.mark.parametrize("name", CASES)
def test_hamming_best2_cpu_equals_jax_masked_best2(name):
    a, b, mask = masked_case(name)
    ref = [np.array(x) for x in jm.masked_best2(
        jdesc.hamming(jnp.asarray(a), jnp.asarray(b)), jnp.asarray(mask))]
    got = [x.numpy() for x in cuda_hamming.hamming_best2(_t(a), _t(b), _t(mask))]
    for g, r in zip(got, ref):
        assert g.dtype == np.int32 and g.shape == (a.shape[0],)
        np.testing.assert_array_equal(g, r)
    d1, i1, d2 = got
    empty = ~mask.any(axis=1)
    assert (d1[empty] == tm.BIG).all() and (d2[empty] == tm.BIG).all()
    assert (i1[empty] == 0).all()
    if name == "empty_rows":
        assert empty.sum() >= 30
    if name == "ties":
        assert (d1 == d2).sum() > 20           # ties at the best: d2 = d1


@pytest.mark.parametrize("max_dist,ratio", [(50, 1.0), (100, 0.9), (256, 0.75)])
def test_nn_match_desc_equals_jax_nn_match(max_dist, ratio):
    rng = np.random.default_rng(5)
    a, b, mask = masked_case("ties", seed=5)
    row_valid = rng.random(a.shape[0]) < 0.9
    col_valid = rng.random(b.shape[0]) < 0.9
    ref = jm.nn_match(jdesc.hamming(jnp.asarray(a), jnp.asarray(b)),
                      row_valid=jnp.asarray(row_valid), col_valid=jnp.asarray(col_valid),
                      extra_mask=jnp.asarray(mask), max_dist=max_dist, ratio=ratio)
    got = tm.nn_match_desc(_t(a), _t(b), row_valid=_t(row_valid), col_valid=_t(col_valid),
                           extra_mask=_t(mask), max_dist=max_dist, ratio=ratio)
    for name in ("idx", "dist", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.array(getattr(ref, name)))
    assert int(got.mask.sum()) > 0


def test_hamming_best2_checks_inputs_and_counts_only_launches():
    a, b, mask = (_t(x) for x in masked_case("ragged"))
    before = dict(cuda_hamming.launches)
    cuda_hamming.hamming_best2(a, b, mask)
    assert cuda_hamming.launches == before      # the CPU runs the plain version
    with pytest.raises(TypeError):
        cuda_hamming.hamming_best2(a, b, mask.to(torch.uint8))
    with pytest.raises(ValueError):
        cuda_hamming.hamming_best2(a, b, mask[:, :-1])
    with pytest.raises(ValueError):
        cuda_hamming.hamming_best2(a[:, :4], b, mask)
    with pytest.raises(ValueError):
        cuda_hamming.hamming_best2(a.to("meta"), b.to("meta"), mask.to("meta"))
