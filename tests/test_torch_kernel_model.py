"""A numpy model of what the two CUDA Hamming kernels do with a row, held
against ``matching.masked_best2`` of the JAX package and of the port.

The kernels (``csrc/window_match.cu``, ``csrc/masked_best2.cu`` over
``csrc/best2_merge.cuh``) run only on a card.  What they can get wrong
without any card noticing at the usual shapes is arithmetic that runs the
same in numpy: the tie rule carried by keys ``distance << 20 | column``
through 32 lanes and a two-minimum warp merge, the way columns are dealt to
the lanes, the warp's candidate queue, the 16-byte mask words read from an
address aligned down with the head and tail bytes masked off, and the fold
of a later part of the bank into what an earlier part wrote.  The model
below repeats those steps lane by lane with the kernels' constants and
names.  Results are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.ops import matching as jm
from refactored_orb_slam2_tpu_torch.ops import matching as tm

BIG = 1 << 20
COL_BITS = 20
NONE = 2**31 - 1          # kNone: above every key
GROUP = 1024              # kGroup: columns a warp gathers candidates from at a time
MAX_BANK = 8192           # kMaxBank of window_match.cu
BATCH = 2                 # kBatch of masked_best2.cu: 16-byte words a lane holds
LANES = 32


# ---------------------------------------------------------------- best2_merge.cuh
def make_key(d, col):
    return (int(d) << COL_BITS) | int(col)


def push(k1, k2, key):
    return min(k1, key), min(k2, max(k1, key))


def merge(k1, k2, e1, e2):
    return min(k1, e1), min(max(k1, e1), min(k2, e2))


def warp_merge(k1, k2):
    """Two warp-wide minima: the smallest k1, then the smallest of what is
    left (a lane that holds the winner offers its k2, the others their k1)."""
    m1 = min(k1)
    return m1, min(b if a == m1 else a for a, b in zip(k1, k2))


def queue_and_match(mine, offset_of, base, dist_row, k1, k2):
    """``mine[lane]`` is the lane's bit set of candidates.  A scan gives each
    lane its place in the queue, it writes its offsets in rising bit order,
    then lane t takes the entries t, t + 32, ..."""
    cnt = [bin(m).count("1") for m in mine]
    if not any(cnt):
        return
    queue, slot = [None] * GROUP, 0
    for lane in range(LANES):                      # slot = exclusive scan of cnt
        bits = mine[lane]
        while bits:
            bit = (bits & -bits).bit_length() - 1
            off = offset_of(lane, bit)
            assert 0 <= off < GROUP and off < 1 << 16      # a uint16 queue entry
            queue[slot] = off
            slot += 1
            bits &= bits - 1
    total = slot
    assert total == sum(cnt) <= GROUP
    for lane in range(LANES):
        for k in range(lane, total, LANES):
            col = base + queue[k]
            k1[lane], k2[lane] = push(k1[lane], k2[lane], make_key(dist_row[col], col))


def store_row(out, row, first_part, k1, k2):
    if not first_part:
        o1, oi, o2 = (int(out[j, row]) for j in range(3))
        k1, k2 = merge(k1, k2, make_key(o1, oi) if o1 < BIG else NONE,
                       make_key(o2, 0) if o2 < BIG else NONE)
    out[0, row] = BIG if k1 == NONE else k1 >> COL_BITS
    out[1, row] = 0 if k1 == NONE else k1 & ((1 << COL_BITS) - 1)
    out[2, row] = BIG if k2 == NONE else k2 >> COL_BITS


# ---------------------------------------------------------------- window_match.cu
def round32(n):
    return (n + 31) & ~31


def window_model(dist, uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t, lo, hi,
                 max_bank=MAX_BANK):
    n1, n2 = dist.shape
    if hi < lo:
        n2 = 0
    n_banks = -(-n2 // max_bank) if n2 > max_bank else 1
    bank_cols = -(-n2 // n_banks)
    span = hi - lo
    out = np.zeros((3, n1), np.int32)
    f32 = np.float32
    for bank in range(n_banks):
        c0 = bank * bank_cols
        n = min(bank_cols, n2 - c0)
        n32 = round32(n)
        # the block's bank: the padding and the invalid columns get u = NaN
        s_uv = np.zeros((n32, 2), f32)
        s_oct = np.zeros(n32, np.int64)
        for k in range(n32):
            c = c0 + min(k, n - 1)
            ok = k < n and bool(valid_t[c])
            s_uv[k] = (uv_t[c, 0] if ok else np.nan, uv_t[c, 1])
            s_oct[k] = oct_t[c]
        for row in range(n1):
            k1, k2 = [NONE] * LANES, [NONE] * LANES
            if valid_q[row]:
                u, v, r = f32(uv_q[row, 0]), f32(uv_q[row, 1]), f32(radius[row])
                oct_lo = int(oct_q[row]) + lo
                with np.errstate(invalid="ignore"):
                    hit = ((np.abs(u - s_uv[:, 0]) <= r) & (np.abs(v - s_uv[:, 1]) <= r)
                           # one unsigned compare for lo <= oct_t - oct_q <= hi
                           & (((s_oct - oct_lo) & 0xFFFFFFFF) <= span))
                for g in range(0, n32, GROUP):
                    steps = min(GROUP, n32 - g) >> 5
                    mine = [sum(int(hit[g + 32 * s + lane]) << s for s in range(steps))
                            for lane in range(LANES)]
                    queue_and_match(mine, lambda lane, s: 32 * s + lane, c0 + g,
                                    dist[row], k1, k2)
            store_row(out, row, bank == 0, *warp_merge(k1, k2))
    return out


# ---------------------------------------------------------------- masked_best2.cu
def nonzero4(v):
    """Bit b set iff byte b of the 32-bit word is not zero."""
    top = (((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v) & 0x80808080
    return (((top >> 7) * 0x01020408) & 0xFFFFFFFF) >> 24


def nonzero_bytes(word16):
    x, y, z, w = (int.from_bytes(word16[4 * i:4 * i + 4].tobytes(), "little")
                  for i in range(4))
    return nonzero4(x) | (nonzero4(y) << 4) | (nonzero4(z) << 8) | (nonzero4(w) << 12)


def valid_bytes(p0, n):
    lo, hi = min(max(-p0, 0), 16), min(max(n - p0, 0), 16)
    return ((1 << hi) - 1) & ~((1 << lo) - 1) if hi > lo else 0


def masked_model(dist, memory, first_byte):
    """``memory`` is device memory as bytes (index = address, so index 0 is
    16-byte aligned); the (n1, n2) mask starts at ``first_byte``."""
    n1, n2 = dist.shape
    out = np.zeros((3, n1), np.int32)
    for row in range(n1):
        first = first_byte + row * n2
        head = first & 15
        word0, n_words = first - head, (head + n2 + 15) >> 4
        assert word0 + 16 * n_words <= len(memory)
        k1, k2 = [NONE] * LANES, [NONE] * LANES
        for g in range(0, n_words, LANES * BATCH):
            base = 16 * g - head
            mine = []
            for lane in range(LANES):
                bits = 0
                for j in range(BATCH):
                    idx = g + 32 * j + lane
                    word = (memory[word0 + 16 * idx:word0 + 16 * idx + 16]
                            if idx < n_words else np.zeros(16, np.uint8))
                    bits |= (nonzero_bytes(word)
                             & valid_bytes(base + 512 * j + 16 * lane, n2)) << (16 * j)
                mine.append(bits)
            queue_and_match(mine, lambda lane, bit: 512 * (bit >> 4) + 16 * lane + (bit & 15),
                            base, dist[row], k1, k2)
        store_row(out, row, True, *warp_merge(k1, k2))
    return out


# ---------------------------------------------------------------- inputs
def _hamming(a, b):
    x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return np.unpackbits(x, axis=-1).sum(-1).astype(np.int32)


def _descriptors(rng, n1, n2):
    """A bank drawn from 5 descriptors and their one-bit neighbours, so that
    most rows have several columns tied at the best and at the second best."""
    pool = rng.integers(0, 2**32, (5, 8), dtype=np.uint32)
    pool = np.concatenate([pool, pool ^ np.uint32(1), pool ^ np.uint32(2)])
    return pool[rng.integers(0, 15, n1)], pool[rng.integers(0, 15, n2)]


def _reference(dist, mask):
    """masked_best2 of the JAX package and of the port, which must agree."""
    ref = np.stack([np.array(x) for x in jm.masked_best2(jnp.asarray(dist),
                                                         jnp.asarray(mask))])
    port = np.stack([x.numpy() for x in tm.masked_best2(torch.from_numpy(dist),
                                                        torch.from_numpy(mask))])
    np.testing.assert_array_equal(port, ref)
    return ref


N2S = [1, 7, 31, 32, 33, 1000, 1031]


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("n2", N2S)
@pytest.mark.parametrize("first_byte", [0, 5, 16 + 13])
def test_masked_kernel_model_equals_masked_best2(n2, first_byte):
    rng = np.random.default_rng(100 * n2 + first_byte)
    n1 = 20
    a, b = _descriptors(rng, n1, n2)
    mask = rng.random((n1, n2)) < (0.5 if n2 < 100 else 0.04)
    mask[[3, 11]] = False                                  # rows with no candidate
    mask[7] = True                                         # a row with every column
    mask[5] = False
    mask[5, n2 - 1] = True                                 # only the last column
    mask[6] = False
    mask[6, 0] = True                                      # only the first column
    dist = _hamming(a, b)
    # the bytes before the first row and after the last are somebody else's
    memory = np.full(first_byte + n1 * n2 + 32, 0xFF, np.uint8)
    memory[first_byte:first_byte + n1 * n2] = mask.ravel()
    got = masked_model(dist, memory, first_byte)
    ref = _reference(dist, mask)
    np.testing.assert_array_equal(got, ref)
    assert (ref[0, [3, 11]] == BIG).all() and (ref[1, [3, 11]] == 0).all()
    assert ref[1, 5] == n2 - 1 and ref[1, 6] == 0
    if n2 >= 31:
        assert (ref[0] == ref[2]).sum() >= 3               # ties at the best


@pytest.mark.parametrize("n2", N2S)
@pytest.mark.parametrize("band", [(-1, 0), (-1, 1)])
def test_window_kernel_model_equals_masked_best2(n2, band):
    rng = np.random.default_rng(7 * n2 + band[1])
    n1 = 20
    a, b = _descriptors(rng, n1, n2)
    uv_q = rng.uniform(0, 64, (n1, 2)).astype(np.float32)
    uv_t = rng.uniform(0, 64, (n2, 2)).astype(np.float32)
    radius = rng.uniform(8, 40, n1).astype(np.float32)
    radius[4] = 1000.0                                     # a row that sees every column
    oct_q = rng.integers(0, 4, n1).astype(np.int32)
    oct_t = rng.integers(0, 4, n2).astype(np.int32)
    valid_q = rng.random(n1) < 0.9
    valid_t = rng.random(n2) < 0.9
    valid_q[[2, 9]] = False
    valid_q[4] = True
    dist = _hamming(a, b)
    mask = (np.array(jm.window_mask(jnp.asarray(uv_q), jnp.asarray(uv_t), jnp.asarray(radius)))
            & np.array(jm.octave_band_mask(jnp.asarray(oct_q), jnp.asarray(oct_t), *band))
            & valid_q[:, None] & valid_t[None, :])
    ref = _reference(dist, mask)
    got = window_model(dist, uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t, *band)
    np.testing.assert_array_equal(got, ref)
    assert (ref[0, [2, 9]] == BIG).all()
    if n2 >= 31:
        assert (ref[0] < BIG).sum() >= 10


@pytest.mark.parametrize("n2,max_bank", [(33, 32), (1000, 96), (1031, 512), (64, 32)])
def test_window_kernel_model_folds_the_parts_of_a_large_bank(n2, max_bank):
    """A bank larger than a block holds is worked on in equal parts; a later
    part folds its best-2 into what the earlier parts wrote.  Ties across
    parts must still go to the lowest column."""
    rng = np.random.default_rng(n2 + max_bank)
    n1 = 16
    a, b = _descriptors(rng, n1, n2)
    uv_q = rng.uniform(0, 64, (n1, 2)).astype(np.float32)
    uv_t = rng.uniform(0, 64, (n2, 2)).astype(np.float32)
    radius = np.full(n1, 30.0, np.float32)
    radius[:4] = [0.0, 1000.0, 1000.0, 2.0]
    zeros = np.zeros(max(n1, n2), np.int32)
    valid_q, valid_t = np.ones(n1, bool), rng.random(n2) < 0.9
    dist = _hamming(a, b)
    mask = (np.array(jm.window_mask(jnp.asarray(uv_q), jnp.asarray(uv_t), jnp.asarray(radius)))
            & valid_t[None, :])
    ref = _reference(dist, mask)
    got = window_model(dist, uv_q, uv_t, radius, zeros[:n1], zeros[:n2], valid_q, valid_t,
                       0, 0, max_bank=max_bank)
    np.testing.assert_array_equal(got, ref)
    assert (ref[0, 1:3] == ref[2, 1:3]).all()              # the open rows end in a tie


def test_window_kernel_model_empty_band_has_no_candidate():
    rng = np.random.default_rng(0)
    a, b = _descriptors(rng, 4, 40)
    uv = np.zeros((40, 2), np.float32)
    ones = np.ones(40, bool)
    got = window_model(_hamming(a, b), uv[:4], uv, np.full(4, 9.0, np.float32),
                       np.zeros(4, np.int32), np.zeros(40, np.int32), ones[:4], ones, 1, 0)
    assert (got[0] == BIG).all() and (got[1] == 0).all() and (got[2] == BIG).all()


def test_nonzero_bytes_and_valid_bytes_arithmetic():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 256, (200, 16)).astype(np.uint8)
    words[rng.random((200, 16)) < 0.5] = 0
    words[0], words[1], words[2] = 0, 0xFF, 0x80
    words[3] = np.tile([1, 0, 0x7F, 0x80], 4)
    for w in words:
        want = sum(1 << i for i in range(16) if w[i])
        assert nonzero_bytes(w) == want
    for p0 in range(-40, 60):
        for n in (0, 1, 7, 16, 17, 33):
            want = sum(1 << i for i in range(16) if 0 <= p0 + i < n)
            assert valid_bytes(p0, n) == want


@pytest.mark.parametrize("seed", range(4))
def test_warp_merge_keeps_the_two_smallest_keys(seed):
    """Lanes hold the two smallest keys of disjoint sets in any order of
    arrival; two minima give the two smallest of the union, so a tie at the
    distance goes to the lowest column and d2 = d1 when two columns tie."""
    rng = np.random.default_rng(seed)
    cols = rng.permutation(400)[:rng.integers(0, 200)]
    keys = [make_key(rng.integers(0, 4), c) for c in cols]
    k1, k2 = [NONE] * LANES, [NONE] * LANES
    for key in keys:
        lane = int(rng.integers(0, 3 if seed == 0 else LANES))
        k1[lane], k2[lane] = push(k1[lane], k2[lane], key)
    want = sorted(keys) + [NONE, NONE]
    assert warp_merge(k1, k2) == (want[0], want[1])
