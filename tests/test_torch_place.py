"""Place recognition, the port against the JAX package on the same inputs:
the packaged vocabulary (4096 words), word assignment, tf-idf signatures,
scores, vocabulary training, the bitwise-majority mean, and the KeyFrameDB
cases of ``tests/test_place.py`` on both packages.

Tolerances: word ids, trained centres, idf, the mean descriptor and every
candidate list equal (integer results, or floats computed from equal
integers); signatures within 1e-6 and scores within 1e-5 (float sums in
another order).  The KeyFrameDB on a JAX-built map's covisibility is held
in ``tests/test_torch_reloc.py``, which builds that map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.ops import descriptors as JD
from refactored_orb_slam2_tpu.place import keyframe_db as JDB
from refactored_orb_slam2_tpu.place import vocab as JV
from refactored_orb_slam2_tpu.utils.config import CameraConfig, ORBConfig
from refactored_orb_slam2_tpu_torch.frontend.frame import build_frame_rgbd
from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference, vocabulary_from_numpy
from refactored_orb_slam2_tpu_torch.ops import descriptors as TD
from refactored_orb_slam2_tpu_torch.place import keyframe_db as TDB
from refactored_orb_slam2_tpu_torch.place import vocab as TV
from refactored_orb_slam2_tpu_torch.system import VOCAB_ASSET
from refactored_orb_slam2_tpu_torch.utils import world3d as W
from test_place import make_descriptor_families

torch.set_num_threads(1)

JAX_ASSET = "refactored_orb_slam2_tpu/assets/vocab.npz"


def _t(a):
    """numpy uint32 words -> the port's int32 words (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _ones(n):
    return jnp.ones(n, bool), torch.ones(n, dtype=torch.bool)


@pytest.fixture(scope="module")
def frames():
    """Descriptors and valid masks of two rendered 320x240 room frames
    (500 features, 4 levels), 10 frames apart on the orbit, from the port's
    ORB extraction (held equal to the JAX package's in test_torch_orb)."""
    cam_cfg = config_from_reference(CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65,
                                                 bf=20.0, width=320, height=240))
    orb = config_from_reference(ORBConfig(n_features=500, n_levels=4))
    cam = camera_from_config(cam_cfg)
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)
    rng = np.random.default_rng(0)
    out = []
    for T in (poses[0], poses[10]):
        img, depth = world.render(T, cam, want_depth=True, noise=2.0, rng=rng)
        f = build_frame_rgbd(torch.from_numpy(np.asarray(img, np.float32)),
                             torch.from_numpy(np.asarray(depth, np.float32)), cam, orb)
        out.append((f.desc, f.valid))
    return out


@pytest.fixture(scope="module")
def vocabs():
    return JV.load_vocabulary(JAX_ASSET), TV.load_vocabulary(VOCAB_ASSET)


def test_word_ids_equal_on_a_rendered_frame(frames, vocabs):
    jv, tv = vocabs
    for desc, valid in frames:
        assert int(valid.sum()) > 300
        w_j = JV.assign_words(jv, jnp.asarray(desc.numpy().view(np.uint32)),
                              jnp.asarray(valid.numpy()))
        w_t = TV.assign_words(tv, desc, valid)
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
        assert (w_t[~valid] == -1).all() and (w_t[valid] >= 0).all()


def test_bow_vector_within_1e6(frames, vocabs):
    jv, tv = vocabs
    for desc, valid in frames:
        ids = TV.assign_words(tv, desc, valid)
        v_t = TV.bow_vector(tv, ids)
        v_j = JV.bow_vector(jv, jnp.asarray(ids.numpy()))
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)
        assert abs(float(v_t.sum()) - 1.0) < 1e-5


def test_bow_score_within_1e5(frames, vocabs):
    jv, tv = vocabs
    sig = [TV.bow_vector(tv, TV.assign_words(tv, d, v)) for d, v in frames]
    s_t = TV.bow_score(sig[0], torch.stack(sig))
    s_j = JV.bow_score(jnp.asarray(sig[0].numpy()), jnp.asarray(torch.stack(sig).numpy()))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    assert abs(float(s_t[0]) - 1.0) < 1e-5 and 0.0 < float(s_t[1]) < 1.0


def test_train_vocabulary_equal_for_the_same_seed():
    rng = np.random.default_rng(0)
    descs, _, _ = make_descriptor_families(rng)
    for n_words, iters, seed in ((32, 6, 0), (48, 3, 5), (700, 2, 1)):   # 700 > N: replace
        jv = JV.train_vocabulary(descs, n_words=n_words, iters=iters, seed=seed)
        tv = TV.train_vocabulary(descs, n_words=n_words, iters=iters, seed=seed)
        np.testing.assert_array_equal(tv.words.numpy().view(np.uint32), np.asarray(jv.words))
        np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))
        np.testing.assert_array_equal(tv.words_pm1.numpy(), np.asarray(jv.words_pm1, np.float32))


def test_mean_descriptor_equal():
    rng = np.random.default_rng(8)
    for n in (1, 2, 7, 40):                          # even counts give majority ties
        d = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        for valid in (np.ones(n, bool), rng.random(n) < 0.5, np.zeros(n, bool)):
            j = JD.mean_descriptor(jnp.asarray(d), jnp.asarray(valid))
            t = TD.mean_descriptor(_t(d), torch.from_numpy(valid))
            np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))


def test_vocabulary_carried_across_assigns_equally(vocabs):
    jv, _ = vocabs
    tv = vocabulary_from_numpy(dict(words=np.asarray(jv.words), idf=np.asarray(jv.idf)))
    rng = np.random.default_rng(9)
    d = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
    jo, to = _ones(300)
    np.testing.assert_array_equal(TV.assign_words(tv, _t(d), to).numpy(),
                                  np.asarray(JV.assign_words(jv, jnp.asarray(d), jo)))


# ------------------------------------------- tests/test_place.py, mirrored
def test_train_clusters_families():
    rng = np.random.default_rng(0)
    descs, fam, _ = make_descriptor_families(rng)
    vocab = TV.train_vocabulary(descs, n_words=32, iters=6)
    words = TV.assign_words(vocab, _t(descs), torch.ones(len(descs), dtype=torch.bool)).numpy()
    agree = sum((words[fam == f] == np.bincount(words[fam == f]).argmax()).mean()
                for f in range(32))
    assert agree / 32 > 0.8


def test_bow_roundtrip_and_similarity():
    rng = np.random.default_rng(1)
    descs, fam, _ = make_descriptor_families(rng)
    vocab = TV.train_vocabulary(descs, n_words=32, iters=4)

    def sig(d):
        return TV.bow_vector(vocab, TV.assign_words(vocab, _t(d), torch.ones(len(d), dtype=torch.bool)))

    v1, v2, v3 = sig(descs[fam < 8]), sig(descs[fam < 8][::-1]), sig(descs[fam >= 24])
    assert float(TV.bow_score(v1, v2)) > 0.9
    assert float(TV.bow_score(v1, v3)) < 0.3
    assert abs(float(v1.sum()) - 1.0) < 1e-5


def test_save_load_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    descs, _, _ = make_descriptor_families(rng, n_families=8)
    vocab = TV.train_vocabulary(descs, n_words=16, iters=2)
    path = str(tmp_path / "vocab.npz")
    TV.save_vocabulary(vocab, path)
    back, jax_read = TV.load_vocabulary(path), JV.load_vocabulary(path)
    np.testing.assert_array_equal(back.words.numpy(), vocab.words.numpy())
    np.testing.assert_array_equal(np.asarray(jax_read.words), vocab.words.numpy().view(np.uint32))
    ten = torch.ones(10, dtype=torch.bool)
    np.testing.assert_array_equal(TV.assign_words(back, _t(descs[:10]), ten).numpy(),
                                  TV.assign_words(vocab, _t(descs[:10]), ten).numpy())


def _both_dbs(rng, n_kf=12):
    """tests/test_place.py's database on both packages, with one
    vocabulary: 12 keyframes of 4 descriptor families each, keyframe 10
    re-observing keyframe 1's families (the loop)."""
    descs, fam, _ = make_descriptor_families(rng, n_families=48, per_family=10)
    jv = JV.train_vocabulary(descs, n_words=48, iters=4)
    tv = vocabulary_from_numpy(dict(words=np.asarray(jv.words), idf=np.asarray(jv.idf)))
    jdb, tdb = JDB.KeyFrameDB(jv, max_keyframes=16), TDB.KeyFrameDB(tv, max_keyframes=16)
    frames = []
    for k in range(n_kf):
        base = 4 if k == 10 else (k * 4) % 40
        d = descs[(fam >= base) & (fam < base + 4)]
        dd = np.concatenate([d, np.zeros((64 - len(d), 8), np.uint32)])
        vv = np.asarray([True] * len(d) + [False] * (64 - len(d)))
        jdb.add(k, jnp.asarray(dd), jnp.asarray(vv))
        tdb.add(k, _t(dd), torch.from_numpy(vv))
        frames.append((dd, vv))
    np.testing.assert_allclose(tdb.bow.numpy(), np.asarray(jdb.bow), atol=1e-6)
    np.testing.assert_array_equal(tdb.valid.numpy(), np.asarray(jdb.valid))
    return jdb, tdb, frames


def _cands(c):
    return [int(x) for x in np.asarray(c) if x >= 0]


def test_loop_candidate_found():
    jdb, tdb, _ = _both_dbs(np.random.default_rng(3))
    covis = np.zeros((16, 16), np.int32)
    covis[10, 9] = covis[9, 10] = 50
    covis[10, 8] = covis[8, 10] = 30
    jc, js = JDB.detect_loop_candidates(jdb, jdb.bow[10], 10, jnp.asarray(covis))
    tc, ts = TDB.detect_loop_candidates(tdb, tdb.bow[10], 10, torch.from_numpy(covis))
    assert 1 in _cands(tc)
    assert _cands(tc) == _cands(jc)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_group_accumulation_beats_lone_decoy():
    """A covisible group of moderately similar keyframes outranks a lone
    keyframe whose single score is a little higher."""
    rng = np.random.default_rng(6)
    descs, _, _ = make_descriptor_families(rng, n_families=8)
    jv = JV.train_vocabulary(descs, n_words=8, iters=2)
    tv = vocabulary_from_numpy(dict(words=np.asarray(jv.words), idf=np.asarray(jv.idf)))
    K, Wn = 16, jv.n_words
    query = np.zeros(Wn, np.float32)
    query[:4] = 0.25
    bows = np.zeros((K, Wn), np.float32)
    for k in (1, 2, 3):
        bows[k, :4] = 0.15
        bows[k, 4 + (k % 4)] = 0.40
    bows[7, :4] = 0.20
    bows[7, 5] = 0.20
    bows[0, 6] = 1.0
    valid = np.asarray([k in (0, 1, 2, 3, 7) for k in range(K)])
    covis = np.zeros((K, K), np.int32)
    for a in (1, 2, 3):
        for b in (1, 2, 3):
            if a != b:
                covis[a, b] = 40
    covis[12, 0] = covis[0, 12] = 30
    jdb, tdb = JDB.KeyFrameDB(jv, max_keyframes=K), TDB.KeyFrameDB(tv, max_keyframes=K)
    jdb.bow, jdb.valid = jnp.asarray(bows), jnp.asarray(valid)
    tdb.bow, tdb.valid = torch.from_numpy(bows), torch.from_numpy(valid)
    jc, _ = JDB.detect_loop_candidates(jdb, jnp.asarray(query), 12, jnp.asarray(covis))
    tc, _ = TDB.detect_loop_candidates(tdb, torch.from_numpy(query), 12, torch.from_numpy(covis))
    assert _cands(tc) == _cands(jc)
    assert _cands(tc) and _cands(tc)[0] in (1, 2, 3) and 7 not in _cands(tc)
    # the covisibility form of the reloc search, on the same bank
    jr, _ = JDB.detect_reloc_candidates(jdb, jnp.asarray(query), jnp.asarray(covis))
    tr, _ = TDB.detect_reloc_candidates(tdb, torch.from_numpy(query), torch.from_numpy(covis))
    assert _cands(tr) == _cands(jr)


@pytest.mark.parametrize("erase", [False, True])
def test_reloc_candidates(erase):
    jdb, tdb, frames = _both_dbs(np.random.default_rng(5 if erase else 4))
    if erase:
        jdb.erase(5)
        tdb.erase(5)
    dd, vv = frames[5]
    jb = jdb.signature_of(jnp.asarray(dd), jnp.asarray(vv))
    tb = tdb.signature_of(_t(dd), torch.from_numpy(vv))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    np.testing.assert_allclose(tdb.scores(tb).numpy(), np.asarray(jdb.scores(jb)), atol=1e-5)
    jc, _ = JDB.detect_reloc_candidates(jdb, jb)
    tc, _ = TDB.detect_reloc_candidates(tdb, tb)
    assert _cands(tc) == _cands(jc)
    assert (int(tc[0]) != 5) if erase else (int(tc[0]) == 5)
