"""Loop detection in async mode as a function of the run's schedule, on the
CPU: the JAX package's ``SlamSystem(async_mapping=True)`` and the port's
replayed through one schedule (``tests/loop_schedule.py``).

The scenario is the stereo one of ``tests/test_torch_async_sensors.py``
(seed 4, bf 80, 500 features, 320x240, 4 levels, map 24 x 4096 x 8) over
its first N_FRAMES frames, with loop closing on and ``loop.kf_gap`` 2, so
that detection runs from keyframe 3 on; a keyframe is made at every frame
and keyframe BA_STOP's local BA is stopped after 2 of its 3 LM chunks.  A
straight path closes no loop: what is held is what each detection read and
gave (``loop_schedule.traced``).

- (a) The port replayed twice under the schedule where each keyframe's
  loop detection waits until mapping has ended LAG more keyframes: the
  same poses returned, the same detections, every map bank equal.
- (b) Under the prompt schedule (each detection right after its
  keyframe's mapping, as a synchronous run has it) the two packages read
  the same state at every detection: the KeyFrameDB's slots besides the
  query, the connected keyframes, minScore (1e-5).  The port's async mode
  decides with ORB-SLAM2's DetectLoop (``detect_orbslam2``), the JAX
  package with its own rule: the port's candidates, groups and consistent
  candidates equal ORB-SLAM2's model run on the JAX package's state.
- (c) Under the lagging schedule the port's KeyFrameDB holds only
  keyframes older than the query, as ORB-SLAM2's does at DetectLoop (the
  loop closer adds a keyframe after its own detection), and its
  detections equal the model's on the JAX package's state under the same
  schedule.  The JAX package's database holds keyframes k+1 .. k+LAG at
  detection k, which its loop closer has not processed: shown beside the
  port's.

ORB-SLAM2's own loop detection (``loop_schedule.OrbSlam2Loop``) is held
on a hand-made case (four consistent detections, the shared-word test, the
gates), and the port's ``detect_orbslam2`` against it on random states.  A
late schedule that phase 13 (b) recorded on the card replays through both
packages at full width in ``test_replay_recorded_circuit`` (marked slow).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import loop_schedule as LS
import test_torch_async_sensors as A
import test_torch_stereo_sequence as st
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam

torch.set_num_threads(1)

N_FRAMES = 8
LAG = 2
BA_STOP = 5
CFG = dataclasses.replace(st.CFG, loop=dataclasses.replace(st.CFG.loop, kf_gap=2))
TCFG = config_from_reference(CFG)
PROMPT = LS.prompt_schedule(N_FRAMES, range(1, N_FRAMES), ba_stops={BA_STOP: 2})
LAGGING = LS.prompt_schedule(N_FRAMES, range(1, N_FRAMES), loop_lag=LAG,
                             ba_stops={BA_STOP: 2})


def _track(slam, frame, i):
    return slam.track_stereo(*frame, i * 0.1)


def _run(package: str, schedule: dict, frames) -> dict:
    slam = (JSlam(CFG, async_mapping=True) if package == "jax"
            else TSlam(TCFG, device="cpu", async_mapping=True))
    trace = []
    model = LS.OrbSlam2Loop(kf_gap=CFG.loop.kf_gap) if package == "jax" else None
    with LS.traced(package, trace, model):
        out = LS.replay(slam, frames, schedule, _track)
    slam.shutdown()
    host = (lambda x: x.numpy()) if package == "port" else np.asarray
    return dict(trace=trace, out=[None if p is None else np.asarray(p) for p in out],
                n_kf=slam.n_kf, kf_frames=host(slam.map.kf_frame_id)[:slam.n_kf].tolist(),
                map=slam.map, stats=dict(slam.stats))


@pytest.fixture(scope="module")
def runs():
    _, frames = A._frames("stereo")
    frames = frames[:N_FRAMES]
    return {(pkg, name): _run(pkg, sched, frames)
            for pkg, name, sched in (("jax", "prompt", PROMPT), ("port", "prompt", PROMPT),
                                     ("jax", "lagging", LAGGING), ("port", "lagging", LAGGING))}


def _held(rec: dict) -> list:
    """The KeyFrameDB's slots a detection saw besides the query's own (the
    reference's database does not hold it yet at its own detection)."""
    return [v for v in rec["valid"] if v != rec["kf"]]


def _orb(rec: dict) -> dict:
    """The decision of a port record, or of ORB-SLAM2's model beside a JAX
    record."""
    got = rec.get("orb", rec)
    return {k: got[k] for k in ("candidates", "groups", "consistent")}


def test_replay_is_deterministic(runs):
    _, frames = A._frames("stereo")
    again = _run("port", LAGGING, frames[:N_FRAMES])
    first = runs[("port", "lagging")]
    assert again["trace"] == first["trace"] and len(first["trace"]) >= N_FRAMES - 3
    assert again["kf_frames"] == first["kf_frames"] and first["n_kf"] == N_FRAMES
    for a, b in zip(again["out"], first["out"]):
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    for f in dataclasses.fields(first["map"]):
        assert torch.equal(getattr(again["map"], f.name), getattr(first["map"], f.name)), f.name


def test_prompt_schedule_detections_as_jax(runs):
    j, t = runs[("jax", "prompt")], runs[("port", "prompt")]
    assert t["kf_frames"] == j["kf_frames"] and len(t["trace"]) == len(j["trace"]) > 0
    for jr, tr in zip(j["trace"], t["trace"]):
        assert tr["kf"] == jr["kf"] and tr["valid"] == _held(jr), jr["kf"]
        assert sorted(tr["connected"]) == jr["connected"] != [], jr["kf"]
        assert abs(tr["min_score"] - jr["min_score"]) <= 1e-5, jr["kf"]
        assert abs(jr["orb"]["min_score"] - jr["min_score"]) <= 1e-5, jr["kf"]
        assert _orb(tr) == _orb(jr), jr["kf"]
    # the straight path gives no candidate (every database keyframe is
    # covisible with the query): test_torch_loop_closing.py holds the
    # candidates and groups on a map with a loop


def test_lagging_schedule_decides_on_the_prompt_state(runs):
    lagging, jax_lagging = runs[("port", "lagging")], runs[("jax", "lagging")]
    newer = {r["kf"]: [s for s in r["valid"] if s > r["kf"]] for r in jax_lagging["trace"]}
    print("\nKeyFrameDB slots newer than the query at each detection, lagging schedule: "
          f"JAX {newer}, port "
          f"{ {r['kf']: [s for s in r['valid'] if s > r['kf']] for r in lagging['trace']} }")
    assert any(newer.values())
    assert all(max(r["valid"], default=-1) < r["kf"] for r in lagging["trace"])
    assert len(lagging["trace"]) == len(jax_lagging["trace"])
    for jr, tr in zip(jax_lagging["trace"], lagging["trace"]):
        assert tr["kf"] == jr["kf"] and _orb(tr) == _orb(jr), jr["kf"]


def _model_case():
    """Six keyframes whose signatures put 0-2 (one place) against 3-5 (its
    revisit), with 0-1-2 and 3-4-5 covisible chains and no covisibility
    between the two."""
    bow = np.zeros((8, 6), np.float32)
    for k in (0, 3):
        bow[k, :3] = [0.5, 0.3, 0.2]
    for k in (1, 4):
        bow[k, :3] = [0.4, 0.4, 0.2]
    for k in (2, 5):
        bow[k, 1:4] = [0.3, 0.3, 0.4]
    covis = np.zeros((8, 8), np.int32)
    for a, b in ((0, 1), (1, 2), (3, 4), (4, 5)):
        covis[a, b] = covis[b, a] = 20
    return bow, covis


def test_orbslam2_model_needs_four_consistent_detections():
    bow, covis = _model_case()
    model = LS.OrbSlam2Loop(kf_gap=0)
    steps = [model.detect(k, bow, range(k), covis) for k in (3, 3, 3, 3)]
    assert [s["candidates"] for s in steps] == [[0]] * 4
    # counts 0, 1, 2, 3: the reference accepts at 3 (the packages at 2)
    assert [s["groups"][0][1] for s in steps] == [0, 1, 2, 3]
    assert [s["consistent"] for s in steps] == [[], [], [], [0]]


def test_orbslam2_model_gates_and_word_test():
    bow, covis = _model_case()
    model = LS.OrbSlam2Loop(kf_gap=4)
    assert model.detect(3, bow, range(3), covis)["min_score"] is None    # before kf_gap
    model.kf_gap = 0
    # keyframe 4 is connected to 3 and 5 (minScore from them); 1 scores
    # highest and its group {0, 1, 2} gathers 0 and 2's scores
    step = model.detect(4, bow, range(4), covis)
    assert step["candidates"] == [1] and step["groups"][0] == [[0, 1, 2], 0]
    # a database without keyframe 1: its neighbours' best member instead
    assert model.detect(4, bow, [0, 2, 3], covis)["candidates"] == [0]
    # no candidate empties the chain
    assert model.detect(4, bow, [], covis)["candidates"] == [] and model.groups == []


# ------------------------------------------------ the recorded circuit (slow)
SCHEDULES = os.path.join(os.path.dirname(__file__), "data", "async_circuit_schedules.json")
LATE = "call1_run3"


def _circuit_replay(package: str, schedule: dict, frames, poses) -> dict:
    import chip_smoke
    from test_torch_smoke_reference import reference_config

    cfg = chip_smoke.circuit_config()
    fps = cfg.camera.fps
    if package == "jax":
        slam = JSlam(reference_config(cfg), async_mapping=True)
        track = lambda s, f, i: s.track_stereo_device(*(t.numpy() for t in f), i / fps)
        model = LS.OrbSlam2Loop(kf_gap=cfg.loop.kf_gap)
    else:
        slam = TSlam(cfg, device="cpu", async_mapping=True)
        track = lambda s, f, i: s.track_stereo_device(*f, i / fps)
        model = None
    # the global BA is left out: when it merges is not part of the schedule,
    # and on the CPU it takes longer than the rest of the run
    slam._launch_gba = lambda kf_cur, iters=10: None
    trace = []
    with LS.traced(package, trace, model):
        out = LS.replay(slam, frames, schedule, track, timeout=3600.0,
                        progress=lambda i: i % 20 or print(f"{package}: frame {i}", flush=True))
    slam.shutdown()
    host = (lambda x: x.numpy()) if package == "port" else np.asarray
    edges = host(slam.map.kf_loop_edges)
    pairs = sorted({tuple(sorted((k, int(x)))) for k in range(edges.shape[0])
                    for x in edges[k] if x >= 0})
    kf_frames = host(slam.map.kf_frame_id)[:slam.n_kf].tolist()
    gt = chip_smoke.world_centres(poses)
    return dict(trace=trace, lost=[i for i, p in enumerate(out) if p is None], pairs=pairs,
                pair_frames=[tuple(kf_frames[k] for k in p) for p in pairs], n_kf=slam.n_kf,
                ate=chip_smoke.ate_rmse_se3(slam.camera_centers(),
                                            gt[slam.tracked_frame_ids()]),
                kf_frames=kf_frames)


def _same_state(jr: dict, tr: dict) -> bool:
    """The two packages read the same state at a detection: the database's
    slots, the connected keyframes, minScore within 1e-5."""
    return (tr["valid"] == _held(jr) and sorted(tr["connected"]) == jr["connected"]
            and abs(tr["min_score"] - jr["min_score"]) <= 1e-5)


@pytest.mark.slow
def test_replay_recorded_circuit():
    """A late schedule recorded on the card (``tests/data/``, ``call1_run3``:
    loop at frames 19 and 136 with the JAX package's detection rule)
    through the port and the JAX package on the CPU at the card's full
    width, without the global BA.  Held: the keyframe set is the recorded
    one in both, at most 2 frames lost, one loop in each; at every
    detection until the packages' states first differ (float rounding
    grows along the circuit), the port's async detection decides as
    ORB-SLAM2's DetectLoop (``loop_schedule.OrbSlam2Loop``) on the JAX
    package's state, and those detections are most of the circuit's."""
    import chip_smoke

    with open(SCHEDULES) as f:
        rec = json.load(f)[LATE]
    poses = chip_smoke.circuit_poses()
    frames = chip_smoke.render_circuit(poses, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count())
    try:
        out = {name: _circuit_replay(name, rec["schedule"], frames, poses)
               for name in ("port", "jax")}
    finally:
        torch.set_num_threads(threads)
    for name, r in out.items():
        print(f"\n{name}: lost {r['lost']}, n_kf {r['n_kf']}, loop pairs {r['pairs']} made at "
              f"frames {r['pair_frames']}, ATE {r['ate']:.6f} m (the card: "
              f"{rec['pair_frames']}, ATE {rec['ate']:.6f} m)")
    jax_by_kf = {t["kf"]: t for t in out["jax"]["trace"]}
    port = [t for t in out["port"]["trace"] if t["kf"] in jax_by_kf]
    first = next((t["kf"] for t in port if not _same_state(jax_by_kf[t["kf"]], t)), None)
    print(f"first detection where the packages' states differ: {first}")
    for t in port:
        j = jax_by_kf[t["kf"]]
        if first is None or t["kf"] >= first:
            print(f"  {t['kf']}: port {t['candidates']} {t['consistent']} {t['sim3']}; "
                  f"ORB-SLAM2 on JAX's state {j['orb']['candidates']} "
                  f"{j['orb']['consistent']}; JAX {j['raw']} {j['cands']} {j['sim3']}")
    held = [t for t in port if first is None or t["kf"] < first]
    for t in held:
        assert _orb(t) == _orb(jax_by_kf[t["kf"]]), t["kf"]
    assert len(held) >= len(port) // 2
    recorded = sum(d[1] for d in rec["schedule"]["decisions"]) + 1
    for name, r in out.items():
        assert r["n_kf"] == recorded and len(r["lost"]) <= 2, name
        assert len(r["pairs"]) == 1, name


def test_orbslam2_detect_stands_in_for_the_port_detect():
    """The port's ``detect_orbslam2`` against ORB-SLAM2's model: the
    hand-made case (four consistent detections, the gate after a loop),
    then 40 random states in chains of four detections (sparse
    signatures, covisibility weights around the threshold of 15, a
    database with holes), every step's minScore, candidates, groups and
    consistent candidates equal."""
    from refactored_orb_slam2_tpu_torch.backend import loop_closing as TLC

    bow, covis = _model_case()
    db = type("DB", (), {"bow": torch.from_numpy(bow), "valid": torch.ones(8, dtype=torch.bool)})
    state = TLC.LoopState()
    got = [TLC.detect_orbslam2(state, db, 3, torch.from_numpy(covis), 8, kf_gap=0)
           for _ in range(4)]
    assert got == [[], [], [], [0]]
    state.last_loop_kf = 3
    assert TLC.detect_orbslam2(state, db, 4, torch.from_numpy(covis), 8, kf_gap=2) == []

    rng = np.random.default_rng(13)
    n_cands = 0
    for case in range(40):
        K, W = 24, 40
        # continuous weights: no two scores tie, as the rounding of a sum
        # order would decide a tie
        counts = (rng.random((K, W)) * (rng.random((K, W)) < 0.4)).astype(np.float32)
        counts[:, 0] += 0.01
        bow = counts / counts.sum(1, keepdims=True)
        w = rng.integers(0, 40, (K, K)) * (rng.random((K, K)) < 0.3)
        w = np.triu(w, 1)
        covis = (w + w.T).astype(np.int32)
        valid = rng.random(K) < 0.85
        db = type("DB", (), {"bow": torch.from_numpy(bow), "valid": torch.from_numpy(valid)})
        state, model = TLC.LoopState(), LS.OrbSlam2Loop(kf_gap=4)
        for kf in sorted(rng.choice(np.arange(4, K), 4, replace=False)):
            rec = {}
            got = TLC.detect_orbslam2(state, db, int(kf), torch.from_numpy(covis), K,
                                      kf_gap=4, record=rec)
            want = model.detect(int(kf), bow, np.nonzero(valid[:kf])[0], covis)
            assert abs(rec["min_score"] - want["min_score"]) <= 1e-6, (case, kf)
            assert _orb(rec) == _orb(want) and got == want["consistent"], (case, kf)
            assert [[sorted(g), n] for g, n in state.consistent_groups] == want["groups"]
            n_cands += len(want["candidates"])
    assert n_cands > 20
