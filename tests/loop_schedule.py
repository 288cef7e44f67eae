"""Replay of an async run's schedule on the CPU, through the JAX package's
``SlamSystem(async_mapping=True)`` or the port's.

An async run differs from a synchronous one by its schedule: which frames
became keyframes while the mapping thread was busy or idle, where a
keyframe's local BA was stopped by ``abort_ba``, how far mapping had got
when each frame was tracked and when each keyframe's loop detection ran.
``chip_smoke.py`` phase 13 (b) records it on the card (``_schedule_of``):

- ``decisions``: [frame, inserted, mapper idle, refused, the newest
  keyframe whose mapping had ended, the keyframe being mapped (-1: none),
  the mapping steps it had done] per keyframe decision;
- ``ba_chunks``: [keyframe, LM chunks its local BA ran];
- ``detections``: [keyframe, the newest keyframe whose mapping had ended,
  n_kf, the KeyFrameDB's valid slots as [first, last] runs] per detection.

``replay`` drives a system through such a schedule with its worker threads
gated, so that nothing depends on the host's timing and two replays are
equal: each frame's keyframe decision is the recorded one (the system's
own criteria and its backpressure are not consulted, and the tracker never
sets ``abort_ba``); before each frame the mapping worker runs, one step of
``_mapping_steps`` at a time, to the recorded progress and then waits; a
local BA recorded as stopped is stopped after the same LM chunk; the loop
worker runs keyframe k's ``_try_close_loop`` only once mapping has ended
the keyframe recorded for its detection, while mapping and tracking wait,
and a global BA it starts runs to its end before anything else moves.
``traced`` records what each loop detection read and gave.

``OrbSlam2Loop`` is ORB-SLAM2's own loop detection, LoopClosing::DetectLoop
over KeyFrameDatabase::DetectLoopCandidates, in numpy on a package's
inputs (the query, the BoW signatures, the database's slots, the
covisibility weights): what the reference's loop closer detects under the
same schedule and state, and the plain reference of the port's async
detection (``backend.loop_closing.detect_orbslam2``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

FULL_CHUNKS = 3      # a local BA run to its end: 1 chunk of 5 LM iterations, then 2


def slot_runs(slots) -> list:
    """Sorted slots as [first, last] runs."""
    runs = []
    for s in slots:
        if runs and s == runs[-1][1] + 1:
            runs[-1][1] = s
        else:
            runs.append([s, s])
    return runs


def prompt_schedule(n_frames: int, kf_frames, *, loop_lag: int = 0, ba_stops=None) -> dict:
    """A schedule with keyframes made at ``kf_frames`` (keyframe 0 is the
    first frame's), every keyframe mapped before the next frame is tracked,
    and keyframe k's loop detection run once keyframe k + ``loop_lag`` is
    mapped (0: at once, as a synchronous run).  ``ba_stops``: {keyframe:
    chunks} for local BAs stopped early."""
    kf_frames = sorted(kf_frames)
    decisions, n_kf = [], 1
    for f in range(1, n_frames):
        inserted = f in kf_frames
        decisions.append([f, int(inserted), 1, 0, n_kf - 1 if n_kf > 1 else -1, -1, 0])
        n_kf += inserted
    ba = [[k, (ba_stops or {}).get(k, FULL_CHUNKS if k >= 2 else 0)] for k in range(1, n_kf)]
    detections = [[k, min(k + loop_lag, n_kf - 1), -1, []] for k in range(1, n_kf)]
    return {"decisions": decisions, "ba_chunks": ba, "detections": detections}


class _Gates:
    """The gated workers of one system (see the module docstring)."""

    def __init__(self, slam, schedule: dict, timeout: float):
        self.slam, self.timeout = slam, timeout
        self.cv = threading.Condition()
        self.free = False
        self.map_at = None          # (kf, step) the mapping worker waits to run
        self.grant = None
        self.mapped = -1            # the newest keyframe whose mapping ended
        self.kf, self.chunks = -1, 0
        self.loop_at, self.loop_go = None, None
        self.loop_pending, self.loop_done = [], set()
        self.inserted = {int(r[0]): bool(r[1]) for r in schedule["decisions"]}
        self.target = {int(r[0]): (int(r[4]), int(r[5]), int(r[6]))
                       for r in schedule["decisions"]}
        self.stop_after = {int(k): int(c) for k, c in schedule["ba_chunks"]
                           if 0 < c < FULL_CHUNKS}
        self.release_at = {int(d[0]): int(d[1]) for d in schedule["detections"]}
        self.chunk_attr = "_lm_chunk" if hasattr(slam, "_lm_chunk") else "_jit_lm_chunk"

    # ---- the wrappers, installed on the instance
    @contextlib.contextmanager
    def installed(self):
        slam = self.slam
        names = ("_need_new_keyframe", "_mapping_steps", "_try_close_loop", self.chunk_attr)
        saved = {n: vars(slam).get(n) for n in names}
        steps, close, chunk = slam._mapping_steps, slam._try_close_loop, getattr(
            slam, self.chunk_attr)

        def decided(*args, **kwargs):
            fid = kwargs.get("frame_id")
            return self.inserted.get(slam.frame_id if fid is None else fid, False)

        def gated_steps(kf):
            gen, s = steps(kf), 0
            with self.cv:
                self.kf, self.chunks = kf, 0
            while True:
                self._park_map(kf, s)
                try:
                    next(gen)
                except StopIteration:
                    break
                s += 1
                yield
            with self.cv:
                self.mapped = kf
                if slam.loop_closing_enabled:
                    self.loop_pending.append(kf)
                self.cv.notify_all()

        def counted_chunk(*args, **kwargs):
            out = chunk(*args, **kwargs)
            if threading.current_thread().name == "local-mapping":
                self.chunks += 1
                if self.chunks == self.stop_after.get(self.kf):
                    slam.abort_ba = True
            return out

        def gated_close(kf, *args, **kwargs):
            with self.cv:
                self.loop_at = kf
                self.cv.notify_all()
                self.cv.wait_for(lambda: self.free or self.loop_go == kf)
                self.loop_at = self.loop_go = None
            try:
                return close(kf, *args, **kwargs)
            finally:
                with self.cv:
                    self.loop_done.add(kf)
                    self.cv.notify_all()

        slam._need_new_keyframe, slam._mapping_steps = decided, gated_steps
        slam._try_close_loop = gated_close
        setattr(slam, self.chunk_attr, counted_chunk)
        try:
            yield self
        finally:
            with self.cv:
                self.free = True
                self.cv.notify_all()
            for n, v in saved.items():
                if v is None:
                    vars(slam).pop(n, None)
                else:
                    setattr(slam, n, v)

    def _park_map(self, kf: int, s: int):
        with self.cv:
            self.map_at = (kf, s)
            self.cv.notify_all()
            self.cv.wait_for(lambda: self.free or self.grant == (kf, s))
            self.grant = self.map_at = None
            self.cv.notify_all()

    # ---- the replaying thread's side
    def _wait(self, pred, what: str):
        """Wait for ``pred()`` (some of it is set outside the condition:
        poll)."""
        deadline = time.monotonic() + self.timeout
        with self.cv:
            while not pred():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"replay: {what} not reached in {self.timeout} s")
                self.cv.wait(0.005)

    def _settled(self) -> bool:
        """The mapping worker parked at a step, or idle with nothing queued."""
        return self.map_at is not None or self.slam.mapper.idle

    def _step(self):
        """Let the mapping worker run the step it waits at; wait until it
        parks again or goes idle (its keyframe handed to the loop worker)."""
        at = self.map_at
        with self.cv:
            self.grant = at
            self.cv.notify_all()
        self._wait(lambda: self.grant is None and self._settled(), f"mapping step {at}")

    def _release_loops(self, every: bool = False):
        """Run each pending loop call whose recorded mapping progress is
        reached (``every``: all), in order, to its end and its GBA's."""
        while self.loop_pending:
            kf = self.loop_pending[0]
            if not every and self.mapped < self.release_at.get(kf, kf):
                return
            self._wait(lambda: self.loop_at == kf, f"loop call of keyframe {kf}")
            with self.cv:
                self.loop_go = kf
                self.cv.notify_all()
            self._wait(lambda: kf in self.loop_done, f"loop call of keyframe {kf} done")
            gba = self.slam._gba_thread
            if gba is not None and gba.is_alive():
                gba.join(self.timeout)
                if gba.is_alive():
                    raise TimeoutError("replay: the global BA did not end")
            self.loop_pending.pop(0)

    def advance(self, target):
        """Mapping (and the loop calls that fall due) to ``target`` =
        (newest keyframe mapped, keyframe in progress or -1, its steps)."""
        mapped, kf, step = target
        self._wait(self._settled, "the mapping worker settled")
        while True:
            self._release_loops()
            at = self.map_at
            if self.mapped >= mapped and (
                    kf < 0 or self.mapped >= kf or (at is not None and at >= (kf, step))):
                return
            if at is None:        # idle: nothing left to map
                return
            self._step()

    def drain(self):
        """Everything queued mapped, then every loop call, in order."""
        while True:
            self._wait(self._settled, "the mapping worker settled")
            if self.map_at is None:
                break
            self._step()
        self._release_loops(every=True)


def replay(slam, frames, schedule: dict, track, *, timeout: float = 300.0,
           progress=None) -> list:
    """``frames`` through the async ``slam`` under ``schedule``;
    ``track(slam, frame, i)`` tracks frame i, ``progress(i)`` is called
    after it.  Returns what each call returned; the workers are drained
    and idle at the end."""
    gates = _Gates(slam, schedule, timeout)
    out, target = [], (-1, -1, 0)
    with gates.installed():
        for i, frame in enumerate(frames):
            target = gates.target.get(i, target)
            gates.advance(target)
            out.append(track(slam, frame, i))
            if progress is not None:
                progress(i)
        gates.drain()
    if not slam.wait_mapping_idle(timeout=timeout):
        raise TimeoutError(f"replay: the workers did not drain in {timeout} s")
    return out


# ------------------------------------------------------------------ the trace
def _terms(scores, valid, row, query_kf: int) -> dict:
    """minScore and the eligible slots of a loop query from its scores
    against the bank, the database's slots and its covisibility row
    (``detect_loop_candidates``' formulas, in numpy)."""
    scores, valid, row = np.asarray(scores), np.asarray(valid, bool), np.asarray(row)
    pool = np.where(row >= 15, scores, np.inf)
    min_score = min(float(pool.min()), 1.0)
    min_score = min_score if np.isfinite(min_score) else 0.0
    slots = np.arange(len(scores))
    eligible = (valid & (row <= 0) & (slots != query_kf) & (scores >= max(min_score, 0.0))
                & (scores > 0))
    return {"valid": np.nonzero(valid)[0].tolist(), "min_score": min_score,
            "eligible": np.nonzero(eligible)[0].tolist(),
            "connected": np.nonzero(row >= 15)[0].tolist()}


@contextlib.contextmanager
def traced(package: str, trace: list, model: "OrbSlam2Loop | None" = None):
    """Record each loop detection of ``package`` ("jax" or "port") into
    ``trace``, with each consistent candidate's Sim3 outcome (``sim3``).

    - The JAX package (``detect``): the keyframe, the KeyFrameDB's slots it
      saw, minScore, the eligible and connected slots, the raw candidates,
      the consistent groups after the call, the consistent candidates
      (``cands``).  With ``model``, ORB-SLAM2's DetectLoop on the same
      state (its database: the slots before the query; the covisibility
      among the keyframes the map holds) under ``orb``: its minScore,
      candidates, groups and consistent candidates.  A few small host
      reads per detection.
    - The port's async mode (``detect_orbslam2``): its own record (the
      database's slots, the connected keyframes, minScore, the scored
      slots, the candidates, the groups, the consistent candidates)."""
    if package == "port":
        from refactored_orb_slam2_tpu_torch.backend import loop_closing as lc

        detect, sim3 = lc.detect_orbslam2, lc.compute_sim3

        def traced_port(state, *args, **kwargs):
            rec = {}
            cands = detect(state, *args, record=rec, **kwargs)
            if rec:
                trace.append(dict(rec, sim3=[]))
            return cands

        lc.detect_orbslam2 = traced_port
        lc.compute_sim3 = _traced_sim3(sim3, trace)
        try:
            yield trace
        finally:
            lc.detect_orbslam2, lc.compute_sim3 = detect, sim3
        return

    from refactored_orb_slam2_tpu.backend import loop_closing as lc
    from refactored_orb_slam2_tpu.place import keyframe_db as owner

    detect, candidates, sim3 = lc.detect, owner.detect_loop_candidates, lc.compute_sim3
    pending, rows = {}, []

    def traced_candidates(db, query_bow, query_kf, covis, **kwargs):
        out = candidates(db, query_bow, query_kf, covis, **kwargs)
        valid = np.asarray(db.valid)
        pending.update(_terms(np.asarray(db.scores(query_bow)), valid,
                              np.asarray(covis[query_kf]), query_kf),
                       raw=[int(c) for c in np.asarray(out[0]) if c >= 0])
        if model is not None:
            n = max(query_kf, int(np.nonzero(valid)[0].max())) + 1
            if len(rows) < n:           # a keyframe's signature never changes
                rows.extend(np.asarray(db.bow[len(rows):n]))
            pending["orb"] = model.detect(query_kf, np.stack(rows[:n]),
                                          np.nonzero(valid[:query_kf])[0],
                                          np.asarray(covis[:n, :n]))
        return out

    def traced_detect(state, db, covis, kf, *args, **kwargs):
        pending.clear()
        cands = detect(state, db, covis, kf, *args, **kwargs)
        if pending:
            trace.append(dict(pending, kf=int(kf), cands=[int(c) for c in cands], sim3=[],
                              groups=[[sorted(int(i) for i in g), int(n)]
                                      for g, n in state.consistent_groups]))
        return cands

    lc.detect, owner.detect_loop_candidates = traced_detect, traced_candidates
    lc.compute_sim3 = _traced_sim3(sim3, trace)
    try:
        yield trace
    finally:
        lc.detect, owner.detect_loop_candidates, lc.compute_sim3 = detect, candidates, sim3


def _traced_sim3(sim3, trace: list):
    def traced_sim3(state, cam, kf_cur, kf_cand, **kwargs):
        out = sim3(state, cam, kf_cur, kf_cand, **kwargs)
        if trace and trace[-1]["kf"] == kf_cur:
            trace[-1]["sim3"].append(int(bool(out[0])))
        return out
    return traced_sim3


# ------------------------------------------------- ORB-SLAM2's loop detection
def _ordered_connected(covis, k: int, th: int = 15) -> list:
    """KeyFrame::mvpOrderedConnectedKeyFrames: the keyframes sharing >= th
    points with k by weight, descending (the one with the most when none
    reaches th; KeyFrame::UpdateConnections)."""
    row = covis[k]
    idx = np.nonzero(row >= th)[0]
    if len(idx) == 0:
        j = int(np.argmax(row))
        return [j] if row[j] > 0 else []
    return idx[np.argsort(-row[idx], kind="stable")].tolist()


class OrbSlam2Loop:
    """LoopClosing::DetectLoop (LoopClosing.cc:94-215) with
    KeyFrameDatabase::DetectLoopCandidates (KeyFrameDatabase.cc:72-193), as
    the reference computes them, on a package's state:

    - minScore: the lowest score of the query against its ordered connected
      keyframes (weight >= 15, or the heaviest), starting from 1;
    - the database's keyframes that share a word with the query and are
      not connected to it (weight > 0: mConnectedKeyFrameWeights holds every
      covisible keyframe), kept when they share more than 0.8 x the most
      shared words and score >= minScore;
    - each one's score accumulated over its 10 best covisible keyframes
      that passed the word test, its best-scoring member returned when the
      sum is above 0.75 x the best sum (which starts at minScore);
    - consistency: a candidate's group is itself and every keyframe
      covisible with it; it counts one more than a previous group it
      shares a keyframe with, each previous group is carried once, and a
      candidate is consistent when its count reaches ``consistency_th``
      (mnCovisibilityConsistencyTh = 3; the JAX package accepts at 2);
    - nothing before keyframe ``kf_gap`` (mLastLoopKFid starts at 0).

    The JAX package's ``detect`` (and the port's outside the async mode)
    differs: it leaves covisible keyframes below weight 15 out of a group,
    accepts a count of 2, carries every candidate's group, caps the
    candidates at 8 and applies no word test.  The port's async mode runs
    ``detect_orbslam2``, which this model holds on the CPU.  ``detect``
    returns the step's record; ``groups`` is the chain."""

    def __init__(self, kf_gap: int = 10, consistency_th: int = 3):
        self.kf_gap, self.consistency_th = kf_gap, consistency_th
        self.groups: list = []
        self.last_loop = 0

    def candidates(self, kf: int, bow, db_slots, covis, min_score: float) -> list:
        bow = np.asarray(bow, np.float32)
        words = bow > 0
        K = covis.shape[0]
        in_db = np.zeros(K, bool)
        in_db[np.asarray(db_slots, int)] = True
        shared = (words[:, words[kf]]).sum(1)
        sharing = in_db & (covis[kf] <= 0) & (np.arange(K) != kf) & (shared > 0)
        if not sharing.any():
            return []
        min_common = int(0.8 * shared[sharing].max())
        passed = sharing & (shared > min_common)
        score = 1.0 - 0.5 * np.abs(bow[kf][None] - bow).sum(-1)
        scored = [int(j) for j in np.nonzero(passed & (score >= min_score))[0]]
        if not scored:
            return []
        best_acc, accs = min_score, []
        for j in scored:
            acc, best, best_s = float(score[j]), j, float(score[j])
            for n in _ordered_connected(covis, j)[:10]:
                if passed[n]:
                    acc += float(score[n])
                    if score[n] > best_s:
                        best, best_s = n, float(score[n])
            accs.append((acc, best))
            best_acc = max(best_acc, acc)
        out = []
        for acc, best in accs:
            if acc > 0.75 * best_acc and best not in out:
                out.append(best)
        return out

    def detect(self, kf: int, bow, db_slots, covis) -> dict:
        """One DetectLoop call for keyframe ``kf``: ``bow`` (K, W) the
        signatures, ``db_slots`` the database's keyframes, ``covis`` (K, K)
        the weights.  Returns {kf, min_score, candidates, groups,
        consistent}."""
        covis = np.asarray(covis)
        rec = {"kf": kf, "min_score": None, "candidates": [], "consistent": []}
        if kf < self.last_loop + self.kf_gap:
            rec["groups"] = [[sorted(g), n] for g, n in self.groups]
            return rec
        bow = np.asarray(bow, np.float32)
        min_score = 1.0
        for c in _ordered_connected(covis, kf):
            min_score = min(min_score, float(1.0 - 0.5 * np.abs(bow[kf] - bow[c]).sum()))
        rec["min_score"] = min_score
        cands = self.candidates(kf, bow, db_slots, covis, min_score)
        rec["candidates"] = cands
        current, used, consistent = [], [False] * len(self.groups), []
        for c in cands:
            group = {c} | {int(i) for i in np.nonzero(covis[c] > 0)[0]}
            enough = matched = False
            for i, (prev, n) in enumerate(self.groups):
                if not group & prev:
                    continue
                matched = True
                if not used[i]:
                    current.append((group, n + 1))
                    used[i] = True
                if n + 1 >= self.consistency_th and not enough:
                    consistent.append(c)
                    enough = True
            if not matched:
                current.append((group, 0))
        self.groups = current
        rec.update(consistent=consistent, groups=[[sorted(g), n] for g, n in current])
        return rec

    def closed(self, kf: int) -> None:
        """A loop was closed at ``kf`` (mLastLoopKFid)."""
        self.last_loop = kf
