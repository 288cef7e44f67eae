"""SLAM system facade: RGB-D, stereo and monocular tracking with local
mapping (synchronous, or cooperative and pipelined), relocalization,
localization-only mode and loop closing (port of system.py).

What runs here, in the JAX package's order:

- RGB-D and stereo, frame 0: ``_initialize_depth``, keyframe 0 with one
  point per feature with depth (a stereo frame's depth comes from
  ``ops.stereo.stereo_match``);
- monocular: ``_initialize_mono`` keeps a reference frame, matches later
  frames against it and runs the two-view initializer
  (``solvers.initializer``) until it accepts a reconstruction; then two
  keyframes, the triangulated points, a 20-iteration BA and the
  median-depth scale;
- every tracked frame: ``_fused_step`` (the JAX ``_build_fused_track.step``:
  frame build, motion-model match with the 2x window retry, pose-only LM,
  local-map selection and the fused window matcher (CUDA kernel), a second
  pose-only LM, the counters and ``Tcr``), on the card one CUDA graph replay
  (``frontend/fused_graph.py``, the counterpart of ``_jit_fused_track``).
  ``_track_fused`` dispatches each frame against the tracker's uncommitted
  device state and ``_commit_fused`` commits it ``pipeline_depth`` calls
  later: in the same call in synchronous mode (depth 0), later with
  ``pipelined=True`` (``track_*`` then returns the pose as a device
  tensor).  The commit applies the visibility counters.  When the motion
  model fails, TrackReferenceKeyFrame and the decomposed local map take
  over; when that fails too, or too few local-map inliers remain, the frame
  is lost, and the frames in flight behind it go through the decomposed
  path (``flush_pipeline``);
- a lost system with at most 5 keyframes resets and initializes again on a
  later frame (Tracking.cc:421-428); with more, or with the map frozen, every
  later frame tries ``_relocalize`` (Tracking.cc:1217-1363): BoW candidates
  from the KeyFrameDB over the covisibility groups, SearchByBoW, batched
  EPnP RANSAC, the pose-only LM, up to two projection rescue rounds (the
  masked best-2 CUDA kernel) and the 50-inlier bar.  A relocalized frame
  goes straight to the local map, leaves no velocity, and for
  ``max_frames_between_kf`` frames the local map must give
  ``min_inliers_local_map_reloc`` inliers;
- a keyframe (``_need_new_keyframe``, ``_create_keyframe``) is mapped by
  ``_mapping_steps``, a step generator: work sets, triangulation, fusion in
  both directions, recent-point culling and statistics, the local BA in
  chunks of 5 LM iterations (on the card each chunk one CUDA graph replay,
  ``_ba_chunk``), keyframe culling, both descriptor searches through the
  masked best-2 CUDA kernel.  On the card each triangulated neighbour and
  each fuse call replays CUDA graphs around its one eager masked best-2
  (``_mapping_run``).  Synchronous and pipelined mode
  run it to completion before the next frame; ``cooperative_mapping=True``
  queues the keyframe and pumps one step per tracked frame
  (``_pump_mapping``), and a keyframe needed while mapping is busy aborts
  the local BA and goes in while fewer than 3 are queued.  A monocular
  keyframe gets no depth points: triangulation is its only source of new
  points;
- localization-only mode (``activate_localization_mode``): the map is
  frozen, no keyframe is inserted, and every frame takes the decomposed
  path ``_track``, which for RGB-D and stereo adds temporal points from the
  last frame's depth to the motion-model matches (``_track_vo``), and a
  frame that followed visual odometry alone tries ``_relocalize`` first;
- every keyframe's BoW signature goes into the KeyFrameDB
  (``_register_keyframe_bow``), and a culled keyframe leaves it;
- loop closing after every mapped keyframe (``_try_close_loop``, from
  ``loop.kf_gap + 2`` keyframes on): detection with the consistency chain,
  ``compute_sim3`` per consistent candidate, the projection count, then
  ``_correct_loop`` (propagation through the covisible group, SearchAndFuse
  with the masked best-2 CUDA kernel, the essential graph, the point
  correction) and the global BA (``_launch_gba``, inline in the
  single-thread modes);
- ``async_mapping=True`` (``backend/async_mapper.py``): mapping and loop
  closing run on worker threads, a global BA on a thread of its own over a
  snapshot of the map, each on a CUDA stream of its own on the card.  The
  tracker buffers its visibility counters (``_pending_vis``) and flushes
  them at the keyframe insertion, waits at most 500 ms for a mapping
  backlog of 3 to drain, and stops the mapping worker around the capture of
  its CUDA graph.  Every map mutation takes ``_map_lock``; every map is
  published with an event on the writer's stream (``map``).  A global BA
  whose epoch moved (a newer loop, ``reset``) is dropped; one that merges
  moves the keyframes and points made while it ran along the spanning
  tree.  A local BA whose gathered window a loop correction or a GBA merge
  overtook drops its result (``map_epoch``) instead of writing
  pre-correction poses into the corrected map.  Loop detection there is
  ORB-SLAM2's own DetectLoop (``LC.detect_orbslam2``);
- the trajectory products, chained through culled keyframes.

A tracked frame of the fused path reads one (6,) scalar vector and one
(2, 4, 4) pose stack back to the host, through pinned memory, as the JAX
facade does; a keyframe, a localization-only frame, a relocalization and a
loop closure add the reads listed in PERF.md.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from .backend import local_mapping as LM
from .backend.async_mapper import AsyncMapper
from .backend import loop_closing as LC
from .frontend import tracking_kernels as TK
from .frontend.fused_graph import FusedGraph, StepGraph, stage
from .frontend.frame import (
    FrameData, build_frame_mono, build_frame_rgbd, build_frame_stereo,
)
from .geometry import camera as cam_mod
from .geometry import se3, sim3
from .geometry.camera import camera_from_config
from .models import map_ops
from .models.map_state import (
    MapState, covisibility_matrix, create_empty, n_observations, update_point_stats,
    update_point_stats_subset,
)
from .ops import matching as M
from .ops.descriptors import hamming
from .ops.image import level_sigma2
from .ops.orb import level_quotas
from .optim import bundle_adjustment as BA
from .optim import pose_graph as PG
from .optim.pose_opt import optimize_pose
from .parallel import dist_ba
from .place.keyframe_db import KeyFrameDB, detect_reloc_candidates
from .place.vocab import load_vocabulary, train_vocabulary
from .solvers import epnp
from .solvers.initializer import initialize_two_view
from .utils import telemetry

SENSORS = ("rgbd", "stereo", "monocular")
VOCAB_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "vocab.npz")
#: local mapping's generator steps that ``_mapping_run`` replays as CUDA
#: graphs; one that a test replaced runs eagerly
_GRAPHED_STEPS = (LM.fuse_gen, LM.fuse_targets_gen, LM.triangulate_neighbor_gen)
#: marks a positional argument of a graphed step that is a graph input
_INPUT = object()


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


def _encode_img(img) -> np.ndarray:
    """Host-side: grayscale float [0, 255] -> uint8 (the wire encoding)."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a
    return np.clip(a, 0.0, 255.0).astype(np.uint8)


def _encode_depth(depth) -> np.ndarray:
    """Host-side: metric depth -> uint16 millimeters."""
    a = np.asarray(depth)
    if a.dtype == np.uint16:
        return a
    return np.clip(a * 1000.0, 0.0, 65535.0).astype(np.uint16)


def _decode_img(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _decode_depth(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * 1e-3


def _write_tum(path: str, rows) -> None:
    """TUM lines ``t x y z qx qy qz qw`` from (timestamp, Tcw) pairs."""
    with open(path, "w") as f:
        for ts, Tcw in rows:
            Twc = np.linalg.inv(Tcw)
            q = se3.to_quaternion(torch.from_numpy(Twc[:3, :3].copy())).numpy()
            t = Twc[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def _start_read(t: torch.Tensor):
    """Start copying ``t`` to the host: on the card into pinned memory,
    with an event after the copy; ``_finish_read`` waits for it."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _finish_read(pending) -> np.ndarray:
    telemetry.inc("host_reads")
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy().copy()


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host, read now (the host waits for the device): every
    such read of the tracking, mapping and loop paths goes through here or
    ``_finish_read`` and counts in ``telemetry``'s ``host_reads``."""
    telemetry.inc("host_reads")
    return t.cpu().numpy()


@dataclasses.dataclass
class FrameLog:
    frame_id: int
    timestamp: float
    Tcr: np.ndarray          # pose relative to the reference keyframe
    ref_kf: int
    lost: bool


class SlamSystem:
    """SLAM on an explicit device for the sensor named by ``config.sensor``.
    Feed frames with ``track_rgbd`` / ``track_stereo`` / ``track_monocular``
    (host arrays) or their ``_device`` forms (uint8 images and uint16
    millimetre depth already on ``device``); read the trajectory with
    ``frame_poses`` / ``export_trajectory_tum``."""

    def __init__(self, config, device="cuda", async_mapping: bool = False,
                 pipelined: bool = False, pipeline_depth: int = 1,
                 cooperative_mapping: bool = False):
        # SLAM geometry needs full float32 products: at reduced precision the
        # pose normal equations and descriptor intensity differences lose
        # enough that tracking margins collapse (the JAX facade pins
        # jax_default_matmul_precision="highest" for the same reason; on the
        # TPU at bf16, identical input lost 125 of 600 frames).  On the card
        # cuDNN and matmuls may use TF32, which keeps ~3 decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if cooperative_mapping and async_mapping:
            raise ValueError("cooperative_mapping and async_mapping are exclusive")
        if config.sensor not in SENSORS:
            raise ValueError(f"sensor {config.sensor!r}: expected one of {SENSORS}")
        self.cfg = config
        self.sensor = config.sensor
        self.device = torch.device(device)
        self.cam = camera_from_config(config.camera)

        self.n_feat_slots = sum(level_quotas(
            config.orb.n_features, config.orb.n_levels, config.orb.scale_factor
        ))

        # metric close-point threshold: ThDepth is in baseline units
        self.th_depth_m = (
            config.tracking.th_depth * config.camera.bf / config.camera.fx
            if config.camera.bf > 0 else 0.0
        )
        lv_sigma2 = level_sigma2(config.orb.n_levels, config.orb.scale_factor)
        self.inv_sigma2_table = torch.from_numpy(
            np.asarray(1.0 / lv_sigma2, np.float32)
        ).to(self.device)
        self.scale_factors = np.asarray(
            [config.orb.scale_factor ** i for i in range(config.orb.n_levels)],
            np.float32,
        )
        self.loop_closing_enabled = True
        # a tracked frame is committed ``pipeline_depth`` calls after its
        # dispatch: 0 in synchronous mode, which commits it in the same call.
        # Pipelined, track_* returns the pose as a device tensor; depth 1
        # commits the previous frame before each dispatch and gives sync
        # mode's map, a deeper pipeline lets keyframe decisions land up to
        # depth - 1 frames late (the JAX package measured its ATE 0.104 m at
        # depth 3 against 0.0027 m at depth 1 on its fixture).
        self.pipeline_depth = max(1, int(pipeline_depth)) if pipelined else 0
        # cooperative mapping: local mapping advances as a step generator
        # pumped between frame dispatches on the tracking thread
        self.cooperative = cooperative_mapping
        # the async mode's worker threads (made after the first reset), and
        # on the card one CUDA stream per worker: every map is then
        # published with an event on the writer's stream (``map``)
        self.mapper: Optional[AsyncMapper] = None
        self._streams = None
        if async_mapping and self.device.type == "cuda":
            self._streams = {name: torch.cuda.Stream(self.device)
                             for name in ("mapping", "loop", "gba")}
        self._tls = threading.local()
        # the LM chunk the local and the global BA run, an attribute so that
        # a test can slow it down
        self._lm_chunk = BA.lm_chunk
        # the global BA thread (async mode), its stop flag and epoch
        # (mnFullBAIdx, LoopClosing.cc:618-715), and the map's correction
        # epoch, which a local BA's scatter checks
        self._gba_thread: Optional[threading.Thread] = None
        self._stop_gba = False
        self.gba_epoch = 0
        self.map_epoch = 0
        # the tracked frame as one CUDA graph, captured at the first fused
        # frame on the card and kept across reset() (the shapes stay)
        self._graph: Optional[FusedGraph] = None
        # the local BA's LM chunk as CUDA graphs (``_ba_chunk``), kept across
        # reset() too: every window is gathered at the same padded shapes;
        # so are triangulation's and fusion's (``_mapping_run``), which take
        # their keyframe slots as views of ``_slots``
        self._ba_graphs: dict = {}
        self._tri_fuse_graphs: dict = {}
        self._slots = torch.arange(self.cfg.map.max_keyframes, dtype=torch.int32,
                                   device=self.device)
        self._eye4 = torch.eye(4, dtype=torch.float32, device=self.device)
        self._scalars: dict = {}
        # which tracking paths fired; global BAs run and dropped, local BAs
        # dropped because a correction overtook them (async mode)
        self.stats = {"motion_tracks": 0, "ref_kf_tracks": 0, "vo_tracks": 0,
                      "relocs": 0, "reloc_rejects": 0, "gba_runs": 0, "gba_aborted": 0,
                      "local_ba_discarded": 0}
        # what each candidate of the last _relocalize call gave (see there)
        self.reloc_log: list[dict] = []
        self.localization_only = False
        self.frame_id = -1
        self.reset()
        if async_mapping:
            if self._streams is not None:
                self._prime_worker_graphs()
                # what the tracker's stream made so far (the empty map, the
                # tables above) is complete before a worker's stream reads it
                torch.cuda.synchronize(self.device)
            self.mapper = AsyncMapper(self)

    def reset(self):
        """Full reset: map, keyframe database, trajectory and counters
        (System::Reset -> Tracking::Reset, Tracking.cc:1365-1409).  The
        frame counter and ``stats`` run on.  A global BA in flight is
        stopped and its epoch moved; in async mode the workers finish what
        they hold first, so that none writes a keyframe of the old map into
        the new one."""
        self._stop_gba = True
        self.gba_epoch += 1
        self.map_epoch += 1
        if self.mapper is not None:
            self.mapper.wait_idle(300)
        with self._map_lock():
            self.map = create_empty(self.cfg.map, self.n_feat_slots, self.device)
        self.n_kf = 0
        self.n_pt = 0
        self.state = TrackState.NOT_INITIALIZED
        self.last_frame: Optional[FrameData] = None
        self.last_pose: Optional[torch.Tensor] = None
        self.last_pt_idx: Optional[torch.Tensor] = None
        self.velocity: Optional[torch.Tensor] = None
        self.ref_kf = 0
        self._ref_matches = 0
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -1
        # the vocabulary loads (or, under allow_vocab_fallback, trains) at
        # the first keyframe, as in the JAX package
        self.vocab = None
        self.db: Optional[KeyFrameDB] = None
        self.trajectory: list[FrameLog] = []
        # culled keyframes: slot -> (T_this_to_parent, parent slot), so the
        # trajectory chains through the spanning tree (System.cc:372-390)
        self.culled_chain: dict[int, tuple[np.ndarray, int]] = {}
        # the monocular initializer's reference frame
        self._init_ref: Optional[FrameData] = None
        # localization-only visual-odometry flag (mbVO, Tracking.cc:131)
        self.mb_vo = False
        self.loop_state = LC.LoopState()
        # frames dispatched and not yet committed (pipelined mode)
        self._inflight: list[dict] = []
        # the id of the frame that made each keyframe, the key of its
        # mapping and loop spans (telemetry)
        self._kf_key: dict[int, int] = {}
        # keyframes waiting for cooperative mapping, and the running one
        self._coop_pending: list[int] = []
        self._coop_gen = None
        # mbAbortBA (LocalMapping.cc:70-78): the tracker sets it, the local
        # BA's chunks poll it
        self.abort_ba = False
        # a keyframe the tracker re-anchors on at its next frame (a global
        # BA merged while frames were in flight, or a loop corrected or a
        # GBA merged on another thread)
        self._pending_pose_jump: Optional[int] = None
        # the tracker's visibility counters, buffered in async mode and
        # flushed at the next keyframe insertion
        self._pending_vis: list = []

    def activate_localization_mode(self):
        """Track against the frozen map without inserting keyframes
        (System::ActivateLocalizationMode, System.cc:311-319), once the
        frames in flight are committed and mapping has drained (in async
        mode: the workers and a GBA in flight)."""
        self.flush_pipeline()
        self._drain_mapping()
        if self.mapper is not None:
            self.mapper.wait_idle(300)
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def shutdown(self):
        """Drain the mapping pipeline (System::Shutdown, System.cc:336-353):
        commit the frames in flight, run cooperative mapping to its end, and
        in async mode wait for the workers, stop them and raise the first
        exception one of them kept."""
        self.flush_pipeline()
        self._drain_mapping()
        if self.mapper is not None:
            self.mapper.wait_idle(timeout=300)
            mapper, self.mapper = self.mapper, None
            mapper.shutdown()

    def wait_mapping_idle(self, timeout: float = 60.0) -> bool:
        """Run cooperative mapping until every queued keyframe is mapped, or
        in async mode wait up to ``timeout`` s for the workers and a GBA in
        flight; True when nothing is left."""
        self._drain_mapping()
        if self.mapper is not None:
            return self.mapper.wait_idle(timeout=timeout)
        return not self._coop_busy()

    # ---------------------------------------------------- the published map
    @property
    def map(self) -> MapState:
        """The published map, ready on the calling thread's current stream.
        In async mode on the card each map comes with an event recorded on
        its writer's stream: the first read on another thread's stream waits
        for it, and marks every bank as used by that stream, so that the
        caching allocator does not hand a bank's block back to the writer
        while the reader's work on it is still queued.  A caller that reads
        the map more than once for one result takes it once into a local."""
        pub = self._pub
        if pub[1] is not None and getattr(self._tls, "ready", None) is not pub:
            self._make_ready(pub)
        return pub[0]

    @map.setter
    def map(self, m: MapState) -> None:
        event = None
        if self._streams is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._pub = self._tls.ready = (m, event)

    def _make_ready(self, pub) -> MapState:
        """``pub`` = (map, event) made ready on the current stream."""
        m, event = pub
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for f in dataclasses.fields(m):
                getattr(m, f.name).record_stream(stream)
        self._tls.ready = pub
        return m

    def _publish_under_lock(self) -> None:
        """Publish the map again with an event after the device work this
        thread queued since its last publish (the KeyFrameDB's rows, which
        are written in place)."""
        if self._streams is not None:
            with self._map_lock():
                self.map = self.map

    def _map_lock(self):
        """The map-writer lock (a null context without the async mode's
        workers).  Held across one mutation's dispatch and its publish, the
        read of ``self.map`` included, so that no other writer's publish is
        lost between the two; host reads of the mapping path stay outside
        it where the path allows."""
        if self.mapper is not None:
            return self.mapper.write_lock
        return contextlib.nullcontext()

    def _on_stream(self, name: str):
        """A worker thread's stream as its current stream (a null context
        on the CPU)."""
        if self._streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._streams[name])

    def _sync_stream(self) -> None:
        """Wait for the calling thread's current stream (nothing on the
        CPU)."""
        if self._streams is not None:
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------------- tracking
    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(host).to(self.device)

    def track_stereo(self, img_l, img_r, timestamp: float) -> Optional[np.ndarray]:
        """Host frame: rectified grayscale left and right images in [0, 255]."""
        return self._track_entry(self._to_device(_encode_img(img_l)),
                                 self._to_device(_encode_img(img_r)), timestamp)

    def track_rgbd(self, img, depth, timestamp: float) -> Optional[np.ndarray]:
        """Host frame: grayscale image in [0, 255] and depth in meters."""
        return self._track_entry(self._to_device(_encode_img(img)),
                                 self._to_device(_encode_depth(depth)), timestamp)

    def track_monocular(self, img, timestamp: float) -> Optional[np.ndarray]:
        """Host frame: grayscale image in [0, 255]."""
        return self._track_entry(self._to_device(_encode_img(img)), None, timestamp)

    # Frames already in the wire encoding (uint8 grayscale, uint16 millimetre
    # depth) and on ``self.device``.
    def track_rgbd_device(self, img_u8: torch.Tensor, depth_u16: torch.Tensor,
                          timestamp: float) -> Optional[np.ndarray]:
        return self._track_entry(img_u8, depth_u16, timestamp)

    def track_stereo_device(self, img_l_u8: torch.Tensor, img_r_u8: torch.Tensor,
                            timestamp: float) -> Optional[np.ndarray]:
        return self._track_entry(img_l_u8, img_r_u8, timestamp)

    def track_monocular_device(self, img_u8: torch.Tensor,
                               timestamp: float) -> Optional[np.ndarray]:
        return self._track_entry(img_u8, None, timestamp)

    def _track_entry(self, raw_a, raw_b, timestamp: float):
        self.frame_id += 1
        with telemetry.timer("frame", self.frame_id):
            if self._pending_pose_jump is not None:
                # a global BA merged while frames were in flight: re-anchor
                self.last_pose = self.map.kf_pose[self._pending_pose_jump]
                self.velocity = None
                self._pending_pose_jump = None
            if self.state == TrackState.OK and not self.localization_only:
                # the steady state: the whole per-frame path is one fused step
                return self._track_fused(raw_a, raw_b, timestamp)
            self.flush_pipeline()
            # initialization, a frame after a loss and localization-only frames
            # run the decomposed steps
            with telemetry.timer("track.decomposed"):
                return self._track(self._build_frame(raw_a, raw_b), timestamp)

    def _build_frame(self, raw_a, raw_b) -> FrameData:
        """``raw_b`` is the depth map (RGB-D), the right image (stereo) or
        None (monocular)."""
        if self.sensor == "stereo":
            return build_frame_stereo(_decode_img(raw_a), _decode_img(raw_b),
                                      self.cam, self.cfg.orb)
        if self.sensor == "rgbd":
            return build_frame_rgbd(_decode_img(raw_a), _decode_depth(raw_b),
                                    self.cam, self.cfg.orb)
        return build_frame_mono(_decode_img(raw_a), self.cam, self.cfg.orb)

    @property
    def _motion_window(self) -> float:
        """SearchByProjection window of the motion model, in pixels at level
        0 (Tracking.cc:795-799)."""
        return 7.0 if self.sensor == "stereo" else 15.0

    def _track(self, frame: FrameData, timestamp: float) -> Optional[np.ndarray]:
        """The decomposed path: initialization, a frame after a loss, and
        every frame of localization-only mode."""
        if self.state == TrackState.NOT_INITIALIZED:
            ok = (self._initialize_mono(frame) if self.sensor == "monocular"
                  else self._initialize_depth(frame))
            if not ok:
                return None
            self.state = TrackState.OK
            self._log_frame(timestamp, lost=False)
            return _host(self.last_pose)

        relocalized = False
        if self.state == TrackState.LOST:
            # reset when lost right after initialization (Tracking.cc:421-428)
            if self.n_kf <= 5 and not self.localization_only:
                self.reset()
                return None
            relocalized, pose, pt_idx = self._relocalize(frame)
            if not relocalized:
                self._log_frame(timestamp, lost=True)
                return None
            # a relocalized frame goes straight to the local map
            # (Tracking.cc:291, 335-346)
            self.velocity = None
            self.last_reloc_frame_id = self.frame_id

        if not relocalized and self.localization_only and self.mb_vo:
            # VO mode: the map is out of view; try relocalizing on every such
            # frame (Tracking.cc:312-361)
            relocalized, pose_r, pt_r = self._relocalize(frame)
            if relocalized:
                pose, pt_idx = pose_r, pt_r
                self.mb_vo = False
                self.velocity = None
                self.last_reloc_frame_id = self.frame_id

        vo_n_tot = 0
        if not relocalized:
            # --- pose prediction + motion-model tracking -------------------
            pose0 = (self.velocity @ self.last_pose if self.velocity is not None
                     else self.last_pose)
            th = self._motion_window
            pt_idx, n_m = self._motion_track(frame, pose0, th)
            if int(_host(n_m)) < 20:    # widen the window 2x (Tracking.cc:802)
                pt_idx, n_m = self._motion_track(frame, pose0, 2 * th)

            pose, ok = pose0, False
            if self.localization_only and self.sensor != "monocular":
                # localization-only tracking always adds temporal points from
                # the last frame's depth to the motion model (UpdateLastFrame,
                # Tracking.cc:724-778); mbVO = the map matches collapsed
                # (Tracking.cc:299-361)
                pose, pt_idx, n_map, vo_n_tot = self._track_vo(frame, pose0, pt_idx, th)
                ok = vo_n_tot > 20
                self.mb_vo = ok and n_map < 10
                if self.mb_vo:
                    self.stats["vo_tracks"] += 1
            elif int(_host(n_m)) >= 20:
                seed = (pose0 if self.cfg.tracking.seed_pose_opt_from_prediction
                        else self.last_pose)
                pose, pt_idx, n_inliers = self._pose_opt_against_map(frame, seed, pt_idx)
                ok = int(_host(n_inliers)) >= self.cfg.tracking.min_inliers_track
                if ok:
                    self.stats["motion_tracks"] += 1

            if not ok:
                ok, pose2, pt2 = self._track_reference_keyframe(frame)
                if ok:
                    pose, pt_idx = pose2, pt2
                    self.stats["ref_kf_tracks"] += 1
                    self.mb_vo = False
            if not ok:
                self.state = TrackState.LOST
                self._log_frame(timestamp, lost=True)
                return None

        if self.localization_only and self.mb_vo:
            # pure-VO frame: no local map in view (Tracking.cc:330-346)
            return self._finish_vo_frame(frame, pose, pt_idx, timestamp)

        # --- track local map -----------------------------------------------
        pose, pt_idx, n_map_inliers = self._track_local_map(frame, pose, pt_idx)
        n_map_inliers = int(_host(n_map_inliers))
        if n_map_inliers < self._local_map_bar():
            if self.localization_only and vo_n_tot > 20:
                # where the reference goes LOST (Tracking.cc:352-361) the JAX
                # package degrades to VO: the map is frozen and cannot be
                # corrupted, and frame-to-frame VO is still strong
                self.mb_vo = True
                self.stats["vo_tracks"] += 1
                return self._finish_vo_frame(frame, pose, pt_idx, timestamp)
            self.state = TrackState.LOST
            self._log_frame(timestamp, lost=True)
            return None

        self._advance(frame, pose, pt_idx, relocalized)
        if (not self.localization_only
                and self._need_new_keyframe(frame, pt_idx, n_map_inliers)):
            self._create_keyframe(frame, pose, pt_idx)
        self._log_frame(timestamp, lost=False)
        return _host(pose)

    def _fused_step(self, raw_a, raw_b, last_pt, last_octave, last_angle, last_pose,
                    velocity, have_vel, ref_kf, min_obs, kf_pose, kf_point_idx,
                    kf_feat_valid, pt_pos, pt_valid, pt_desc, pt_normal, pt_min_dist,
                    pt_max_dist, pt_obs_kf):
        """The whole per-frame OK-state path as device work with no host
        read (the JAX ``_build_fused_track.step``).  It reads tensors only:
        the velocity is the identity where ``have_vel`` is false, and the
        reference keyframe and the observation bar are device int32, so
        that one CUDA graph of it serves every frame
        (``frontend/fused_graph.py``).  Returns (frame, [Tcw, Tcr], map
        point per feature, the local map's points, the (6,) int32 scalars);
        the commit applies the visibility counters.  Its seven stages are
        ``stage`` marks, from the frame build to the counts."""
        cam, cfg = self.cam, self.cfg
        n_levels = cfg.orb.n_levels
        P = pt_pos.shape[0]
        th = self._motion_window
        with stage("track.build"):
            frame = self._build_frame(raw_a, raw_b)

        def motion(win):
            return TK.match_motion_model(
                cam, pose0, frame, last_pt, last_octave, pt_pos, pt_valid, pt_desc,
                last_angle, th=win, scale_factors=self.scale_factors, nn_max_dist=75,
            )

        # 2x window retry when fewer than 20 matches (Tracking.cc:802).  The
        # JAX step branches on the device with lax.cond; here both widths
        # are matched and the result selected on the device, which keeps the
        # step free of host reads and gives the same answer.
        with stage("track.motion"):
            pose0 = torch.where(have_vel, velocity @ last_pose, last_pose)
            r1, r_wide = motion(th), motion(2 * th)
            retry = r1.n_matches < 20
            r = TK.ProjMatchResult(
                pt_idx=torch.where(retry, r_wide.pt_idx, r1.pt_idx),
                n_matches=torch.where(retry, r_wide.n_matches, r1.n_matches),
            )
        with stage("track.pose1"):
            inv_s2 = self.inv_sigma2_table[torch.clamp(frame.octave, 0, n_levels - 1).long()]
            is_st = frame.uvr[:, 2] >= 0
            seed1 = pose0 if cfg.tracking.seed_pose_opt_from_prediction else last_pose
            o1 = optimize_pose(cam, seed1, pt_pos[torch.clamp(r.pt_idx, min=0).long()],
                               frame.uvr, inv_s2, r.pt_idx >= 0, is_st)
            pt1 = torch.where(o1.inlier, r.pt_idx, -1)

        # local map (TrackLocalMap)
        with stage("track.local_select"):
            already = map_ops.set_rows(torch.zeros(P, dtype=torch.bool, device=pt_pos.device),
                                       torch.where(pt1 >= 0, pt1, P), True)
            local = TK.select_local_points(
                cam, o1.Tcw, pt_pos, pt_valid, pt_normal, pt_min_dist, pt_max_dist, already,
                budget=4096, scale_factor=cfg.orb.scale_factor, n_levels=n_levels,
            )
        with stage("track.local_match"):
            r2 = TK.match_local_points(frame, local, pt_desc, pt1, th=1.0,
                                       scale_factors=self.scale_factors)
        with stage("track.pose2"):
            o2 = optimize_pose(cam, o1.Tcw, pt_pos[torch.clamp(r2.pt_idx, min=0).long()],
                               frame.uvr, inv_s2, r2.pt_idx >= 0, is_st)
            pt2 = torch.where(o2.inlier, r2.pt_idx, -1)

        with stage("track.counts"):
            # NeedNewKeyFrame close counts (Tracking.cc:911-927)
            close = (frame.depth > 0) & (frame.depth < self.th_depth_m) & frame.valid
            tracked_close = (close & (pt2 >= 0)).sum(dtype=torch.int32)
            untracked_close = (close & (pt2 < 0)).sum(dtype=torch.int32)

            # nRefMatches: the reference keyframe's landmarks with >= min_obs
            # observations (Tracking.cc:897-899); obs slots of culled keyframes
            # are cleared, so pt_obs_kf >= 0 alone is the validity test.  The
            # reference keyframe's rows come by index_select of the device index.
            ref = ref_kf.reshape(1).long()
            n_obs = (pt_obs_kf >= 0).sum(dim=1, dtype=torch.int32)
            ref_pt = kf_point_idx.index_select(0, ref)[0]
            rp = torch.clamp(ref_pt, min=0).long()
            ref_has = ((ref_pt >= 0) & kf_feat_valid.index_select(0, ref)[0] & pt_valid[rp]
                       & (n_obs[rp] >= min_obs))
            ref_tracked = ref_has.sum(dtype=torch.int32)

            Tcr = o2.Tcw @ se3.inv(kf_pose.index_select(0, ref)[0])
            scalars = torch.stack([
                r.n_matches, o1.n_inliers, o2.n_inliers,
                tracked_close, untracked_close, ref_tracked,
            ]).to(torch.int32)
            poses_out = torch.stack([o2.Tcw, Tcr])
        return frame, poses_out, pt2, local.idx, scalars

    def _scalar(self, value, dtype) -> torch.Tensor:
        """A 0-dim device tensor per (value, dtype), made once: the graph's
        buffer is then refilled only when the value changes."""
        key = (value, dtype)
        if key not in self._scalars:
            self._scalars[key] = torch.full((), value, dtype=dtype, device=self.device)
        return self._scalars[key]

    def _fused_inputs(self, raw_a, raw_b) -> dict:
        """The fused step's inputs from the tracker's state and the map,
        read once (in async mode another thread may publish a new one
        meanwhile)."""
        last, m = self.last_frame, self.map
        return dict(
            raw_a=raw_a, raw_b=raw_b, last_pt=self.last_pt_idx, last_octave=last.octave,
            last_angle=last.angle, last_pose=self.last_pose,
            velocity=self._eye4 if self.velocity is None else self.velocity,
            have_vel=self._scalar(self.velocity is not None, torch.bool),
            ref_kf=self._scalar(int(self.ref_kf), torch.int32),
            min_obs=self._scalar(3 if self.n_kf > 2 else 2, torch.int32),   # Tracking.cc:897
            kf_pose=m.kf_pose, kf_point_idx=m.kf_point_idx, kf_feat_valid=m.kf_feat_valid,
            pt_pos=m.pt_pos, pt_valid=m.pt_valid, pt_desc=m.pt_desc, pt_normal=m.pt_normal,
            pt_min_dist=m.pt_min_dist, pt_max_dist=m.pt_max_dist, pt_obs_kf=m.pt_obs_kf,
        )

    def _run_fused(self, inputs: dict):
        """The fused step on ``inputs``: on the card one CUDA graph replay
        (captured at the first call), on the CPU the eager step."""
        if self.device.type != "cuda":
            return self._fused_step(**inputs)
        if self._graph is None:
            self._graph = FusedGraph(self._fused_step)
        if self._graph.graph is None and self.mapper is not None:
            # the capture: the mapping worker parked, its stream idle
            with self.mapper.stopped():
                return self._graph.run(inputs)
        return self._graph.run(inputs)

    def _dispatch_fused(self, raw_a, raw_b, timestamp: float) -> dict:
        """Enqueue the fused step and return an unresolved record: its
        outputs and the tracker state it was dispatched from.  On the card
        the pose stack and the scalars start their copy into pinned host
        memory at once (``_start_read``)."""
        with telemetry.timer("track.dispatch", self.frame_id):
            frame, poses_out, pt2, local_idx, sc = self._run_fused(
                self._fused_inputs(raw_a, raw_b))
            rec = dict(frame=frame, poses_out=poses_out, pt2=pt2, local_idx=local_idx, sc=sc,
                       timestamp=timestamp, frame_id=self.frame_id, ref_kf=self.ref_kf,
                       prev_pose=self.last_pose, prev_frame=self.last_frame,
                       prev_pt_idx=self.last_pt_idx, prev_velocity=self.velocity)
            rec["reads"] = (_start_read(poses_out), _start_read(sc))
            return rec

    def _commit_fused(self, rec: dict) -> Optional[np.ndarray]:
        """The per-frame state machine on a resolved fused record (the JAX
        ``_commit_fused``).  The tracker's ``last_*`` already hold this
        record's outputs (``_track_fused``) and roll back to the record's
        ``prev_*`` before a fallback or a loss.  Returns the frame's pose or
        None.  On the motion model's path with no keyframe it makes two host
        reads, the pose stack and the scalars (``_finish_read``); the
        fallback, a loss and a keyframe read more."""
        with telemetry.timer("track.commit", rec["frame_id"]):
            with telemetry.timer("track.read"):
                poses_np, s = (_finish_read(r) for r in rec["reads"])
            pose_np, Tcr_np = poses_np[0], poses_np[1]
            frame, timestamp, frame_id = rec["frame"], rec["timestamp"], rec["frame_id"]
            n_motion, n_inl1, n_map, t_close, u_close, ref_tracked = (int(x) for x in s)
            ok_motion = n_motion >= 20 and n_inl1 >= self.cfg.tracking.min_inliers_track

            def rollback():
                self.last_pose, self.last_frame = rec["prev_pose"], rec["prev_frame"]
                self.last_pt_idx, self.velocity = rec["prev_pt_idx"], rec["prev_velocity"]

            if ok_motion:
                self.stats["motion_tracks"] += 1
                pose, pt_idx = rec["poses_out"][0], rec["pt2"]
                n_map_inliers = n_map
                self._count_visibility(rec["local_idx"], pt_idx)
                close_counts = (t_close, u_close)
                self._ref_matches = ref_tracked
            else:
                # TrackReferenceKeyFrame fallback + decomposed local map
                with telemetry.timer("track.fallback"):
                    rollback()
                    ok, pose, pt_idx = self._track_reference_keyframe(frame)
                    if not ok:
                        self.state = TrackState.LOST
                        self._log_frame(timestamp, lost=True, frame_id=frame_id)
                        return None
                    self.stats["ref_kf_tracks"] += 1
                    pose, pt_idx, n_mi = self._track_local_map(frame, pose, pt_idx)
                    n_map_inliers = int(_host(n_mi))
                close_counts = None
                Tcr_np = None
                pose_np = None

            if n_map_inliers < self._local_map_bar(frame_id):
                rollback()
                self.state = TrackState.LOST
                self._log_frame(timestamp, lost=True, frame_id=frame_id)
                return None

            if not ok_motion:       # the motion path's last_* are its dispatch's
                self._advance(frame, pose, pt_idx)
            self.state = TrackState.OK
            # the step's Tcr is relative to the reference keyframe of the
            # dispatch, which an older record's keyframe may have replaced since
            ref_kf = rec["ref_kf"] if Tcr_np is not None else self.ref_kf
            if self._need_new_keyframe(frame, pt_idx, n_map_inliers, close_counts,
                                       frame_id=frame_id):
                with telemetry.timer("track.keyframe"):
                    self._create_keyframe(frame, pose, pt_idx, frame_id=frame_id)
                # the frame is the new keyframe: from the tracker's pose, which
                # mapping moved with it, or, while younger frames are in flight
                # and last_pose is theirs, as the keyframe itself
                Tcr_np = np.eye(4, dtype=np.float32) if self._inflight else None
                ref_kf = self.ref_kf
            self._log_frame(timestamp, lost=False, Tcr=Tcr_np, frame_id=frame_id, ref_kf=ref_kf)
            return _host(pose) if pose_np is None else pose_np

    def _track_fused(self, raw_a, raw_b, timestamp: float):
        """A steady-state tracked frame: commit the frames dispatched
        ``pipeline_depth`` calls ago, dispatch this one against the
        tracker's uncommitted device state and chain the tracker on its
        outputs.  At depth 0 (synchronous mode) the frame is committed at
        once and the call returns its host pose, or None for a lost frame:
        one dispatch and ``_commit_fused``'s two host reads (more at a
        fallback or a keyframe).  Deeper, the call returns the pose as a
        device tensor, and a loss shows up to ``depth`` frames late; the
        frames in flight and this one then go through the decomposed path."""
        while self._inflight and len(self._inflight) >= self.pipeline_depth:
            self._commit_fused(self._inflight.pop(0))
            if self.state != TrackState.OK:
                self.flush_pipeline()
                with telemetry.timer("track.decomposed"):
                    return self._track(self._build_frame(raw_a, raw_b), timestamp)
        rec = self._dispatch_fused(raw_a, raw_b, timestamp)
        pose_dev = rec["poses_out"][0]
        # the next dispatch chains on device values
        self.velocity = pose_dev @ se3.inv(self.last_pose)
        self.last_pose = pose_dev
        self.last_frame = rec["frame"]
        self.last_pt_idx = rec["pt2"]
        if not self.pipeline_depth:
            pose = self._commit_fused(rec)
            if self.cooperative:
                self._pump_mapping()
            return pose
        self._inflight.append(rec)
        # one bounded mapping step in the shadow of this frame's device
        # work, proportionally more when keyframes queue up
        if self.cooperative:
            backlog = self._coop_backlog()
            self._pump_mapping(1 if backlog <= 1 else 4 * backlog)
        return pose_dev

    def flush_pipeline(self):
        """Commit every frame in flight (nothing in synchronous mode).  Once
        an older frame turns out lost, the younger ones' results, dispatched
        on its outputs, are void: they go through the decomposed path
        instead, with their own frame ids (their frames were kept)."""
        while self._inflight:
            rec = self._inflight.pop(0)
            if self.state == TrackState.OK:
                self._commit_fused(rec)
            else:
                saved = self.frame_id
                self.frame_id = rec["frame_id"]
                try:
                    with telemetry.timer("track.decomposed", rec["frame_id"]):
                        self._track(rec["frame"], rec["timestamp"])
                finally:
                    self.frame_id = saved

    # ----------------------------------------------------------- sub-steps
    def _local_map_bar(self, frame_id: Optional[int] = None) -> int:
        """TrackLocalMap's inlier bar, stricter for ``max_frames_between_kf``
        frames after a relocalization (Tracking.cc:870-877)."""
        t = self.cfg.tracking
        fid = self.frame_id if frame_id is None else frame_id
        recent = (self.last_reloc_frame_id >= 0
                  and fid - self.last_reloc_frame_id < t.max_frames_between_kf)
        return t.min_inliers_local_map_reloc if recent else t.min_inliers_local_map

    def _advance(self, frame: FrameData, pose, pt_idx, relocalized: bool = False):
        """The tracker's state after a tracked frame.  A relocalized frame
        has no previous pose to difference against, so it leaves no velocity
        (Tracking.cc:376-383)."""
        self.velocity = None if relocalized else pose @ se3.inv(self.last_pose)
        self.last_pose = pose
        self.last_frame = frame
        self.last_pt_idx = pt_idx
        self.state = TrackState.OK

    def _finish_vo_frame(self, frame: FrameData, pose, pt_idx, timestamp):
        """A localization-only frame tracked by visual odometry alone (no
        local map)."""
        self._advance(frame, pose, pt_idx)
        self._log_frame(timestamp, lost=False)
        return _host(pose)

    def _motion_track(self, frame: FrameData, pose0, th: float):
        last, m = self.last_frame, self.map
        res = TK.match_motion_model(
            self.cam, pose0, frame, self.last_pt_idx, last.octave,
            m.pt_pos, m.pt_valid, m.pt_desc, last.angle,
            th=th, scale_factors=self.scale_factors, nn_max_dist=75,
        )
        return res.pt_idx, res.n_matches

    def _track_vo(self, frame: FrameData, pose0, pt_idx, th: float):
        """The surviving map matches together with temporal points from the
        last frame's depth, pose-optimized over the union.  Returns (pose,
        map point per feature, map inliers, all inliers); one host read."""
        last, m = self.last_frame, self.map
        res = TK.match_vo_points(
            self.cam, pose0, frame, last.xy, last.depth, last.valid,
            self.last_pt_idx, last.octave, last.angle, last.desc, self.last_pose,
            th=2 * th, scale_factors=self.scale_factors,
        )
        p = torch.clamp(pt_idx, min=0).long()
        map_valid = (pt_idx >= 0) & m.pt_valid[p]
        pw = torch.where(map_valid[:, None], m.pt_pos[p], res.pw)
        n_levels = self.cfg.orb.n_levels
        inv_s2 = self.inv_sigma2_table[torch.clamp(frame.octave, 0, n_levels - 1).long()]
        result = optimize_pose(self.cam, self.last_pose, pw, frame.uvr, inv_s2,
                               map_valid | res.mask, frame.uvr[:, 2] >= 0)
        map_inlier = result.inlier & map_valid
        n_map, n_tot = _host(torch.stack([map_inlier.sum(dtype=torch.int32),
                                          result.n_inliers.to(torch.int32)])).tolist()
        return result.Tcw, torch.where(map_inlier, pt_idx, -1), n_map, n_tot

    def _set_ref_kf(self, kf_slot: int):
        """Reference keyframe and its tracked-landmark count
        (KeyFrame::TrackedMapPoints, Tracking.cc:887-899)."""
        self.ref_kf = int(kf_slot)
        min_obs = 3 if self.n_kf > 2 else 2
        pt = self.map.kf_point_idx[self.ref_kf]
        p = torch.clamp(pt, min=0).long()
        has = ((pt >= 0) & self.map.kf_feat_valid[self.ref_kf]
               & self.map.pt_valid[p] & (n_observations(self.map)[p] >= min_obs))
        self._ref_matches = int(_host(has.sum()))

    def _track_reference_keyframe(self, frame: FrameData):
        """TrackReferenceKeyFrame (Tracking.cc:681-719): match the frame
        against the reference keyframe's landmark features, optimize the
        pose from the last one; returns (ok, pose, pt_idx)."""
        m, r = self.map, self.ref_kf
        res = TK.match_reference_kf(
            frame, m.kf_desc[r], m.kf_point_idx[r], m.kf_feat_valid[r],
            m.kf_angle[r], m.pt_valid, nn_ratio=self.cfg.matcher.nn_ratio_ref_kf,
        )
        if int(_host(res.n_matches)) < self.cfg.tracking.min_matches_ref_kf:
            return False, None, None
        pose, pt_idx, n_inl = self._pose_opt_against_map(frame, self.last_pose,
                                                         res.pt_idx)
        return int(_host(n_inl)) >= self.cfg.tracking.min_inliers_track, pose, pt_idx

    def _pose_opt_against_map(self, frame: FrameData, pose0, pt_idx):
        n_levels = self.cfg.orb.n_levels
        inv_s2 = self.inv_sigma2_table[torch.clamp(frame.octave, 0, n_levels - 1).long()]
        result = optimize_pose(
            self.cam, pose0, self.map.pt_pos[torch.clamp(pt_idx, min=0).long()],
            frame.uvr, inv_s2, pt_idx >= 0, frame.uvr[:, 2] >= 0,
        )
        return result.Tcw, torch.where(result.inlier, pt_idx, -1), result.n_inliers

    def _track_local_map(self, frame: FrameData, pose, pt_idx):
        """TrackLocalMap as separate steps, with the visibility counters."""
        P = self.map.pt_pos.shape[0]
        m = self.map
        already = map_ops.set_rows(torch.zeros(P, dtype=torch.bool, device=self.device),
                                   torch.where(pt_idx >= 0, pt_idx, P), True)
        local = TK.select_local_points(
            self.cam, pose, m.pt_pos, m.pt_valid, m.pt_normal,
            m.pt_min_dist, m.pt_max_dist, already, budget=4096,
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
        )
        res = TK.match_local_points(frame, local, m.pt_desc, pt_idx, th=1.0,
                                    scale_factors=self.scale_factors)
        pose, pt_idx, n_inl = self._pose_opt_against_map(frame, pose, res.pt_idx)
        self._count_visibility(local.idx, pt_idx)
        return pose, pt_idx, n_inl

    def _count_visibility(self, local_idx, pt_idx):
        """A tracked frame's IncreaseVisible / IncreaseFound counters
        (MapPoint.cc:214-227), which feed MapPointCulling: into the live
        map, or in async mode, where the mapper owns the map, buffered for
        ``_flush_pending_vis`` at the next keyframe insertion (the oldest go
        once 256 frames wait)."""
        if self.mapper is None:
            self.map = LM.update_visibility(self.map, local_idx, pt_idx)
            return
        self._pending_vis.append((local_idx, pt_idx))
        if len(self._pending_vis) > 256:
            self._pending_vis.pop(0)

    def _flush_pending_vis(self):
        """The buffered counters into the map (under the writer lock)."""
        for vis, fnd in self._pending_vis:
            self.map = LM.update_visibility(self.map, vis, fnd)
        self._pending_vis.clear()

    # ------------------------------------------------------- initialization
    def _initialize_depth(self, frame: FrameData) -> bool:
        """Stereo and RGB-D bootstrap (Tracking::StereoInitialization,
        Tracking.cc:454-503): enough features, then one point per feature
        with depth."""
        if self.sensor == "monocular":
            return False
        n_valid = int(_host(frame.valid.sum()))
        need = min(500, int(0.6 * self.n_feat_slots))
        if n_valid < need:
            return False
        # check the depth yield before touching the map
        if int(_host((frame.depth > 0).sum())) < 100:
            return False
        pose = torch.eye(4, dtype=torch.float32, device=self.device)
        no_pt = torch.full((frame.n_slots,), -1, dtype=torch.int32, device=self.device)
        kf_slot = self._insert_keyframe_arrays(frame, pose, no_pt, parent=-1)
        self.map, n_new = map_ops.create_points_from_depth(
            self.map, kf_slot, frame.depth, no_pt, self.cam,
            th_depth=1e9,   # init: all depths (Tracking.cc:476)
            pt_base=self.n_pt, max_new=self.n_feat_slots,
        )
        self.n_pt += int(_host(n_new))
        self.map = update_point_stats(self.map, scale_factor=self.cfg.orb.scale_factor,
                                      n_levels=self.cfg.orb.n_levels)
        self.last_pose = pose
        self.last_frame = frame
        self.last_pt_idx = self.map.kf_point_idx[kf_slot]
        self._set_ref_kf(kf_slot)
        self.last_kf_frame_id = self.frame_id
        return True

    def _initialize_mono(self, frame: FrameData) -> bool:
        """Monocular two-view bootstrap (Tracking::MonocularInitialization +
        CreateInitialMapMonocular, Tracking.cc:505-666): windowed matching
        against a stored reference frame, batched H/F RANSAC, the
        triangulated initial map, a 20-iteration BA and the median-depth
        scale normalization.  The minimal sets are drawn from a CPU
        generator seeded with the frame id.

        Spans: ``init`` (key: the frame id) around each call, with
        ``init.match``, ``init.two_view``, ``init.map`` and ``init.ba``
        inside; counters: ``init.attempts`` (a two-view solve ran),
        ``init.refused`` (it did not succeed), ``init.restarts`` (the
        reference frame was replaced or dropped) and ``init.accepted``."""
        with telemetry.timer("init", self.frame_id):
            n_valid = int(_host(frame.valid.sum()))
            if self._init_ref is None:
                if n_valid >= 100:
                    self._init_ref = frame
                return False
            if n_valid < 100:
                self._init_ref = None
                telemetry.inc("init.restarts")
                return False
            ref = self._init_ref

            # SearchForInitialization (ORBmatcher.cc:388-492): window 100 px,
            # ratio 0.9, mutual best.  The reference searches level 0 only but
            # doubles the feature budget of init frames (Tracking.cc:121); with
            # the normal budget levels 0-1 are admitted instead.
            with telemetry.timer("init.match"):
                geo = M.window_mask(ref.xy, frame.xy, 100.0)
                geo = geo & (ref.octave[:, None] <= 1) & (frame.octave[None, :] <= 1)
                res = M.nn_match(hamming(ref.desc, frame.desc), row_valid=ref.valid,
                                 col_valid=frame.valid, extra_mask=geo, max_dist=50,
                                 ratio=0.9, mutual=True)
                keep = M.rotation_consistency_mask(ref.angle, frame.angle, res)
                n_keep = int(_host(keep.sum()))
            if n_keep < 60:
                self._init_ref = frame      # restart with this frame (Tracking.cc:540)
                telemetry.inc("init.restarts")
                return False

            telemetry.inc("init.attempts")
            with telemetry.timer("init.two_view"):
                feat1 = torch.clamp(res.idx, min=0).long()
                xn1 = cam_mod.pixel_to_normalized(self.cam, ref.xy)
                xn2 = cam_mod.pixel_to_normalized(self.cam, frame.xy)[feat1]
                gen = torch.Generator(device="cpu")
                gen.manual_seed(self.frame_id)
                init = initialize_two_view(xn1, xn2, keep, gen, sigma_px=1.0,
                                           focal=float(self.cfg.camera.fx))

                # median depth of the good points (Tracking.cc:618-642): the
                # mean of the two middle values, as numpy.median
                good = init.inliers
                z_sorted = torch.sort(torch.where(good, init.points3d[:, 2],
                                                  float("inf"))).values
                n_good = good.sum()
                mid = torch.stack([torch.clamp(n_good - 1, min=0) // 2, n_good // 2])
                med_depth = z_sorted[mid].mean()
                success, med, n_new = _host(torch.stack(
                    [init.success.to(torch.float32), med_depth,
                     n_good.to(torch.float32)])).tolist()
            if not success:
                telemetry.inc("init.refused")
                return False
            if not med > 0:
                self._init_ref = None
                telemetry.inc("init.restarts")
                return False

            with telemetry.timer("init.map"):
                n_new = int(n_new)
                scale = 1.0 / med_depth
                pos = init.points3d * scale
                T1 = torch.eye(4, dtype=torch.float32, device=self.device)
                T2 = se3.from_rt(init.R21, init.t21 * scale)

                N = frame.n_slots
                no_pt = torch.full((N,), -1, dtype=torch.int32, device=self.device)
                kf0 = self._insert_keyframe_arrays(ref, T1, no_pt, parent=-1)
                kf1 = self._insert_keyframe_arrays(frame, T2, no_pt, parent=kf0)

                # the triangulated points, observed by both keyframes: good
                # match i (feature i of the reference frame, feature feat1[i]
                # of this one) takes slot n_pt + its rank among the good
                m = self.map
                P = m.pt_pos.shape[0]
                slot = self.n_pt + torch.cumsum(good, dim=0) - 1
                rows = torch.where(good, slot, P)                  # P = dropped
                slot32 = slot.to(torch.int32)
                dist_v = torch.linalg.norm(pos, dim=1)
                sfac = self.cfg.orb.scale_factor
                max_d = dist_v * sfac ** ref.octave.to(torch.float32)
                feat0 = torch.arange(N, dtype=torch.int32, device=self.device)
                obs_kf = map_ops.set_rows(map_ops.set_rows(m.pt_obs_kf, rows, kf0, col=0),
                                          rows, kf1, col=1)
                obs_feat = map_ops.set_rows(map_ops.set_rows(m.pt_obs_feat, rows, feat0, col=0),
                                            rows, feat1.to(torch.int32), col=1)
                kf_point_idx = m.kf_point_idx.clone()
                kf_point_idx[kf0] = torch.where(good, slot32, m.kf_point_idx[kf0])
                kf_point_idx[kf1] = map_ops.set_rows(m.kf_point_idx[kf1],
                                                     torch.where(good, feat1, N), slot32)
                self.map = m.replace(
                    pt_pos=map_ops.set_rows(m.pt_pos, rows, pos),
                    pt_valid=map_ops.set_rows(m.pt_valid, rows, True),
                    pt_desc=map_ops.set_rows(m.pt_desc, rows, ref.desc),
                    pt_normal=map_ops.set_rows(
                        m.pt_normal, rows, pos / torch.clamp(dist_v, min=1e-9)[:, None]),
                    pt_min_dist=map_ops.set_rows(
                        m.pt_min_dist, rows, max_d / sfac ** (self.cfg.orb.n_levels - 1)),
                    pt_max_dist=map_ops.set_rows(m.pt_max_dist, rows, max_d),
                    pt_ref_kf=map_ops.set_rows(m.pt_ref_kf, rows, kf1),
                    pt_first_kf=map_ops.set_rows(m.pt_first_kf, rows, kf0),
                    pt_obs_kf=obs_kf,
                    pt_obs_feat=obs_feat,
                    kf_point_idx=kf_point_idx,
                )
                self.n_pt += n_new

            # init global BA, 20 iterations (Tracking.cc:618)
            with telemetry.timer("init.ba"):
                slots = torch.arange(self.map.kf_valid.shape[0], device=self.device)
                self._windowed_ba(slots == kf1, slots == kf0, 20, 0)
                self.map = update_point_stats(self.map, scale_factor=sfac,
                                              n_levels=self.cfg.orb.n_levels)
            self.last_pose = self.map.kf_pose[kf1]
            self.last_frame = frame
            self.last_pt_idx = self.map.kf_point_idx[kf1]
            self._set_ref_kf(kf1)
            self.last_kf_frame_id = self.frame_id
            self._init_ref = None
            telemetry.inc("init.accepted")
            return True

    # ----------------------------------------------------------- keyframes
    def _need_new_keyframe(self, frame: FrameData, pt_idx, n_inliers: int,
                           close_counts: Optional[tuple] = None,
                           frame_id: Optional[int] = None) -> bool:
        """NeedNewKeyFrame (Tracking.cc:880-962).  ``close_counts`` =
        (tracked_close, untracked_close) from the fused step; computed here
        otherwise.  ``frame_id``: the frame decided on, when it is not the
        newest (a pipelined commit).  Mapping is busy while a keyframe is
        queued or being mapped (cooperative mode) or while the mapping
        worker is not idle (async mode): then c1b fails, and a keyframe that
        is still needed interrupts the local BA and, for stereo and RGB-D,
        goes in while fewer than 3 are queued; in async mode the tracker
        waits up to 500 ms for the queue to drop below 3, then skips the
        keyframe with a ``mapping_backlog`` warning."""
        if self.n_kf >= self.cfg.map.max_keyframes - 2:
            telemetry.warn(
                "kf_capacity",
                f"keyframe bank full ({self.n_kf}/{self.cfg.map.max_keyframes})"
                " — no further keyframes will be inserted; raise "
                "MapConfig.max_keyframes",
            )
            return False
        mapper_idle = self.mapper.idle if self.mapper is not None else not self._coop_busy()
        fid = self.frame_id if frame_id is None else frame_id
        frames_since = fid - self.last_kf_frame_id
        ref_matches = self._ref_matches
        mono = self.sensor == "monocular"
        # thRefRatio (Tracking.cc:922-928): 0.9 for monocular, 0.4 with a
        # near-empty map, 0.75 otherwise
        th_ratio = 0.9 if mono else 0.4 if self.n_kf < 2 else 0.75
        need_close = False
        if not mono:
            if close_counts is None:
                d = _host(frame.depth)
                pid = _host(pt_idx)
                close = (d > 0) & (d < self.th_depth_m)
                close_counts = (int((close & (pid >= 0)).sum()),
                                int((close & (pid < 0)).sum()))
            tracked_close, untracked_close = close_counts
            need_close = tracked_close < 100 and untracked_close > 70
        c1a = frames_since >= self.cfg.tracking.max_frames_between_kf
        c1b = frames_since >= self.cfg.tracking.min_frames_between_kf and mapper_idle
        c1c = not mono and (n_inliers < ref_matches * 0.25 or need_close)
        c2 = (n_inliers < ref_matches * th_ratio or need_close) and n_inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if mapper_idle:
            return True
        # mapping busy: interrupt its local BA (Tracking.cc:951 InterruptBA)
        # and, for stereo and RGB-D, insert anyway while the queue is short
        # (Tracking.cc:952-959), draining it here first when it is not
        self.abort_ba = True
        if mono:
            return False
        if self.mapper is None:
            if self._coop_backlog() >= 3:
                self._pump_mapping(32)
            return self._coop_backlog() < 3
        # async backpressure: a bounded window for the worker to drain
        # rather than skipping a needed keyframe at once, which starves the
        # map (the tracker sleeps, yielding the GIL)
        deadline = time.monotonic() + 0.5
        while self.mapper.queue_len() >= 3:
            if time.monotonic() >= deadline:
                telemetry.warn(
                    "mapping_backlog",
                    "mapping queue still full after 500 ms backpressure window — "
                    "keyframe skipped (mapping cannot keep up with the frame rate)",
                )
                return False
            time.sleep(0.005)
        return True

    def _insert_keyframe_arrays(self, frame: FrameData, pose, matched_pt,
                                parent: int) -> int:
        kf_slot = self.n_kf
        # the KeyFrameDB's rows are written in place: before the publish,
        # whose event orders them for the workers' streams
        self._register_keyframe_bow(kf_slot, frame)
        self.map = map_ops.insert_keyframe(
            self.map, kf_slot, self.frame_id, pose,
            frame.xy, frame.uvr, frame.octave, frame.angle, frame.desc,
            frame.valid, matched_pt, parent,
        )
        self.n_kf += 1
        return kf_slot

    def _register_keyframe_bow(self, kf_slot: int, frame: FrameData):
        """Add the keyframe's tf-idf signature to the KeyFrameDB, loading the
        vocabulary first if need be.  Its order (the reference cannot run
        without ORBvoc either, System.cc:74-121): ``cfg.vocab_path``, then
        the packaged asset (``assets/vocab.npz``), then, only under
        ``cfg.allow_vocab_fallback``, a small vocabulary trained on this
        frame's descriptors; else ``FileNotFoundError``."""
        if self.vocab is None:
            path = self.cfg.vocab_path or VOCAB_ASSET
            if os.path.exists(path):
                self.vocab = load_vocabulary(path, self.device)
            elif self.cfg.allow_vocab_fallback:
                telemetry.warn(
                    "vocab_fallback",
                    f"vocabulary asset not found at {path} — training a "
                    "one-frame fallback vocabulary (degraded loop recall)",
                )
                descs = _host(frame.desc[frame.valid])
                n_words = min(256, max(32, len(descs) // 4))
                self.vocab = train_vocabulary(descs, n_words=n_words, iters=4,
                                              device=self.device)
            else:
                raise FileNotFoundError(
                    f"vocabulary asset not found at {path}; point cfg.vocab_path "
                    "at one, or opt in to the degraded one-frame fallback with "
                    "SystemConfig(allow_vocab_fallback=True) (the reference "
                    "likewise requires ORBvoc, System.cc:74-83)"
                )
            self.db = KeyFrameDB(self.vocab, self.cfg.map.max_keyframes)
        self.db.add(kf_slot, frame.desc, frame.valid)

    def _insert_kf_with_points(self, frame: FrameData, pose, pt_idx) -> int:
        kf_slot = self._insert_keyframe_arrays(frame, pose, pt_idx, parent=self.ref_kf)
        if self.sensor == "monocular":
            return kf_slot
        # stereo and RGB-D: close points for untracked features
        # (CreateNewKeyFrame, Tracking.cc:976-1023)
        cap = self.map.pt_pos.shape[0]
        if self.n_pt >= cap - 128:
            telemetry.warn(
                "pt_capacity",
                f"map-point bank full ({self.n_pt}/{cap}) — close-point "
                "creation suspended; raise MapConfig.max_points",
            )
        else:
            self.map, n_new = map_ops.create_points_from_depth(
                self.map, kf_slot, frame.depth, pt_idx, self.cam,
                th_depth=float(self.th_depth_m), pt_base=self.n_pt, max_new=128,
            )
            self.n_pt += int(_host(n_new))
        return kf_slot

    def _create_keyframe(self, frame: FrameData, pose, pt_idx,
                         frame_id: Optional[int] = None):
        """Insert the keyframe, then map it: at once in synchronous and
        pipelined mode, queued for the pump in cooperative mode.  The
        tracker's associations re-anchor on the keyframe only when no newer
        frame is in flight (a pipelined chain keeps ``last_pt_idx`` aligned
        with ``last_frame``).  A pipelined commit runs after the next frame
        was dispatched, so the keyframe takes that frame's id, as in the
        JAX package.  In async mode the insertion takes the writer lock,
        flushes the buffered counters first, and the keyframe goes to the
        mapping worker's queue.  ``frame_id`` is the frame that made it (the
        one committed, by default the newest): the key of its mapping and
        loop spans."""
        if self.mapper is not None:
            # the worker's local BA in flight was already interrupted by
            # _need_new_keyframe setting abort_ba
            with self.mapper.paused():
                self._flush_pending_vis()
                kf_slot = self._insert_kf_with_points(frame, pose, pt_idx)
                self._publish_under_lock()
        else:
            kf_slot = self._insert_kf_with_points(frame, pose, pt_idx)
        self._kf_key[kf_slot] = self.frame_id if frame_id is None else frame_id
        self._set_ref_kf(kf_slot)
        self.last_kf_frame_id = self.frame_id
        if not self._inflight:
            self.last_pt_idx = self.map.kf_point_idx[kf_slot]
        if self.mapper is not None:
            self.mapper.submit(kf_slot)
            return
        if self.cooperative:
            self._coop_pending.append(kf_slot)
            return
        self._mapping_pipeline(kf_slot)
        # fusion may have merged landmarks the tracker references; re-read
        # the keyframe's (remapped) associations (MapPoint::Replace)
        if not self._inflight:
            self.last_pt_idx = self.map.kf_point_idx[kf_slot]

    def _mapping_pipeline(self, kf_slot: int):
        """A keyframe's mapping and loop closing, run to completion."""
        self._mapping_core(kf_slot)
        if self.loop_closing_enabled:
            self._try_close_loop(kf_slot)

    # ------------------------------------------------- cooperative mapping
    def _coop_busy(self) -> bool:
        return self._coop_gen is not None or bool(self._coop_pending)

    def _coop_backlog(self) -> int:
        return len(self._coop_pending) + (1 if self._coop_gen else 0)

    def _pump_mapping(self, budget: int = 1):
        """Advance cooperative mapping by up to ``budget`` steps (a step is
        what ``_mapping_steps`` does between two yields).  Called once per
        tracked frame."""
        for _ in range(budget):
            if self._coop_gen is None:
                if not self._coop_pending:
                    return
                self._coop_gen = self._coop_steps(self._coop_pending.pop(0))
            try:
                next(self._coop_gen)
            except StopIteration:
                self._coop_gen = None

    def _coop_steps(self, kf_slot: int):
        yield from self._mapping_steps(kf_slot)
        if self.loop_closing_enabled:
            yield
            self._try_close_loop(kf_slot)

    def _drain_mapping(self, max_steps: int = 10000):
        """Run cooperative mapping to completion (shutdown, export)."""
        steps = 0
        while self._coop_busy() and steps < max_steps:
            self._pump_mapping(16)
            steps += 16

    # ------------------------------------------------------- loop closing
    def _try_close_loop(self, kf_slot: int) -> bool:
        """Detect and correct a loop at keyframe ``kf_slot`` (the
        LoopClosing::Run body; in async mode on the loop worker's thread).
        Each candidate's RANSAC sets come from a CPU generator seeded with
        the frame id, as the JAX package seeds ``PRNGKey(frame_id)``.  An
        accepted loop stops a GBA in flight, is corrected under the writer
        lock, and starts a new GBA.

        The async mode detects with the reference's own DetectLoop
        (``LC.detect_orbslam2``: its database of the keyframes before
        ``kf_slot``, its word test, four consistent detections) where the
        other modes keep the JAX package's ``detect``: there the keyframe
        set depends on the mapping thread's timing, and the JAX rule's
        chain of three closed the street circuit's loop late or not at all
        under more of the recorded schedules (ROADMAP, faults in the
        reference).  Its RANSAC is seeded with the keyframe's own frame id,
        which a synchronous run has there, not with the tracker's frame id
        when the loop thread gets to it.  Spans: ``loop.detect``, a
        ``loop.sim3`` per candidate, ``loop.correct``, keyed by the
        keyframe's frame."""
        key = self._kf_key.get(kf_slot)
        with telemetry.timer("loop.detect", key):
            if self.db is None or self.n_kf < self.cfg.loop.kf_gap + 2:
                return False
            lcfg, orb = self.cfg.loop, self.cfg.orb
            covis = covisibility_matrix(self.map)
            seed = self.frame_id
            if self.mapper is None:
                cands = LC.detect(self.loop_state, self.db, kf_slot, self.db.bow[kf_slot],
                                  covis, kf_gap=lcfg.kf_gap,
                                  consistency_th=lcfg.covisibility_consistency_th)
            else:
                cands = LC.detect_orbslam2(self.loop_state, self.db, kf_slot, covis, self.n_kf,
                                           kf_gap=lcfg.kf_gap,
                                           consistency_th=lcfg.covisibility_consistency_th)
                if cands:
                    seed = int(_host(self.map.kf_frame_id[kf_slot]))
        for cand in cands:
            with telemetry.timer("loop.sim3", key):
                gen = torch.Generator(device="cpu")
                gen.manual_seed(seed)
                ok, R_cm, t_cm, s_cm, pairs = LC.compute_sim3(
                    self.map, self.cam, kf_slot, cand, fix_scale=self.sensor != "monocular",
                    generator=gen, min_inliers=lcfg.min_bow_matches,
                    scale_factor=orb.scale_factor, n_levels=orb.n_levels)
                if not ok:
                    continue
                # final acceptance: the loop neighbourhood's landmarks through
                # the corrected Sim3, enough matches in all (LoopClosing.cc:
                # 330-373, >= 40)
                S_cw = self._corrected_sim3(cand, R_cm, t_cm, s_cm)
                slots = torch.arange(covis.shape[0], device=self.device)
                group = ((covis[cand] >= 15) | (slots == cand)) & self.map.kf_valid
                n_total = LC.count_loop_projection_matches(self.map, self.cam, kf_slot, group,
                                                           *S_cw) + len(pairs)
                if n_total < lcfg.min_total_matches:
                    continue
            with telemetry.timer("loop.correct", key):
                # abort a GBA in flight before correcting (LoopClosing.cc:382)
                self._abort_running_gba()
                with self._map_lock():
                    self._correct_loop(kf_slot, cand, R_cm, t_cm, s_cm)
            # the global BA (LoopClosing.cc:556): inline in the single-thread
            # modes, on a thread of its own in async mode
            self._launch_gba(kf_slot)
            return True
        return False

    def _sim3_on_device(self, R, t, s):
        """compute_sim3's host (R, t, s) as one copy to the device."""
        flat = torch.from_numpy(np.concatenate([np.asarray(R, np.float32).reshape(9),
                                                np.asarray(t, np.float32),
                                                np.float32([s])])).to(self.device)
        return flat[:9].reshape(3, 3), flat[9:12], flat[12]

    def _corrected_sim3(self, kf_loop: int, R_cm, t_cm, s_cm):
        """S_cw = S_cm S_mw, the current keyframe's corrected pose."""
        T_mw = self.map.kf_pose[kf_loop]
        S_cm = self._sim3_on_device(R_cm, t_cm, s_cm)
        return sim3.compose(*S_cm, T_mw[:3, :3], T_mw[:3, 3], torch.ones_like(S_cm[2]))

    def _correct_loop(self, kf_cur: int, kf_loop: int, R_cm, t_cm, s_cm):
        """CorrectLoop (LoopClosing.cc:375-563), in the reference's order:
        Sim3 propagation through the current keyframe's covisible group and
        its points, SearchAndFuse of the loop neighbourhood's landmarks into
        every corrected keyframe, LoopConnections, the essential graph, the
        point correction.  The caller runs the global BA after it.  Host
        reads: the covisibility matrix with the keyframe banks before the
        fusion, the matrix after it.  It moves ``map_epoch``: a local BA
        gathered before it drops its result.  In async mode the tracker
        re-anchors on the corrected keyframe at its next frame."""
        m, K = self.map, self.map.kf_pose.shape[0]
        dev = self.device
        orb = self.cfg.orb
        covis_dev = covisibility_matrix(m)
        host = _host(torch.cat([covis_dev.reshape(-1), m.kf_valid.to(torch.int32), m.kf_parent,
                                m.kf_loop_edges.reshape(-1)]))
        covis_before = host[:K * K].reshape(K, K)
        kf_valid = host[K * K:K * K + K] > 0
        kf_parent = host[K * K + K:K * K + 2 * K]
        loop_edges = host[K * K + 2 * K:].reshape(K, -1)
        old_R, old_t = m.kf_pose[:, :3, :3], m.kf_pose[:, :3, 3]
        old_s = torch.ones(K, dtype=torch.float32, device=dev)
        S_cw = self._corrected_sim3(kf_loop, R_cm, t_cm, s_cm)

        # propagate to the covisible group (LoopClosing.cc:413-470), every
        # slot at once: S_iw = T_ic S_cw with T_ic = T_iw T_cw^-1
        group = sorted({kf_cur} | {int(i) for i in np.where(
            (covis_before[kf_cur] >= 15) & kf_valid)[0]})
        slots = torch.arange(K, device=dev)
        group_mask = ((covis_dev[kf_cur] >= 15) & m.kf_valid) | (slots == kf_cur)
        T_ic = m.kf_pose @ se3.inv(m.kf_pose[kf_cur])
        S_iw = sim3.compose(T_ic[:, :3, :3], T_ic[:, :3, 3], old_s, *S_cw)
        mid_R, mid_t, mid_s = (torch.where(group_mask.reshape((K,) + (1,) * (x.dim() - 1)), x, o)
                               for x, o in zip(S_iw, (old_R, old_t, old_s)))

        # the group's poses and landmarks corrected in the live map
        # (LoopClosing.cc:413-508), so fusion happens in the corrected frame
        ref = torch.clamp(m.pt_ref_kf, min=0).long()
        pt_group = group_mask[ref] & (m.pt_ref_kf >= 0) & m.pt_valid
        mid_pts = PG.correct_points_after_pose_graph(m.pt_pos, m.pt_ref_kf, old_R, old_t,
                                                     old_s, mid_R, mid_t, mid_s)
        mid_poses = se3.from_rt(mid_R, mid_t / mid_s[:, None])
        self.map = m = m.replace(
            kf_pose=torch.where(group_mask[:, None, None], mid_poses, m.kf_pose),
            pt_pos=torch.where(pt_group[:, None], mid_pts, m.pt_pos))

        # SearchAndFuse (LoopClosing.cc:565-590): the loop neighbourhood's
        # landmarks into every keyframe of the corrected group, radius th=4
        loop_group = ((covis_dev[kf_loop] >= 15) | (slots == kf_loop)) & m.kf_valid
        obs_in_loop = loop_group[torch.clamp(m.pt_obs_kf, min=0).long()] & (m.pt_obs_kf >= 0)
        loop_pt_mask = m.pt_valid & torch.any(obs_in_loop, dim=1)
        for i in group:
            self.map = LM.fuse_into_keyframe(self.map, i, self.cam, loop_pt_mask, budget=1024,
                                             scale_factor=orb.scale_factor,
                                             n_levels=orb.n_levels, th=4.0)
        self.map = update_point_stats(self.map, scale_factor=orb.scale_factor,
                                      n_levels=orb.n_levels)

        # LoopConnections (LoopClosing.cc:517-539): covisibility the fusion
        # just created between the corrected group and the rest
        covis_after = _host(covisibility_matrix(self.map))
        in_group = set(group)
        loop_connections = [
            (i, int(j)) for i in group
            for j in np.where((covis_after[i] >= 15) & (covis_before[i] < 15))[0]
            if int(j) not in in_group and kf_valid[j]]

        # the essential graph: spanning tree and strong covisibility from
        # the pre-correction geometry (NonCorrectedSim3), earlier loop
        # edges, the new loop connections measured in the corrected frame,
        # and the measured loop edge itself (M_ji with i = loop, j = current
        # is S_cm)
        historic = [(k, int(le)) for k in range(self.n_kf) for le in loop_edges[k]
                    if le >= 0 and le > k]
        edge_sets = [LC.build_essential_graph_edges(
            kf_parent, covis_before, kf_valid, historic, old_R, old_t, old_s,
            min_covis_weight=self.cfg.map.ess_graph_min_weight)]
        if loop_connections:
            lij = torch.tensor(loop_connections, dtype=torch.int32).T.to(dev)
            edge_sets.append(PG.make_edges_from_poses(
                lij[0], lij[1], mid_R, mid_t, mid_s,
                torch.ones(len(loop_connections), dtype=torch.bool, device=dev)))
        S_cm_dev = self._sim3_on_device(R_cm, t_cm, s_cm)
        ij = torch.tensor([[kf_loop], [kf_cur]], dtype=torch.int32).to(dev)
        edge_sets.append(PG.PoseGraphEdges(
            i=ij[0], j=ij[1], R=S_cm_dev[0][None], t=S_cm_dev[1][None],
            s=S_cm_dev[2][None], weight=torch.ones(1, device=dev),
            valid=torch.ones(1, dtype=torch.bool, device=dev)))
        edges = PG.PoseGraphEdges(*[torch.cat(parts) for parts in zip(*edge_sets)])

        mcfg = self.cfg.map
        solver = mcfg.pose_graph_solver
        if solver == "auto":
            solver = "pcg" if K > mcfg.pose_graph_dense_max else "dense"
        opt_R, opt_t, opt_s = PG.optimize_pose_graph(
            mid_R, mid_t, mid_s, self.map.kf_valid, slots == kf_loop, edges,
            fix_scale=self.sensor != "monocular", solver=solver,
            n_cg=mcfg.pose_graph_cg_iters or None)

        # landmarks through their reference keyframes, from the propagated
        # (mid) frame the group's points are already in; Sim3 nodes back to
        # SE3 (LoopClosing.cc:488)
        m = self.map
        new_pts = PG.correct_points_after_pose_graph(m.pt_pos, m.pt_ref_kf, mid_R, mid_t,
                                                     mid_s, opt_R, opt_t, opt_s)
        new_poses = se3.from_rt(opt_R, opt_t / opt_s[:, None])
        loop_edges_dev = m.kf_loop_edges.clone()
        loop_edges_dev[kf_cur, 0:1].fill_(kf_loop)
        loop_edges_dev[kf_loop, 0:1].fill_(kf_cur)
        self.map = m.replace(
            kf_pose=torch.where(m.kf_valid[:, None, None], new_poses, m.kf_pose),
            pt_pos=torch.where(m.pt_valid[:, None], new_pts, m.pt_pos),
            kf_loop_edges=loop_edges_dev)
        self.map = update_point_stats(self.map, scale_factor=orb.scale_factor,
                                      n_levels=orb.n_levels)
        self.map_epoch += 1
        self.loop_state.last_loop_kf = kf_cur
        if self.mapper is None:
            self.last_pose = self.map.kf_pose[kf_cur]
            self.velocity = None
        else:
            self._pending_pose_jump = kf_cur

    # ------------------------------------------------------------ global BA
    def _global_ba(self, window_mask, fixed_mask, iters: int):
        """Whole-map BA with the matrix-free Schur PCG solver
        (Optimizer::GlobalBundleAdjustemnt, Optimizer.cc:43-50), written
        back with its outliers erased."""
        prob = map_ops.build_ba_problem(self.map, window_mask, fixed_mask,
                                        self.inv_sigma2_table)
        result = BA.run(self.cam, prob, iters_phase1=iters, iters_phase2=0, solver="pcg",
                        n_cg=self.cfg.map.gba_cg_iters)
        self.map = map_ops.writeback_ba(self.map, result.kf_poses, result.points,
                                        result.obs_valid, prob)

    def _run_ba_chunked(self, prob, iters1: int, iters2: int, *, solver: str = "dense",
                        n_cg: int = 0, chunk: int = 5, should_stop=None):
        """The two-phase LM schedule in chunks of ``chunk`` iterations that
        carry the damping across, as ``BA.run`` carries it within a phase
        (fresh damping for phase 2).  Between chunks ``should_stop()`` may
        end it early (g2o's force-stop flag: the local BA keeps its partial
        progress, Optimizer.cc:650-694; the GBA drops it, LoopClosing.cc:
        631); in async mode each chunk is waited for first, so that the
        flag is polled against the device's progress.  ``prob`` may be a
        ``BA.ShardedBAProblem`` (the result is then per shard).  Returns
        (BAResult, stopped early)."""
        stopped = False

        def phase(n, poses, points):
            nonlocal stopped
            lam = BA.initial_damping(prob)
            done = 0
            while done < n and not stopped:
                k = min(chunk, n - done)
                poses, points, lam = self._lm_chunk(self.cam, prob, poses, points, lam,
                                                    n_iters=k, use_huber=True, solver=solver,
                                                    n_cg=n_cg)
                if should_stop is not None and self.mapper is not None:
                    self._sync_stream()
                done += k
                if should_stop is not None and done < n and should_stop():
                    stopped = True
            return poses, points

        poses, points = phase(iters1, prob.kf_poses, prob.points)
        if iters2 > 0 and not stopped:
            prob = BA.with_obs_valid(prob, BA.classify_outliers(self.cam, prob, poses, points))
            poses, points = phase(iters2, poses, points)
        final_valid = BA.classify_outliers(self.cam, prob, poses, points)
        zero = BA.per_shard(prob, lambda s: torch.zeros((), dtype=torch.float32,
                                                        device=s.kf_poses.device))
        return BA.BAResult(kf_poses=poses, points=points, obs_valid=final_valid,
                           total_chi2=zero), stopped

    def _launch_gba(self, kf_cur: int, iters: int = 10):
        """RunGlobalBundleAdjustment (LoopClosing.cc:618-715): the whole map
        with the PCG solver, the origin keyframe fixed, over a snapshot (the
        published map with its event: the banks are never written in place,
        so it needs no copy).  Inline in the single-thread modes; in async
        mode on a thread of its own and its own stream, which polls the
        stop flag and the epoch between LM chunks."""
        self.gba_epoch += 1
        epoch = self.gba_epoch
        self._stop_gba = False
        snapshot = self._pub
        n_kf_snap, n_pt_snap = self.n_kf, self.n_pt
        key = self._kf_key.get(kf_cur)
        if self.mapper is None:
            with telemetry.timer("gba", key):
                self._gba_worker(snapshot[0], epoch, n_kf_snap, n_pt_snap, iters)
            return
        mapper = self.mapper

        def run():
            try:
                with self._on_stream("gba"), telemetry.timer("gba", key):
                    snap = self._make_ready(snapshot)
                    self._gba_worker(snap, epoch, n_kf_snap, n_pt_snap, iters)
            except Exception as e:      # kept for shutdown
                mapper.record_exception(e)

        self._gba_thread = threading.Thread(target=run, name="global-ba", daemon=True)
        self._gba_thread.start()

    def _abort_running_gba(self):
        """Stop a GBA in flight and move its epoch (LoopClosing.cc:382-393)."""
        if self._gba_thread is not None and self._gba_thread.is_alive():
            self._stop_gba = True
            self.gba_epoch += 1

    def _gba_worker(self, snapshot, epoch: int, n_kf_snap: int, n_pt_snap: int,
                    iters: int):
        """The GBA over ``snapshot`` in chunks of 2 LM iterations; dropped
        (``stats["gba_aborted"]``) when stopped or when the epoch moved, else
        merged, in async mode under the writer lock after a second look at
        the epoch.  With more than one device visible the problem is cut
        along the point axis over all of them (``parallel/dist_ba.py``), as
        the JAX package shards it whenever it sees more than one chip, and
        the result is gathered back on this thread's stream before the
        merge."""
        K = snapshot.kf_pose.shape[0]
        slots = torch.arange(K, device=self.device)
        prob = map_ops.build_ba_problem(snapshot, snapshot.kf_valid & (slots != 0),
                                        slots == 0, self.inv_sigma2_table)
        devices = dist_ba.visible_devices(self.device)
        if len(devices) > 1:
            prob = dist_ba.shard_ba_problem(prob, dist_ba.make_mesh(devices=devices))
        result, stopped = self._run_ba_chunked(
            prob, iters, 0, solver="pcg", n_cg=self.cfg.map.gba_cg_iters, chunk=2,
            should_stop=lambda: self._stop_gba or self.gba_epoch != epoch)
        self.stats["gba_runs"] += 1
        if stopped or self.gba_epoch != epoch:
            self.stats["gba_aborted"] += 1
            return
        if len(devices) > 1:
            result = dist_ba.gather(result, self.device)
        with self._map_lock():
            if self.gba_epoch != epoch:      # a second look under the lock
                self.stats["gba_aborted"] += 1
                return
            self._merge_gba_result(snapshot, result, n_kf_snap, n_pt_snap)

    def _merge_gba_result(self, snapshot, result, n_kf_snap: int, n_pt_snap: int):
        """The GBA's poses and points into the live map, with the spanning
        tree carrying the correction to what was made while it ran
        (LoopClosing.cc:648-703), without its outlier classification:

        - a keyframe of the snapshot takes the GBA's pose;
        - a keyframe made after the snapshot (``n_kf_snap <= k < n_kf``)
          keeps its pose relative to its parent, composed onto the parent's
          corrected pose, in ascending slot order, so that a parent is
          corrected first;
        - a point of the snapshot takes the GBA's position; a newer one
          moves with its reference keyframe, ``x' = T_new^-1 (T_old x)``.

        On the device; only the new keyframes' parents are read on the host.
        It moves ``map_epoch``.  The caller holds the writer lock.  The
        tracker re-anchors at its next frame when frames are in flight or
        it runs on another thread, else at once."""
        m = self.map
        K, P = m.kf_pose.shape[0], m.pt_pos.shape[0]
        dev = self.device
        in_gba = (snapshot.kf_valid & (torch.arange(K, device=dev) < n_kf_snap) & m.kf_valid)
        corrected = torch.where(in_gba[:, None, None], result.kf_poses, m.kf_pose)
        n_kf = self.n_kf
        if n_kf > n_kf_snap:
            parents = _host(m.kf_parent[n_kf_snap:n_kf]).tolist()
            for k, p in zip(range(n_kf_snap, n_kf), parents):
                if p < 0:
                    continue
                # an LU inverse, as the JAX package's np.linalg.inv (the
                # rigid inverse moves far points of the chain by 1e-5 m)
                T_rel = m.kf_pose[k] @ torch.linalg.inv_ex(m.kf_pose[p]).inverse
                ok = m.kf_valid[k] & m.kf_valid[p]
                corrected[k] = torch.where(ok, T_rel @ corrected[p], corrected[k])
        in_gba_pt = snapshot.pt_valid & (torch.arange(P, device=dev) < n_pt_snap)
        pos = torch.where((in_gba_pt & m.pt_valid)[:, None], result.points, m.pt_pos)
        ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
        newer = m.pt_valid & ~in_gba_pt & (m.pt_ref_kf >= 0) & m.kf_valid[ref]
        T_old, T_new = m.kf_pose[ref], corrected[ref]
        xc = torch.einsum("nij,nj->ni", T_old[:, :3, :3], pos) + T_old[:, :3, 3]
        moved = torch.einsum("nji,nj->ni", T_new[:, :3, :3], xc - T_new[:, :3, 3])
        self.map = m.replace(kf_pose=corrected,
                             pt_pos=torch.where(newer[:, None], moved, pos))
        self.map_epoch += 1
        if self.mapper is None and not self._inflight:
            self.last_pose = self.map.kf_pose[self.ref_kf]
        else:
            # the tracker re-anchors at its next frame
            self._pending_pose_jump = int(self.ref_kf)

    # ------------------------------------------------------- local mapping
    def _mapping_core(self, kf_slot: int):
        """The LocalMapping::Run body, run to completion (synchronous and
        pipelined mode; cooperative mode pumps ``_mapping_steps`` instead)."""
        for _ in self._mapping_steps(kf_slot):
            pass

    def _mapping_steps(self, kf_slot: int):
        """The LocalMapping::Run body (LocalMapping.cc:44-104) as a step
        generator: work sets, triangulation, fusion in both directions,
        recent-point culling with the statistics refresh, the triangulation
        reconcile, the local BA in chunks, keyframe culling.  It yields
        where the JAX package's does, after each bounded unit of device
        work: cooperative mode pumps one step per frame, so the yields decide
        when later keyframes go in.  Every step reads the live map and
        counters, which the tracker may have moved since the one before.
        Each step is a ``mapping.*`` span keyed by the keyframe's frame."""
        nn, n_nb, t_cap = self._neighbor_caps()
        key = self._kf_key.get(kf_slot)
        with telemetry.timer("mapping.work_sets", key):
            work = self._work_sets(kf_slot, nn=nn, t_cap=t_cap, n_neighbors=n_nb)
        tri_nb, fuse_slots, fuse_slots_dev, window, fixed, cull_cands = work
        yield
        with telemetry.timer("mapping.triangulate", key):
            n_new, pt_base = self._triangulate_new_points(kf_slot, tri_nb)
            # the count's download starts now; the reconcile reads it later
            n_new = _start_read(n_new)
        yield
        with telemetry.timer("mapping.fuse", key):
            self._fuse_neighbors(kf_slot, fuse_slots, fuse_slots_dev)
        yield
        with telemetry.timer("mapping.cull_points", key):
            self._cull_and_refresh(kf_slot)
        yield
        with telemetry.timer("mapping.reconcile", key):
            self._reconcile_triangulation(n_new, pt_base)
        yield
        if self.n_kf >= 3:
            self.abort_ba = False       # a fresh run (LocalMapping.cc:66)
            yield from self._windowed_ba_steps(window, fixed, 5, 10, key=key)
            # keep the tracker's pose consistent with the adjusted keyframe,
            # unless a newer frame in flight chains on the old one or the
            # tracker runs on another thread
            if self.mapper is None and not self._inflight:
                self.last_pose = self.map.kf_pose[kf_slot]
        else:
            self._prime_ba_graph(window, fixed)
        yield
        if self.n_kf >= 5:
            # the redundancy ratios go out one step ahead of the culling
            with telemetry.timer("mapping.kf_redundancy", key):
                ratios = LM.keyframe_redundancy(self.map, torch.clamp(cull_cands, min=0))
            yield
            with telemetry.timer("mapping.kf_cull", key):
                self._cull_keyframes(kf_slot, cull_cands, ratios)

    def _neighbor_caps(self):
        """(fuse neighbours, triangulation neighbours, fuse target cap)."""
        default_nb = 20 if self.sensor == "monocular" else 10
        nn = self.cfg.map.fuse_neighbors or default_nb
        return nn, self.cfg.map.triangulate_neighbors or default_nb, 3 * nn + 2

    def _work_sets(self, kf_slot: int, *, nn: int, t_cap: int, n_neighbors: int):
        """``mapping_work_sets`` on the device, then one host read of the
        two slot lists the triangulation and fuse loops walk (and the fuse
        target count).  Returns (triangulation neighbours, fuse targets as
        host lists, fuse targets on the device, BA window and fixed masks,
        culling candidates)."""
        tri_nb, fuse_slots, n_fuse, _, window, fixed, cull_cands = LM.mapping_work_sets(
            self.map, kf_slot, self.ref_kf, nn=nn, t_cap=t_cap, n_neighbors=n_neighbors,
        )
        host = _host(torch.cat([tri_nb, fuse_slots, n_fuse[None]]))
        n_fuse = int(host[-1])
        if n_fuse > t_cap:
            telemetry.warn(
                "fuse_target_overflow",
                f"SearchInNeighbors has {n_fuse} fuse targets; only {t_cap} "
                "scanned (densely covisible graph — raise MapConfig.fuse_neighbors "
                "ring budget)",
            )
        tri_host = [int(x) for x in host[:n_neighbors]]
        fuse_host = [int(x) for x in host[n_neighbors:n_neighbors + t_cap]]
        return tri_host, fuse_host, fuse_slots, window, fixed, cull_cands

    def _triangulate_new_points(self, kf_slot: int, neighbors: list):
        """CreateNewMapPoints over the covisible neighbours (weight > 15).
        The JAX package reserves 64 slots per listed neighbour before it
        knows the count and hands back the unused tail at the reconcile;
        point slot numbers decide every later index, so the port reserves
        the same way."""
        cap = self.map.pt_pos.shape[0]
        with self._map_lock():
            pt_base = self.n_pt
            self.map, n_new = self._triangulate(self.map, kf_slot, neighbors, pt_base)
            self.n_pt = self._tri_reserved_end = min(pt_base + 64 * len(neighbors), cap)
        if self.n_pt >= cap - 64:
            telemetry.warn(
                "pt_capacity",
                f"map-point bank full ({self.n_pt}/{cap}) — triangulation "
                "suspended; raise MapConfig.max_points",
            )
        return n_new, pt_base

    def _triangulate(self, state, kf_slot: int, neighbors: list, pt_base: int):
        """``LM.triangulate_with_neighbors`` on ``state`` with this system's
        settings, each neighbour through ``_mapping_run``."""
        return LM.triangulate_with_neighbors(
            state, kf_slot, neighbors, self.cam, pt_base, max_new=64,
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            # mono requires a baseline of 1% of the median depth
            # (LocalMapping.cc:219)
            min_baseline_ratio=0.01 if self.sensor == "monocular" else 0.005,
            run=self._mapping_run,
        )

    def _fuse_neighbors(self, kf_slot: int, fuse_slots: list, fuse_slots_dev):
        """SearchInNeighbors (LocalMapping.cc:425-509) on the live map."""
        with self._map_lock():
            self.map = self._fuse(self.map, kf_slot, fuse_slots, fuse_slots_dev)

    def _fuse(self, state, kf_slot: int, fuse_slots: list, fuse_slots_dev):
        """SearchInNeighbors on ``state``: this keyframe's landmarks into
        every target, then every target's landmarks into this keyframe, each
        call through ``_mapping_run``."""
        sf, nl = self.cfg.orb.scale_factor, self.cfg.orb.n_levels
        state = LM.fuse_into_keyframes(
            state, fuse_slots, self.cam, budget=1024, scale_factor=sf,
            n_levels=nl, cand_idx=state.kf_point_idx[kf_slot], run=self._mapping_run,
        )
        return self._mapping_run(LM.fuse_targets_gen, state, kf_slot, fuse_slots_dev,
                                 self.cam, budget=2048, scale_factor=sf, n_levels=nl)

    def _prime_worker_graphs(self) -> None:
        """Async mode on the card, before the workers start: capture the
        mapping worker's CUDA graphs (triangulation's, fusion's, the local
        BA chunk's) on its stream, on the empty map, results dropped.  A
        capture on the worker's thread would fail if another thread
        synchronized the device meanwhile (a profiler's end does)."""
        t_cap = self._neighbor_caps()[2]
        no_kf = torch.zeros(self.cfg.map.max_keyframes, dtype=torch.bool, device=self.device)
        with self._on_stream("mapping"):
            self._triangulate(self.map, 0, [1], 0)
            self._fuse(self.map, 0, [1], torch.full((t_cap,), -1, dtype=torch.int32,
                                                    device=self.device))
            self._prime_ba_graph(no_kf, no_kf)

    def _mapping_run(self, step, state, *args, **kwargs):
        """One of local mapping's generator steps (``LM.fuse_gen``,
        ``LM.fuse_targets_gen``, ``LM.triangulate_neighbor_gen``) on
        ``state``: on the card one replay of its CUDA graphs around the
        eager masked best-2, where ``_tri_fuse_graph`` gives them (the call
        that captures them gives the warm-up's result), else
        ``LM.run_eager``.  Int arguments are keyframe slots; each call
        counts one ``mapping.tri_fuse_graph_replays`` or
        ``mapping.tri_fuse_eager_calls``."""
        graph, inputs = self._tri_fuse_graph(step, state, args, kwargs)
        if graph is None or graph.graph is None:
            telemetry.inc("mapping.tri_fuse_eager_calls")
        else:
            telemetry.inc("mapping.tri_fuse_graph_replays")
        if graph is None:
            return LM.run_eager(step, state, *args, **kwargs)
        park = self.mapper is not None and (torch.cuda.current_stream(self.device)
                                            != self._streams["mapping"])
        changed, extra = self._graph_call(graph, inputs, park)
        state = state.replace(**changed)
        return (state, *extra) if extra else state

    def _tri_fuse_graph(self, step, state, args, kwargs):
        """The graph of a ``_mapping_run`` call on the card, one per stream,
        step, fixed arguments and input shapes, and its inputs (every bank of
        ``state``, each int of ``args`` as a device slot, each tensor); None
        where the step runs eagerly: on the CPU, or for a replaced step."""
        if self.device.type != "cuda" or step not in _GRAPHED_STEPS:
            return None, None
        inputs = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        fixed = []
        for i, a in enumerate(args):
            if isinstance(a, int):
                a = self._slots[a:a + 1]
            if isinstance(a, torch.Tensor):
                inputs[f"arg{i}"] = a
                fixed.append(_INPUT)
            else:
                fixed.append(a)
        tensor_kw = [k for k, v in kwargs.items() if isinstance(v, torch.Tensor)]
        inputs.update((k, kwargs[k]) for k in tensor_kw)
        const_kw = tuple(sorted((k, v) for k, v in kwargs.items() if k not in tensor_kw))
        key = ((torch.cuda.current_stream(self.device).cuda_stream, step, tuple(fixed),
                const_kw) + tuple((k, t.shape, t.dtype) for k, t in inputs.items()))
        graph = self._tri_fuse_graphs.get(key)
        if graph is None:
            names = [f.name for f in dataclasses.fields(state)]

            def graph_step(**ins):
                st = MapState(**{n: ins[n] for n in names})
                call_args = [ins[f"arg{i}"] if a is _INPUT else a for i, a in enumerate(fixed)]
                out = yield from step(st, *call_args, **{k: ins[k] for k in tensor_kw},
                                      **dict(const_kw))
                new, *extra = out if isinstance(out, tuple) else (out,)
                # only the banks the step wrote leave the graph
                return ({n: getattr(new, n) for n in names if getattr(new, n) is not ins[n]},
                        tuple(extra))
            graph = self._tri_fuse_graphs[key] = StepGraph(graph_step, call=LM.best2)
        return graph, inputs

    def _graph_call(self, graph: StepGraph, inputs: dict, park: bool):
        """One call of ``graph``: a replay, or its capture (whose result is
        the warm-up's), with the mapping worker parked around a capture
        where ``park``."""
        if park and graph.graph is None:
            with self.mapper.stopped():
                return graph.run(inputs)
        return graph.run(inputs)

    def _cull_and_refresh(self, kf_slot: int):
        """MapPointCulling over the recent slots, then the statistics of the
        points this keyframe observes (all points it triangulated or fused)."""
        with self._map_lock():
            self.map = LM.cull_recent_map_points(self.map, kf_slot, self.n_pt)
            self.map = update_point_stats_subset(
                self.map, self.map.kf_point_idx[kf_slot],
                scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            )

    def _reconcile_triangulation(self, n_new, pt_base: int):
        """Hand back the reserved triangulation slots no point took, if no
        other allocation came in since (cooperative mode may insert a
        keyframe's depth points in between).  ``n_new`` is the count's
        started download (``_start_read``)."""
        n_new = int(_finish_read(n_new))      # the read stays outside the lock
        with self._map_lock():
            if self.n_pt == self._tri_reserved_end:
                self.n_pt = pt_base + n_new

    def _windowed_ba(self, window_mask, fixed_mask, iters1: int, iters2: int):
        """Local BA run to completion, not interruptible (the monocular
        initializer's BA)."""
        for _ in self._windowed_ba_steps(window_mask, fixed_mask, iters1, iters2,
                                         abortable=False):
            pass

    def _windowed_ba_steps(self, window_mask, fixed_mask, iters1: int, iters2: int,
                           abortable: bool = True, key=None):
        """Local BA (Optimizer::LocalBundleAdjustment) on the compact window
        as a step generator: gather, ``iters1`` robust LM iterations, drop
        outliers, ``iters2`` more, scatter back with the final outliers
        erased.  It yields after the gather and after every chunk of 5 LM
        iterations; between chunks an ``abort_ba`` set by the tracker stops
        it (mbAbortBA), and the progress so far is written back
        (Optimizer.cc:650-694).  In async mode each chunk is waited for
        before the next is queued, and the scatter is dropped (counted in
        ``stats["local_ba_discarded"]``) if a loop correction or a GBA merge
        moved ``map_epoch`` since the gather: it would write pre-correction
        poses into the corrected map.  Its steps are ``mapping.ba_*`` spans
        under ``key``."""
        mcfg = self.cfg.map
        epoch = self.map_epoch
        with telemetry.timer("mapping.ba_gather", key):
            prob, kf_sel, pt_sel, obs_sel, n_pt_in = map_ops.gather_ba_window(
                self.map, window_mask, fixed_mask, self.inv_sigma2_table,
                max_kfs=mcfg.local_ba_max_kfs, max_points=mcfg.local_ba_max_points,
                max_obs=mcfg.local_ba_max_obs,
            )
            n_pt_in = _start_read(n_pt_in)
        yield
        lam0 = lambda: torch.full((), 1e-4, dtype=torch.float32, device=self.device)
        stopped = False

        def chunks(n, poses, points, lam):
            nonlocal stopped
            done = 0
            while done < n and not stopped:
                k = min(5, n - done)
                with telemetry.timer("mapping.ba_chunk", key):
                    poses, points, lam = self._ba_chunk(prob, poses, points, lam, k)
                    if self.mapper is not None:
                        # async worker: this chunk done before the next is
                        # queued, so that the abort flag is polled against
                        # the device's progress
                        self._sync_stream()
                done += k
                yield poses, points, lam
                if abortable and done < n and self.abort_ba:
                    stopped = True

        poses, points = prob.kf_poses, prob.points
        for poses, points, _ in chunks(iters1, poses, points, lam0()):
            yield
        if iters2 > 0 and not stopped:
            with telemetry.timer("mapping.ba_classify", key):
                prob = prob._replace(obs_valid=BA.classify_outliers(self.cam, prob,
                                                                    poses, points))
            yield
            # fresh damping for the re-classified problem, like g2o
            for poses, points, _ in chunks(iters2, poses, points, lam0()):
                yield
        with telemetry.timer("mapping.ba_scatter", key):
            final_valid = BA.classify_outliers(self.cam, prob, poses, points)
            with self._map_lock():
                if self.map_epoch == epoch:
                    self.map = map_ops.scatter_ba_window(self.map, prob, kf_sel, pt_sel,
                                                         obs_sel, poses, points, final_valid)
                else:
                    self.stats["local_ba_discarded"] += 1
            n_pt_in = int(_finish_read(n_pt_in))
        if n_pt_in > mcfg.local_ba_max_points:
            telemetry.warn(
                "local_ba_point_overflow",
                f"local BA window has {n_pt_in} points; only "
                f"{mcfg.local_ba_max_points} optimized (raise "
                "MapConfig.local_ba_max_points)",
            )

    def _ba_chunk(self, prob, poses, points, lam, n_iters: int, *, solver: str = "dense",
                  n_cg: int = 0):
        """``n_iters`` robust LM iterations of the local BA
        (``self._lm_chunk``): one replay of the chunk's CUDA graph where
        ``_ba_graph`` gives one (the chunk that captures it gives the
        warm-up's eager result), else eager.  Each chunk counts one
        ``mapping.ba_graph_replays`` or ``mapping.ba_eager_chunks``."""
        graph = self._ba_graph(prob, n_iters, solver)
        if graph is None:
            telemetry.inc("mapping.ba_eager_chunks")
            return self._lm_chunk(self.cam, prob, poses, points, lam, n_iters=n_iters,
                                  use_huber=True, solver=solver, n_cg=n_cg)
        inputs = dict(prob._asdict(), lm_poses=poses, lm_points=points, lm_lam=lam)
        if graph.graph is None:
            telemetry.inc("mapping.ba_eager_chunks")
            return self._capture_ba(graph, inputs)
        telemetry.inc("mapping.ba_graph_replays")
        return graph.run(inputs)

    def _ba_graph(self, prob, n_iters: int, solver: str = "dense"):
        """The CUDA graph (``StepGraph``) of a chunk on the card: a full
        chunk of 5 iterations of the stock ``BA.lm_chunk`` on a dense,
        unsharded ``BAProblem``, one graph per stream, problem shapes and
        chunk length.  None where the chunk runs eagerly: on the CPU, for a
        sharded problem, the PCG solver, a shorter chunk or a replaced
        ``_lm_chunk``."""
        if (self.device.type != "cuda" or n_iters != 5 or solver != "dense"
                or not isinstance(prob, BA.BAProblem) or self._lm_chunk is not BA.lm_chunk):
            return None
        key = (torch.cuda.current_stream(self.device).cuda_stream, n_iters) + tuple(
            (t.shape, t.dtype) for t in prob)
        graph = self._ba_graphs.get(key)
        if graph is None:
            # the captured step: the problem rebuilt from its ten tensors
            def step(lm_poses, lm_points, lm_lam, **fields):
                return self._lm_chunk(self.cam, BA.BAProblem(**fields), lm_poses, lm_points,
                                      lm_lam, n_iters=n_iters, use_huber=True)
            graph = self._ba_graphs[key] = StepGraph(step)
        return graph

    def _capture_ba(self, graph: StepGraph, inputs: dict):
        """A BA chunk's capture (its result: the warm-up's).  On the
        tracker's stream in async mode (the monocular initializer's BA) the
        mapping worker is parked around it, as for the tracked frame's."""
        if self.mapper is not None and (torch.cuda.current_stream(self.device)
                                        != self._streams["mapping"]):
            with self.mapper.stopped():
                return graph.run(inputs)
        return graph.run(inputs)

    def _prime_ba_graph(self, window_mask, fixed_mask) -> None:
        """On the card, while no local BA has run on this stream (a
        keyframe mapped with fewer than 3 in the map): capture the chunk's
        graph on this keyframe's window, its result dropped, so that the
        first local BA replays it.  The window is gathered at the padded
        shapes every later one has."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device).cuda_stream
        if any(key[0] == stream for key in self._ba_graphs):
            return
        mcfg = self.cfg.map
        prob = map_ops.gather_ba_window(
            self.map, window_mask, fixed_mask, self.inv_sigma2_table,
            max_kfs=mcfg.local_ba_max_kfs, max_points=mcfg.local_ba_max_points,
            max_obs=mcfg.local_ba_max_obs)[0]
        graph = self._ba_graph(prob, 5)
        if graph is not None:
            self._capture_ba(graph, dict(
                prob._asdict(), lm_poses=prob.kf_poses, lm_points=prob.points,
                lm_lam=torch.full((), 1e-4, dtype=torch.float32, device=self.device)))

    def _cull_keyframes(self, kf_slot: int, cull_cands, ratios):
        """KeyFrameCulling (LocalMapping.cc:595-655): drop candidate
        keyframes with >= 90% redundant landmarks.  All candidates' ratios
        come from one batched evaluation (``ratios``, dispatched a step
        earlier), read back with the candidates and the live parent bank in
        one host read; a ratio is evaluated again only after an earlier
        candidate of the round was culled (culling removes observations,
        which can only lower the other ratios)."""
        host = _host(torch.cat([cull_cands.to(torch.float32), ratios,
                                self.map.kf_parent.to(torch.float32)]))
        C = cull_cands.shape[0]
        candidates = [int(c) for c in host[:C] if c >= 0]
        parents = host[2 * C:].astype(np.int64)
        culled_this_round = False
        for cand, ratio in zip(candidates, host[C:2 * C]):
            if ratio < 0.9:
                continue
            if culled_this_round:
                idx = torch.full((1,), cand, dtype=torch.int32, device=self.device)
                if float(_host(LM.keyframe_redundancy(self.map, idx)[0])) < 0.9:
                    continue
            parent = int(parents[cand])
            if parent < 0:
                continue
            T_cp = (self.map.kf_pose[cand] @ se3.inv(self.map.kf_pose[parent]))
            self.culled_chain[cand] = (_host(T_cp), parent)
            # re-parent the children to the culled keyframe's parent
            children = np.nonzero(parents == cand)[0]
            idx = torch.from_numpy(children).to(self.device) if len(children) else None
            with self._map_lock():
                if idx is not None:
                    self.map = self.map.replace(kf_parent=map_ops.set_rows(
                        self.map.kf_parent, idx, parent))
                    parents[children] = parent
                if self.db is not None:
                    self.db.erase(cand)      # in place: before the publish
                self.map = LM.remove_keyframe(self.map, cand)
            culled_this_round = True

    # ------------------------------------------------------- relocalization
    def _reloc_rescue(self, frame: FrameData, pose, cand: int, pt_idx, th: float,
                      max_dist: int):
        """A projection-search rescue round (ORBmatcher.cc:1385-1504): the
        candidate keyframe's landmarks not matched yet, into the frame's free
        features.  Returns (pt_idx, matches added); one host read."""
        m = self.map
        res = TK.match_kf_points_by_projection(
            self.cam, pose, frame, m.kf_point_idx[cand], m.kf_feat_valid[cand],
            m.kf_angle[cand], m.pt_pos, m.pt_valid, m.pt_desc, m.pt_max_dist, pt_idx,
            th=th, max_dist=max_dist, scale_factors=self.scale_factors,
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
        )
        return res.pt_idx, int(_host(res.n_matches))

    def _relocalize(self, frame: FrameData):
        """Relocalization after a tracking loss (Tracking.cc:1217-1363): BoW
        candidate keyframes over the covisibility groups, SearchByBoW as a
        mutual descriptor search against each candidate's landmark features
        (at least 15 matches), batched EPnP RANSAC, the pose-only LM on its
        inliers, then up to two projection rescue rounds (window 10 and
        distance 100, then window 3 and distance 64), accepted at
        ``min_inliers_reloc`` (50) inliers.  Each candidate's EPnP sets come
        from a CPU generator seeded with the frame id, as the JAX package
        seeds ``PRNGKey(frame_id)``.

        Returns (ok, pose, pt_idx).  ``reloc_log`` keeps, per candidate
        tried, the SearchByBoW matches, the EPnP inliers, the LM inliers
        after each step, the rescue rounds run and whether it was accepted;
        the accepted one also keeps the frame, pose and associations."""
        self.reloc_log = []
        if self.db is None:
            return False, None, None
        cfg = self.cfg
        target = cfg.tracking.min_inliers_reloc
        m = self.map
        bow = self.db.signature_of(frame.desc, frame.valid)
        cands, _ = detect_reloc_candidates(self.db, bow, covisibility_matrix(m))
        N = frame.n_slots
        for cand in _host(cands).tolist():
            if cand < 0:
                continue
            rec = dict(cand=cand, rescue_rounds=0, accepted=False)
            self.reloc_log.append(rec)
            pt_kf = m.kf_point_idx[cand]
            kp = torch.clamp(pt_kf, min=0).long()
            has_pt = (pt_kf >= 0) & m.kf_feat_valid[cand] & m.pt_valid[kp]
            res = M.nn_match(hamming(m.kf_desc[cand], frame.desc), row_valid=has_pt,
                             col_valid=frame.valid, max_dist=50,
                             ratio=cfg.matcher.nn_ratio_reloc, mutual=True)
            rec["bow_matches"] = int(_host(res.mask.sum()))
            if rec["bow_matches"] < 15:         # SearchByBoW bar (Tracking.cc:1253)
                continue
            xn = cam_mod.pixel_to_normalized(self.cam,
                                             frame.xy[torch.clamp(res.idx, min=0).long()])
            gen = torch.Generator(device="cpu")
            gen.manual_seed(self.frame_id)
            pnp = epnp.epnp_ransac(m.pt_pos[kp], xn, res.mask, gen,
                                   sigma2=(1.0 / float(cfg.camera.fx)) ** 2,
                                   chi2_th=5.991, min_inliers=10)
            success, rec["epnp_inliers"] = _host(torch.stack(
                [pnp.success.to(torch.int32), pnp.n_inliers])).tolist()
            if not success:
                continue
            # the pose-only LM on the EPnP inlier associations
            sel = res.mask & pnp.inliers
            pt_of_feat = map_ops.set_rows(
                torch.full((N,), -1, dtype=torch.int32, device=self.device),
                torch.where(sel, res.idx, N), torch.where(sel, pt_kf, -1))
            pose, pt_idx, n_inl = self._pose_opt_against_map(frame, pnp.Tcw, pt_of_feat)
            n_inl = int(_host(n_inl))
            rec["lm_inliers"] = [n_inl]
            if n_inl < 10:
                continue
            # rescue round 1: wide window, loose distance (Tracking.cc:1315)
            if n_inl < target:
                pt_idx, n_add = self._reloc_rescue(frame, pose, cand, pt_idx,
                                                   th=10.0, max_dist=100)
                rec["rescue_rounds"] = 1
                if n_inl + n_add >= target:
                    pose, pt_idx, n_inl = self._pose_opt_against_map(frame, pose, pt_idx)
                    n_inl = int(_host(n_inl))
                    rec["lm_inliers"].append(n_inl)
                    # rescue round 2: narrow window around the refined pose
                    # (Tracking.cc:1330-1345)
                    if target > n_inl > 30:
                        pt_idx, n_add = self._reloc_rescue(frame, pose, cand, pt_idx,
                                                           th=3.0, max_dist=64)
                        rec["rescue_rounds"] = 2
                        if n_inl + n_add >= target:
                            pose, pt_idx, n_inl = self._pose_opt_against_map(
                                frame, pose, pt_idx)
                            n_inl = int(_host(n_inl))
                            rec["lm_inliers"].append(n_inl)
            if n_inl >= target:
                rec.update(accepted=True, frame=frame, pose=pose, pt_idx=pt_idx)
                self._set_ref_kf(cand)
                self.state = TrackState.OK
                self.stats["relocs"] += 1
                return True, pose, pt_idx
            self.stats["reloc_rejects"] += 1
        return False, None, None

    # ----------------------------------------------------------- trajectory
    def _log_frame(self, timestamp, lost: bool, Tcr=None, frame_id: Optional[int] = None,
                   ref_kf: Optional[int] = None):
        """Log a frame's pose relative to ``ref_kf`` (the current reference
        keyframe by default) as Tcr, by default the tracker's last pose's."""
        ref_kf = self.ref_kf if ref_kf is None else ref_kf
        if Tcr is None:
            Tcr = _host(self.last_pose @ se3.inv(self.map.kf_pose[ref_kf]))
        self.trajectory.append(FrameLog(self.frame_id if frame_id is None else frame_id,
                                        timestamp, Tcr, ref_kf, lost))

    def _resolve_kf_pose(self, kf: int, kf_poses: np.ndarray) -> np.ndarray:
        """Pose of a (possibly culled) keyframe, chaining relative
        transforms through the spanning tree (System.cc:372-390)."""
        chain = np.eye(4, dtype=np.float32)
        seen = 0
        while kf in self.culled_chain and seen < 64:
            T_cp, parent = self.culled_chain[kf]
            chain = chain @ T_cp
            kf = parent
            seen += 1
        return chain @ kf_poses[kf]

    def tracked_logs(self) -> list[FrameLog]:
        """Frame logs with a pose (lost frames skipped, System.cc:387-388),
        once the frames in flight are committed."""
        self.flush_pipeline()
        return [log for log in self.trajectory if not log.lost]

    def tracked_frame_ids(self) -> np.ndarray:
        return np.asarray([log.frame_id for log in self.tracked_logs()])

    def frame_poses(self) -> np.ndarray:
        """(n, 4, 4) Tcw per tracked frame, recomposed through the current
        keyframe poses (System::SaveTrajectoryTUM, System.cc:355-415).  The
        frames in flight are committed first: their keyframes and mapping
        move the keyframe poses (the JAX package reads those poses before
        it commits)."""
        self.flush_pipeline()
        kf_poses = self.map.kf_pose.cpu().numpy()
        out = [log.Tcr @ self._resolve_kf_pose(log.ref_kf, kf_poses)
               for log in self.tracked_logs()]
        if not out:
            return np.zeros((0, 4, 4), dtype=np.float32)
        return np.stack(out)

    def camera_centers(self) -> np.ndarray:
        return np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in self.frame_poses()])

    def export_trajectory_tum(self, path: str):
        _write_tum(path, zip((log.timestamp for log in self.tracked_logs()),
                             self.frame_poses()))

    def export_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only trajectory (System::SaveKeyFrameTrajectoryTUM,
        System.cc:417-450), after the frames in flight are committed."""
        self.flush_pipeline()
        kf_poses = self.map.kf_pose.cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        kf_fid = self.map.kf_frame_id.cpu().numpy()
        ts_by_fid = {log.frame_id: log.timestamp for log in self.trajectory}
        _write_tum(path, ((ts_by_fid.get(int(kf_fid[k]), 0.0), kf_poses[k])
                          for k in range(self.n_kf) if kf_valid[k]))

    def export_trajectory_kitti(self, path: str):
        with open(path, "w") as f:
            for Tcw in self.frame_poses():
                row = np.linalg.inv(Tcw)[:3, :4].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in row) + "\n")
