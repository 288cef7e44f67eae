"""SLAM system facade: RGB-D, stereo and monocular tracking with synchronous
local mapping, relocalization and localization-only mode (port of
system.py).

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
  pose-only LM, the counters and ``Tcr``), then ``_commit_fused``.  When
  the motion model fails, TrackReferenceKeyFrame and the decomposed local
  map take over; when that fails too, or too few local-map inliers remain,
  the frame is lost;
- a lost system with at most 5 keyframes resets and initializes again on a
  later frame (Tracking.cc:421-428); with more, or with the map frozen, every
  later frame tries ``_relocalize`` (Tracking.cc:1217-1363): BoW candidates
  from the KeyFrameDB over the covisibility groups, SearchByBoW, batched
  EPnP RANSAC, the pose-only LM, up to two projection rescue rounds (the
  masked best-2 CUDA kernel) and the 50-inlier bar.  A relocalized frame
  goes straight to the local map, leaves no velocity, and for
  ``max_frames_between_kf`` frames the local map must give
  ``min_inliers_local_map_reloc`` inliers;
- a keyframe (``_need_new_keyframe``, ``_create_keyframe``) runs local
  mapping to completion before the next frame (``_mapping_steps``: work
  sets, triangulation, fusion in both directions, recent-point culling and
  statistics, the dense local BA, keyframe culling), both descriptor
  searches through the masked best-2 CUDA kernel.  A monocular keyframe
  gets no depth points: triangulation is its only source of new points;
- localization-only mode (``activate_localization_mode``): the map is
  frozen, no keyframe is inserted, and every frame takes the decomposed
  path ``_track``, which for RGB-D and stereo adds temporal points from the
  last frame's depth to the motion-model matches (``_track_vo``), and a
  frame that followed visual odometry alone tries ``_relocalize`` first;
- every keyframe's BoW signature goes into the KeyFrameDB
  (``_register_keyframe_bow``), and a culled keyframe leaves it;
- the trajectory products, chained through culled keyframes.

Paths outside the port so far raise ``NotImplementedError`` naming the
ROADMAP.md queue-1 item that brings them: loop closing (11; set
``loop_closing_enabled = False``) and the async modes (12).  A tracked
frame of the fused path reads one (6,) scalar vector and one (2, 4, 4) pose
stack back to the host, as the JAX facade does; a keyframe, a
localization-only frame and a relocalization add the reads listed in
PERF.md.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .backend import local_mapping as LM
from .frontend import tracking_kernels as TK
from .frontend.frame import (
    FrameData, build_frame_mono, build_frame_rgbd, build_frame_stereo,
)
from .geometry import camera as cam_mod
from .geometry import se3
from .geometry.camera import camera_from_config
from .models import map_ops
from .models.map_state import (
    covisibility_matrix, create_empty, n_observations, update_point_stats,
    update_point_stats_subset,
)
from .ops import matching as M
from .ops.descriptors import hamming
from .ops.image import level_sigma2
from .ops.orb import level_quotas
from .optim import bundle_adjustment as BA
from .optim.pose_opt import optimize_pose
from .place.keyframe_db import KeyFrameDB, detect_reloc_candidates
from .place.vocab import load_vocabulary, train_vocabulary
from .solvers import epnp
from .solvers.initializer import initialize_two_view
from .utils import telemetry

SENSORS = ("rgbd", "stereo", "monocular")
VOCAB_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "vocab.npz")


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
                 pipelined: bool = False, cooperative_mapping: bool = False):
        # SLAM geometry needs full float32 products: at reduced precision the
        # pose normal equations and descriptor intensity differences lose
        # enough that tracking margins collapse (the JAX facade pins
        # jax_default_matmul_precision="highest" for the same reason; on the
        # TPU at bf16, identical input lost 125 of 600 frames).  On the card
        # cuDNN and matmuls may use TF32, which keeps ~3 decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if async_mapping or pipelined or cooperative_mapping:
            raise NotImplementedError(
                "async, pipelined and cooperative modes arrive with ROADMAP.md "
                "queue 1 item 12; the port runs the synchronous mode"
            )
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
        # loop closing arrives with ROADMAP.md queue 1 item 11; until then a
        # run that would reach loop detection raises unless this is False
        self.loop_closing_enabled = True
        # which tracking paths fired
        self.stats = {"motion_tracks": 0, "ref_kf_tracks": 0, "vo_tracks": 0,
                      "relocs": 0, "reloc_rejects": 0}
        # what each candidate of the last _relocalize call gave (see there)
        self.reloc_log: list[dict] = []
        self.localization_only = False
        self.frame_id = -1
        self.reset()

    def reset(self):
        """Full reset: map, keyframe database, trajectory and counters
        (System::Reset -> Tracking::Reset, Tracking.cc:1365-1409).  The
        frame counter and ``stats`` run on."""
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

    def activate_localization_mode(self):
        """Track against the frozen map without inserting keyframes
        (System::ActivateLocalizationMode, System.cc:311-319).  Mapping is
        synchronous, so nothing is in flight to wait for."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

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
        if self.state == TrackState.OK and not self.localization_only:
            return self._track_fused(raw_a, raw_b, timestamp)
        # initialization, a frame after a loss and localization-only frames
        # run the decomposed steps
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
            return self.last_pose.cpu().numpy()

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
            if int(n_m) < 20:           # widen the window 2x (Tracking.cc:802)
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
            elif int(n_m) >= 20:
                seed = (pose0 if self.cfg.tracking.seed_pose_opt_from_prediction
                        else self.last_pose)
                pose, pt_idx, n_inliers = self._pose_opt_against_map(frame, seed, pt_idx)
                ok = int(n_inliers) >= self.cfg.tracking.min_inliers_track
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
        n_map_inliers = int(n_map_inliers)
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
        return pose.cpu().numpy()

    def _fused_step(self, raw_a, raw_b):
        """The whole per-frame OK-state path as device work with no host
        read (the JAX ``_build_fused_track.step``)."""
        cam, cfg, m = self.cam, self.cfg, self.map
        n_levels = cfg.orb.n_levels
        P = m.pt_pos.shape[0]
        th = self._motion_window
        frame = self._build_frame(raw_a, raw_b)
        last = self.last_frame
        pose0 = (self.velocity @ self.last_pose if self.velocity is not None
                 else self.last_pose)

        def motion(win):
            return TK.match_motion_model(
                cam, pose0, frame, self.last_pt_idx, last.octave,
                m.pt_pos, m.pt_valid, m.pt_desc, last.angle,
                th=win, scale_factors=self.scale_factors, nn_max_dist=75,
            )

        # 2x window retry when fewer than 20 matches (Tracking.cc:802).  The
        # JAX step branches on the device with lax.cond; here both widths
        # are matched and the result selected on the device, which keeps the
        # step free of host reads and gives the same answer.
        r1, r_wide = motion(th), motion(2 * th)
        retry = r1.n_matches < 20
        r = TK.ProjMatchResult(
            pt_idx=torch.where(retry, r_wide.pt_idx, r1.pt_idx),
            n_matches=torch.where(retry, r_wide.n_matches, r1.n_matches),
        )
        inv_s2 = self.inv_sigma2_table[torch.clamp(frame.octave, 0, n_levels - 1).long()]
        is_st = frame.uvr[:, 2] >= 0
        seed1 = pose0 if cfg.tracking.seed_pose_opt_from_prediction else self.last_pose
        o1 = optimize_pose(cam, seed1, m.pt_pos[torch.clamp(r.pt_idx, min=0).long()],
                           frame.uvr, inv_s2, r.pt_idx >= 0, is_st)
        pt1 = torch.where(o1.inlier, r.pt_idx, -1)

        # local map (TrackLocalMap)
        already = map_ops.set_rows(torch.zeros(P, dtype=torch.bool, device=self.device),
                                   torch.where(pt1 >= 0, pt1, P), True)
        local = TK.select_local_points(
            cam, o1.Tcw, m.pt_pos, m.pt_valid, m.pt_normal,
            m.pt_min_dist, m.pt_max_dist, already,
            budget=4096, scale_factor=cfg.orb.scale_factor, n_levels=n_levels,
        )
        r2 = TK.match_local_points(frame, local, m.pt_desc, pt1, th=1.0,
                                   scale_factors=self.scale_factors)
        o2 = optimize_pose(cam, o1.Tcw, m.pt_pos[torch.clamp(r2.pt_idx, min=0).long()],
                           frame.uvr, inv_s2, r2.pt_idx >= 0, is_st)
        pt2 = torch.where(o2.inlier, r2.pt_idx, -1)

        # visibility / found statistics (sync-mode map update)
        new_visible = map_ops.add_rows(m.pt_visible,
                                       torch.where(local.idx >= 0, local.idx, P), 1)
        new_found = map_ops.add_rows(m.pt_found, torch.where(pt2 >= 0, pt2, P), 1)

        # NeedNewKeyFrame close counts (Tracking.cc:911-927)
        close = (frame.depth > 0) & (frame.depth < self.th_depth_m) & frame.valid
        tracked_close = (close & (pt2 >= 0)).sum(dtype=torch.int32)
        untracked_close = (close & (pt2 < 0)).sum(dtype=torch.int32)

        # nRefMatches: the reference keyframe's landmarks with >= min_obs
        # observations (Tracking.cc:897-899); obs slots of culled keyframes
        # are cleared, so pt_obs_kf >= 0 alone is the validity test
        min_obs = 3 if self.n_kf > 2 else 2
        n_obs = (m.pt_obs_kf >= 0).sum(dim=1, dtype=torch.int32)
        ref_pt = m.kf_point_idx[self.ref_kf]
        rp = torch.clamp(ref_pt, min=0).long()
        ref_has = ((ref_pt >= 0) & m.kf_feat_valid[self.ref_kf] & m.pt_valid[rp]
                   & (n_obs[rp] >= min_obs))
        ref_tracked = ref_has.sum(dtype=torch.int32)

        Tcr = o2.Tcw @ se3.inv(m.kf_pose[self.ref_kf])
        scalars = torch.stack([
            r.n_matches, o1.n_inliers, o2.n_inliers,
            tracked_close, untracked_close, ref_tracked,
        ]).to(torch.int32)
        poses_out = torch.stack([o2.Tcw, Tcr])
        return frame, poses_out, pt2, new_visible, new_found, scalars

    def _commit_fused(self, step_out: tuple, timestamp: float) -> Optional[np.ndarray]:
        """The per-frame state machine on the step's outputs (the JAX
        ``_commit_fused`` with ``optimistic=False``)."""
        frame, poses_out, pt2, nvis, nfnd, sc = step_out
        poses_np = poses_out.cpu().numpy()
        s = sc.cpu().numpy()
        pose_np, Tcr_np = poses_np[0], poses_np[1]
        n_motion, n_inl1, n_map, t_close, u_close, ref_tracked = (int(x) for x in s)
        ok_motion = n_motion >= 20 and n_inl1 >= self.cfg.tracking.min_inliers_track

        if ok_motion:
            self.stats["motion_tracks"] += 1
            pose, pt_idx = poses_out[0], pt2
            n_map_inliers = n_map
            self.map = self.map.replace(pt_visible=nvis, pt_found=nfnd)
            close_counts = (t_close, u_close)
            self._ref_matches = ref_tracked
        else:
            # TrackReferenceKeyFrame fallback + decomposed local map
            ok, pose, pt_idx = self._track_reference_keyframe(frame)
            if not ok:
                self.state = TrackState.LOST
                self._log_frame(timestamp, lost=True)
                return None
            self.stats["ref_kf_tracks"] += 1
            pose, pt_idx, n_mi = self._track_local_map(frame, pose, pt_idx)
            n_map_inliers = int(n_mi)
            close_counts = None
            Tcr_np = None
            pose_np = None

        if n_map_inliers < self._local_map_bar():
            self.state = TrackState.LOST
            self._log_frame(timestamp, lost=True)
            return None

        self._advance(frame, pose, pt_idx)
        if self._need_new_keyframe(frame, pt_idx, n_map_inliers, close_counts):
            self._create_keyframe(frame, pose, pt_idx)
            Tcr_np = None   # the reference keyframe changed; recompute
        self._log_frame(timestamp, lost=False, Tcr=Tcr_np)
        return pose.cpu().numpy() if pose_np is None else pose_np

    def _track_fused(self, raw_a, raw_b, timestamp: float):
        """Steady-state tracked frame: one step, two host reads."""
        return self._commit_fused(self._fused_step(raw_a, raw_b), timestamp)

    # ----------------------------------------------------------- sub-steps
    def _local_map_bar(self) -> int:
        """TrackLocalMap's inlier bar, stricter for ``max_frames_between_kf``
        frames after a relocalization (Tracking.cc:870-877)."""
        t = self.cfg.tracking
        recent = (self.last_reloc_frame_id >= 0
                  and self.frame_id - self.last_reloc_frame_id < t.max_frames_between_kf)
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
        return pose.cpu().numpy()

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
        n_map, n_tot = torch.stack([map_inlier.sum(dtype=torch.int32),
                                    result.n_inliers.to(torch.int32)]).tolist()
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
        self._ref_matches = int(has.sum())

    def _track_reference_keyframe(self, frame: FrameData):
        """TrackReferenceKeyFrame (Tracking.cc:681-719): match the frame
        against the reference keyframe's landmark features, optimize the
        pose from the last one; returns (ok, pose, pt_idx)."""
        m, r = self.map, self.ref_kf
        res = TK.match_reference_kf(
            frame, m.kf_desc[r], m.kf_point_idx[r], m.kf_feat_valid[r],
            m.kf_angle[r], m.pt_valid, nn_ratio=self.cfg.matcher.nn_ratio_ref_kf,
        )
        if int(res.n_matches) < self.cfg.tracking.min_matches_ref_kf:
            return False, None, None
        pose, pt_idx, n_inl = self._pose_opt_against_map(frame, self.last_pose,
                                                         res.pt_idx)
        return int(n_inl) >= self.cfg.tracking.min_inliers_track, pose, pt_idx

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
        self.map = LM.update_visibility(self.map, local.idx, pt_idx)
        return pose, pt_idx, n_inl

    # ------------------------------------------------------- initialization
    def _initialize_depth(self, frame: FrameData) -> bool:
        """Stereo and RGB-D bootstrap (Tracking::StereoInitialization,
        Tracking.cc:454-503): enough features, then one point per feature
        with depth."""
        if self.sensor == "monocular":
            return False
        n_valid = int(frame.valid.sum())
        need = min(500, int(0.6 * self.n_feat_slots))
        if n_valid < need:
            return False
        # check the depth yield before touching the map
        if int((frame.depth > 0).sum()) < 100:
            return False
        pose = torch.eye(4, dtype=torch.float32, device=self.device)
        no_pt = torch.full((frame.n_slots,), -1, dtype=torch.int32, device=self.device)
        kf_slot = self._insert_keyframe_arrays(frame, pose, no_pt, parent=-1)
        self.map, n_new = map_ops.create_points_from_depth(
            self.map, kf_slot, frame.depth, no_pt, self.cam,
            th_depth=1e9,   # init: all depths (Tracking.cc:476)
            pt_base=self.n_pt, max_new=self.n_feat_slots,
        )
        self.n_pt += int(n_new)
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
        generator seeded with the frame id."""
        n_valid = int(frame.valid.sum())
        if self._init_ref is None:
            if n_valid >= 100:
                self._init_ref = frame
            return False
        if n_valid < 100:
            self._init_ref = None
            return False
        ref = self._init_ref

        # SearchForInitialization (ORBmatcher.cc:388-492): window 100 px,
        # ratio 0.9, mutual best.  The reference searches level 0 only but
        # doubles the feature budget of init frames (Tracking.cc:121); with
        # the normal budget levels 0-1 are admitted instead.
        geo = M.window_mask(ref.xy, frame.xy, 100.0)
        geo = geo & (ref.octave[:, None] <= 1) & (frame.octave[None, :] <= 1)
        res = M.nn_match(hamming(ref.desc, frame.desc), row_valid=ref.valid,
                         col_valid=frame.valid, extra_mask=geo, max_dist=50,
                         ratio=0.9, mutual=True)
        keep = M.rotation_consistency_mask(ref.angle, frame.angle, res)
        if int(keep.sum()) < 60:
            self._init_ref = frame      # restart with this frame (Tracking.cc:540)
            return False

        feat1 = torch.clamp(res.idx, min=0).long()
        xn1 = cam_mod.pixel_to_normalized(self.cam, ref.xy)
        xn2 = cam_mod.pixel_to_normalized(self.cam, frame.xy)[feat1]
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.frame_id)
        init = initialize_two_view(xn1, xn2, keep, gen, sigma_px=1.0,
                                   focal=float(self.cfg.camera.fx))

        # median depth of the good points (Tracking.cc:618-642): the mean of
        # the two middle values, as numpy.median
        good = init.inliers
        z_sorted = torch.sort(torch.where(good, init.points3d[:, 2], float("inf"))).values
        n_good = good.sum()
        mid = torch.stack([torch.clamp(n_good - 1, min=0) // 2, n_good // 2])
        med_depth = z_sorted[mid].mean()
        success, med, n_new = torch.stack(
            [init.success.to(torch.float32), med_depth, n_good.to(torch.float32)]).tolist()
        if not success:
            return False
        if not med > 0:
            self._init_ref = None
            return False
        n_new = int(n_new)
        scale = 1.0 / med_depth
        pos = init.points3d * scale
        T1 = torch.eye(4, dtype=torch.float32, device=self.device)
        T2 = se3.from_rt(init.R21, init.t21 * scale)

        N = frame.n_slots
        no_pt = torch.full((N,), -1, dtype=torch.int32, device=self.device)
        kf0 = self._insert_keyframe_arrays(ref, T1, no_pt, parent=-1)
        kf1 = self._insert_keyframe_arrays(frame, T2, no_pt, parent=kf0)

        # the triangulated points, observed by both keyframes: good match i
        # (feature i of the reference frame, feature feat1[i] of this one)
        # takes slot n_pt + its rank among the good
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
        return True

    # ----------------------------------------------------------- keyframes
    def _need_new_keyframe(self, frame: FrameData, pt_idx, n_inliers: int,
                           close_counts: Optional[tuple] = None) -> bool:
        """NeedNewKeyFrame (Tracking.cc:880-962) in synchronous mode, where
        local mapping is always idle.  ``close_counts`` = (tracked_close,
        untracked_close) from the fused step; computed here otherwise."""
        if self.n_kf >= self.cfg.map.max_keyframes - 2:
            telemetry.warn(
                "kf_capacity",
                f"keyframe bank full ({self.n_kf}/{self.cfg.map.max_keyframes})"
                " — no further keyframes will be inserted; raise "
                "MapConfig.max_keyframes",
            )
            return False
        frames_since = self.frame_id - self.last_kf_frame_id
        ref_matches = self._ref_matches
        mono = self.sensor == "monocular"
        # thRefRatio (Tracking.cc:922-928): 0.9 for monocular, 0.4 with a
        # near-empty map, 0.75 otherwise
        th_ratio = 0.9 if mono else 0.4 if self.n_kf < 2 else 0.75
        need_close = False
        if not mono:
            if close_counts is None:
                d = frame.depth.cpu().numpy()
                pid = pt_idx.cpu().numpy()
                close = (d > 0) & (d < self.th_depth_m)
                close_counts = (int((close & (pid >= 0)).sum()),
                                int((close & (pid < 0)).sum()))
            tracked_close, untracked_close = close_counts
            need_close = tracked_close < 100 and untracked_close > 70
        c1a = frames_since >= self.cfg.tracking.max_frames_between_kf
        c1b = frames_since >= self.cfg.tracking.min_frames_between_kf
        c1c = not mono and (n_inliers < ref_matches * 0.25 or need_close)
        c2 = (n_inliers < ref_matches * th_ratio or need_close) and n_inliers > 15
        return bool((c1a or c1b or c1c) and c2)

    def _insert_keyframe_arrays(self, frame: FrameData, pose, matched_pt,
                                parent: int) -> int:
        kf_slot = self.n_kf
        self.map = map_ops.insert_keyframe(
            self.map, kf_slot, self.frame_id, pose,
            frame.xy, frame.uvr, frame.octave, frame.angle, frame.desc,
            frame.valid, matched_pt, parent,
        )
        self.n_kf += 1
        self._register_keyframe_bow(kf_slot, frame)
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
                descs = frame.desc[frame.valid].cpu().numpy()
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
            self.n_pt += int(n_new)
        return kf_slot

    def _create_keyframe(self, frame: FrameData, pose, pt_idx):
        kf_slot = self._insert_kf_with_points(frame, pose, pt_idx)
        self._set_ref_kf(kf_slot)
        self.last_kf_frame_id = self.frame_id
        self._mapping_steps(kf_slot)
        if self.loop_closing_enabled:
            self._try_close_loop(kf_slot)
        # fusion may have merged landmarks the tracker references; re-read
        # the keyframe's (remapped) associations (MapPoint::Replace)
        self.last_pt_idx = self.map.kf_point_idx[kf_slot]

    def _try_close_loop(self, kf_slot: int):
        """Loop detection runs from the JAX package's first keyframe with
        enough history (its ``_try_close_loop``, system.py:2149)."""
        if self.n_kf >= self.cfg.loop.kf_gap + 2:
            raise NotImplementedError(
                f"keyframe {kf_slot}: loop closing arrives with ROADMAP.md queue 1 "
                "item 11; set SlamSystem.loop_closing_enabled = False to map "
                "without it"
            )

    # ------------------------------------------------------- local mapping
    def _mapping_steps(self, kf_slot: int):
        """The LocalMapping::Run body (LocalMapping.cc:44-104), run to
        completion: work sets, triangulation, fusion, recent-point culling
        with the statistics refresh, the triangulation reconcile, the local
        BA, keyframe culling."""
        default_nb = 20 if self.sensor == "monocular" else 10
        nn = self.cfg.map.fuse_neighbors or default_nb
        n_nb = self.cfg.map.triangulate_neighbors or default_nb
        t_cap = 3 * nn + 2
        work = self._work_sets(kf_slot, nn=nn, t_cap=t_cap, n_neighbors=n_nb)
        tri_nb, fuse_slots, fuse_slots_dev, window, fixed, cull_cands = work
        n_new, pt_base = self._triangulate_new_points(kf_slot, tri_nb)
        self._fuse_neighbors(kf_slot, fuse_slots, fuse_slots_dev)
        self._cull_and_refresh(kf_slot)
        self._reconcile_triangulation(n_new, pt_base)
        if self.n_kf >= 3:
            self._windowed_ba(window, fixed, 5, 10)
            # keep the tracker's pose consistent with the adjusted keyframe
            self.last_pose = self.map.kf_pose[kf_slot]
        if self.n_kf >= 5:
            self._cull_keyframes(kf_slot, cull_cands)

    def _work_sets(self, kf_slot: int, *, nn: int, t_cap: int, n_neighbors: int):
        """``mapping_work_sets`` on the device, then one host read of the
        two slot lists the triangulation and fuse loops walk (and the fuse
        target count).  Returns (triangulation neighbours, fuse targets as
        host lists, fuse targets on the device, BA window and fixed masks,
        culling candidates)."""
        tri_nb, fuse_slots, n_fuse, _, window, fixed, cull_cands = LM.mapping_work_sets(
            self.map, kf_slot, self.ref_kf, nn=nn, t_cap=t_cap, n_neighbors=n_neighbors,
        )
        host = torch.cat([tri_nb, fuse_slots, n_fuse[None]]).cpu().numpy()
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
        pt_base = self.n_pt
        self.map, n_new = LM.triangulate_with_neighbors(
            self.map, kf_slot, neighbors, self.cam, pt_base, max_new=64,
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            # mono requires a baseline of 1% of the median depth
            # (LocalMapping.cc:219)
            min_baseline_ratio=0.01 if self.sensor == "monocular" else 0.005,
        )
        self.n_pt = min(pt_base + 64 * len(neighbors), cap)
        if self.n_pt >= cap - 64:
            telemetry.warn(
                "pt_capacity",
                f"map-point bank full ({self.n_pt}/{cap}) — triangulation "
                "suspended; raise MapConfig.max_points",
            )
        return n_new, pt_base

    def _fuse_neighbors(self, kf_slot: int, fuse_slots: list, fuse_slots_dev):
        """SearchInNeighbors (LocalMapping.cc:425-509): this keyframe's
        landmarks into every target, then every target's landmarks into
        this keyframe."""
        sf, nl = self.cfg.orb.scale_factor, self.cfg.orb.n_levels
        self.map = LM.fuse_into_keyframes(
            self.map, fuse_slots, self.cam, budget=1024, scale_factor=sf,
            n_levels=nl, cand_idx=self.map.kf_point_idx[kf_slot],
        )
        # direction 2: membership of each observation in the target list
        obs = self.map.pt_obs_kf
        in_tgt = torch.any(obs[:, :, None] == fuse_slots_dev[None, None, :], dim=-1)
        tgt_mask = self.map.pt_valid & torch.any(in_tgt & (obs >= 0), dim=1)
        self.map = LM.fuse_into_keyframe(
            self.map, kf_slot, self.cam, tgt_mask, budget=2048, scale_factor=sf,
            n_levels=nl,
        )

    def _cull_and_refresh(self, kf_slot: int):
        """MapPointCulling over the recent slots, then the statistics of the
        points this keyframe observes (all points it triangulated or fused)."""
        self.map = LM.cull_recent_map_points(self.map, kf_slot, self.n_pt)
        self.map = update_point_stats_subset(
            self.map, self.map.kf_point_idx[kf_slot],
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
        )

    def _reconcile_triangulation(self, n_new: torch.Tensor, pt_base: int):
        """Hand back the reserved triangulation slots no point took (one
        host read).  In synchronous mode no other allocation can come in
        between, which the JAX package checks for its async modes."""
        self.n_pt = pt_base + int(n_new)

    def _windowed_ba(self, window_mask, fixed_mask, iters1: int, iters2: int):
        """Local BA (Optimizer::LocalBundleAdjustment) on the compact
        window: gather, ``iters1`` robust LM iterations, drop outliers,
        ``iters2`` more, scatter back with the final outliers erased.  The
        JAX package runs the iterations in chunks of 5 so that its async
        modes can interrupt between them; in synchronous mode nothing does,
        and the chunks give the same result as one run."""
        mcfg = self.cfg.map
        prob, kf_sel, pt_sel, obs_sel, n_pt_in = map_ops.gather_ba_window(
            self.map, window_mask, fixed_mask, self.inv_sigma2_table,
            max_kfs=mcfg.local_ba_max_kfs, max_points=mcfg.local_ba_max_points,
            max_obs=mcfg.local_ba_max_obs,
        )
        lam0 = lambda: torch.full((), 1e-4, dtype=torch.float32, device=self.device)
        poses, points, _ = BA.lm_chunk(self.cam, prob, prob.kf_poses, prob.points,
                                       lam0(), n_iters=iters1, use_huber=True)
        if iters2 > 0:
            prob = prob._replace(obs_valid=BA.classify_outliers(self.cam, prob,
                                                                poses, points))
            # fresh damping for the re-classified problem, like g2o
            poses, points, _ = BA.lm_chunk(self.cam, prob, poses, points, lam0(),
                                           n_iters=iters2, use_huber=True)
        final_valid = BA.classify_outliers(self.cam, prob, poses, points)
        self.map = map_ops.scatter_ba_window(self.map, prob, kf_sel, pt_sel, obs_sel,
                                             poses, points, final_valid)
        n_pt_in = int(n_pt_in)
        if n_pt_in > mcfg.local_ba_max_points:
            telemetry.warn(
                "local_ba_point_overflow",
                f"local BA window has {n_pt_in} points; only "
                f"{mcfg.local_ba_max_points} optimized (raise "
                "MapConfig.local_ba_max_points)",
            )

    def _cull_keyframes(self, kf_slot: int, cull_cands):
        """KeyFrameCulling (LocalMapping.cc:595-655): drop candidate
        keyframes with >= 90% redundant landmarks.  All candidates' ratios
        come from one batched evaluation, read back with the candidates and
        the parent bank in one host read; a ratio is evaluated again only
        after an earlier candidate of the round was culled (culling removes
        observations, which can only lower the other ratios)."""
        ratios = LM.keyframe_redundancy(self.map, torch.clamp(cull_cands, min=0))
        host = torch.cat([cull_cands.to(torch.float32), ratios,
                          self.map.kf_parent.to(torch.float32)]).cpu().numpy()
        C = cull_cands.shape[0]
        candidates = [int(c) for c in host[:C] if c >= 0]
        parents = host[2 * C:].astype(np.int64)
        culled_this_round = False
        for cand, ratio in zip(candidates, host[C:2 * C]):
            if ratio < 0.9:
                continue
            if culled_this_round:
                idx = torch.full((1,), cand, dtype=torch.int32, device=self.device)
                if float(LM.keyframe_redundancy(self.map, idx)[0]) < 0.9:
                    continue
            parent = int(parents[cand])
            if parent < 0:
                continue
            T_cp = (self.map.kf_pose[cand] @ se3.inv(self.map.kf_pose[parent]))
            self.culled_chain[cand] = (T_cp.cpu().numpy(), parent)
            # re-parent the children to the culled keyframe's parent
            children = np.nonzero(parents == cand)[0]
            if len(children):
                idx = torch.from_numpy(children).to(self.device)
                self.map = self.map.replace(kf_parent=map_ops.set_rows(
                    self.map.kf_parent, idx, parent))
                parents[children] = parent
            self.map = LM.remove_keyframe(self.map, cand)
            if self.db is not None:
                self.db.erase(cand)
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
        return res.pt_idx, int(res.n_matches)

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
        for cand in cands.tolist():
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
            rec["bow_matches"] = int(res.mask.sum())
            if rec["bow_matches"] < 15:         # SearchByBoW bar (Tracking.cc:1253)
                continue
            xn = cam_mod.pixel_to_normalized(self.cam,
                                             frame.xy[torch.clamp(res.idx, min=0).long()])
            gen = torch.Generator(device="cpu")
            gen.manual_seed(self.frame_id)
            pnp = epnp.epnp_ransac(m.pt_pos[kp], xn, res.mask, gen,
                                   sigma2=(1.0 / float(cfg.camera.fx)) ** 2,
                                   chi2_th=5.991, min_inliers=10)
            success, rec["epnp_inliers"] = torch.stack(
                [pnp.success.to(torch.int32), pnp.n_inliers]).tolist()
            if not success:
                continue
            # the pose-only LM on the EPnP inlier associations
            sel = res.mask & pnp.inliers
            pt_of_feat = map_ops.set_rows(
                torch.full((N,), -1, dtype=torch.int32, device=self.device),
                torch.where(sel, res.idx, N), torch.where(sel, pt_kf, -1))
            pose, pt_idx, n_inl = self._pose_opt_against_map(frame, pnp.Tcw, pt_of_feat)
            n_inl = int(n_inl)
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
                    n_inl = int(n_inl)
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
                            n_inl = int(n_inl)
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
    def _log_frame(self, timestamp, lost: bool, Tcr=None):
        if Tcr is None:
            Tcr = (self.last_pose @ se3.inv(self.map.kf_pose[self.ref_kf])).cpu().numpy()
        self.trajectory.append(FrameLog(self.frame_id, timestamp, Tcr, self.ref_kf, lost))

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
        """Frame logs with a pose (lost frames skipped, System.cc:387-388)."""
        return [log for log in self.trajectory if not log.lost]

    def tracked_frame_ids(self) -> np.ndarray:
        return np.asarray([log.frame_id for log in self.tracked_logs()])

    def frame_poses(self) -> np.ndarray:
        """(n, 4, 4) Tcw per tracked frame, recomposed through the current
        keyframe poses (System::SaveTrajectoryTUM, System.cc:355-415)."""
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
        System.cc:417-450)."""
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
