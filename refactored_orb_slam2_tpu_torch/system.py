"""SLAM system facade: the RGB-D tracking slice (port of system.py).

What runs here, in the JAX package's order:

- frame 0: ``_initialize_depth`` — keyframe 0, one point per feature with
  depth, the full-bank point statistics, the reference keyframe;
- every later frame: ``_fused_step`` (the JAX ``_build_fused_track.step``):
  frame build, motion-model match with the 2x window retry, pose-only LM,
  local-map selection and the fused window matcher (CUDA kernel), a second
  pose-only LM, the visibility/found counters, the close-point and
  reference-tracked counts, and ``Tcr``; then ``_commit_fused`` on its
  ``ok_motion`` branch and ``_need_new_keyframe``;
- the trajectory products (``frame_poses``, ``export_trajectory_tum``, ...).

Paths outside the slice raise ``NotImplementedError`` naming the ROADMAP.md
queue-1 item that brings them.  The host reads one (6,) scalar vector and one
(2, 4, 4) pose stack per tracked frame, as the JAX facade does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from refactored_orb_slam2_tpu.utils import telemetry

from .frontend import tracking_kernels as TK
from .frontend.frame import FrameData, build_frame_rgbd
from .geometry import se3
from .geometry.camera import camera_from_config
from .models import map_ops
from .models.map_state import create_empty, n_observations, update_point_stats
from .ops.image import level_sigma2
from .ops.orb import level_quotas
from .optim.pose_opt import optimize_pose


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1


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


@dataclasses.dataclass
class FrameLog:
    frame_id: int
    timestamp: float
    Tcr: np.ndarray          # pose relative to the reference keyframe
    ref_kf: int
    lost: bool


class SlamSystem:
    """RGB-D tracking on an explicit device.  Feed frames with
    ``track_rgbd`` (host arrays) or ``track_rgbd_device`` (uint8 image and
    uint16 millimetre depth already on ``device``); read the trajectory with
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
        if config.sensor != "rgbd":
            raise NotImplementedError(
                f"sensor {config.sensor!r}: stereo arrives with ROADMAP.md queue 1 "
                "item 8 and monocular with item 9; the port tracks RGB-D"
            )
        self.cfg = config
        self.device = torch.device(device)
        self.cam = camera_from_config(config.camera)

        self.n_feat_slots = sum(level_quotas(
            config.orb.n_features, config.orb.n_levels, config.orb.scale_factor
        ))
        self.map = create_empty(config.map, self.n_feat_slots, self.device)
        self.n_kf = 0
        self.n_pt = 0

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

        self.state = TrackState.NOT_INITIALIZED
        self.frame_id = -1
        self.last_frame: Optional[FrameData] = None
        self.last_pose: Optional[torch.Tensor] = None
        self.last_pt_idx: Optional[torch.Tensor] = None
        self.velocity: Optional[torch.Tensor] = None
        self.ref_kf = 0
        self._ref_matches = 0
        self.last_kf_frame_id = -1
        self.trajectory: list[FrameLog] = []

    # ------------------------------------------------------------- tracking
    def track_rgbd(self, img, depth, timestamp: float) -> Optional[np.ndarray]:
        """Host frame: grayscale image in [0, 255] and depth in meters."""
        return self._track_entry(
            torch.from_numpy(_encode_img(img)).to(self.device),
            torch.from_numpy(_encode_depth(depth)).to(self.device),
            timestamp,
        )

    def track_rgbd_device(self, img_u8: torch.Tensor, depth_u16: torch.Tensor,
                          timestamp: float) -> Optional[np.ndarray]:
        """Frame already in the wire encoding and on ``self.device``."""
        return self._track_entry(img_u8, depth_u16, timestamp)

    def _track_entry(self, raw_a, raw_b, timestamp: float):
        self.frame_id += 1
        if self.state == TrackState.OK:
            return self._track_fused(raw_a, raw_b, timestamp)
        frame = self._build_frame(raw_a, raw_b)
        if not self._initialize_depth(frame):
            return None
        self.state = TrackState.OK
        self._log_frame(timestamp, lost=False)
        return self.last_pose.cpu().numpy()

    def _build_frame(self, raw_a, raw_b) -> FrameData:
        return build_frame_rgbd(_decode_img(raw_a), _decode_depth(raw_b),
                                self.cam, self.cfg.orb)

    def _fused_step(self, raw_a, raw_b):
        """The whole per-frame OK-state path as device work with no host
        read (the JAX ``_build_fused_track.step``)."""
        cam, cfg, m = self.cam, self.cfg, self.map
        n_levels = cfg.orb.n_levels
        P = m.pt_pos.shape[0]
        th = 15.0
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

    def _commit_fused(self, step_out: tuple, timestamp: float) -> np.ndarray:
        """The per-frame state machine on the step's outputs (the JAX
        ``_commit_fused`` with ``optimistic=False``, ``ok_motion`` branch)."""
        frame, poses_out, pt2, nvis, nfnd, sc = step_out
        poses_np = poses_out.cpu().numpy()
        s = sc.cpu().numpy()
        pose_np, Tcr_np = poses_np[0], poses_np[1]
        n_motion, n_inl1, n_map, t_close, u_close, ref_tracked = (int(x) for x in s)
        ok_motion = n_motion >= 20 and n_inl1 >= self.cfg.tracking.min_inliers_track
        if not ok_motion:
            raise NotImplementedError(
                f"frame {self.frame_id}: motion-model tracking failed "
                f"({n_motion} matches, {n_inl1} inliers); the TrackReferenceKeyFrame "
                "fallback arrives with ROADMAP.md queue 1 item 7"
            )
        self.map = self.map.replace(pt_visible=nvis, pt_found=nfnd)
        self._ref_matches = ref_tracked

        # the stricter bar right after a relocalization (Tracking.cc:870-877)
        # arrives with relocalization, ROADMAP.md queue 1 item 10
        local_bar = self.cfg.tracking.min_inliers_local_map
        if n_map < local_bar:
            raise NotImplementedError(
                f"frame {self.frame_id}: tracking lost ({n_map} local-map "
                f"inliers < {local_bar}); the LOST state arrives with ROADMAP.md "
                "queue 1 item 7 and relocalization with item 10"
            )

        pose = poses_out[0]
        self.velocity = pose @ se3.inv(self.last_pose)
        self.last_pose = pose
        self.last_frame = frame
        self.last_pt_idx = pt2
        self.state = TrackState.OK
        if self._need_new_keyframe(n_map, (t_close, u_close), self.frame_id):
            raise NotImplementedError(
                f"frame {self.frame_id}: a new keyframe is needed; keyframe "
                "insertion with local mapping arrives with ROADMAP.md queue 1 item 7"
            )
        self._log_frame(timestamp, lost=False, Tcr=Tcr_np)
        return pose_np

    def _track_fused(self, raw_a, raw_b, timestamp: float):
        """Steady-state tracked frame: one step, two host reads."""
        return self._commit_fused(self._fused_step(raw_a, raw_b), timestamp)

    # ------------------------------------------------------- initialization
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

    def _initialize_depth(self, frame: FrameData) -> bool:
        """RGB-D bootstrap (Tracking::StereoInitialization,
        Tracking.cc:454-503): enough features, then one point per feature
        with depth."""
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

    # ----------------------------------------------------------- keyframes
    def _need_new_keyframe(self, n_inliers: int, close_counts: tuple,
                           frame_id: int) -> bool:
        """NeedNewKeyFrame (Tracking.cc:880-962) in synchronous mode, where
        local mapping is always idle."""
        if self.n_kf >= self.cfg.map.max_keyframes - 2:
            telemetry.warn(
                "kf_capacity",
                f"keyframe bank full ({self.n_kf}/{self.cfg.map.max_keyframes})"
                " — no further keyframes will be inserted; raise "
                "MapConfig.max_keyframes",
            )
            return False
        frames_since = frame_id - self.last_kf_frame_id
        ref_matches = self._ref_matches
        th_ratio = 0.4 if self.n_kf < 2 else 0.75     # thRefRatio, Tracking.cc:922-928
        tracked_close, untracked_close = close_counts
        need_close = tracked_close < 100 and untracked_close > 70
        c1a = frames_since >= self.cfg.tracking.max_frames_between_kf
        c1b = frames_since >= self.cfg.tracking.min_frames_between_kf
        c1c = n_inliers < ref_matches * 0.25 or need_close
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
        # The JAX package also registers the keyframe's BoW signature in the
        # KeyFrameDB here (_register_keyframe_bow).  Nothing on the tracking
        # slice reads the database; it arrives with relocalization, ROADMAP.md
        # queue 1 item 10.
        return kf_slot

    # ----------------------------------------------------------- trajectory
    def _log_frame(self, timestamp, lost: bool, Tcr=None):
        if Tcr is None:
            Tcr = (self.last_pose @ se3.inv(self.map.kf_pose[self.ref_kf])).cpu().numpy()
        self.trajectory.append(FrameLog(self.frame_id, timestamp, Tcr, self.ref_kf, lost))

    def tracked_logs(self) -> list[FrameLog]:
        """Frame logs with a pose (lost frames skipped, System.cc:387-388)."""
        return [log for log in self.trajectory if not log.lost]

    def tracked_frame_ids(self) -> np.ndarray:
        return np.asarray([log.frame_id for log in self.tracked_logs()])

    def frame_poses(self) -> np.ndarray:
        """(n, 4, 4) Tcw per tracked frame, recomposed through the current
        keyframe poses (System::SaveTrajectoryTUM, System.cc:355-415).  No
        keyframe is culled on the slice, so each reference keyframe's pose is
        read directly; chaining through culled keyframes arrives with
        keyframe culling (ROADMAP.md queue 1 item 7)."""
        kf_poses = self.map.kf_pose.cpu().numpy()
        out = [log.Tcr @ kf_poses[log.ref_kf] for log in self.tracked_logs()]
        if not out:
            return np.zeros((0, 4, 4), dtype=np.float32)
        return np.stack(out)

    def camera_centers(self) -> np.ndarray:
        return np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in self.frame_poses()])

    def export_trajectory_tum(self, path: str):
        poses = self.frame_poses()
        with open(path, "w") as f:
            for log, Tcw in zip(self.tracked_logs(), poses):
                Twc = np.linalg.inv(Tcw)
                q = se3.to_quaternion(torch.from_numpy(Twc[:3, :3].copy())).numpy()
                t = Twc[:3, 3]
                f.write(
                    f"{log.timestamp:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )
