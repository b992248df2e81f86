"""Per-frame human-object dataset (stages 2/3), host-side numpy
(counterpart of `hosnerf_tpu/data/human_dataset.py`: the same items from
the same seed, drawing from `np.random.default_rng` in the same order;
images read, undistorted and resized by `data/imgproc.py` in place of
cv2).

* train items emit dense patches: every pixel of each sampled patch gets
  a ray (static shapes), with per-ray (near, far, valid) from the dense
  bbox slab test;
* eval items emit the full pixel grid + ray_mask; the renderer chunks
  statically.

On-disk layout matches the reference datasets:
  images/*.png, masks/*.png, images_flow/*_bwd.npz,
  canonical_joints.pkl, mesh_infos.pkl, cameras.pkl,
  cameras_scaleworld.pkl (stage-1 output), transitions_times.json.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from hosnerf_tpu_torch.core import body as body_math
from hosnerf_tpu_torch.data import cameras as cam_util
from hosnerf_tpu_torch.data import imgproc


def add_object_joints(joints24: np.ndarray) -> np.ndarray:
    """Append the two object joints extrapolated from wrists/elbows.

    object_right = j23 + (j23 - j19); object_left = j22 + (j22 - j18)
    (ref: train.py:131-146 `load_canonical_joints`).
    """
    right = joints24[23] + (joints24[23] - joints24[19])
    left = joints24[22] + (joints24[22] - joints24[18])
    return np.concatenate([joints24, right[None], left[None]], 0)


def skeleton_to_bbox(skeleton: np.ndarray, bbox_offset: float = 0.6):
    return {"min_xyz": np.min(skeleton, axis=0) - bbox_offset,
            "max_xyz": np.max(skeleton, axis=0) + bbox_offset}


def resize_flow(flow: np.ndarray, h_new: int, w_new: int) -> np.ndarray:
    """ref: train.py:32-37 (note: the reference scales u by H-ratio and v by
    W-ratio; kept bit-compatible)."""
    h_old, w_old = flow.shape[:2]
    out = imgproc.resize(flow, (w_new, h_new),
                         interpolation=imgproc.INTER_LINEAR)
    out[:, :, 0] *= h_new / h_old
    out[:, :, 1] *= w_new / w_old
    return out


class HumanDataset:
    """Modes: 'train', 'progress', 'movement', 'test', 'freeview', 'tpose'.

    progress/test use every-(N//16)-th frame x16; train excludes those
    frames; movement is every frame (ref: create_dataset.py:43-49,
    train.py:112-121).
    """

    def __init__(self, dataset_path: str, mode: str = "train",
                 bbox_offset: float = 0.6, mweight_volume_size: int = 32,
                 resize_img_scale: float = 1.0,
                 n_patches: int = 2, patch_size: int = 32,
                 sample_subject_ratio: float = 0.8,
                 bgcolor: Optional[List[float]] = None,
                 freeview_frame_idx: int = 0, render_frames: int = 100,
                 skip: int = 1, maxframes: int = -1,
                 use_scaleworld: bool = False, seed: int = 0):
        self.path = dataset_path
        self.mode = mode
        self.bbox_offset = bbox_offset
        self.resize_img_scale = resize_img_scale
        self.n_patches = n_patches
        self.patch_size = patch_size
        self.sample_subject_ratio = sample_subject_ratio
        self.bgcolor = bgcolor
        self.freeview_frame_idx = freeview_frame_idx
        self.render_frames = render_frames
        self.use_scaleworld = use_scaleworld
        self.rng = np.random.default_rng(seed)

        self.image_dir = os.path.join(dataset_path, "images")
        self.flow_dir = os.path.join(dataset_path, "images_flow")

        with open(os.path.join(dataset_path, "canonical_joints.pkl"),
                  "rb") as f:
            cl = pickle.load(f)
        self.canonical_joints = add_object_joints(
            cl["joints"].astype(np.float32))
        self.canonical_bbox = skeleton_to_bbox(self.canonical_joints,
                                               bbox_offset)
        self.motion_weights_priors = body_math.approx_gaussian_bone_volumes(
            self.canonical_joints, self.canonical_bbox["min_xyz"],
            self.canonical_bbox["max_xyz"],
            grid_size=mweight_volume_size).astype(np.float32)
        self.cnl_gtfms = body_math.get_canonical_global_tfms(
            self.canonical_joints)

        cam_file = ("cameras_scaleworld.pkl" if use_scaleworld
                    else "cameras.pkl")
        with open(os.path.join(dataset_path, cam_file), "rb") as f:
            self.cameras = pickle.load(f)

        with open(os.path.join(dataset_path, "mesh_infos.pkl"), "rb") as f:
            mesh_infos = pickle.load(f)
        # extend every frame with the object joints + zero object pose dims
        # (ref: train.py:164-180)
        for fn, info in mesh_infos.items():
            tj = info["tpose_joints"].astype(np.float32)
            info["tpose_joints"] = add_object_joints(tj)
            info["poses"] = np.concatenate(
                [info["poses"].astype(np.float32),
                 np.zeros(6, np.float32)], 0)
            info["bbox"] = skeleton_to_bbox(
                add_object_joints(info["joints"].astype(np.float32))
                if info["joints"].shape[0] == 24 else info["joints"],
                bbox_offset)
        self.mesh_infos = mesh_infos

        frames = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(self.image_dir) if f.endswith(".png"))
        total = len(frames)
        times_all = np.linspace(0.0, 1.0, total).astype(np.float32)

        idx = np.arange(total)
        test_skip = max(total // 16, 1)
        test_idx = idx[::test_skip][:16]
        if len(test_idx) >= total:  # tiny datasets: keep at most half
            test_idx = test_idx[::2][: max(total // 2, 1)]
        if mode == "train":
            keep = np.array([i for i in idx if i not in test_idx])
        elif mode in ("progress", "test"):
            keep = test_idx
        elif mode in ("movement", "tpose"):
            keep = idx
        elif mode == "freeview":
            keep = np.arange(self.render_frames)
        else:
            raise ValueError(mode)

        if mode != "freeview":
            keep = keep[::skip]
            if maxframes > 0:
                keep = keep[:maxframes]
            self.framelist = [frames[i] for i in keep]
            self.times = times_all[keep]
        else:
            self.framelist = [frames[min(freeview_frame_idx, total - 1)]
                              ] * self.render_frames
            self.times = np.full(self.render_frames,
                                 times_all[min(freeview_frame_idx,
                                               total - 1)], np.float32)
        self.img_idx = keep
        self.all_frames = frames
        self.times_all = times_all
        self.is_train = mode == "train"

        tt_path = os.path.join(dataset_path, "transitions_times.json")
        self.transitions = None
        if os.path.exists(tt_path):
            with open(tt_path) as f:
                infos = json.load(f)
            self.transitions = np.array(
                [np.float32(v["time"]) for v in infos.values()], np.float32)

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.framelist)

    def _load_image(self, frame_name: str):
        img = imgproc.imread_png(
            os.path.join(self.image_dir, frame_name + ".png"),
            color=True)[..., ::-1].astype(np.float32)
        alpha = imgproc.imread_png(
            os.path.join(self.path, "masks", frame_name + ".png"), color=True)
        alpha = alpha.astype(np.float32) / 255.0
        cam = self.cameras.get(frame_name, {})
        if "distortions" in cam:
            K = cam["intrinsics"]
            D = cam["distortions"]
            img = imgproc.undistort(img, K, D)
            alpha = imgproc.undistort(alpha, K, D)
        if self.resize_img_scale != 1.0:
            img = imgproc.resize(img, None, fx=self.resize_img_scale,
                                 fy=self.resize_img_scale,
                                 interpolation=imgproc.INTER_LANCZOS4)
            alpha = imgproc.resize(alpha, None, fx=self.resize_img_scale,
                                   fy=self.resize_img_scale,
                                   interpolation=imgproc.INTER_LINEAR)
        return img / 255.0, alpha

    def _load_flow(self, frame_name: str, h: int, w: int):
        p = os.path.join(self.flow_dir, frame_name + "_bwd.npz")
        if not os.path.exists(p):
            return np.zeros((h, w, 2), np.float32), np.zeros((h, w),
                                                             np.float32)
        data = np.load(p)
        flow, mask = data["flow"], np.float32(data["mask"])
        if flow.shape[:2] != (h, w):
            flow = resize_flow(flow, h, w)
            mask = imgproc.resize(mask, (w, h),
                                  interpolation=imgproc.INTER_NEAREST)
        return flow.astype(np.float32), mask

    def _skel(self, frame_name: str):
        info = self.mesh_infos[frame_name]
        return {
            "poses": info["poses"].astype(np.float32),
            "tpose_joints": info["tpose_joints"].astype(np.float32),
            "bbox": {k: v.copy() for k, v in info["bbox"].items()},
            "Rh": info["Rh"].astype(np.float32),
            "Th": info["Th"].astype(np.float32),
        }

    def _camera_for(self, frame_name: str, skel):
        cam = self.cameras[frame_name]
        K = cam["intrinsics"][:3, :3].copy().astype(np.float32)
        K[:2] *= self.resize_img_scale
        E, newsmpl_to_smpl = cam_util.apply_global_tfm_to_camera(
            cam["smpl_to_camera"], skel["Rh"], skel["Th"])
        return K, E, newsmpl_to_smpl, cam

    def _pick_patches(self, subject_mask, bbox_mask, h, w):
        """Patch center selection (ref: train.py:252-321), dense patches."""
        out = []
        bbox_not_subject = bbox_mask & ~subject_mask
        for _ in range(self.n_patches):
            cand = (subject_mask
                    if self.rng.random() < self.sample_subject_ratio
                    else bbox_not_subject)
            if not cand.any():
                cand = (subject_mask if subject_mask.any()
                        else np.ones_like(subject_mask))
            ys, xs = np.where(cand)
            k = self.rng.integers(len(ys))
            half = self.patch_size // 2
            x_min = int(np.clip(xs[k] - half, 0, w - self.patch_size))
            y_min = int(np.clip(ys[k] - half, 0, h - self.patch_size))
            out.append((x_min, y_min))
        return out

    # ------------------------------------------------------------------
    def get_train_item(self, idx: int) -> Dict[str, np.ndarray]:
        frame_name = self.framelist[idx]
        time = self.times[idx]
        if self.bgcolor is None:
            bgcolor = (self.rng.random(3) * 255.0).astype(np.float32)
        else:
            bgcolor = np.asarray(self.bgcolor, np.float32)

        img, alpha = self._load_image(frame_name)
        h, w = img.shape[:2]
        flow, flow_mask = self._load_flow(frame_name, h, w)

        skel = self._skel(frame_name)
        K, E, newsmpl_to_smpl, cam = self._camera_for(frame_name, skel)

        # composite the training target over bgcolor where stage-2 style;
        # stage 3 trains against the raw image (ref: 3rd train.py:356)
        if not self.use_scaleworld:
            img = (img * alpha[..., :1]
                   + (1 - alpha[..., :1]) * bgcolor / 255.0)

        rays_o, rays_d = cam_util.get_rays_from_KRT(
            h, w, K, E[:3, :3], E[:3, 3])
        near, far, ray_mask = cam_util.rays_intersect_3d_bbox_dense(
            skel["bbox"], rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))
        near = near.reshape(h, w)
        far = far.reshape(h, w)
        ray_mask = ray_mask.reshape(h, w)

        subject_mask = alpha[..., 0] > 0.0
        corners = self._pick_patches(subject_mask, ray_mask, h, w)

        P = self.patch_size

        def crop(arr, c):
            x0, y0 = c
            return arr[y0:y0 + P, x0:x0 + P]

        i_grid, j_grid = np.meshgrid(np.arange(w, dtype=np.float32),
                                     np.arange(h, dtype=np.float32),
                                     indexing="xy")
        grid5 = np.stack([i_grid, j_grid, flow[..., 0], flow[..., 1],
                          flow_mask], -1)

        def gather(arr):
            return np.concatenate(
                [crop(arr, c).reshape(-1, *arr.shape[2:]) for c in corners])

        results = {
            "frame_name": frame_name,
            "time": np.float32(time),
            "bgcolor": bgcolor,
            "rays_o": gather(rays_o).astype(np.float32),
            "rays_d": gather(rays_d).astype(np.float32),
            "near": gather(near[..., None]).astype(np.float32),
            "far": gather(far[..., None]).astype(np.float32),
            "ray_valid": gather(ray_mask[..., None].astype(np.float32)),
            "ray_grid": gather(grid5).astype(np.float32),
            "target_patches": np.stack(
                [crop(img, c) for c in corners]).astype(np.float32),
            "patch_masks": np.stack(
                [crop(ray_mask, c) for c in corners]).astype(np.float32),
            "dst_posevec": skel["poses"][3:] + 1e-2,
            "cnl_gtfms": self.cnl_gtfms,
            "motion_weights_priors": self.motion_weights_priors,
            "cnl_bbox_min_xyz": self.canonical_bbox["min_xyz"].astype(
                np.float32),
            "cnl_bbox_scale_xyz": (2.0 / (
                self.canonical_bbox["max_xyz"]
                - self.canonical_bbox["min_xyz"])).astype(np.float32),
        }
        dst_Rs, dst_Ts = body_math.body_pose_to_body_RTs(
            skel["poses"], skel["tpose_joints"])
        results["dst_Rs"] = dst_Rs
        results["dst_Ts"] = dst_Ts

        # previous-frame pose for the flow branch; self for frame 0
        # (ref: train.py:668-700)
        gi = int(self.img_idx[idx])
        prev_name = (self.all_frames[gi - 1] if gi > 0 and time > 0.005
                     else frame_name)
        skel_p = self._skel(prev_name)
        Kp, Ep, _, _ = self._camera_for(prev_name, skel_p)
        dst_Rs_p, dst_Ts_p = body_math.body_pose_to_body_RTs(
            skel_p["poses"], skel_p["tpose_joints"])
        results.update({
            "dst_Rs_prev": dst_Rs_p,
            "dst_Ts_prev": dst_Ts_p,
            "dst_posevec_prev": skel_p["poses"][3:] + 1e-2,
            "newsmpl_to_camera_prev": Ep.astype(np.float32),
            "intrinsics_prev": Kp.astype(np.float32),
        })

        # stage-3 background rays in scaled world (ref: 3rd train.py:511-548)
        if self.use_scaleworld:
            sw2cam = cam["scaleworld_to_camera"]
            results["newsmpl_to_scale_world"] = np.asarray(
                cam["smpl_to_scale_world"] @ newsmpl_to_smpl, np.float32)
            ro, rd, vd, radii = cam_util.get_rays_from_KRT_bkg(
                h, w, K, sw2cam[:3, :3], sw2cam[:3, 3])
            results["rays_o_bkg"] = gather(ro).astype(np.float32)
            results["rays_d_bkg"] = gather(rd).astype(np.float32)
            results["viewdirs_bkg"] = gather(vd).astype(np.float32)
            results["radii"] = gather(radii).astype(np.float32)
        return results

    # ------------------------------------------------------------------
    def get_eval_item(self, idx: int) -> Dict[str, np.ndarray]:
        """Full-image item for progress/movement/test rendering."""
        frame_name = self.framelist[idx]
        time = self.times[idx]
        bgcolor = np.asarray(self.bgcolor if self.bgcolor is not None
                             else [255.0, 255.0, 255.0], np.float32)
        img, alpha = self._load_image(frame_name)
        h, w = img.shape[:2]
        skel = self._skel(frame_name)
        K, E, newsmpl_to_smpl, cam = self._camera_for(frame_name, skel)
        if not self.use_scaleworld:
            img = (img * alpha[..., :1]
                   + (1 - alpha[..., :1]) * bgcolor / 255.0)

        rays_o, rays_d = cam_util.get_rays_from_KRT(
            h, w, K, E[:3, :3], E[:3, 3])
        near, far, ray_mask = cam_util.rays_intersect_3d_bbox_dense(
            skel["bbox"], rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))

        dst_Rs, dst_Ts = body_math.body_pose_to_body_RTs(
            skel["poses"], skel["tpose_joints"])
        results = {
            "frame_name": frame_name,
            "time": np.float32(time),
            "img_width": w, "img_height": h,
            "target_img": img.astype(np.float32),
            "bgcolor": bgcolor,
            "rays_o": rays_o.reshape(-1, 3).astype(np.float32),
            "rays_d": rays_d.reshape(-1, 3).astype(np.float32),
            "near": near[:, None], "far": far[:, None],
            "ray_mask": ray_mask,
            "dst_Rs": dst_Rs, "dst_Ts": dst_Ts,
            "dst_posevec": skel["poses"][3:] + 1e-2,
            "cnl_gtfms": self.cnl_gtfms,
            "motion_weights_priors": self.motion_weights_priors,
            "cnl_bbox_min_xyz": self.canonical_bbox["min_xyz"].astype(
                np.float32),
            "cnl_bbox_scale_xyz": (2.0 / (
                self.canonical_bbox["max_xyz"]
                - self.canonical_bbox["min_xyz"])).astype(np.float32),
        }
        if self.use_scaleworld:
            sw2cam = cam["scaleworld_to_camera"]
            results["newsmpl_to_scale_world"] = np.asarray(
                cam["smpl_to_scale_world"] @ newsmpl_to_smpl, np.float32)
            ro, rd, vd, radii = cam_util.get_rays_from_KRT_bkg(
                h, w, K, sw2cam[:3, :3], sw2cam[:3, 3])
            results["rays_o_bkg"] = ro.reshape(-1, 3).astype(np.float32)
            results["rays_d_bkg"] = rd.reshape(-1, 3).astype(np.float32)
            results["viewdirs_bkg"] = vd.reshape(-1, 3).astype(np.float32)
            results["radii"] = radii.reshape(-1, 1).astype(np.float32)
        return results

    def get_freeview_item(self, view_idx: int) -> Dict[str, np.ndarray]:
        """Orbit views of the fixed freeview frame (ref: 3rd freeview.py)."""
        frame_name = self.framelist[view_idx]
        item = self.get_eval_item(view_idx)
        skel = self._skel(frame_name)
        K, E, newsmpl_to_smpl, cam = self._camera_for(frame_name, skel)
        center = np.mean(np.stack([skel["bbox"]["min_xyz"],
                                   skel["bbox"]["max_xyz"]]), 0)
        E_rot, T_smpl = cam_util.rotate_camera_by_frame_idx(
            E, view_idx, trans=center, period=self.render_frames)
        h, w = item["img_height"], item["img_width"]
        rays_o, rays_d = cam_util.get_rays_from_KRT(
            h, w, K, E_rot[:3, :3], E_rot[:3, 3])
        near, far, ray_mask = cam_util.rays_intersect_3d_bbox_dense(
            skel["bbox"], rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))
        item.update({
            "rays_o": rays_o.reshape(-1, 3).astype(np.float32),
            "rays_d": rays_d.reshape(-1, 3).astype(np.float32),
            "near": near[:, None], "far": far[:, None],
            "ray_mask": ray_mask,
        })
        if self.use_scaleworld:
            # orbit in scaled world: T_world = s2w @ T_smpl @ inv(s2w)
            # (ref: 3rd freeview.py:227-230)
            s2w = np.asarray(cam["smpl_to_scale_world"] @ newsmpl_to_smpl,
                             np.float64)
            T_world = s2w @ T_smpl @ np.linalg.inv(s2w)
            E_colmap = cam["scaleworld_to_camera"] @ T_world
            ro, rd, vd, radii = cam_util.get_rays_from_KRT_bkg(
                h, w, K, E_colmap[:3, :3], E_colmap[:3, 3])
            item["rays_o_bkg"] = ro.reshape(-1, 3).astype(np.float32)
            item["rays_d_bkg"] = rd.reshape(-1, 3).astype(np.float32)
            item["viewdirs_bkg"] = vd.reshape(-1, 3).astype(np.float32)
            item["radii"] = radii.reshape(-1, 1).astype(np.float32)
        return item

    def get_tpose_item(self, view_idx: int, resolution: int = 512,
                       time: Optional[float] = None) -> Dict[str, np.ndarray]:
        """Canonical-pose turntable render item (ref: tpose.py:28-233:
        synthetic camera at radius 6, focal 1250, orbiting the canonical
        skeleton)."""
        joints = self.canonical_joints
        center = joints.mean(0)
        angle = 2 * np.pi * view_idx / max(self.render_frames, 1)
        campos = center + 6.0 * np.array(
            [np.sin(angle), 0.0, np.cos(angle)], np.float32)
        camrot = cam_util.get_camrot(campos, lookat=center)
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = camrot
        E[:3, 3] = -camrot @ campos
        K = np.array([[1250.0, 0, resolution / 2],
                      [0, 1250.0, resolution / 2], [0, 0, 1]], np.float32)

        rays_o, rays_d = cam_util.get_rays_from_KRT(
            resolution, resolution, K, E[:3, :3], E[:3, 3])
        bbox = self.canonical_bbox
        near, far, ray_mask = cam_util.rays_intersect_3d_bbox_dense(
            bbox, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))

        # canonical pose: zero joint angles
        poses = np.zeros(len(joints) * 3, np.float32)
        dst_Rs, dst_Ts = body_math.body_pose_to_body_RTs(poses, joints)
        return {
            "time": np.float32(self.times[0] if time is None else time),
            "img_width": resolution, "img_height": resolution,
            "bgcolor": np.asarray(self.bgcolor or [255.0] * 3, np.float32),
            "rays_o": rays_o.reshape(-1, 3).astype(np.float32),
            "rays_d": rays_d.reshape(-1, 3).astype(np.float32),
            "near": near[:, None], "far": far[:, None],
            "ray_mask": ray_mask,
            "dst_Rs": dst_Rs, "dst_Ts": dst_Ts,
            "dst_posevec": poses[3:] + 1e-2,
            "cnl_gtfms": self.cnl_gtfms,
            "motion_weights_priors": self.motion_weights_priors,
            "cnl_bbox_min_xyz": bbox["min_xyz"].astype(np.float32),
            "cnl_bbox_scale_xyz": (2.0 / (bbox["max_xyz"]
                                          - bbox["min_xyz"])).astype(
                np.float32),
        }

    def __getitem__(self, idx: int):
        if self.mode == "train":
            return self.get_train_item(idx)
        if self.mode == "freeview":
            return self.get_freeview_item(idx)
        if self.mode == "tpose":
            return self.get_tpose_item(idx)
        return self.get_eval_item(idx)
