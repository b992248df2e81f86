"""Synthetic batches in numpy and the mini capture on disk (counterpart of
`hosnerf_tpu/data/synthetic.py::human_batch`, `composed_batch`,
`scene_ray_batch` and `write_mini_dataset`; same seed, same arrays)."""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict

import numpy as np

from hosnerf_tpu_torch.core import body
from hosnerf_tpu_torch.data.cameras import get_camrot
from hosnerf_tpu_torch.data.imgproc import imwrite_png


def human_batch(n_patches: int = 2, patch_size: int = 8, seed: int = 0,
                time: float = 0.5, grid_size: int = 16,
                total_bones: int = 26) -> Dict[str, np.ndarray]:
    """A fabricated stage-2 item: a synthetic skeleton inside
    [-0.5, 0.5]^3, gaussian bone-volume priors, camera rays from z = -3
    toward the subject, and dense target patches."""
    rng = np.random.default_rng(seed)
    R = n_patches * patch_size * patch_size

    tpose = np.zeros((total_bones, 3), np.float32)
    parents = body.parent_index_array(total_bones)
    for j in range(1, total_bones):
        tpose[j] = tpose[parents[j]] + rng.normal(scale=0.08, size=3)
    tpose = np.clip(tpose, -0.45, 0.45).astype(np.float32)

    bbox_offset = 0.3
    bbox_min = tpose.min(0) - bbox_offset
    bbox_max = tpose.max(0) + bbox_offset
    bbox_scale = 2.0 / (bbox_max - bbox_min)

    cnl_gtfms = body.get_canonical_global_tfms(tpose)
    priors = body.approx_gaussian_bone_volumes(
        tpose, bbox_min, bbox_max, grid_size=grid_size)

    def pose_arrays(scale):
        angles = (rng.normal(scale=scale, size=(total_bones * 3,))
                  .astype(np.float32))
        Rs, Ts = body.body_pose_to_body_RTs(angles, tpose)
        return Rs, Ts, angles[3:]      # posevec: non-root joints, 75-d

    dst_Rs, dst_Ts, posevec = pose_arrays(0.1)
    dst_Rs_p, dst_Ts_p, posevec_p = pose_arrays(0.1)

    cam = np.array([0.0, 0.0, -3.0], np.float32)
    px = rng.uniform(-0.3, 0.3, size=(R, 2)).astype(np.float32)
    d = np.concatenate([px, np.ones((R, 1), np.float32)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    return {
        "rays_o": np.broadcast_to(cam, (R, 3)).copy(),
        "rays_d": d,
        "near": np.full((R, 1), 2.2, np.float32),
        "far": np.full((R, 1), 3.8, np.float32),
        "dst_Rs": dst_Rs, "dst_Ts": dst_Ts,
        "dst_posevec": posevec,
        "dst_Rs_prev": dst_Rs_p, "dst_Ts_prev": dst_Ts_p,
        "dst_posevec_prev": posevec_p,
        "cnl_gtfms": cnl_gtfms,
        "motion_weights_priors": priors,
        "cnl_bbox_min_xyz": bbox_min.astype(np.float32),
        "cnl_bbox_scale_xyz": bbox_scale.astype(np.float32),
        "bgcolor": np.array([255.0, 255.0, 255.0], np.float32),
        "time": np.float32(time),
        "target_patches": rng.uniform(
            0, 1, (n_patches, patch_size, patch_size, 3)).astype(np.float32),
        "patch_masks": np.ones((n_patches, patch_size, patch_size),
                               np.float32),
        "ray_grid": np.concatenate([
            rng.uniform(0, 64, (R, 2)),
            rng.normal(scale=1.0, size=(R, 2)),
            np.ones((R, 1))], -1).astype(np.float32),
        "newsmpl_to_camera_prev": np.eye(4, dtype=np.float32),
        "intrinsics_prev": np.array(
            [[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]], np.float32),
    }


def write_mini_dataset(path: str, n_frames: int = 8, res: int = 48,
                       n_transitions: int = 1, seed: int = 0) -> str:
    """Write a mini capture with the original HOSNeRF datasets' layout
    (images/, masks/, images_flow/*_bwd.npz, canonical_joints.pkl,
    mesh_infos.pkl, cameras.pkl, poses_bounds.npy, transitions_times.json)
    under `path`, so that the loaders and all three training stages run
    without capture data. The same files as the JAX package's writer from
    the same seed; the PNGs hold the same pixels, written by
    `imgproc.imwrite_png`."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    os.makedirs(os.path.join(path, "masks"), exist_ok=True)
    os.makedirs(os.path.join(path, "images_flow"), exist_ok=True)

    # 24 SMPL joints in a rough standing pose whose x/z spread matches the
    # painted subject's extent, so that rays through subject pixels pass
    # near bone volumes and stage 2 has a gradient path to the images
    joints = np.zeros((24, 3), np.float32)
    joints[:, 1] = np.linspace(-0.8, 0.6, 24)
    joints[:, 0] = rng.normal(scale=0.25, size=24)
    joints[:, 2] = rng.normal(scale=0.25, size=24)

    with open(os.path.join(path, "canonical_joints.pkl"), "wb") as f:
        pickle.dump({"joints": joints}, f)

    focal = 1.2 * res
    K = np.array([[focal, 0, res / 2], [0, focal, res / 2], [0, 0, 1]],
                 np.float64)

    mesh_infos, cameras = {}, {}
    poses_bounds = np.zeros((n_frames, 17), np.float64)
    frame_names = [f"frame_{i:06d}" for i in range(n_frames)]
    parents24 = np.array(
        [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
         17, 18, 19, 20, 21])
    for i, fn in enumerate(frame_names):
        # camera orbiting the subject
        th = 2 * np.pi * i / n_frames * 0.2
        campos = np.array([2.5 * np.sin(th), 0.0, -2.5 * np.cos(th)])
        Rm = get_camrot(campos.astype(np.float32),
                        np.zeros(3, np.float32)).astype(np.float64)
        E = np.eye(4)
        E[:3, :3] = Rm
        E[:3, 3] = -Rm @ campos

        # image: a coloured gradient background and a solid-colour subject
        # painted along the projected skeleton; mask = the subject
        yy, xx = np.mgrid[0:res, 0:res]
        img = np.stack([xx / res, yy / res, np.full_like(xx, 0.5,
                                                         dtype=float)], -1)
        blob = np.zeros((res, res), bool)
        rad = max(2, res // 14)
        for j in range(24):
            for t in np.linspace(0.0, 1.0, 6):
                p3 = joints[j] * (1 - t) + joints[parents24[j]] * t
                cam = Rm @ p3 + E[:3, 3]
                if cam[2] <= 1e-3:
                    continue
                pix = K @ (cam / cam[2])
                cx, cy = int(round(pix[0])), int(round(pix[1]))
                blob |= ((xx - cx) ** 2 + (yy - cy) ** 2) < rad ** 2
        img[blob] = [0.9, 0.3, 0.2]
        imwrite_png(os.path.join(path, "images", fn + ".png"),
                    (img * 255).astype(np.uint8)[..., ::-1])
        imwrite_png(os.path.join(path, "masks", fn + ".png"),
                    (blob * 255).astype(np.uint8))
        np.savez(os.path.join(path, "images_flow", fn + "_bwd.npz"),
                 flow=rng.normal(scale=0.5, size=(res, res, 2)).astype(
                     np.float32),
                 mask=np.ones((res, res), bool))
        cameras[fn] = {
            "intrinsics": K.astype(np.float32),
            "smpl_to_camera": E.astype(np.float32),
            "smpl_to_world": np.eye(4, dtype=np.float32),
        }
        mesh_infos[fn] = {
            "poses": rng.normal(scale=0.05, size=72).astype(np.float32),
            "tpose_joints": joints,
            "joints": joints + rng.normal(scale=0.01, size=joints.shape
                                          ).astype(np.float32),
            "Rh": rng.normal(scale=0.02, size=3).astype(np.float32),
            "Th": rng.normal(scale=0.02, size=3).astype(np.float32),
        }
        # poses_bounds row: 3x5 [R|t|hwf] + near/far in LLFF layout; the
        # loader maps stored columns [s0 s1 s2] to OpenCV's [s1, s0, -s2],
        # so store the inverse mapping
        c2w = np.linalg.inv(E)
        stored = np.stack(
            [c2w[:3, 1], c2w[:3, 0], -c2w[:3, 2], c2w[:3, 3]], axis=1)
        hwf = np.array([[res], [res], [focal]])
        poses_bounds[i, :15] = np.concatenate([stored, hwf], 1).reshape(-1)
        poses_bounds[i, 15:] = [0.5, 10.0]

    np.save(os.path.join(path, "poses_bounds.npy"), poses_bounds)
    with open(os.path.join(path, "mesh_infos.pkl"), "wb") as f:
        pickle.dump(mesh_infos, f)
    with open(os.path.join(path, "cameras.pkl"), "wb") as f:
        pickle.dump(cameras, f)
    if n_transitions > 0:
        tt = {frame_names[(k + 1) * n_frames // (n_transitions + 1)]:
              {"time": float((k + 1) / (n_transitions + 1))}
              for k in range(n_transitions)}
        with open(os.path.join(path, "transitions_times.json"), "w") as f:
            json.dump(tt, f)
    return path


def composed_batch(n_patches: int = 2, patch_size: int = 8, seed: int = 0,
                   time: float = 0.5, grid_size: int = 16
                   ) -> Dict[str, np.ndarray]:
    """A fabricated stage-3 item: the human item plus background rays for
    the same pixels in scaled-world coordinates. The smpl -> scaled-world
    transform is the identity, so the background rays are the human
    rays."""
    b = human_batch(n_patches, patch_size, seed=seed, time=time,
                    grid_size=grid_size)
    R = b["rays_o"].shape[0]
    b["newsmpl_to_scale_world"] = np.eye(4, dtype=np.float32)
    b["rays_o_bkg"] = b["rays_o"].copy()
    b["rays_d_bkg"] = b["rays_d"].copy()
    b["viewdirs_bkg"] = b["rays_d"].copy()
    b["radii"] = np.full((R, 1), 0.002, np.float32)
    return b


def scene_ray_batch(n_rays: int, seed: int = 0,
                    time: float = 0.0) -> Dict[str, np.ndarray]:
    """Random rays from cameras on a ring through a synthetic scene of two
    solid-colour gaussian blobs over a white background, with targets
    rendered by marching a fine fixed grid: rays_o, rays_d, viewdirs
    [N, 3], radii [N, 1], times [N], target [N, 3]."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n_rays)
    cam = np.stack([3.0 * np.cos(theta), 3.0 * np.sin(theta),
                    rng.uniform(-0.5, 0.5, n_rays)], -1)
    aim = rng.normal(scale=0.4, size=(n_rays, 3))
    d = aim - cam
    viewdirs = d / np.linalg.norm(d, axis=-1, keepdims=True)

    blobs = np.array([[0.5, 0.0, 0.0], [-0.4, 0.3, 0.1]])
    blob_rgb = np.array([[0.9, 0.2, 0.1], [0.1, 0.3, 0.8]])
    sigma = 0.25
    ts = np.linspace(0.5, 6.0, 96)
    pts = cam[:, None, :] + viewdirs[:, None, :] * ts[None, :, None]
    dens = np.zeros(pts.shape[:2])
    rgb = np.zeros(pts.shape)
    for b, c in zip(blobs, blob_rgb):
        g = np.exp(-np.sum((pts - b) ** 2, -1) / (2 * sigma ** 2)) * 8.0
        dens += g
        rgb += g[..., None] * c
    rgb = rgb / np.maximum(dens[..., None], 1e-8)
    dt = ts[1] - ts[0]
    alpha = 1.0 - np.exp(-dens * dt)
    trans = np.cumprod(np.concatenate(
        [np.ones((n_rays, 1)), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    target = (w[..., None] * rgb).sum(1) + (1 - w.sum(1))[:, None]

    return {
        "rays_o": cam.astype(np.float32),
        "rays_d": viewdirs.astype(np.float32),
        "viewdirs": viewdirs.astype(np.float32),
        "radii": np.full((n_rays, 1), 0.002, np.float32),
        "times": np.full((n_rays,), time, np.float32),
        "target": target.astype(np.float32),
    }
