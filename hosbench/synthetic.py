"""Frozen copy of the port's synthetic batches (`hosnerf_tpu_torch/data/
synthetic.py::human_batch`, `composed_batch`, `scene_ray_batch`) and the
numpy skeleton helpers they call (`core/body.py`), so that the benchmark's
traffic does not move when the program changes. Same seed, same arrays
(`hosbench/tests/test_hosbench_traffic.py`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

SMPL_JOINT_IDX = {
    "pelvis_root": 0, "left_hip": 1, "right_hip": 2, "belly_button": 3,
    "left_knee": 4, "right_knee": 5, "lower_chest": 6, "left_ankle": 7,
    "right_ankle": 8, "upper_chest": 9, "left_toe": 10, "right_toe": 11,
    "neck": 12, "left_clavicle": 13, "right_clavicle": 14, "head": 15,
    "left_shoulder": 16, "right_shoulder": 17, "left_elbow": 18,
    "right_elbow": 19, "left_wrist": 20, "right_wrist": 21,
    "left_thumb": 22, "right_thumb": 23, "object_right": 24, "object_left": 25,
}

# parent[i] for joint i >= 1; joint 0 is the root. The object joints hang
# off the thumbs (24<-23, 25<-22).
SMPL_PARENT = {
    1: 0, 2: 0, 3: 0, 4: 1, 5: 2, 6: 3, 7: 4, 8: 5, 9: 6, 10: 7,
    11: 8, 12: 9, 13: 9, 14: 9, 15: 12, 16: 13, 17: 14, 18: 16, 19: 17,
    20: 18, 21: 19, 22: 20, 23: 21, 24: 23, 25: 22,
}
TOTAL_BONES = 26

TORSO_JOINTS = [
    SMPL_JOINT_IDX[n] for n in
    ["pelvis_root", "belly_button", "lower_chest", "upper_chest",
     "left_clavicle", "right_clavicle"]
]
BONE_STDS = np.array([0.03, 0.06, 0.03])
HEAD_STDS = np.array([0.06, 0.06, 0.06])
RIGHT_OBJECT_STDS = np.array([0.06, 0.06, 0.06])
LEFT_OBJECT_STDS = np.array([0.06, 0.06, 0.06])
JOINT_STDS = np.array([0.02, 0.02, 0.02])


def parent_index_array(total_bones: int = TOTAL_BONES) -> np.ndarray:
    """parents[i] = parent of joint i (parents[0] = 0)."""
    parents = np.zeros(total_bones, dtype=np.int32)
    for child, parent in SMPL_PARENT.items():
        if child < total_bones:
            parents[child] = parent
    return parents


def _rvec_to_rmtx_np(rvec: np.ndarray) -> np.ndarray:
    """Rodrigues on a single (3,) vector, with the reference's
    rvec / (theta + 1e-5) axis."""
    theta = np.linalg.norm(rvec)
    r = (rvec / (theta + 1e-5)).reshape(3)
    K = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    return (np.cos(theta) * np.eye(3) + np.sin(theta) * K
            + (1 - np.cos(theta)) * np.outer(r, r)).astype(np.float32)


def body_pose_to_body_RTs(jangles: np.ndarray, tpose_joints: np.ndarray):
    """Joint angles [(J*3,)] + tpose joints [J, 3] -> per-bone local (R, T)."""
    jangles = jangles.reshape(-1, 3)
    total = jangles.shape[0]
    parents = parent_index_array(total)
    Rs = np.stack([_rvec_to_rmtx_np(jangles[i]) for i in range(total)], 0)
    Ts = tpose_joints - tpose_joints[parents]
    Ts[0] = tpose_joints[0]
    return Rs.astype(np.float32), Ts.astype(np.float32)


def get_canonical_global_tfms(canonical_joints: np.ndarray) -> np.ndarray:
    """Canonical joints [J, 3] -> global 4x4 transforms [J, 4, 4]."""
    total = canonical_joints.shape[0]
    parents = parent_index_array(total)
    gtfms = np.zeros((total, 4, 4), dtype=np.float32)
    gtfms[:, :3, :3] = np.eye(3)
    gtfms[:, 3, 3] = 1.0
    gtfms[0, :3, 3] = canonical_joints[0]
    for i in range(1, total):
        local = np.eye(4, dtype=np.float32)
        local[:3, 3] = canonical_joints[i] - canonical_joints[parents[i]]
        gtfms[i] = gtfms[parents[i]] @ local
    return gtfms


def _rotation_between_np(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Rotation matrix sending direction v1 to v2."""
    v1 = v1 / max(np.linalg.norm(v1), 1e-5)
    v2 = v2 / max(np.linalg.norm(v2), 1e-5)
    n = np.cross(v1, v2)
    c = float(v1 @ v2)
    K = np.array([[0, -n[2], n[1]], [n[2], 0, -n[0]], [-n[1], n[0], 0]])
    return (np.eye(3) + K + K @ K * (1.0 / (1.0 + c))).astype(np.float32)


def approx_gaussian_bone_volumes(tpose_joints: np.ndarray,
                                 bbox_min_xyz: np.ndarray,
                                 bbox_max_xyz: np.ndarray,
                                 grid_size: int = 32) -> np.ndarray:
    """Analytic per-bone gaussian prior volumes [J+1, G, G, G], volume
    axes (z, y, x), last channel the background."""
    total_joints = tpose_joints.shape[0]
    tpose_joints = tpose_joints.astype(np.float32)
    parents = parent_index_array(total_joints)

    zs = np.linspace(bbox_min_xyz[2], bbox_max_xyz[2], grid_size)
    ys = np.linspace(bbox_min_xyz[1], bbox_max_xyz[1], grid_size)
    xs = np.linspace(bbox_min_xyz[0], bbox_max_xyz[0], grid_size)
    zg, yg, xg = np.meshgrid(zs, ys, xs, indexing="ij")
    grid = np.stack([xg, yg, zg], axis=-1)  # [G,G,G,3] xyz channels

    def gaussian(center, S, R):
        sigma = R @ S @ S @ R.T
        d = grid - center
        dist = np.einsum("abci,ij,abcj->abc", d, sigma, d)
        return np.exp(-dist)

    calibrated = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    children_of = {j: [c for c in range(1, total_joints) if parents[c] == j]
                   for j in range(total_joints)}

    g_volumes = []
    for j in range(total_joints):
        vol = np.zeros((grid_size,) * 3, dtype=np.float32)
        children = children_of[j]
        if children:
            for child in children:
                stds = BONE_STDS * 2.0
                S = np.diag(1.0 / stds).astype(np.float32)
                if j in TORSO_JOINTS:
                    S[0, 0] /= 1.5
                    S[2, 2] /= 1.5
                start, end = tpose_joints[j], tpose_joints[child]
                R = _rotation_between_np(calibrated, end - start)
                vol = vol + gaussian((start + end) / 2.0, S, R)
        else:
            if j == SMPL_JOINT_IDX["head"]:
                stds = HEAD_STDS
            elif j == SMPL_JOINT_IDX["object_right"]:
                stds = RIGHT_OBJECT_STDS
            elif j == SMPL_JOINT_IDX["object_left"]:
                stds = LEFT_OBJECT_STDS
            else:
                stds = JOINT_STDS
            S = np.diag(1.0 / (stds * 2.0)).astype(np.float32)
            vol = gaussian(tpose_joints[j], S, np.eye(3, dtype=np.float32))
        g_volumes.append(vol.astype(np.float32))

    g_volumes = np.stack(g_volumes, axis=0)
    bg = 1.0 - np.clip(np.sum(g_volumes, axis=0, keepdims=True), 0.0, 1.0)
    g_volumes = np.concatenate([g_volumes, bg], axis=0)
    return g_volumes / np.clip(np.sum(g_volumes, axis=0, keepdims=True),
                               0.001, None)


def human_batch(n_patches: int = 2, patch_size: int = 8, seed: int = 0,
                time: float = 0.5, grid_size: int = 16,
                total_bones: int = 26) -> Dict[str, np.ndarray]:
    """A fabricated stage-2 item: a synthetic skeleton inside
    [-0.5, 0.5]^3, gaussian bone-volume priors, camera rays from z = -3
    toward the subject, and dense target patches."""
    rng = np.random.default_rng(seed)
    R = n_patches * patch_size * patch_size

    tpose = np.zeros((total_bones, 3), np.float32)
    parents = parent_index_array(total_bones)
    for j in range(1, total_bones):
        tpose[j] = tpose[parents[j]] + rng.normal(scale=0.08, size=3)
    tpose = np.clip(tpose, -0.45, 0.45).astype(np.float32)

    bbox_offset = 0.3
    bbox_min = tpose.min(0) - bbox_offset
    bbox_max = tpose.max(0) + bbox_offset
    bbox_scale = 2.0 / (bbox_max - bbox_min)

    cnl_gtfms = get_canonical_global_tfms(tpose)
    priors = approx_gaussian_bone_volumes(
        tpose, bbox_min, bbox_max, grid_size=grid_size)

    def pose_arrays(scale):
        angles = (rng.normal(scale=scale, size=(total_bones * 3,))
                  .astype(np.float32))
        Rs, Ts = body_pose_to_body_RTs(angles, tpose)
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
