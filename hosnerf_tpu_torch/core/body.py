"""Skeleton / kinematics math for the human-object model.

Counterpart of `hosnerf_tpu/core/body.py`. Device-side pieces are torch
functions on [..., B, 3, 3] / [..., B, 4, 4] tensors; host-side pieces
are jax-free numpy copies used to build synthetic batches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Device-side (torch)
# ---------------------------------------------------------------------------

def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Batched Rodrigues formula: [..., 3] axis-angle -> [..., 3, 3], with
    the reference's epsilon-regularized angle theta = sqrt(1e-5 + |r|^2)."""
    theta = torch.sqrt(1e-5 + torch.sum(rvec ** 2, dim=-1))
    r = rvec / theta[..., None]
    cos = torch.cos(theta)
    sin = torch.sin(theta)
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    one_c = 1.0 - cos
    rows = [
        rx * rx + (1.0 - rx * rx) * cos,
        rx * ry * one_c - rz * sin,
        rx * rz * one_c + ry * sin,
        rx * ry * one_c + rz * sin,
        ry * ry + (1.0 - ry * ry) * cos,
        ry * rz * one_c - rx * sin,
        rx * rz * one_c - ry * sin,
        ry * rz * one_c + rx * sin,
        rz * rz + (1.0 - rz * rz) * cos,
    ]
    return torch.stack(rows, dim=-1).reshape(rvec.shape[:-1] + (3, 3))


@functools.lru_cache(maxsize=None)
def _unit_row(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[0, 0, 0, 1], made on `device` once per (device, dtype) by device
    ops: a row built from a host list is a blocking copy to the card."""
    return (torch.arange(4, device=device) == 3).to(dtype)


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    return _unit_row(like.device, like.dtype).expand(like.shape[:-2]
                                                     + (1, 4))


def rigid_inverse(G: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse [R^T | -R^T t] of rigid 4x4 transforms."""
    R = G[..., :3, :3]
    t = G[..., :3, 3]
    Rt = R.transpose(-1, -2)
    new_t = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, new_t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(G)], dim=-2)


def affine_inverse(G: torch.Tensor) -> torch.Tensor:
    """Exact inverse of affine 4x4 transforms via the adjugate: the
    reference's Rodrigues rotations are ~1e-4 non-orthonormal, so the
    transpose would not do (see the JAX counterpart's note)."""
    R = G[..., :3, :3]
    t = G[..., :3, 3]
    c0, c1, c2 = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    adj = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                       torch.linalg.cross(c0, c1)], dim=-2)
    det = torch.sum(c0 * torch.linalg.cross(c1, c2), dim=-1)[..., None, None]
    Rinv = adj / det
    new_t = -torch.einsum("...ij,...j->...i", Rinv, t)
    top = torch.cat([Rinv, new_t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(G)], dim=-2)


def construct_G(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    top = torch.cat([R, T[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(R)], dim=-2)


def forward_kinematics(local_Gs: torch.Tensor,
                       total_bones: int = TOTAL_BONES) -> torch.Tensor:
    """Compose local per-bone transforms [..., B, 4, 4] along the static
    parent chain -> global transforms, same shape."""
    parents = parent_index_array(total_bones)
    gtfms = [local_Gs[..., 0, :, :]]
    for i in range(1, total_bones):
        gtfms.append(torch.matmul(gtfms[parents[i]], local_Gs[..., i, :, :]))
    return torch.stack(gtfms, dim=-3)


def motion_bases(dst_Rs: torch.Tensor, dst_Ts: torch.Tensor,
                 cnl_gtfms: torch.Tensor):
    """Backward (canonical <- observation) and forward per-bone affine
    bases. Returns (scale_Rs, Ts, scale_Rs_fwd, Ts_fwd)."""
    local_Gs = construct_G(dst_Rs, dst_Ts)
    dst_gtfms = forward_kinematics(local_Gs, local_Gs.shape[-3])

    f_mtx = torch.matmul(cnl_gtfms, affine_inverse(dst_gtfms))
    f_fwd = torch.matmul(dst_gtfms, affine_inverse(cnl_gtfms))
    return f_mtx[..., :3, :3], f_mtx[..., :3, 3], f_fwd[..., :3, :3], \
        f_fwd[..., :3, 3]


# ---------------------------------------------------------------------------
# Host-side (numpy) — synthetic data helpers
# ---------------------------------------------------------------------------

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
