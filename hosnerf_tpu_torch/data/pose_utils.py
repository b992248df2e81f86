"""Pose normalization and render-path generation, host-side numpy
(counterpart of `hosnerf_tpu/data/pose_utils.py`; `pose_interp`
interpolates axis-angle rotations through `data/imgproc.py`'s Rodrigues
pair in place of cv2's).

Provenance: `transform_poses_pca` / `focus_point_fn` / `viewmatrix` /
`generate_ellipse_path` implement the canonical camera-path math from
Google's multinerf (Apache-2.0), which the HOSNeRF reference itself
vendors verbatim; the numpy statement order here follows that lineage.
"""

from __future__ import annotations

import numpy as np

from hosnerf_tpu_torch.data.imgproc import rodrigues, rodrigues_inverse


def normalize(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-7)


def pad_poses(p: np.ndarray) -> np.ndarray:
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def viewmatrix(lookdir, up, position) -> np.ndarray:
    """Look-at camera-to-world [3, 4] (ref: pose_utils.py:62-68)."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def transform_poses_pca(poses: np.ndarray):
    """Rotate/scale c2w poses so PCA axes align with XYZ and translations fit
    in [-1,1]^3 (ref: pose_utils.py:15-49)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean

    eigval, eigvec = np.linalg.eig(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    rot = eigvec[:, inds].T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1.0])) @ rot

    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_recentered = (transform @ pad_poses(poses))[..., :3, :4]
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)

    if poses_recentered.mean(axis=0)[2, 1] < 0:
        flip = np.diag(np.array([1, -1, -1.0]))
        poses_recentered = flip @ poses_recentered
        transform = np.diag(np.array([1, -1, -1, 1.0])) @ transform

    scale = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
    poses_recentered[:, :3, 3] *= scale
    transform = np.diag(np.array([scale] * 3 + [1.0])) @ transform
    return poses_recentered, transform


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Nearest point to all camera focal axes (ref: pose_utils.py:52-58)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 5,
                          z_variation: float = 0.0,
                          z_phase: float = 0.0) -> np.ndarray:
    """Elliptical orbit through the capture volume."""
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low, high = -sc + offset, sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)[:-1]
    positions = np.stack([
        low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
        low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
        z_variation * (z_low[2] + (z_high - z_low)[2]
                       * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
    ], -1)

    avg_up = normalize(poses[:, :3, 1].mean(0))
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])
    return np.stack([viewmatrix(p - center, up, p) for p in positions])


def pose_interp(poses: np.ndarray, factor: int) -> np.ndarray:
    """Insert `factor-1` interpolated poses between neighbors (4x factor on
    the wrap-around segment), axis-angle rotation interp + lerped
    translation (ref: pose_utils.py:129-152)."""
    out = []
    n = len(poses)
    for i in range(n):
        out.append(np.asarray(poses[i], np.float64))
        f = 4 * factor if i == n - 1 else factor
        nxt = (i + 1) % n
        r_rel = poses[nxt, :3, :3] @ poses[i, :3, :3].T
        rvec = rodrigues_inverse(r_rel)
        for j in range(f - 1):
            frac = (j + 1) / f
            ret = np.eye(4)
            ret[:3, :3] = rodrigues(rvec * frac) @ poses[i, :3, :3]
            ret[:3, 3] = ((1 - frac) * poses[i, :3, 3]
                          + frac * poses[nxt, :3, 3])
            out.append(ret)
    return np.stack(out).astype(np.float32)
