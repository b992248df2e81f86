"""Host-side (numpy) camera geometry for the human-object pipeline
(counterpart of `hosnerf_tpu/data/cameras.py`; the same arrays, with
`data/imgproc.py::rodrigues` in place of `cv2.Rodrigues`).

`rays_intersect_3d_bbox_dense` returns per-ray (near, far, mask) without
boolean compaction, so downstream batches keep static shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from hosnerf_tpu_torch.data.imgproc import rodrigues


def rodrigues_np(rvec: np.ndarray) -> np.ndarray:
    return rodrigues(rvec).astype(np.float32)


def get_camrot(campos: np.ndarray, lookat: Optional[np.ndarray] = None,
               inv_camera: bool = False) -> np.ndarray:
    """Camera rotation from position + look-at (ref: camera_util.py:74-103)."""
    if lookat is None:
        lookat = np.zeros(3, np.float32)
    up = np.array([0.0, -1.0 if inv_camera else 1.0, 0.0], np.float32)
    forward = lookat - campos
    forward = forward / np.linalg.norm(forward)
    right = np.cross(up, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    up = up / np.linalg.norm(up)
    return np.array([right, up, forward], dtype=np.float32)


def update_extrinsics(extrinsics: np.ndarray, angle: float,
                      trans: Optional[np.ndarray] = None):
    """Rotate the scene (SMPL) about a 15-degree-elevated axis and return the
    updated extrinsics plus the smpl-space transform T_smpl.
    ref: camera_util.py:13-71 (stage-3 variant returning (new_E, T_smpl))."""
    grot_vec = np.array(
        [0.0, np.cos(15 / 180 * np.pi), np.sin(15 / 180 * np.pi)]) * angle
    grot_mtx = rodrigues_np(grot_vec)

    T = np.identity(4)
    T[:3, :3] = grot_mtx
    if trans is not None:
        T_a = np.identity(4)
        T_a[:3, 3] = -trans
        T_b = np.identity(4)
        T_b[:3, 3] = trans
        T = T_b @ T @ T_a
    T_smpl = np.linalg.inv(T)
    return (extrinsics @ T_smpl).astype(np.float32), T_smpl.astype(np.float32)


def rotate_camera_by_frame_idx(extrinsics: np.ndarray, frame_idx: int,
                               trans: Optional[np.ndarray] = None,
                               period: int = 196, inv_angle: bool = False):
    """Orbit by frame index (ref: camera_util.py:106-130)."""
    angle = 2 * np.pi * (frame_idx / period)
    if inv_angle:
        angle = -angle
    return update_extrinsics(extrinsics, angle, trans)


def apply_global_tfm_to_camera(E: np.ndarray, Rh: np.ndarray,
                               Th: np.ndarray):
    """Fold SMPL global Rh/Th into the extrinsics; also return
    newsmpl_to_smpl (ref: camera_util.py:133-151, stage-3 variant)."""
    global_tfms = np.eye(4)
    rot = rodrigues_np(Rh).T
    global_tfms[:3, :3] = rot
    global_tfms[:3, 3] = -rot @ np.asarray(Th, np.float64)
    newsmpl_to_smpl = np.linalg.inv(global_tfms)
    return (E @ newsmpl_to_smpl).astype(np.float32), \
        newsmpl_to_smpl.astype(np.float32)


def get_rays_from_KRT(H: int, W: int, K: np.ndarray, R: np.ndarray,
                      T: np.ndarray):
    """Per-pixel rays in world space (ref: camera_util.py:154-180)."""
    rays_o = (-R.T @ T).ravel()
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = xy1 @ np.linalg.inv(K).T
    pixel_world = (pixel_camera - T.ravel()) @ R
    rays_d = pixel_world - rays_o[None, None]
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_rays_from_KRT_bkg(H: int, W: int, K: np.ndarray, R: np.ndarray,
                          T: np.ndarray):
    """KRT rays + normalized viewdirs + mip radii
    (ref: camera_util.py:183-216)."""
    rays_o, rays_d = get_rays_from_KRT(H, W, K, R, T)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    dx = np.sqrt(np.sum((rays_d[:-1] - rays_d[1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1, :]], 0)
    radii = dx[..., None] * 2 / np.sqrt(12)
    return rays_o, rays_d, viewdirs.astype(np.float32), \
        radii.astype(np.float32)


def rays_intersect_3d_bbox_dense(bounds: np.ndarray, ray_o: np.ndarray,
                                 ray_d: np.ndarray):
    """Slab test of rays vs an axis-aligned box, DENSE outputs.

    Returns (near [N], far [N], mask [N]); invalid rays get near=far=0.
    Semantics match the reference's compacted version
    (ref: camera_util.py:219-266) on the valid rays.
    """
    if isinstance(bounds, dict):
        bounds = np.stack([bounds["min_xyz"], bounds["max_xyz"]], axis=0)
    bounds = bounds + np.array([-0.01, 0.01])[:, None]

    ray_d = ray_d.copy()
    ray_d[np.abs(ray_d) < 1e-5] = 1e-5
    nominator = bounds[None] - ray_o[:, None]  # [N, 2, 3]
    d_intersect = (nominator / ray_d[:, None]).reshape(-1, 6)
    p_intersect = (d_intersect[..., None] * ray_d[:, None]
                   + ray_o[:, None])  # [N, 6, 3]
    min_x, min_y, min_z, max_x, max_y, max_z = bounds.ravel()
    eps = 1e-6
    ok = ((p_intersect[..., 0] >= min_x - eps)
          & (p_intersect[..., 0] <= max_x + eps)
          & (p_intersect[..., 1] >= min_y - eps)
          & (p_intersect[..., 1] <= max_y + eps)
          & (p_intersect[..., 2] >= min_z - eps)
          & (p_intersect[..., 2] <= max_z + eps))  # [N, 6]
    mask = ok.sum(-1) == 2

    norm_ray = np.linalg.norm(ray_d, axis=-1)
    # distances to the (up to 2) valid plane hits; invalid -> +inf / -inf
    dist = np.linalg.norm(p_intersect - ray_o[:, None], axis=-1) / \
        norm_ray[:, None]
    near = np.where(mask, np.min(np.where(ok, dist, np.inf), axis=-1), 0.0)
    far = np.where(mask, np.max(np.where(ok, dist, -np.inf), axis=-1), 0.0)
    return near.astype(np.float32), far.astype(np.float32), mask
