"""Stage-1 scene ray generation, host-side numpy (a copy of
`hosnerf_tpu/data/rays.py`, which imports only numpy)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def convert_to_ndc(origins, directions, ndc_coeffs, near: float = 1.0):
    """Shift rays to the near plane and map to NDC."""
    t = (near - origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions

    dx, dy, dz = directions[:, 0], directions[:, 1], directions[:, 2]
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    o = np.stack([ndc_coeffs[0] * (ox / oz), ndc_coeffs[1] * (oy / oz),
                  1 - 2 * near / oz], -1)
    d = np.stack([ndc_coeffs[0] * (dx / dz - ox / oz),
                  ndc_coeffs[1] * (dy / dz - oy / oz),
                  2 * near / oz], -1)
    return o, d


def image_rays(intrinsic: np.ndarray, extrinsic: np.ndarray, h: int, w: int,
               use_pixel_centers: bool = True):
    """Rays for ONE image: returns rays_o/rays_d/viewdirs [H*W, 3] and mip
    radii [H*W, 1] (ref: ray_utils.py:34-139, de-batched; radii from
    vertical neighbor dir differences * 2/sqrt(12))."""
    center = 0.5 if use_pixel_centers else 0.0
    i, j = np.meshgrid(np.arange(w, dtype=np.float32) + center,
                       np.arange(h, dtype=np.float32) + center,
                       indexing="xy")
    dirs = np.stack([
        (i - intrinsic[0][2]) / intrinsic[0][0],
        (j - intrinsic[1][2]) / intrinsic[1][1],
        np.ones_like(i),
    ], -1)
    rays_d_grid = np.einsum("hwc,rc->hwr", dirs, extrinsic[:3, :3])

    dx = np.sqrt(np.sum((rays_d_grid[:-1] - rays_d_grid[1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1, :]], 0)
    radii = (dx * 2 / np.sqrt(12)).reshape(-1, 1).astype(np.float32)

    rays_d = rays_d_grid.reshape(-1, 3).astype(np.float32)
    rays_o = np.broadcast_to(
        extrinsic[:3, 3], rays_d.shape).astype(np.float32)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return rays_o, rays_d, viewdirs.astype(np.float32), radii


def pixel_rays(intrinsic: np.ndarray, extrinsic: np.ndarray, h: int, w: int,
               sel: np.ndarray, use_pixel_centers: bool = True):
    """Rays for SELECTED flat pixel indices of one image — value-identical
    to `image_rays(...)[k][sel]` without building the full H*W grid (the
    pooled train samplers touch every train image each batch; full grids
    would thrash any cache). Radii reproduce `image_rays`' exact row
    semantics: row r uses the (r, r+1) vertical neighbor difference for
    r <= h-2, and row h-1 reuses row h-3's value (the appended `dx[-2:-1]`
    row of the grid form, itself mirroring the reference's ray_utils.py
    radii construction)."""
    center = 0.5 if use_pixel_centers else 0.0
    sel = np.asarray(sel)
    r = sel // w
    c = sel % w
    i = c.astype(np.float32) + center
    fx, fy = intrinsic[0][0], intrinsic[1][1]
    cx, cy = intrinsic[0][2], intrinsic[1][2]
    rot = np.asarray(extrinsic[:3, :3], np.float64)

    def dirs_at(jv):
        d = np.stack([(i - cx) / fx, (jv - cy) / fy, np.ones_like(i)], -1)
        return d @ rot.T

    rays_d = dirs_at(r.astype(np.float32) + center)
    rb = np.where(r == h - 1, h - 3, r)
    rb = np.clip(rb, 0, max(h - 2, 0)).astype(np.float32)
    dvert = dirs_at(rb + center) - dirs_at(rb + 1.0 + center)
    dx = np.sqrt(np.sum(dvert ** 2, -1))
    radii = (dx * 2 / np.sqrt(12)).reshape(-1, 1).astype(np.float32)

    rays_d = rays_d.astype(np.float32)
    rays_o = np.broadcast_to(
        np.asarray(extrinsic[:3, 3], np.float32), rays_d.shape).copy()
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return rays_o, rays_d, viewdirs.astype(np.float32), radii


def batched_image_rays(intrinsics, extrinsics, image_sizes):
    """Rays for a list of images, concatenated (ref: batchified_get_rays)."""
    parts = [image_rays(K, E, h, w)
             for K, E, (h, w) in zip(intrinsics, extrinsics, image_sizes)]
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))
