"""Inverse and forward linear blend skinning against a motion weight
volume, gather form (counterpart of the gather pieces of
`hosnerf_tpu/ops/lbs.py`).

The gather forms take every sample through every bone with 8 corner
gathers. The hand-written Hopper kernels live in `ops/cuda/lbs.py`;
`inverse_warp`, `bone_weights` and `forward_warp_multi` dispatch between
the two by `impl` as the JAX package's `ops/lbs.py:283-374` does.
"""

from __future__ import annotations

import torch

from hosnerf_tpu_torch.ops.grid_sample import _corner_taps


def normalize_coords(pos: torch.Tensor, cnl_bbox_min_xyz: torch.Tensor,
                     cnl_bbox_scale_xyz: torch.Tensor) -> torch.Tensor:
    """World -> [-1, 1] volume coords."""
    return (pos - cnl_bbox_min_xyz) * cnl_bbox_scale_xyz - 1.0


def _trilinear_taps(coords: torch.Tensor, D: int, H: int, W: int):
    """Per-corner (lin_index [N], weight [N]) pairs for the 8 corners,
    zeros padding masked."""
    return list(_corner_taps(coords, D, H, W))


def _sample_channel(vol_flat_b: torch.Tensor, taps) -> torch.Tensor:
    out = None
    for lin, w in taps:
        contrib = w * vol_flat_b[lin]
        out = contrib if out is None else out + contrib
    return out


def inverse_lbs_gather(pts: torch.Tensor, motion_scale_Rs: torch.Tensor,
                       motion_Ts: torch.Tensor,
                       motion_weights_vol: torch.Tensor,
                       cnl_bbox_min_xyz: torch.Tensor,
                       cnl_bbox_scale_xyz: torch.Tensor):
    """Warp observation points to canonical space.
    pts [N, 3]; motion_scale_Rs [B, 3, 3]; motion_Ts [B, 3];
    motion_weights_vol [B+1, D, H, W] (background channel unused).
    Returns x_skel [N, 3], fg_likelihood_mask [N, 1], weights [B, N]."""
    B = motion_weights_vol.shape[0] - 1
    D, H, W = motion_weights_vol.shape[1:]
    vol_flat = motion_weights_vol.reshape(B + 1, -1)

    wsum = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    acc = torch.zeros_like(pts)
    weights = []
    for b in range(B):
        pos_b = pts @ motion_scale_Rs[b].T + motion_Ts[b]
        coords_b = normalize_coords(pos_b, cnl_bbox_min_xyz,
                                    cnl_bbox_scale_xyz)
        w_b = _sample_channel(vol_flat[b], _trilinear_taps(coords_b, D, H, W))
        weights.append(w_b)
        wsum = wsum + w_b
        acc = acc + w_b[:, None] * pos_b

    x_skel = acc / torch.clamp(wsum, min=1e-4)[:, None]
    return x_skel, wsum[:, None], torch.stack(weights, 0)


def resolve_impl(impl: str, motion_weights_vol: torch.Tensor,
                 pts: torch.Tensor) -> str:
    """'auto' -> 'pallas' (the hand-written kernels, the name kept from the
    JAX package) for points on a CUDA device and a cubic power-of-two
    volume; 'gather' otherwise (where the JAX package takes its XLA one-hot
    form on a TPU, which the port does not have)."""
    if impl != "auto":
        return impl
    D, H, W = motion_weights_vol.shape[1:]
    if pts.is_cuda and D == H == W and D & (D - 1) == 0 and D <= 128:
        return "pallas"
    return "gather"


def inverse_warp(pts, motion_scale_Rs, motion_Ts, motion_weights_vol,
                 cnl_bbox_min_xyz, cnl_bbox_scale_xyz, impl: str = "auto",
                 pg_impl: str = "quad"):
    """Inverse LBS returning (x_skel [N, 3], fg_likelihood_mask [N, 1]).
    impl: 'pallas' (the pair-grid core named by pg_impl: 'quad', 'win' or
    'bp'), 'pallas_dense' (the dense core), both with bf16 taps through
    the inverse-LBS kernels of ops/cuda/lbs.py; 'gather'; or 'auto'."""
    impl = resolve_impl(impl, motion_weights_vol, pts)
    if impl in ("pallas", "pallas_dense"):
        from hosnerf_tpu_torch.ops.cuda import lbs as cuda_lbs
        return cuda_lbs.inverse_lbs(pts, motion_scale_Rs, motion_Ts,
                                    motion_weights_vol, cnl_bbox_min_xyz,
                                    cnl_bbox_scale_xyz,
                                    pair_grid=impl == "pallas",
                                    pg_impl=pg_impl)
    if impl != "gather":
        raise ValueError(f"unknown inverse-LBS impl {impl!r}")
    x_skel, fg, _ = inverse_lbs_gather(pts, motion_scale_Rs, motion_Ts,
                                       motion_weights_vol, cnl_bbox_min_xyz,
                                       cnl_bbox_scale_xyz)
    return x_skel, fg


def bone_weights(pts, motion_weights_vol, cnl_bbox_min_xyz,
                 cnl_bbox_scale_xyz, impl: str = "auto") -> torch.Tensor:
    """All-bone trilinear weights at shared points -> [N, B] (the
    forward-LBS sampling pattern: every channel at the same point).
    impl 'pallas' runs the all-bone weights kernels of ops/cuda/lbs.py in
    bf16; every other impl the gather form."""
    impl = resolve_impl(impl, motion_weights_vol, pts)
    if impl == "pallas":
        from hosnerf_tpu_torch.ops.cuda import lbs as cuda_lbs
        return cuda_lbs.bone_weights(pts, motion_weights_vol,
                                     cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    B = motion_weights_vol.shape[0] - 1
    D, H, W = motion_weights_vol.shape[1:]
    vol_flat = motion_weights_vol.reshape(B + 1, -1)
    coords = normalize_coords(pts, cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    taps = _trilinear_taps(coords, D, H, W)
    return torch.stack([_sample_channel(vol_flat[b], taps)
                        for b in range(B)], dim=1)


def apply_forward_lbs_multi(weights, pts, motion_scale_Rs_fwd,
                            motion_Ts_fwd):
    """Blend K stacked forward transform sets ([K, B, 3, 3], [K, B, 3])
    with shared weights [N, B] at shared points [N, 3]: (x_deform
    [K, N, 3], wsum [N, 1])."""
    wsum = torch.sum(weights, dim=1)
    acc = (torch.einsum("nb,kbij,nj->kni", weights, motion_scale_Rs_fwd, pts)
           + torch.einsum("nb,kbi->kni", weights, motion_Ts_fwd))
    x_deform = acc / torch.clamp(wsum, min=1e-4)[None, :, None]
    return x_deform, wsum[:, None]


def forward_warp_multi(pts, motion_scale_Rs_fwd, motion_Ts_fwd,
                       motion_weights_vol, cnl_bbox_min_xyz,
                       cnl_bbox_scale_xyz, impl: str = "auto"):
    """Forward LBS for K transform sets at shared canonical points:
    (x_deform [K, N, 3], wsum [N, 1]). impl: 'pallas' (the fused
    forward-LBS kernel of ops/cuda/lbs.py in bf16, or its plain version
    for CPU tensors); otherwise `bone_weights(impl=impl)` +
    `apply_forward_lbs_multi`, as the JAX package dispatches (its
    'pallas_dense' takes the gather weights here); 'auto' resolves
    first."""
    impl = resolve_impl(impl, motion_weights_vol, pts)
    if impl == "pallas":
        from hosnerf_tpu_torch.ops.cuda import lbs as cuda_lbs
        return cuda_lbs.forward_lbs_multi(
            pts, motion_scale_Rs_fwd, motion_Ts_fwd, motion_weights_vol,
            cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    w = bone_weights(pts, motion_weights_vol, cnl_bbox_min_xyz,
                     cnl_bbox_scale_xyz, impl=impl)
    return apply_forward_lbs_multi(w, pts, motion_scale_Rs_fwd,
                                   motion_Ts_fwd)
