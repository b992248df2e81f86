"""Inverse and forward linear blend skinning against a motion weight
volume in plain PyTorch (counterpart of `hosnerf_tpu/ops/lbs.py`).

Two plain forms, as in the JAX package:

* gather (`*_gather`): every sample through every bone with 8 corner
  gathers from the flattened volume;
* one-hot ('xla', the JAX package's name for it): the trilinear lookup
  factorised as xy-bilinear one-hot rows [N, H*W] (4 weighted taps)
  times the bone's volume [H*W, D], then a 2-tap z interpolation. Each
  bone's weights are recomputed in the backward (`torch.utils.checkpoint`
  where JAX takes `jax.checkpoint`), so the [N, H*W] rows are not kept.
  Square xy slices only.

The hand-written Hopper kernels live in `ops/cuda/lbs.py`;
`inverse_warp`, `bone_weights` and `forward_warp_multi` dispatch among
the three by `impl` as the JAX package's `ops/lbs.py:283-374` does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _onehot_taps(coords: torch.Tensor, D: int, H: int, W: int):
    """Factorised trilinear taps: xy-bilinear one-hot rows [N, H*W]
    (4 weighted taps) and z selection rows [N, D] (2 weighted taps), by
    index compares (no gather); out-of-range taps weigh 0, as in
    `_trilinear_taps`."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    fx = (x + 1.0) * 0.5 * (W - 1)
    fy = (y + 1.0) * 0.5 * (H - 1)
    fz = (z + 1.0) * 0.5 * (D - 1)
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    tx, ty, tz = fx - x0, fy - y0, fz - z0

    n = coords.shape[0]
    hw_iota = torch.arange(H * W, device=coords.device)[None, :]
    onehot_xy = torch.zeros((n, H * W), dtype=coords.dtype,
                            device=coords.device)
    for dx in (0, 1):
        for dy in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            w = (tx if dx else 1.0 - tx) * (ty if dy else 1.0 - ty)
            valid = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
            idx = (cy.clamp(0, H - 1).long() * W
                   + cx.clamp(0, W - 1).long())
            onehot_xy = onehot_xy + (w * valid)[:, None] * (
                idx[:, None] == hw_iota)

    d_iota = torch.arange(D, device=coords.device)[None, :]
    zsel = torch.zeros((n, D), dtype=coords.dtype, device=coords.device)
    for dz in (0, 1):
        cz = z0 + dz
        w = tz if dz else 1.0 - tz
        valid = (cz >= 0) & (cz <= D - 1)
        iz = cz.clamp(0, D - 1).long()
        zsel = zsel + (w * valid)[:, None] * (iz[:, None] == d_iota)
    return onehot_xy, zsel


def _bone_weight_onehot_fn(pos_b, vol_b_hw_d, cnl_bbox_min_xyz,
                           cnl_bbox_scale_xyz):
    D = vol_b_hw_d.shape[-1]
    G = int(round(vol_b_hw_d.shape[0] ** 0.5))
    coords = normalize_coords(pos_b, cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    onehot_xy, zsel = _onehot_taps(coords, D, G, G)
    zcols = onehot_xy @ vol_b_hw_d                           # [N, D]
    return torch.sum(zcols * zsel, dim=-1)


def _bone_weight_onehot(pos_b, vol_b_hw_d, cnl_bbox_min_xyz,
                        cnl_bbox_scale_xyz):
    """Trilinear motion weight of ONE bone at [N, 3] points by the one-hot
    product; vol_b_hw_d [H*W, D] (H == W). Recomputed in the backward."""
    return checkpoint(_bone_weight_onehot_fn, pos_b, vol_b_hw_d,
                      cnl_bbox_min_xyz, cnl_bbox_scale_xyz,
                      use_reentrant=False)


def _all_bone_weights_onehot_fn(cnl_pts, vol_hw_d, cnl_bbox_min_xyz,
                                cnl_bbox_scale_xyz):
    D = vol_hw_d.shape[-1]
    G = int(round(vol_hw_d.shape[1] ** 0.5))
    coords = normalize_coords(cnl_pts, cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    onehot_xy, zsel = _onehot_taps(coords, D, G, G)
    return torch.stack([torch.sum((onehot_xy @ vol_hw_d[b]) * zsel, dim=-1)
                        for b in range(vol_hw_d.shape[0])], 0)


def _all_bone_weights_onehot(cnl_pts, vol_hw_d, cnl_bbox_min_xyz,
                             cnl_bbox_scale_xyz):
    """Weights of ALL bones at the same points: one one-hot build, B
    products; vol_hw_d [B, H*W, D] -> [B, N]. Recomputed in the
    backward."""
    return checkpoint(_all_bone_weights_onehot_fn, cnl_pts, vol_hw_d,
                      cnl_bbox_min_xyz, cnl_bbox_scale_xyz,
                      use_reentrant=False)


def _vol_hw_d(motion_weights_vol: torch.Tensor) -> torch.Tensor:
    """The B bone channels as [B, H*W, D]: xy on the contraction axis."""
    B = motion_weights_vol.shape[0] - 1
    D, H, W = motion_weights_vol.shape[1:]
    if H != W:
        raise ValueError("the one-hot LBS form needs square xy slices; "
                         "use the gather form")
    return motion_weights_vol[:B].reshape(B, D, H * W).transpose(1, 2)


def inverse_lbs(pts: torch.Tensor, motion_scale_Rs: torch.Tensor,
                motion_Ts: torch.Tensor, motion_weights_vol: torch.Tensor,
                cnl_bbox_min_xyz: torch.Tensor,
                cnl_bbox_scale_xyz: torch.Tensor):
    """Warp observation points to canonical space, one-hot form: pts
    [N, 3]; motion_scale_Rs [B, 3, 3]; motion_Ts [B, 3];
    motion_weights_vol [B+1, D, H, W] (background channel unused).
    Returns x_skel [N, 3], fg_likelihood_mask [N, 1], weights [B, N]."""
    vol_hw_d = _vol_hw_d(motion_weights_vol)
    wsum = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    acc = torch.zeros_like(pts)
    weights = []
    for b in range(vol_hw_d.shape[0]):
        pos_b = pts @ motion_scale_Rs[b].T + motion_Ts[b]
        w_b = _bone_weight_onehot(pos_b, vol_hw_d[b], cnl_bbox_min_xyz,
                                  cnl_bbox_scale_xyz)
        weights.append(w_b)
        wsum = wsum + w_b
        acc = acc + w_b[:, None] * pos_b

    x_skel = acc / torch.clamp(wsum, min=1e-4)[:, None]
    return x_skel, wsum[:, None], torch.stack(weights, 0)


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


def forward_lbs(cnl_pts: torch.Tensor, motion_scale_Rs_fwd: torch.Tensor,
                motion_Ts_fwd: torch.Tensor,
                motion_weights_vol: torch.Tensor,
                cnl_bbox_min_xyz: torch.Tensor,
                cnl_bbox_scale_xyz: torch.Tensor):
    """Warp canonical points to observation space, one-hot form: the
    weights sampled once at the canonical point for every bone. Returns
    x_deform [N, 3], fg_likelihood_fwd [N, 1]."""
    weights = _all_bone_weights_onehot(cnl_pts,
                                       _vol_hw_d(motion_weights_vol),
                                       cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    return _blend_forward(weights, cnl_pts, motion_scale_Rs_fwd,
                          motion_Ts_fwd)


def forward_lbs_gather(cnl_pts: torch.Tensor,
                       motion_scale_Rs_fwd: torch.Tensor,
                       motion_Ts_fwd: torch.Tensor,
                       motion_weights_vol: torch.Tensor,
                       cnl_bbox_min_xyz: torch.Tensor,
                       cnl_bbox_scale_xyz: torch.Tensor):
    """`forward_lbs` in the gather form (any volume shape)."""
    B = motion_weights_vol.shape[0] - 1
    D, H, W = motion_weights_vol.shape[1:]
    vol_flat = motion_weights_vol.reshape(B + 1, -1)
    coords = normalize_coords(cnl_pts, cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    taps = _trilinear_taps(coords, D, H, W)
    weights = [_sample_channel(vol_flat[b], taps) for b in range(B)]
    return _blend_forward(weights, cnl_pts, motion_scale_Rs_fwd,
                          motion_Ts_fwd)


def _blend_forward(weights, cnl_pts, motion_scale_Rs_fwd, motion_Ts_fwd):
    """Bone by bone: sum_b w_b (R_b x + T_b) / max(sum_b w_b, 1e-4), with
    the weights [B][N]; (x_deform [N, 3], wsum [N, 1])."""
    wsum = torch.zeros(cnl_pts.shape[0], dtype=cnl_pts.dtype,
                       device=cnl_pts.device)
    acc = torch.zeros_like(cnl_pts)
    for b in range(len(weights)):
        pos_b = cnl_pts @ motion_scale_Rs_fwd[b].T + motion_Ts_fwd[b]
        wsum = wsum + weights[b]
        acc = acc + weights[b][:, None] * pos_b
    x_deform = acc / torch.clamp(wsum, min=1e-4)[:, None]
    return x_deform, wsum[:, None]


def resolve_impl(impl: str, motion_weights_vol: torch.Tensor,
                 pts: torch.Tensor) -> str:
    """'auto' -> 'pallas' (the hand-written kernels, the name kept from the
    JAX package) for points on a CUDA device and a cubic power-of-two
    volume; 'gather' otherwise (the JAX package's 'auto' takes the one-hot
    'xla' form only for other volumes on a TPU; the port takes it only
    when asked)."""
    if impl != "auto":
        return impl
    D, H, W = motion_weights_vol.shape[1:]
    if pts.is_cuda and D == H == W and D & (D - 1) == 0 and D <= 128:
        return "pallas"
    return "gather"


def inverse_warp(pts, motion_scale_Rs, motion_Ts, motion_weights_vol,
                 cnl_bbox_min_xyz, cnl_bbox_scale_xyz, impl: str = "auto",
                 pg_impl: str = "quad", pg_sort: str = "sig"):
    """Inverse LBS returning (x_skel [N, 3], fg_likelihood_mask [N, 1]).
    impl: 'pallas' (the pair-grid core named by pg_impl: 'quad', in the
    row order of pg_sort, 'win' or 'bp'), 'pallas_dense' (the dense
    core), both with bf16 taps through
    the inverse-LBS kernels of ops/cuda/lbs.py; 'xla' (the one-hot
    form); 'gather'; or 'auto'."""
    impl = resolve_impl(impl, motion_weights_vol, pts)
    if impl in ("pallas", "pallas_dense"):
        from hosnerf_tpu_torch.ops.cuda import lbs as cuda_lbs
        return cuda_lbs.inverse_lbs(pts, motion_scale_Rs, motion_Ts,
                                    motion_weights_vol, cnl_bbox_min_xyz,
                                    cnl_bbox_scale_xyz,
                                    pair_grid=impl == "pallas",
                                    pg_impl=pg_impl, pg_sort=pg_sort)
    if impl not in ("xla", "gather"):
        raise ValueError(f"unknown inverse-LBS impl {impl!r}")
    fn = inverse_lbs if impl == "xla" else inverse_lbs_gather
    x_skel, fg, _ = fn(pts, motion_scale_Rs, motion_Ts, motion_weights_vol,
                       cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    return x_skel, fg


def bone_weights(pts, motion_weights_vol, cnl_bbox_min_xyz,
                 cnl_bbox_scale_xyz, impl: str = "auto") -> torch.Tensor:
    """All-bone trilinear weights at shared points -> [N, B] (the
    forward-LBS sampling pattern: every channel at the same point).
    impl 'pallas' runs the all-bone weights kernels of ops/cuda/lbs.py in
    bf16, 'xla' the one-hot form (square xy slices); every other impl,
    and 'xla' on other volumes, the gather form."""
    impl = resolve_impl(impl, motion_weights_vol, pts)
    if impl == "pallas":
        from hosnerf_tpu_torch.ops.cuda import lbs as cuda_lbs
        return cuda_lbs.bone_weights(pts, motion_weights_vol,
                                     cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    B = motion_weights_vol.shape[0] - 1
    D, H, W = motion_weights_vol.shape[1:]
    if impl == "xla" and H == W:
        return _all_bone_weights_onehot(pts, _vol_hw_d(motion_weights_vol),
                                        cnl_bbox_min_xyz,
                                        cnl_bbox_scale_xyz).T
    vol_flat = motion_weights_vol.reshape(B + 1, -1)
    coords = normalize_coords(pts, cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    taps = _trilinear_taps(coords, D, H, W)
    return torch.stack([_sample_channel(vol_flat[b], taps)
                        for b in range(B)], dim=1)


def apply_forward_lbs(weights, pts, motion_scale_Rs_fwd, motion_Ts_fwd):
    """Blend per-bone forward transforms [B, 3, 3], [B, 3] with weights
    [N, B] from `bone_weights`: (x_deform [N, 3], wsum [N, 1]), the math
    of `forward_lbs` given the same weights."""
    wsum = torch.sum(weights, dim=1)
    acc = (torch.einsum("nb,bij,nj->ni", weights, motion_scale_Rs_fwd, pts)
           + weights @ motion_Ts_fwd)
    x_deform = acc / torch.clamp(wsum, min=1e-4)[:, None]
    return x_deform, wsum[:, None]


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
    for CPU tensors); otherwise `bone_weights(impl=impl)` ('xla': the
    one-hot weights) + `apply_forward_lbs_multi`, as the JAX package
    dispatches (its 'pallas_dense' takes the gather weights here); 'auto'
    resolves first."""
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
