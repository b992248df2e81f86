"""The dynamic human-object field's training forward in plain PyTorch, on
a dict of parameters named as the port's `HumanObjectField.state_dict()`:
a functional copy of the port's dense plain path (`models/human.py::
_samples_dense` with the gather-form LBS of `ops/lbs.py` and the module
MLPs of `models/human_components.py`), every sample through every stage.
The pose refiner, the weight-volume decoder, inverse LBS, the non-rigid
and canonical trunks and forward LBS are all worked out here from the
weights and the batch; nothing is taken from the program."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from hosbench.reference import render
from hosbench.reference.precision import F32, Precision

COND, POSE_EMBED = 75, 75
CNL_MULTIRES, NR_MULTIRES = 10, 6
NR_KICK_IN, NR_FULL_BAND = 10_000, 50_000


# --- skeleton math (the port's core/body.py) --------------------------------

SMPL_PARENT = {
    1: 0, 2: 0, 3: 0, 4: 1, 5: 2, 6: 3, 7: 4, 8: 5, 9: 6, 10: 7,
    11: 8, 12: 9, 13: 9, 14: 9, 15: 12, 16: 13, 17: 14, 18: 16, 19: 17,
    20: 18, 21: 19, 22: 20, 23: 21, 24: 23, 25: 22,
}


def parents(total: int) -> np.ndarray:
    out = np.zeros(total, dtype=np.int32)
    for child, parent in SMPL_PARENT.items():
        if child < total:
            out[child] = parent
    return out


def rodrigues(rvec):
    theta = torch.sqrt(1e-5 + torch.sum(rvec ** 2, dim=-1))
    r = rvec / theta[..., None]
    cos, sin = torch.cos(theta), torch.sin(theta)
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    one_c = 1.0 - cos
    rows = [rx * rx + (1.0 - rx * rx) * cos, rx * ry * one_c - rz * sin,
            rx * rz * one_c + ry * sin, rx * ry * one_c + rz * sin,
            ry * ry + (1.0 - ry * ry) * cos, ry * rz * one_c - rx * sin,
            rx * rz * one_c - ry * sin, ry * rz * one_c + rx * sin,
            rz * rz + (1.0 - rz * rz) * cos]
    return torch.stack(rows, -1).reshape(rvec.shape[:-1] + (3, 3))


def _bottom(like):
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=like.dtype,
                       device=like.device)
    return row.expand(like.shape[:-2] + (1, 4))


def construct_G(R, T):
    return torch.cat([torch.cat([R, T[..., :, None]], -1), _bottom(R)], -2)


def affine_inverse(G):
    R, t = G[..., :3, :3], G[..., :3, 3]
    c0, c1, c2 = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    adj = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                       torch.linalg.cross(c0, c1)], -2)
    det = torch.sum(c0 * torch.linalg.cross(c1, c2), -1)[..., None, None]
    rinv = adj / det
    new_t = -torch.einsum("...ij,...j->...i", rinv, t)
    return torch.cat([torch.cat([rinv, new_t[..., :, None]], -1),
                      _bottom(G)], -2)


def motion_bases(dst_Rs, dst_Ts, cnl_gtfms):
    local = construct_G(dst_Rs, dst_Ts)
    par = parents(local.shape[-3])
    g = [local[0]]
    for i in range(1, local.shape[-3]):
        g.append(g[par[i]] @ local[i])
    dst_gtfms = torch.stack(g, -3)
    f_mtx = cnl_gtfms @ affine_inverse(dst_gtfms)
    f_fwd = dst_gtfms @ affine_inverse(cnl_gtfms)
    return f_mtx[..., :3, :3], f_mtx[..., :3, 3], f_fwd[..., :3, :3], \
        f_fwd[..., :3, 3]


# --- embedders ----------------------------------------------------------------

def fourier_embed(x, multires: int):
    scaled = x[..., None, :] * (2.0 ** torch.arange(
        multires, dtype=x.dtype, device=x.device))[:, None]
    both = torch.stack([torch.sin(scaled), torch.cos(scaled)], -2)
    return torch.cat([x, both.reshape(x.shape[:-1] + (-1,))], -1)


def hann_alpha(iter_val: float) -> float:
    t = max(float(iter_val) - NR_KICK_IN, 0.0)
    return NR_MULTIRES * t / (NR_FULL_BAND - NR_KICK_IN)


def hannw_fourier_embed(x, alpha: float):
    j = torch.arange(NR_MULTIRES, dtype=x.dtype, device=x.device)
    w = (1.0 - torch.cos(math.pi * torch.clamp(alpha - j, 0.0, 1.0))) / 2.0
    scaled = x[..., None, :] * (2.0 ** j)[:, None]
    both = torch.stack([torch.sin(scaled), torch.cos(scaled)],
                       -2) * w[:, None, None]
    return both.reshape(x.shape[:-1] + (-1,))


# --- component networks ---------------------------------------------------------

def _lin(p, name, x, prec: Precision = None):
    if prec is None:
        return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])
    return prec.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def pose_refiner(p, posevec, refined: int):
    h = posevec
    for i in range(3):
        h = torch.relu(_lin(p, f"pose_decoder.block_mlps.{2 * i}", h))
    out = {}
    for key in ("dstR", "dstT"):
        t = torch.relu(_lin(p, f"pose_decoder.block_mlps_{key}.0", h))
        out[key] = _lin(p, f"pose_decoder.block_mlps_{key}.2", t).reshape(
            refined, 3)
    return rodrigues(out["dstR"]), out["dstT"]


def refine_pose(p, dst_Rs, dst_Ts, posevec):
    Rs, Ts = pose_refiner(p, posevec, dst_Rs.shape[0] - 1)
    return (torch.cat([dst_Rs[:1], dst_Rs[1:] @ Rs]),
            torch.cat([dst_Ts[:1], dst_Ts[1:] + Ts]))


def weight_volume(p, priors, prec: Precision):
    """softmax(decoder(constant) + log(priors)) over the channels."""
    pre = "mweight_vol_decoder.decoder"
    h = F.leaky_relu(_lin(p, f"{pre}.block_mlp.0",
                          p["mweight_vol_decoder.const_embedding"][None]),
                     0.2)
    h = h.reshape(1, 1024, 1, 1, 1)
    n_conv = 1 + max(int(k.split(".")[3]) for k in p
                     if k.startswith(f"{pre}.block_conv.")) // 2
    for n in range(n_conv):
        h = prec.conv_transpose3d(h, p[f"{pre}.block_conv.{2 * n}.weight"],
                                  p[f"{pre}.block_conv.{2 * n}.bias"])
        if n < n_conv - 1:
            h = F.leaky_relu(h, 0.2)
    return torch.softmax(h[0] + torch.log(priors), dim=0)


def nonrigid_mlp(p, name, depth, embed, pts, cond, prec: Precision):
    h = torch.cat([cond, embed], -1)
    for i in range(depth):
        if i == 4:
            h = torch.cat([h, embed], -1)
        h = torch.relu(_lin(p, f"{name}.block_mlps.{2 * i}", h, prec))
    return pts + _lin(p, f"{name}.block_mlps.{2 * depth}", h)


def canonical_mlp(p, depth, x, prec: Precision):
    h = x
    for i in range(depth):
        if i == 5:
            h = torch.cat([x, h], -1)
        h = torch.relu(_lin(p, f"cnl_mlp.pts_linears.{2 * i}", h, prec))
    return _lin(p, "cnl_mlp.output_linear.0", h)


# --- linear blend skinning (gather form) ------------------------------------------

def corner_taps(coords, D, H, W):
    """(linear voxel index, weight) of the 8 trilinear corners of coords
    [..., 3] (x indexes W, y H, z D; [-1, 1] corner-aligned), zero weight
    off the grid."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    fx, fy, fz = ((x + 1.0) * 0.5 * (W - 1), (y + 1.0) * 0.5 * (H - 1),
                  (z + 1.0) * 0.5 * (D - 1))
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    tx, ty, tz = fx - x0, fy - y0, fz - z0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                cx, cy, cz = x0 + dx, y0 + dy, z0 + dz
                w = ((tx if dx else 1.0 - tx) * (ty if dy else 1.0 - ty)
                     * (tz if dz else 1.0 - tz))
                valid = ((cx >= 0) & (cx <= W - 1) & (cy >= 0)
                         & (cy <= H - 1) & (cz >= 0) & (cz <= D - 1))
                yield ((cz.clamp(0, D - 1).long() * H
                        + cy.clamp(0, H - 1).long()) * W
                       + cx.clamp(0, W - 1).long()), w * valid


def sample_bones(flat, coords, D, H, W):
    """Each bone's channel of the volume (flat [B, D*H*W]) at its own
    points coords [B, N, 3] (or [N, 3], shared): weights [B, N]. The
    lookups are `torch.gather`s, whose backward scatters with adds."""
    B = flat.shape[0]
    out = None
    for lin, w in corner_taps(coords, D, H, W):
        idx = lin.expand(B, lin.shape[-1]) if lin.ndim == 1 else lin
        c = w * torch.gather(flat, 1, idx)
        out = c if out is None else out + c
    return out


def normalize(pos, bmin, bscale):
    return (pos - bmin) * bscale - 1.0


def inverse_lbs(pts, m_sR, m_T, vol, bmin, bscale):
    """(x_skel [N, 3], fg [N, 1]): every bone's inverse transform of
    every point, its weight there, blended."""
    B = vol.shape[0] - 1
    D, H, W = vol.shape[1:]
    pos = torch.einsum("bij,nj->bni", m_sR, pts) + m_T[:, None, :]
    w = sample_bones(vol[:B].reshape(B, -1), normalize(pos, bmin, bscale),
                     D, H, W)
    wsum, acc = w[0], w[0][:, None] * pos[0]
    for b in range(1, B):            # bone by bone, the port's order
        wsum = wsum + w[b]
        acc = acc + w[b][:, None] * pos[b]
    return acc / torch.clamp(wsum, min=1e-4)[:, None], wsum[:, None]


def forward_lbs_multi(pts, sR_fwd, T_fwd, vol, bmin, bscale):
    """K transform sets at shared points: x_deform [K, N, 3]."""
    B = vol.shape[0] - 1
    D, H, W = vol.shape[1:]
    w = sample_bones(vol[:B].reshape(B, -1), normalize(pts, bmin, bscale),
                     D, H, W).T
    wsum = torch.sum(w, 1)
    acc = (torch.einsum("nb,kbij,nj->kni", w, sR_fwd, pts)
           + torch.einsum("nb,kbi->kni", w, T_fwd))
    return acc / torch.clamp(wsum, min=1e-4)[None, :, None]


# --- the field --------------------------------------------------------------------

def human_forward(p: Dict[str, torch.Tensor], batch, iter_val, state_idx,
                  generator, *, n_samples: int = 128, num_states: int = 1,
                  cnl_depth: int = 8, nr_depth: int = 6,
                  prec: Precision = F32) -> Dict[str, torch.Tensor]:
    """The training forward (is_train, perturb 1 with the generator's
    draws): the outputs stage 3's composite and losses read."""
    R, S = batch["rays_o"].shape[0], n_samples
    bmin, bscale = batch["cnl_bbox_min_xyz"], batch["cnl_bbox_scale_xyz"]
    dst_Rs, dst_Ts = refine_pose(p, batch["dst_Rs"], batch["dst_Ts"],
                                 batch["dst_posevec"][:POSE_EMBED])
    m_sR, m_T, m_sR_fwd, m_T_fwd = motion_bases(dst_Rs, dst_Ts,
                                                batch["cnl_gtfms"])
    vol = weight_volume(p, batch["motion_weights_priors"], prec)
    vol_taps = prec.operand(vol)
    on = float(iter_val >= NR_KICK_IN)
    cond = batch["dst_posevec"][None, :COND] * on
    alpha = hann_alpha(iter_val)
    t_vals = torch.linspace(0.0, 1.0, S, device=batch["rays_o"].device,
                            dtype=batch["rays_o"].dtype)
    z = batch["near"] * (1.0 - t_vals)[None] + batch["far"] * t_vals[None]
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    u = torch.rand(z.shape, generator=generator, device=generator.device,
                   dtype=z.dtype)
    z = lower + (upper - lower) * u.to(z.device)
    pts = batch["rays_o"][:, None, :] + batch["rays_d"][:, None, :] * \
        z[..., None]
    pts_flat = pts.reshape(-1, 3)
    n = pts_flat.shape[0]
    embed = torch.stack([p[f"human_stateembeds.{k}"]
                         for k in range(num_states)])[
        torch.as_tensor(state_idx, device=pts.device).long()]

    x_skel, fg = inverse_lbs(pts_flat, m_sR, m_T, vol_taps, bmin, bscale)
    cnl_pts = nonrigid_mlp(p, "non_rigid_mlp", nr_depth,
                           hannw_fourier_embed(x_skel, alpha), x_skel,
                           cond.expand(n, COND), prec)
    xyz = fourier_embed(cnl_pts, CNL_MULTIRES)
    raw = canonical_mlp(p, cnl_depth, torch.cat(
        [xyz, embed.expand(n, embed.shape[-1])], -1), prec).reshape(R, S, 4)

    p_Rs, p_Ts = refine_pose(p, batch["dst_Rs_prev"], batch["dst_Ts_prev"],
                             batch["dst_posevec_prev"][:POSE_EMBED])
    _, _, p_sR_fwd, p_T_fwd = motion_bases(p_Rs, p_Ts, batch["cnl_gtfms"])
    cond_prev = batch["dst_posevec_prev"][None, :COND] * on
    deform = forward_lbs_multi(cnl_pts, torch.stack([m_sR_fwd, p_sR_fwd]),
                               torch.stack([m_T_fwd, p_T_fwd]), vol_taps,
                               bmin, bscale).reshape(2 * n, 3)
    deform = nonrigid_mlp(p, "non_rigid_forward_mlp", nr_depth,
                          hannw_fourier_embed(deform, alpha), deform,
                          torch.cat([cond.expand(n, COND),
                                     cond_prev.expand(n, COND)]), prec)
    pts_mask = fg.reshape(R, S, 1)
    rgb, acc, weights, _ = render.raw2outputs(raw, pts_mask, z,
                                              batch["rays_d"],
                                              batch["bgcolor"])
    return {"rgb": rgb, "weights": weights,
            "observe_pts": pts_flat, "deform_pts_final": deform[:n],
            "cycle_mask": (fg[:, 0] > 0.005).float(),
            "deform_pts_prev_final": deform[n:].reshape(R, S, 3),
            "human_rgb": torch.sigmoid(raw[..., :3]),
            "human_density": torch.relu(raw[..., 3]),
            "newsmpl_pts": pts, "pts_mask": pts_mask[..., 0], "z_vals": z}
