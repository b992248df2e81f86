"""Stage 3's merge of the background and human sample streams along each
ray (counterpart of `hosnerf_tpu/ops/merge.py`).

Two exact forms: `merge_sorted_streams` (one stable argsort of the joined
depths; the human weights come back through the inverse permutation) and
`sortless_composite`, which needs no sort: the transmittance before a
sample in merged order is the product of its own stream's exclusive
prefix and the other stream's factors in front of it, both sums of log
factors under comparison masks. Ties put background before human, the
order of the stable join [bkg, hum].
"""

from __future__ import annotations

import torch


def z_along_ray(points: torch.Tensor, rays_o: torch.Tensor,
                rays_d: torch.Tensor, thresh: float = 1e-5) -> torch.Tensor:
    """Depth z of world points [R, S, 3] along rays o + z d ([R, 3]):
    per ray the mean of (p - o) / d over the coordinates with |d| > thresh,
    over all three where none has."""
    ratio = (points - rays_o[:, None, :]) / (rays_d[:, None, :] + 1e-10)
    valid = (torch.abs(rays_d) > thresh).to(points.dtype)
    denom = torch.sum(valid, dim=-1)
    all_bad = denom == 0
    w = torch.where(all_bad[:, None], torch.ones_like(valid), valid)
    denom = torch.where(all_bad, 3.0, denom)
    return torch.einsum("rsc,rc->rs", ratio, w) / denom[:, None]


def merge_sorted_streams(z_bkg, out_bkg, z_hum, out_hum, mask_hum):
    """Merge two per-ray sample streams by depth. z_bkg [R, Nb], out_bkg
    [R, Nb, 4] (activated rgb + sigma), z_hum [R, Nh], out_hum [R, Nh, 4],
    mask_hum [R, Nh]. Returns the sorted z, out, mask [R, N, 1] and
    `inv_order` (joined order -> sorted position)."""
    z = torch.cat([z_bkg, z_hum], dim=-1)
    out = torch.cat([out_bkg, out_hum], dim=-2)
    mask = torch.cat([torch.ones_like(z_bkg), mask_hum], dim=-1)
    order = torch.argsort(z, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1, stable=True)
    return {
        "z": torch.gather(z, -1, order),
        "out": torch.gather(out, -2, order[..., None].expand(out.shape)),
        "mask": torch.gather(mask, -1, order)[..., None],
        "inv_order": inv_order,
        "num_bkg": z_bkg.shape[-1],
    }


def sortless_composite(z_bkg, out_bkg, z_hum, out_hum, mask_hum, rays_d):
    """Jointly composite two per-ray sample streams without sorting
    (inputs as `merge_sorted_streams`). Returns (rgb [R, 3], acc [R],
    background weights, human weights, depth [R])."""
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    inf = 1e10

    def stream_dists(z_own, z_other, other_ties_after: bool):
        """Each own sample's interval in merged order: the distance to
        the nearest later sample of either stream (1e10 past the last)."""
        next_own = torch.cat([z_own[..., 1:],
                              torch.full_like(z_own[..., :1], inf)], -1)
        if other_ties_after:
            ahead = z_other[..., None, :] >= z_own[..., :, None]
        else:
            ahead = z_other[..., None, :] > z_own[..., :, None]
        next_other = torch.amin(
            torch.where(ahead, z_other[..., None, :], inf), dim=-1)
        return torch.clamp(torch.minimum(next_own, next_other) - z_own,
                           max=inf)

    dist_b = stream_dists(z_bkg, z_hum, other_ties_after=True)
    dist_h = stream_dists(z_hum, z_bkg, other_ties_after=False)
    alpha_b = 1.0 - torch.exp(-out_bkg[..., 3] * dist_b * norm)
    alpha_h = (1.0 - torch.exp(-out_hum[..., 3] * dist_h * norm)) * mask_hum
    # log(max(1 - alpha, 1e-10)), the reference's + 1e-10 floor at alpha 1
    log_b = torch.log(torch.clamp(1.0 - alpha_b, min=1e-10))
    log_h = torch.log(torch.clamp(1.0 - alpha_h, min=1e-10))

    def excl_prefix(x):
        c = torch.cumsum(x, -1)
        return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)

    before_h_for_b = (z_hum[..., None, :] < z_bkg[..., :, None]).to(
        log_h.dtype)
    before_b_for_h = (z_bkg[..., None, :] <= z_hum[..., :, None]).to(
        log_b.dtype)
    cross_b = torch.einsum("rij,rj->ri", before_h_for_b, log_h)
    cross_h = torch.einsum("rij,rj->ri", before_b_for_h, log_b)
    w_b = alpha_b * torch.exp(excl_prefix(log_b) + cross_b)
    w_h = alpha_h * torch.exp(excl_prefix(log_h) + cross_h)

    rgb = (torch.einsum("ri,ric->rc", w_b, out_bkg[..., :3])
           + torch.einsum("ri,ric->rc", w_h, out_hum[..., :3]))
    acc = torch.sum(w_b, -1) + torch.sum(w_h, -1)
    depth = torch.sum(w_b * z_bkg, -1) + torch.sum(w_h * z_hum, -1)
    return rgb, acc, w_b, w_h, depth


def extract_human_weights(weights_sorted: torch.Tensor,
                          merged: dict) -> torch.Tensor:
    """Compositing weights in sorted order -> the human samples' weights in
    their own order."""
    w_concat = torch.gather(weights_sorted, -1, merged["inv_order"])
    return w_concat[..., merged["num_bkg"]:]
