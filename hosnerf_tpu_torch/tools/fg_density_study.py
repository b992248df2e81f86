"""Sample liveness on production-shaped batches (counterpart of
`tools/fg_density_study.py`): the fraction of samples and of row blocks
that the liveness-sorted path (models/human.py::_samples_sorted) must
compute.

    python -m hosnerf_tpu_torch.tools.fg_density_study [--n_patches 2] \\
        [--device cpu]

The human field of `Stage3Config(n_patches)` (weights from seed 0, f32
trunks) on `composed_batch(n_patches, 32, grid_size=32)` at iter 100,
is_train, no jitter. Prints:
  fg_alive    fraction of samples with fg_mask > 0.005 (what the cycle
              mask keeps) and > 0;
  inv_alive   fraction of samples inside any bone's inverse-LBS tap
              support (the rest are dead rows); pair density: of
              (sample, bone) pairs;
  tile_alive  on the port's sorted domain (`ops/cuda/lbs.py::bp_prepare`:
              support test, signature sort, dead prefix): the fraction of
              T-row tiles holding an inv-alive sample, T = 64, 128, 256
              and the kernels' block of INV_TILE rows, and the sorted
              domain's live fraction (1 - dead prefix / rows), the share
              of B2/B3/B5's rows that the k0 skip leaves;
  fwd in-grid fraction of the canonical points (the forward LBS's
              inputs) inside the weight volume.
"""

from __future__ import annotations

import argparse

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

EPS = 1e-5
TILES = (64, 128, 256)


@torch.no_grad()
def study(n_patches: int, device, patch_size: int = 32,
          small: bool = False) -> dict:
    """{statistic: fraction} of the batch's samples (see the module)."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    from hosnerf_tpu_torch.train import stage3
    cfg = common.stage3_config(n_patches, patch_size, small,
                               compute_dtype=None)
    batch = common.stage3_batch(cfg, device)
    _, human = stage3.make_models(cfg, seed=0, device=device)
    out = human(batch, 100.0, 0, is_train=True, perturb=0.0)
    fg = out["pts_mask"].reshape(-1)
    G, B = cfg.mweight_volume_size, cfg.total_bones
    si = human.sample_inputs(batch, 100.0)
    s, o, rg, tg, _ = clbs.grid_tables(
        si["m_sR"], si["m_T"], si["vol"], batch["cnl_bbox_min_xyz"],
        batch["cnl_bbox_scale_xyz"])
    pts = si["pts_flat"].float()
    sup = torch.cat([clbs._sample_support(p, rg, tg, G)
                     for p in pts.split(1 << 18)])
    inv_alive = sup.any(dim=1)
    dom = clbs.bp_prepare(pts, rg, tg, G, B)
    alive_s = dom.sort_rows(inv_alive[:, None])[:, 0]
    res = {"samples": float(fg.numel()),
           "fg_alive (>0.005)": float((fg > 0.005).float().mean()),
           "fg_alive (>0)": float((fg > 0).float().mean()),
           "inv_alive (any bone)": float(inv_alive.float().mean()),
           "pair density (true)": float(sup.float().mean())}
    for T in TILES + (clbs.INV_TILE,):
        n_t = -(-alive_s.shape[0] // T) * T
        a = torch.cat([alive_s, alive_s.new_zeros(n_t - alive_s.shape[0])])
        res[f"tile_alive @T={T}"] = float(
            a.reshape(-1, T).any(dim=1).float().mean())
    res["sorted domain live fraction"] = 1.0 - float(
        dom.n_dead_groups) * clbs.SORT_GROUP / dom.n_pad
    cnl = out["cnl_pts"].reshape(-1, 3)
    f = cnl * s[None] + o[None]
    res["fwd in-grid"] = float(((f > -1 - EPS) & (f < G + EPS)).all(
        dim=1).float().mean())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=2)
    ap.add_argument("--patch_size", type=int, default=32)
    ap.add_argument("--small", action="store_true",
                    help="test-only: tiny widths (tools/common.py::SMALL)")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    print(f"device: {common.device_record(device)}", flush=True)
    for k, v in study(args.n_patches, device, args.patch_size,
                      args.small).items():
        print(f"{k:28s} {v:.0f}" if k == "samples" else f"{k:28s} {v:.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
