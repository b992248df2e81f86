"""Grid-coordinate ranges per alive (tile, bone) pair under the 'sig' and
'sigmorton' sample orders (counterpart of `tools/pg_window_study.py`):
whether a windowed pair-grid kernel's x and z windows of W cells would
cover every supported tap. Counting only (`tools/pair_count.py`).

    python -m hosnerf_tpu_torch.tools.pg_window_study [--n_patches 2] \\
        [--device cpu]

For each alive pair, the range of floor(f) over the tile's supported
samples (f the bone's grid coordinate, floors clipped to [-1, G]) must be
at most W - 2. Prints per order the alive pairs and their density, for
W = 8, 16, 24 the share of pairs whose fx, fy, fz and both fx and fz
ranges fit, and the mean ranges.
"""

from __future__ import annotations

import argparse

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.tools import pair_count as pc
from hosnerf_tpu_torch.utils import card

G = 32
WINDOWS = (8, 16, 24)
ORDERS = ("sig", "sigmorton")


@torch.no_grad()
def study(n_patches: int, device, patch_size: int = 32) -> dict:
    """{order: {'alive': pairs, 'density': alive share of (tile, bone),
    W: (fx, fy, fz, fx & fz fit shares), 'mean': (fx, fy, fz) mean
    ranges}}; padding rows support nothing, as in the JAX script."""
    pts, rg, tg, _ = pc.production_points(n_patches, device, patch_size, G)
    B = rg.shape[0]
    pts_p, n = pc.pad_rows(pts, pc.TILE_PG)
    sup = clbs._sample_support(pts_p, rg, tg, G)
    sup[n:] = False
    orders = pc.group_orders(pc.group_keys(pts_p, sup), B)
    R3 = rg.reshape(B, 3, 3)
    out = {}
    for name in ORDERS:
        rows = pc.rows_of(orders[name])
        pts_s, sup_s = pts_p[rows], sup[rows]
        f = torch.einsum("nk,bck->nbc", pts_s, R3) + tg[None]
        fl = torch.clamp(torch.floor(f), -1, G).to(torch.int64)
        tiles_f = fl.reshape(-1, pc.TILE_PG, B, 3)
        tiles_sup = sup_s.reshape(-1, pc.TILE_PG, B)[..., None]
        alive = tiles_sup[..., 0].any(dim=1)
        big = 10 ** 6
        fmin = torch.where(tiles_sup, tiles_f, big).min(dim=1).values
        fmax = torch.where(tiles_sup, tiles_f, -big).max(dim=1).values
        rr = (fmax - fmin)[alive]                     # [n_alive, 3]
        res = {"alive": int(rr.shape[0]),
               "density": float(alive.sum()) / alive.numel()}
        for W in WINDOWS:
            fit = rr <= W - 2
            res[W] = tuple(float(fit[:, c].float().mean()) for c in range(3)) \
                + (float((fit[:, 0] & fit[:, 2]).float().mean()),)
        res["mean"] = tuple(float(rr[:, c].float().mean()) for c in range(3))
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=2)
    ap.add_argument("--patch_size", type=int, default=32)
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    print(f"device: {common.device_record(device)}", flush=True)
    for name, res in study(args.n_patches, device, args.patch_size).items():
        print(f"--- {name}: alive pairs={res['alive']} (density "
              f"{res['density']:.3f})", flush=True)
        for W in WINDOWS:
            fx, fy, fz, both = res[W]
            print(f"  W={W:2d}: fx fits {fx:.2%}  fy {fy:.2%}  fz {fz:.2%}  "
                  f"fx&fz {both:.2%}", flush=True)
        mx, my, mz = res["mean"]
        print(f"  mean ranges fx={mx:.1f} fy={my:.1f} fz={mz:.1f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
