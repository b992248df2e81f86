"""Pair density of the TPU pair-grid schedule under candidate sort keys
and tile predicates, on production-shaped ray samples (counterpart of
`tools/pg_density_study.py`). Counting only (`tools/pair_count.py`).

    python -m hosnerf_tpu_torch.tools.pg_density_study [--n_patches 2] \\
        [--device cpu]

Variants: morton + aabb (the JAX package's legacy route), morton + exact
(tile alive = OR of the per-sample exact support tests), sig + exact
(groups sorted by their OR'd support signature: the JAX default and the
port's 'sig' route), sigmorton + exact (signature, then Morton key) and
mortonsig + exact (Morton key, then signature). Also printed: the true
(sample, bone) support density, the floor of any schedule, and the number
of distinct group signatures.

The JAX script prints two "distinct signatures" lines; the first prints
the `size=` argument of `jnp.unique` (the group count), not a count. This
tool prints only the true count, from `torch.unique`.
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


@torch.no_grad()
def study(n_patches: int, device, patch_size: int = 32) -> dict:
    """{'samples', 'true density', 'signatures', 'groups', (order, mode):
    (pairs, capacity)} at `n_patches`, as the JAX script counts them (its
    padding rows are counted as samples, as there)."""
    pts, rg, tg, _ = pc.production_points(n_patches, device, patch_size, G)
    B = rg.shape[0]
    pts_p, n = pc.pad_rows(pts, pc.TILE_PG)
    sup = clbs._sample_support(pts_p, rg, tg, G)
    keys = pc.group_keys(pts_p, sup)
    res = {"samples": n,
           "true density": float(sup[:n].float().mean()),
           "signatures": int(torch.unique(keys["sig"]).numel()),
           "groups": int(keys["sig"].numel())}
    for name, gperm in pc.group_orders(keys, B).items():
        rows = pc.rows_of(gperm)
        modes = ("aabb", "exact") if name == "morton" else ("exact",)
        for mode in modes:
            alive = (pc.aabb_alive(pts_p[rows], rg, tg, G) if mode == "aabb"
                     else pc.exact_alive(sup[rows]))
            res[(name, mode)] = pc.density(alive, G)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=2)
    ap.add_argument("--patch_size", type=int, default=32)
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    print(f"device: {common.device_record(device)}", flush=True)
    res = study(args.n_patches, device, args.patch_size)
    ngb, _ = pc.pg_pad_shapes(26, G)
    print(f"samples={res['samples']} TILE_PG={pc.TILE_PG} NGB={ngb}",
          flush=True)
    print(f"true (sample,bone) density: {res['true density']:.3f}",
          flush=True)
    print(f"distinct group signatures: {res['signatures']} / "
          f"{res['groups']} groups", flush=True)
    for key, val in res.items():
        if isinstance(key, tuple):
            pairs, cap = val
            print(f"{key[0]:10s} + {key[1]:5s}: {pairs:6d}/{cap} = "
                  f"{pairs / cap:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
