"""The inverse LBS's dense core against its quad core on production-shaped
points, with the TPU schedule's pair density (counterpart of
`tools/bench_lbs_pg.py`).

    python -m hosnerf_tpu_torch.tools.bench_lbs_pg [--n_patches 2] \\
        [--device cpu]

The points are the rays of `synthetic.human_batch(n_patches, 32,
grid_size=32)` at 128 depths from near to far, the bone transforms
`core/body.py::motion_bases` gives, a softmax volume from seed 3
(`tools/pair_count.py::production_points`). Printed:
  pair density      `_build_pairs`' count over its capacity at the JAX
                    package's constants (Morton order, AABB predicate,
                    TILE_PG = 128), and the same count at the port's B1
                    block of INV_TILE rows;
  pallas_dense      `ops/lbs.py::inverse_warp(impl="pallas_dense")`: row
                    6, the rows as given (B1, B4);
  pallas            `inverse_warp(impl="pallas")`: the quad core in its
                    default 'sig' order, row 1 over `bp_prepare`'s sorted
                    domain (B1 at the domain's k0; B4);
each forward, and forward + backward to the points and the volume, as a
chain of calls issued back to back with one synchronisation at the end
(`tools/common.py::chain_ms`), the points moved by 1e-6 of a distinct draw
per call.
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
ITERS, WARMUP = 10, 2
IMPLS = ("pallas_dense", "pallas")


def densities(pts, rg, tg):
    """{tile: (pairs, capacity)} at TILE_PG and INV_TILE."""
    with torch.no_grad():
        return {t: pc.bench_density(pts, rg, tg, G, t)
                for t in (pc.TILE_PG, clbs.INV_TILE)}


def bench(device, n_patches: int = 2, patch_size: int = 32,
          iters: int = ITERS, warmup: int = WARMUP):
    """(rays, samples, densities, [(line name, ms per call)])."""
    from hosnerf_tpu_torch.ops import lbs as lbs_ops
    pts, rg, tg, (m_sR, m_T, bmin, bscale) = pc.production_points(
        n_patches, device, patch_size, G)
    B = m_sR.shape[0]
    vol = torch.softmax(torch.randn(
        B + 1, G, G, G, generator=torch.Generator().manual_seed(3)),
        dim=0).to(device)
    dens = densities(pts, rg, tg)

    def nudged(i):
        return pts + 1e-6 * torch.rand((1,), generator=common.jitter(i)).to(
            device)

    def loss(p, v, impl):
        x, m = lbs_ops.inverse_warp(p, m_sR, m_T, v, bmin, bscale,
                                    impl=impl)
        return x.mean() + m.mean()

    vg = vol.clone().requires_grad_()
    rows = []
    for impl in IMPLS:
        def fwd(i, impl=impl):
            with torch.no_grad():
                return loss(nudged(i), vol, impl)

        def fb(i, impl=impl):
            vg.grad = None
            loss(nudged(i).requires_grad_(), vg, impl).backward()

        rows.append((f"{impl} fwd", common.chain_ms(fwd, iters, warmup)))
        rows.append((f"{impl} fwd+bwd", common.chain_ms(fb, iters, warmup)))
    return patch_size ** 2 * n_patches, pts.shape[0], dens, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=2)
    ap.add_argument("--patch_size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    print(f"device: {common.device_record(device)}", flush=True)
    rays, n, dens, rows = bench(device, args.n_patches, args.patch_size,
                                args.iters, args.warmup)
    print(f"rays={rays} samples={n}", flush=True)
    for (tile, (pairs, cap)), name in zip(dens.items(),
                                          ("TILE_PG", "INV_TILE")):
        print(f"pair density: {pairs}/{cap} = {pairs / cap:.3f} ({name}="
              f"{tile})", flush=True)
    for name, ms in rows:
        print(f"{name:30s} {ms:9.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
