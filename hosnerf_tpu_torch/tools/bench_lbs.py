"""The inverse and all-bone LBS kernels through their entry points,
forward and forward + backward (counterpart of `tools/bench_lbs.py`).

    python -m hosnerf_tpu_torch.tools.bench_lbs [--n 262144] [--device cpu]

At `--n` random samples (N(0, 0.5^2) points, 26 bones of near-identity
transforms, G = 32, a softmax volume, all from seed 0):
  inverse fwd             `ops/lbs.py::inverse_warp(impl="pallas")`: the
                          quad core in its default 'sig' order, row 1
                          (B1) over `bp_prepare`'s sorted domain;
  inverse fwd+bwd         the same and its backward to the volume (row 4,
                          B4);
  shared fwd              `bone_weights(impl="pallas")` (row 7's forward);
  shared+fwd_lbs fwd+bwd  `bone_weights`, then `apply_forward_lbs`, and
                          the backward to the points and the volume (row
                          7's backward).
Each a chain of calls issued back to back with one synchronisation at the
end (`tools/common.py::chain_ms`), the points moved by 1e-6 of a distinct
draw per call.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

N = 262_144
B, G = 26, 32
ITERS, WARMUP = 10, 2


def inputs(n: int, device, G: int = G, seed: int = 0):
    """(pts, m_sR, m_T, vol, bmin, bscale) on `device`."""
    gen = torch.Generator().manual_seed(seed)
    pts = torch.randn(n, 3, generator=gen) * 0.5
    m_sR = torch.randn(B, 3, 3, generator=gen) * 0.1 + torch.eye(3)
    m_T = torch.randn(B, 3, generator=gen) * 0.1
    vol = torch.softmax(torch.randn(B + 1, G, G, G, generator=gen), dim=0)
    return tuple(t.to(device) for t in (
        pts, m_sR, m_T, vol, torch.full((3,), -1.0), torch.ones(3)))


def bench(device, n: int = N, G: int = G, iters: int = ITERS,
          warmup: int = WARMUP) -> List[Tuple[str, float]]:
    """[(line name, ms per call)] of the four lines."""
    from hosnerf_tpu_torch.ops import lbs as lbs_ops
    pts, m_sR, m_T, vol, bmin, bscale = inputs(n, device, G)

    def nudged(i):
        return pts + 1e-6 * torch.rand((1,), generator=common.jitter(i)).to(
            device)

    def inv(p, v):
        x, m = lbs_ops.inverse_warp(p, m_sR, m_T, v, bmin, bscale,
                                    impl="pallas")
        return x.mean() + m.mean()

    def inv_fwd(i):
        with torch.no_grad():
            return inv(nudged(i), vol)

    vg = vol.clone().requires_grad_()

    def inv_fb(i):
        vg.grad = None
        inv(nudged(i), vg).backward()

    def sh_fwd(i):
        with torch.no_grad():
            return lbs_ops.bone_weights(nudged(i), vol, bmin, bscale,
                                        impl="pallas").mean()

    def sh_fb(i):
        vg.grad = None
        p = nudged(i).requires_grad_()
        w = lbs_ops.bone_weights(p, vg, bmin, bscale, impl="pallas")
        d, _ = lbs_ops.apply_forward_lbs(w, p, m_sR, m_T)
        d.mean().backward()

    return [(name, common.chain_ms(fn, iters, warmup)) for name, fn in (
        ("inverse fwd", inv_fwd), ("inverse fwd+bwd", inv_fb),
        ("shared fwd", sh_fwd), ("shared+fwd_lbs fwd+bwd", sh_fb))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    print(f"device: {common.device_record(device)}", flush=True)
    print(f"n_samples={args.n}", flush=True)
    for name, ms in bench(device, args.n, iters=args.iters,
                          warmup=args.warmup):
        print(f"{name:30s} {ms:9.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
