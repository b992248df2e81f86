"""The human field's pieces, forward + backward each (counterpart of
`tools/profile_human.py`), at n_patches x 32^2 rays x 128 samples
(262,144 samples at the default 2 patches).

    python -m hosnerf_tpu_torch.tools.profile_human [--n_patches 2] \\
        [--device cpu]

Pieces: the inverse LBS through `ops/lbs.py::inverse_warp` with
impl='pallas' (on the card B1 and B4, the dense path's pair-grid core) and
impl='xla' (the one-hot form); the all-bone weights (`bone_weights`,
impl='pallas': row 7's kernels on the card) and two forward blends; the
canonical MLP (8 x 256) and the non-rigid MLP (6 x 128, three chained
calls) as modules (cuBLAS, bf16); the embedders (three hann-windowed
and one fourier PE); the motion-weight-volume decoder. Each timed as a
chain of calls issued back to back with one synchronisation at the end
(`utils/benchtools.py::timeit_chain`), the input moved by 1e-6 of a
distinct draw per call. The inputs are random, as in the JAX tool: 26
bones, G = 32, points N(0, 0.5^2), near-identity transforms, a softmax
volume.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

S = 128
B = 26
ITERS, WARMUP = 10, 2


def pieces(device, n: int, G: int = 32, width: int = 256,
           nr_width: int = 128, iters: int = ITERS,
           warmup: int = WARMUP) -> List[Tuple[str, float]]:
    """[(piece, ms per forward + backward)] at `n` samples."""
    from hosnerf_tpu_torch.models import embedders
    from hosnerf_tpu_torch.models.human_components import (
        CanonicalMLP, MotionWeightVolumeDecoder, NonRigidMLP)
    from hosnerf_tpu_torch.ops import lbs as lbs_ops
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    pts = randn(n, 3) * 0.5
    m_sR = randn(B, 3, 3) * 0.1 + torch.eye(3, device=device)
    m_T = randn(B, 3) * 0.1
    vol0 = torch.softmax(randn(B + 1, G, G, G), dim=0)
    bmin = torch.full((3,), -1.0, device=device)
    bscale = torch.ones(3, device=device)
    rows = []

    def nudged(i, x):
        return x + 1e-6 * torch.rand((1,), generator=common.jitter(i)).to(
            device)

    def timed(name, loss_of, *leaves):
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]

        def call(i):
            for t in leaves:
                t.grad = None
            loss_of(i, *leaves).backward()

        rows.append((name, common.chain_ms(call, iters, warmup)))

    for impl in ("pallas", "xla"):
        timed(f"inverse_warp {impl} fwd+bwd", lambda i, p, v, impl=impl: sum(
            t.mean() for t in lbs_ops.inverse_warp(
                nudged(i, p), m_sR, m_T, v, bmin, bscale, impl=impl)),
            pts, vol0)

    def fwd_lbs(i, p, v):
        p = nudged(i, p)
        w = lbs_ops.bone_weights(p, v, bmin, bscale, impl="pallas")
        d1, _ = lbs_ops.apply_forward_lbs(w, p, m_sR, m_T)
        d2, _ = lbs_ops.apply_forward_lbs(w, p, m_sR, m_T)
        return d1.mean() + d2.mean()

    timed("bone_weights+2 fwd_lbs fwd+bwd", fwd_lbs, pts, vol0)

    cdt = torch.bfloat16
    cnl = CanonicalMLP(63 + 64, 8, width, compute_dtype=cdt, generator=gen,
                       device=device)
    timed("cnl_mlp fwd+bwd", lambda i, f: cnl(nudged(i, f)).mean(),
          randn(n, 63 + 64))

    nr = NonRigidMLP(36, 75, 6, nr_width, (4,), compute_dtype=cdt,
                     generator=gen, device=device)
    cond = randn(n, 75)

    def nr3(i, e):
        e = nudged(i, e)
        o = nr(e, pts, cond)["xyz"]
        o = nr(e, o, cond)["xyz"]
        return nr(e, o, cond)["xyz"].mean()

    timed("nr_mlp x3 fwd+bwd", nr3, randn(n, 36))

    def emb(i, p):
        p = nudged(i, p)
        a = embedders.hann_alpha(10000.0, 10000, 50000, 6)
        return (embedders.hannw_fourier_embed(p, 6, a).mean()
                + embedders.hannw_fourier_embed(p + 0.1, 6, a).mean()
                + embedders.hannw_fourier_embed(p + 0.2, 6, a).mean()
                + embedders.fourier_embed(p, 10).mean())

    timed("embedders (3 hannw + fourier)", emb, pts)

    dec = MotionWeightVolumeDecoder(256, G, B, generator=gen, device=device)
    priors = torch.as_tensor(np.random.default_rng(0).uniform(
        0.01, 1.0, (B + 1, G, G, G)).astype(np.float32), device=device)

    def dec_call(i):
        dec.zero_grad(set_to_none=True)
        dec(nudged(i, priors)).mean().backward()

    rows.append(("mweight_vol_decoder fwd+bwd",
                 common.chain_ms(dec_call, iters, warmup)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=2)
    ap.add_argument("--patch_size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--small", action="store_true",
                    help="test-only: G = 8, MLPs 32 wide")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    n = args.n_patches * args.patch_size ** 2 * S
    sizes = (dict(G=8, width=32, nr_width=32) if args.small else {})
    print(f"device: {common.device_record(device)}", flush=True)
    print(f"n_patches={args.n_patches} samples={n}", flush=True)
    for name, ms in pieces(device, n, iters=args.iters, warmup=args.warmup,
                           **sizes):
        print(f"{name:34s} {ms:9.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
