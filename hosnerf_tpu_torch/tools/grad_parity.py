"""Sorted-vs-dense gradient parity of the stage-3 loss on the card
(counterpart of `tools/tpu_grad_parity.py`).

Every parameter gradient of the stage-3 loss (no LPIPS term, as in the
JAX tool) is taken twice on the same weights, batch and jitter: with the
human field's liveness-sorted path (`sparse=True`: B1-B5 over the sorted
domain, blocks of dead rows skipped) and with its dense per-sample path
(`sparse=False`). Only this comparison catches a kernel that reads
memory it never wrote in the blocks it skips: the kernel-vs-plain checks
run the same skipping on both sides. The human field's `sparse`
attribute stands in for the JAX package's HOSNERF_SPARSE.

    python -m hosnerf_tpu_torch.tools.grad_parity [--n_patches 2] \\
        [--device cpu]

Prints the five worst relative max-differences (max |sorted - dense|
over max |dense|, per parameter), the worst one's float repr on a line of
its own (`worst rel diff exact:`), and any non-finite sorted gradient;
exits 1 where one passes TOL or is not finite. On `composed_batch(n, 32, grid_size=32)`
with `Stage3Config(n_patches=n, compute_dtype="bf16")`, iter 100, state
0, the jitter from one CPU generator seeded 7.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

TOL = 5e-3   # bf16 trunks on both sides; the JAX tool's bound
ITER = 100.0


def stage3_grads(cfg, scene, human, batch, sparse: bool
                 ) -> Dict[str, Optional[torch.Tensor]]:
    """{'scene.<name>' / 'human.<name>': gradient on the CPU, or None} of
    the stage-3 loss with the human field's path set by `sparse`."""
    from hosnerf_tpu_torch.models.state import state_index
    from hosnerf_tpu_torch.train import stage3
    human.sparse = sparse
    for m in (scene, human):
        m.zero_grad(set_to_none=True)
    loss, _ = stage3.make_loss_fn(cfg, scene, human, None)(
        batch, ITER, state_index(batch["time"], None),
        torch.Generator().manual_seed(7))
    loss.backward()
    return {f"{tag}.{n}": (None if p.grad is None
                           else p.grad.detach().float().cpu())
            for tag, m in (("scene", scene), ("human", human))
            for n, p in m.named_parameters()}


def compare(gs, gd):
    """([(rel max-diff, parameter)] largest first, [problems]) of the
    sorted gradients `gs` against the dense ones `gd`."""
    rels, bad = [], []
    for name, b in gd.items():
        a = gs[name]
        if a is None and b is None:
            continue      # the proposal MLPs: no gradient on either path
        if a is None or b is None:
            bad.append(f"gradient on one path only: {name}")
            continue
        if not bool(torch.isfinite(a).all()):
            bad.append(f"NONFINITE sparse grad: {name}")
            continue
        scale = max(float(b.abs().max()), 1e-9)
        rel = float((a - b).abs().max()) / scale
        rels.append((rel, name))
        if not math.isfinite(rel) or rel > TOL:
            bad.append(f"MISMATCH {name}: rel={rel:.3e}")
    return sorted(rels, reverse=True), bad


def run(n_patches: int, device, patch_size: int = 32, small: bool = False):
    """([(rel max-diff, parameter)] largest first, problems) at
    `n_patches`."""
    from hosnerf_tpu_torch.train import stage3
    cfg = common.stage3_config(n_patches, patch_size, small)
    batch = common.stage3_batch(cfg, device)
    scene, human = stage3.make_models(cfg, seed=0, device=device)
    gs = stage3_grads(cfg, scene, human, batch, True)
    gd = stage3_grads(cfg, scene, human, batch, False)
    return compare(gs, gd)


def top(rels, k: int = 5) -> str:
    """The k largest relative differences and their parameters."""
    return ", ".join(f"{r:.3e} {n}" for r, n in rels[:k])


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
    rels, bad = run(args.n_patches, device, args.patch_size, args.small)
    for line in bad:
        print(line, flush=True)
    print(f"n_patches={args.n_patches} worst rel diff: {top(rels)} (tol "
          f"{TOL}) on {common.device_record(device)['kind']}", flush=True)
    if rels:
        print(f"worst rel diff exact: {rels[0][0]!r} {rels[0][1]}",
              flush=True)
    print("GRAD PARITY:", "FAIL" if bad else "PASS", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
