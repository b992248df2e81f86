"""The trunk-only MLP kernel (row 8, `ops/cuda/mlp.py::fused_trunk`)
against the module MLPs, forward + backward through autograd
(counterpart of `tools/bench_mlp.py`).

    python -m hosnerf_tpu_torch.tools.bench_mlp [--n 262144] [--device cpu]

At `--n` samples in bf16, the JAX tool's two production layouts: the
canonical MLP (127 -> 8 x 256, the input concatenated before layer 5 ->
4) and the non-rigid MLP (111 -> 6 x 128, [h, embed] concatenated at
layer 4, the 36-wide embed at column 75 -> 3). The fused kernel takes
random weights N(0, 1/din) and zero biases, as the JAX tool builds them;
the modules (`CanonicalMLP`, `NonRigidMLP` with compute_dtype=bf16,
cuBLAS) their own initialisation. Each line is a chain of calls issued
back to back with one synchronisation at the end (`tools/common.py::
chain_ms`), the input moved by 1e-6 of a distinct draw per call; the
loss is the sum of the squared outputs, its gradients taken for every
weight.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

N = 262_144
ITERS, WARMUP = 10, 2
# (name, din, width, depth, skip keywords, dout), as tools/bench_mlp.py
LAYOUTS = (
    ("cnl", 127, 256, 8, dict(skip_before=5, skip_order="input_first",
                              skip_off=0, skip_width=127), 4),
    ("nr ", 111, 128, 6, dict(skip_before=4, skip_order="h_first",
                              skip_off=75, skip_width=36), 3),
)


def trunk_weights(din, width, depth, kw, dout, device, seed: int = 0):
    """Random fused-trunk weights: layers [(W [width, k], b)] with W ~
    N(0, 1/k), b = 0, and the head (W ~ N(0, 0.05^2) [dout, width], 0),
    each a leaf that takes a gradient."""
    gen = torch.Generator().manual_seed(seed)
    layers, prev = [], din
    for i in range(depth):
        k = prev + (kw["skip_width"] if i == kw["skip_before"] else 0)
        layers.append((torch.randn(width, k, generator=gen) / k ** 0.5,
                       torch.zeros(width)))
        prev = width
    out = (torch.randn(dout, width, generator=gen) * 0.05, torch.zeros(dout))
    layers = [tuple(t.to(device).requires_grad_() for t in p) for p in layers]
    return layers, tuple(t.to(device).requires_grad_() for t in out)


def module_for(name: str, width: int, depth: int, device):
    """The model's own MLP of the layout, bf16 trunks, and its call on the
    [N, din] input (NonRigidMLP splits it into [cond 75 | embed 36])."""
    from hosnerf_tpu_torch.models.human_components import (CanonicalMLP,
                                                           NonRigidMLP)
    gen = torch.Generator().manual_seed(0)
    if name.strip() == "cnl":
        mod = CanonicalMLP(127, depth, width, (4,), torch.bfloat16,
                           generator=gen, device=device)
        return mod, mod
    mod = NonRigidMLP(36, 75, depth, width, (4,), torch.bfloat16,
                      generator=gen, device=device)
    return mod, lambda x: mod(x[:, 75:], x[:, :3], x[:, :75])["xyz"]


def bench(device, n: int = N, iters: int = ITERS, warmup: int = WARMUP
          ) -> List[Tuple[str, float]]:
    """[(line name, ms per forward + backward)]: fused, then module, per
    layout."""
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    rows = []
    for name, din, width, depth, kw, dout in LAYOUTS:
        x = torch.randn(n, din, generator=torch.Generator().manual_seed(9)
                        ).to(device)
        layers, out = trunk_weights(din, width, depth, kw, dout, device)
        params = [t for p in layers for t in p] + list(out)

        def nudged(i):
            return x + 1e-6 * torch.rand(
                (1,), generator=common.jitter(i)).to(device)

        def fused(i):
            for t in params:
                t.grad = None
            y = cmlp.fused_trunk(nudged(i), layers, out, precision="bf16",
                                 **kw)
            (y ** 2).sum().backward()

        rows.append((f"{name} fused fwd+bwd",
                     common.chain_ms(fused, iters, warmup)))
        mod, call = module_for(name, width, depth, device)

        def module(i):
            mod.zero_grad(set_to_none=True)
            (call(nudged(i)) ** 2).sum().backward()

        rows.append((f"{name} module fwd+bwd",
                     common.chain_ms(module, iters, warmup)))
        del x, layers, out, params, mod
    return rows


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
    for name, ms in bench(device, args.n, args.iters, args.warmup):
        print(f"{name:34s} {ms:9.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
