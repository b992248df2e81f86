"""One stage-2 step's gradients on the card's kernel path against the same
path through the kernels' plain versions on the CPU, parameter by
parameter.

Both runs take the sorted path (`lbs_impl='pallas'`, `mlp_impl='fused'`),
or with `--dense` the dense per-sample path (`sparse=False`: the
inverse-LBS kernel in Morton row order, the fused MLP and forward-LBS
kernels on every sample), with bf16 LBS taps and f32 trunks, start from
the same weights (built from one seed) and see the same synthetic batch,
with no sample jitter. On CUDA
tensors the path launches the hand-written kernels, on CPU tensors their
plain versions, so the two runs differ only where a kernel differs from
its plain version: the order of its sums, and the bf16 roundings that
order moves across a rounding boundary. (How the bf16 taps move the
gradients away from the dense f32 path is `tests/test_torch_train.py`'s
concern.) `chip_smoke.py` holds the result to its tolerance; alone:

    python -m hosnerf_tpu_torch.train.gradcheck [--dense]

prints the table for the training batch (2 patches of 32 x 32 rays).
`--device cpu` runs both sides on the plain versions: every difference is
then 0, a dry run of the script.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import torch

from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.models import lpips
from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.models.state import state_index
from hosnerf_tpu_torch.train import stage2

ITER = 60_000      # the non-rigid condition and the full hann band are on


def step_grads(cfg: stage2.Stage2Config, nb, device, state_dict
               ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {name: grad on the CPU}) of one loss evaluation at ITER on
    `device`, LPIPS with the random backbone included."""
    model = stage2.make_model(cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    lp = lpips.load_weights(lpips.LPIPS(device=device), quiet=True
                            ).requires_grad_(False)
    batch = {k: torch.as_tensor(v, device=device) for k, v in nb.items()}
    total, _ = stage2.make_loss_fn(cfg, model, lp)(
        batch, ITER, state_index(batch["time"], None))
    total.backward()
    return float(total.detach()), {
        n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
        if p.grad is not None}


def compare_step_grads(device=None, n_patches: int = 2, patch_size: int = 32,
                       seed: int = 0, dense: bool = False) -> Dict:
    """Full-width stage-2 model from `seed`; loss and gradients on the
    kernel path (on `device`, the card unless named) and on the plain path
    (CPU) for one synthetic batch, both sorted or both dense. Returns
    {'loss': (kernel, plain),
    'params': {name: (rel_l2, cosine)}} over the parameters whose plain
    gradient is nonzero, and 'missing': the parameters with a gradient on
    one side only."""
    device = resolve_device(device)
    cfg = stage2.Stage2Config(n_patches=n_patches, patch_size=patch_size,
                              perturb=0.0, lbs_impl="pallas",
                              mlp_impl="fused", sparse=not dense)
    nb = synthetic.human_batch(n_patches, patch_size, seed=seed,
                               grid_size=cfg.mweight_volume_size)
    sd = stage2.make_model(cfg, seed=seed, device="cpu").state_dict()
    k_loss, kg = step_grads(cfg, nb, device, sd)
    p_loss, pg = step_grads(cfg, nb, "cpu", sd)
    params = {}
    for name, ref in pg.items():
        if float(ref.abs().max()) == 0.0:
            continue
        got, ref = kg[name].double(), ref.double()
        rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
        cos = float(torch.sum(got * ref) / (torch.linalg.norm(got)
                                            * torch.linalg.norm(ref)))
        params[name] = (rel, cos)
    return {"loss": (k_loss, p_loss), "params": params,
            "missing": sorted(set(kg) ^ set(pg))}


def report(res: Dict, tol_rel: Optional[float] = None) -> Tuple[float, float]:
    """Print the per-parameter table; returns (worst rel_l2, worst
    cosine)."""
    k_loss, p_loss = res["loss"]
    print(f"gradcheck loss kernel path {k_loss:.7f} plain path {p_loss:.7f}")
    for name, (rel, cos) in sorted(res["params"].items()):
        flag = ("  <- beyond tolerance"
                if tol_rel is not None and rel > tol_rel else "")
        print(f"  {name:60s} rel_l2 {rel:.3e} cos {cos:.8f}{flag}")
    if res["missing"]:
        print(f"  gradient on one side only: {res['missing']}")
    worst_rel = max(r for r, _ in res["params"].values())
    worst_cos = min(c for _, c in res["params"].values())
    print(f"gradcheck {len(res['params'])} parameters: worst rel_l2 "
          f"{worst_rel:.3e}, worst cosine {worst_cos:.8f}", flush=True)
    return worst_rel, worst_cos


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="kernel path's device (default: the card)")
    ap.add_argument("--n-patches", type=int, default=2)
    ap.add_argument("--patch-size", type=int, default=32)
    ap.add_argument("--dense", action="store_true",
                    help="the dense per-sample path (sparse=False)")
    args = ap.parse_args()
    report(compare_step_grads(args.device, args.n_patches, args.patch_size,
                              dense=args.dense))


if __name__ == "__main__":
    main()
