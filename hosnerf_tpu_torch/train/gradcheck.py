"""One training step's gradients on the card's kernel path against the
same path through the kernels' plain versions on the CPU, parameter by
parameter: the stage-2 step, or with `--stage3` the composed stage-3 step
(the scene and the human field; the scene's MLPs are plain products on
both sides).

The stage-3 check holds the image terms (LPIPS and mse) fixed where they
enter the backward: both sides backpropagate the same cotangent of the
composed patches, the image terms' gradient taken once on the CPU at the
CPU's image, and the flow and cycle terms through their own gradients.
LPIPS with the random backbone is ill-conditioned at the composed image:
the card's and the CPU's tiny image difference, which no hand-written
kernel makes, moves its input gradient by more than the tolerance (the
check prints that gap). The fixed cotangent leaves the conditioning out
and keeps the LPIPS gradient's path back through the kernels in the
comparison. The stage-2 check takes each side's own LPIPS gradient.

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

    python -m hosnerf_tpu_torch.train.gradcheck [--dense | --stage3]

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
from hosnerf_tpu_torch.train import stage2, stage3
from hosnerf_tpu_torch.utils import card

ITER = 60_000      # the non-rigid condition and the full hann band are on


def _lpips(device):
    return lpips.load_weights(lpips.LPIPS(device=device), quiet=True
                              ).requires_grad_(False)


def _grads(models) -> Dict[str, torch.Tensor]:
    return {prefix + n: p.grad.detach().float().cpu()
            for prefix, m in models.items() for n, p in m.named_parameters()
            if p.grad is not None}


def step_grads(cfg: stage2.Stage2Config, nb, device, state_dict
               ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {name: grad on the CPU}) of one stage-2 loss evaluation at
    ITER on `device`, LPIPS with the random backbone included."""
    model = stage2.make_model(cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    batch = {k: torch.as_tensor(v, device=device) for k, v in nb.items()}
    total, _ = stage2.make_loss_fn(cfg, model, _lpips(device))(
        batch, ITER, state_index(batch["time"], None))
    total.backward()
    return float(total.detach()), _grads({"": model})


def stage3_grads(cfg: stage3.Stage3Config, nb, device, state_dicts,
                 pred_grad: Optional[torch.Tensor] = None
                 ) -> Tuple[float, Dict[str, torch.Tensor], torch.Tensor]:
    """(loss, {name: grad on the CPU}, own) of one stage-3 loss evaluation
    at ITER on `device` (state_dicts {'scene.': ...,  'human.': ...};
    names carry the prefix); own: the image terms' gradient at this
    side's composed patches, on the CPU. The image terms enter the
    backward as `pred_grad`, a cotangent of the composed patches, or as
    `own` when none is given."""
    scene, human = stage3.make_models(cfg, device=device)
    models = {"scene.": scene, "human.": human}
    for prefix, m in models.items():
        m.load_state_dict(state_dicts[prefix], strict=True)
    batch = {k: torch.as_tensor(v, device=device) for k, v in nb.items()}
    comp, human_out = stage3.composed_forward(
        cfg, scene, human, batch, ITER, state_index(batch["time"], None),
        is_train=True)
    pred = stage3.composed_patches(cfg, comp, batch)
    x = pred.detach().requires_grad_()
    image = stage3.image_losses(x, batch["target_patches"], _lpips(device))
    terms = stage3.human_losses(comp, human_out, batch)
    own = torch.autograd.grad(stage3.weighted_total(cfg, image),
                              x)[0].cpu()
    pred_grad = own if pred_grad is None else pred_grad
    (torch.sum(pred * pred_grad.to(device))
     + stage3.weighted_total(cfg, terms)).backward()
    total = stage3.weighted_total(cfg, {**image, **terms})
    return float(total.detach()), _grads(models), own


def compare_step_grads(device=None, n_patches: int = 2, patch_size: int = 32,
                       seed: int = 0, dense: bool = False,
                       stage3_step: bool = False) -> Dict:
    """Full-width stage-2 model (or, with stage3_step, the stage-3 scene
    and human field) from `seed`; loss and gradients on the kernel path
    (on `device`, the card unless named) and on the plain path (CPU) for
    one synthetic batch, both sorted or both dense. Returns
    {'loss': (kernel, plain),
    'params': {name: (rel_l2, cosine)}} over the parameters whose plain
    gradient is nonzero, 'missing': the parameters with a gradient on
    one side only, and for stage 3 'image_grad': the rel L2 between the
    two sides' own image-term gradients (the one the fixed cotangent
    leaves out)."""
    device = resolve_device(device)
    res: Dict = {}
    kw = dict(n_patches=n_patches, patch_size=patch_size, perturb=0.0,
              lbs_impl="pallas", mlp_impl="fused")
    if stage3_step:
        if dense:
            raise ValueError("the stage-3 check runs the sorted path only")
        cfg = stage3.Stage3Config(**kw)
        nb = synthetic.composed_batch(n_patches, patch_size, seed=seed,
                                      grid_size=cfg.mweight_volume_size)
        scene, human = stage3.make_models(cfg, seed=seed, device="cpu")
        sds = {"scene.": scene.state_dict(), "human.": human.state_dict()}
        p_loss, pg, on_cpu = stage3_grads(cfg, nb, "cpu", sds)
        k_loss, kg, on_card = stage3_grads(cfg, nb, device, sds, on_cpu)
        res["image_grad"] = float(torch.linalg.norm(on_card - on_cpu)
                                  / torch.linalg.norm(on_cpu))
    else:
        cfg = stage2.Stage2Config(sparse=not dense, **kw)
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
    res.update(loss=(k_loss, p_loss), params=params,
               missing=sorted(set(kg) ^ set(pg)))
    return res


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
    if "image_grad" in res:
        print(f"gradcheck image terms' gradient at each side's own composed "
              f"patches, kernel vs plain path: rel_l2 "
              f"{res['image_grad']:.3e} (both sides backpropagate the plain "
              "path's)")
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
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--dense", action="store_true",
                      help="the dense per-sample path (sparse=False)")
    path.add_argument("--stage3", action="store_true",
                      help="the composed stage-3 step (scene + human field, "
                      "sorted path)")
    args = ap.parse_args()
    card.configure()
    report(compare_step_grads(args.device, args.n_patches, args.patch_size,
                              dense=args.dense, stage3_step=args.stage3))


if __name__ == "__main__":
    main()
