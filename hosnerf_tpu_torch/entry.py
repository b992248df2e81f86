"""Dry-run entry points of the port (counterpart of `__graft_entry__.py`).

  entry(device=None) -> (fn, example_args): the tiny scene model's eval
      step and its batch, on the card unless `device` names another.
  dryrun_multidevice(n, backend=None, device=None) -> per-rank reports:
      n processes (this module's `--worker`, so that they import neither
      the tests nor JAX) joined in one process group; each runs the tiny
      stage-3 step on its share of the rays, then stages 1 and 2, then a
      sharded composed-render chunk, and holds each against the one-process
      step on the whole batch (loss within 2e-6 * max(1, |loss|), as
      `__graft_entry__.py::_loss_agreement`; every gradient within rel L2
      1e-5 on the CPU, 1e-4 on the card, where the kernels' sums and
      cuBLAS's run in another order: 3.65e-6 measured at 2 ranks on one
      H100), the render chunk within TOL_RENDER, and every rank's
      parameters after the update against the others', bit for bit.

    python -m hosnerf_tpu_torch.entry [--device cpu] [--n 2] [--backend gloo]

runs both (on the card by default: with one card, pass --device cuda:0
--backend gloo, since NCCL refuses two ranks on one device). `size="cell"`
runs bench.py's stage-3 cell instead (full width, LPIPS, kernel launches
counted per rank and the step timed by `utils/benchtools`), as
chip_smoke.py's phase ddp does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from hosnerf_tpu_torch.utils import card

TOL_LOSS = 2e-6      # relative to max(1, |loss|)
TOL_GRAD = {"cpu": 1e-5, "cuda": 1e-4}   # rel L2 per parameter
# sharded vs one-process render chunk, (max, mean) abs error over the
# largest value: the CPU's plain path gives the same bits up to rounding;
# on the card cuBLAS picks other algorithms for other row counts (5.9e-7,
# 1.2e-7 measured), held to chip_smoke.py's render tolerances
TOL_RENDER = {"cpu": (1e-6, 1e-7), "cuda": (5e-2, 2e-3)}
TRAIN_ITER = 60_000  # the non-rigid condition and full hann band on
PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_stage1_cfg():
    from hosnerf_tpu_torch.train import stage1
    return stage1.Stage1Config(
        max_steps=100, near=0.5, far=20.0, nerf_netwidth=64,
        prop_netwidth=32, num_prop_samples=16, num_nerf_samples=8,
        lr_delay_steps=0)


def entry(device=None):
    """(eval_fn, (batch,)): the tiny scene model's eval step on 64 rays."""
    from hosnerf_tpu_torch.data import batches, synthetic
    from hosnerf_tpu_torch.train import stage1
    cfg = _tiny_stage1_cfg()
    model, _ = stage1.init_state(cfg, seed=0, device=device)
    batch = batches.to_device(synthetic.scene_ray_batch(64), device)
    return stage1.make_eval_step(cfg, model), (batch,)


# ---------------------------------------------------------------------------
# the worker: one rank
# ---------------------------------------------------------------------------

def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    d = float(torch.linalg.vector_norm((got - ref).double()))
    r = float(torch.linalg.vector_norm(ref.double()))
    return d / r if r > 0 else d


def _params_digest(models) -> str:
    h = hashlib.blake2b(digest_size=16)
    for m in models:
        for name, p in m.named_parameters():
            h.update(name.encode())
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _stage_check(name: str, models, grad_fn, update, host_batch, args,
                 rank: int, world: int, device, tol_loss: float,
                 tol_grad: float, seed: int = 1) -> Dict:
    """The one-process gradient step on the whole batch, then this rank's
    step on its share (gradients summed over the ranks) from the same
    parameters and generator seed; loss and every gradient held to the
    tolerances; then the update, and the parameters' digest held against
    every rank's."""
    import torch.distributed as dist

    from hosnerf_tpu_torch.data import batches
    from hosnerf_tpu_torch.parallel import mesh

    params = [(n, p) for m in models for n, p in m.named_parameters()]
    full = batches.to_device(host_batch, device)
    ref = grad_fn(full, *args, torch.Generator().manual_seed(seed))
    ref_grads = {n: None if p.grad is None else p.grad.detach().clone()
                 for n, p in params}
    local = batches.to_device(
        mesh.shard_batch(host_batch, rank, world, keys=mesh.RAY_KEYS),
        device)
    mesh.check_same_batch(local)
    aux = grad_fn(local, *args, torch.Generator().manual_seed(seed))
    l1, ln = float(ref["loss"]), float(aux["loss"])
    worst, worst_name = 0.0, None
    for n, p in params:
        if (p.grad is None) != (ref_grads[n] is None):
            raise AssertionError(f"{name}: {n} has a gradient on one side "
                                 "only")
        if p.grad is not None:
            e = _rel_l2(p.grad, ref_grads[n])
            if e > worst:
                worst, worst_name = e, n
    del ref_grads
    update()
    digests = [None] * world
    dist.all_gather_object(digests, _params_digest(models))
    delta = abs(ln - l1)
    rep = {"loss_1": l1, "loss_n": ln, "loss_delta": delta,
           "max_grad_rel": worst, "worst_param": worst_name,
           "params_equal": len(set(digests)) == 1}
    print(f"dryrun_multidevice({world}) rank {rank}: {name} sharded vs "
          f"one-process loss {ln:.7f} vs {l1:.7f} |delta|={delta:.2e}, "
          f"max gradient rel L2 {worst:.2e} ({worst_name}), parameters "
          f"equal on every rank: {rep['params_equal']}", flush=True)
    if not delta <= tol_loss * max(1.0, abs(l1)):
        raise AssertionError(f"{name}: loss {ln} vs one-process {l1}")
    if not worst <= tol_grad:
        raise AssertionError(f"{name}: gradient {worst_name} rel L2 {worst}")
    if not rep["params_equal"]:
        raise AssertionError(f"{name}: the ranks' parameters differ after "
                             "the update")
    return rep


def _render_check(cfg, scene, human, host_batch, rank, world, device,
                  tols) -> Dict:
    """A composed render chunk through `shard_eval_fn` against the same
    chunk in one process: max and mean abs error over the largest value,
    held to tols (max, mean)."""
    from hosnerf_tpu_torch.data import batches
    from hosnerf_tpu_torch.eval import renderers
    from hosnerf_tpu_torch.parallel import mesh
    render_fn = renderers.make_composed_render_fn(cfg, scene, human)
    full = batches.to_device(host_batch, device)
    ref = render_fn(full)
    got = mesh.shard_eval_fn(render_fn, rank, world)(full)
    scale = max(float(ref.abs().max()), 1e-30)
    diff = (got.float() - ref.float()).abs()
    rep = {"rays": int(ref.shape[0]), "rgb_mean": float(got.mean()),
           "max_err": float(diff.max()) / scale,
           "mean_err": float(diff.mean()) / scale}
    print(f"dryrun_multidevice({world}) rank {rank}: sharded composed "
          f"render chunk of {rep['rays']} rays, rgb mean "
          f"{rep['rgb_mean']:.4f}, error max {rep['max_err']:.3e} mean "
          f"{rep['mean_err']:.3e} of the largest value", flush=True)
    if not (got.shape == ref.shape and bool(torch.isfinite(got).all())
            and rep["max_err"] <= tols[0] and rep["mean_err"] <= tols[1]):
        raise AssertionError(f"sharded render chunk disagrees: {rep}")
    return rep


def _tiny(rank: int, world: int, device) -> Dict:
    from hosnerf_tpu_torch.data import synthetic
    from hosnerf_tpu_torch.train import stage1, stage2, stage3
    tol_grad = TOL_GRAD[device.type]
    out = {}
    n_patches = max(2, world)
    cfg3 = stage3.Stage3Config(
        n_samples=8, cnl_mlp_width=32, nr_mlp_width=32,
        mweight_volume_size=8, n_patches=n_patches, patch_size=4,
        num_prop_samples=8, num_nerf_samples=4, nerf_netwidth=32,
        prop_netwidth=16, near_bkg=0.5, far_bkg=20.0)
    scene, human, opt = stage3.init_state(cfg3, seed=0, device=device)
    b3 = synthetic.composed_batch(cfg3.n_patches, cfg3.patch_size,
                                  grid_size=8)
    out["stage3"] = _stage_check(
        "stage-3", [scene, human], stage3.make_grad_fn(cfg3, scene, human),
        lambda: stage3.s2.apply_updates(cfg3, opt), b3, (TRAIN_ITER,), rank,
        world, device, TOL_LOSS, tol_grad)

    cfg1 = _tiny_stage1_cfg()
    model1, opt1 = stage1.init_state(cfg1, seed=0, device=device)
    out["stage1"] = _stage_check(
        "stage-1", [model1], stage1.make_grad_fn(cfg1, model1),
        lambda: stage1.apply_updates(cfg1, model1, opt1),
        synthetic.scene_ray_batch(8 * world), (0,), rank, world, device,
        TOL_LOSS, tol_grad)

    cfg2 = stage2.Stage2Config(
        n_samples=8, cnl_mlp_width=32, nr_mlp_width=32,
        mweight_volume_size=8, n_patches=n_patches, patch_size=4)
    model2, opt2 = stage2.init_state(cfg2, seed=0, device=device)
    out["stage2"] = _stage_check(
        "stage-2", [model2],
        stage2.make_grad_fn(stage2.make_loss_fn(cfg2, model2), [model2]),
        lambda: stage2.apply_updates(cfg2, opt2),
        synthetic.human_batch(cfg2.n_patches, cfg2.patch_size, grid_size=8),
        (TRAIN_ITER,), rank, world, device, TOL_LOSS, tol_grad)

    out["render"] = _render_check(cfg3, scene, human, b3, rank, world,
                                  device, TOL_RENDER[device.type])
    return out


def _cell(rank: int, world: int, device, spec: Dict) -> Dict:
    """bench.py's stage-3 cell, Stage3Config(n_patches=2,
    compute_dtype='bf16') on composed_batch(2, 32, grid_size=32): the
    sharded gradient step against the one-process one (spec's loss and
    gradient tolerances), then 1 + 3 sharded training steps with the
    kernel wrappers' launches counted around the 3 and the step timed by
    `utils/benchtools.timeit_chain`, then one sharded render chunk.
    spec['cfg'] overrides config fields (a small CPU rehearsal)."""
    import dataclasses

    from hosnerf_tpu_torch.data import batches, synthetic
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.parallel import mesh
    from hosnerf_tpu_torch.train import stage3
    from hosnerf_tpu_torch.utils import benchtools, spans

    cfg = dataclasses.replace(
        stage3.Stage3Config(n_patches=2, compute_dtype="bf16"),
        **spec.get("cfg", {}))
    lp = lpips.load_weights(lpips.LPIPS(device=device)).requires_grad_(False)
    scene, human, opt = stage3.init_state(cfg, seed=0, device=device)
    hb = synthetic.composed_batch(cfg.n_patches, cfg.patch_size,
                                  grid_size=cfg.mweight_volume_size)
    out = {"check": _stage_check(
        "stage-3 cell", [scene, human],
        stage3.make_grad_fn(cfg, scene, human, lpips_apply=lp),
        lambda: stage3.s2.apply_updates(cfg, opt), hb, (TRAIN_ITER,), rank,
        world, device, spec["tol_loss"], spec["tol_grad"])}

    step = stage3.make_train_step(cfg, scene, human, opt, lpips_apply=lp)
    local = batches.to_device(
        mesh.shard_batch(hb, rank, world, keys=mesh.RAY_KEYS), device)
    gens = [(local, TRAIN_ITER, torch.Generator().manual_seed(11 + i))
            for i in range(4)]
    wrappers = spans.kernel_wrappers()
    step(*gens[0])                                 # the warm-up step
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for w in wrappers.values():
        w.launches = 0
    losses = []
    sec = benchtools.timeit_chain(lambda *a: losses.append(step(*a)),
                                  gens[1:], iters=3, warmup=0)
    out["ms_per_step"] = sec * 1e3
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    out["losses"] = [benchtools.force_value(x["loss"]) for x in losses]
    out["rays_per_rank"] = int(local["rays_o"].shape[0])
    # the step's gradient all-reduce alone (on the last step's gradients)
    grads = [p.grad for m in (scene, human) for p in m.parameters()
             if p.grad is not None]
    out["grad_numel"] = sum(g.numel() for g in grads)
    out["allreduce_ms"] = 1e3 * benchtools.timeit_chain(
        mesh.shard_of(local).reduce_grads,
        [([p for m in (scene, human) for p in m.parameters()],)] * 2,
        iters=1, warmup=1)
    print(f"dryrun_multidevice({world}) rank {rank}: 3 sharded steps of "
          f"{out['rays_per_rank']} rays, {out['ms_per_step']:.2f} ms/step "
          f"(the gradient all-reduce of {out['grad_numel']} values alone "
          f"{out['allreduce_ms']:.2f} ms), losses {out['losses']}, launches "
          + " ".join(f"{k}={v}" for k, v in out["launches"].items()),
          flush=True)
    out["render"] = _render_check(cfg, scene, human, hb, rank, world,
                                  device, tuple(spec["tol_render"]))
    return out


def _worker(spec_path: str) -> int:
    from hosnerf_tpu_torch.parallel import distributed
    with open(spec_path) as f:
        spec = json.load(f)
    rank, world = spec["rank"], spec["world"]
    os.environ["LOCAL_RANK"] = str(spec.get("local_rank", rank))
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    card.configure()
    device = distributed.initialize(spec["init"], world, rank,
                                    backend=spec.get("backend"),
                                    device=spec.get("device"))
    try:
        t0 = time.time()
        rep = (_cell(rank, world, device, spec) if spec["size"] == "cell"
               else _tiny(rank, world, device))
        rep["seconds"] = time.time() - t0
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    finally:
        distributed.shutdown()
    return 0


def dryrun_multidevice(n: int, backend: Optional[str] = None, device=None,
                       size: str = "tiny", threads: Optional[int] = None,
                       timeout: float = 900.0, quiet: bool = False,
                       **spec) -> List[Dict]:
    """Spawn n worker processes (one process group, initialised from a
    file in a temporary directory), wait for them, and return their
    reports in rank order; raise with the workers' output if any fails.
    `device`: each rank's ('cuda' -> cuda:{rank}; the card unless
    named); `backend`: NCCL on CUDA devices, gloo on the CPU, unless
    named."""
    device = "cuda" if device is None else str(device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PKG_PARENT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                        else []))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(n):
            path = os.path.join(tmp, f"spec{r}.json")
            with open(path, "w") as f:
                json.dump({"rank": r, "world": n, "local_rank": r,
                           "init": "file://" + os.path.join(tmp, "init"),
                           "backend": backend, "device": device,
                           "size": size, "threads": threads, "out": tmp,
                           **spec}, f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "hosnerf_tpu_torch.entry",
                 "--worker", path], env=env, cwd=tmp,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], False
        deadline = time.time() + timeout
        for p in procs:
            try:
                log, _ = p.communicate(timeout=max(1.0,
                                                   deadline - time.time()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                log, _ = p.communicate()
                p.returncode = p.returncode or -9
            logs.append(log)
            failed = failed or p.returncode != 0
            if p.returncode != 0:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
        if failed:
            raise RuntimeError(
                f"dryrun_multidevice({n}) failed:\n" + "\n".join(
                    f"--- rank {r} (rc {p.returncode})\n{log[-4000:]}"
                    for r, (p, log) in enumerate(zip(procs, logs))))
        if not quiet:
            for log in logs:
                sys.stdout.write(log)
        reports = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    return reports


def main(argv=None) -> int:
    p = argparse.ArgumentParser("hosnerf_tpu_torch.entry")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    p.add_argument("--device", default=None,
                   help="each rank's device (default: the card)")
    p.add_argument("--backend", default=None)
    p.add_argument("--n", type=int, default=2)
    args = p.parse_args(argv)
    card.configure()
    if args.worker:
        return _worker(args.worker)
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry eval step:", tuple(out.shape), float(out.mean()))
    dryrun_multidevice(args.n, args.backend, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
