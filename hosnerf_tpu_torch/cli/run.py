"""The command line of the port: train, evaluate or render one stage
(counterpart of `hosnerf_tpu/cli/run.py`, with the same flags).

  python -m hosnerf_tpu_torch.cli.run --stage scene  --ginc <gin> \\
      --scene_name Backpack --logbase logs [--ginb k=v ...] [--seed N]
  python -m hosnerf_tpu_torch.cli.run --stage human  --cfg <scene.yaml> ...
  python -m hosnerf_tpu_torch.cli.run --stage hosnerf --ginc <gin> \\
      --cfg <yaml> --bkgd_path <stage-1 ckpt> --human_path <stage-2 ckpt>

--run_mode {train,eval,render} maps to the reference's trainer.fit /
test / predict. Runs write under <logbase>/<stage>_<scene_name>/:
metrics.jsonl and TensorBoard events, ckpt/{last,best}.pt (the port's
checkpoints, `train/checkpoints.py`), results*.json and the rendered
images and videos. --bkgd_path, --human_path and a --ckpt_path ending in
.ckpt take reference Lightning checkpoints too. --device picks the
device (default: the CUDA card, which must exist; `cpu` for the CPU):
the port's counterpart of the JAX package's platform pin.

Data parallel over N cards, one process each:

  torchrun --nproc_per_node N -m hosnerf_tpu_torch.cli.run --stage ...

Each rank joins the process group (`parallel/distributed.py::initialize`:
NCCL on the cards, gloo with --device cpu), `--device cuda` meaning its
own card (cuda:LOCAL_RANK). Every rank builds the same batch from the
same seed and keeps its share of the rays (`parallel/mesh.py::
shard_batch`) before `data/batches.py::to_device`; the render and eval
callables render each chunk split over the ranks (`shard_eval_fn`), as
the JAX CLI shards over its data mesh. Rank 0 writes the logs,
checkpoints, results and images.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from hosnerf_tpu_torch.parallel import distributed, mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("hosnerf_tpu_torch")
    p.add_argument("--stage", choices=["scene", "human", "hosnerf"],
                   required=True)
    p.add_argument("--ginc", action="append", default=[],
                   help="gin config file(s)")
    p.add_argument("--ginb", action="append", default=[],
                   help="gin binding override(s)")
    p.add_argument("--cfg", type=str, default=None,
                   help="per-scene yaml (stages human/hosnerf)")
    p.add_argument("--default_cfg", type=str, default=None,
                   help="default.yaml path (defaults to built-in values)")
    p.add_argument("--scene_name", type=str, default=None)
    p.add_argument("--logbase", type=str, default="logs")
    p.add_argument("--seed", type=int, default=220901)
    p.add_argument("--resume_training", type=lambda s: s.lower() == "true",
                   default=False)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--bkgd_path", type=str, default=None)
    p.add_argument("--human_path", type=str, default=None)
    p.add_argument("--run_mode", choices=["train", "eval", "render"],
                   default="train")
    p.add_argument("--max_steps", type=int, default=None,
                   help="override gin/yaml step count")
    p.add_argument("--lpips_vgg_path", type=str,
                   default=os.environ.get("LPIPS_VGG_PATH"),
                   help="torchvision vgg16 state_dict (.pth) for "
                        "metric-grade LPIPS; falls back to fixed-seed "
                        "random VGG features without it")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda needs a card; cpu "
                        "for the CPU)")
    return p


def _device(args) -> torch.device:
    """This rank's device (--device; 'cuda' is cuda:LOCAL_RANK)."""
    return distributed.rank_device(args.device)


def _report(*args) -> None:
    """Print on rank 0 only."""
    if distributed.is_primary():
        print(*args)


def _shard(batch):
    """This rank's share of a host batch's rays (the batch unchanged for
    one rank)."""
    return mesh.shard_batch(batch, keys=mesh.RAY_KEYS)


def _load_lpips(args, patch_size: int, device):
    """(LPIPS module, backbone provenance) with the weights available
    (a vgg16 backbone when --lpips_vgg_path is given, else its fixed-seed
    random one); (None, None) below LPIPS's 16x16 minimum, where the
    training loss and the eval omit the LPIPS term."""
    if patch_size < 16:
        print(f"[lpips] patches {patch_size}x{patch_size} < 16x16 "
              "minimum - lpips loss/metric disabled for this run")
        return None, None
    from hosnerf_tpu_torch.models import lpips as lpips_mod
    lp = lpips_mod.load_weights(lpips_mod.LPIPS(device=device),
                                vgg_path=args.lpips_vgg_path)
    return (lp.requires_grad_(False),
            lpips_mod.backbone_provenance(args.lpips_vgg_path))


def _lpips_metric(lp):
    from hosnerf_tpu_torch.eval import metrics as M
    return None if lp is None else M.make_lpips_metric(lp)


def _logdir(args) -> str:
    name = args.scene_name or "scene"
    d = os.path.join(args.logbase, f"{args.stage}_{name}")
    os.makedirs(d, exist_ok=True)
    return d


def _capture_dir(basedir: str, scene_name) -> str:
    """The reference's yaml `basedir` points directly at the capture dir;
    accept the stage-1 convention too (<basedir>/<scene_name>) when that
    subdirectory is the actual capture (has mesh_infos.pkl)."""
    if scene_name:
        sub = os.path.join(basedir, scene_name)
        if (os.path.isfile(os.path.join(sub, "mesh_infos.pkl"))
                and not os.path.isfile(
                    os.path.join(basedir, "mesh_infos.pkl"))):
            return sub
    return basedir


def _resolve_cdt(spec, device) -> Optional[str]:
    """Config-surface compute dtype: 'auto' (default) -> bf16 MLP trunks
    on the card, f32 (None) on the CPU; 'bf16'/'f32' force it."""
    s = str(spec or "auto").lower()
    if s == "auto":
        return "bf16" if torch.device(device).type == "cuda" else None
    return None if s in ("f32", "float32", "none") else s


def _loop_generator(args) -> torch.Generator:
    return torch.Generator().manual_seed(args.seed + 1)


def run_scene(args) -> None:
    from hosnerf_tpu_torch.config import ginlite
    from hosnerf_tpu_torch.data import batches, scene_loader, scene_pipeline
    from hosnerf_tpu_torch.eval import metrics as M
    from hosnerf_tpu_torch.eval import renderers
    from hosnerf_tpu_torch.train import checkpoints as ck
    from hosnerf_tpu_torch.train import loop, stage1

    device = _device(args)
    gin = ginlite.parse_config_files_and_bindings(args.ginc, args.ginb)
    run_cfg = ginlite.scoped(gin, "run")
    logdir = _logdir(args)
    if distributed.is_primary():
        with open(os.path.join(logdir, "config.gin"), "w") as f:
            f.write(ginlite.dumps(gin))

    datadir = run_cfg.get("datadir", ".")
    scene = scene_loader.load_nerf_360_v2(
        datadir, args.scene_name,
        factor=int(gin.get("LitDataNeRF360V2.factor", 0) or 0),
        near=gin.get("LitDataNeRF360V2.near", 0.1),
        far=gin.get("LitDataNeRF360V2.far", 1e6))
    batch_size = int(gin.get("LitData.batch_size", 4096))
    pipe = scene_pipeline.ScenePipeline(
        scene, batch_size, seed=args.seed,
        batch_sampler=str(gin.get("LitData.batch_sampler", "single_image")),
        precrop=bool(gin.get("LitData.precrop", False)),
        precrop_steps=int(gin.get("LitData.precrop_steps", 0)))

    # transition times for the state embeddings
    tt = os.path.join(datadir, args.scene_name, "transitions_times.json")
    transitions = None
    if os.path.exists(tt):
        with open(tt) as f:
            transitions = np.array(
                [v["time"] for v in json.load(f).values()], np.float32)

    max_steps = args.max_steps or int(run_cfg.get("max_steps", 500_000))
    cfg = stage1.Stage1Config(
        max_steps=max_steps, near=scene.near, far=scene.far,
        grad_max_norm=float(run_cfg.get("grad_max_norm", 0.001)),
        num_states=(len(transitions) + 1) if transitions is not None else 1,
        nerf_netwidth=int(gin.get("NeRFMLP.netwidth", 1024)),
        prop_netwidth=int(gin.get("PropMLP.netwidth", 256)),
        num_prop_samples=int(gin.get("MipNeRF360.num_prop_samples", 64)),
        num_nerf_samples=int(gin.get("MipNeRF360.num_nerf_samples", 32)),
        compute_dtype=_resolve_cdt(gin.get("MipNeRF360.compute_dtype"),
                                   device))

    model, opt = stage1.init_state(cfg, seed=args.seed, device=device)
    models = {"scene": model}
    start_step, loop_gen = 0, _loop_generator(args)
    if args.ckpt_path and args.ckpt_path.endswith(".ckpt"):
        # torch Lightning checkpoint: weights-only warm start
        ck.overlay_params(model, ck.import_scene_params(args.ckpt_path))
    elif args.resume_training or args.ckpt_path:
        # true resume: LR schedule, Adam moments and jitter draws continue
        start_step = ck.restore_train_state(
            os.path.join(logdir, "ckpt"), args.ckpt_path or "last", models,
            opt, loop_gen)

    step_fn = stage1.make_train_step(cfg, model, opt, transitions)
    eval_step = mesh.shard_eval_fn(stage1.make_eval_step(cfg, model,
                                                         transitions))

    if args.run_mode == "train":
        def val_fn(step):
            i = int(scene.i_split[1][0])
            rgb = renderers.render_scene_image(eval_step, pipe, i,
                                               device=device)
            return float(M.psnr(torch.as_tensor(rgb),
                                torch.as_tensor(scene.images[i])))

        loop.run_training(
            num_steps=max_steps,
            sample_batch=lambda: batches.to_device(
                _shard(pipe.sample_train_batch()), device),
            step_fn=step_fn, models=models, optimizer=opt, logdir=logdir,
            rays_per_step=batch_size,
            log_every=int(run_cfg.get("log_every_n_steps", 100)),
            val_fn=val_fn, generator=loop_gen, start_step=start_step,
            lr_schedule=lambda s: stage1.learning_rate(cfg, s))
    elif args.run_mode == "eval":
        lp, lp_backbone = _load_lpips(args, 32, device)
        results = renderers.evaluate_scene(
            eval_step, pipe, logdir, lpips_metric=_lpips_metric(lp),
            lpips_backbone=lp_backbone, device=device)
        _report(results)
    else:  # render: the interpolated camera path (reference `predict`)
        path = renderers.render_scene_path(eval_step, pipe, logdir,
                                           device=device)
        _report(f"wrote {path}")


def _human_sizes(cfg_yaml):
    """(volume size, patches, patch size, samples, canonical width,
    non-rigid width, MLP chunk) from the yaml's network keys
    (ref: 2nd.../configs/default.yaml:23-59); mlp_chunk is the reference's
    netchunk_per_gpu * 4 points per call, None (unset) one pass."""
    netchunk = cfg_yaml.get("netchunk_per_gpu")
    patch_y = cfg_yaml.get("patch", {})
    return dict(
        mweight_volume_size=int(cfg_yaml.get("mweight_volume", {}).get(
            "volume_size", 32)),
        n_patches=int(patch_y.get("N_patches", 2)),
        patch_size=int(patch_y.get("size", 32)),
        n_samples=int(cfg_yaml.get("N_samples", 128)),
        cnl_mlp_width=int(cfg_yaml.get("canonical_mlp", {}).get(
            "mlp_width", 256)),
        nr_mlp_width=int(cfg_yaml.get("non_rigid_motion_mlp", {}).get(
            "mlp_width", 128)),
        mlp_chunk=int(netchunk) * 4 if netchunk else None)


def _make_batch(ds, device):
    """make_batch(i=None): item i (a random one without i) of the dataset,
    this rank's share of its rays, on the device (the frame name
    dropped)."""
    from hosnerf_tpu_torch.data import batches

    def make_batch(i=None):
        idx = np.random.randint(len(ds)) if i is None else i
        return batches.to_device(_shard(ds[idx]), device)

    return make_batch


def _eval_or_render(args, cfg_yaml, render_fn, factory, logdir, device,
                    transitions, lp, lp_backbone, tpose_resolution,
                    extra_keys=(), tpose_render_fn=None) -> None:
    """Stages 2 and 3 outside training: the full eval sweep (eval) or the
    freeview orbit (render)."""
    from hosnerf_tpu_torch.eval import renderers
    rnd_y = cfg_yaml.get("render", {})
    frames = int(rnd_y.get("freeview_frames", 100))
    if args.run_mode == "eval":
        out = renderers.full_human_eval(
            render_fn, factory, logdir, transitions=transitions,
            lpips_metric=_lpips_metric(lp), lpips_backbone=lp_backbone,
            extra_keys=extra_keys, tpose_render_fn=tpose_render_fn,
            # the render block is a framework extension for small runs
            tpose_resolution=int(rnd_y.get("tpose_resolution",
                                           tpose_resolution)),
            freeview_frames=frames, tpose_views=rnd_y.get("tpose_views"),
            device=device)
        _report(out)
    else:
        out = renderers.render_freeview(
            render_fn, factory(mode="freeview", render_frames=frames),
            logdir, extra_keys=extra_keys, device=device)
        _report(f"{len(out)} frames")


def _factory(cfg_yaml, datadir, vol_size, **fixed):
    """dataset_factory(mode, **kw) of the eval sweeps: a HumanDataset on
    a white background (freeview at the yaml's freeview.frame_idx)."""
    from hosnerf_tpu_torch.data.human_dataset import HumanDataset

    def factory(mode, **kw):
        if mode == "freeview":
            kw.setdefault("freeview_frame_idx", int(
                cfg_yaml.get("freeview", {}).get("frame_idx", 0)))
        return HumanDataset(datadir, mode=mode,
                            mweight_volume_size=vol_size,
                            bgcolor=[255.0, 255.0, 255.0], **fixed, **kw)

    return factory


def run_human(args) -> None:
    from hosnerf_tpu_torch.config import yamlcfg
    from hosnerf_tpu_torch.data.human_dataset import HumanDataset
    from hosnerf_tpu_torch.eval import renderers
    from hosnerf_tpu_torch.train import checkpoints as ck
    from hosnerf_tpu_torch.train import loop, stage2

    device = _device(args)
    cfg_yaml = yamlcfg.make_cfg(args.cfg, args.default_cfg)
    logdir = _logdir(args)
    datadir = _capture_dir(cfg_yaml.get("basedir", "."), args.scene_name)
    sizes = _human_sizes(cfg_yaml)
    vol_size = sizes["mweight_volume_size"]
    ds = HumanDataset(datadir, mode="train", n_patches=sizes["n_patches"],
                      patch_size=sizes["patch_size"],
                      mweight_volume_size=vol_size, seed=args.seed)
    num_states = (len(ds.transitions) + 1
                  if ds.transitions is not None else 1)
    train_y = cfg_yaml.get("train", {})
    max_steps = args.max_steps or int(train_y.get("maxiter", 400_000))
    cfg = stage2.Stage2Config(
        maxiter=max_steps, lr=float(train_y.get("lr", 0.0006667)),
        num_states=num_states, **sizes,
        compute_dtype=_resolve_cdt(cfg_yaml.get("compute_dtype"), device))

    model, opt = stage2.init_state(cfg, seed=args.seed, device=device)
    models = {"human": model}
    lp, lp_backbone = _load_lpips(args, cfg.patch_size, device)

    start_step, loop_gen = 0, _loop_generator(args)
    if args.ckpt_path and args.ckpt_path.endswith(".ckpt"):
        ck.overlay_params(model, ck.import_human_params(args.ckpt_path))
    elif args.resume_training or args.ckpt_path:
        start_step = ck.restore_train_state(
            os.path.join(logdir, "ckpt"), args.ckpt_path or "last", models,
            opt, loop_gen)

    trans = (torch.as_tensor(ds.transitions, dtype=torch.float32)
             if ds.transitions is not None else None)
    render_fn = mesh.shard_eval_fn(renderers.make_render_fn(model, trans))

    if args.run_mode == "train":
        # in-training progress eval + empty-render trap
        # (ref: 2nd model.py:495-564,600-603)
        prog_ds = HumanDataset(datadir, mode="progress",
                               mweight_volume_size=vol_size, seed=args.seed)
        lp_metric = _lpips_metric(lp)

        def progress_fn(step):
            return renderers.evaluate_human(
                render_fn, prog_ds, logdir, f"prog_{step:06d}",
                lpips_metric=lp_metric, max_items=4, device=device)

        loop.run_training(
            num_steps=max_steps, sample_batch=_make_batch(ds, device),
            step_fn=stage2.make_train_step(cfg, model, opt, ds.transitions,
                                           lp),
            models=models, optimizer=opt, logdir=logdir,
            rays_per_step=cfg.n_patches * cfg.patch_size ** 2,
            generator=loop_gen, start_step=start_step,
            progress_fn=progress_fn,
            progress_every=int(cfg_yaml.get("progress", {}).get(
                "dump_interval", 5000)))
    else:
        # ref 2nd tpose.py:29 renders 1024^2
        _eval_or_render(args, cfg_yaml, render_fn,
                        _factory(cfg_yaml, datadir, vol_size), logdir,
                        device, ds.transitions, lp, lp_backbone, 1024)


def run_hosnerf(args) -> None:
    from hosnerf_tpu_torch.config import ginlite, yamlcfg
    from hosnerf_tpu_torch.data.human_dataset import HumanDataset
    from hosnerf_tpu_torch.eval import renderers
    from hosnerf_tpu_torch.train import checkpoints as ck
    from hosnerf_tpu_torch.train import loop, stage3

    device = _device(args)
    gin = ginlite.parse_config_files_and_bindings(args.ginc, args.ginb)
    cfg_yaml = yamlcfg.make_cfg(args.cfg, args.default_cfg)
    logdir = _logdir(args)
    datadir = _capture_dir(
        cfg_yaml.get("basedir", ginlite.scoped(gin, "run").get(
            "datadir", ".")), args.scene_name)
    sizes = _human_sizes(cfg_yaml)
    vol_size = sizes["mweight_volume_size"]
    ds = HumanDataset(datadir, mode="train", use_scaleworld=True,
                      n_patches=sizes["n_patches"],
                      patch_size=sizes["patch_size"],
                      mweight_volume_size=vol_size, seed=args.seed)
    num_states = (len(ds.transitions) + 1
                  if ds.transitions is not None else 1)
    train_y = cfg_yaml.get("train", {})
    max_steps = args.max_steps or int(train_y.get("maxiter", 200_000))
    cfg = stage3.Stage3Config(
        maxiter=max_steps, num_states=num_states, **sizes,
        near_bkg=float(gin.get("LitDataHumanObject.near_bkg", 0.1)),
        far_bkg=float(gin.get("LitDataHumanObject.far_bkg", 1e6)),
        nerf_netwidth=int(gin.get("NeRFMLP.netwidth", 1024)),
        prop_netwidth=int(gin.get("PropMLP.netwidth", 256)),
        num_prop_samples=int(gin.get("MipNeRF360.num_prop_samples", 64)),
        num_nerf_samples=int(gin.get("MipNeRF360.num_nerf_samples", 32)),
        compute_dtype=_resolve_cdt(
            cfg_yaml.get("compute_dtype",
                         gin.get("MipNeRF360.compute_dtype")), device))

    scene, human, opt = stage3.init_state(cfg, seed=args.seed, device=device)
    models = {"scene": scene, "human": human}
    # two-checkpoint warm start (ref: 3rd run.py:205-212); each path may
    # be a reference Lightning .ckpt or one of the port's checkpoints
    if args.human_path:
        ck.overlay_params(human, ck.load_stage_params(args.human_path,
                                                      "human"))
    if args.bkgd_path:
        ck.overlay_params(scene, ck.load_stage_params(args.bkgd_path,
                                                      "scene"))

    start_step, loop_gen = 0, _loop_generator(args)
    if args.resume_training or args.ckpt_path:
        start_step = ck.restore_train_state(
            os.path.join(logdir, "ckpt"), args.ckpt_path or "last", models,
            opt, loop_gen)

    # the lpips patch loss is stage 3's largest term (w_lpips=1.0,
    # ref 3rd model.py:892-906), wired as in stage 2
    lp, lp_backbone = _load_lpips(args, cfg.patch_size, device)
    trans = (torch.as_tensor(ds.transitions, dtype=torch.float32)
             if ds.transitions is not None else None)
    render_fn = mesh.shard_eval_fn(
        renderers.make_composed_render_fn(cfg, scene, human, trans))
    extra = ("newsmpl_to_scale_world",)

    if args.run_mode == "train":
        prog_ds = HumanDataset(datadir, mode="progress",
                               use_scaleworld=True,
                               mweight_volume_size=vol_size, seed=args.seed)
        lp_metric = _lpips_metric(lp)

        def progress_fn(step):
            return renderers.evaluate_human(
                render_fn, prog_ds, logdir, f"prog_{step:06d}",
                lpips_metric=lp_metric, max_items=4, extra_keys=extra,
                device=device)

        loop.run_training(
            num_steps=max_steps, sample_batch=_make_batch(ds, device),
            step_fn=stage3.make_train_step(cfg, scene, human, opt,
                                           ds.transitions, lp),
            models=models, optimizer=opt, logdir=logdir,
            rays_per_step=cfg.n_patches * cfg.patch_size ** 2,
            generator=loop_gen, start_step=start_step,
            progress_fn=progress_fn,
            progress_every=int(cfg_yaml.get("progress", {}).get(
                "dump_interval", 5000)))
    else:
        # the canonical pose with the human model alone (ref: 3rd
        # test_tpose), at 512^2 (ref 3rd tpose.py:29)
        _eval_or_render(args, cfg_yaml, render_fn,
                        _factory(cfg_yaml, datadir, vol_size,
                                 use_scaleworld=True), logdir, device,
                        ds.transitions, lp, lp_backbone, 512,
                        extra_keys=extra,
                        tpose_render_fn=mesh.shard_eval_fn(
                            renderers.make_render_fn(human, trans)))


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    from hosnerf_tpu_torch.train import loop
    loop.set_reproducible()
    distributed.initialize(device=args.device)   # no-op for one process
    try:
        if args.stage == "scene":
            run_scene(args)
        elif args.stage == "human":
            run_human(args)
        else:
            run_hosnerf(args)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
