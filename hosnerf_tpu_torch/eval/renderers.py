"""Renderers and evaluation sweeps for all three stages (counterpart of
`hosnerf_tpu/eval/renderers.py`, and of the stage-2 and stage-3
`render_fn`s of `hosnerf_tpu/cli/run.py`).

Stage 1 renders an image in fixed-size ray chunks through the trainer's
`eval_step(batch)`; stages 2 and 3 render each item of a HumanDataset
sweep chunk by chunk through `render_fn(chunk_batch)`. The port's models
hold their weights, so neither callable takes a params argument. Sweeps
score each image (PSNR, SSIM, optionally LPIPS) on the render device,
write PNGs and results*.json, and flag all-background renders (the
reference's empty-image trap). Under a process group every rank renders
(the render callables are `parallel/mesh.py::shard_eval_fn`-wrapped, so
each renders its block of every chunk and gets the whole chunk back) and
scores, and rank 0 alone writes the images, videos and results files.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hosnerf_tpu_torch.data import batches
from hosnerf_tpu_torch.data import rays as ray_gen
from hosnerf_tpu_torch.eval import io as eio
from hosnerf_tpu_torch.eval import metrics as M
from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.models.state import state_indexer
from hosnerf_tpu_torch.parallel import distributed

HUMAN_SHARED_KEYS = (
    "dst_Rs", "dst_Ts", "dst_posevec", "cnl_gtfms", "motion_weights_priors",
    "cnl_bbox_min_xyz", "cnl_bbox_scale_xyz", "bgcolor",
)
HUMAN_RAY_KEYS = ("rays_o", "rays_d", "near", "far")
BKG_RAY_KEYS = ("rays_o_bkg", "rays_d_bkg", "viewdirs_bkg", "radii")
RENDER_ITER = 10 ** 7   # the iteration the render path evaluates at


def make_render_fn(model, transitions: Optional[torch.Tensor] = None
                   ) -> Callable:
    """render_fn(chunk_batch) -> rgb [chunk, 3]: the model at
    iter_val = 10**7 with the state of the batch's time (state 0 without
    a time), is_train=False, without autograd."""
    state_of = state_indexer(transitions)

    def render_fn(b: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "time" in b:
            s_idx = state_of(b["time"])
        else:
            s_idx = torch.zeros((), dtype=torch.int32,
                                device=b["rays_o"].device)
        with torch.no_grad():
            return model(b, RENDER_ITER, s_idx, is_train=False)["rgb"]

    return render_fn


def make_composed_render_fn(cfg, scene, human,
                            transitions: Optional[torch.Tensor] = None
                            ) -> Callable:
    """render_fn(chunk_batch) -> rgb [chunk, 3] of the composed stage-3
    model (`train/stage3.py::composed_forward`) at iter_val = 10**7, the
    state of the batch's time (state 0 without one), is_train=False,
    without autograd. The chunk needs the background ray keys and
    newsmpl_to_scale_world (`render_human_image(..., extra_keys=
    ("newsmpl_to_scale_world",))`)."""
    from hosnerf_tpu_torch.train import stage3

    state_of = state_indexer(transitions)

    def render_fn(b: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "time" in b:
            s_idx = state_of(b["time"])
        else:
            s_idx = torch.zeros((), dtype=torch.int32,
                                device=b["rays_o"].device)
        with torch.no_grad():
            comp, _ = stage3.composed_forward(cfg, scene, human, b,
                                              RENDER_ITER, s_idx)
        return comp["rgb"]

    return render_fn


def render_human_image(render_fn: Callable, item: Dict, device,
                       chunk: int = 8192, extra_keys: tuple = ()
                       ) -> np.ndarray:
    """Full-image human (or composed) render over the dense pixel grid,
    `chunk` rays at a time (the last chunk shorter: nothing here compiles
    per shape, so it is not padded). item: numpy arrays with
    img_height/img_width, the ray keys (and the background ray keys,
    where present) and the shared keys, to which `extra_keys` adds
    more."""
    h, w = item["img_height"], item["img_width"]
    n = item["rays_o"].shape[0]
    shared = {k: torch.as_tensor(np.asarray(item[k]), device=device)
              for k in HUMAN_SHARED_KEYS + ("time",) + tuple(extra_keys)
              if k in item}
    ray_keys = [k for k in HUMAN_RAY_KEYS + BKG_RAY_KEYS if k in item]
    outs = []
    for s in range(0, n, chunk):
        cb = dict(shared)
        for k in ray_keys:
            cb[k] = torch.as_tensor(item[k][s:s + chunk], device=device)
        outs.append(render_fn(cb).float().cpu().numpy())
    return np.concatenate(outs).reshape(int(h), int(w), 3)


# ---------------------------------------------------------------------------
# stage 1: the scene
# ---------------------------------------------------------------------------

def render_scene_image(eval_step: Callable, pipe, image_idx: int,
                       chunk: int = 4096, device=None) -> np.ndarray:
    """Full-image stage-1 render, `chunk` rays at a time: eval_step(batch)
    -> rgb [rays, 3] on the pipeline's chunks, the last one cut to its
    valid rays (the pipeline pads it for the JAX package's fixed shapes).
    Returns [H, W, 3]."""
    device = resolve_device(device)
    h, w = pipe.scene.image_sizes[image_idx]
    outs = []
    for b in pipe.eval_image_batches(image_idx, chunk):
        n = b.pop("n_valid")
        rgb = eval_step(batches.to_device({k: v[:n] for k, v in b.items()},
                                          device))
        outs.append(rgb.float().cpu().numpy())
    return np.concatenate(outs).reshape(int(h), int(w), 3)


def _scores(rgb: np.ndarray, tgt: np.ndarray, device, lpips_metric,
            **ssim_kw):
    """(psnr, ssim, lpips or None) of one image against its target, on
    `device`."""
    a = torch.as_tensor(rgb, device=device, dtype=torch.float32)
    b = torch.as_tensor(np.asarray(tgt), device=device, dtype=torch.float32)
    return (float(M.psnr(a, b)), float(M.ssim(a, b, **ssim_kw)[0]),
            None if lpips_metric is None else float(lpips_metric(a, b)))


def evaluate_scene(eval_step, pipe, logdir: str, lpips_metric=None,
                   splits=("train", "val", "test"), chunk: int = 4096,
                   save_images: bool = True,
                   lpips_backbone: Optional[str] = None,
                   device=None) -> Dict:
    """Per-split mean PSNR/SSIM (gaussian window)/LPIPS, results.json
    ([psnr, ssim, lpips] by split, then {'lpips_backbone'} where LPIPS
    ran) and the test split's renders as render_model/*.png."""
    device = resolve_device(device)
    i_train, i_val, i_test, _ = pipe.scene.i_split
    split_ids = {"train": i_train, "val": i_val, "test": i_test}
    results = {m: {} for m in ("psnr", "ssim", "lpips")}
    if lpips_metric is not None:
        # top level, so the per-split lpips dict holds only float means
        results["lpips_backbone"] = lpips_backbone or "unknown"
    rendered_all = []
    for split in splits:
        psnrs, ssims, lpipss = [], [], []
        for i in split_ids[split]:
            rgb = render_scene_image(eval_step, pipe, int(i), chunk, device)
            p, s, lp = _scores(rgb, pipe.scene.images[int(i)], device,
                               lpips_metric)
            psnrs.append(p)
            ssims.append(s)
            if lp is not None:
                lpipss.append(lp)
            if split == "test":
                rendered_all.append(rgb)
        results["psnr"][split] = float(np.mean(psnrs)) if psnrs else None
        results["ssim"][split] = float(np.mean(ssims)) if ssims else None
        results["lpips"][split] = (float(np.mean(lpipss)) if lpipss
                                   else None)

    if not distributed.is_primary():
        return results
    os.makedirs(logdir, exist_ok=True)
    if save_images and rendered_all:
        eio.store_image(os.path.join(logdir, "render_model"), rendered_all)
    stats = [results["psnr"], results["ssim"], results["lpips"]]
    if "lpips_backbone" in results:
        stats.append({"lpips_backbone": results["lpips_backbone"]})
    eio.write_stats(os.path.join(logdir, "results.json"), *stats)
    return results


def render_scene_path(eval_step, pipe, logdir: str, chunk: int = 4096,
                      fps: int = 20, device=None) -> str:
    """The scene's interpolated camera path (`render_poses` at
    `render_times`), each frame in `chunk`-ray chunks, as
    render_video/images.mp4."""
    device = resolve_device(device)
    frames = []
    scene = pipe.scene
    h, w = scene.image_sizes[0]
    for pose, t in zip(scene.render_poses, scene.render_times):
        rays = ray_gen.image_rays(scene.intrinsics[0], pose, int(h), int(w))
        n = rays[0].shape[0]
        outs = []
        for s in range(0, n, chunk):
            b = {k: a[s:s + chunk] for k, a in zip(
                ("rays_o", "rays_d", "viewdirs", "radii"), rays)}
            b["times"] = np.full((b["rays_o"].shape[0],), t, np.float32)
            outs.append(eval_step(batches.to_device(b, device))
                        .float().cpu().numpy())
        frames.append(np.concatenate(outs).reshape(int(h), int(w), 3))
    if not distributed.is_primary():
        return os.path.join(logdir, "render_video", "images.mp4")
    return eio.store_video(os.path.join(logdir, "render_video"), frames,
                           fps=fps)


# ---------------------------------------------------------------------------
# stages 2 and 3: HumanDataset sweeps
# ---------------------------------------------------------------------------

def evaluate_human(render_fn, dataset, logdir: str, tag: str,
                   lpips_metric=None, chunk: int = 8192,
                   extra_keys: tuple = (), max_items: Optional[int] = None,
                   save_images: bool = True,
                   lpips_backbone: Optional[str] = None,
                   device=None) -> Dict:
    """One sweep over a HumanDataset (progress, test or movement mode):
    each frame rendered and scored against its target (PSNR, SSIM with
    the uniform 7 window, LPIPS), [render | target] PNGs in <tag>_vis/,
    results_<tag>.json; `is_empty_img` where a render is background
    everywhere (within 5/255 of the item's bgcolor)."""
    device = resolve_device(device)
    psnrs, ssims, lpipss, images = [], [], [], []
    is_empty = False
    n = len(dataset) if max_items is None else min(max_items, len(dataset))
    for i in range(n):
        item = dataset[i]
        rgb = render_human_image(render_fn, item, device, chunk, extra_keys)
        bg = np.asarray(item["bgcolor"]) / 255.0
        if np.allclose(rgb, bg, atol=5.0 / 255.0):
            is_empty = True
        tgt = item["target_img"]
        p, s, lp = _scores(rgb, tgt, device, lpips_metric, kernel_size=7,
                           uniform_window=True)
        psnrs.append(p)
        ssims.append(s)
        if lp is not None:
            lpipss.append(lp)
        if save_images:
            images.append(np.concatenate(
                [eio.to_8b_image(rgb), eio.to_8b_image(tgt)], axis=1))
    primary = distributed.is_primary()
    if save_images and images and primary:
        os.makedirs(logdir, exist_ok=True)
        eio.store_image(os.path.join(logdir, f"{tag}_vis"), images)
    out = {
        "psnr": float(np.mean(psnrs)) if psnrs else None,
        "ssim": float(np.mean(ssims)) if ssims else None,
        "lpips": float(np.mean(lpipss)) if lpipss else None,
        "is_empty_img": is_empty,
    }
    if lpips_metric is not None:
        out["lpips_backbone"] = lpips_backbone or "unknown"
    if primary:
        eio.write_stats(os.path.join(logdir, f"results_{tag}.json"), out)
    return out


def full_human_eval(render_fn, dataset_factory, logdir: str,
                    transitions=None, lpips_metric=None, chunk: int = 8192,
                    extra_keys: tuple = (), tpose_resolution: int = 512,
                    freeview_frames: int = 100,
                    tpose_views: Optional[int] = None,
                    tpose_render_fn=None,
                    lpips_backbone: Optional[str] = None,
                    device=None) -> Dict:
    """The reference's test sweep: held-out test frames, all frames
    ('movement'), the freeview orbit and the canonical pose at each
    state's midpoint time; results.json holds [testimgs, allimgs].
    `dataset_factory(mode, **kw)` builds a HumanDataset; stage 3 renders
    the canonical pose with the human field alone (`tpose_render_fn`)."""
    results = {}
    for tag, mode in (("testimgs", "test"), ("allimgs", "movement")):
        results[tag] = evaluate_human(
            render_fn, dataset_factory(mode=mode), logdir, tag,
            lpips_metric, chunk, extra_keys, lpips_backbone=lpips_backbone,
            device=device)
    render_freeview(render_fn,
                    dataset_factory(mode="freeview",
                                    render_frames=freeview_frames),
                    logdir, chunk, extra_keys, device=device)
    tpose_kw = {"render_frames": tpose_views} if tpose_views else {}
    render_tpose(tpose_render_fn or render_fn,
                 dataset_factory(mode="tpose", **tpose_kw), logdir,
                 transitions=transitions, resolution=tpose_resolution,
                 n_views=tpose_views, chunk=chunk, device=device)
    if distributed.is_primary():
        eio.write_stats(os.path.join(logdir, "results.json"),
                        results["testimgs"], results["allimgs"])
    return results


def render_freeview(render_fn, dataset, logdir: str, chunk: int = 8192,
                    extra_keys: tuple = (), save_video: bool = True,
                    device=None) -> List[np.ndarray]:
    """The 360-degree orbit: every item of a freeview dataset, then
    freeview/images.mp4 (none for zero frames)."""
    device = resolve_device(device)
    frames = [render_human_image(render_fn, dataset[i], device, chunk,
                                 extra_keys) for i in range(len(dataset))]
    if save_video and frames and distributed.is_primary():
        eio.store_video(os.path.join(logdir, "freeview"), frames)
    return frames


def tpose_midpoint_times(transitions: Optional[np.ndarray]) -> List[float]:
    """The midpoint time of every state segment [0, t_1, .., 1]; [0.5]
    without transitions."""
    if transitions is None or len(transitions) == 0:
        return [0.5]
    edges = np.concatenate([[0.0], np.asarray(transitions), [1.0]])
    return [float((edges[i] + edges[i + 1]) / 2)
            for i in range(len(edges) - 1)]


def render_tpose(render_fn, dataset, logdir: str, transitions=None,
                 resolution: int = 512, n_views: Optional[int] = None,
                 chunk: int = 8192, device=None) -> List[np.ndarray]:
    """Canonical-pose turntable at each state's midpoint time: the
    dataset's `render_frames` views per state (`n_views` overrides), an
    mp4 per state of more than 8 views, and a contact sheet of up to 8
    views per state in tpose_vis/*.png."""
    device = resolve_device(device)
    primary = distributed.is_primary()
    frames = []
    per_state = n_views or getattr(dataset, "render_frames", 4)
    for si, t in enumerate(tpose_midpoint_times(transitions)):
        state_frames = []
        for v in range(per_state):
            item = dataset.get_tpose_item(v, resolution=resolution, time=t)
            state_frames.append(render_human_image(render_fn, item, device,
                                                   chunk))
        if len(state_frames) > 8:
            if primary:
                eio.store_video(os.path.join(logdir, f"tpose_state{si}"),
                                state_frames)
            step = max(len(state_frames) // 8, 1)
            frames.extend(state_frames[::step][:8])
        else:
            frames.extend(state_frames)
    if frames and primary:
        eio.store_image(os.path.join(logdir, "tpose_vis"), frames)
    return frames
