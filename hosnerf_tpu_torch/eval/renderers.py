"""Chunked full-image rendering of the human field (counterpart of
`hosnerf_tpu/eval/renderers.py::render_human_image` and of the stage-2
`render_fn` of `hosnerf_tpu/cli/run.py`)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from hosnerf_tpu_torch.models.state import state_index

HUMAN_SHARED_KEYS = (
    "dst_Rs", "dst_Ts", "dst_posevec", "cnl_gtfms", "motion_weights_priors",
    "cnl_bbox_min_xyz", "cnl_bbox_scale_xyz", "bgcolor",
)
HUMAN_RAY_KEYS = ("rays_o", "rays_d", "near", "far")
RENDER_ITER = 10 ** 7   # the iteration the render path evaluates at


def make_render_fn(model, transitions: Optional[torch.Tensor] = None
                   ) -> Callable:
    """render_fn(chunk_batch) -> rgb [chunk, 3]: the model at
    iter_val = 10**7 with the state of the batch's time (state 0 without
    a time), is_train=False, without autograd."""

    def render_fn(b: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "time" in b:
            s_idx = state_index(b["time"], transitions)
        else:
            s_idx = torch.zeros((), dtype=torch.int32)
        with torch.no_grad():
            return model(b, RENDER_ITER, s_idx, is_train=False)["rgb"]

    return render_fn


def _pad_chunk(arr: np.ndarray, start: int, chunk: int) -> np.ndarray:
    end = min(start + chunk, arr.shape[0])
    out = arr[start:end]
    if end - start < chunk:
        pad = np.repeat(out[:1], chunk - (end - start), axis=0)
        out = np.concatenate([out, pad], 0)
    return out


def render_human_image(render_fn: Callable, item: Dict, device,
                       chunk: int = 8192) -> np.ndarray:
    """Full-image render over the dense pixel grid, `chunk` rays at a time
    (the last chunk padded by repeating its first ray).
    item: numpy arrays with img_height/img_width and the ray keys."""
    h, w = item["img_height"], item["img_width"]
    n = item["rays_o"].shape[0]
    shared = {k: torch.as_tensor(np.asarray(item[k]), device=device)
              for k in HUMAN_SHARED_KEYS + ("time",) if k in item}
    outs = []
    for s in range(0, n, chunk):
        cb = dict(shared)
        for k in HUMAN_RAY_KEYS:
            cb[k] = torch.as_tensor(_pad_chunk(item[k], s, chunk),
                                    device=device)
        rgb = render_fn(cb)
        outs.append(rgb[: min(chunk, n - s)].float().cpu().numpy())
    return np.concatenate(outs).reshape(int(h), int(w), 3)
