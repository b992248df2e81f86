"""Checkpoints: the port's own train-state files with the reference's
best/last semantics, and torch Lightning `.ckpt` import and export
(counterpart of `hosnerf_tpu/train/checkpoints.py`).

A checkpoint is one `torch.save` file, `<ckpt_dir>/<name>.pt`, that
`torch.load(weights_only=True)` reads:

  {"models": {"scene" | "human": state_dict}, "optimizer": state_dict,
   "updates": opt.updates, "step": next step, "generator": its state}

so a resumed run continues the learning-rate schedules, Adam's moments
and step counts, and the loop's jitter draws where they left off. The
port's modules use the reference's torch keys, so a Lightning `.ckpt`
is a state_dict under a prefix ("model." for the scene, "human." for the
human field): importing strips it, exporting adds it.

ref: ModelCheckpoint(monitor='val/psnr', filename='best', save_top_k=1,
save_last=True) (1st.../run.py:124-131); stage-3 warm start loads the
human ckpt then the bkgd ckpt with strict=False (3rd.../run.py:205-212).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# native checkpoints
# ---------------------------------------------------------------------------


def checkpoint_path(ckpt_dir: str, name: str) -> str:
    """<ckpt_dir>/<name>.pt; a name that is a path (absolute, or ending
    in .pt) is taken as one."""
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    return path if path.endswith(".pt") else path + ".pt"


def save_checkpoint(ckpt_dir: str, name: str, state: Dict[str, Any]) -> str:
    """Write `state` to <ckpt_dir>/<name>.pt (replacing it whole: written
    to a temporary file first)."""
    path = checkpoint_path(ckpt_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, name: str) -> Dict[str, Any]:
    """The state saved under `name`, its tensors on the CPU."""
    return torch.load(checkpoint_path(ckpt_dir, name), map_location="cpu",
                      weights_only=True)


class BestLastCheckpointer:
    """Reference semantics: always refresh 'last'; keep the single 'best'
    by monitored value (val/psnr, higher is better). The best value
    persists in best_value.json so the monitor survives
    --resume_training (Lightning stores it inside the .ckpt)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._best_path = os.path.join(ckpt_dir, "best_value.json")
        self.best_value = -np.inf
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                self.best_value = float(json.load(f)["best_value"])

    def save_last(self, state: Dict[str, Any]) -> str:
        return save_checkpoint(self.ckpt_dir, "last", state)

    def maybe_save_best(self, state: Dict[str, Any],
                        monitored: float) -> Optional[str]:
        if monitored > self.best_value:
            self.best_value = monitored
            path = save_checkpoint(self.ckpt_dir, "best", state)
            with open(self._best_path, "w") as f:
                json.dump({"best_value": float(monitored)}, f)
            return path
        return None


# ---------------------------------------------------------------------------
# full train state (true resume)
# ---------------------------------------------------------------------------

def pack_train_state(models: Dict[str, torch.nn.Module],
                     optimizer: Optional[torch.optim.Optimizer], step: int,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, Any]:
    """The checkpointable train state: each model's state_dict, the
    optimizer's (Adam's moments and per-parameter step counts) and its
    update count `opt.updates`, the step to resume from and the loop
    generator's state."""
    state: Dict[str, Any] = {
        "models": {k: m.state_dict() for k, m in models.items()},
        "step": int(step)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
        state["updates"] = int(getattr(optimizer, "updates", 0))
    if generator is not None:
        state["generator"] = generator.get_state()
    return state


def restore_train_state(ckpt_dir: str, name: str,
                        models: Dict[str, torch.nn.Module],
                        optimizer: Optional[torch.optim.Optimizer] = None,
                        generator: Optional[torch.Generator] = None) -> int:
    """Load what `pack_train_state` saved under `name` into the models
    (strict), the optimizer (with `opt.updates`) and the generator, in
    place. Returns the step to resume from."""
    state = restore_checkpoint(ckpt_dir, name)
    for k, m in models.items():
        m.load_state_dict(state["models"][k], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
        optimizer.updates = int(state["updates"])
    if generator is not None:
        generator.set_state(state["generator"])
    return int(state["step"])


def load_stage_params(path: str, which: str) -> Dict[str, torch.Tensor]:
    """A state_dict for the scene or the human field (which: 'scene' |
    'human') from either a reference torch Lightning `.ckpt` or one of the
    port's own checkpoints (e.g. `<logdir>/ckpt/last.pt` of a stage-1,
    stage-2 or stage-3 run), so stages trained here warm-start stage 3
    (ref 3rd run.py:205-212 loads the two stage ckpts)."""
    if path.endswith(".ckpt"):
        return (import_scene_params(path) if which == "scene"
                else import_human_params(path))
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state["models"][which]


# ---------------------------------------------------------------------------
# torch Lightning .ckpt import and export
# ---------------------------------------------------------------------------

def _load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob.get("state_dict", blob)


def _strip(sd: Dict[str, torch.Tensor], prefix: str
           ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def import_scene_params(path: str, prefix: str = "model."
                        ) -> Dict[str, torch.Tensor]:
    """Stage-1 Lightning ckpt -> the SceneField state_dict entries it
    holds (`mlps.{i}.*`)."""
    return _strip(_load_torch_state_dict(path), prefix)


def import_human_params(path: str, prefix: str = "human."
                        ) -> Dict[str, torch.Tensor]:
    """Stage-2/3 Lightning ckpt -> the HumanObjectField state_dict entries
    it holds."""
    return _strip(_load_torch_state_dict(path), prefix)


def overlay_params(module: torch.nn.Module,
                   imported: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """strict=False load: each of the module's entries that `imported`
    holds is replaced by it (a shape mismatch raises ValueError), the
    others stay; imported keys the module lacks are ignored. In place;
    returns the module."""
    merged = module.state_dict()
    for k, v in merged.items():
        if k in imported:
            if tuple(imported[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"shape mismatch importing checkpoint: {k} "
                    f"{tuple(imported[k].shape)} vs {tuple(v.shape)}")
            merged[k] = imported[k]
    module.load_state_dict(merged, strict=True)
    return module


def _export(module: torch.nn.Module, prefix: str
            ) -> Dict[str, torch.Tensor]:
    return {prefix + k: v.detach().float().cpu().contiguous()
            for k, v in module.state_dict().items()}


def export_scene_params(module: torch.nn.Module, prefix: str = "model."
                        ) -> Dict[str, torch.Tensor]:
    """SceneField -> Lightning-style state_dict (reference key naming,
    f32 CPU tensors)."""
    return _export(module, prefix)


def export_human_params(module: torch.nn.Module, prefix: str = "human."
                        ) -> Dict[str, torch.Tensor]:
    """HumanObjectField -> Lightning-style state_dict."""
    return _export(module, prefix)


def save_torch_ckpt(path: str, state_dict: Dict[str, Any]) -> str:
    """Write a Lightning-compatible .ckpt: {"state_dict": tensors}."""
    torch.save({"state_dict": {k: torch.as_tensor(v)
                               for k, v in state_dict.items()}}, path)
    return path
