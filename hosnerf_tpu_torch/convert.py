"""JAX params -> this package's state_dicts, without importing jax.

Takes the nested dict of arrays that `HumanObjectField.init` produces in
the JAX package (leaves as numpy arrays, or anything `np.asarray` reads)
and emits the reference torch keys, the same mapping as
`hosnerf_tpu/train/checkpoints.py::export_human_params` with an empty
prefix: Dense kernels [din, dout] become Linear weights [dout, din];
DHWIO transposed-conv kernels become ConvTranspose3d weights
[in, out, k, k, k] with the spatial taps flipped (the JAX kernel is used
as a correlation over the dilated input, torch's as its transpose).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _dense(sd, key: str, node) -> None:
    sd[key + ".weight"] = np.ascontiguousarray(
        np.asarray(node["Dense_0"]["kernel"], np.float32).T)
    sd[key + ".bias"] = np.asarray(node["Dense_0"]["bias"], np.float32)


def _conv(kernel) -> np.ndarray:
    k = np.asarray(kernel, np.float32).transpose(3, 4, 0, 1, 2)
    return np.ascontiguousarray(np.flip(k, (2, 3, 4)))


def human_params_to_numpy(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX HumanObjectField params -> {reference key: float32 array}."""
    sd: Dict[str, np.ndarray] = {}
    cnl = params["cnl_mlp"]
    j = 0
    while f"linear_{j}" in cnl:
        _dense(sd, f"cnl_mlp.pts_linears.{2 * j}", cnl[f"linear_{j}"])
        j += 1
    _dense(sd, "cnl_mlp.output_linear.0", cnl["output"])

    for mod in ("non_rigid_mlp", "non_rigid_forward_mlp"):
        node = params[mod]
        j = 0
        while f"linear_{j}" in node:
            _dense(sd, f"{mod}.block_mlps.{2 * j}", node[f"linear_{j}"])
            j += 1
        _dense(sd, f"{mod}.block_mlps.{2 * j}", node["output"])

    pose = params["pose_decoder"]
    j = 0
    while f"trunk_{j}" in pose:
        _dense(sd, f"pose_decoder.block_mlps.{2 * j}", pose[f"trunk_{j}"])
        j += 1
    for torch_head, ours in (("block_mlps_dstR", "head_r"),
                             ("block_mlps_dstT", "head_t")):
        _dense(sd, f"pose_decoder.{torch_head}.0", pose[f"{ours}_0"])
        _dense(sd, f"pose_decoder.{torch_head}.2", pose[f"{ours}_out"])

    dec = params["mweight_vol_decoder"]
    sd["mweight_vol_decoder.const_embedding"] = np.asarray(
        dec["const_embedding"], np.float32)
    dd = dec["decoder"]
    _dense(sd, "mweight_vol_decoder.decoder.block_mlp.0", dd["block_mlp"])
    convs = sorted((k for k in dd if k.startswith("deconv_")
                    and k != "deconv_out"), key=lambda s: int(s.split("_")[1]))
    for n, name in enumerate(convs + ["deconv_out"]):
        base = f"mweight_vol_decoder.decoder.block_conv.{2 * n}"
        sd[base + ".weight"] = _conv(dd[name]["kernel"])
        sd[base + ".bias"] = np.asarray(dd[name]["bias"], np.float32)

    embeds = np.asarray(params["state_embeds"], np.float32)
    for k in range(embeds.shape[0]):
        sd[f"human_stateembeds.{k}"] = embeds[k]
    return sd


def human_state_dict(params: Dict[str, Any], device=None
                     ) -> Dict[str, torch.Tensor]:
    """The state_dict `HumanObjectField.load_state_dict(strict=True)`
    takes, built from JAX params."""
    return {k: torch.from_numpy(v.copy()).to(device)
            for k, v in human_params_to_numpy(params).items()}


def lpips_params_to_numpy(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX LPIPS params -> the port's `models/lpips.py::LPIPS` state_dict
    arrays: flax conv kernels HWIO -> OIHW, biases as they are, and the
    five lin heads `lin_i` [C]."""
    sd: Dict[str, np.ndarray] = {}
    for name, node in params["vgg"].items():
        sd[f"vgg.{name}.weight"] = np.ascontiguousarray(
            np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1))
        sd[f"vgg.{name}.bias"] = np.asarray(node["bias"], np.float32)
    for i in range(5):
        sd[f"lin_{i}"] = np.asarray(params[f"lin_{i}"], np.float32)
    return sd


def lpips_state_dict(params: Dict[str, Any], device=None
                     ) -> Dict[str, torch.Tensor]:
    """The state_dict `LPIPS.load_state_dict(strict=True)` takes, built
    from JAX LPIPS params."""
    return {k: torch.from_numpy(v.copy()).to(device)
            for k, v in lpips_params_to_numpy(params).items()}
