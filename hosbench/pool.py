"""The one traffic generator: a mix file (`hosbench/traffic/<mix>.json`)
names its kind and parameters, and this module turns it and a seed into a
pool of batches on the device. The timed loop cycles through the pool, so
steps see different frames, live fractions and sort orders.

Kinds:
  * "composed": frames of one synthetic capture (`synthetic.human_batch`'s
    skeleton; each frame its own pose, camera turned about the subject,
    rays, patches and targets), as stage-3 batches
    (`synthetic.composed_batch`'s keys);
  * "rays": scene ray batches (`synthetic.scene_ray_batch`), each its own
    rays and targets, each ray's time drawn from the mix's `times`.
The mix names its capture (`capture`): every seed trains on the same set
of batches, in its own order, so that the work of a run does not depend
on the seed (the share of live human samples moves a step's time). The
seed draws the order, the weights and every step's jitter generator
(`step_generator`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from hosbench import synthetic

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def jitter(i: int) -> torch.Generator:
    """Frozen copy of the port's `tools/common.py::jitter`: the CPU
    generator of timed call i."""
    return torch.Generator().manual_seed(1000 + i)


def step_seed(seed: int, i: int) -> int:
    """The jitter seed of step i of a run at `seed`: `jitter`'s 1000 + i,
    offset by the run's seed."""
    return (int(seed) * 1_000_003 + 1000 + i) % (2 ** 63)


def step_generator(seed: int, i: int, device="cpu") -> torch.Generator:
    return torch.Generator(device).manual_seed(step_seed(seed, i))


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


def composed_frames(mix: Dict, seed: int, grid_size: int,
                    total_bones: int = 26) -> List[Dict[str, np.ndarray]]:
    """`mix['pool']` stage-3 frames of one capture. The skeleton, bbox,
    priors and canonical transforms are `human_batch`'s at the seed; frame
    k draws its pose, rays, targets and flow from its own stream and turns
    the camera about the subject's vertical axis by an angle in
    [-turn, turn]. Each target patch has a colour of its own (uniform)
    under N(0, target_noise) pixel noise, as patches of a photograph
    differ: a loss over some of the patches is not the loss over all."""
    P, S = mix["n_patches"], mix["patch_size"]
    skel = synthetic.human_batch(1, 1, seed=seed % (2 ** 63),
                                 grid_size=grid_size,
                                 total_bones=total_bones)
    tpose_rng = np.random.default_rng(seed % (2 ** 63))
    parents = synthetic.parent_index_array(total_bones)
    tpose = np.zeros((total_bones, 3), np.float32)
    for j in range(1, total_bones):
        tpose[j] = tpose[parents[j]] + tpose_rng.normal(scale=0.08, size=3)
    tpose = np.clip(tpose, -0.45, 0.45).astype(np.float32)
    frames = []
    for k in range(mix["pool"]):
        rng = np.random.default_rng([seed % (2 ** 63), k])
        R = P * S * S

        def pose(scale):
            angles = rng.normal(scale=scale, size=(total_bones * 3,)
                                ).astype(np.float32)
            Rs, Ts = synthetic.body_pose_to_body_RTs(angles, tpose)
            return Rs, Ts, angles[3:]

        dst_Rs, dst_Ts, posevec = pose(mix["pose_scale"])
        p_Rs, p_Ts, p_posevec = pose(mix["pose_scale"])
        rot = _rot_y(rng.uniform(-mix["turn"], mix["turn"]))
        cam = rot @ np.array([0.0, 0.0, -3.0], np.float32)
        px = rng.uniform(-0.3, 0.3, size=(R, 2)).astype(np.float32)
        d = np.concatenate([px, np.ones((R, 1), np.float32)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = (d @ rot.T).astype(np.float32)
        f = {k2: skel[k2] for k2 in ("cnl_gtfms", "motion_weights_priors",
                                     "cnl_bbox_min_xyz",
                                     "cnl_bbox_scale_xyz", "bgcolor",
                                     "newsmpl_to_camera_prev",
                                     "intrinsics_prev")}
        f.update({
            "rays_o": np.broadcast_to(cam, (R, 3)).astype(np.float32).copy(),
            "rays_d": d,
            "near": np.full((R, 1), 2.2, np.float32),
            "far": np.full((R, 1), 3.8, np.float32),
            "dst_Rs": dst_Rs, "dst_Ts": dst_Ts, "dst_posevec": posevec,
            "dst_Rs_prev": p_Rs, "dst_Ts_prev": p_Ts,
            "dst_posevec_prev": p_posevec,
            "time": np.float32(mix["time"]),
            "target_patches": np.clip(
                rng.uniform(0, 1, (P, 1, 1, 3)) + mix["target_noise"]
                * rng.normal(size=(P, S, S, 3)), 0, 1).astype(np.float32),
            "patch_masks": np.ones((P, S, S), np.float32),
            "ray_grid": np.concatenate([
                rng.uniform(0, 64, (R, 2)), rng.normal(scale=1.0,
                                                       size=(R, 2)),
                np.ones((R, 1))], -1).astype(np.float32),
            "newsmpl_to_scale_world": np.eye(4, dtype=np.float32),
            "radii": np.full((R, 1), 0.002, np.float32),
        })
        f["rays_o_bkg"] = f["rays_o"].copy()
        f["rays_d_bkg"] = f["rays_d"].copy()
        f["viewdirs_bkg"] = f["rays_d"].copy()
        frames.append(f)
    return frames


def ray_batches(mix: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`mix['pool']` scene batches of `mix['n_rays']` rays; each ray's time
    one of `mix['times']`, drawn from the batch's stream."""
    out = []
    for k in range(mix["pool"]):
        s = (int(seed) * 7919 + k) % (2 ** 63)
        b = synthetic.scene_ray_batch(mix["n_rays"], seed=s)
        rng = np.random.default_rng([s, 1])
        b["times"] = rng.choice(np.asarray(mix["times"], np.float32),
                                size=mix["n_rays"]).astype(np.float32)
        out.append(b)
    return out


def frames(mix: Dict, seed: int, **sizes) -> List[Dict[str, np.ndarray]]:
    """The run's pool: the mix's capture (`mix['capture']`, the same set of
    batches for every seed, so that every run does the same work) in an
    order drawn from `seed`."""
    cap = mix["capture"]
    if mix["kind"] == "composed":
        batches = composed_frames(mix, cap, sizes["grid_size"],
                                  sizes.get("total_bones", 26))
    elif mix["kind"] == "rays":
        batches = ray_batches(mix, cap)
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    order = np.random.default_rng([int(seed) % (2 ** 63), 7]).permutation(
        len(batches))
    return [batches[k] for k in order]


def to_device(batches: List[Dict[str, np.ndarray]], device
              ) -> List[Dict[str, torch.Tensor]]:
    """The pool on the device; arrays equal across the pool (the
    capture's skeleton and priors) are moved once and shared."""
    shared: Dict[int, torch.Tensor] = {}
    out = []
    for b in batches:
        d = {}
        for k, v in b.items():
            key = id(v)
            if key not in shared:
                shared[key] = torch.as_tensor(np.asarray(v), device=device)
            d[k] = shared[key]
        out.append(d)
    return out
