"""The benchmark's own analytic counts: the model FLOPs a training step
needs and each hand-written kernel's operations and bytes, from the
configuration's shapes and the benchmark's own support test on the
inputs it hands over. Nothing is read from the program, so a step counts
the same whether the port runs a hand-written kernel or a library op.

Needed work only: forward and backward (input and weight gradients) of
every trained product, the forward alone where no gradient is taken (the
stage-3 step's proposal MLPs, whose samples are detached and which take
no loss; LPIPS, whose weights are fixed: forward of both images and the
input gradient of the rendered one); no recomputation (the trunk
kernels' backward recomputes its forward: not counted) and no one-hot
products (the TPU's LBS form: the Hopper kernels compute taps and
blends, counted per live (sample, bone) pair).

Peaks (NVIDIA H100 SXM data sheet, dense): 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s HBM. The LBS
kernels' operations are f32 on the CUDA cores (`chip_smoke.py`'s bound
arithmetic, copied): they are held to the f32 rate.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from hosbench.specs import VGG_PLAN

BF16_PEAK, F32_PEAK, HBM_BPS = 989e12, 67e12, 3.35e12

# f32 operations of the LBS kernels (chip_smoke.py / the port's bench.py
# OPS_*): B1 / B4 per live (sample, bone) pair; B5 forward / backward per
# (live sample, bone) at two transform sets
OPS_B1_PAIR, OPS_B4_PAIR = 75, 250
OPS_B5F_BONE, OPS_B5B_BONE = 68, 166
PG_EPS = 1e-5


def macs(shapes: Dict[str, Tuple[int, ...]], prefix: str) -> int:
    """Multiply-adds per row of the 2-D weights under `prefix`."""
    return sum(math.prod(s) for k, s in shapes.items()
               if k.startswith(prefix) and k.endswith(".weight")
               and len(s) == 2)


def decoder_macs(shapes, prefix: str) -> int:
    """The weight-volume decoder on its constant: the first linear and
    each transposed convolution (k=4, s=2) over its input voxels."""
    total = macs(shapes, prefix + ".block_mlp.")
    n = 0
    while f"{prefix}.block_conv.{2 * n}.weight" in shapes:
        total += math.prod(shapes[f"{prefix}.block_conv.{2 * n}.weight"]) \
            * (2 ** n) ** 3
        n += 1
    return total


def vgg_macs(shapes, prefix: str, size: int) -> int:
    """LPIPS's VGG16 on one size x size image (pooling after taps 1-4)."""
    total, j, s = 0, 0, size
    for item in VGG_PLAN:
        if item == "M":
            s //= 2
        elif item != "T":
            total += math.prod(shapes[f"{prefix}.vgg.conv_{j}.weight"]) * s * s
            j += 1
    return total


def scene_flops(shapes, rays: int, prop_samples: int, nerf_samples: int,
                prop_trained: bool) -> float:
    """The proposal MLPs (levels 0, 1) and the NeRF MLP (level 2):
    forward 2 x MACs a sample; a trained MLP 3x that."""
    prop = sum(macs(shapes, f"scene.mlps.{i}.") for i in (0, 1)) \
        * rays * prop_samples * 2.0
    nerf = macs(shapes, "scene.mlps.2.") * rays * nerf_samples * 2.0
    return prop * (3.0 if prop_trained else 1.0) + 3.0 * nerf


def trunk_macs(shapes) -> Tuple[int, int]:
    """(canonical, non-rigid) MACs a row of the human trunks."""
    return macs(shapes, "human.cnl_mlp."), macs(shapes,
                                                "human.non_rigid_mlp.")


def support(batch, u, m_sR, m_T, G: int):
    """(live samples, live (sample, bone) pairs) of one step: sample p
    supports bone b where every grid coordinate of its inverse transform
    lies in (-1, G) (the trilinear taps that are not zero), widened by
    PG_EPS. Samples are the step's jittered ones (u its draws [R, S])."""
    S = u.shape[1]
    t = torch.linspace(0.0, 1.0, S, device=u.device, dtype=torch.float32)
    z = batch["near"] * (1.0 - t)[None] + batch["far"] * t[None]
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    z = lower + (upper - lower) * u
    pts = (batch["rays_o"][:, None, :] + batch["rays_d"][:, None, :]
           * z[..., None]).reshape(-1, 3)
    scale = batch["cnl_bbox_scale_xyz"] * 0.5 * (G - 1)
    off = -batch["cnl_bbox_min_xyz"] * scale
    rg = m_sR * scale[None, :, None]
    tg = m_T * scale[None, :] + off[None, :]
    live = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    pairs = 0
    for b in range(rg.shape[0]):
        f = pts @ rg[b].T + tg[b]
        sup = torch.all((f > -1.0 - PG_EPS) & (f < G + PG_EPS), -1)
        live |= sup
        pairs += int(sup.sum())
    return int(live.sum()), pairs


def lbs_kernels(live: int, pairs: int, B: int, G: int) -> Dict[str, Tuple]:
    """{kernel: (f32 ops, bytes)} of B1, B4, B5 forward and backward: the
    operations per pair or per (live sample, bone); bytes each input read
    once and each output written once (points 12 B, accumulators 16 B,
    the f32 volume and its gradient 4 B a voxel per bone)."""
    vol = 4 * B * G ** 3
    return {
        "B1": (OPS_B1_PAIR * pairs, live * (12 + 16) + vol),
        "B4": (OPS_B4_PAIR * pairs, live * (12 + 16 + 12) + 2 * vol),
        "B5f": (OPS_B5F_BONE * live * B, live * (12 + 28) + vol),
        "B5b": (OPS_B5B_BONE * live * B, live * (12 + 28 + 12) + 2 * vol),
    }


def trunk_kernels(shapes, live: int) -> Dict[str, Tuple]:
    """{kernel: (bf16 ops, bytes)} of B2 (the forward trunks: canonical on
    the live rows, non-rigid on them three times) and B3 (their input and
    weight gradients, without the recomputed forward)."""
    cnl, nr = trunk_macs(shapes)
    fwd = 2.0 * (cnl * live + nr * 3 * live)
    wbytes = 2 * (cnl + 2 * nr)
    return {"B2": (fwd, live * (12 + 16) + 3 * live * (12 + 12) + wbytes),
            "B3": (2.0 * fwd, live * (12 + 16 + 12)
                   + 3 * live * (12 + 12 + 12) + 3 * wbytes)}


def roofline_s(f32_ops: float = 0.0, bf16_ops: float = 0.0,
               nbytes: float = 0.0) -> float:
    """The least time the card could take: the larger of the operations'
    time at their peaks and the bytes' at the HBM rate."""
    return max(f32_ops / F32_PEAK + bf16_ops / BF16_PEAK, nbytes / HBM_BPS)


def shapes_of(specs: Iterable) -> Dict[str, Tuple[int, ...]]:
    return {name: tuple(shape) for name, shape, _ in specs}
