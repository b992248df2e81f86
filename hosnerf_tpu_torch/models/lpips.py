"""LPIPS (VGG16 taps + five 1x1 'lin' heads) as an nn.Module, the stage-2
patch loss (counterpart of `hosnerf_tpu/models/lpips.py`).

The convolutions and pooling are PyTorch's (cuDNN on the card), as they
are XLA's outside Pallas in the JAX package. Inputs are NHWC in [-1, 1],
the JAX package's layout. The weight files (torchvision's vgg16 and the
reference's lin heads) are not in the repository: `load_weights` reads
them when given paths; without a VGG16 file the backbone keeps its
fixed-seed He init and a banner says so (KNOWN_GAPS #1).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hosnerf_tpu_torch.models.layers import resolve_device

VGG_TAPS = (64, 128, 256, 512, 512)
VGG_PLAN = [64, 64, "T", "M", 128, 128, "T", "M", 256, 256, 256, "T", "M",
            512, 512, 512, "T", "M", 512, 512, 512, "T"]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_BANNER = (
    "=" * 72 + "\n"
    "[lpips] WARNING: VGG16 backbone weights NOT provided - LPIPS runs on\n"
    "[lpips] FIXED-SEED RANDOM features. Training works; LPIPS *numbers*\n"
    "[lpips] are not comparable to published metric-grade LPIPS. Supply a\n"
    "[lpips] torchvision vgg16 .pth for metric parity.\n" + "=" * 72)


def backbone_provenance(vgg_path: Optional[str]) -> str:
    """'vgg16' (real torchvision weights) or 'random-fixed-seed'."""
    return ("vgg16" if vgg_path and os.path.exists(vgg_path)
            else "random-fixed-seed")


class LPIPS(nn.Module):
    """lpips(x, y) = sum_l mean_hw(lin_l((norm f_l(x) - norm f_l(y))^2)),
    [N] for NHWC inputs in [-1, 1] of at least 16 x 16."""

    def __init__(self, *, seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        convs, cin = {}, 3
        for item in VGG_PLAN:
            if isinstance(item, int):
                conv = nn.Conv2d(cin, item, 3, padding=1, device=device)
                with torch.no_grad():
                    std = math.sqrt(2.0 / (cin * 9))     # He normal
                    conv.weight.copy_(torch.randn(conv.weight.shape,
                                                  generator=gen) * std)
                    conv.bias.zero_()
                convs[f"conv_{len(convs)}"] = conv
                cin = item
        self.vgg = nn.ModuleDict(convs)
        for i, c in enumerate(VGG_TAPS):
            setattr(self, f"lin_{i}",
                    nn.Parameter(torch.ones(c, device=device)))
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device)
                             .reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device)
                             .reshape(1, 3, 1, 1), persistent=False)

    def features(self, x):
        taps, j = [], 0
        for item in VGG_PLAN:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            elif item == "T":
                taps.append(x)
            else:
                x = torch.relu(self.vgg[f"conv_{j}"](x))
                j += 1
        return taps

    def forward(self, x, y):
        if x.shape[1] < 16 or x.shape[2] < 16:
            raise ValueError(
                f"LPIPS needs inputs >= 16x16 (got {x.shape[1]}x"
                f"{x.shape[2]}): the 5th VGG tap has zero extent below it")
        fx = self.features((x.permute(0, 3, 1, 2) - self.shift) / self.scale)
        fy = self.features((y.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True),
                                min=1e-10)
            b = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True),
                                min=1e-10)
            contrib = torch.einsum("nchw,c->nhw", (a - b) ** 2,
                                   getattr(self, f"lin_{i}"))
            total = total + contrib.mean(dim=(1, 2))
        return total


def load_weights(model: LPIPS, lin_path: Optional[str] = None,
                 vgg_path: Optional[str] = None,
                 quiet: bool = False) -> LPIPS:
    """Overlay torch weight files: lin_path the reference's lin heads
    (`lin{i}.model.1.weight`), vgg_path a torchvision vgg16 state_dict
    (`features.*`). Without a VGG16 file, prints the random-backbone
    banner unless quiet."""
    if backbone_provenance(vgg_path) != "vgg16" and not quiet:
        print(_BANNER, flush=True)
    with torch.no_grad():
        if lin_path and os.path.exists(lin_path):
            sd = torch.load(lin_path, map_location="cpu")
            for i in range(5):
                getattr(model, f"lin_{i}").copy_(
                    sd[f"lin{i}.model.1.weight"].reshape(-1))
        if vgg_path and os.path.exists(vgg_path):
            sd = torch.load(vgg_path, map_location="cpu")
            idx = sorted({int(k.split(".")[1]) for k in sd
                          if k.startswith("features.")
                          and k.endswith(".weight")})
            for j, li in enumerate(idx):
                conv = model.vgg[f"conv_{j}"]
                conv.weight.copy_(sd[f"features.{li}.weight"])
                conv.bias.copy_(sd[f"features.{li}.bias"])
    return model
