"""Initialization helpers with the reference's (torch) semantics and the
compute-dtype and remat resolvers (counterpart of
`hosnerf_tpu/models/layers.py`).

Every initializer takes an explicit `torch.Generator`, so a model built
from a seed is the same on every run and device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def resolve_remat(spec) -> str:
    """Remat config spec -> 'none' | 'heavy' | 'all'. Accepts bools
    (False -> 'none', True -> 'all') or the strings. 'heavy' recomputes
    only a model's memory-dominant trunk in the backward (the human
    field's 8x256 canonical MLP); 'all' every per-sample MLP."""
    if isinstance(spec, str):
        key = spec.lower()
        if key in ("none", "heavy", "all"):
            return key
        raise ValueError(f"unknown remat mode {spec!r}")
    return "all" if spec else "none"


def resolve_compute_dtype(spec) -> Optional[torch.dtype]:
    """Config-surface dtype spec -> torch.bfloat16 or None (= f32).
    Accepts None, 'bf16'/'bfloat16', 'f32'/'float32'/'fp32' or a dtype."""
    if spec is None or isinstance(spec, torch.dtype):
        return None if spec == torch.float32 else spec
    key = spec.lower()
    if key in ("bf16", "bfloat16"):
        return torch.bfloat16
    if key in ("f32", "float32", "fp32"):
        return None
    raise ValueError(f"unknown compute_dtype {spec!r}")


def resolve_device(device) -> torch.device:
    """Where a model is built: the CUDA card unless the caller names a
    device (device='cpu' for the CPU). Raises where torch sees no card and
    none was named: nothing falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: hosnerf_tpu_torch builds its models on the "
                "card by default; pass device='cpu' to build on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    """In-place U(-bound, bound) drawn on the CPU from `gen`, then copied
    to t's device (the same numbers whatever the device)."""
    with torch.no_grad():
        vals = torch.rand(t.shape, generator=gen, dtype=torch.float32)
        t.copy_((vals * 2.0 - 1.0) * bound)
    return t


def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen, dtype=torch.float32)
                * std)
    return t


def xavier_uniform_gain(weight: torch.Tensor, gain: float,
                        gen: torch.Generator):
    """The reference's xavier_uniform_ with explicit gain for a Linear
    weight [out, in]: bound = gain * sqrt(6 / (fan_in + fan_out))."""
    fan_out, fan_in = weight.shape
    return uniform_(weight, gain * math.sqrt(6.0 / (fan_in + fan_out)), gen)


def small_uniform(weight: torch.Tensor, gen: torch.Generator,
                  bound: float = 1e-5):
    """U(-bound, bound); the reference's near-zero last-layer init."""
    return uniform_(weight, bound, gen)


def blockwise_transposed_conv_init(weight: torch.Tensor, gain: float,
                                   gen: torch.Generator):
    """xavier-uniform for a ConvTranspose3d weight [in, out, k, k, k] with
    the reference's blockwise tie: values constant over each 2x2x2 kernel
    cell, so the initial op is ~nearest-neighbour upsampling."""
    cin, cout, kd, kh, kw = weight.shape
    ksize_eff = kd * kh * kw // 8
    std = gain * math.sqrt(2.0 / ((cin + cout) * ksize_eff))
    hd, hh, hw = (kd + 1) // 2, (kh + 1) // 2, (kw + 1) // 2
    base = torch.empty((cin, cout, hd, hh, hw))
    uniform_(base, std * math.sqrt(3.0), gen)
    # each value over a 2x2x2 cell: one copy of the broadcast
    full = base[:, :, :, None, :, None, :, None].expand(
        cin, cout, hd, 2, hh, 2, hw, 2).reshape(
        cin, cout, 2 * hd, 2 * hh, 2 * hw)[:, :, :kd, :kh, :kw]
    with torch.no_grad():
        weight.copy_(full)
    return weight
