"""Weights from a seed, made on the device in a few large draws.

A configuration lists its parameters as (name, shape, init) with the
port's initialisers written out as rules (a frozen copy: the port's
`models/layers.py`, `models/scene.py::_torch_linear`,
`models/human_components.py::_linear` and the LPIPS He init). `make`
draws every uniform parameter from one `torch.rand` and every normal one
from one `torch.randn` on one device generator, then scales each slice.
The same seed gives the same tensors; the program loads them, and the
reference takes its own f32 copy of the same dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

RELU_GAIN = math.sqrt(2.0)
LEAKY02_GAIN = math.sqrt(2.0 / (1.0 + 0.2 ** 2))

# init rules: ("u", bound) U(-bound, bound); ("n", std) N(0, std^2);
# ("c", value) a constant; ("last", value) zeros but the last entry;
# ("block", bound) the transposed convolutions'
# blockwise-tied U(-bound, bound), one value per 2x2x2 kernel cell
Spec = Tuple[str, Tuple[int, ...], Tuple]


def torch_linear(name: str, din: int, dout: int) -> List[Spec]:
    """The scene MLPs' TorchLinear init: kaiming-uniform weight
    U(+-sqrt(6 / din)), bias U(+-1 / sqrt(din))."""
    return [(f"{name}.weight", (dout, din), ("u", math.sqrt(6.0 / din))),
            (f"{name}.bias", (dout,), ("u", 1.0 / math.sqrt(din)))]


def xavier_linear(name: str, din: int, dout: int, gain) -> List[Spec]:
    """The human field's Linear: xavier-uniform weight with `gain` (None:
    U(+-1e-5)), zero bias."""
    bound = 1e-5 if gain is None else gain * math.sqrt(6.0 / (din + dout))
    return [(f"{name}.weight", (dout, din), ("u", bound)),
            (f"{name}.bias", (dout,), ("c", 0.0))]


def blockwise_conv(name: str, cin: int, cout: int, gain: float
                   ) -> List[Spec]:
    """ConvTranspose3d(k=4) with the reference's blockwise-tied xavier
    init (std gain * sqrt(2 / ((cin + cout) * 8))), zero bias."""
    std = gain * math.sqrt(2.0 / ((cin + cout) * 8))
    return [(f"{name}.weight", (cin, cout, 4, 4, 4),
             ("block", std * math.sqrt(3.0))),
            (f"{name}.bias", (cout,), ("c", 0.0))]


def make(specs: Sequence[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on `device`} for every spec, from `seed`."""
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    n_u = n_n = 0
    for _, shape, (kind, *_) in specs:
        if kind == "u":
            n_u += math.prod(shape)
        elif kind == "block":
            n_u += math.prod(shape) // 8
        elif kind == "n":
            n_n += math.prod(shape)
    u = torch.rand(n_u, generator=gen, device=device)
    g = torch.randn(n_n, generator=gen, device=device)
    out, ou, on = {}, 0, 0
    for name, shape, (kind, arg) in specs:
        if kind == "u":
            k = math.prod(shape)
            out[name] = ((u[ou:ou + k] * 2.0 - 1.0) * arg).reshape(shape)
            ou += k
        elif kind == "block":
            cin, cout, kd, kh, kw = shape
            k = cin * cout * 8
            base = ((u[ou:ou + k] * 2.0 - 1.0) * arg).reshape(
                cin, cout, kd // 2, 1, kh // 2, 1, kw // 2, 1)
            out[name] = base.expand(cin, cout, kd // 2, 2, kh // 2, 2,
                                    kw // 2, 2).reshape(shape).contiguous()
            ou += k
        elif kind == "n":
            k = math.prod(shape)
            out[name] = (g[on:on + k] * arg).reshape(shape)
            on += k
        elif kind == "c":
            out[name] = torch.full(shape, float(arg), device=device)
        elif kind == "last":
            out[name] = torch.zeros(shape, device=device)
            out[name][-1] = float(arg)
        else:
            raise ValueError(f"unknown init {kind!r} of {name}")
    return out


def sub(params: Dict[str, torch.Tensor], prefix: str
        ) -> Dict[str, torch.Tensor]:
    """The entries under `prefix.`, with the prefix stripped."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in params.items() if k.startswith(p)}


def load(module: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy `params` into the module's parameters and persistent buffers
    (every one named, no other)."""
    missing = set(module.state_dict()) ^ set(params)
    if missing:
        raise KeyError(f"weights and module differ in {sorted(missing)[:8]}")
    with torch.no_grad():
        for k, v in module.state_dict().items():
            v.copy_(params[k])
