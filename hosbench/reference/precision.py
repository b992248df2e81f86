"""How the reference computes the parts that a configuration runs in bf16
on the card (the MLP trunks, the weight-volume decoder's convolutions,
the LBS volume taps).

'f32': as they are, in f32 (TF32 off). 'fp8': the control, one step below
bf16: each forward operand rounded to float8 e4m3 and each incoming
gradient to float8 e5m2, both at a per-tensor scale (the tensor's largest
magnitude maps to the format's largest value), the products in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2 on its way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _quant(t: torch.Tensor, dtype, top: float):
    """(t in `dtype` at a per-tensor scale, the scale)."""
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / top
    return (t.detach() / scale).to(dtype), scale


class _Fp8Linear(torch.autograd.Function):
    """x @ w.T on e4m3 operands, the incoming gradient in e5m2, products in
    f32; the operands are kept for the backward in their 8-bit form."""

    @staticmethod
    def forward(ctx, x, w):
        qx, sx = _quant(x, torch.float8_e4m3fn, E4M3_MAX)
        qw, sw = _quant(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qx, sx, qw, sw)
        return (qx.to(x.dtype) * sx) @ (qw.to(w.dtype) * sw).T

    @staticmethod
    def backward(ctx, g):
        qx, sx, qw, sw = ctx.saved_tensors
        g = _round(g, torch.float8_e5m2, E5M2_MAX)
        x = qx.float() * sx
        w = qw.float() * sw
        gx = g @ w
        gw = g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1])
        return gx, gw


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """t, or t rounded to e4m3 (the gradient passes straight)."""
        if self.name == "f32":
            return t
        return t + (_round(t, torch.float8_e4m3fn, E4M3_MAX) - t).detach()

    def result(self, t: torch.Tensor) -> torch.Tensor:
        """t; under fp8 its gradient is rounded to e5m2."""
        return t if self.name == "f32" else _GradRound.apply(t)

    def linear(self, x, weight, bias=None):
        y = (F.linear(x, weight) if self.name == "f32"
             else _Fp8Linear.apply(x, weight))
        return y if bias is None else y + bias

    def conv_transpose3d(self, x, weight, bias):
        y = self.result(F.conv_transpose3d(self.operand(x),
                                           self.operand(weight), None,
                                           stride=2, padding=1))
        return y + bias[None, :, None, None, None]


F32 = Precision("f32")
