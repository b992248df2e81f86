"""Component networks of the human-object model (counterpart of
`hosnerf_tpu/models/human_components.py`).

Module and parameter names follow the reference torch checkpoint keys that
`hosnerf_tpu/train/checkpoints.py::export_human_params` emits, so a
converted JAX state_dict loads with `load_state_dict(strict=True)`:

  cnl_mlp.pts_linears.{2j}, cnl_mlp.output_linear.0
  non_rigid_mlp.block_mlps.{2j} (j < depth), .block_mlps.{2 depth} = head
  pose_decoder.block_mlps.{2j}, .block_mlps_dstR.{0,2}, .block_mlps_dstT.{0,2}
  mweight_vol_decoder.const_embedding, .decoder.block_mlp.0,
  .decoder.block_conv.{2n}

Every module is built on the CUDA card unless `device` names another
(device='cpu' for the CPU; no card and no device raises).

`compute_dtype=torch.bfloat16` runs the trunk matmuls on bf16 operands
(bf16 result, bias added in bf16) while parameters stay f32; the output
heads always run in f32.

The weight-volume decoder's transposed convolutions take one of two forms
(`deconv_impl`, the JAX package's HOSNERF_DECONV_IMPL): 'conv', cuDNN's
`conv_transpose3d`, and 'phase', the JAX `ConvTranspose3dTorch` phase
decomposition: eight products [N^3, 8 cin] @ [8 cin, cout] per layer over
shifted views of the input. 'conv' is the default.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hosnerf_tpu_torch.core.body import rodrigues
from hosnerf_tpu_torch.models.layers import (blockwise_transposed_conv_init,
                                             normal_, resolve_device,
                                             small_uniform,
                                             xavier_uniform_gain)

RELU_GAIN = math.sqrt(2.0)
LEAKY02_GAIN = math.sqrt(2.0 / (1.0 + 0.2 ** 2))


def _linear(din: int, dout: int, gain: Optional[float],
            gen: torch.Generator, device) -> nn.Linear:
    """Linear with xavier(gain) weights (None = U(+-1e-5)) and zero bias."""
    lin = nn.Linear(din, dout, device=device)
    if gain is None:
        small_uniform(lin.weight, gen)
    else:
        xavier_uniform_gain(lin.weight, gain, gen)
    nn.init.zeros_(lin.bias)
    return lin


def linear_cdt(x: torch.Tensor, lin: nn.Linear,
               cdt: Optional[torch.dtype]) -> torch.Tensor:
    """`lin(x)` in the compute dtype: bf16 operands, bf16 product, bias
    added in bf16 (the flax Dense(dtype=bf16) semantics); f32 otherwise."""
    if cdt is None:
        return F.linear(x, lin.weight, lin.bias)
    y = F.linear(x.to(cdt), lin.weight.to(cdt))
    return y + lin.bias.to(cdt)


def _relu_stack(depth: int, din_of, width: int, gen, device) -> nn.ModuleList:
    """[Linear, ReLU] * depth with reference indices (Linear at 2j)."""
    mods = []
    for i in range(depth):
        mods += [_linear(din_of(i), width, RELU_GAIN, gen, device), nn.ReLU()]
    return nn.ModuleList(mods)


class CanonicalMLP(nn.Module):
    """Canonical rgb+sigma MLP, depth x width; the full input is
    re-concatenated [input, h] before linear `skip + 1` (the reference
    counts its skips over layers 2..depth)."""

    def __init__(self, input_ch: int, mlp_depth: int = 8,
                 mlp_width: int = 256, skips: Sequence[int] = (4,),
                 compute_dtype: Optional[torch.dtype] = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.mlp_depth = mlp_depth
        self.skips = tuple(skips)
        self.compute_dtype = compute_dtype

        def din(i):
            if i == 0:
                return input_ch
            return mlp_width + (input_ch if (i - 1) in self.skips else 0)

        self.pts_linears = _relu_stack(mlp_depth, din, mlp_width, generator,
                                       device)
        self.output_linear = nn.Sequential(
            _linear(mlp_width, 4, 1.0, generator, device))

    def layer(self, i: int) -> nn.Linear:
        return self.pts_linears[2 * i]

    def head(self) -> nn.Linear:
        return self.output_linear[0]

    def forward(self, pos_embed: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        if cdt is not None:
            pos_embed = pos_embed.to(cdt)
        h = pos_embed
        for i in range(self.mlp_depth):
            if i > 0 and (i - 1) in self.skips:
                h = torch.cat([pos_embed, h], dim=-1)
            h = torch.relu(linear_cdt(h, self.layer(i), cdt))
        return self.head()(h.float())


class NonRigidMLP(nn.Module):
    """Non-rigid offset MLP: input [condition_code, pos_embed]; skip layers
    re-concat [h, pos_embed]; head init U(+-1e-5)."""

    def __init__(self, pos_embed_size: int, condition_code_size: int = 75,
                 mlp_depth: int = 6, mlp_width: int = 128,
                 skips: Sequence[int] = (4,),
                 compute_dtype: Optional[torch.dtype] = None, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.mlp_depth = mlp_depth
        self.skips = tuple(skips)
        self.compute_dtype = compute_dtype

        def din(i):
            if i == 0:
                return condition_code_size + pos_embed_size
            return mlp_width + (pos_embed_size if i in self.skips else 0)

        mods = list(_relu_stack(mlp_depth, din, mlp_width, generator, device))
        mods.append(_linear(mlp_width, 3, None, generator, device))
        self.block_mlps = nn.ModuleList(mods)

    def layer(self, i: int) -> nn.Linear:
        return self.block_mlps[2 * i]

    def head(self) -> nn.Linear:
        return self.block_mlps[2 * self.mlp_depth]

    def forward(self, pos_embed, pos_xyz, condition_code):
        cdt = self.compute_dtype
        if cdt is not None:
            pos_embed = pos_embed.to(cdt)
            condition_code = condition_code.to(cdt)
        h = torch.cat([condition_code, pos_embed], dim=-1)
        for i in range(self.mlp_depth):
            if i in self.skips and i > 0:
                h = torch.cat([h, pos_embed], dim=-1)
            h = torch.relu(linear_cdt(h, self.layer(i), cdt))
        trans = self.head()(h.float())
        return {"xyz": pos_xyz + trans, "offsets": trans}


class BodyPoseRefiner(nn.Module):
    """posevec -> shared trunk -> (delta R via Rodrigues, delta T) for
    total_bones - 1 refined bones."""

    def __init__(self, embedding_size: int = 75, total_bones: int = 26,
                 mlp_width: int = 256, mlp_depth: int = 4, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.refined = total_bones - 1
        self.mlp_depth = mlp_depth
        trunk = []
        for i in range(mlp_depth - 1):
            trunk += [_linear(embedding_size if i == 0 else mlp_width,
                              mlp_width, RELU_GAIN, generator, device),
                      nn.ReLU()]
        self.block_mlps = nn.Sequential(*trunk)
        for name in ("block_mlps_dstR", "block_mlps_dstT"):
            setattr(self, name, nn.Sequential(
                _linear(mlp_width, mlp_width, RELU_GAIN, generator, device),
                nn.ReLU(),
                _linear(mlp_width, 3 * self.refined, None, generator,
                        device)))

    def forward(self, posevec):
        h = self.block_mlps(posevec)
        rvec = self.block_mlps_dstR(h)
        tvec = self.block_mlps_dstT(h)
        Rs = rodrigues(rvec.reshape(rvec.shape[:-1] + (self.refined, 3)))
        Ts = tvec.reshape(tvec.shape[:-1] + (self.refined, 3))
        return {"Rs": Rs, "Ts": Ts}


DECONV_IMPLS = ("conv", "phase")


def _conv_transpose(x: torch.Tensor, conv: nn.ConvTranspose3d,
                    cdt: Optional[torch.dtype]) -> torch.Tensor:
    """ConvTranspose3d(k=4, s=2, p=1) in the compute dtype: bf16 operands
    and bf16 result upcast before the f32 bias, as the JAX conv path."""
    if cdt is None:
        return conv(x)
    y = F.conv_transpose3d(x.to(cdt), conv.weight.to(cdt), None, stride=2,
                           padding=1)
    return y.float() + conv.bias[None, :, None, None, None]


def phase_weights(weight: torch.Tensor) -> torch.Tensor:
    """ConvTranspose3d weight [cin, cout, 4, 4, 4] -> the eight phase
    matrices [8, 8 cin, cout] of the JAX `ConvTranspose3dTorch`. The
    weight holds the JAX DHWIO kernel with its taps flipped
    (`convert._conv`), so the flip is undone first; then, as tap t = 2a + p
    per axis (shift a, phase p), one reshape and transpose to (pz, py, px,
    az, ay, ax, cin, cout)."""
    cin, cout = weight.shape[:2]
    k = weight.flip((2, 3, 4)).permute(2, 3, 4, 0, 1)
    k = k.reshape(2, 2, 2, 2, 2, 2, cin, cout)
    return k.permute(1, 3, 5, 0, 2, 4, 6, 7).reshape(8, 8 * cin, cout)


def _phase_products(lhs, rhs, cdt: Optional[torch.dtype]) -> torch.Tensor:
    """lhs [P, M, K] @ rhs [P, K, N] with an f32 result: f32 operands, or
    (cdt bf16) f32 products of bf16-rounded operands, what JAX's bf16
    einsum with preferred_element_type=f32 computes."""
    if cdt is None:
        return torch.bmm(lhs, rhs)
    return torch.bmm(lhs.to(cdt).float(), rhs.to(cdt).float())


def _phase_conv_transpose(x: torch.Tensor, conv: nn.ConvTranspose3d,
                          cdt: Optional[torch.dtype]) -> torch.Tensor:
    """The same ConvTranspose3d(k=4, s=2, p=1) on channels-last x [n, d,
    h, w, cin] -> [n, 2d, 2h, 2w, cout] as eight phase products (the JAX
    `ConvTranspose3dTorch`): per axis, output 2i + p reads the input padded
    by one at i + p + a, a in {0, 1}, against tap t = 2a + p. The shifted
    views are unfolds of the padded input (two taps a, then the two phases
    p, per axis), gathered by one copy into [8 phases, n d h w, (az, ay,
    ax, cin)], JAX's contraction order; the phases interleave into the
    output by one reshape and transpose; f32 bias last."""
    n, d, h, w, cin = x.shape
    cout = conv.weight.shape[1]
    v = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    for dim in (1, 2, 3):
        v = v.unfold(dim, 2, 1)            # shift a of each axis, appended
    for dim, size in ((1, d), (2, h), (3, w)):
        v = v.unfold(dim, size, 1)         # phase p of each axis in place
    # v [n, pz, py, px, cin, az, ay, ax, i, j, k] = xp[pz+i+az, py+j+ay,
    # px+k+ax]
    lhs = v.permute(1, 2, 3, 0, 8, 9, 10, 5, 6, 7, 4).reshape(
        8, n * d * h * w, 8 * cin)
    y = _phase_products(lhs, phase_weights(conv.weight), cdt)
    y = y.reshape(2, 2, 2, n, d, h, w, cout)
    y = y.permute(3, 4, 0, 5, 1, 6, 2, 7).reshape(n, 2 * d, 2 * h, 2 * w,
                                                  cout)
    return y + conv.bias


class ConvDecoder3D(nn.Module):
    """Embedding -> Linear(1024) -> stride-2 transposed convs ->
    [N, voxel_channels, vol, vol, vol] (channels first)."""

    def __init__(self, embedding_size: int = 256, volume_size: int = 32,
                 voxel_channels: int = 27,
                 compute_dtype: Optional[torch.dtype] = None,
                 deconv_impl: str = "conv", *,
                 generator: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        if deconv_impl not in DECONV_IMPLS:
            raise ValueError(f"unknown deconv_impl {deconv_impl!r}")
        self.compute_dtype = compute_dtype
        self.deconv_impl = deconv_impl
        self.block_mlp = nn.Sequential(
            _linear(embedding_size, 1024, LEAKY02_GAIN, generator, device))
        inch, outch = 1024, 512
        plan = []
        for _ in range(int(math.log2(volume_size)) - 1):
            plan.append((inch, outch))
            if inch == outch:
                outch = inch // 2
            else:
                inch = outch
        plan.append((plan[-1][1], voxel_channels))
        convs = []
        for n, (cin, cout) in enumerate(plan):
            conv = nn.ConvTranspose3d(cin, cout, 4, stride=2, padding=1,
                                      device=device)
            gain = 1.0 if n == len(plan) - 1 else LEAKY02_GAIN
            blockwise_transposed_conv_init(conv.weight, gain, generator)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            if n < len(plan) - 1:
                convs.append(nn.LeakyReLU(0.2))
        self.block_conv = nn.Sequential(*convs)

    def forward(self, embedding):
        h = F.leaky_relu(self.block_mlp(embedding), 0.2)
        if self.deconv_impl == "phase":
            h = h.reshape(h.shape[0], 1, 1, 1, 1024)
            for mod in self.block_conv:
                if isinstance(mod, nn.ConvTranspose3d):
                    h = _phase_conv_transpose(h, mod, self.compute_dtype)
                else:
                    h = mod(h)
            return h.permute(0, 4, 1, 2, 3).contiguous()
        h = h.reshape(h.shape[0], 1024, 1, 1, 1)
        for mod in self.block_conv:
            if isinstance(mod, nn.ConvTranspose3d):
                h = _conv_transpose(h, mod, self.compute_dtype)
            else:
                h = mod(h)
        return h


class MotionWeightVolumeDecoder(nn.Module):
    """Learnable 256-d constant -> ConvDecoder3D -> softmax(decoded +
    log(priors)) over channels: motion weight volume [B+1, G, G, G]."""

    def __init__(self, embedding_size: int = 256, volume_size: int = 32,
                 total_bones: int = 26,
                 compute_dtype: Optional[torch.dtype] = None,
                 deconv_impl: str = "conv", *,
                 generator: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.const_embedding = nn.Parameter(
            torch.empty(embedding_size, device=device))
        normal_(self.const_embedding, 1.0, generator)
        self.decoder = ConvDecoder3D(
            embedding_size, volume_size, total_bones + 1, compute_dtype,
            deconv_impl, generator=generator, device=device)
        self._decoded = None   # (weights' key, output) of `decoded`

    def decoded(self) -> torch.Tensor:
        """The decoder's output for the constant, [C, D, H, W]. It depends
        on the weights alone, so without autograd it is computed once per
        version of the weights and reused: a render's chunks and frames
        share it."""
        if torch.is_grad_enabled():
            return self.decoder(self.const_embedding[None])[0]
        key = (self.decoder.compute_dtype, self.decoder.deconv_impl,
               *((p.data_ptr(), p._version) for p in self.parameters()))
        if self._decoded is None or self._decoded[0] != key:
            self._decoded = (key, self.decoder(self.const_embedding[None])[0])
        return self._decoded[1]

    def forward(self, motion_weights_priors):
        return torch.softmax(self.decoded() + torch.log(motion_weights_priors),
                             dim=0)
