"""The parameters of the port's models as (name, shape, init) lists, from
a configuration's sizes, with the port's initialisers as rules
(`hosbench/weights.py`). Names are the port's `state_dict()` keys under a
prefix ('scene.', 'human.', 'lpips.'), so the program loads them strictly
and the reference reads them by the same names."""

from __future__ import annotations

from typing import Dict, List

from hosbench import weights as W
from hosbench.reference import geopoly

STATE_EMBED, BOTTLENECK, VIEW_WIDTH, VIEW_IN = 64, 256, 128, 256 + 3 + 24
POSE_EMBED, COND = 75, 75
VGG_PLAN = [64, 64, "T", "M", 128, 128, "T", "M", 256, 256, 256, "T", "M",
            512, 512, 512, "T", "M", 512, 512, 512, "T"]
VGG_TAPS = (64, 128, 256, 512, 512)


def scene_in_dim() -> int:
    """MipMLP's input: the integrated PE of the icosahedron-2 basis over
    degrees 0-11, plus the 64-d state embedding."""
    n_basis = geopoly.generate_basis("icosahedron", 2).shape[1]
    return 2 * n_basis * 12 + STATE_EMBED


def skip_stack_dims(depth: int, din: int, width: int) -> List[int]:
    """Input widths of a scene trunk's layers (the stack's input joins
    after layer idx when idx % 4 == 0 and idx > 0), and its output width
    last."""
    dims, w = [], din
    for idx in range(depth):
        dims.append(w)
        w = width + din if idx % 4 == 0 and idx > 0 else width
    return dims + [w]


def scene_specs(prefix: str, s: Dict) -> List[W.Spec]:
    din = scene_in_dim()
    out = []
    levels = [(s["prop_netdepth"], s["prop_netwidth"], True)] * 2 + [
        (s["nerf_netdepth"], s["nerf_netwidth"], False)]
    for i, (depth, width, prop) in enumerate(levels):
        m = f"{prefix}.mlps.{i}"
        dims = skip_stack_dims(depth, din, width)
        for j in range(depth):
            out += W.torch_linear(f"{m}.pts_linear.{j}", dims[j], width)
        out += W.torch_linear(f"{m}.density_layer", dims[-1], 1)
        if not prop:
            out += W.torch_linear(f"{m}.bottleneck_layer", dims[-1],
                                  BOTTLENECK)
            out += W.torch_linear(f"{m}.views_linear.0", VIEW_IN, VIEW_WIDTH)
            out += W.torch_linear(f"{m}.rgb_layer", VIEW_WIDTH, 3)
        out += [(f"{m}.bkgd_stateembeds.{k}", (STATE_EMBED,), ("n", 1.0))
                for k in range(s["num_states"])]
    return out


def decoder_plan(volume: int, channels: int):
    """(cin, cout) of the weight-volume decoder's transposed convolutions
    (the port's `ConvDecoder3D`)."""
    inch, outch, plan = 1024, 512, []
    for _ in range(volume.bit_length() - 2):
        plan.append((inch, outch))
        if inch == outch:
            outch = inch // 2
        else:
            inch = outch
    plan.append((plan[-1][1], channels))
    return plan


def cnl_dims(s: Dict) -> List[int]:
    din = 3 * (1 + 2 * 10) + STATE_EMBED
    w = s["cnl_mlp_width"]
    return [din] + [w + (din if i == 5 else 0)
                    for i in range(1, s["cnl_mlp_depth"])]


def nr_dims(s: Dict) -> List[int]:
    embed = 3 * 2 * 6
    w = s["nr_mlp_width"]
    return [COND + embed] + [w + (embed if i == 4 else 0)
                             for i in range(1, s["nr_mlp_depth"])]


def human_specs(prefix: str, s: Dict) -> List[W.Spec]:
    """The human-object field; the canonical head's density bias is the
    configuration's `density_bias` (kept alive, see its file)."""
    B, pw = s["total_bones"], s["pose_mlp_width"]
    relu = W.RELU_GAIN
    out = []
    for i in range(s["pose_mlp_depth"] - 1):
        out += W.xavier_linear(f"{prefix}.pose_decoder.block_mlps.{2 * i}",
                               POSE_EMBED if i == 0 else pw, pw, relu)
    for key in ("dstR", "dstT"):
        out += W.xavier_linear(f"{prefix}.pose_decoder.block_mlps_{key}.0",
                               pw, pw, relu)
        out += W.xavier_linear(f"{prefix}.pose_decoder.block_mlps_{key}.2",
                               pw, 3 * (B - 1), None)
    dec = f"{prefix}.mweight_vol_decoder"
    out.append((f"{dec}.const_embedding", (256,), ("n", 1.0)))
    out += W.xavier_linear(f"{dec}.decoder.block_mlp.0", 256, 1024,
                           W.LEAKY02_GAIN)
    plan = decoder_plan(s["mweight_volume_size"], B + 1)
    for n, (cin, cout) in enumerate(plan):
        out += W.blockwise_conv(f"{dec}.decoder.block_conv.{2 * n}", cin,
                                cout, 1.0 if n == len(plan) - 1
                                else W.LEAKY02_GAIN)
    for m in ("non_rigid_mlp", "non_rigid_forward_mlp"):
        dims = nr_dims(s)
        for j, d in enumerate(dims):
            out += W.xavier_linear(f"{prefix}.{m}.block_mlps.{2 * j}", d,
                                   s["nr_mlp_width"], relu)
        out += W.xavier_linear(f"{prefix}.{m}.block_mlps.{2 * len(dims)}",
                               s["nr_mlp_width"], 3, None)
    for j, d in enumerate(cnl_dims(s)):
        out += W.xavier_linear(f"{prefix}.cnl_mlp.pts_linears.{2 * j}", d,
                               s["cnl_mlp_width"], relu)
    w = s["cnl_mlp_width"]
    out.append((f"{prefix}.cnl_mlp.output_linear.0.weight", (4, w),
                ("u", (6.0 / (w + 4)) ** 0.5)))
    out.append((f"{prefix}.cnl_mlp.output_linear.0.bias", (4,),
                ("last", s["density_bias"])))
    out += [(f"{prefix}.human_stateembeds.{k}", (STATE_EMBED,), ("n", 1.0))
            for k in range(s["num_states"])]
    return out


def lpips_specs(prefix: str) -> List[W.Spec]:
    """LPIPS's VGG16 convolutions with a He-normal init (its published
    weights are a download) and its lin heads at one."""
    out, cin, j = [], 3, 0
    for item in VGG_PLAN:
        if isinstance(item, int):
            out.append((f"{prefix}.vgg.conv_{j}.weight", (item, cin, 3, 3),
                        ("n", (2.0 / (cin * 9)) ** 0.5)))
            out.append((f"{prefix}.vgg.conv_{j}.bias", (item,), ("c", 0.0)))
            cin, j = item, j + 1
    out += [(f"{prefix}.lin_{i}", (c,), ("c", 1.0))
            for i, c in enumerate(VGG_TAPS)]
    return out
