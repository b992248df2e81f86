"""The fused MLP trunks: positional embedding + trunk + f32 head (B2/B3),
and the trunk alone on raw input rows (row 8). The Hopper kernels'
wrappers (csrc/embed_trunk.cu forward, csrc/embed_trunk_bwd.cu backward,
on the machinery of csrc/trunk_common.cuh), their plain PyTorch versions,
and the autograd functions that join them.

Counterpart of `hosnerf_tpu/ops/pallas/mlp.py::fused_embed_trunk` and
`fused_trunk` with their VJPs. Weights come in torch orientation
(`nn.Linear.weight`, [dout, din]) with the reference's interleaved PE row
order; the kernels build the PE in that order themselves, so no row
permutation is needed (the TPU kernel's `embed_row_perm` only served its
lane-dense layout), and the weight gradients come back in the `nn.Linear`
layout. A bias gradient has its bias's shape [dout] (the JAX trunk VJP's
[1, dout] is not copied).

Every kernel entry takes a CPU tensor to its plain version and a CUDA
tensor to the kernel; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hosnerf_tpu_torch.models.embedders import (fourier_embed,
                                                hann_window,
                                                hannw_fourier_embed)
from hosnerf_tpu_torch.ops.cuda import _build
from hosnerf_tpu_torch.ops.cuda.lbs import (first_live_row, live_rows_mask,
                                            _k0_tensor)
from hosnerf_tpu_torch.utils import spans

MLP_TILE = 1024      # k0 counts blocks of this many rows, as on the TPU
MAX_LAYERS = 12      # csrc/trunk_common.cuh kMaxLayers
MAX_OUT = 4          # csrc/embed_trunk_bwd.cu kMaxOut
KERNEL_WIDTHS = (32, 128, 256)


class EmbedSpec:
    """Static description of the embed preamble.

    kind: 'fourier' (input prepended) | 'hannw' (windowed, no identity);
    aux_mode: 'broadcast' (one [A] row) | 'stream' ([N, A] rows);
    aux_first: aux before the PE in the trunk input ([cond, embed] for
    the non-rigid MLP; [embed, state] for the canonical MLP)."""

    def __init__(self, kind: str, multires: int, aux_width: int,
                 aux_mode: str, aux_first: bool):
        if kind not in ("fourier", "hannw"):
            raise ValueError(f"unknown embed kind {kind!r}")
        if aux_mode not in ("broadcast", "stream"):
            raise ValueError(f"unknown aux_mode {aux_mode!r}")
        self.kind = kind
        self.multires = multires
        self.include_input = kind == "fourier"
        self.aux_width = aux_width
        self.aux_mode = aux_mode
        self.aux_first = aux_first

    @property
    def ex_width(self) -> int:
        return 3 * (1 if self.include_input else 0) + 6 * self.multires


def _skip_slice(espec: EmbedSpec, skip_source: str) -> Tuple[int, int]:
    """(offset, width) of the first-input slice the skip layer re-concats."""
    if skip_source == "full_input":
        return 0, espec.ex_width + espec.aux_width
    if skip_source == "embed":
        return (espec.aux_width if espec.aux_first else 0), espec.ex_width
    raise ValueError(f"unknown skip_source {skip_source!r}")


def trunk_input(x, aux, alpha, espec: EmbedSpec) -> torch.Tensor:
    """[N, ex_width + A] f32 first-layer input in the reference layout."""
    x = x.float()
    if espec.kind == "fourier":
        ex = fourier_embed(x, espec.multires)
    else:
        ex = hannw_fourier_embed(x, espec.multires, alpha)
    aux = aux.float().expand(x.shape[0], espec.aux_width)
    return torch.cat([aux, ex] if espec.aux_first else [ex, aux], dim=-1)


def _rounder(precision: str):
    if precision == "bf16":
        return lambda t: t.to(torch.bfloat16).float()
    if precision == "highest":
        return lambda t: t
    raise ValueError(f"unknown precision {precision!r}")


def _trunk_pass(xc, layers, skip_before, skip_src, src_first, rnd):
    """The trunk on a (rounded) first-layer input: (last hidden state,
    per-layer (input, output) activations) with the kernels' rounding
    points. The `skip_before` layer takes [skip_src, h] (src_first) or
    [h, skip_src]."""
    h = xc
    acts = []
    for i, (w, b) in enumerate(layers):
        if i == skip_before:
            h = torch.cat([skip_src, h] if src_first else [h, skip_src],
                          dim=-1)
        a_in = h
        z = rnd(h @ rnd(w.float()).T)
        h = torch.relu(rnd(z + rnd(b.float())))
        acts.append((a_in, h))
    return h, acts


def _trunk_backprop(acts, layers, out, g_out, skip_before, skip_width,
                    src_first, rnd):
    """Backward of `_trunk_pass` + the f32 head: head in f32; per layer in
    reverse: g *= (h_out > 0), gc = bf16(g), dW += gc^T a_in (bf16
    operands), db += sum g (unrounded), g = gc bf16(W); the skip layer's
    input gradient split into its source slice's part. Returns (d/d first
    input, d/d skip source (or None), [(dW [dout, din], db [dout])],
    (dWout, dbout))."""
    dout = (g_out.T @ acts[-1][1], g_out.sum(0))
    g = g_out @ out[0].float()
    dlayers: List = [None] * len(layers)
    gskip = None
    sw = skip_width
    for i in reversed(range(len(layers))):
        a_in, h_out = acts[i]
        g = g * (h_out > 0)
        gc = rnd(g)
        dlayers[i] = (gc.T @ a_in, g.sum(0))
        g = gc @ rnd(layers[i][0].float())
        if i == skip_before:
            if src_first:
                gskip, g = g[:, :sw], g[:, sw:]
            else:
                gskip, g = g[:, g.shape[1] - sw:], g[:, :g.shape[1] - sw]
    return g, gskip, dlayers, dout


def _plain_forward(x, aux, alpha, layers, out, espec, skip_before,
                   skip_source, precision):
    """(output, per-layer (input, output) activations) with the kernel's
    rounding points."""
    rnd = _rounder(precision)
    xc = rnd(trunk_input(x, aux, alpha, espec))
    off, width = _skip_slice(espec, skip_source)
    h, acts = _trunk_pass(xc, layers, skip_before, xc[:, off:off + width],
                          skip_source == "full_input", rnd)
    return h @ out[0].float().T + out[1].float(), acts


def fused_embed_trunk_plain(x, aux, alpha, layers, out, *,
                            espec: EmbedSpec, skip_before: Optional[int],
                            skip_source: str,
                            precision: str = "bf16") -> torch.Tensor:
    """Plain PyTorch version, every row computed. bf16: the input row is
    rounded to bf16; each layer takes the f32 product of bf16 operands,
    rounds it to bf16, adds the bf16 bias in bf16, ReLU; the head is f32
    on the bf16 hidden state. highest: f32 throughout."""
    return _plain_forward(x, aux, alpha, layers, out, espec, skip_before,
                          skip_source, precision)[0]


def embed_bwd(x, g_ex, espec: EmbedSpec, alpha) -> torch.Tensor:
    """d/dx of the PE (`_embed_bwd`, mlp.py:405-421) in f32: per
    coordinate sum_j (g_sin c_j - g_cos s_j) 2^j over the (hann-windowed)
    sin/cos, plus the identity columns of the fourier kind."""
    x = x.float()
    F = espec.multires
    idoff = 3 if espec.include_input else 0
    freqs = 2.0 ** torch.arange(F, dtype=x.dtype, device=x.device)
    scaled = x[:, None, :] * freqs[:, None]                     # [n, F, 3]
    s, c = torch.sin(scaled), torch.cos(scaled)
    if espec.kind == "hannw":
        w = hann_window(alpha, F, x)[:, None]
        s, c = s * w, c * w
    g = g_ex[:, idoff:idoff + 6 * F].reshape(-1, F, 2, 3)
    dx = ((g[:, :, 0] * c - g[:, :, 1] * s) * freqs[:, None]).sum(1)
    if espec.include_input:
        dx = dx + g_ex[:, :3]
    return dx


def fused_embed_trunk_bwd_plain(x, aux, alpha, layers, out, gout, *,
                                espec: EmbedSpec, skip_before: Optional[int],
                                skip_source: str, precision: str = "bf16",
                                k0_blocks=None):
    """Plain version of the backward (`_ebwd_kernel` with
    `_trunk_bwd_tile` and `_embed_bwd`, mlp.py:145-192, 405-483), on rows
    from the clamped k0 * 1024 on (rows below get dx = 0, stream daux = 0,
    and add nothing): recompute the forward with its rounding points; head
    in f32; per layer in reverse: g *= (h_out > 0), gc = bf16(g),
    dW += gc^T a_in (bf16 operands), db += sum g (unrounded), g = gc
    bf16(W); the skip slice's gradient back to its source; the PE chain in
    f32. Returns (dx [N, 3], daux ([N, A] stream, [A] broadcast),
    [(dW [dout, din], db [dout])], (dWout, dbout))."""
    n = x.shape[0]
    first = first_live_row(0 if k0_blocks is None else k0_blocks, n,
                           MLP_TILE)
    rnd = _rounder(precision)
    stream = espec.aux_mode == "stream"
    xs = x[first:].float()
    aux_s = aux[first:] if stream else aux
    _, acts = _plain_forward(xs, aux_s, alpha, layers, out, espec,
                             skip_before, skip_source, precision)
    off, sw = _skip_slice(espec, skip_source)
    d_full, gskip, dlayers, dout = _trunk_backprop(
        acts, layers, out, gout[first:].float(), skip_before, sw,
        skip_source == "full_input", rnd)
    if gskip is not None:
        d_full = d_full.clone()
        d_full[:, off:off + sw] += gskip
    A = espec.aux_width
    if espec.aux_first:
        g_aux, g_ex = d_full[:, :A], d_full[:, A:]
    else:
        g_ex, g_aux = d_full[:, :espec.ex_width], d_full[:, espec.ex_width:]
    dx = torch.zeros(n, 3, device=x.device)
    dx[first:] = embed_bwd(xs, g_ex, espec, alpha)
    if stream:
        daux = torch.zeros(n, A, device=x.device)
        daux[first:] = g_aux
    else:
        daux = g_aux.sum(0)
    return dx, daux, dlayers, dout


# ---------------------------------------------------------------------------
# host-side layout for the kernels
# ---------------------------------------------------------------------------

def _round_up(v: int, align: int) -> int:
    return -(-v // align) * align


def _round16(v: int) -> int:
    return _round_up(v, 16)


PANEL = 64          # columns of a 128-byte-swizzled bf16 panel
PANEL_BYTES = 8192  # one [64 rows][64 cols] bf16 panel
MAX_STEPS = 320     # csrc/trunk_common.cuh kMaxSteps
MAX_XW = 256        # Xs columns (4 panels)
# f32 kernels at width 256: the three-piece Xs and Hs images of a 64-row
# tile and two stages of weight pieces fill shared memory at 128 input
# columns (csrc/trunk_common.cuh x3_fwd_smem)
MAX_XW_F32_256 = 128


# Layer plans and swizzle indices by their static key: building them
# copies index lists to the card, which would stall the stream per call.
_PLANS: dict = {}


def _memo(key, build):
    if key not in _PLANS:
        _PLANS[key] = build()
    return _PLANS[key]


def _shapes(layers):
    return tuple(tuple(w.shape) for w, _ in layers)


def _place(seg_cols, hid, w, i):
    """Lay one layer's input segments out in packed weight columns.
    seg_cols: [((buf, off, width), [segment column of each original input
    column of that segment])] in input order. Each segment starts a
    64-column weight chunk (the backward routes the input gradients chunk
    by chunk); K is the padded total. Returns (segments [(buf,
    off, width, kpos)], K, cols: packed column of each original input
    column)."""
    segs, cols, k = [], [], 0
    for (buf, off, width), local in seg_cols:
        k = _round_up(k, PANEL)
        segs.append((buf, off, width, k))
        cols += [k + j for j in local]
        k += width
    if tuple(w.shape) != (hid, len(cols)):
        raise ValueError(f"layer {i} weight {tuple(w.shape)} does not "
                         f"match the spec ({hid}, {len(cols)})")
    return segs, _round_up(k, PANEL), torch.tensor(cols, device=w.device)


def _layer_plan(layers, espec: EmbedSpec, skip_before, skip_source):
    """Per layer: (segments [(buf, off, width, kpos)], K, cols). Shared
    memory Xs holds [PE | pad | aux | pad] with each part padded to 16
    columns; a layer input is one or two 16-aligned segments of Xs (buf 0)
    / Hs (buf 1), placed from packed weight column kpos (a multiple of
    64, `_place`), K packed columns in all; cols[j] is the packed column
    of original input column j (pad columns hold zeros)."""
    key = ("embed", _shapes(layers), espec.kind, espec.multires,
           espec.aux_width, espec.aux_first, skip_before, skip_source,
           layers[0][0].device)
    return _memo(key, lambda: _build_layer_plan(layers, espec, skip_before,
                                                skip_source))


def _build_layer_plan(layers, espec, skip_before, skip_source):
    hid = int(layers[0][0].shape[0])
    A, ex_w = espec.aux_width, espec.ex_width
    exp_w = _round16(ex_w)
    xw = exp_w + _round16(A)
    ex_cols = list(range(ex_w))
    aux_cols = [exp_w + a for a in range(A)]
    x_cols = aux_cols + ex_cols if espec.aux_first else ex_cols + aux_cols
    plan = []
    for i, (w, _) in enumerate(layers):
        if i == 0:
            seg_cols = [((0, 0, xw), x_cols)]
        elif i == skip_before and skip_source == "full_input":
            seg_cols = [((0, 0, xw), x_cols), ((1, 0, hid), range(hid))]
        elif i == skip_before:
            seg_cols = [((1, 0, hid), range(hid)), ((0, 0, exp_w), ex_cols)]
        else:
            seg_cols = [((1, 0, hid), range(hid))]
        plan.append(_place(seg_cols, hid, w, i))
    return plan, hid, xw, exp_w


def _swizzle128(wp: torch.Tensor) -> torch.Tensor:
    """[..., R, K] (K a multiple of 64) -> the flat images of K / 64 chunks
    [R][64] in wgmma's 128-byte swizzle, [..., K / 64, R * 64]: in row r,
    the 8-column group j is stored at group j ^ (r % 8)
    (csrc/trunk_common.cuh `swz`)."""
    *lead, R, K = wp.shape
    t = wp.reshape(*lead, R, K // PANEL, 8, 8).transpose(-4, -3)

    def index():
        r = torch.arange(R, device=wp.device)
        return r[:, None], torch.arange(8, device=wp.device)[None, :] ^ \
            (r % 8)[:, None]
    r, src = _memo(("swizzle", R, wp.device), index)
    return t[..., r, src, :].reshape(*lead, K // PANEL, R * PANEL)


def split3(t: torch.Tensor) -> torch.Tensor:
    """[3, *t.shape] bf16: f32 values as three bf16 pieces hi = bf16(v),
    mid = bf16(v - hi), lo = bf16(v - hi - mid) (each difference exact in
    f32), whose sum holds v to 2^-24 of it: the f32 kernels' operands
    (csrc/trunk_common.cuh `split3`)."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    r = t - hi.float()
    mid = r.to(torch.bfloat16)
    return torch.stack([hi, mid, (r - mid.float()).to(torch.bfloat16)])


def _packed_weights(layers, plan, hid, precision: str):
    """Every layer's weights scattered into its packed columns [HID, K],
    as flat 128-byte-swizzled chunk images [HID][64], layer after layer:
    bf16 one image per chunk; highest three per chunk, the `split3` pieces
    hi, mid, lo. Built on the device in a few operations for all layers
    at once."""
    dev = layers[0][0].device
    k_all = sum(K for _, K, _ in plan)

    def columns():
        out, off = [], 0
        for _, K, cols in plan:
            out.append(cols + off)
            off += K
        return torch.cat(out)
    wp = torch.zeros(hid, k_all, device=dev)
    wp[:, _memo(("columns", id(plan)), columns)] = torch.cat(
        [w.float() for w, _ in layers], dim=1)
    if precision == "bf16":
        return _swizzle128(wp).reshape(-1).to(torch.bfloat16)
    return _swizzle128(split3(wp)).transpose(0, 1).reshape(-1)


def _ksteps(segs):
    """The forward's K-steps of one layer (csrc/trunk_common.cuh
    `Meta::step`): per 16 packed columns of each segment, the byte offset
    of its A slice in the warpgroup's Xs/Hs image (column panel * 8 KB +
    2 bytes per column inside the panel; the swizzle is applied by the
    hardware from the address; f32 adds the piece's offset), the buffer,
    the step inside its weight chunk and the chunk."""
    steps = []
    for buf, off, width, kpos in segs:
        for j in range(0, width, 16):
            col, kg = off + j, kpos + j
            byte = (col // PANEL) * PANEL_BYTES + (col % PANEL) * 2
            steps.append(byte | buf << 16 | (kg % PANEL // 16) << 17
                         | (kg // PANEL) << 20)
    return steps


def _pack_meta(layers, out, plan, hid, head, precision: str,
               skip_off: int = 0):
    """The meta int32 array (csrc/trunk_common.cuh `parse_meta`: L, hid,
    out_dim, then `head` = [xw, exp_w, ex_w, kind, F, A, aux_stride]; per
    layer its two segments (buf, off, width, kpos), K, weight offset and
    its K-steps' first index and count; the skip slice's offset in x, read
    by the raw-input kind; last the K-steps) and the packed weights and
    biases: `_packed_weights`' chunk images of [HID, K] (the wgmma B
    operand), biases bf16 or f32."""
    bf16 = precision == "bf16"
    if head[0] > MAX_XW:
        raise ValueError(f"the kernels take at most {MAX_XW} input "
                         f"columns, got {head[0]}")
    if not bf16 and hid == 256 and head[0] > MAX_XW_F32_256:
        raise ValueError(f"the f32 kernels take at most {MAX_XW_F32_256} "
                         f"input columns at width 256, got {head[0]}")
    dt = torch.bfloat16 if bf16 else torch.float32
    meta = [len(layers), hid, int(out[0].shape[0])] + list(head)
    steps, w_off = [], 0
    for segs, K, _ in plan:
        for sg in segs + [(0, 0, 0, 0)] * (2 - len(segs)):
            meta += list(sg)
        own = _ksteps(segs)
        meta += [K, w_off, len(steps), len(own)]
        steps += own
        w_off += hid * K
    if len(steps) > MAX_STEPS:
        raise ValueError(f"{len(steps)} K-steps, the kernels take "
                         f"{MAX_STEPS}")
    meta += [skip_off, len(steps)] + steps
    w_all = _packed_weights(layers, plan, hid, precision)
    b_all = torch.stack([b.float() for _, b in layers]).to(dt).contiguous()
    return (np.asarray(meta, np.int32), w_all, b_all,
            out[0].float().contiguous(), out[1].float().contiguous())


def _pack(layers, out, espec: EmbedSpec, skip_before, skip_source,
          precision: str, aux_stride: int):
    """Host-side layout for the embed trunk kernels (`_layer_plan` gives
    the layout, `_pack_meta` the arrays)."""
    plan, hid, xw, exp_w = _layer_plan(layers, espec, skip_before,
                                       skip_source)
    head = [xw, exp_w, espec.ex_width, 0 if espec.kind == "fourier" else 1,
            espec.multires, espec.aux_width, aux_stride]
    return _pack_meta(layers, out, plan, hid, head, precision)


def _act_buffers(n, L, hid, xw, precision, dev):
    """The backward's scratch (act_x, act_h, gc): 64-row tiles of swizzled
    bf16 [64][64] panels, every tile written. bf16: 2 tiles per 128-row
    CTA tile; f32: one per 64-row tile, as three piece images each."""
    if precision == "bf16":
        t64, pieces = 2 * -(-n // 128), 1
    else:
        t64, pieces = -(-n // 64), 3
    xpn, hpn = -(-xw // PANEL), max(1, hid // PANEL)
    f = dict(device=dev, dtype=torch.bfloat16)
    tile = pieces * PANEL * PANEL
    return (torch.empty(t64 * xpn * tile, **f),
            torch.empty(L * t64 * hpn * tile, **f),
            torch.empty(L * t64 * hpn * tile, **f))


def _check_weights(layers, out, dev) -> int:
    """Raise on trunk widths, depths or heads the kernels do not take;
    returns the hidden width."""
    hid = int(layers[0][0].shape[0])
    if hid not in KERNEL_WIDTHS or len(layers) > MAX_LAYERS:
        raise ValueError(f"kernel takes widths {KERNEL_WIDTHS} and at most "
                         f"{MAX_LAYERS} layers, got {hid} x {len(layers)}")
    for w, b in layers:
        if w.device != dev or b.device != dev or w.shape[0] != hid:
            raise ValueError("every trunk layer must be [hid, din] on the "
                             "device of x")
    if out[0].device != dev or out[0].shape[1] != hid or \
            out[0].shape[0] > MAX_OUT:
        raise ValueError(f"head weight must be [out_dim <= {MAX_OUT}, hid] "
                         "on the device")
    return hid


def _check_kernel_args(x, aux, layers, out, espec: EmbedSpec,
                       precision: str) -> int:
    """Raise on what the kernels do not take; returns the aux row stride."""
    if precision not in ("bf16", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    n = x.shape[0]
    dev = x.device
    if x.shape != (n, 3) or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32 [N, 3]")
    A = espec.aux_width
    if aux.dtype != torch.float32 or aux.device != dev:
        raise ValueError("aux must be float32 on the device of x")
    if espec.aux_mode == "broadcast":
        if aux.shape != (A,) or not aux.is_contiguous():
            raise ValueError("broadcast aux must be a contiguous [A] row")
        aux_stride = 0
    else:
        if aux.shape != (n, A) or aux.stride(1) != 1 or \
                aux.stride(0) not in (0, A):
            raise ValueError("stream aux must be [N, A] with rows of stride "
                             "A (or 0 for one expanded row)")
        aux_stride = aux.stride(0)
    _check_weights(layers, out, dev)
    return aux_stride


def _alpha_tensor(alpha, dev) -> torch.Tensor:
    a = (alpha.reshape(1).float() if torch.is_tensor(alpha)
         else torch.full((1,), float(alpha or 0.0), device=dev))
    if a.device != dev:
        raise ValueError("alpha must be on the device of x")
    return a


# ---------------------------------------------------------------------------
# B2: forward kernel
# ---------------------------------------------------------------------------

def embed_trunk_fwd(x, aux, alpha, layers, out, *, espec: EmbedSpec,
                    skip_before, skip_source, precision="bf16",
                    k0_blocks=None) -> torch.Tensor:
    """B2: the forward, [N, out_dim]. A CPU tensor runs
    `fused_embed_trunk_plain` (every row); a CUDA tensor the kernel of
    csrc/embed_trunk.cu (or raises), which leaves rows below the clamped
    k0 * 1024 unwritten."""
    if x.device.type == "cpu":
        return fused_embed_trunk_plain(
            x, aux, alpha, layers, out, espec=espec, skip_before=skip_before,
            skip_source=skip_source, precision=precision)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    aux_stride = _check_kernel_args(x, aux, layers, out, espec, precision)
    meta, w_all, b_all, wout, bout = _pack(
        layers, out, espec, skip_before, skip_source, precision, aux_stride)
    alpha_t = _alpha_tensor(alpha, dev)
    k0 = _k0_tensor(k0_blocks, dev)
    n = x.shape[0]
    res = torch.empty(n, int(wout.shape[0]), device=dev, dtype=torch.float32)
    lib = _lib()
    rc = lib.hosnerf_embed_trunk(
        meta.ctypes.data, int(precision == "bf16"), x.data_ptr(),
        aux.data_ptr(), alpha_t.data_ptr(), k0.data_ptr(), w_all.data_ptr(),
        b_all.data_ptr(), wout.data_ptr(), bout.data_ptr(), res.data_ptr(),
        n, torch.cuda.current_stream(dev).cuda_stream)
    fused_embed_trunk.launches += 1
    _build.check(rc, lib, "fused_embed_trunk")
    return res


# ---------------------------------------------------------------------------
# B3: backward kernel
# ---------------------------------------------------------------------------

def embed_trunk_bwd(x, aux, alpha, layers, out, gout, *, espec: EmbedSpec,
                    skip_before, skip_source, precision="bf16",
                    k0_blocks=None):
    """B3: the backward, as `fused_embed_trunk_bwd_plain` returns it. A CPU
    tensor runs that plain version; a CUDA tensor the kernels of
    csrc/embed_trunk_bwd.cu (forward recompute with activation store, row
    tiles in reverse, dW products; one call) or raises. The wrapper zeroes
    the dx and stream-daux rows the kernels leave unwritten (below the
    clamped k0 * 1024): stream daux feeds an expand whose backward sums
    every row. The sums over rows (dW, db, broadcast daux) come in one
    fixed order: the same inputs on one card give the same bits."""
    if x.device.type == "cpu":
        return fused_embed_trunk_bwd_plain(
            x, aux, alpha, layers, out, gout, espec=espec,
            skip_before=skip_before, skip_source=skip_source,
            precision=precision, k0_blocks=k0_blocks)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    aux_stride = _check_kernel_args(x, aux, layers, out, espec, precision)
    meta, w_all, b_all, wout, bout = _pack(
        layers, out, espec, skip_before, skip_source, precision, aux_stride)
    plan, hid, xw, _ = _layer_plan(layers, espec, skip_before, skip_source)
    bf16 = precision == "bf16"
    n, L, A = x.shape[0], len(layers), espec.aux_width
    out_dim = int(wout.shape[0])
    gout = gout.float().contiguous()
    if gout.shape != (n, out_dim) or gout.device != dev:
        raise ValueError(f"gout must be [N, {out_dim}] on the device of x")
    alpha_t = _alpha_tensor(alpha, dev)
    k0 = _k0_tensor(k0_blocks, dev)
    stream = espec.aux_mode == "stream"

    def f32(*shape):   # every output entry is written by the kernels
        return torch.empty(*shape, device=dev, dtype=torch.float32)

    act_x, act_h, gc = _act_buffers(n, L, hid, xw, precision, dev)
    dx = f32(n, 3)
    daux = f32(n, A) if stream else f32(A)
    db, dwout, dbout = f32(L, hid), f32(out_dim, hid), f32(out_dim)
    dw = f32(hid * sum(K for _, K, _ in plan))
    splits = max(1, min(16, n // 16384))
    lib = _bwd_lib()
    part = _bwd_part(lib, meta, bf16, stream, n, splits, dev)
    rc = lib.hosnerf_embed_trunk_bwd(
        meta.ctypes.data, int(bf16), int(stream), x.data_ptr(),
        aux.data_ptr(), alpha_t.data_ptr(), k0.data_ptr(), w_all.data_ptr(),
        b_all.data_ptr(), wout.data_ptr(), gout.data_ptr(),
        act_x.data_ptr(), act_h.data_ptr(), gc.data_ptr(), dx.data_ptr(),
        daux.data_ptr(), db.data_ptr(), dwout.data_ptr(), dbout.data_ptr(),
        dw.data_ptr(), part.data_ptr(), n, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    fused_embed_trunk_bwd.launches += 1
    _build.check(rc, lib, "fused_embed_trunk_bwd")
    dead = ~live_rows_mask(k0, n, MLP_TILE, dev)
    dx.masked_fill_(dead, 0.0)
    if stream:
        daux.masked_fill_(dead, 0.0)
    dlayers, w_off = [], 0
    for i, (_, K, cols) in enumerate(plan):
        dwp = dw[w_off:w_off + hid * K].reshape(hid, K)
        dlayers.append((dwp[:, cols], db[i]))
        w_off += hid * K
    return dx, daux, dlayers, (dwout, dbout)


# ---------------------------------------------------------------------------
# the differentiable entry
# ---------------------------------------------------------------------------

class _TrunkCfg:
    def __init__(self, espec, skip_before, skip_source, precision, alpha,
                 depth):
        self.kw = dict(espec=espec, skip_before=skip_before,
                       skip_source=skip_source, precision=precision)
        self.alpha = alpha
        self.depth = depth


class _EmbedTrunk(torch.autograd.Function):

    @staticmethod
    @spans.spanned("B2")
    def forward(ctx, x, aux, k0, cfg, *params):
        ctx.cfg = cfg
        ctx.save_for_backward(x, aux, k0, *params)
        layers = [(params[2 * i], params[2 * i + 1])
                  for i in range(cfg.depth)]
        return embed_trunk_fwd(x, aux, cfg.alpha, layers, params[-2:],
                               k0_blocks=k0, **cfg.kw)

    @staticmethod
    @spans.spanned("B3.bwd")
    def backward(ctx, gout):
        cfg = ctx.cfg
        x, aux, k0, *params = ctx.saved_tensors
        layers = [(params[2 * i], params[2 * i + 1])
                  for i in range(cfg.depth)]
        dx, daux, dlayers, dout = embed_trunk_bwd(
            x, aux, cfg.alpha, layers, params[-2:], gout, k0_blocks=k0,
            **cfg.kw)
        flat = [t for pair in dlayers for t in pair] + list(dout)
        return (dx, daux, None, None, *flat)


def fused_embed_trunk(x, aux, alpha,
                      layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      out: Tuple[torch.Tensor, torch.Tensor], *, kind: str,
                      multires: int, aux_mode: str, aux_first: bool,
                      skip_before: Optional[int], skip_source: str,
                      precision: str = "bf16",
                      k0_blocks=None) -> torch.Tensor:
    """Embed + trunk + head, differentiable in x, aux and every weight
    (forward B2, backward B3; plain versions for CPU tensors; d(alpha) =
    0). x [N, 3] raw points; aux = one [A] row (broadcast) or [N, A] rows
    (stream; a stride-0 expanded row is taken as is); alpha = hann anneal
    (float or 1-element tensor; unused for 'fourier'); layers
    [(W [dout, din], b [dout])] in the reference row order; out =
    (W_out [out_dim, hid], b_out), applied in f32.

    k0_blocks: optional int or device tensor, the first live 1024-row
    block (clamped to n_blocks - 1). On the card, rows below k0_blocks *
    1024 are unspecified (the kernel leaves them unwritten) and get no
    gradient. Returns [N, out_dim]."""
    espec = EmbedSpec(kind, multires, int(aux.shape[-1]), aux_mode,
                      aux_first)
    cfg = _TrunkCfg(espec, skip_before, skip_source, precision, alpha,
                    len(layers))
    params = [t for pair in layers for t in pair] + list(out)
    return _EmbedTrunk.apply(x, aux, _k0_tensor(k0_blocks, x.device), cfg,
                             *params)


fused_embed_trunk.launches = 0


def fused_embed_trunk_bwd(x, aux, alpha, layers, out, gout, *, kind: str,
                          multires: int, aux_mode: str, aux_first: bool,
                          skip_before: Optional[int], skip_source: str,
                          precision: str = "bf16", k0_blocks=None):
    """The backward with the keyword interface of `fused_embed_trunk`
    (B3 on CUDA tensors, the plain version on CPU tensors)."""
    espec = EmbedSpec(kind, multires, int(aux.shape[-1]), aux_mode,
                      aux_first)
    return embed_trunk_bwd(x, aux, alpha, layers, out, gout, espec=espec,
                           skip_before=skip_before, skip_source=skip_source,
                           precision=precision, k0_blocks=k0_blocks)


fused_embed_trunk_bwd.launches = 0


# ---------------------------------------------------------------------------
# row 8: the trunk-only fused MLP (raw input rows, no embedding)
# ---------------------------------------------------------------------------

class TrunkSpec:
    """Static architecture of a trunk-only MLP (the JAX `TrunkSpec`,
    mlp.py:81-104): input width din; the `skip_before` layer (or None)
    re-concatenates the input slice [skip_off, skip_off + skip_width)
    before ('input_first') or after ('h_first') the hidden state."""

    def __init__(self, din: int, skip_before: Optional[int], skip_order: str,
                 skip_off: int, skip_width: int):
        if skip_order not in ("input_first", "h_first"):
            raise ValueError(f"unknown skip_order {skip_order!r}")
        if skip_before is not None and not (
                0 <= skip_off and skip_width > 0
                and skip_off + skip_width <= din):
            raise ValueError(f"skip slice [{skip_off}, {skip_off} + "
                             f"{skip_width}) outside the input ({din})")
        self.din = din
        self.skip_before = skip_before
        self.skip_order = skip_order
        self.skip_off = skip_off
        self.skip_width = skip_width


def _raw_trunk(x, layers, spec: TrunkSpec, rnd):
    xc = rnd(x.float())
    src = xc[:, spec.skip_off:spec.skip_off + spec.skip_width]
    return _trunk_pass(xc, layers, spec.skip_before, src,
                       spec.skip_order == "input_first", rnd)


def fused_trunk_plain(x, layers, out, *, spec: TrunkSpec,
                      precision: str = "bf16") -> torch.Tensor:
    """Plain version of the trunk-only MLP (`_forward_tile`,
    mlp.py:107-132): the input row rounded to bf16, each layer the f32
    product of bf16 operands rounded to bf16, plus the bf16 bias in bf16,
    ReLU; the head f32 on the bf16 hidden state ("highest": f32
    throughout). Returns [N, out_dim]."""
    h, _ = _raw_trunk(x, layers, spec, _rounder(precision))
    return h @ out[0].float().T + out[1].float()


def fused_trunk_bwd_plain(x, layers, out, gout, *, spec: TrunkSpec,
                          precision: str = "bf16"):
    """Plain version of the trunk-only backward (`_trunk_bwd_tile`,
    mlp.py:145-192): recompute, then `_trunk_backprop`; the skip slice's
    gradient is added into its input columns. Returns (dx [N, din],
    [(dW [dout, din], db [dout])], (dWout, dbout)): every bias gradient
    has its bias's shape."""
    rnd = _rounder(precision)
    _, acts = _raw_trunk(x, layers, spec, rnd)
    dx, gskip, dlayers, dout = _trunk_backprop(
        acts, layers, out, gout.float(), spec.skip_before, spec.skip_width,
        spec.skip_order == "input_first", rnd)
    if gskip is not None:
        dx = dx.clone()
        dx[:, spec.skip_off:spec.skip_off + spec.skip_width] += gskip
    return dx, dlayers, dout


def _trunk_plan(layers, spec: TrunkSpec):
    """Xs holds [x | pad] and, unless the skip slice already ends the
    16-aligned input from a 16-aligned offset, a copy of the slice [src |
    pad] after it (the kernels' aux columns, read from x itself at row
    stride din). Returns (plan as `_layer_plan`'s, hid, xw, exp_w, A = the
    copy's width or 0)."""
    key = ("trunk", _shapes(layers), spec.din, spec.skip_before,
           spec.skip_order, spec.skip_off, spec.skip_width,
           layers[0][0].device)
    return _memo(key, lambda: _build_trunk_plan(layers, spec))


def _build_trunk_plan(layers, spec: TrunkSpec):
    hid = int(layers[0][0].shape[0])
    din, sw = spec.din, spec.skip_width
    exp_w, sw16 = _round16(din), _round16(sw)
    in_place = spec.skip_off % 16 == 0 and spec.skip_off + sw == din
    A = 0 if spec.skip_before is None or in_place else sw
    src = ((0, spec.skip_off, sw16) if in_place else (0, exp_w, sw16),
           range(sw))
    hs = ((1, 0, hid), range(hid))
    plan = []
    for i, (w, _) in enumerate(layers):
        if i == 0:
            seg_cols = [((0, 0, exp_w), range(din))]
        elif i == spec.skip_before and spec.skip_order == "input_first":
            seg_cols = [src, hs]
        elif i == spec.skip_before:
            seg_cols = [hs, src]
        else:
            seg_cols = [hs]
        plan.append(_place(seg_cols, hid, w, i))
    return plan, hid, exp_w + _round16(A), exp_w, A


def _trunk_args(x, layers, out, spec: TrunkSpec, precision: str):
    """Check what the kernels take; returns (plan, hid, meta, w_all,
    b_all, wout, bout, A)."""
    if precision not in ("bf16", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    n = x.shape[0]
    if x.shape != (n, spec.din) or x.dtype != torch.float32 or \
            not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 [N, {spec.din}]")
    if spec.skip_before == 0:
        raise ValueError("the kernels take no skip before layer 0")
    _check_weights(layers, out, x.device)
    plan, hid, xw, exp_w, A = _trunk_plan(layers, spec)
    head = [xw, exp_w, spec.din, 2, 0, A, spec.din]
    return (plan, hid, *_pack_meta(layers, out, plan, hid, head, precision,
                                   spec.skip_off), A)


def trunk_fwd(x, layers, out, *, spec: TrunkSpec,
              precision: str = "bf16") -> torch.Tensor:
    """Row 8 forward, [N, out_dim]. A CPU tensor runs `fused_trunk_plain`;
    a CUDA tensor the trunk kernel of csrc/embed_trunk.cu with the raw
    input stage of trunk_common.cuh (or raises)."""
    if x.device.type == "cpu":
        return fused_trunk_plain(x, layers, out, spec=spec,
                                 precision=precision)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    _, _, meta, w_all, b_all, wout, bout, _ = _trunk_args(
        x, layers, out, spec, precision)
    zero_f, zero_i = torch.zeros(1, device=dev), _k0_tensor(None, dev)
    n = x.shape[0]
    res = torch.empty(n, int(wout.shape[0]), device=dev, dtype=torch.float32)
    lib = _lib()
    rc = lib.hosnerf_embed_trunk(
        meta.ctypes.data, int(precision == "bf16"), x.data_ptr(),
        x.data_ptr() + 4 * spec.skip_off, zero_f.data_ptr(),
        zero_i.data_ptr(), w_all.data_ptr(), b_all.data_ptr(),
        wout.data_ptr(), bout.data_ptr(), res.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream)
    fused_trunk.launches += 1
    _build.check(rc, lib, "fused_trunk")
    return res


def trunk_bwd(x, layers, out, gout, *, spec: TrunkSpec,
              precision: str = "bf16"):
    """Row 8 backward, as `fused_trunk_bwd_plain` returns it. A CPU tensor
    runs that plain version; a CUDA tensor the kernels of
    csrc/embed_trunk_bwd.cu (forward recompute with activation store, row
    tiles in reverse, dW products; one call) or raises. The sums over rows
    (dW, db) come in one fixed order: the same inputs on one card give
    the same bits."""
    if x.device.type == "cpu":
        return fused_trunk_bwd_plain(x, layers, out, gout, spec=spec,
                                     precision=precision)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    plan, hid, meta, w_all, b_all, wout, bout, _ = _trunk_args(
        x, layers, out, spec, precision)
    bf16 = precision == "bf16"
    n, L = x.shape[0], len(layers)
    out_dim = int(wout.shape[0])
    gout = gout.float().contiguous()
    if gout.shape != (n, out_dim) or gout.device != dev:
        raise ValueError(f"gout must be [N, {out_dim}] on the device of x")

    def f32(*shape):   # every output entry is written by the kernels
        return torch.empty(*shape, device=dev, dtype=torch.float32)

    act_x, act_h, gc = _act_buffers(n, L, hid, int(meta[3]), precision, dev)
    dx = f32(n, spec.din)
    db, dwout, dbout = f32(L, hid), f32(out_dim, hid), f32(out_dim)
    dw = f32(hid * sum(K for _, K, _ in plan))
    unused = torch.zeros(1, device=dev, dtype=torch.float32)
    zero_i = _k0_tensor(None, dev)
    splits = max(1, min(16, n // 16384))
    lib = _bwd_lib()
    part = _bwd_part(lib, meta, bf16, False, n, splits, dev)
    rc = lib.hosnerf_embed_trunk_bwd(
        meta.ctypes.data, int(bf16), 0, x.data_ptr(),
        x.data_ptr() + 4 * spec.skip_off, unused.data_ptr(),
        zero_i.data_ptr(), w_all.data_ptr(), b_all.data_ptr(),
        wout.data_ptr(), gout.data_ptr(),
        act_x.data_ptr(), act_h.data_ptr(), gc.data_ptr(), dx.data_ptr(),
        unused.data_ptr(), db.data_ptr(), dwout.data_ptr(), dbout.data_ptr(),
        dw.data_ptr(), part.data_ptr(), n, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    fused_trunk_bwd.launches += 1
    _build.check(rc, lib, "fused_trunk_bwd")
    dlayers, w_off = [], 0
    for i, (_, K, cols) in enumerate(plan):
        dwp = dw[w_off:w_off + hid * K].reshape(hid, K)
        dlayers.append((dwp[:, cols], db[i]))
        w_off += hid * K
    return dx, dlayers, (dwout, dbout)


class _Trunk(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, spec, precision, *params):
        ctx.spec, ctx.precision = spec, precision
        ctx.save_for_backward(x, *params)
        L = (len(params) - 2) // 2
        layers = [(params[2 * i], params[2 * i + 1]) for i in range(L)]
        return trunk_fwd(x, layers, params[-2:], spec=spec,
                         precision=precision)

    @staticmethod
    def backward(ctx, gout):
        x, *params = ctx.saved_tensors
        L = (len(params) - 2) // 2
        layers = [(params[2 * i], params[2 * i + 1]) for i in range(L)]
        dx, dlayers, dout = trunk_bwd(x, layers, params[-2:], gout,
                                      spec=ctx.spec,
                                      precision=ctx.precision)
        flat = [t for pair in dlayers for t in pair] + list(dout)
        return (dx, None, None, *flat)


def fused_trunk(x, layer_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                out_params: Tuple[torch.Tensor, torch.Tensor], *,
                skip_before: Optional[int] = None,
                skip_order: str = "input_first", skip_off: int = 0,
                skip_width: int = 0, precision: str = "bf16") -> torch.Tensor:
    """Fused MLP trunk + f32 head (the JAX `fused_trunk`, mlp.py:738-760):
    x [N, Din] -> [N, out_dim], differentiable in x and every weight
    (forward and backward kernels, plain versions for CPU tensors).
    layer_params: [(W_i [dout, din_i], b_i [dout])] in `nn.Linear`
    orientation, din of the `skip_before` layer including the concat
    width; out_params: (W_out [out_dim, hid], b_out), applied in f32."""
    spec = TrunkSpec(int(x.shape[-1]), skip_before, skip_order, skip_off,
                     skip_width)
    params = [t for pair in layer_params for t in pair] + list(out_params)
    return _Trunk.apply(x.float().contiguous(), spec, precision, *params)


fused_trunk.launches = 0


def fused_trunk_bwd(x, layer_params, out_params, gout, *,
                    skip_before: Optional[int] = None,
                    skip_order: str = "input_first", skip_off: int = 0,
                    skip_width: int = 0, precision: str = "bf16"):
    """The backward with the keyword interface of `fused_trunk` (the row-8
    kernels on CUDA tensors, the plain version on CPU tensors)."""
    spec = TrunkSpec(int(x.shape[-1]), skip_before, skip_order, skip_off,
                     skip_width)
    return trunk_bwd(x, layer_params, out_params, gout, spec=spec,
                     precision=precision)


fused_trunk_bwd.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("embed_trunk")
    p = ctypes.c_void_p
    _build.declare(lib, "hosnerf_embed_trunk",
                   [p, ctypes.c_int, p, p, p, p, p, p, p, p, p,
                    ctypes.c_int, p])
    lib.hosnerf_trunk_f32_route.argtypes = []
    lib.hosnerf_trunk_f32_route.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("embed_trunk_bwd")
    p = ctypes.c_void_p
    i = ctypes.c_int
    _build.declare(lib, "hosnerf_embed_trunk_bwd",
                   [p, i, i] + [p] * 18 + [i, i, p])
    _build.declare(lib, "hosnerf_embed_trunk_bwd_scratch", [p, i, i, i, i])
    return lib


def _bwd_part(lib, meta, bf16: bool, stream: bool, n: int, splits: int,
              dev) -> torch.Tensor:
    """The backward's scratch of partial sums (slots that the kernels
    write whole and add in order), uninitialised."""
    floats = lib.hosnerf_embed_trunk_bwd_scratch(
        meta.ctypes.data, int(bf16), int(stream), n, splits)
    if floats < 0:
        raise ValueError("fused_embed_trunk_bwd: the kernels refuse this "
                         "trunk")
    return torch.empty(floats, device=dev, dtype=torch.float32)


def f32_route() -> str:
    """The route the built f32 ("highest") trunk kernels take (builds
    csrc/embed_trunk.cu on first use)."""
    return _lib().hosnerf_trunk_f32_route().decode()
