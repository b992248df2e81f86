"""The bf16 trunk kernels' host-side layout (hosnerf_tpu_torch/ops/cuda/
mlp.py: `_layer_plan`, `_trunk_plan`, `_pack_meta`), checked on the CPU
against a short emulation of wgmma's 128-byte swizzle, without JAX.

The kernels (csrc/trunk_common.cuh, csrc/embed_trunk_bwd.cu) read every
weight chunk and activation tile as [rows][64 cols] bf16 images in which
row r keeps its 16-byte group j at group j ^ (r % 8), and address each
16-column K-step by a byte offset into the warpgroup's Xs or Hs image.
These tests unpack the weight images to the original weights, decode
every K-step to the column it reads, and run the forward on emulated
shared-memory images, step by step as the kernel does.
"""

import numpy as np
import pytest
import torch

from hosnerf_tpu_torch.ops.cuda import mlp as cmlp

# name: (embed spec or raw trunk spec, hid, depth, out_dim)
EMBED = {
    "canonical": (dict(kind="fourier", multires=10, aux_width=64,
                       aux_mode="broadcast", aux_first=False, skip_before=5,
                       skip_source="full_input"), 256, 8, 4),
    "nonrigid": (dict(kind="hannw", multires=6, aux_width=75,
                      aux_mode="stream", aux_first=True, skip_before=4,
                      skip_source="embed"), 128, 6, 3),
    "narrow": (dict(kind="fourier", multires=4, aux_width=8,
                    aux_mode="stream", aux_first=False, skip_before=2,
                    skip_source="embed"), 32, 4, 4),
}
RAW = {
    "raw_canonical": (dict(din=127, skip_before=5, skip_order="input_first",
                           skip_off=0, skip_width=127), 256, 8, 4),
    "raw_nonrigid": (dict(din=111, skip_before=4, skip_order="h_first",
                          skip_off=75, skip_width=36), 128, 6, 3),
    "raw_narrow": (dict(din=40, skip_before=2, skip_order="input_first",
                        skip_off=8, skip_width=20), 32, 3, 2),
}


def _swizzle_index(r, c):
    """Element index of (row r, column c) in a 64-row image of [64][64]
    panels: the address a kernel computes, with the hardware's XOR of the
    16-byte group by the row within its 8-row group."""
    logical = r * 128 + (c % 64) * 2
    return (c // 64) * 4096 + (logical ^ ((r % 8) << 4)) // 2


def _emb_width(kw):
    return 3 * (kw["kind"] == "fourier") + 6 * kw["multires"]


def _layers(din_of, hid, depth, out_dim, seed):
    rng = np.random.default_rng(seed)
    layers = []
    for i in range(depth):
        k = din_of(i)
        layers.append((torch.from_numpy(rng.normal(0, k ** -0.5, (hid, k))
                                        .astype(np.float32)),
                       torch.from_numpy(rng.normal(0, 0.1, hid)
                                        .astype(np.float32))))
    out = (torch.from_numpy(rng.normal(0, 0.05, (out_dim, hid))
                            .astype(np.float32)),
           torch.from_numpy(rng.normal(0, 0.01, out_dim).astype(np.float32)))
    return layers, out


def _embed_case(name, seed=0):
    kw, hid, depth, out_dim = EMBED[name]
    ex, A = _emb_width(kw), kw["aux_width"]
    skip_w = ex + A if kw["skip_source"] == "full_input" else ex

    def din(i):
        return ex + A if i == 0 else hid + (skip_w if i == kw["skip_before"]
                                            else 0)

    layers, out = _layers(din, hid, depth, out_dim, seed)
    espec = cmlp.EmbedSpec(kw["kind"], kw["multires"], A, kw["aux_mode"],
                           kw["aux_first"])
    stride = 0 if kw["aux_mode"] == "broadcast" else A
    plan, _, xw, _ = cmlp._layer_plan(layers, espec, kw["skip_before"],
                                      kw["skip_source"])
    meta, w_all, b_all, wout, bout = cmlp._pack(
        layers, out, espec, kw["skip_before"], kw["skip_source"], "bf16",
        stride)
    return layers, plan, xw, meta, w_all, (kw, espec, b_all, out)


def _raw_case(name, seed=0):
    kw, hid, depth, out_dim = RAW[name]
    spec = cmlp.TrunkSpec(**kw)

    def din(i):
        return kw["din"] if i == 0 else hid + (kw["skip_width"]
                                               if i == kw["skip_before"]
                                               else 0)

    layers, out = _layers(din, hid, depth, out_dim, seed)
    x = torch.zeros(4, kw["din"])
    plan, _, meta, w_all, *_ = cmlp._trunk_args(x, layers, out, spec, "bf16")
    return layers, plan, int(meta[3]), meta, w_all, None


def _case(name):
    return _embed_case(name) if name in EMBED else _raw_case(name)


def _meta_layers(meta):
    """Decode the per-layer part of the meta array and the K-step table."""
    L = int(meta[0])
    p, out = 10, []
    for _ in range(L):
        segs = [tuple(int(v) for v in meta[p + 4 * s:p + 4 * s + 4])
                for s in range(2)]
        out.append(dict(segs=[s for s in segs if s[2] > 0],
                        K=int(meta[p + 8]), w_off=int(meta[p + 9]),
                        step0=int(meta[p + 10]), nsteps=int(meta[p + 11])))
        p += 12
    n_steps = int(meta[p + 1])
    return out, [int(v) for v in meta[p + 2:p + 2 + n_steps]]


def _unswizzle_chunks(img, rows, K):
    """[rows, K] from K / 64 chunk images [rows][64], read as the kernel
    addresses them."""
    r, c = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    idx = torch.from_numpy(_swizzle_index(r, c))
    return torch.cat([img[ch * rows * 64:(ch + 1) * rows * 64][idx].float()
                      for ch in range(K // 64)], dim=1)


ALL = sorted(EMBED) + sorted(RAW)


@pytest.mark.parametrize("name", ALL)
def test_weight_image_unpacks_to_the_weights(name):
    """Every layer's image, unswizzled, is its bf16 weights scattered into
    `cols` of a [HID, K] block, zero elsewhere; layers lie back to back
    from offset 0 and each segment starts a 64-column chunk."""
    layers, plan, _, meta, w_all, _ = _case(name)
    hid = int(meta[1])
    lay, _ = _meta_layers(meta)
    w_off = 0
    for (w, _), (segs, K, cols), ml in zip(layers, plan, lay):
        assert ml["K"] == K and ml["w_off"] == w_off and K % 64 == 0
        assert [s[3] % 64 for s in ml["segs"]] == [0] * len(ml["segs"])
        assert ml["segs"] == [tuple(s) for s in segs]
        blk = _unswizzle_chunks(w_all[w_off:w_off + hid * K], hid, K)
        want = torch.zeros(hid, K)
        want[:, cols] = w.to(torch.bfloat16).float()
        assert torch.equal(blk, want)
        w_off += hid * K
    assert w_all.numel() == w_off and w_all.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ALL)
def test_ksteps_address_the_planned_columns(name):
    """Each 16-column K-step reads, at its byte offset in Xs or Hs, the 16
    buffer columns that `_layer_plan` / `_trunk_plan` put at its packed
    columns, and the steps cover every segment once, in packed order."""
    layers, plan, xw, meta, _, _ = _case(name)
    hid = int(meta[1])
    lay, steps = _meta_layers(meta)
    assert int(meta[3]) == xw <= cmlp.MAX_XW
    nxt = 0
    for (segs, K, _), ml in zip(plan, lay):
        assert ml["step0"] == nxt
        mine = steps[nxt:nxt + ml["nsteps"]]
        nxt += ml["nsteps"]
        want = [(buf, off + j, kpos + j) for buf, off, width, kpos in segs
                for j in range(0, width, 16)]
        got = []
        for st in mine:
            byte, buf = st & 0xFFFF, (st >> 16) & 1
            kk, chunk = (st >> 17) & 3, st >> 20
            panel, inner = divmod(byte, 8192)
            assert inner % 32 == 0 and inner < 128
            got.append((buf, panel * 64 + inner // 2, chunk * 64 + kk * 16))
        assert got == want
        for buf, col, kg in got:
            assert col + 16 <= (xw if buf == 0 else hid) and kg + 16 <= K
    assert nxt == len(steps)


def _image(rows_vals):
    """A 64-row bf16 image of [64][64] panels holding rows_vals [64, C]."""
    n, C = rows_vals.shape
    img = torch.zeros(-(-C // 64) * 4096)
    r, c = np.meshgrid(np.arange(n), np.arange(C), indexing="ij")
    img[torch.from_numpy(_swizzle_index(r, c))] = rows_vals.float()
    return img


def _read(img, byte, rows, cols):
    """[rows, cols] read from an image at a descriptor's start offset, as
    wgmma reads a K-major tile (8-row groups 1024 bytes apart)."""
    base, inner = divmod(byte, 8192)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    logical = r * 128 + inner + 2 * c
    return img[torch.from_numpy(base * 4096 + (logical ^ ((r % 8) << 4)) // 2)]


@pytest.mark.parametrize("name", ["nonrigid", "narrow", "canonical"])
def test_emulated_forward_matches_plain(name):
    """The bf16 forward run on emulated images of one warpgroup's 64 rows,
    the way csrc/trunk_common.cuh `embed_trunk_bf16` runs it: per layer,
    per weight chunk, one product per K-step of A read from Xs/Hs at the
    step's offset and B from the chunk image; round, bias, ReLU, write Hs.
    It matches the plain version at its rounding points (f32 sums in
    another order: 1e-2 of the scale, as the kernels are held)."""
    layers, plan, xw, meta, w_all, (kw, espec, b_all, out) = _case(name)
    hid = int(meta[1])
    rng = np.random.default_rng(1)
    n = 64
    x = torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32))
    A = kw["aux_width"]
    aux = torch.from_numpy(rng.normal(0, 1, (n, A) if kw["aux_mode"] ==
                                      "stream" else (A,)).astype(np.float32))
    alpha = 3.5
    ref = cmlp.fused_embed_trunk_plain(
        x, aux, alpha, layers, out, espec=espec,
        skip_before=kw["skip_before"], skip_source=kw["skip_source"])
    # Xs in the kernel's column order: [PE | pad | aux | pad]
    full = cmlp.trunk_input(x, aux, alpha, espec)
    ex_w, exp_w = espec.ex_width, int(meta[4])
    ex, au = (full[:, A:], full[:, :A]) if espec.aux_first else \
        (full[:, :ex_w], full[:, ex_w:])
    xs = torch.zeros(n, xw)
    xs[:, :ex_w], xs[:, exp_w:exp_w + A] = ex, au
    imgs = {0: _image(xs.to(torch.bfloat16).float()),
            1: torch.zeros(max(1, hid // 64) * 4096)}
    lay, steps = _meta_layers(meta)
    for i, ml in enumerate(lay):
        acc = torch.zeros(n, hid)
        for st in steps[ml["step0"]:ml["step0"] + ml["nsteps"]]:
            chunk = ml["w_off"] + (st >> 20) * hid * 64
            wimg = w_all[chunk:chunk + hid * 64].float()
            a = _read(imgs[(st >> 16) & 1], st & 0xFFFF, n, 16)
            b = _read(wimg, ((st >> 17) & 3) * 32, hid, 16)
            acc += a @ b.T
        h = torch.relu((acc.to(torch.bfloat16).float()
                        + b_all[i].float()).to(torch.bfloat16).float())
        imgs[1] = _image(h)
    got = h @ out[0].T + out[1]
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-2 * scale
