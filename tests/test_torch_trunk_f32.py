"""The f32 ("highest") trunk kernels' bf16x3 route, checked on the CPU
without JAX: the weight pieces the packer builds
(hosnerf_tpu_torch/ops/cuda/mlp.py `split3`, `_packed_weights`), and an
emulation of the kernels' product terms, in their order, read through the
packed images, held to the plain versions at the chip's tolerances.

The kernels (csrc/trunk_common.cuh `embed_trunk_x3`, csrc/embed_trunk_bwd.cu
`rows_bwd_x3`, `dw_x3`) take every f32 operand as three bf16 pieces hi,
mid, lo and every f32 product as the six piece products with piece indices
qa + qb <= 2. The forward sums each 64-column weight chunk's products (its
pieces streamed lo, mid, hi; hi hi last) in a fresh accumulator and adds it
to the layer's sum; the backward stores activations and gc as pieces, masks
by the stored hi piece and sums each chunk's input gradient over K = HID.
"""

import numpy as np
import pytest
import torch

from hosnerf_tpu_torch.ops.cuda import mlp as cmlp

# name: (embed spec, hid, depth, out_dim): the production trunks' layouts
EMBED = {
    "canonical": (dict(kind="fourier", multires=10, aux_width=64,
                       aux_mode="broadcast", aux_first=False, skip_before=5,
                       skip_source="full_input"), 256, 8, 4),
    "nonrigid": (dict(kind="hannw", multires=6, aux_width=75,
                      aux_mode="stream", aux_first=True, skip_before=4,
                      skip_source="embed"), 128, 6, 3),
}
# tools/bench_mlp.py's canonical layout on raw rows, and a narrow one whose
# skip slice is copied into the aux columns
RAW = {
    "raw_canonical": (dict(din=127, skip_before=5, skip_order="input_first",
                           skip_off=0, skip_width=127), 256, 8, 4),
    "raw_narrow": (dict(din=40, skip_before=2, skip_order="h_first",
                        skip_off=8, skip_width=20), 32, 3, 2),
}
N = 64            # one CTA tile of the f32 kernels
TOL_FWD = 1e-5    # chip_smoke.py TOL_MLP["highest"], of the output's scale
TOL_BWD = (2e-3, 1e-2, 1e-3)   # chip_smoke.py TOL_BWD["mlp_highest"]
# the six piece products (qa, qb) of a weight piece qb, in the kernels'
# order: pieces lo (2), mid (1), hi (0); within one, hi (0) of A last
SCHEDULE = [(qa, qb) for qb in (2, 1, 0) for qa in range(2 - qb, -1, -1)]

torch.set_num_threads(1)


def _swizzle_index(r, c):
    """Element index of (row r, column c) in a 64-row image of [64][64]
    panels (the hardware's XOR of the 16-byte group by r % 8)."""
    logical = r * 128 + (c % 64) * 2
    return (c // 64) * 4096 + (logical ^ ((r % 8) << 4)) // 2


def _unswizzle(img, rows):
    """[rows, 64] from one chunk image [rows][64]."""
    r, c = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    return img[torch.from_numpy(_swizzle_index(r, c))].float()


def _image(vals):
    """A 64-row image of [64][64] panels holding vals [64, C]."""
    n, C = vals.shape
    img = torch.zeros(-(-C // 64) * 4096)
    r, c = np.meshgrid(np.arange(n), np.arange(C), indexing="ij")
    img[torch.from_numpy(_swizzle_index(r, c))] = vals.float()
    return img


def _read(img, byte, rows, cols):
    """[rows, cols] read at a descriptor's start byte, K-major."""
    base, inner = divmod(byte, 8192)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    logical = r * 128 + inner + 2 * c
    return img[torch.from_numpy(base * 4096 + (logical ^ ((r % 8) << 4))
                                // 2)]


def _meta_layers(meta):
    """The per-layer part of the meta array and the K-step table."""
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


def _layers(din_of, hid, depth, out_dim, rng):
    layers = []
    for i in range(depth):
        k = din_of(i)
        layers.append((torch.from_numpy(rng.normal(0, k ** -0.5, (hid, k))
                                        .astype(np.float32)),
                       torch.from_numpy(rng.normal(0, 0.1, hid)
                                        .astype(np.float32))))
    out = (torch.from_numpy(rng.normal(0, 0.3, (out_dim, hid))
                            .astype(np.float32)),
           torch.from_numpy(rng.normal(0, 0.01, out_dim).astype(np.float32)))
    return layers, out


def _embed_case(name):
    kw, hid, depth, out_dim = EMBED[name]
    rng = np.random.default_rng(3)
    ex = 3 * (kw["kind"] == "fourier") + 6 * kw["multires"]
    A = kw["aux_width"]
    skip_w = ex + A if kw["skip_source"] == "full_input" else ex
    layers, out = _layers(
        lambda i: ex + A if i == 0 else hid + (skip_w if i == kw["skip_before"]
                                               else 0), hid, depth, out_dim,
        rng)
    espec = cmlp.EmbedSpec(kw["kind"], kw["multires"], A, kw["aux_mode"],
                           kw["aux_first"])
    x = torch.from_numpy(rng.uniform(-1, 1, (N, 3)).astype(np.float32))
    stream = kw["aux_mode"] == "stream"
    aux = torch.from_numpy(rng.normal(0, 1, (N, A) if stream else (A,))
                           .astype(np.float32))
    meta, w_all, b_all, _, _ = cmlp._pack(
        layers, out, espec, kw["skip_before"], kw["skip_source"], "highest",
        A if stream else 0)
    plan = cmlp._layer_plan(layers, espec, kw["skip_before"],
                            kw["skip_source"])[0]
    alpha = 2.5
    # Xs in the kernel's column order: [PE | pad | aux | pad]
    full = cmlp.trunk_input(x, aux, alpha, espec)
    ex_w, exp_w = espec.ex_width, int(meta[4])
    exs, auxs = (full[:, A:], full[:, :A]) if espec.aux_first else \
        (full[:, :ex_w], full[:, ex_w:])
    xs = torch.zeros(N, int(meta[3]))
    xs[:, :ex_w], xs[:, exp_w:exp_w + A] = exs, auxs
    kws = dict(espec=espec, skip_before=kw["skip_before"],
               skip_source=kw["skip_source"], precision="highest")
    gout = torch.from_numpy(rng.normal(0, 1, (N, out_dim))
                            .astype(np.float32))
    return dict(layers=layers, out=out, plan=plan, meta=meta, w_all=w_all,
                b_all=b_all, xs=xs, gout=gout,
                plain=lambda: cmlp.fused_embed_trunk_plain(
                    x, aux, alpha, layers, out, **kws),
                plain_bwd=lambda: cmlp.fused_embed_trunk_bwd_plain(
                    x, aux, alpha, layers, out, gout, **kws),
                finish=lambda dxs: _embed_grads(dxs, x, espec, alpha, meta,
                                                stream))


def _embed_grads(dxs, x, espec, alpha, meta, stream):
    """dx and daux from the gradient over the Xs columns."""
    ex_w, exp_w, A = espec.ex_width, int(meta[4]), espec.aux_width
    g_aux = dxs[:, exp_w:exp_w + A]
    return [cmlp.embed_bwd(x, dxs[:, :ex_w], espec, alpha),
            g_aux if stream else g_aux.sum(0)]


def _raw_case(name):
    kw, hid, depth, out_dim = RAW[name]
    rng = np.random.default_rng(4)
    spec = cmlp.TrunkSpec(**kw)
    layers, out = _layers(
        lambda i: kw["din"] if i == 0 else hid + (
            kw["skip_width"] if i == kw["skip_before"] else 0),
        hid, depth, out_dim, rng)
    x = torch.from_numpy(rng.normal(0, 1, (N, kw["din"])).astype(np.float32))
    plan, _, meta, w_all, b_all, _, _, A = cmlp._trunk_args(
        x, layers, out, spec, "highest")
    exp_w = int(meta[4])
    xs = torch.zeros(N, int(meta[3]))
    xs[:, :kw["din"]] = x
    sl = slice(kw["skip_off"], kw["skip_off"] + kw["skip_width"])
    if A:
        xs[:, exp_w:exp_w + A] = x[:, sl]
    gout = torch.from_numpy(rng.normal(0, 1, (N, out_dim))
                            .astype(np.float32))

    def finish(dxs):
        dx = dxs[:, :kw["din"]].clone()
        if A:
            dx[:, sl] += dxs[:, exp_w:exp_w + A]
        return [dx]

    return dict(layers=layers, out=out, plan=plan, meta=meta, w_all=w_all,
                b_all=b_all, xs=xs, gout=gout,
                plain=lambda: cmlp.fused_trunk_plain(
                    x, layers, out, spec=spec, precision="highest"),
                plain_bwd=lambda: cmlp.fused_trunk_bwd_plain(
                    x, layers, out, gout, spec=spec, precision="highest"),
                finish=finish)


@pytest.fixture(scope="module", params=sorted(EMBED) + sorted(RAW))
def case(request):
    name = request.param
    return _embed_case(name) if name in EMBED else _raw_case(name)


def _pieces(c, i, chunk):
    """Layer i's weight chunk as its three unswizzled piece images [3, HID,
    64] (hi, mid, lo), read where the producer copies them from."""
    hid = int(c["meta"][1])
    lay, _ = _meta_layers(c["meta"])
    base = 3 * lay[i]["w_off"] + 3 * chunk * hid * 64
    return torch.stack([_unswizzle(c["w_all"][base + q * hid * 64:
                                              base + (q + 1) * hid * 64], hid)
                        for q in range(3)])


def test_weight_pieces_reconstruct_the_weights(case):
    """Each chunk's three piece images are bf16(w), bf16(w - hi) and
    bf16(w - hi - mid) of the packed f32 weights, and their sum is w to
    2^-24 of |w|."""
    c = case
    for i, ((w, _), (_, K, cols)) in enumerate(zip(c["layers"], c["plan"])):
        wp = torch.zeros(w.shape[0], K)
        wp[:, cols] = w
        got = torch.cat([_pieces(c, i, ch) for ch in range(K // 64)], dim=2)
        hi = wp.to(torch.bfloat16).float()
        mid = (wp - hi).to(torch.bfloat16).float()
        assert torch.equal(got[0], hi) and torch.equal(got[1], mid)
        assert torch.equal(got[2], (wp - hi - mid).to(torch.bfloat16).float())
        err = (got.double().sum(0) - wp.double()).abs()
        assert bool((err <= 2.0 ** -24 * wp.double().abs()).all())


def _forward(c, drop=None):
    """The f32 forward on emulated images as embed_trunk_x3 runs it: per
    layer, per chunk, a fresh sum u over the SCHEDULE's piece products of
    each K-step (A read from the Xs/Hs piece images at the step's offset, B
    from the weight piece image), u added to the layer's sum; bias, ReLU,
    split into Hs. `drop`: one (qa, qb) left out. Returns (output, [per
    layer f32 input, output])."""
    meta, hid = c["meta"], int(c["meta"][1])
    lay, steps = _meta_layers(meta)
    imgs = {0: [_image(p) for p in cmlp.split3(c["xs"])],
            1: [torch.zeros(max(1, hid // 64) * 4096)] * 3}
    bufs = {0: c["xs"], 1: None}
    acts = []
    for i, ml in enumerate(lay):
        a_in = torch.cat([bufs[b][:, off:off + wd]
                          for b, off, wd, _ in ml["segs"]], dim=1)
        acc = torch.zeros(N, hid)
        for ch in range(ml["K"] // 64):
            pieces = _pieces(c, i, ch)
            mine = [st for st in steps[ml["step0"]:ml["step0"] + ml["nsteps"]]
                    if st >> 20 == ch]
            u = torch.zeros(N, hid)
            for qa, qb in SCHEDULE:
                if (qa, qb) == drop:
                    continue
                for st in mine:
                    a = _read(imgs[(st >> 16) & 1][qa], st & 0xFFFF, N, 16)
                    kk = ((st >> 17) & 3) * 16
                    u += a.float() @ pieces[qb][:, kk:kk + 16].T
            acc += u
        h = torch.relu(acc + c["b_all"][i])
        imgs[1] = [_image(p) for p in cmlp.split3(h)]
        bufs[1] = h
        acts.append((a_in, h))
    out = c["out"]
    return h @ out[0].T + out[1], acts


def test_emulated_forward_matches_plain(case):
    """The emulated bf16x3 forward agrees with the plain f32 version within
    the chip's f32 tolerance (1e-5 of the output's scale)."""
    got, _ = _forward(case)
    ref = case["plain"]()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= TOL_FWD * scale


@pytest.mark.parametrize("drop", [(0, 1), (1, 0)])
def test_forward_without_a_cross_term_fails(case, drop):
    """Leaving out one cross term of order 2^-8 (hi mid or mid hi) moves
    the output beyond that tolerance: the test tells the schedules apart.
    (A term of order 2^-16, lo hi, moves it by ~3e-6 of the scale, under
    the tolerance.)"""
    got, _ = _forward(case, drop)
    ref = case["plain"]()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) > TOL_FWD * scale


def _backward(c):
    """The f32 backward as rows_bwd_x3 and dw_x3 run it, on the pieces the
    recompute stores: the head on the pieces' f32 sum, the mask from the
    hi piece, gc split into pieces, per weight chunk the SCHEDULE's piece
    products over K = HID, dW from the six piece products of gc and the
    stored input pieces. Returns the plain versions' tuple."""
    meta, hid = c["meta"], int(c["meta"][1])
    lay, _ = _meta_layers(meta)
    _, acts = _forward(c)
    out, gout = c["out"], c["gout"]
    h_last = cmlp.split3(acts[-1][1]).float().sum(0)
    dout = (gout.T @ h_last, gout.sum(0))
    g = gout @ out[0]
    dxs = torch.zeros_like(c["xs"])
    dlayers = [None] * len(lay)
    for i in reversed(range(len(lay))):
        ml = lay[i]
        a_in, h_out = acts[i]
        g = g * (cmlp.split3(h_out)[0].float() > 0)
        gp = cmlp.split3(g).float()
        ap = cmlp.split3(a_in).float()
        # dW: the six piece products, [HID, K] in packed columns
        dwp = torch.zeros(hid, ml["K"])
        kcols = torch.cat([torch.arange(kp, kp + wd)
                           for _, _, wd, kp in ml["segs"]])
        for qg, qa in ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)):
            dwp[:, kcols] += gp[qg].T @ ap[qa]
        dlayers[i] = (dwp[:, c["plan"][i][2]], g.sum(0))
        # input gradients chunk by chunk, routed by segment
        gin = torch.zeros(N, ml["K"])
        for ch in range(ml["K"] // 64):
            pieces = _pieces(c, i, ch)
            u = torch.zeros(N, 64)
            for qa, qb in SCHEDULE:
                u += gp[qa] @ pieces[qb]
            gin[:, 64 * ch:64 * ch + 64] = u
        g = torch.zeros(N, hid)
        for b, off, wd, kp in ml["segs"]:
            if b:
                g[:, off:off + wd] = gin[:, kp:kp + wd]
            else:
                dxs[:, off:off + wd] += gin[:, kp:kp + wd]
    return (*c["finish"](dxs), dlayers, dout)


def _close(got, ref, what):
    """chip_smoke.py's `close` at TOL_BWD: relative L2, and at most a share
    of entries beyond the max bound of the reference's scale."""
    scale = float(ref.abs().max()) + 1e-30
    diff = (got - ref).abs()
    l2 = float(torch.linalg.norm(got - ref) / (torch.linalg.norm(ref)
                                                + 1e-30))
    share = float((diff > TOL_BWD[1] * scale).float().mean())
    assert l2 <= TOL_BWD[0] and share <= TOL_BWD[2], (what, l2, share)


def test_emulated_backward_matches_plain(case):
    """The emulated bf16x3 backward agrees with the plain f32 backward
    output by output (dx, daux, every dW and db, the head's) within the
    chip's f32 backward tolerance."""
    got = _backward(case)
    ref = case["plain_bwd"]()

    def flat(t):
        *head, dlayers, dout = t
        return list(head) + [v for p in dlayers for v in p] + list(dout)

    g, r = flat(got), flat(ref)
    assert len(g) == len(r)
    for i, (a, b) in enumerate(zip(g, r)):
        assert a.shape == b.shape, i
        _close(a, b, f"output {i}")


def test_f32_width_256_rejects_wide_inputs():
    """At width 256 the f32 kernels' three-piece Xs and Hs images fill
    shared memory at 128 input columns: the packer raises above that (the
    bf16 kernels take 256), before any launch."""
    rng = np.random.default_rng(5)
    espec = cmlp.EmbedSpec("fourier", 10, 128, "broadcast", False)
    din = espec.ex_width + 128
    layers, out = _layers(lambda i: din if i == 0 else 256, 256, 2, 4, rng)
    args = (layers, out, espec, None, "embed")
    assert cmlp._pack(*args, "bf16", 0)[0][3] == 192
    with pytest.raises(ValueError, match="at most 128 input columns"):
        cmlp._pack(*args, "highest", 0)
