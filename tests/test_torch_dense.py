"""The port's dense per-sample slice against the JAX package on the CPU:
the four inverse-LBS cores (one kernel pair in four row orders), the
all-bone weights, the trunk-only MLP, the pair-grid prototype, and the
human field's dense path with its training step, `mlp_chunk` and `remat`.

Inputs are made from numpy seeds and handed to both packages; the JAX
Pallas kernels run in interpret mode (as tests/test_pallas_lbs.py runs
them), the port's kernel entries on CPU tensors take their plain versions.
Each tolerance is stated where it is used.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hosnerf_tpu.data import synthetic
from hosnerf_tpu.models.human import HumanObjectField as JaxField
from hosnerf_tpu.ops.pallas import lbs as plbs
from hosnerf_tpu.ops.pallas import mlp as pmlp
from hosnerf_tpu.train import stage2 as jstage2
from hosnerf_tpu_torch import convert
from hosnerf_tpu_torch.models.human import HumanObjectField
from hosnerf_tpu_torch.models.layers import resolve_remat
from hosnerf_tpu_torch.ops import lbs as tlbs
from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
from hosnerf_tpu_torch.tools import proto_pairgrid as tproto
from hosnerf_tpu_torch.train import stage2 as tstage2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITER = 60_000      # non-rigid condition and the full hann band are on


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, ref):
    """(max error / max |ref|, relative L2 error)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max() + 1e-30
    return (np.abs(got - ref).max() / scale,
            np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-30))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the four inverse-LBS cores: one kernel pair, four row orders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pg():
    """tests/test_pallas_lbs.py's `data_pg` case (N = 700, B = 26, G = 32,
    every other bone far out of support) as grid-space tables."""
    rng = np.random.RandomState(1)
    B, G, N = 26, 32, 700
    pts = (rng.randn(N, 3) * 0.7).astype(np.float32)
    Rs = np.stack([np.eye(3) + 0.1 * rng.randn(3, 3) for _ in range(B)])
    Ts = 0.2 * rng.randn(B, 3)
    Ts[::2] += 50.0
    vol = jax.nn.softmax(jnp.asarray(rng.randn(B + 1, G, G, G), jnp.float32),
                         axis=0)
    bmin = jnp.asarray([-1.3, -1.1, -1.2], jnp.float32)
    bscale = jnp.asarray([0.9, 1.0, 1.1], jnp.float32)
    s, o = plbs._grid_affine(bmin, bscale, G)
    rg = (jnp.asarray(Rs, jnp.float32) * s[None, :, None]).reshape(B, 9)
    tg = jnp.asarray(Ts, jnp.float32) * s[None] + o[None]
    vol_qz = jnp.transpose(vol[:B], (0, 3, 2, 1)).reshape(B, G * G, G)
    return dict(pts=jnp.asarray(pts), rg=rg, tg=tg, vol_qz=vol_qz,
                vol=vol, bmin=bmin, bscale=bscale)


ENTRIES = {"dense": (plbs.inverse_core, clbs.inverse_core),
           "quad": (plbs.inverse_core_pg, clbs.inverse_core_pg),
           "win": (plbs.inverse_core_pgw, clbs.inverse_core_pgw),
           "bp": (plbs.inverse_core_bp, clbs.inverse_core_bp)}


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_inverse_entry_matches_jax_core(pg, name, prec):
    """Each port entry (plain B1 in its row order) against its own JAX core
    (Pallas in interpret mode). Both round the same quantities; the f32
    order of their sums differs: a few f32 ulps of grid coordinates up to
    G = 32 (ulp 3.8e-6) -> atol 3e-5 on the coordinate sums and 2e-6 on
    the weight sum. In bf16 the TPU cores build the grid coordinate in
    another order too, so a tap product hx*hy an ulp away from a bf16
    rounding boundary rounds to the other neighbour (one bf16 ulp, <= 2^-7
    of the weight) -> at most 2% of the entries beyond those atols, none
    beyond 2^-7 of the column's scale (observed 0.5% of entries, 2e-5 of
    the scale). The windowed core's result is finite (its TPU table did
    not overflow)."""
    jcore, tcore = ENTRIES[name]
    ref = np.asarray(jcore(pg["pts"], pg["rg"], pg["tg"], pg["vol_qz"], prec))
    got = tcore(_t(pg["pts"]), _t(pg["rg"]), _t(pg["tg"]), _t(pg["vol_qz"]),
                prec).numpy()
    assert np.isfinite(ref).all() and got.shape == ref.shape
    for cols, atol in ((slice(0, 3), 3e-5), (slice(3, 4), 2e-6)):
        err = np.abs(got[:, cols] - ref[:, cols])
        if prec == "highest":
            assert err.max() <= atol
        else:
            assert (err > atol).mean() <= 0.02
            assert err.max() <= 2 ** -7 * np.abs(ref[:, cols]).max()
    assert (ref[:, 3] > 0).sum() > 100        # the support is not empty


@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_inverse_entry_grads_match_jax_dense_vjp(pg, prec):
    """The VJP of JAX `inverse_core` (the dense core; JAX's own tests hold
    its pair-grid cores to it) is the oracle for all four port entries,
    whose backward is plain B4 in their row order. highest: f32 order
    only -> 1e-5 of each gradient's scale; bf16: a term such as gw * hz
    that the two sum in another order can round to the other bf16
    neighbour (2^-9 of itself) -> 5e-4 of the scale (test_torch_train's
    B4 reasoning)."""
    args = (pg["pts"], pg["rg"], pg["tg"], pg["vol_qz"])
    gacc = np.random.default_rng(2).normal(size=(700, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: plbs.inverse_core(*a, prec), *args)
    ref = vjp(jnp.asarray(gacc))
    tol = 5e-4 if prec == "bf16" else 1e-5
    for name, (_, tcore) in sorted(ENTRIES.items()):
        targs = [_t(a).requires_grad_() for a in args]
        tcore(*targs, prec).backward(_t(gacc))
        for what, a, b in zip(("dpts", "drg", "dtg", "dvol"), targs, ref):
            assert np.abs(np.asarray(b)).max() > 0, what
            err, _ = _rel(a.grad.numpy(), b)
            assert err <= tol, (name, what, err)


def test_inverse_lbs_dispatch_and_row_orders(pg):
    """`ops/lbs.py::inverse_warp` as the JAX dispatch: 'pallas' reaches the
    pair-grid core named by pg_impl, 'pallas_dense' the dense core; the
    four give the same values per sample (they are one computation), and
    the Morton, signature + Morton and signature orders are permutations
    of whole 8-sample groups."""
    pts, vol = _t(pg["pts"]), _t(pg["vol"])
    m_sR = torch.eye(3).repeat(26, 1, 1) * 0.9
    m_T = torch.randn(26, 3, generator=torch.Generator().manual_seed(0))
    outs = {}
    for impl, pgi in (("pallas", "quad"), ("pallas", "win"),
                      ("pallas", "bp"), ("pallas_dense", "quad")):
        outs[impl, pgi] = tlbs.inverse_warp(
            pts, m_sR, m_T, vol, _t(pg["bmin"]), _t(pg["bscale"]),
            impl=impl, pg_impl=pgi)
    ref = outs["pallas_dense", "quad"]
    for k, (x, w) in outs.items():
        assert torch.equal(x, ref[0]) and torch.equal(w, ref[1]), k
    with pytest.raises(ValueError, match="pg_impl"):
        tlbs.inverse_warp(pts, m_sR, m_T, vol, _t(pg["bmin"]),
                          _t(pg["bscale"]), impl="pallas", pg_impl="tri")
    pts_p = clbs._pad_points(pts)
    rg, tg = _t(pg["rg"]), _t(pg["tg"])
    for order in (clbs._morton_order, clbs._sig_morton_order,
                  clbs._support_order):
        gperm = order(pts_p, rg, tg, 32, 700)
        assert sorted(gperm.tolist()) == list(range(pts_p.shape[0] // 8))
        assert gperm.tolist() != sorted(gperm.tolist())


@pytest.mark.parametrize("pg_sort", clbs.PG_SORTS)
def test_quad_route_row_order_matches_jax(pg, monkeypatch, pg_sort):
    """The quad core's rows reach B1 in JAX's order for each HOSNERF_PG_SORT:
    'sig' in `bp_prepare(kind="quad")`'s (signature sort over rows padded
    to TILE_PG) at its k0, 'morton' in `_group_sort_perm`'s; unsorted, the
    values are the Morton route's bit for bit (one per-sample function)."""
    pts, rg, tg, vol_qz = (_t(pg[k]) for k in ("pts", "rg", "tg", "vol_qz"))
    seen = []
    apply = clbs._InverseCore.apply
    monkeypatch.setattr(clbs._InverseCore, "apply",
                        lambda *a: seen.append(a) or apply(*a))
    got = clbs.inverse_core_pg(pts, rg, tg, vol_qz, "bf16", pg_sort)
    (rows, *_, k0), = seen
    pts_p, _ = plbs._pad_rows(pg["pts"], plbs.TILE_PG)
    if pg_sort == "sig":
        dom = plbs.bp_prepare(pg["pts"], pg["rg"], pg["tg"], 32, 26,
                              kind="quad")
        perm = np.asarray(dom.perm)
        k0_ref = int(dom.n_dead_groups) * plbs.SORT_GROUP // clbs.INV_TILE
        assert int(k0) == k0_ref and int(dom.n_dead_groups) > 0
    else:
        perm = np.asarray(plbs._group_sort_perm(pts_p)[0])
        assert k0 is None
    np.testing.assert_array_equal(rows.numpy(), np.asarray(pts_p)[perm])
    assert not np.array_equal(perm, np.arange(perm.size))
    monkeypatch.undo()
    ref = clbs.inverse_core_pg(pts, rg, tg, vol_qz, "bf16", "morton")
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="pg_sort"):
        clbs.inverse_core_pg(pts, rg, tg, vol_qz, "bf16", "zorder")


# ---------------------------------------------------------------------------
# row 7: all-bone weights at shared points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_bone_weights_match_jax(pg, prec):
    """`ops/lbs.py::bone_weights(impl='pallas')` (plain row-7 versions)
    against JAX `ops/pallas/lbs.py::bone_weights` (`shared_core` in
    interpret mode): values and the VJP in the world points and the
    volume, at points spread over the grid. Values: the same rounding
    points, f32 order -> 1e-5 of the scale. Gradients: highest 1e-4 of
    the scale; bf16 1e-3, since gw = bf16(dL/dw) can round apart where
    the two sum its inputs in another order (test_torch_train's B5
    reasoning)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.4, 1.2, (700, 3)).astype(np.float32)
    vol = np.asarray(pg["vol"])
    gw = rng.normal(size=(700, 26)).astype(np.float32)
    jfn = lambda p, v: plbs.bone_weights(p, v, pg["bmin"], pg["bscale"],  # noqa: E731
                                         precision=prec)
    ref, vjp = jax.vjp(jfn, jnp.asarray(pts), jnp.asarray(vol))
    dref = vjp(jnp.asarray(gw))
    tp, tv = _t(pts).requires_grad_(), _t(vol).requires_grad_()
    if prec == "bf16":
        got = tlbs.bone_weights(tp, tv, _t(pg["bmin"]), _t(pg["bscale"]),
                                impl="pallas")
    else:
        got = clbs.bone_weights(tp, tv, _t(pg["bmin"]), _t(pg["bscale"]),
                                precision=prec)
    assert _rel(got.detach().numpy(), ref)[0] <= 1e-5
    assert float(np.asarray(ref).max()) > 0.1
    got.backward(_t(gw))
    tol = 1e-3 if prec == "bf16" else 1e-4
    for what, a, b in (("dpts", tp, dref[0]), ("dvol", tv, dref[1])):
        assert np.abs(np.asarray(b)).max() > 0, what
        assert _rel(a.grad.numpy(), b)[0] <= tol, what


def test_grid_sample_maps_like_grid_affine(pg):
    """The library call timed beside row 7 on the card: grid_sample of the
    [1, B, G, G, G] volume at [1, 1, 1, N, 3] normalised points
    (align_corners=True, zeros padding) computes the f32 all-bone weights
    of `shared_core_plain` in 'highest' (the same grid mapping as
    `_grid_affine`) to f32 order, 1e-5 of the scale."""
    rng = np.random.default_rng(4)
    pts = _t(rng.uniform(-1.4, 1.2, (500, 3)))
    vol = _t(pg["vol"])
    ref = clbs.bone_weights(pts, vol, _t(pg["bmin"]), _t(pg["bscale"]),
                            precision="highest")
    coords = (pts - _t(pg["bmin"])) * _t(pg["bscale"]) - 1.0
    got = torch.nn.functional.grid_sample(
        vol[None, :26], coords[None, None, None], mode="bilinear",
        padding_mode="zeros", align_corners=True)[0, :, 0, 0].T
    assert _rel(got.numpy(), ref.numpy())[0] <= 1e-5


# ---------------------------------------------------------------------------
# row 8: the trunk-only MLP (tools/bench_mlp.py's production layouts)
# ---------------------------------------------------------------------------

TRUNKS = {
    # CanonicalMLP: 127 -> 8 x 256, [input, h] before layer 5, -> 4
    "canonical": dict(din=127, width=256, depth=8, skip_before=5,
                      skip_order="input_first", skip_off=0, skip_width=127,
                      dout=4),
    # NonRigidMLP: [cond 75 | embed 36] -> 6 x 128, [h, embed] before
    # layer 4, -> 3
    "nonrigid": dict(din=111, width=128, depth=6, skip_before=4,
                     skip_order="h_first", skip_off=75, skip_width=36,
                     dout=3),
}
N_TRUNK = 300


def trunk_case(name, seed=0, n=N_TRUNK):
    """(x, flax-oriented layers [(W [din, dout], b)], head, keywords)."""
    c = TRUNKS[name]
    rng = np.random.default_rng(seed)
    layers, prev = [], c["din"]
    for i in range(c["depth"]):
        din = prev + (c["skip_width"] if i == c["skip_before"] else 0)
        layers.append((rng.normal(size=(din, c["width"])).astype(np.float32)
                       / np.sqrt(din),
                       rng.normal(size=c["width"]).astype(np.float32) * 0.1))
        prev = c["width"]
    out = (rng.normal(size=(c["width"], c["dout"])).astype(np.float32) * 0.05,
           rng.normal(size=c["dout"]).astype(np.float32) * 0.01)
    x = rng.normal(size=(n, c["din"])).astype(np.float32)
    kw = {k: c[k] for k in ("skip_before", "skip_order", "skip_off",
                            "skip_width")}
    return x, layers, out, kw


def _torch_trunk(layers, out, grad=False):
    tl = [(_t(w.T).requires_grad_(grad), _t(b).requires_grad_(grad))
          for w, b in layers]
    return tl, (_t(out[0].T).requires_grad_(grad),
                _t(out[1]).requires_grad_(grad))


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_fused_trunk_matches_jax(name, prec):
    """Forward: `ops/cuda/mlp.py::fused_trunk` (plain row-8 version)
    against JAX `pmlp.fused_trunk` (Pallas in interpret mode). highest:
    f32 order only -> 1e-5 of the scale; bf16: the same rounding points,
    but a pre-activation an f32 ulp from a bf16 rounding boundary rounds
    the other way and moves its output by a bf16 ulp -> 1e-2 of the scale
    and at most 5% of the entries beyond 1e-3 of it (the B2 tolerance).
    Gradients: `jax.vjp` of the Pallas kernel body's own jnp trunk
    (`pmlp._forward_tile`, the same rounding points; the fused VJP fails
    on the installed JAX). highest: 1e-4 of each gradient's scale. bf16:
    autodiff keeps bf16 cotangents where the kernel keeps g in f32 and
    rounds only gc -> relative L2 5e-2, as B3 against flax; and against
    the kernel body's own backward (`pmlp._trunk_bwd_tile`, the kernel's
    rounding points), where only entries of gc = bf16(g) that the f32
    order moves across a rounding boundary differ (2^-9 of themselves),
    1e-3 L2 (observed 2.4e-4). Bias gradients have the bias's shape."""
    x, layers, out, kw = trunk_case(name)
    ref = np.asarray(pmlp.fused_trunk(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers],
        (jnp.asarray(out[0]), jnp.asarray(out[1])), precision=prec, **kw))
    tl, to = _torch_trunk(layers, out, grad=True)
    xt = _t(x).requires_grad_()
    got = cmlp.fused_trunk(xt, tl, to, precision=prec, **kw)
    scale = np.abs(ref).max()
    err = np.abs(got.detach().numpy() - ref)
    assert err.max() <= (1e-2 if prec == "bf16" else 1e-5) * scale
    assert (err > 1e-3 * scale).mean() <= 0.05

    gout = np.random.default_rng(5).normal(size=ref.shape).astype(np.float32)
    got.backward(_t(gout))
    spec = pmlp.TrunkSpec([w.shape for w, _ in layers], kw["skip_before"],
                          kw["skip_order"], kw["skip_off"], kw["skip_width"],
                          out[0].shape[1], prec)

    def body(xx, ps, wo, bo):
        return pmlp._forward_tile(xx, ps, wo, bo, spec)

    jl = [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]
    _, vjp = jax.vjp(body, jnp.asarray(x), jl, jnp.asarray(out[0]),
                     jnp.asarray(out[1]))
    dx_r, dl_r, dwo_r, dbo_r = vjp(jnp.asarray(gout))
    pairs = [(xt.grad, dx_r), (to[0].grad.T, dwo_r), (to[1].grad, dbo_r)]
    for (w, b), (dw_r, db_r) in zip(tl, dl_r):
        assert b.grad.shape == b.shape
        pairs += [(w.grad.T, dw_r), (b.grad, db_r)]
    for k, (a, b) in enumerate(pairs):
        err, l2 = _rel(a.numpy(), np.asarray(b, np.float32))
        assert (l2 <= 5e-2) if prec == "bf16" else (err <= 1e-4), (k, err)
    if prec == "bf16":
        dwb = [_Ref(jnp.zeros(np.shape(a), jnp.float32))
               for w, b in jl + [(jnp.asarray(out[0]), jnp.asarray(out[1]))]
               for a in (w, b[None])]
        dx_k = pmlp._trunk_bwd_tile(
            jnp.asarray(x), [(w, b[None]) for w, b in jl],
            jnp.asarray(out[0]), jnp.asarray(out[1])[None],
            jnp.asarray(gout), dwb, spec)
        kern = [dx_k] + [r.value for r in dwb]
        mine = [xt.grad] + [t.grad.T if t.grad.ndim == 2 else t.grad[None]
                            for pair in tl + [to] for t in pair]
        for k, (a, b) in enumerate(zip(mine, kern)):
            _, l2 = _rel(a.numpy(), np.asarray(b))
            assert l2 <= 1e-3, (k, l2)


class _Ref:
    """A stand-in for a Pallas output ref outside a kernel: `r[:, :] += v`
    updates the array it holds."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, v):
        self.value = self.value.at[idx].set(v)


def _unswizzle(img, rows, K):
    """[rows, K] from the bf16 kernels' weight image: K / 64 chunks of
    [rows][64], where row r keeps its 8-column group j at group j ^ (r % 8)
    (wgmma's 128-byte swizzle)."""
    t = img.reshape(K // 64, rows, 8, 8)
    out = torch.empty(rows, K // 64, 8, 8)
    for r in range(rows):
        for pg in range(8):
            out[r, :, pg ^ (r % 8)] = t[:, r, pg]
    return out.reshape(rows, K)


def _weight_matrix(w_all, w_off, hid, K, bf16):
    """[K, hid] from the kernels' weight images of one layer: bf16 chunk
    images, or f32 as three bf16 piece images (hi, mid, lo) per chunk from
    3 w_off on, summed in f32."""
    if bf16:
        return _unswizzle(w_all[w_off:w_off + hid * K].float(), hid, K).T
    blk = w_all[3 * w_off:3 * (w_off + hid * K)].float().reshape(
        K // 64, 3, hid * 64)
    return sum(_unswizzle(blk[:, q].reshape(-1), hid, K)
               for q in range(3)).T


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_trunk_kernel_layout(name, prec):
    """The host-side layout the row-8 kernels consume (`_trunk_args`: the
    raw input row in Xs, the skip slice read in place or copied into the
    aux columns, segments and scattered weight columns), run here the way
    csrc/trunk_common.cuh reads it, computes `fused_trunk_plain`'s
    function: f32 order only (bf16 1e-2 of the scale, 5% of entries beyond
    1e-3, as the B2 layout test)."""
    x, layers, out, kw = trunk_case(name, n=64)
    tl, to = _torch_trunk(layers, out)
    xt = _t(x)
    spec = cmlp.TrunkSpec(x.shape[1], **kw)
    ref = cmlp.fused_trunk_plain(xt, tl, to, spec=spec, precision=prec)
    _, hid, meta, w_all, b_all, wout, bout, A = cmlp._trunk_args(
        xt, tl, to, spec, prec)
    L, _, _, xw, exp_w, ex_w, kind = (int(v) for v in meta[:7])
    assert kind == 2 and ex_w == x.shape[1]
    assert int(meta[10 + 12 * L]) == kw["skip_off"]
    assert A == (0 if name == "canonical" else kw["skip_width"])
    bf16 = prec == "bf16"

    def rnd(t):
        return t.to(torch.bfloat16).float() if bf16 else t

    xs = torch.zeros(x.shape[0], xw)
    xs[:, :ex_w] = xt
    xs[:, exp_w:exp_w + A] = xt[:, kw["skip_off"]:kw["skip_off"] + A]
    xs, hs, p = rnd(xs), torch.zeros(x.shape[0], hid), 10
    for i in range(L):
        segs = [tuple(int(v) for v in meta[p + 4 * s:p + 4 + 4 * s])
                for s in range(2)]
        K, w_off = int(meta[p + 8]), int(meta[p + 9])
        p += 12
        inp = torch.zeros(x.shape[0], K)
        for buf, off, w, kpos in segs:
            inp[:, kpos:kpos + w] = (xs if buf == 0 else hs)[:, off:off + w]
        z = rnd(inp @ _weight_matrix(w_all, w_off, hid, K, bf16))
        hs = torch.relu(rnd(z + b_all[i].float()))
    got = hs @ wout.T + bout
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    assert float(err.max()) <= (1e-2 if bf16 else 1e-5) * scale
    assert float((err > 1e-3 * scale).float().mean()) <= 0.05


# ---------------------------------------------------------------------------
# row 12: the pair-grid prototype
# ---------------------------------------------------------------------------

def _jax_proto():
    spec = importlib.util.spec_from_file_location(
        "jax_proto_pairgrid", os.path.join(ROOT, "tools",
                                           "proto_pairgrid.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_pairs", [7, 2])
def test_proto_pairgrid_plain_matches_jax_run(n_pairs):
    """The prototype's plain version against the JAX script's `run`
    (interpret mode) on its own case, full length and cut to 2 steps (a
    dynamic length: only the visited tiles are compared, as the script
    does): out to f32 order (1e-5 of the scale), dvol exactly."""
    jp = _jax_proto()
    pts, vol, ptile, pbone = tproto.case()
    out_r, dvol_r = jp.run(jnp.int32(n_pairs), jnp.asarray(ptile),
                           jnp.asarray(pbone), jnp.asarray(pts),
                           jnp.asarray(vol), tproto.N_TILES, True)
    out, dvol = tproto.run(torch.tensor([n_pairs]), torch.from_numpy(ptile),
                           torch.from_numpy(pbone), _t(pts), _t(vol),
                           tproto.N_TILES)
    rows = slice(0, tproto.N_TILES * tproto.T if n_pairs == 7 else tproto.T)
    assert _rel(out.numpy()[rows], np.asarray(out_r)[rows])[0] <= 1e-5
    np.testing.assert_array_equal(dvol.numpy(), np.asarray(dvol_r))
    ref, _ = tproto.reference(pts, vol, n_pairs)
    assert _rel(out.numpy()[rows], ref[rows])[0] <= 1e-5


# ---------------------------------------------------------------------------
# the human field's dense path and its training step
# ---------------------------------------------------------------------------

S = 8
CFG = dict(n_patches=1, patch_size=16, n_samples=S, cnl_mlp_width=32,
           nr_mlp_width=32, mweight_volume_size=32, perturb=0.0)
FIELD_KW = dict(total_bones=26, n_samples=S, mweight_volume_size=32,
                cnl_mlp_width=32, nr_mlp_width=32)


@pytest.fixture(scope="module")
def field():
    """The tiny stage-2 batch (16 x 16 rays, 8 samples, widths 32, G = 32)
    and JAX params from key 0."""
    nb = synthetic.human_batch(1, 16, grid_size=32)
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    params, _, _, _ = jstage2.init_state(
        jstage2.Stage2Config(lbs_impl="gather", **CFG), jax.random.key(0),
        batch)
    params = jax.tree.map(np.asarray, params)
    return dict(batch=batch, params=params,
                sd=convert.human_state_dict(params),
                tbatch={k: torch.from_numpy(np.array(v))
                        for k, v in nb.items()})


def _jax_step(field, lbs_impl):
    """JAX loss, gradients and params after one optax Adam update (dense
    path: mlp_impl 'auto' is flax off the TPU)."""
    jcfg = jstage2.Stage2Config(lbs_impl=lbs_impl, **CFG)
    loss_fn = jstage2.make_loss_fn(jcfg, jstage2.make_model(jcfg))
    opt = jstage2.make_optimizer(jcfg, field["params"])

    @jax.jit
    def step(p):
        (total, losses), g = jax.value_and_grad(
            lambda q: loss_fn(q, None, field["batch"], ITER, jnp.int32(0),
                              None), has_aux=True)(p)
        upd, _ = opt.update(g, opt.init(p), p)
        return total, losses, g, optax.apply_updates(p, upd)

    total, losses, g, after = step(jax.tree.map(jnp.asarray, field["params"]))
    return (float(total), {k: float(v) for k, v in losses.items()},
            convert.human_params_to_numpy(jax.tree.map(np.asarray, g)),
            convert.human_params_to_numpy(jax.tree.map(np.asarray, after)))


def _port_step(field, **kw):
    """The port's loss, gradients and params after one `make_train_step`."""
    cfg = tstage2.Stage2Config(**CFG, **kw)
    model = tstage2.make_model(cfg, device="cpu")
    model.load_state_dict(field["sd"], strict=True)
    step = tstage2.make_train_step(cfg, model,
                                   tstage2.make_optimizer(cfg, model))
    losses = step(field["tbatch"], ITER)
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def port_dense(field):
    """The port's dense step with the pair-grid LBS (plain versions) and
    module MLPs: the reference for the chunk and remat cases."""
    return _port_step(field, lbs_impl="pallas", mlp_impl="flax")


@pytest.mark.parametrize("lbs_impl", ["pallas", "pallas_dense"])
def test_dense_step_matches_jax(field, port_dense, lbs_impl):
    """The port's dense path (HumanObjectField(mlp_impl='flax',
    lbs_impl=...): the inverse-LBS entries' plain versions, module MLPs,
    B5's plain version or, for 'pallas_dense', the gather forward LBS as
    JAX dispatches it) against JAX with the same arguments (Pallas in
    interpret mode), f32 trunks, one training step:
    * the loss and its terms to 1e-5 relative;
    * every gradient leaf to 5e-3 relative L2: both sample the volumes
      with bf16 taps at the same rounding points, but the motion bases and
      decoded volume reach them in another f32 order, which flips single
      tap roundings (2^-9 of a weight), and 6 + 8 + 6 layers pass that on
      (observed <= 1e-3);
    * the params after one Adam step: its first update is
      lr * g / (|g| + eps), near lr * sign(g), so a gradient near 0 that
      the two sides give opposite signs moves its entry by up to 2 lr:
      each leaf's update to 5e-2 relative L2 and at most 1% of all
      entries off by more than 1e-2 of their leaf's largest update
      (observed 6e-3 and 0.08%)."""
    total, losses, ref_g, ref_p = _jax_step(field, lbs_impl)
    t_losses, grads, after = (port_dense if lbs_impl == "pallas" else
                              _port_step(field, lbs_impl=lbs_impl,
                                         mlp_impl="flax"))
    np.testing.assert_allclose(t_losses["loss"], total, rtol=1e-5)
    for k in losses:
        np.testing.assert_allclose(t_losses[k], losses[k], rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    assert losses["flow"] > 0 and losses["cycle"] > 0
    nonzero = [k for k, v in ref_g.items() if np.abs(v).max() > 0]
    assert {tstage2.group_of(k) for k in nonzero} == set(tstage2.GROUPS)
    n_off = n_all = 0
    for k in nonzero:
        assert _rel(grads[k], ref_g[k])[1] <= 5e-3, k
        before = field["sd"][k].numpy()
        upd, ref_upd = after[k] - before, ref_p[k] - before
        assert _rel(upd, ref_upd)[1] <= 5e-2, k
        off = np.abs(upd - ref_upd) > 1e-2 * np.abs(ref_upd).max()
        n_off, n_all = n_off + off.sum(), n_all + off.size
    assert n_off <= 0.01 * n_all


@pytest.mark.parametrize("remat,chunk", [("heavy", None), ("all", 1000)])
def test_chunk_and_remat_equal_unchunked(field, port_dense, monkeypatch,
                                         remat, chunk):
    """`mlp_chunk` and `remat` reshape only how the module MLPs run: the
    loss, every gradient and the params after one step equal the
    unchunked, unrecomputed port's (recomputation repeats the same
    arithmetic: exact; chunks change the f32 blocking of the matmuls:
    1e-6 relative L2). 'all' recomputes every MLP, 'heavy' only the
    canonical one, each chunk on its own."""
    import hosnerf_tpu_torch.models.human as thuman
    seen = []
    real = thuman.checkpoint

    def counting(fn, *args, **kw):
        seen.append(type(fn).__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(thuman, "checkpoint", counting)
    losses, grads, after = _port_step(field, lbs_impl="pallas",
                                      mlp_impl="flax", remat=remat,
                                      mlp_chunk=chunk)
    ref_l, ref_g, ref_p = port_dense
    chunks = 1 if chunk is None else -(-256 * S // chunk)
    expect = {"CanonicalMLP": chunks}
    if remat == "all":
        expect["NonRigidMLP"] = chunks + (1 if chunk is None
                                          else -(-2 * 256 * S // chunk))
    assert {k: seen.count(k) for k in set(seen)} == expect
    tol = 0.0 if chunk is None else 1e-6
    np.testing.assert_allclose(losses["loss"], ref_l["loss"], rtol=tol)
    assert sorted(grads) == sorted(ref_g)
    for k in ref_g:
        assert _rel(grads[k], ref_g[k])[1] <= tol, k
        assert _rel(after[k], ref_p[k])[1] <= tol, k


def test_resolve_remat():
    assert [resolve_remat(v) for v in (False, True, "none", "Heavy",
                                       "all")] == ["none", "all", "none",
                                                   "heavy", "all"]
    with pytest.raises(ValueError, match="remat"):
        resolve_remat("some")


def test_unsorted_fused_path_matches_jax(field, monkeypatch):
    """`sparse=False` with the fused MLPs and the pair-grid LBS (the
    port's plain versions) against JAX's dense path with its fused Pallas
    kernels (HOSNERF_SPARSE=0, set for the JAX call only), render outputs:
    bf16 LBS taps on both sides with the same rounding points, f32 trunks;
    2e-4 absolute, the sorted-path tolerance of test_torch_human."""
    monkeypatch.setenv("HOSNERF_SPARSE", "0")
    jm = JaxField(lbs_impl="pallas", mlp_impl="fused", **FIELD_KW)
    ref = jax.jit(lambda p: jm.apply(
        {"params": p}, field["batch"], 10 ** 7, jnp.int32(0),
        is_train=False))(jax.tree.map(jnp.asarray, field["params"]))
    monkeypatch.delenv("HOSNERF_SPARSE")
    model = HumanObjectField(lbs_impl="pallas", mlp_impl="fused",
                             sparse=False, **FIELD_KW, device="cpu")
    model.load_state_dict(field["sd"], strict=True)
    model._samples_sorted = None                # never reached
    with torch.no_grad():
        out = model(field["tbatch"], 10 ** 7, torch.tensor(0))
    for k in ("rgb", "alpha", "depth", "weights", "pts_mask"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=2e-4, err_msg=k)
    assert float(out["alpha"].max()) > 0.0


def test_remat_chunked_weights_load_strict(field):
    """flax's nn.remat keeps the module names: a JAX
    HumanObjectField(remat=True, mlp_chunk=...) has the param tree of a
    plain one (compared by path, from `jax.eval_shape` of its init), so
    its params move into the port through `convert.py` with strict=True;
    with the same remat and mlp_chunk the port renders what that JAX model
    renders (f32 gather and module MLPs: op order only, rtol 1e-5 and atol
    3e-5 as test_torch_human's dense check)."""
    kw = dict(lbs_impl="gather", mlp_impl="flax", **FIELD_KW)
    jm = JaxField(remat=True, mlp_chunk=1000, **kw)
    shapes = jax.eval_shape(lambda r: jm.init(
        {"params": r}, field["batch"], 0, jnp.int32(0),
        is_train=True)["params"], jax.random.key(1))

    def paths(tree):
        return sorted((jax.tree_util.keystr(p), tuple(np.shape(v)))
                      for p, v in jax.tree_util.tree_leaves_with_path(tree))

    assert paths(shapes) == paths(field["params"])
    ref = jax.jit(lambda p: jm.apply(
        {"params": p}, field["batch"], 10 ** 7, jnp.int32(0),
        is_train=False))(jax.tree.map(jnp.asarray, field["params"]))
    model = HumanObjectField(remat="all", mlp_chunk=1000, **kw, device="cpu")
    res = model.load_state_dict(field["sd"], strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        out = model(field["tbatch"], 10 ** 7, torch.tensor(0))
    for k in ("rgb", "alpha", "depth", "weights"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=3e-5, err_msg=k)
