"""The port's sorted-domain glue and the plain versions of its two kernels
against the JAX package's Pallas kernels (interpret mode on the CPU).

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py); here the plain versions are
held against the TPU reference on the same numpy-made inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hosnerf_tpu.core import body as jbody
from hosnerf_tpu.data import synthetic
from hosnerf_tpu.ops.pallas import lbs as plbs
from hosnerf_tpu.ops.pallas import mlp as pmlp
from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
from test_torch_cuda import mlp_case, torch_args

G = 32      # production volume (BPD = 28 fits the JAX 31-bit signature)
B = 26
S = 16      # samples per ray: 256 rays -> 4096 samples


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def lbs_data():
    """Production-shaped inverse-LBS inputs from the synthetic batch, the
    JAX sorted domain and its pair tables."""
    torch.set_num_threads(1)
    nb = synthetic.human_batch(1, 16, grid_size=G)
    b = {k: jnp.asarray(v) for k, v in nb.items()}
    b["far"] = b["far"] * 4.0
    t = jnp.linspace(0.0, 1.0, S)
    z = b["near"] * (1 - t)[None] + b["far"] * t[None]
    pts = (b["rays_o"][:, None] + b["rays_d"][:, None] * z[..., None]
           ).reshape(-1, 3)
    m_sR, m_T, _, _ = jbody.motion_bases(b["dst_Rs"], b["dst_Ts"],
                                         b["cnl_gtfms"])
    s_, o_ = plbs._grid_affine(b["cnl_bbox_min_xyz"],
                               b["cnl_bbox_scale_xyz"], G)
    rg = (m_sR * s_[None, :, None]).reshape(B, 9)
    tg = m_T * s_[None] + o_[None]
    vol = b["motion_weights_priors"]
    vol_qz = jnp.transpose(vol[:B], (0, 3, 2, 1)).reshape(B, G * G, G)
    dom = plbs.bp_prepare(pts, rg, tg, G, B)
    return dict(pts=pts, rg=rg, tg=tg, vol=vol, vol_qz=vol_qz, dom=dom,
                m_sR=m_sR, m_T=m_T, b=b)


def test_grid_tables_match_jax_layout(lbs_data):
    d = lbs_data
    s, o, rg, tg, vol_qz = clbs.grid_tables(
        _t(d["m_sR"]), _t(d["m_T"]), _t(d["vol"]),
        _t(d["b"]["cnl_bbox_min_xyz"]), _t(d["b"]["cnl_bbox_scale_xyz"]))
    np.testing.assert_allclose(rg.numpy(), np.asarray(d["rg"]), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(d["tg"]), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(vol_qz.numpy(), np.asarray(d["vol_qz"]))


def test_bp_prepare_matches_jax(lbs_data):
    """Same signature sort (perm), dead-prefix count and live mask."""
    d = lbs_data
    dom = clbs.bp_prepare(_t(d["pts"]), _t(d["rg"]), _t(d["tg"]), G, B)
    jd = d["dom"]
    assert dom.n_pad == jd.n_pad and dom.n == jd.n
    np.testing.assert_array_equal(dom.perm.numpy(), np.asarray(jd.perm))
    np.testing.assert_array_equal(dom.inv_perm.numpy(),
                                  np.asarray(jd.inv_perm))
    assert int(dom.n_dead_groups) == int(jd.n_dead_groups)
    assert int(dom.k0_for(1024)) == int(jd.k0_for(1024)) >= 1
    np.testing.assert_array_equal(
        dom.live_row_mask().numpy(), np.asarray(jd.live_row_mask()) > 0)
    x = np.arange(dom.n * 2, dtype=np.float32).reshape(dom.n, 2)
    np.testing.assert_array_equal(
        dom.unsort(dom.sort_rows(torch.from_numpy(x))).numpy(), x)


def test_bp_prepare_rejects_wide_signatures(lbs_data):
    d = lbs_data
    with pytest.raises(ValueError, match="B <= 31"):
        clbs.bp_prepare(_t(d["pts"]), torch.zeros(32, 9), torch.zeros(32, 3),
                        G, 32)


@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_inverse_core_plain_matches_pallas(lbs_data, prec):
    """Plain kernel-1 version vs `plbs.inverse_core_pg_s` on JAX's own
    sorted inputs. Both round the same quantities in bf16 mode, so the
    only differences are f32 summation order: at grid coordinates up to
    G = 32 a few f32 ulps (ulp(32) = 3.8e-6), hence atol 3e-5 on the
    coordinate sums and 2e-6 on the weight sum, in both precisions."""
    d = lbs_data
    jd = d["dom"]
    pts_s = jd.sort_rows(d["pts"])
    ref = np.asarray(plbs.inverse_core_pg_s(pts_s, d["rg"], d["tg"],
                                            d["vol_qz"], *jd.tables, prec))
    got = clbs.inverse_core_pg_s(_t(pts_s), _t(d["rg"]), _t(d["tg"]),
                                 _t(d["vol_qz"]), prec).numpy()
    np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=3e-5, rtol=0)
    np.testing.assert_allclose(got[:, 3], ref[:, 3], atol=2e-6, rtol=0)
    dead = int(jd.n_dead_groups) * plbs.SORT_GROUP
    assert dead > 0 and not np.any(got[:dead])      # dead rows exactly 0
    assert np.any(got[dead:, 3] > 0)


def test_inverse_lbs_unsorted_matches_pallas_dispatch(lbs_data):
    """`inverse_lbs` (sort -> plain kernel -> unsort -> world) against the
    JAX pair-grid wrapper, bf16 both: same tolerance reasoning as above,
    in world units (grid / s, s ~ 20)."""
    d = lbs_data
    b = d["b"]
    x_ref, w_ref = plbs.inverse_lbs(d["pts"], d["m_sR"], d["m_T"], d["vol"],
                                    b["cnl_bbox_min_xyz"],
                                    b["cnl_bbox_scale_xyz"])
    x, w = clbs.inverse_lbs(_t(d["pts"]), _t(d["m_sR"]), _t(d["m_T"]),
                            _t(d["vol"]), _t(b["cnl_bbox_min_xyz"]),
                            _t(b["cnl_bbox_scale_xyz"]))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=2e-6)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=2e-5)


def test_cpu_tensor_takes_plain_version(lbs_data):
    """A CPU tensor never reaches the kernel: the launch count stays."""
    d = lbs_data
    before = clbs.inverse_core_pg_s.launches
    clbs.inverse_core_pg_s(_t(d["pts"])[:64], _t(d["rg"]), _t(d["tg"]),
                           _t(d["vol_qz"]))
    assert clbs.inverse_core_pg_s.launches == before


# ---------------------------------------------------------------------------
# kernel 2: fused embed + trunk
# ---------------------------------------------------------------------------

N_MLP = 2048     # two 1024-row blocks, so k0 = 1 skips one


@pytest.mark.parametrize("k0", [0, 1])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("name", ["nonrigid", "canonical"])
def test_embed_trunk_plain_matches_pallas(name, prec, k0):
    """Plain kernel-2 version vs `pmlp.fused_embed_trunk` forward, rows
    >= k0 * 1024 (the kernel leaves the rest unwritten). highest: f32
    summation order only -> 1e-5 of the output scale. bf16: the same
    rounding points; a different f32 summation order can flip one bf16
    rounding of an activation, which moves an output by about a bf16 ulp
    of the activations -> 1e-2 of the scale, and at most 5% of the
    entries beyond 1e-3 of it."""
    x, aux, alpha, layers, out, kw = mlp_case(name, n=N_MLP)
    ref = np.asarray(pmlp.fused_embed_trunk(
        jnp.asarray(x), jnp.asarray(aux), alpha,
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers],
        (jnp.asarray(out[0]), jnp.asarray(out[1])), precision=prec,
        k0_blocks=k0, **kw))[k0 * 1024:]
    tl, to = torch_args(layers, out)
    got = cmlp.fused_embed_trunk(torch.from_numpy(x), torch.from_numpy(aux),
                                 alpha, tl, to, precision=prec, k0_blocks=k0,
                                 **kw).numpy()[k0 * 1024:]
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    if prec == "highest":
        assert err.max() <= 1e-5 * scale, err.max()
    else:
        assert err.max() <= 1e-2 * scale, err.max()
        assert np.mean(err > 1e-3 * scale) <= 0.05


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


def _packed_reference(x, aux, alpha, layers, out, kw, prec):
    """Run the trunk the way csrc/embed_trunk.cu does, from `_pack`'s meta
    and packed weights: the input row laid out in Xs order, each layer a
    product of its Xs/Hs segments with the packed weight block."""
    espec = cmlp.EmbedSpec(kw["kind"], kw["multires"], aux.shape[-1],
                           kw["aux_mode"], kw["aux_first"])
    stride = 0 if kw["aux_mode"] == "broadcast" else aux.shape[-1]
    meta, w_all, b_all, wout, bout = cmlp._pack(
        layers, out, espec, kw["skip_before"], kw["skip_source"], prec,
        stride)
    L, hid, _, xw, exp_w, ex_w = (int(v) for v in meta[:6])
    bf16 = prec == "bf16"

    def rnd(t):
        return t.to(torch.bfloat16).float() if bf16 else t

    full = cmlp.trunk_input(x, aux, alpha, espec)
    A = espec.aux_width
    ex, au = (full[:, A:], full[:, :A]) if espec.aux_first else \
        (full[:, :ex_w], full[:, ex_w:])
    n = x.shape[0]
    xs = torch.zeros(n, xw)
    xs[:, :ex_w] = ex
    xs[:, exp_w:exp_w + A] = au
    xs = rnd(xs)
    hs = torch.zeros(n, hid)
    p = 10
    for i in range(L):
        segs = [tuple(int(v) for v in meta[p + 4 * s:p + 4 + 4 * s])
                for s in range(2)]
        K, w_off = int(meta[p + 8]), int(meta[p + 9])
        p += 12
        inp = torch.zeros(n, K)
        for buf, off, w, kpos in segs:
            inp[:, kpos:kpos + w] = (xs if buf == 0 else hs)[:, off:off + w]
        z = rnd(inp @ _weight_matrix(w_all, w_off, hid, K, bf16))
        hs = torch.relu(rnd(z + b_all[i].float()))
    return hs @ wout.T + bout


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("name", ["nonrigid", "canonical"])
def test_kernel_weight_packing(name, prec):
    """The host-side layout the CUDA kernel consumes (`_pack`: Xs column
    placement, segments, scattered weight columns) computes the same
    function as the plain version; run here on the CPU with the same
    rounding points, so only f32 summation order differs."""
    x, aux, alpha, layers, out, kw = mlp_case(name, n=256)
    tl, to = torch_args(layers, out)
    espec = cmlp.EmbedSpec(kw["kind"], kw["multires"], aux.shape[-1],
                           kw["aux_mode"], kw["aux_first"])
    ref = cmlp.fused_embed_trunk_plain(
        torch.from_numpy(x), torch.from_numpy(aux), alpha, tl, to,
        espec=espec, skip_before=kw["skip_before"],
        skip_source=kw["skip_source"], precision=prec)
    got = _packed_reference(torch.from_numpy(x), torch.from_numpy(aux),
                            alpha, tl, to, kw, prec)
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    assert float(err.max()) <= (1e-2 if prec == "bf16" else 1e-5) * scale
    assert float((err > 1e-3 * scale).float().mean()) <= 0.05
