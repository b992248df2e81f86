"""The port's whole human field against the JAX package at B=26, G=32,
S=16, widths 32 and 16x16 rays (as tests/test_human_sparse.py), with the
JAX params moved by the port's converter:

(i)  port dense (gather LBS, module MLPs, f32) vs JAX dense
     (lbs_impl='gather', mlp_impl='flax');
(ii) port sorted (liveness sort + plain kernel versions) vs JAX sorted
     (lbs_impl='pallas', mlp_impl='fused', Pallas in interpret mode).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hosnerf_tpu.data import synthetic
from hosnerf_tpu.models.human import HumanObjectField as JaxField
from hosnerf_tpu.train import checkpoints as ck
from hosnerf_tpu_torch import convert
from hosnerf_tpu_torch.data import synthetic as tsynthetic
from hosnerf_tpu_torch.eval import renderers
from hosnerf_tpu_torch.models.human import HumanObjectField
from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.ops.cuda import mlp as cmlp

S = 16
G = 32
KW = dict(total_bones=26, n_samples=S, mweight_volume_size=G,
          cnl_mlp_width=32, nr_mlp_width=32)
KEYS = ("rgb", "alpha", "depth", "weights", "pts_mask")
ITER = 10 ** 7       # the render path's iter_val


@pytest.fixture(scope="module")
def field():
    torch.set_num_threads(1)
    nb = synthetic.human_batch(1, 16, grid_size=G)
    # stretch the rays so most samples miss every bone (a real dead prefix)
    nb["far"] = nb["far"] * 4.0
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    jdense = JaxField(lbs_impl="gather", mlp_impl="flax", **KW)
    params = jdense.init({"params": jax.random.key(0)}, batch, 0,
                         jnp.int32(0), is_train=True)["params"]
    pnp = jax.tree.map(np.asarray, params)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in nb.items()}
    return dict(nb=nb, batch=batch, params=params, pnp=pnp, tbatch=tbatch,
                jdense=jdense)


@pytest.fixture(autouse=True)
def _no_grad():
    """The render-path checks read outputs as numpy: no autograd graph."""
    with torch.no_grad():
        yield


def _port(field, **kw):
    m = HumanObjectField(**KW, **kw, device="cpu")
    m.load_state_dict(convert.human_state_dict(field["pnp"]), strict=True)
    return m


def test_synthetic_batch_equals_jax_package():
    a = tsynthetic.human_batch(2, 8, seed=3, grid_size=16)
    b = synthetic.human_batch(2, 8, seed=3, grid_size=16)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


def test_converter_equals_export_and_loads_strict(field):
    sd = convert.human_params_to_numpy(field["pnp"])
    ref = ck.export_human_params(field["pnp"], prefix="")
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert sd[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    m = HumanObjectField(**KW, device="cpu")
    res = m.load_state_dict(convert.human_state_dict(field["pnp"]),
                            strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert "non_rigid_forward_mlp.block_mlps.12.weight" in sd


def test_dense_matches_jax_dense(field):
    """(i) both f32 gather + plain MLPs: op order only. Observed ~1e-5
    (depth, in world units up to ~2, reaches 1.6e-5), so rtol 1e-5 with
    atol 3e-5."""
    ref = field["jdense"].apply({"params": field["params"]}, field["batch"],
                                ITER, jnp.int32(0), is_train=False)
    out = _port(field, lbs_impl="gather", mlp_impl="flax")(
        field["tbatch"], ITER, torch.tensor(0))
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=3e-5, err_msg=k)


def test_sorted_matches_jax_sorted(field):
    """(ii) the sorted path on the plain kernel versions vs JAX's sorted
    path on its Pallas kernels (interpret mode): bf16 inverse LBS on both
    sides with the same rounding points, f32 trunks. Their inputs (motion
    bases, decoded volume) differ in f32 op order, which can flip single
    bf16 tap roundings (one bf16 ulp, 2^-9 relative, on one tap weight):
    tolerance 2e-4 absolute on every composited output (observed ~3e-5;
    the bf16-vs-f32 LBS difference itself is ~3e-3, so this still pins
    the bf16 semantics)."""
    jsorted = JaxField(lbs_impl="pallas", mlp_impl="fused", **KW)
    ref = jsorted.apply({"params": field["params"]}, field["batch"], ITER,
                        jnp.int32(0), is_train=False)
    model = _port(field, lbs_impl="pallas", mlp_impl="fused")
    pts = field["tbatch"]["rays_o"][:, None] + field["tbatch"]["rays_d"][
        :, None] * torch.linspace(0, 1, S)[None, :, None]
    assert model._sparse_ok(pts.reshape(-1, 3), torch.zeros(27, G, G, G),
                            torch.zeros(64))
    out = model(field["tbatch"], ITER, torch.tensor(0))
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=2e-4, err_msg=k)
    # the skip is not vacuous: at least one whole 1024-row MLP block dead
    b = field["tbatch"]
    from hosnerf_tpu_torch.core import body
    m_sR, m_T, _, _ = body.motion_bases(b["dst_Rs"], b["dst_Ts"],
                                        b["cnl_gtfms"])
    vol = model.mweight_vol_decoder(b["motion_weights_priors"])
    _, _, rg, tg, _ = clbs.grid_tables(m_sR, m_T, vol, b["cnl_bbox_min_xyz"],
                                       b["cnl_bbox_scale_xyz"])
    z = b["near"] + (b["far"] - b["near"]) * torch.linspace(0, 1, S)[None]
    p = (b["rays_o"][:, None] + b["rays_d"][:, None] * z[..., None])
    dom = clbs.bp_prepare(p.reshape(-1, 3), rg, tg, G, 26)
    assert int(dom.k0_for(cmlp.MLP_TILE)) >= 1


def test_sorted_cpu_equals_dense_cpu_up_to_bf16_lbs(field):
    """Within the port: the sorted path differs from the dense one only
    by the bf16 inverse-LBS taps (2^-9 relative on the weights)."""
    b = field["tbatch"]
    d = _port(field, lbs_impl="gather", mlp_impl="flax")(b, ITER,
                                                          torch.tensor(0))
    s = _port(field, lbs_impl="pallas", mlp_impl="fused")(b, ITER,
                                                           torch.tensor(0))
    for k in KEYS:
        np.testing.assert_allclose(s[k].numpy(), d[k].numpy(), rtol=0,
                                   atol=2e-2, err_msg=k)


def test_all_dead_batch_is_finite_and_empty(field):
    b = dict(field["tbatch"])
    b["rays_o"] = b["rays_o"] + 1e3          # rays miss the subject
    out = _port(field, lbs_impl="pallas", mlp_impl="fused")(
        b, ITER, torch.tensor(0))
    for k in KEYS:
        assert torch.isfinite(out[k]).all(), k
    assert float(out["pts_mask"].max()) == 0.0
    np.testing.assert_allclose(out["rgb"].numpy(), 1.0, atol=1e-6)


def test_per_sample_state_takes_dense_path(field):
    """A per-sample state embedding falls back to the dense path instead
    of failing (the JAX sorted path asserts there)."""
    model = _port(field, lbs_impl="pallas", mlp_impl="fused")
    one_row = model(field["tbatch"], ITER, torch.tensor(0))

    def not_here(*args):
        raise AssertionError("per-sample state reached the sorted path")

    model._samples_sorted = not_here
    idx = torch.zeros(256 * S, dtype=torch.long)
    per_sample = model(field["tbatch"], ITER, idx)
    # same bf16 LBS (unsorted through inverse_warp), f32 module MLPs
    # instead of the fused plain version: f32 op order only
    for k in KEYS:
        np.testing.assert_allclose(per_sample[k].numpy(),
                                   one_row[k].numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_train_mode_matches_jax_dense(field):
    """is_train=True (perturb 0): the cycle and flow branches' outputs of
    the port's dense path vs JAX dense, and the port's sorted path (plain
    kernel versions) vs its dense path. Dense vs dense is f32 op order
    through the forward LBS and the forward non-rigid MLP: 1e-4 absolute
    on points of magnitude ~2. Sorted vs dense adds the bf16 taps of both
    LBS volumes (2^-9 relative on each tap weight): 2e-2 absolute, as the
    render outputs above."""
    ref = field["jdense"].apply({"params": field["params"]}, field["batch"],
                                ITER, jnp.int32(0), is_train=True)
    with torch.enable_grad():
        dense = _port(field, lbs_impl="gather", mlp_impl="flax")(
            field["tbatch"], ITER, torch.tensor(0), is_train=True)
        srt = _port(field, lbs_impl="pallas", mlp_impl="fused")(
            field["tbatch"], ITER, torch.tensor(0), is_train=True)
    keys = ("observe_pts", "cnl_pts", "deform_pts_final", "cycle_mask",
            "deform_pts_prev_final", "rgb")
    for k in keys:
        np.testing.assert_allclose(dense[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    live = dense["cycle_mask"].detach().numpy() > 0
    assert live.any() and not live.all()
    for k in ("cnl_pts", "deform_pts_final"):
        np.testing.assert_allclose(srt[k].detach().numpy()[live],
                                   dense[k].detach().numpy()[live], rtol=0,
                                   atol=2e-2, err_msg=k)
    assert dense["deform_pts_final"].requires_grad


def test_render_human_image_chunks(field):
    """render_human_image over a 16x16 image in 100-ray chunks (the last
    one padded) equals one pass of the model."""
    model = _port(field, lbs_impl="gather", mlp_impl="flax")
    item = dict(field["nb"])
    item.update(img_height=16, img_width=16)
    img = renderers.render_human_image(renderers.make_render_fn(model),
                                       item, "cpu", chunk=100)
    one = model(field["tbatch"], ITER, torch.tensor(0))["rgb"]
    assert img.shape == (16, 16, 3)
    np.testing.assert_allclose(img.reshape(-1, 3), one.numpy(), rtol=0,
                               atol=1e-6)


def test_package_imports_without_jax_or_triton():
    code = ("import sys, hosnerf_tpu_torch, hosnerf_tpu_torch.convert, "
            "hosnerf_tpu_torch.models.human, hosnerf_tpu_torch.eval."
            "renderers, hosnerf_tpu_torch.models.lpips, "
            "hosnerf_tpu_torch.train.stage2, "
            "hosnerf_tpu_torch.train.schedules, "
            "hosnerf_tpu_torch.train.gradcheck, "
            "hosnerf_tpu_torch.tools.proto_pairgrid\n"
            "from hosnerf_tpu_torch.ops.cuda import _build\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'triton', 'hosnerf_tpu')]\n"
            "assert not bad, bad\n"
            "assert not _build._LIBS\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
