"""Per-module parity of the port against the JAX package on numpy-made
inputs: body math, embedders, state selection, compositing, trilinear
sampling, gather-form inverse LBS and the human components at narrow
widths (weights moved with the port's converter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hosnerf_tpu.core import body as jbody
from hosnerf_tpu.core import render as jrender
from hosnerf_tpu.models import embedders as jemb
from hosnerf_tpu.models import human_components as jhc
from hosnerf_tpu.models import state as jstate
from hosnerf_tpu.ops import grid_sample as jgs
from hosnerf_tpu.ops import lbs as jlbs
from hosnerf_tpu_torch import convert
from hosnerf_tpu_torch.core import body as tbody
from hosnerf_tpu_torch.core import render as trender
from hosnerf_tpu_torch.models import embedders as temb
from hosnerf_tpu_torch.models import human_components as thc
from hosnerf_tpu_torch.models import layers as tlayers
from hosnerf_tpu_torch.models import state as tstate
from hosnerf_tpu_torch.ops import grid_sample as tgs
from hosnerf_tpu_torch.ops import lbs as tlbs

F32 = dict(rtol=1e-5, atol=1e-5)   # f32 parity: op order only


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def pose():
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    tpose = np.cumsum(rng.normal(scale=0.08, size=(26, 3)), 0).astype(
        np.float32)
    angles = rng.normal(scale=0.2, size=(26 * 3,)).astype(np.float32)
    return rng, tpose, angles


def test_numpy_helpers_equal_jax_package(pose):
    _, tpose, angles = pose
    np.testing.assert_array_equal(tbody.parent_index_array(),
                                  jbody.parent_index_array())
    for a, b in zip(tbody.body_pose_to_body_RTs(angles, tpose),
                    jbody.body_pose_to_body_RTs(angles, tpose)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tbody.get_canonical_global_tfms(tpose),
                                  jbody.get_canonical_global_tfms(tpose))
    lo, hi = tpose.min(0) - 0.3, tpose.max(0) + 0.3
    np.testing.assert_array_equal(
        tbody.approx_gaussian_bone_volumes(tpose, lo, hi, 8),
        jbody.approx_gaussian_bone_volumes(tpose, lo, hi, 8))


def test_body_math_matches_jax(pose):
    rng, tpose, angles = pose
    rvec = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tbody.rodrigues(_t(rvec)).numpy(),
                               np.asarray(jbody.rodrigues(rvec)), **F32)
    Rs, Ts = jbody.body_pose_to_body_RTs(angles, tpose)
    G = np.asarray(jbody.construct_G(Rs, Ts))
    np.testing.assert_allclose(tbody.construct_G(_t(Rs), _t(Ts)).numpy(), G,
                               **F32)
    for fn in ("rigid_inverse", "affine_inverse", "forward_kinematics"):
        np.testing.assert_allclose(getattr(tbody, fn)(_t(G)).numpy(),
                                   np.asarray(getattr(jbody, fn)(G)),
                                   err_msg=fn, **F32)
    cnl = jbody.get_canonical_global_tfms(tpose)
    for a, b in zip(tbody.motion_bases(_t(Rs), _t(Ts), _t(cnl)),
                    jbody.motion_bases(Rs, Ts, cnl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


@pytest.mark.parametrize("alpha_iter", [0, 20_000, 10 ** 7])
def test_embedders_match_jax(alpha_iter):
    x = np.random.default_rng(1).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(temb.fourier_embed(_t(x), 10).numpy(),
                               np.asarray(jemb.fourier_embed(x, 10)), **F32)
    a_t = temb.hann_alpha(alpha_iter, 10_000, 50_000, 6)
    a_j = float(jemb.hann_alpha(alpha_iter, 10_000, 50_000, 6))
    assert a_t == pytest.approx(a_j, rel=1e-6)
    np.testing.assert_allclose(
        temb.hannw_fourier_embed(_t(x), 6, a_t).numpy(),
        np.asarray(jemb.hannw_fourier_embed(x, 6, a_j)), **F32)
    assert temb.hann_alpha(5, 0, 0, 6) == float(jemb.hann_alpha(5, 0, 0, 6))


def test_state_index_matches_jax():
    trans = np.array([0.2, 0.5, 0.8], np.float32)
    times = np.array([0.0, 0.2 - 2e-5, 0.2, 0.35, 0.5, 0.5 + 2e-5, 0.9, 1.0],
                     np.float32)
    np.testing.assert_array_equal(
        tstate.state_index(_t(times), _t(trans)).numpy(),
        np.asarray(jstate.state_index(times, trans)))
    assert int(tstate.state_index(torch.tensor(0.7), None)) == 0


def test_raw2outputs_matches_jax():
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(8, 16, 4)).astype(np.float32)
    mask = rng.uniform(size=(8, 16, 1)).astype(np.float32)
    z = np.sort(rng.uniform(2, 4, (8, 16)), -1).astype(np.float32)
    d = rng.normal(size=(8, 3)).astype(np.float32)
    bg = np.array([255.0, 128.0, 0.0], np.float32)
    for a, b in zip(trender.raw2outputs(_t(raw), _t(mask), _t(z), _t(d),
                                        _t(bg)),
                    jrender.raw2outputs(raw, mask, z, d, bg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_trilinear_and_gather_lbs_match_jax(pose):
    rng, tpose, angles = pose
    vol = rng.uniform(size=(5, 6, 7, 8)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tgs.trilinear(_t(vol), _t(coords)).numpy(),
                               np.asarray(jgs.trilinear(vol, coords)), **F32)
    pc = rng.uniform(-1.2, 1.2, (5, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgs.trilinear_per_channel(_t(vol), _t(pc)).numpy(),
        np.asarray(jgs.trilinear_per_channel(vol, pc)), **F32)

    B, G = 26, 8
    lo, hi = tpose.min(0) - 0.3, tpose.max(0) + 0.3
    wvol = jbody.approx_gaussian_bone_volumes(tpose, lo, hi, G)
    Rs, Ts = jbody.body_pose_to_body_RTs(angles, tpose)
    m_sR, m_T, _, _ = (np.asarray(a) for a in jbody.motion_bases(
        Rs, Ts, jbody.get_canonical_global_tfms(tpose)))
    pts = rng.uniform(lo, hi, (200, 3)).astype(np.float32)
    scale = (2.0 / (hi - lo)).astype(np.float32)
    args = (m_sR, m_T, wvol, lo.astype(np.float32), scale)
    ref = jlbs.inverse_lbs_gather(pts, *args)
    got = tlbs.inverse_lbs_gather(_t(pts), *(_t(a) for a in args))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    x, w = tlbs.inverse_warp(_t(pts), *(_t(a) for a in args), impl="gather")
    np.testing.assert_allclose(x.numpy(), np.asarray(ref[0]), **F32)
    with pytest.raises(ValueError):
        tlbs.inverse_warp(_t(pts), *(_t(a) for a in args), impl="xla")


def _flax_params(module, *args):
    return jax.tree.map(np.asarray, module.init(jax.random.key(3),
                                                *args)["params"])


def _load(tmod, sd):
    missing = tmod.load_state_dict(
        {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys


def _dense_sd(prefix, p):
    return {f"{prefix}.weight": p["Dense_0"]["kernel"].T,
            f"{prefix}.bias": p["Dense_0"]["bias"]}


@pytest.mark.parametrize("cdt", [None, "bf16"])
def test_mlps_match_flax(cdt):
    """CanonicalMLP / NonRigidMLP at width 32: f32 at op-order tolerance;
    bf16 trunks round at the same points (operands, product, bias add),
    with different accumulation order -> 2e-2 of the output scale."""
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(0)
    tol = F32 if cdt is None else dict(rtol=0, atol=2e-2)
    jdt = jnp.bfloat16 if cdt else None
    tdt = tlayers.resolve_compute_dtype(cdt)

    pe = rng.normal(size=(40, 63 + 64)).astype(np.float32)
    jm = jhc.CanonicalMLP(mlp_depth=8, mlp_width=32, compute_dtype=jdt)
    p = _flax_params(jm, pe)
    tm = thc.CanonicalMLP(127, 8, 32, (4,), tdt, generator=gen,
                           device="cpu")
    sd = {}
    for j in range(8):
        sd.update(_dense_sd(f"pts_linears.{2 * j}", p[f"linear_{j}"]))
    sd.update(_dense_sd("output_linear.0", p["output"]))
    _load(tm, sd)
    ref = np.asarray(jm.apply({"params": p}, pe))
    np.testing.assert_allclose(tm(_t(pe)).detach().numpy(), ref,
                               **(tol if cdt is None else
                                  dict(rtol=0, atol=2e-2 * np.abs(ref).max())))

    emb = rng.normal(size=(40, 36)).astype(np.float32)
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    cond = rng.normal(size=(40, 75)).astype(np.float32)
    jn = jhc.NonRigidMLP(mlp_depth=6, mlp_width=32, compute_dtype=jdt)
    p = _flax_params(jn, emb, xyz, cond)
    tn = thc.NonRigidMLP(36, 75, 6, 32, (4,), tdt, generator=gen,
                          device="cpu")
    sd = {}
    for j in range(6):
        sd.update(_dense_sd(f"block_mlps.{2 * j}", p[f"linear_{j}"]))
    sd.update(_dense_sd("block_mlps.12", p["output"]))
    _load(tn, sd)
    ref = jn.apply({"params": p}, emb, xyz, cond)
    got = tn(_t(emb), _t(xyz), _t(cond))
    off = np.asarray(ref["offsets"])
    np.testing.assert_allclose(got["offsets"].detach().numpy(), off,
                               rtol=0, atol=(1e-5 if cdt is None else 2e-2)
                               * np.abs(off).max())


def test_pose_refiner_matches_flax():
    rng = np.random.default_rng(5)
    posevec = rng.normal(scale=0.3, size=(75,)).astype(np.float32)
    jm = jhc.BodyPoseRefiner(total_bones=26, mlp_width=32, mlp_depth=4)
    p = _flax_params(jm, posevec)
    tm = thc.BodyPoseRefiner(75, 26, 32, 4,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    sd = {}
    for j in range(3):
        sd.update(_dense_sd(f"block_mlps.{2 * j}", p[f"trunk_{j}"]))
    for th, ours in (("block_mlps_dstR", "head_r"),
                     ("block_mlps_dstT", "head_t")):
        sd.update(_dense_sd(f"{th}.0", p[f"{ours}_0"]))
        sd.update(_dense_sd(f"{th}.2", p[f"{ours}_out"]))
    _load(tm, sd)
    ref = jm.apply({"params": p}, posevec)
    got = tm(_t(posevec))
    for k in ("Rs", "Ts"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), **F32)


def test_transposed_conv_orientation_matches_jax():
    """torch ConvTranspose3d(k=4, s=2, p=1) with the converter's flipped
    kernel == the JAX ConvTranspose3dTorch on NDHWC inputs (non-uniform
    random kernel, so a missed flip or axis swap cannot pass)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 3, 4, 5, 6)).astype(np.float32)     # NDHWC
    jm = jhc.ConvTranspose3dTorch(5)
    p = _flax_params(jm, x)
    p = {"kernel": rng.normal(size=p["kernel"].shape).astype(np.float32),
         "bias": rng.normal(size=(5,)).astype(np.float32)}
    ref = np.asarray(jm.apply({"params": p}, x))
    conv = torch.nn.ConvTranspose3d(6, 5, 4, stride=2, padding=1)
    conv.load_state_dict({"weight": torch.from_numpy(convert._conv(
        p["kernel"])), "bias": _t(p["bias"])})
    got = conv(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-4)


def test_blockwise_conv_init_is_tied():
    w = torch.empty(3, 2, 4, 4, 4)
    tlayers.blockwise_transposed_conv_init(
        w, 1.0, torch.Generator().manual_seed(0))
    cells = w.reshape(3, 2, 2, 2, 2, 2, 2, 2)
    assert torch.equal(cells, cells[:, :, :, :1, :, :1, :, :1].expand_as(
        cells))
    bound = np.sqrt(2.0 / ((3 + 2) * 8)) * np.sqrt(3.0)
    assert float(w.abs().max()) <= bound


def test_motion_weight_decoder_matches_flax():
    """The whole decoder (Linear -> transposed convs -> softmax with the
    priors) at volume 4, channels first on both sides."""
    rng = np.random.default_rng(7)
    priors = rng.uniform(0.01, 1.0, (27, 4, 4, 4)).astype(np.float32)
    jm = jhc.MotionWeightVolumeDecoder(volume_size=4)
    p = _flax_params(jm, priors)
    sd = {"const_embedding": p["const_embedding"]}
    sd.update(_dense_sd("decoder.block_mlp.0", p["decoder"]["block_mlp"]))
    for n, name in enumerate(["deconv_0", "deconv_out"]):
        sd[f"decoder.block_conv.{2 * n}.weight"] = convert._conv(
            p["decoder"][name]["kernel"])
        sd[f"decoder.block_conv.{2 * n}.bias"] = p["decoder"][name]["bias"]
    tm = thc.MotionWeightVolumeDecoder(256, 4, 26,
                                       generator=torch.Generator(),
                                       device="cpu")
    _load(tm, sd)
    np.testing.assert_allclose(tm(_t(priors)).detach().numpy(),
                               np.asarray(jm.apply({"params": p}, priors)),
                               rtol=1e-4, atol=1e-6)
