"""The port's scene stack against the JAX package on the CPU: the
geodesic basis, ray math, step functions, compositing, `SceneField` and
its losses, the scene converter and the synthetic batches.

Inputs are made from numpy seeds; the SceneField's weights are the port's
own (built from a seed), moved into the JAX parameter tree by the inverse
of the port's converter (checked by a round trip through it), so that no
JAX init is compiled. f32 throughout; each tolerance is stated where it
is used.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hosnerf_tpu.core import geopoly as jgeo
from hosnerf_tpu.core import rays as jrays
from hosnerf_tpu.core import render as jrender
from hosnerf_tpu.core import stepfun as jstep
from hosnerf_tpu.data import synthetic as jsyn
from hosnerf_tpu.models import scene as jscene
from hosnerf_tpu.train import checkpoints as jck
from hosnerf_tpu_torch import convert
from hosnerf_tpu_torch.core import geopoly, rays, render, stepfun
from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.models import scene


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    """(max error / max |ref|, relative L2 error)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max() + 1e-30
    return (np.abs(got - ref).max() / scale,
            np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-30))


def assert_close(got, ref, tol, what=""):
    """max error over the reference's largest magnitude <= tol; exact
    agreement of non-finite entries."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got)), what
    assert np.array_equal(got[~fin], ref[~fin]), what
    if fin.any():
        err, _ = _rel(got[fin], ref[fin])
        assert err <= tol, (what, err)


def _dense_node(sd, key):
    """A Linear's port entries as the JAX package's TorchLinear node."""
    return {"Dense_0": {"kernel": jnp.asarray(sd[key + ".weight"].T),
                        "bias": jnp.asarray(sd[key + ".bias"])}}


def _numbered(sd, prefix):
    """The j of the port's `{prefix}{j}.weight` keys, in order."""
    n = sum(1 for k in sd if k.startswith(prefix) and k.endswith(".weight")
            and k[len(prefix):-len(".weight")].isdigit())
    return range(n)


def scene_params_from_port(model, num_levels=3):
    """The JAX SceneField param tree holding the port model's weights:
    the inverse of `convert.scene_params_to_numpy`, which the caller's
    round trip checks."""
    sd = {k: v.detach().cpu().numpy().copy()      # never alias torch memory
          for k, v in model.state_dict().items()}
    params = {}
    for i in range(num_levels):
        base = f"mlps.{i}."
        node = {f"pts_linear_{j}": _dense_node(sd, f"{base}pts_linear.{j}")
                for j in _numbered(sd, base + "pts_linear.")}
        node.update({f"views_linear_{j}":
                     _dense_node(sd, f"{base}views_linear.{j}")
                     for j in _numbered(sd, base + "views_linear.")})
        for layer in ("density_layer", "bottleneck_layer", "rgb_layer"):
            if base + layer + ".weight" in sd:
                node[layer] = _dense_node(sd, base + layer)
        k = 0
        embeds = []
        while f"{base}bkgd_stateembeds.{k}" in sd:
            embeds.append(sd[f"{base}bkgd_stateembeds.{k}"])
            k += 1
        node["state_embeds"] = jnp.asarray(np.stack(embeds))
        params[f"prop_mlp_{i}" if i < num_levels - 1 else "nerf_mlp"] = node
    return params


def assert_round_trip(params, to_numpy, model):
    """The port's converter takes `params` back to the model's
    state_dict, entry for entry."""
    back = to_numpy(jax.tree.map(np.asarray, params))
    sd = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# geopoly, rays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,sub", [("icosahedron", 2), ("icosahedron", 1),
                                       ("octahedron", 2)])
def test_generate_basis_matches_jax(shape, sub):
    """numpy on both sides, the same steps -> equal."""
    np.testing.assert_array_equal(geopoly.generate_basis(shape, sub),
                                  jgeo.generate_basis(shape, sub))


def _ray_case(seed=0, R=6, S=5):
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=0.6, size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    t = np.sort(rng.uniform(0.2, 6.0, (R, S + 1)), -1).astype(np.float32)
    radii = rng.uniform(1e-3, 1e-2, (R, 1)).astype(np.float32)
    # points inside and far outside the unit ball, and one on its surface
    x = (rng.normal(size=(R, S, 3)) * np.geomspace(0.1, 50.0, S)[:, None]
         ).astype(np.float32)
    x[0, 0] = [0.6, 0.8, 0.0]
    return o, d, t, radii, x


def _basis():
    return jgeo.generate_basis("icosahedron", 2)


RAY_OPS = {
    "contract_points": lambda m, o, d, t, r, x: m.contract_points(x),
    "contract_jacobian": lambda m, o, d, t, r, x: m.contract_jacobian(x),
    "cast_cone_diag": lambda m, o, d, t, r, x: m.cast_rays(t, o, d, r),
    "cast_cone_full": lambda m, o, d, t, r, x: m.cast_rays(
        t, o, d, r, diag=False),
    "cast_cylinder_diag": lambda m, o, d, t, r, x: m.cast_rays(
        t, o, d, r, "cylinder"),
    "cast_cylinder_full": lambda m, o, d, t, r, x: m.cast_rays(
        t, o, d, r, "cylinder", diag=False),
    "contract_lift": lambda m, o, d, t, r, x: m.lift_and_diagonalize(
        *m.contract(*m.cast_rays(t, o, d, r, diag=False)), _B(m)),
    "ipe": lambda m, o, d, t, r, x: m.integrated_pos_enc(
        x, x * x * 0.01, 0, 12),
    "pos_enc": lambda m, o, d, t, r, x: m.pos_enc(d, 0, 4, True),
    "pos_enc_no_identity": lambda m, o, d, t, r, x: m.pos_enc(x, 1, 5, False),
    "fused_cone": lambda m, o, d, t, r, x: m.contracted_lifted_gaussians(
        o * 3, d, r, t, _B(m), "cone"),
    "fused_cylinder": lambda m, o, d, t, r, x: m.contracted_lifted_gaussians(
        o * 3, d, r, t, _B(m), "cylinder"),
    "ray_warps": lambda m, o, d, t, r, x: [
        f(t / 7.0) for f in m.construct_ray_warps(0.1, 1e6)],
}


def _B(m):
    b = _basis()
    return jnp.asarray(b) if m is jrays else torch.from_numpy(b)


def _listed(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def jax_family(ops, module, args):
    """Every op of a family on the same inputs, in one JAX compile:
    {name: [numpy outputs]}."""
    fn = jax.jit(lambda *a: {k: _listed(op(module, *a))
                             for k, op in ops.items()})
    return jax.tree.map(np.asarray, fn(*(jnp.asarray(a) for a in args)))


@pytest.fixture(scope="module")
def ray_refs(jax_refs):
    return jax_refs["ray"].result()


@pytest.mark.parametrize("name", sorted(RAY_OPS))
def test_ray_ops_match_jax(name, ray_refs):
    """Each ray function on the same inputs: f32 on both sides in
    another op order -> 1e-5 of each output's scale."""
    got = _listed(RAY_OPS[name](rays, *(_t(a) for a in _ray_case())))
    ref = ray_refs[name]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_close(g, r, 1e-5, f"{name}[{i}]")


def test_fused_lift_equals_composed_and_is_detached():
    """`contracted_lifted_gaussians` equals cast -> contract -> lift
    (1e-5 of the scale) and, like `contract`, passes no gradient."""
    o, d, t, r, _ = _ray_case(3)
    o, d, t, r = (_t(a).requires_grad_() for a in (o * 3, d, t, r))
    basis = _B(rays)
    fused = rays.contracted_lifted_gaussians(o, d, r, t, basis)
    composed = rays.lift_and_diagonalize(
        *rays.contract(*rays.cast_rays(t, o, d, r, diag=False)), basis)
    for a, b in zip(fused, composed):
        assert not a.requires_grad and not b.requires_grad
        assert_close(a, b.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def _step_case(seed=1, R=4, n=9, m=7):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, (R, n + 1)), -1).astype(np.float32)
    t[:, 0], t[:, -1] = 0.0, 1.0
    t[0, 3] = t[0, 4]                     # an empty interval
    w = rng.uniform(0, 1, (R, n)).astype(np.float32)
    w[1, 2] = 0.0
    w /= w.sum(-1, keepdims=True)
    q = np.sort(rng.uniform(-0.1, 1.1, (R, m + 1)), -1).astype(np.float32)
    q[0, 1] = t[0, 2]                     # ties with the knots
    q[1, 2] = t[1, 5]
    logits = np.log(w + 1e-3).astype(np.float32)
    logits[2, 4] = -np.inf
    logits[3, :3] = -np.inf
    u1 = rng.uniform(0, 1, (R, 1)).astype(np.float32)
    un = rng.uniform(0, 1, (R, 6)).astype(np.float32)
    return t, w, q, logits, u1, un


STEP_OPS = {
    "searchsorted": lambda m, t, w, q, lg, u1, un: m.searchsorted(t, q),
    "searchsorted_unbatched": lambda m, t, w, q, lg, u1, un:
        m.searchsorted(t[0], q),
    "inner_outer": lambda m, t, w, q, lg, u1, un: m.inner_outer(q, t, w),
    "lossfun_outer": lambda m, t, w, q, lg, u1, un: m.lossfun_outer(
        q, w[:, :7] / w[:, :7].sum(-1, keepdims=True), t, w),
    "lossfun_distortion": lambda m, t, w, q, lg, u1, un:
        m.lossfun_distortion(t, w),
    "max_dilate_weights": lambda m, t, w, q, lg, u1, un:
        m.max_dilate_weights(t, w, 0.03, (0.0, 1.0), renormalize=True),
    "max_dilate_open": lambda m, t, w, q, lg, u1, un:
        m.max_dilate(t, w, 0.05),
    "integrate_weights": lambda m, t, w, q, lg, u1, un:
        m.integrate_weights(w),
    "sorted_interp": lambda m, t, w, q, lg, u1, un:
        m.sorted_interp(q, t, t * t),
    "invert_cdf_inf_logits": lambda m, t, w, q, lg, u1, un:
        m.invert_cdf(m.integrate_weights(w)[:, :8], t, lg),
    "sample_linspace": lambda m, t, w, q, lg, u1, un:
        m.sample(None, False, t, lg, 6),
    "sample_centered": lambda m, t, w, q, lg, u1, un:
        m.sample(None, False, t, lg, 6, deterministic_center=True),
    "intervals_domain": lambda m, t, w, q, lg, u1, un:
        m.sample_intervals(None, False, t, lg, 6, domain=(0.1, 0.9)),
}


@pytest.fixture(scope="module")
def step_refs(jax_refs):
    return jax_refs["step"].result()


@pytest.mark.parametrize("name", sorted(STEP_OPS))
def test_stepfun_ops_match_jax(name, step_refs):
    """Each step function on the same inputs (empty intervals, zero
    weights, queries tied with knots and outside the domain, -inf
    logits): indices equal; values 1e-5 of the scale (f32, another op
    order)."""
    got = _listed(STEP_OPS[name](stepfun, *(_t(a) for a in _step_case())))
    ref = step_refs[name]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            assert_close(g, r, 1e-5, f"{name}[{i}]")


def _jax_uniform(key, shape):
    return jax.random.uniform(key, shape, dtype=jnp.float32)


SAMPLE_CASES = [(fn, sj) for fn in ("sample", "sample_intervals")
                for sj in (True, False)]


def _sample_kw(fn, single_jitter):
    kw = dict(single_jitter=single_jitter)
    if fn == "sample_intervals":
        kw["domain"] = (0.05, 0.95)
    return kw


def jax_sample_refs():
    """For each case, the uniforms JAX draws from its key
    (`jax.random.uniform(key, t.shape[:-1] + (d,))`) and JAX's randomized
    samples from that key, in one compile."""
    t, _, _, lg, _, _ = _step_case(2)

    @jax.jit
    def run(t, lg):
        key = jax.random.key(5)
        out = {}
        for fn, sj in SAMPLE_CASES:
            d = 1 if sj else 6
            out[fn, sj] = (_jax_uniform(key, t.shape[:-1] + (d,)),
                           getattr(jstep, fn)(key, True, t, lg, 6,
                                              **_sample_kw(fn, sj)))
        return out

    return jax.tree.map(np.asarray, run(jnp.asarray(t), jnp.asarray(lg)))


@pytest.fixture(scope="module")
def sample_refs(jax_refs):
    return jax_refs["sample"].result()


@pytest.mark.parametrize("single_jitter", [True, False])
@pytest.mark.parametrize("fn", ["sample", "sample_intervals"])
def test_randomized_sampling_matches_jax_on_its_uniforms(fn, single_jitter,
                                                         sample_refs):
    """The randomized branch, fed the uniforms JAX draws from its key,
    gives JAX's samples to 1e-5 of the scale; drawn from a torch
    generator instead it stays inside the domain and sorted."""
    t, _, _, lg, _, _ = _step_case(2)
    u, ref = sample_refs[fn, single_jitter]
    kw = _sample_kw(fn, single_jitter)
    got = getattr(stepfun, fn)(None, True, _t(t), _t(lg), 6, u=_t(u), **kw)
    assert_close(got, ref, 1e-5, fn)
    drawn = getattr(stepfun, fn)(torch.Generator().manual_seed(0), True,
                                 _t(t), _t(lg), 6, **kw)
    assert torch.all(drawn[..., 1:] >= drawn[..., :-1])
    assert float(drawn.min()) >= 0.0 and float(drawn.max()) <= 1.0


# ---------------------------------------------------------------------------
# compositing
# ---------------------------------------------------------------------------

def _render_case(seed=4, R=5, S=6):
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0, 3, (R, S)).astype(np.float32)
    tdist = np.sort(rng.uniform(0.5, 4, (R, S + 1)), -1).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    raw = np.concatenate([rgbs, dens[..., None]], -1)
    mask = rng.uniform(0, 1, (R, S, 1)).astype(np.float32)
    bg = np.array([255.0, 128.0, 0.0], np.float32)
    return dens, tdist, dirs, rgbs, raw, mask, bg


RENDER_OPS = {
    "alpha_weights": lambda m, de, td, di, rg, raw, mk, bg:
        m.compute_alpha_weights(de, td, di),
    "alpha_weights_opaque": lambda m, de, td, di, rg, raw, mk, bg:
        m.compute_alpha_weights(de, td, di, opaque_background=True),
    "volumetric_rendering": lambda m, de, td, di, rg, raw, mk, bg: list(
        m.volumetric_rendering(rg, m.compute_alpha_weights(de, td, di)[0],
                               bg / 255.0).values()),
    "volumetric_rendering_scalar_bg": lambda m, de, td, di, rg, raw, mk, bg:
        list(m.volumetric_rendering(
            rg, m.compute_alpha_weights(de, td, di)[0], 1.0).values()),
    "raw2outputs_joint": lambda m, de, td, di, rg, raw, mk, bg:
        m.raw2outputs_joint(raw, td[..., :-1], di),
    "raw2outputs_joint_mask_bg": lambda m, de, td, di, rg, raw, mk, bg:
        m.raw2outputs_joint(raw, td[..., :-1], di, mk, bg),
}


@pytest.fixture(scope="module")
def render_refs(jax_refs):
    return jax_refs["render"].result()


@pytest.mark.parametrize("name", sorted(RENDER_OPS))
def test_render_ops_match_jax(name, render_refs):
    """The compositing functions on the same inputs: 1e-5 of the scale."""
    got = _listed(RENDER_OPS[name](render, *(_t(a) for a in _render_case())))
    ref = render_refs[name]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_close(g, r, 1e-5, f"{name}[{i}]")


# ---------------------------------------------------------------------------
# SceneField
# ---------------------------------------------------------------------------

SCENE = dict(num_prop_samples=8, num_nerf_samples=6, prop_netwidth=16,
             nerf_netwidth=32, num_states=2)
NEAR, FAR = 0.5, 20.0


@pytest.fixture(scope="module")
def scene_case():
    """Port SceneField (seed 0) and the JAX SceneField with its weights,
    on 12 scene rays, state 1."""
    nb = synthetic.scene_ray_batch(12, seed=2)
    batch = {k: nb[k] for k in ("rays_o", "rays_d", "viewdirs", "radii")}
    model = scene.SceneField(remat=False, device="cpu", **SCENE)
    jmodel = jscene.SceneField(remat=False, **SCENE)
    params = scene_params_from_port(model)
    assert_round_trip(params, convert.scene_params_to_numpy, model)
    return model, jmodel, params, batch


def _jax_scene_loss(jmodel, batch, rng, train_frac):
    def loss(p):
        rend, hist = jmodel.apply({"params": p}, batch, train_frac,
                                  rng is not None, jnp.int32(1), NEAR, FAR,
                                  rng=rng)
        total = (jnp.sum(rend[-1]["rgb"] * jnp.arange(1.0, 4.0))
                 + jnp.sum(hist[-1]["density"] * 1e-2)
                 + jscene.interlevel_loss(hist)
                 + jscene.distortion_loss(hist))
        return total, (rend, hist)
    return loss


def _port_scene_loss(model, batch, generator, train_frac):
    rend, hist = model(batch, train_frac, generator is not None, 1, NEAR,
                       FAR, generator=generator)
    total = (torch.sum(rend[-1]["rgb"] * torch.arange(1.0, 4.0))
             + torch.sum(hist[-1]["density"] * 1e-2)
             + scene.interlevel_loss(hist) + scene.distortion_loss(hist))
    return total, (rend, hist)


def replay_draws(monkeypatch, draws):
    """Make each randomized `stepfun.sample_intervals` call take the next
    of `draws` as its uniforms instead of drawing from its generator."""
    draws = iter(draws)
    real = stepfun.sample_intervals

    def replayed(generator, randomized, *args, **kw):
        return real(None, randomized, *args, u=next(draws), **kw)

    monkeypatch.setattr(stepfun, "sample_intervals", replayed)


def _jax_level_uniforms(rng, bsz, levels):
    """The jitter draws JAX's SceneField makes from `rng` (single_jitter:
    one per ray and level; the key split before each level's draw, and
    again for the MLP)."""
    out = []
    for _ in range(levels):
        rng, level_rng = jax.random.split(rng)
        out.append(_jax_uniform(level_rng, (bsz, 1)))
        rng, _ = jax.random.split(rng)
    return out


SCENE_CASES = [(False, 1.0), (True, 0.3)]


def jax_scene_refs(jmodel, params, batch):
    """JAX's loss, outputs and gradients for each case of
    `test_scene_field_matches_jax`, and the randomized case's jitter
    draws, in one compile."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def run(p):
        out = {}
        for randomized, train_frac in SCENE_CASES:
            rng = jax.random.key(7) if randomized else None
            (total, (rend, hist)), grads = jax.value_and_grad(
                _jax_scene_loss(jmodel, jb, rng, train_frac),
                has_aux=True)(p)
            out[randomized, train_frac] = dict(
                total=total, rend=rend, hist=hist, grads=grads,
                u=(_jax_level_uniforms(rng, 12, 3) if randomized else []))
        return out

    return jax.tree.map(np.asarray, run(params))


@pytest.fixture(scope="module")
def scene_refs(jax_refs):
    return jax_refs["scene"].result()


@pytest.fixture(scope="module", autouse=True)
def jax_refs(_threads, scene_case):
    """Every JAX reference of the module, started with it in a pool of
    threads: XLA compiles without holding the GIL, so the compiles overlap
    each other and the port's side of the tests. Each fixture above waits
    for its own."""
    _, jmodel, params, batch = scene_case
    with ThreadPoolExecutor(4) as pool:
        yield {"ray": pool.submit(jax_family, RAY_OPS, jrays, _ray_case()),
               "step": pool.submit(jax_family, STEP_OPS, jstep,
                                   _step_case()),
               "sample": pool.submit(jax_sample_refs),
               "render": pool.submit(jax_family, RENDER_OPS, jrender,
                                     _render_case()),
               "scene": pool.submit(jax_scene_refs, jmodel, params, batch)}


@pytest.mark.parametrize("randomized,train_frac", SCENE_CASES)
def test_scene_field_matches_jax(scene_case, scene_refs, monkeypatch,
                                 randomized, train_frac):
    """Every level's sdist, tdist, density, rgb and weights, each
    rendering, and the gradient of a loss over the last level's rgb and
    density plus the interlevel and distortion losses, against JAX:
    deterministic, and randomized with JAX's own jitter draws replayed
    into the port's sampler (at an annealed train_frac). Values 1e-4 of each output's scale (f32 through
    an 8-layer trunk, IPE frequencies up to 2^11); every gradient leaf to
    1e-4 relative L2, and the proposal MLPs' exactly where JAX's are 0."""
    model, _, _, batch = scene_case
    ref = scene_refs[randomized, train_frac]
    gen = None
    if randomized:
        replay_draws(monkeypatch, [_t(u) for u in ref["u"]])
        gen = torch.Generator().manual_seed(0)
    model.zero_grad(set_to_none=True)
    total, (rend, hist) = _port_scene_loss(
        model, {k: _t(v) for k, v in batch.items()}, gen, train_frac)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(ref["total"]),
                               rtol=1e-5)
    for lvl, (h, rh) in enumerate(zip(hist, ref["hist"])):
        for k in ("sdist", "tdist", "density", "rgb", "weights"):
            assert_close(h[k], rh[k], 1e-4, f"level {lvl} {k}")
    for r, rr in zip(rend, ref["rend"]):
        for k in ("rgb", "acc"):
            assert_close(r[k], rr[k], 1e-4, k)
    ref_g = convert.scene_params_to_numpy(ref["grads"])
    for name, p in model.named_parameters():
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros_like(ref_g[name]))
        if not np.abs(ref_g[name]).any():
            assert not np.abs(got).any(), name
            continue
        assert _rel(got, ref_g[name])[1] <= 1e-4, (name,
                                                   _rel(got, ref_g[name]))


@pytest.mark.parametrize("remat,chunk", [("all", None), ("heavy", 5),
                                         (False, 5)])
def test_scene_remat_and_chunk_keep_values_and_grads(scene_case, remat,
                                                     chunk):
    """remat ('all', 'heavy') and mlp_chunk (5 rays: 12 padded to 15)
    change neither values nor gradients (1e-6 of the scale; the chunked
    products may sum in another order) nor parameter names."""
    model, _, _, batch = scene_case
    tb = {k: _t(v) for k, v in batch.items()}
    other = scene.SceneField(remat=remat, mlp_chunk=chunk, device="cpu",
                             **SCENE)
    other.load_state_dict(model.state_dict(), strict=True)
    outs = []
    for m in (model, other):
        m.zero_grad(set_to_none=True)
        total, (_, hist) = _port_scene_loss(m, tb, None, 1.0)
        total.backward()
        outs.append((hist, {n: p.grad for n, p in m.named_parameters()
                            if p.grad is not None}))
    (h0, g0), (h1, g1) = outs
    for a, b in zip(h0, h1):
        for k in ("density", "rgb", "weights"):
            assert_close(b[k], a[k].detach().numpy(), 1e-6, k)
    assert sorted(g0) == sorted(g1)
    for n in g0:
        assert_close(g1[n], g0[n].numpy(), 1e-6, n)


def test_scene_noise_comes_from_the_generator(scene_case):
    """With density and bottleneck noise on, a randomized forward adds
    noise drawn from its generator: the same seed gives the same output,
    another seed another one, and without a generator none is added."""
    model, _, _, batch = scene_case
    tb = {k: _t(v) for k, v in batch.items()}
    noisy = scene.SceneField(remat=False, device="cpu", **SCENE)
    noisy.load_state_dict(model.state_dict(), strict=True)
    for mlp in noisy.mlps:
        mlp.density_noise, mlp.bottleneck_noise = 1.0, 1.0

    def rgb(m, seed=None, randomized=True):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return m(tb, 1.0, randomized, 1, NEAR, FAR,
                     generator=gen)[1][-1]["rgb"]

    a, b, c = rgb(noisy, 3), rgb(noisy, 3), rgb(noisy, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(rgb(noisy), rgb(model))
    assert not torch.equal(a, rgb(model, 3))


def test_scene_bf16_trunks_track_f32(scene_case):
    """compute_dtype='bf16' runs the trunks on bf16 operands (the heads,
    sampling and compositing f32): the last level's rgb within 2e-2 of the
    f32 model's (bf16 activations through 8 layers), params unchanged."""
    model, _, _, batch = scene_case
    tb = {k: _t(v) for k, v in batch.items()}
    bf = scene.SceneField(remat=False, compute_dtype="bf16", device="cpu",
                          **SCENE)
    bf.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        ref = model(tb, 1.0, False, 1, NEAR, FAR)[1][-1]["rgb"]
        got = bf(tb, 1.0, False, 1, NEAR, FAR)[1][-1]["rgb"]
    assert got.dtype == torch.float32
    assert_close(got, ref.numpy(), 2e-2)


def test_scene_state_dict_matches_export(scene_case):
    """`scene_params_to_numpy` emits `export_scene_params`' keys (prefix
    '') with the same arrays, and the state_dict loads strictly."""
    model, _, params, _ = scene_case
    np_params = jax.tree.map(np.asarray, params)
    ref = jck.export_scene_params(np_params, prefix="")
    got = convert.scene_params_to_numpy(np_params)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    other = scene.SceneField(remat=False, device="cpu", **SCENE)
    other.load_state_dict(convert.scene_state_dict(np_params), strict=True)
    for k, v in other.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      model.state_dict()[k].numpy())


@pytest.mark.parametrize("which", ["composed_batch", "scene_ray_batch"])
def test_synthetic_batches_match_jax(which):
    """The port's numpy copies give the JAX package's arrays."""
    args = (2, 4) if which == "composed_batch" else (9,)
    got = getattr(synthetic, which)(*args, seed=3)
    ref = getattr(jsyn, which)(*args, seed=3)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


def test_rays_keep_eps():
    assert rays.EPS == jrays.EPS and stepfun.EPS == jstep.EPS
