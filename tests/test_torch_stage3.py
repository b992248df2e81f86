"""The port's stage-3 slice against the JAX package on the CPU: the sample
merge, the composition, the composed forward and the full stage-3 step
(loss, every gradient leaf, the parameters after one Adam step), and the
composed render entry.

The full step runs at the tiny configuration of the JAX package's
multichip dry run, with no sample jitter (no generator on either side) and
no LPIPS term. The JAX side runs its flax MLPs and its one-hot ("xla")
LBS form: the same function as the gather form that the stage-2 tests
hold the port to, in half the trace and compile time on the CPU. Both
models' weights are the port's (built from a seed) moved into the JAX
tree through the port's converters, and one JAX compile of the stage-3
loss gradient and Adam step is shared by a module-scoped fixture, which
compiles in the background while the other tests run.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hosnerf_tpu.models import composed as jcomposed
from hosnerf_tpu.ops import merge as jmerge
from hosnerf_tpu.train import stage3 as jstage3
from hosnerf_tpu_torch import convert
from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.eval import renderers
from hosnerf_tpu_torch.models import composed
from hosnerf_tpu_torch.ops import merge
from hosnerf_tpu_torch.train import stage3
from test_torch_scene import (_dense_node, _numbered, _rel, _t,
                              assert_close, assert_round_trip,
                              scene_params_from_port)

ITER = 60_000
TINY = dict(n_samples=8, cnl_mlp_width=32, nr_mlp_width=16,
            mweight_volume_size=8, n_patches=2, patch_size=4,
            num_prop_samples=8, num_nerf_samples=4, nerf_netwidth=32,
            prop_netwidth=16, near_bkg=0.5, far_bkg=20.0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# merge and compose
# ---------------------------------------------------------------------------

def _streams(seed=0, R=6, Nb=7, Nh=5):
    """Two sample streams per ray with cross-stream ties, a dense sample,
    zero-mask human samples and a ray whose direction has tiny entries."""
    rng = np.random.default_rng(seed)
    z_b = np.sort(rng.uniform(0.5, 5, (R, Nb)), -1).astype(np.float32)
    z_h = np.sort(rng.uniform(1.5, 3.5, (R, Nh)), -1).astype(np.float32)
    z_b[0, 3] = z_h[0, 2]                 # ties across the streams
    z_b[1, 1] = z_h[1, 0]
    z_b = np.sort(z_b, -1)
    out_b = np.concatenate([rng.uniform(0, 1, (R, Nb, 3)),
                            rng.uniform(0, 2, (R, Nb, 1))], -1)
    out_h = np.concatenate([rng.uniform(0, 1, (R, Nh, 3)),
                            rng.uniform(0, 4, (R, Nh, 1))], -1)
    out_h[2, 1, 3] = 1e4                  # an opaque human sample
    mask = rng.uniform(0, 1, (R, Nh))
    mask[3] = 0.0
    d = rng.normal(size=(R, 3))
    d[4] = [1e-7, 0.6, 0.8]
    d[5] = [1e-7, 2e-6, 3e-6]             # no component above thresh
    return tuple(a.astype(np.float32) for a in
                 (z_b, out_b, z_h, out_h, mask, d))


def test_z_along_ray_matches_jax():
    """Depths of points along rays, including rays with entries and with
    all entries below the threshold: 1e-5 of the scale."""
    rng = np.random.default_rng(1)
    *_, d = _streams()
    o = rng.normal(size=d.shape).astype(np.float32)
    pts = (o[:, None] + d[:, None] * rng.uniform(1, 3, (6, 4, 1))
           + rng.normal(scale=1e-3, size=(6, 4, 3))).astype(np.float32)
    assert_close(merge.z_along_ray(_t(pts), _t(o), _t(d)),
                 jax.jit(jmerge.z_along_ray)(jnp.asarray(pts), jnp.asarray(o),
                                             jnp.asarray(d)), 1e-5)


def test_merge_sorted_streams_matches_jax():
    """The stable merge (ties: background first): orders and payloads
    equal, and the weights of `raw2outputs_joint` over it mapped back to
    the human samples to 1e-5 of the scale."""
    from hosnerf_tpu.core import render as jrender
    from hosnerf_tpu_torch.core import render
    z_b, out_b, z_h, out_h, mask, d = _streams()
    got = merge.merge_sorted_streams(*(_t(a) for a in
                                       (z_b, out_b, z_h, out_h, mask)))

    @jax.jit
    def jfn(z_b, out_b, z_h, out_h, mask, d):
        ref = jmerge.merge_sorted_streams(z_b, out_b, z_h, out_h, mask)
        rw = jrender.raw2outputs_joint(ref["out"], ref["z"], d,
                                       ref["mask"])[2]
        return ref, jmerge.extract_human_weights(rw, ref)

    ref, ref_w = jfn(*(jnp.asarray(a) for a in
                       (z_b, out_b, z_h, out_h, mask, d)))
    for k in ("z", "out", "mask", "inv_order"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    w = render.raw2outputs_joint(got["out"], got["z"], _t(d),
                                 got["mask"])[2]
    assert_close(merge.extract_human_weights(w, got), ref_w, 1e-5)


def test_sortless_composite_matches_jax_and_sorted_merge():
    """`sortless_composite` against JAX's (1e-5 of the scale), and against
    the sorted merge composited by `raw2outputs_joint` in the port: rgb,
    acc, depth and the human weights to 1e-5 of the scale (the same
    products, summed as logs)."""
    from hosnerf_tpu_torch.core import render
    args = _streams()
    got = merge.sortless_composite(*(_t(a) for a in args))
    ref = jax.jit(jmerge.sortless_composite)(*(jnp.asarray(a)
                                               for a in args))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_close(g, r, 1e-5, f"output {i}")
    z_b, out_b, z_h, out_h, mask, d = (_t(a) for a in args)
    m = merge.merge_sorted_streams(z_b, out_b, z_h, out_h, mask)
    rgb, acc, w, depth = render.raw2outputs_joint(m["out"], m["z"], d,
                                                  m["mask"])
    for g, r in ((got[0], rgb), (got[1], acc), (got[3],
                                                merge.extract_human_weights(
                                                    w, m)),
                 (got[4], depth)):
        assert_close(g, r.numpy(), 1e-5)


def _compose_inputs(seed=2, R=6, Nb=7, Nh=5):
    rng = np.random.default_rng(seed)
    z_b, out_b, z_h, out_h, mask, d = _streams(seed, R, Nb, Nh)
    o = rng.normal(scale=0.1, size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tdist = np.concatenate([z_b, z_b[:, -1:] + 1.0], -1)
    m2w = np.eye(4, dtype=np.float32)
    m2w[:3, 3] = [0.01, -0.02, 0.03]
    pts = (o[:, None] + d[:, None] * z_h[..., None]).astype(np.float32)
    mask[4] = 1e-3                          # sums below FG_THRESHOLD
    last = {"rgb": out_b[..., :3], "density": out_b[..., 3], "tdist": tdist}
    hum = {"human_rgb": out_h[..., :3], "human_density": out_h[..., 3],
           "newsmpl_pts": pts, "pts_mask": mask}
    batch = {"rays_o_bkg": o, "rays_d_bkg": d.astype(np.float32),
             "newsmpl_to_scale_world": m2w}
    cot = {"rgb": rng.normal(size=(R, 3)), "acc": rng.normal(size=(R,)),
           "depth": rng.normal(size=(R,)),
           "human_weights": rng.normal(size=(R, Nh))}
    return last, hum, batch, {k: v.astype(np.float32) for k, v in cot.items()}


DIFF_IN = (("last", "rgb"), ("last", "density"), ("hum", "human_rgb"),
           ("hum", "human_density"), ("hum", "pts_mask"))


@pytest.mark.parametrize("sortless", [True, False])
def test_compose_matches_jax(sortless):
    """`compose`, both branches, against JAX's: rgb, acc, depth, the
    human weights and idx_fg to 1e-5 of the scale; the gradients of a
    random cotangent in the five differentiable inputs (both streams'
    rgb and density, the human mask) to 1e-4 relative L2."""
    last, hum, batch, cot = _compose_inputs()

    def jfn(diff):
        l2, h2 = dict(last), dict(hum)
        for (where, k), v in zip(DIFF_IN, diff):
            (l2 if where == "last" else h2)[k] = v
        out = jcomposed.compose(
            {k: jnp.asarray(v) for k, v in l2.items()},
            {k: jnp.asarray(v) for k, v in h2.items()},
            {k: jnp.asarray(v) for k, v in batch.items()}, sortless)
        return out, sum(jnp.sum(out[k] * cot[k]) for k in cot)

    src = {"last": last, "hum": hum}
    diff = [jnp.asarray(src[w][k]) for w, k in DIFF_IN]
    (_, ref), ref_g = jax.jit(jax.value_and_grad(
        lambda a: jfn(a)[::-1], has_aux=True))(diff)

    tdiff = [_t(src[w][k]).requires_grad_() for w, k in DIFF_IN]
    l2 = {k: _t(v) for k, v in last.items()}
    h2 = {k: _t(v) for k, v in hum.items()}
    for (where, k), v in zip(DIFF_IN, tdiff):
        (l2 if where == "last" else h2)[k] = v
    out = composed.compose(l2, h2, {k: _t(v) for k, v in batch.items()},
                           sortless)
    np.testing.assert_array_equal(out["idx_fg"].numpy(),
                                  np.asarray(ref["idx_fg"]))
    assert not out["idx_fg"].numpy().all() and out["idx_fg"].numpy().any()
    for k in cot:
        assert_close(out[k], ref[k], 1e-5, k)
    sum(torch.sum(out[k] * _t(cot[k])) for k in cot).backward()
    for (where, k), g, r in zip(DIFF_IN, tdiff, ref_g):
        assert _rel(g.grad.numpy(), r)[1] <= 1e-4, (k, _rel(g.grad.numpy(),
                                                            r))


# ---------------------------------------------------------------------------
# the full stage-3 step
# ---------------------------------------------------------------------------

def human_params_from_port(model):
    """The JAX HumanObjectField param tree holding the port model's
    weights: the inverse of `convert.human_params_to_numpy`."""
    sd = {k: v.detach().cpu().numpy().copy()      # never alias torch memory
          for k, v in model.state_dict().items()}

    def nr_mlp(prefix):
        depth = len(_numbered(sd, prefix)) - 1      # the head follows
        node = {f"linear_{j}": _dense_node(sd, f"{prefix}{2 * j}")
                for j in range(depth)}
        node["output"] = _dense_node(sd, f"{prefix}{2 * depth}")
        return node

    cnl = {f"linear_{j}": _dense_node(sd, f"cnl_mlp.pts_linears.{2 * j}")
           for j in _numbered(sd, "cnl_mlp.pts_linears.")}
    cnl["output"] = _dense_node(sd, "cnl_mlp.output_linear.0")
    pose = {f"trunk_{j}": _dense_node(sd, f"pose_decoder.block_mlps.{2 * j}")
            for j in _numbered(sd, "pose_decoder.block_mlps.")}
    for head, ours in (("block_mlps_dstR", "head_r"),
                       ("block_mlps_dstT", "head_t")):
        pose[f"{ours}_0"] = _dense_node(sd, f"pose_decoder.{head}.0")
        pose[f"{ours}_out"] = _dense_node(sd, f"pose_decoder.{head}.2")
    base = "mweight_vol_decoder.decoder."
    convs = list(_numbered(sd, base + "block_conv."))
    dec = {"block_mlp": _dense_node(sd, base + "block_mlp.0")}
    for n in convs:
        w = np.flip(sd[f"{base}block_conv.{2 * n}.weight"], (2, 3, 4))
        dec["deconv_out" if n == len(convs) - 1 else f"deconv_{n}"] = {
            "kernel": jnp.asarray(w.transpose(2, 3, 4, 0, 1)),
            "bias": jnp.asarray(sd[f"{base}block_conv.{2 * n}.bias"])}
    k, embeds = 0, []
    while f"human_stateembeds.{k}" in sd:
        embeds.append(sd[f"human_stateembeds.{k}"])
        k += 1
    return {"cnl_mlp": cnl,
            "non_rigid_mlp": nr_mlp("non_rigid_mlp.block_mlps."),
            "non_rigid_forward_mlp": nr_mlp(
                "non_rigid_forward_mlp.block_mlps."),
            "pose_decoder": pose,
            "mweight_vol_decoder": {
                "const_embedding": jnp.asarray(
                    sd["mweight_vol_decoder.const_embedding"]),
                "decoder": dec},
            "state_embeds": jnp.asarray(np.stack(embeds))}


@pytest.fixture(scope="module", autouse=True)
def step_case(_threads):
    """The tiny stage-3 config on both sides with the port's weights: the
    port's models and batch, and under 'ref' JAX's loss terms, gradients
    and the parameters after one optax step of `make_optimizer` (one
    compile; `jax_ref` waits for them). Autouse, so that it starts with
    the module: JAX compiles in a background thread (XLA compiles without
    holding the GIL) while the tests that do not need its results run."""
    nb = synthetic.composed_batch(TINY["n_patches"], TINY["patch_size"],
                                  grid_size=TINY["mweight_volume_size"])
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    tcfg = stage3.Stage3Config(**TINY)
    scene, human = stage3.make_models(tcfg, device="cpu")
    jcfg = jstage3.Stage3Config(**TINY, lbs_impl="xla")
    jscene, jhuman = jstage3.make_models(jcfg)
    params = {"scene": scene_params_from_port(scene),
              "human": human_params_from_port(human)}
    loss_fn = jstage3.make_loss_fn(jcfg, jscene, jhuman)
    jopt = jstage3.make_optimizer(jcfg, params)

    @jax.jit
    def jstep(p):
        (total, losses), grads = jax.value_and_grad(
            lambda q: loss_fn(q, None, batch, ITER, jnp.int32(0), None),
            has_aux=True)(p)
        upd, _ = jopt.update(grads, jopt.init(p), p)
        return total, losses, grads, optax.apply_updates(p, upd)

    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(lambda: jax.tree.map(np.asarray, jstep(params)))
        assert_round_trip(params["scene"], convert.scene_params_to_numpy,
                          scene)
        assert_round_trip(params["human"], convert.human_params_to_numpy,
                          human)
        yield dict(nb=nb, tcfg=tcfg, scene=scene, human=human, ref=ref)


def jax_ref(case):
    """The case with JAX's results added (total, losses, ref_g, ref_new),
    once the background compile and run have finished."""
    if "total" not in case:
        total, losses, grads, new = case["ref"].result()
        case.update(
            total=float(total),
            losses={k: float(v) for k, v in losses.items()},
            ref_g={"scene": convert.scene_params_to_numpy(grads["scene"]),
                   "human": convert.human_params_to_numpy(grads["human"])},
            ref_new={"scene": convert.scene_params_to_numpy(new["scene"]),
                     "human": convert.human_params_to_numpy(new["human"])})
    return case


def _port_loss(case):
    tb = {k: _t(v) for k, v in case["nb"].items()}
    for m in (case["scene"], case["human"]):
        m.zero_grad(set_to_none=True)
    total, losses = stage3.make_loss_fn(case["tcfg"], case["scene"],
                                        case["human"])(tb, ITER,
                                                       torch.tensor(0))
    total.backward()
    return float(total.detach()), {k: float(v.detach())
                                   for k, v in losses.items()}


def test_composed_render_entry(step_case):
    """`make_composed_render_fn` through `render_human_image` (chunks of 8
    rays, the last padded, the background ray keys and
    newsmpl_to_scale_world passed on) gives the composed forward's rgb on
    the whole batch at iter 10**7, without autograd; that rgb equals the
    training forward's at ITER (the same field with no jitter: 1e-6), whose
    mse term `test_stage3_loss_and_grads_match_jax` holds to JAX's."""
    case = step_case
    cfg, scene, human = case["tcfg"], case["scene"], case["human"]
    item = dict(case["nb"], img_height=4, img_width=8)
    fn = renderers.make_composed_render_fn(cfg, scene, human)
    img = renderers.render_human_image(
        fn, item, "cpu", chunk=12, extra_keys=("newsmpl_to_scale_world",))
    tb = {k: _t(v) for k, v in case["nb"].items()}
    with torch.no_grad():
        comp, _ = stage3.composed_forward(cfg, scene, human, tb,
                                          renderers.RENDER_ITER,
                                          torch.tensor(0))
        train_comp, _ = stage3.composed_forward(cfg, scene, human, tb, ITER,
                                                torch.tensor(0),
                                                is_train=True)
    assert img.shape == (4, 8, 3) and np.isfinite(img).all()
    assert_close(img.reshape(-1, 3), comp["rgb"].numpy(), 1e-6)
    assert_close(train_comp["rgb"], comp["rgb"].numpy(), 1e-6)


def test_stage3_step_with_generator_is_reproducible(step_case):
    """With a generator the step jitters both fields' samples (the scene's
    and the human's generators split from it): the same seed gives the
    same loss, another seed another one, and each stays finite."""
    case = step_case
    cfg = stage3.Stage3Config(**TINY)
    tb = {k: _t(v) for k, v in case["nb"].items()}
    loss_fn = stage3.make_loss_fn(cfg, case["scene"], case["human"])
    with torch.no_grad():
        a, b, c = (float(loss_fn(tb, ITER, torch.tensor(0),
                                 torch.Generator().manual_seed(s))[0])
                   for s in (3, 3, 4))
    assert np.isfinite([a, b, c]).all() and a == b and a != c


def test_stage3_gradcheck_cotangent_gives_the_loss_gradient():
    """`gradcheck.stage3_grads` backpropagates the image terms (LPIPS on
    its random backbone, mse) as a cotangent of the composed patches and
    the flow and cycle terms through their own gradients. With the side's
    own image gradient that is the stage-3 loss's gradient; with a zero
    cotangent, the flow and cycle terms' alone. Every leaf to 1e-6
    relative L2 (the same products), on one 16 x 16 patch (LPIPS's
    smallest input) at the tiny widths."""
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.models.state import state_index
    from hosnerf_tpu_torch.train import gradcheck
    cfg = stage3.Stage3Config(**dict(TINY, n_patches=1, patch_size=16))
    nb = synthetic.composed_batch(1, 16, grid_size=TINY["mweight_volume_size"])
    scene, human = stage3.make_models(cfg, device="cpu")
    sds = {"scene.": scene.state_dict(), "human.": human.state_dict()}
    tb = {k: _t(v) for k, v in nb.items()}
    lp = lpips.load_weights(lpips.LPIPS(device="cpu"), quiet=True
                            ).requires_grad_(False)
    loss, grads, own = gradcheck.stage3_grads(cfg, nb, "cpu", sds)
    _, only_terms, _ = gradcheck.stage3_grads(cfg, nb, "cpu", sds,
                                              torch.zeros_like(own))
    assert float(own.abs().max()) > 0
    for c, got, want_loss in (
            (cfg, grads, loss),
            (dataclasses.replace(cfg, w_lpips=0.0, w_mse=0.0), only_terms,
             None)):
        for m in (scene, human):
            m.zero_grad(set_to_none=True)
        total, losses = stage3.make_loss_fn(c, scene, human, lp)(
            tb, gradcheck.ITER, state_index(tb["time"], None))
        total.backward()
        if want_loss is not None:
            assert float(losses["lpips"]) > 0
            np.testing.assert_allclose(want_loss, float(total.detach()),
                                       rtol=1e-6)
        ref = {p + n: q.grad for p, m in (("scene.", scene),
                                          ("human.", human))
               for n, q in m.named_parameters() if q.grad is not None}
        assert sorted(got) == sorted(ref)
        for name, g in ref.items():
            if not g.abs().any():
                assert not got[name].abs().any(), name
                continue
            assert _rel(got[name], g)[1] <= 1e-6, (name, _rel(got[name], g))


def test_stage3_loss_and_grads_match_jax(step_case):
    """The stage-3 loss and each of its terms to 1e-5 relative (the flow
    and cycle terms nonzero), and every gradient leaf of both models to
    1e-4 relative L2: the same f32 math in another op order through the
    scene's 8-layer NeRF MLP and the human field's MLPs and volume
    decoder. The proposal MLPs get exactly zero gradient on both sides
    (their samples are detached)."""
    total, losses = _port_loss(step_case)
    step_case = jax_ref(step_case)
    np.testing.assert_allclose(total, step_case["total"], rtol=1e-5)
    for k, v in step_case["losses"].items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    assert step_case["losses"]["flow"] > 0
    assert step_case["losses"]["cycle"] > 0
    zero = set()
    for part in ("scene", "human"):
        ref = step_case["ref_g"][part]
        for name, p in step_case[part].named_parameters():
            got = (p.grad.numpy() if p.grad is not None
                   else np.zeros_like(ref[name]))
            if not np.abs(ref[name]).any():
                assert not np.abs(got).any(), name
                zero.add((part, name))
                continue
            assert _rel(got, ref[name])[1] <= 1e-4, (name,
                                                     _rel(got, ref[name]))
    prop = {("scene", n) for n, _ in step_case["scene"].named_parameters()
            if n.startswith(("mlps.0.", "mlps.1."))}
    assert prop and {z for z in zero if z[0] == "scene"} == prop


def _set_grad(ref):
    def hook(p):
        p.grad.copy_(torch.from_numpy(ref))
    return hook


def test_stage3_adam_step_matches_optax(step_case):
    """One step of the port's train step with JAX's gradients handed to
    its Adam (hooks replace each accumulated gradient): the parameters of
    both models meet optax's `make_optimizer` update to 1e-6 relative or
    3e-8 absolute, each of the seven lr groups at its own rate; the
    proposal MLPs, with no gradient, stay unchanged as under optax's zero
    update."""
    case = jax_ref(step_case)
    scene, human = case["scene"], case["human"]
    sd0 = {**{"s." + k: v.clone() for k, v in scene.state_dict().items()},
           **{"h." + k: v.clone() for k, v in human.state_dict().items()}}
    opt = stage3.make_optimizer(case["tcfg"], scene, human)
    assert {g["group"] for g in opt.param_groups} == set(stage3.GROUPS)
    handles = []
    for part in ("scene", "human"):
        ref = case["ref_g"][part]
        for name, p in case[part].named_parameters():
            handles.append(p.register_post_accumulate_grad_hook(
                _set_grad(ref[name])))
    step = stage3.make_train_step(case["tcfg"], scene, human, opt)
    try:
        losses = step({k: _t(v) for k, v in case["nb"].items()}, ITER)
    finally:
        for h in handles:
            h.remove()
    np.testing.assert_allclose(float(losses["loss"]), case["total"],
                               rtol=1e-5)
    refs = case["ref_new"]
    moved = 0
    for part, prefix in (("scene", "s."), ("human", "h.")):
        for k, v in case[part].state_dict().items():
            np.testing.assert_allclose(v.numpy(), refs[part][k], rtol=1e-6,
                                       atol=3e-8, err_msg=k)
            moved += int(not torch.equal(v, sd0[prefix + k]))
    assert moved > 0
    for k in scene.state_dict():
        if k.startswith(("mlps.0.", "mlps.1.")):
            assert torch.equal(scene.state_dict()[k], sd0["s." + k]), k
