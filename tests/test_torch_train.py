"""The port's stage-2 training slice against the JAX package on the CPU.

Inputs are made from numpy seeds and handed to both packages; JAX params
move with the port's converter. The plain versions of the three backward
kernels (inverse LBS, fused forward LBS, fused embed+trunk) are held
against the JAX package's VJPs (its Pallas kernels in interpret mode,
except the fused-MLP VJP, which is broken on the installed JAX, so the
flax modules' VJP is the oracle there); then the whole stage-2 loss and
every gradient, the optimizer and LPIPS. Each tolerance is stated where it
is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hosnerf_tpu.data import synthetic
from hosnerf_tpu.models import embedders as jemb
from hosnerf_tpu.models import human_components as jhc
from hosnerf_tpu.models import lpips as jlpips
from hosnerf_tpu.ops.pallas import lbs as plbs
from hosnerf_tpu.train import stage2 as jstage2
from hosnerf_tpu_torch import convert
from hosnerf_tpu_torch.models import lpips as tlpips
from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
from hosnerf_tpu_torch.train import schedules as tsched
from hosnerf_tpu_torch.train import stage2 as tstage2
from test_torch_cuda import mlp_case, torch_args

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
# B4: inverse-LBS backward
# ---------------------------------------------------------------------------

def _inverse_case(B, G, n, seed):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * 0.7).astype(np.float32)
    pts[:128] += 20.0                    # 16 dead sort groups
    Rs = np.stack([np.eye(3) + 0.1 * rng.randn(3, 3) for _ in range(B)])
    Ts = 0.2 * rng.randn(B, 3)
    vol = np.asarray(jax.nn.softmax(
        jnp.asarray(rng.randn(B + 1, G, G, G), jnp.float32), axis=0))
    bmin = jnp.asarray([-1.3, -1.1, -1.2], jnp.float32)
    bscale = jnp.asarray([0.9, 1.0, 1.1], jnp.float32)
    s_, o_ = plbs._grid_affine(bmin, bscale, G)
    rg = (jnp.asarray(Rs, jnp.float32) * s_[None, :, None]).reshape(B, 9)
    tg = jnp.asarray(Ts, jnp.float32) * s_[None] + o_[None]
    vol_qz = jnp.transpose(jnp.asarray(vol)[:B], (0, 3, 2, 1)).reshape(
        B, G * G, G)
    dom = plbs.bp_prepare(jnp.asarray(pts), rg, tg, G, B, kind="quad")
    pts_s = dom.sort_rows(jnp.asarray(pts))
    gacc = jnp.asarray(rng.randn(pts_s.shape[0], 4), jnp.float32)
    return pts_s, rg, tg, vol_qz, dom, gacc


@pytest.mark.parametrize("B,G,n,prec", [(5, 8, 768, "highest"),
                                        (5, 8, 768, "bf16"),
                                        (26, 32, 512, "bf16")])
def test_inverse_bwd_plain_matches_pallas_vjp(B, G, n, prec):
    """Plain B4 vs the VJP of JAX `inverse_core_pg_s` on its own sorted
    domain and quad pair tables (interpret mode), dead groups included.
    highest: f32 summation order only -> 1e-5 of each gradient's scale
    (observed <= 5e-7). bf16: both round the same quantities, but a
    product such as gw * hz that the two sum in another f32 order can land
    on the other side of a bf16 rounding boundary and move that term by
    2^-9 of itself -> 5e-4 of the scale (observed <= 5e-5). Dead rows get
    dpts exactly 0."""
    pts_s, rg, tg, vol_qz, dom, gacc = _inverse_case(B, G, n, 0)
    _, vjp = jax.vjp(lambda p, r, t, v: plbs.inverse_core_pg_s(
        p, r, t, v, *dom.tables, prec), pts_s, rg, tg, vol_qz)
    ref = vjp(gacc)
    got = clbs.inverse_core_bwd_plain(_t(pts_s), _t(rg), _t(tg),
                                      _t(vol_qz), _t(gacc), prec)
    for name, a, b in zip(("dpts", "drg", "dtg", "dvol"), got, ref):
        assert np.abs(np.asarray(b)).max() > 0, name
        err, _ = _rel(a.numpy(), b)
        assert err <= (5e-4 if prec == "bf16" else 1e-5), (name, err)
    dead = int(dom.n_dead_groups) * plbs.SORT_GROUP
    assert dead >= 128 and not np.any(got[0].numpy()[:dead])


# ---------------------------------------------------------------------------
# B5: fused forward LBS, forward and backward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blend_case():
    B, G, n = 5, 8, 1100                 # three 512-row blocks
    rng = np.random.RandomState(1)
    pts = (rng.randn(n, 3) * 0.5).astype(np.float32)
    Rs = np.stack([np.eye(3) + 0.1 * rng.randn(3, 3) for _ in range(B)])
    Rf = np.stack([Rs, Rs[::-1]]).astype(np.float32)
    Tf = (0.2 * rng.randn(2, B, 3)).astype(np.float32)
    vol = np.asarray(jax.nn.softmax(
        jnp.asarray(rng.randn(B + 1, G, G, G), jnp.float32), axis=0))
    bmin = np.array([-1.3, -1.1, -1.2], np.float32)
    bscale = np.array([0.9, 1.0, 1.1], np.float32)
    gx = rng.randn(2, n, 3).astype(np.float32)
    gw = rng.randn(n, 1).astype(np.float32)
    return pts, Rf, Tf, vol, bmin, bscale, gx, gw


@pytest.mark.parametrize("k0", [0, 1])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_forward_lbs_multi_plain_matches_pallas(blend_case, prec, k0):
    """`forward_lbs_multi` on the plain B5 versions vs the JAX wrapper on
    `shared_blend_core` (interpret mode): values and the VJP in the world
    points, both transform sets and the volume, on rows >= k0 * 512 (the
    cotangent of the skipped rows is 0, as the model's masks make it).
    Values: the same rounding points, f32 order -> 1e-5 of the scale.
    Gradients: highest 1e-4 of the scale; bf16 1e-3, because a gradient
    that lands within an f32 ulp of a bf16 rounding boundary of
    gw = bf16(dw) flips it (2^-9 on one entry; observed 3e-4)."""
    pts, Rf, Tf, vol, bmin, bscale, gx, gw = blend_case
    first = k0 * 512
    gx, gw = gx.copy(), gw.copy()
    gx[:, :first] = 0.0
    gw[:first] = 0.0

    def jfn(p, r, t, v):
        return plbs.forward_lbs_multi(p, r, t, v, jnp.asarray(bmin),
                                      jnp.asarray(bscale), precision=prec,
                                      k0_blocks=k0)

    (xr, wr), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (pts, Rf, Tf,
                                                            vol)))
    ref = vjp((jnp.asarray(gx), jnp.asarray(gw)))
    args = [_t(a).requires_grad_() for a in (pts, Rf, Tf, vol)]
    x, w = clbs.forward_lbs_multi(*args, _t(bmin), _t(bscale),
                                  precision=prec, k0_blocks=k0)
    assert _rel(x.detach().numpy()[:, first:],
                np.asarray(xr)[:, first:])[0] <= 1e-5
    assert _rel(w.detach().numpy()[first:], np.asarray(wr)[first:])[0] \
        <= 1e-5
    torch.autograd.backward([x, w], [_t(gx), _t(gw)])
    tol = 1e-3 if prec == "bf16" else 1e-4
    for name, a, b in zip(("dpts", "dR", "dT", "dvol"), args, ref):
        err, _ = _rel(a.grad.numpy(), b)
        assert err <= tol, (name, err)
    assert not np.any(args[0].grad.numpy()[:first])


# ---------------------------------------------------------------------------
# B3: fused embed + trunk backward
# ---------------------------------------------------------------------------

def _flax_mlp(name, layers, out, cdt):
    """The flax module of a spec and its params from flax-oriented
    weights."""
    if name == "nonrigid":
        mod = jhc.NonRigidMLP(mlp_depth=6, mlp_width=32, compute_dtype=cdt)
    else:
        mod = jhc.CanonicalMLP(mlp_depth=8, mlp_width=32, compute_dtype=cdt)
    p = {f"linear_{i}": {"Dense_0": {"kernel": jnp.asarray(w),
                                     "bias": jnp.asarray(b)}}
         for i, (w, b) in enumerate(layers)}
    p["output"] = {"Dense_0": {"kernel": jnp.asarray(out[0]),
                               "bias": jnp.asarray(out[1])}}
    return mod, p


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("name", ["nonrigid", "canonical"])
def test_embed_trunk_bwd_plain_matches_flax_vjp(name, prec):
    """Plain B3 vs `jax.vjp` of the flax module behind the JAX package's
    embed (hannw or fourier PE, then the MLP), in x, aux and every weight.
    highest: both f32, op order only -> 1e-4 of each gradient's scale.
    bf16: flax runs its backward in bf16 (bf16 cotangents at every layer)
    where the kernel keeps g in f32 and rounds only gc, so the two differ
    by bf16 noise accumulated over 6-8 layers -> relative L2 <= 5e-2 on
    every gradient (observed <= 1.5e-2)."""
    x, aux, alpha, layers, out, kw = mlp_case(name, n=512)
    cdt = jnp.bfloat16 if prec == "bf16" else None
    mod, params = _flax_mlp(name, layers, out, cdt)
    rng = np.random.default_rng(9)
    gout = rng.normal(size=(512, 3 if name == "nonrigid" else 4)).astype(
        np.float32)

    def jfn(xx, aa, pp):
        if name == "nonrigid":
            emb = jemb.hannw_fourier_embed(xx, 6, alpha)
            return mod.apply({"params": pp}, emb, xx, aa)["offsets"]
        emb = jemb.fourier_embed(xx, 10)
        full = jnp.concatenate(
            [emb, jnp.broadcast_to(aa, (xx.shape[0], aa.shape[-1]))], -1)
        return mod.apply({"params": pp}, full).astype(jnp.float32)

    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(aux), params)
    dx_r, daux_r, dp_r = vjp(jnp.asarray(gout))
    tl, to = torch_args(layers, out)
    dx, daux, dl, (dwo, dbo) = cmlp.fused_embed_trunk_bwd(
        _t(x), _t(aux), alpha, tl, to, _t(gout), precision=prec, **kw)
    pairs = [(dx, dx_r), (daux, daux_r),
             (dwo.T, dp_r["output"]["Dense_0"]["kernel"]),
             (dbo, dp_r["output"]["Dense_0"]["bias"])]
    for i, (w, b) in enumerate(dl):
        d = dp_r[f"linear_{i}"]["Dense_0"]
        pairs += [(w.T, d["kernel"]), (b, d["bias"])]
    for k, (a, b) in enumerate(pairs):
        err, l2 = _rel(a.numpy(), np.asarray(b, np.float32))
        if prec == "highest":
            assert err <= 1e-4, (k, err)
        else:
            assert l2 <= 5e-2, (k, l2)


def test_embed_trunk_autograd_skips_dead_blocks():
    """The differentiable entry on CPU tensors: rows below k0 * 1024 get
    dx = 0 and add nothing to the weight gradients (their cotangent is
    zeroed by the model's masks), as on the card."""
    x, aux, alpha, layers, out, kw = mlp_case("nonrigid", n=2048)
    tl, to = torch_args(layers, out)
    tl = [(w.requires_grad_(), b) for w, b in tl]
    xt = _t(x).requires_grad_()
    y = cmlp.fused_embed_trunk(xt, _t(aux), alpha, tl, to, precision="bf16",
                               k0_blocks=1, **kw)
    g = torch.ones_like(y)
    g[:1024] = 0.0
    (y * g).sum().backward()
    assert not xt.grad[:1024].any() and xt.grad[1024:].abs().max() > 0
    dx, _, dl, _ = cmlp.fused_embed_trunk_bwd(
        _t(x)[1024:], _t(aux)[1024:], alpha, [(w.detach(), b) for w, b in tl],
        to, g[1024:], precision="bf16", **kw)
    np.testing.assert_allclose(xt.grad[1024:].numpy(), dx.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl[0][0].grad.numpy(), dl[0][0].numpy(),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole stage-2 loss and its gradients
# ---------------------------------------------------------------------------

S = 16
CFG = dict(n_patches=1, patch_size=16, n_samples=S, cnl_mlp_width=32,
           nr_mlp_width=32, mweight_volume_size=32, perturb=0.0)


@pytest.fixture(scope="module")
def loss_case():
    nb = synthetic.human_batch(1, 16, grid_size=32)
    nb["far"] = nb["far"] * 4.0          # a real dead prefix (>= 1 block)
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    jcfg = jstage2.Stage2Config(lbs_impl="gather", **CFG)
    params, _, jmodel, _ = jstage2.init_state(jcfg, jax.random.key(0), batch)
    loss_fn = jstage2.make_loss_fn(jcfg, jmodel)

    def scalar(p):
        total, losses = loss_fn(p, None, batch, ITER, jnp.int32(0), None)
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(
        scalar, has_aux=True))(params)
    ref_g = convert.human_params_to_numpy(jax.tree.map(np.asarray, grads))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in nb.items()}
    sd = convert.human_state_dict(jax.tree.map(np.asarray, params))
    ports = {}
    for impl in ("dense", "sorted"):
        lbs_impl, mlp_impl = (("gather", "flax") if impl == "dense"
                              else ("pallas", "fused"))
        tcfg = tstage2.Stage2Config(lbs_impl=lbs_impl, mlp_impl=mlp_impl,
                                    **CFG)
        model = tstage2.make_model(tcfg, device="cpu")
        model.load_state_dict(sd, strict=True)
        t_total, t_losses = tstage2.make_loss_fn(tcfg, model)(
            tbatch, ITER, torch.tensor(0))
        t_total.backward()
        ports[impl] = (float(t_total.detach()),
                       {k: float(v.detach()) for k, v in t_losses.items()},
                       {n: p.grad.numpy().copy() for n, p in
                        model.named_parameters() if p.grad is not None})
    return float(total), {k: float(v) for k, v in losses.items()}, ref_g, \
        ports


def test_stage2_loss_and_grads_dense_match_jax(loss_case):
    """Port dense (gather LBS, module MLPs, f32) vs JAX dense
    (lbs_impl='gather', mlp_impl='flax'): every loss term to 1e-5
    relative, and every gradient leaf that JAX gives a nonzero gradient
    (all 5 lr groups) to 1e-4 relative L2 and 1e-3 of its scale: the same
    f32 math in another op order, through 8 + 6 + 6 layers and the
    softmax volume decoder."""
    total, losses, ref_g, ports = loss_case
    t_total, t_losses, grads = ports["dense"]
    np.testing.assert_allclose(t_total, total, rtol=1e-5)
    for k in losses:
        np.testing.assert_allclose(t_losses[k], losses[k], rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    assert losses["flow"] > 0 and losses["cycle"] > 0
    nonzero = [k for k, v in ref_g.items() if np.abs(v).max() > 0]
    assert {tstage2.group_of(k) for k in nonzero} == set(tstage2.GROUPS)
    for k in nonzero:
        err, l2 = _rel(grads[k], ref_g[k])
        assert l2 <= 1e-4 and err <= 1e-3, (k, err, l2)


def test_stage2_sorted_matches_dense_up_to_bf16_lbs(loss_case):
    """Port sorted (liveness sort, plain kernel versions, f32 trunks) vs
    port dense: the sorted path samples both LBS volumes with bf16 taps
    (2^-9 relative on each tap weight), so the loss agrees to 1e-3
    relative and every gradient to cosine >= 0.999 and relative L2 <=
    5e-2 (observed <= 1.1e-2)."""
    _, _, _, ports = loss_case
    d_total, _, dg = ports["dense"]
    s_total, _, sg = ports["sorted"]
    np.testing.assert_allclose(s_total, d_total, rtol=1e-3)
    assert sorted(dg) == sorted(sg)
    for k in dg:
        a, b = sg[k].ravel(), dg[k].ravel()
        if np.abs(b).max() == 0:
            continue
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.999 and _rel(a, b)[1] <= 5e-2, (k, cos)


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 250_000])
def test_optimizer_matches_optax(start):
    """The port's Adam groups vs optax `make_optimizer` fed the same
    gradients for 3 updates from a given update count: the per-group
    exponential lr at the pre-increment count, Adam's moments and bias
    correction -> params to 1e-6 relative, or 3e-8 absolute for entries
    near 0: f32 arithmetic in another order, within an ulp of the largest
    parameters (|p| <= 0.2, ulp 1.5e-8)."""
    cfg = tstage2.Stage2Config(cnl_mlp_width=32, nr_mlp_width=32,
                               mweight_volume_size=4)
    model = tstage2.make_model(cfg, device="cpu")
    jcfg = jstage2.Stage2Config(cnl_mlp_width=32, nr_mlp_width=32,
                                mweight_volume_size=4)
    names = [n for n, _ in model.named_parameters()]
    # copies: jnp.asarray may alias the numpy view of a parameter, which
    # the torch optimizer then updates in place
    jparams = {n: jnp.array(p.detach().numpy(), copy=True)
               for n, p in model.named_parameters()}
    # optax labels by module path: nest the flat names one level so the
    # JAX labeller sees the module (state_embeds in the JAX tree)
    def nest(flat):
        out = {}
        for n, v in flat.items():
            mod = n.split(".")[0]
            mod = "state_embeds" if mod == "human_stateembeds" else mod
            out.setdefault(mod, {})[n] = v
        return out

    jopt = jstage2.make_optimizer(jcfg, nest(jparams))
    jstate = jopt.init(nest(jparams))

    @jax.jit
    def jstep(g, st, p):
        upd, st = jopt.update(g, st, p)
        return optax.apply_updates(p, upd), st

    jstate = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (jnp.full_like(leaf, start)
                            if getattr(path[-1], "name", "") == "count"
                            else leaf), jstate)
    opt = tstage2.make_optimizer(cfg, model)
    opt.updates = start
    rng = np.random.default_rng(11)
    jp = nest(jparams)
    for _ in range(3):
        g = {n: rng.normal(size=p.shape).astype(np.float32)
             for n, p in model.named_parameters()}
        jp, jstate = jstep(nest({n: jnp.asarray(v) for n, v in g.items()}),
                           jstate, jp)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
            if start and p not in opt.state:
                opt.state[p] = {"step": torch.tensor(float(start)),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": torch.zeros_like(p)}
        tstage2.set_learning_rates(opt, cfg, opt.updates)
        opt.step()
        opt.updates += 1
    flat = {}
    for mod in jp.values():
        flat.update(mod)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat[n]),
                                   rtol=1e-6, atol=3e-8, err_msg=n)
    assert len(names) == len(flat)
    assert tsched.exp_decay(250_000, 1.0) == pytest.approx(10 ** -0.5,
                                                           rel=1e-6)


POSE_KICK_IN = 2


def test_pose_kick_in_steps_match_jax():
    """Three stage-2 steps (iter 0, 1, 2) with pose_kick_in_iter = 2,
    port dense (gather LBS, module MLPs, f32) vs JAX dense from the same
    params. Each step every port parameter gets a gradient, exactly 0
    where JAX's is (the pose decoder's before the kick-in) and else within
    2e-2 relative L2 of JAX's (the decoder's from the kick-in on). That is
    looser than the dense loss test's 1e-4: this batch at iters 0-2 is
    more sensitive to f32 op order (at JAX's own params the worst leaf
    reaches 1e-3 at iter 2, and with the params of two Adam steps, equal
    to 1e-6, 1e-2 on a bias whose gradient nearly cancels). A hook then
    hands Adam the JAX step's gradients in place of the port's, so that the
    parameters after each step, the pose decoder's included, meet optax's
    at the tolerances of `test_optimizer_matches_optax`. (From its own
    gradients Adam's first step, about lr * g / |g|, moves entries with
    |g| near its eps by up to 1e-6; the hook holds the gradients
    themselves.) A parameter that gets
    no gradient, as the decoder's did when the port skipped it before the
    kick-in, has no hook call: Adam skips it and starts its bias
    correction late, and at iter 2 its parameters part from optax's."""
    from hosnerf_tpu.models.state import state_index as jstate_index
    nb = synthetic.human_batch(1, 16, grid_size=32)
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in nb.items()}
    jcfg = jstage2.Stage2Config(lbs_impl="gather", **CFG)
    params, jstate, jmodel, jopt = jstage2.init_state(
        jcfg, jax.random.key(0), batch)
    loss_fn = jstage2.make_loss_fn(
        jcfg, jmodel.clone(pose_kick_in_iter=POSE_KICK_IN))

    @jax.jit
    def jstep(p, st, it):
        grads = jax.grad(lambda q: loss_fn(
            q, None, batch, it, jstate_index(batch["time"], None),
            jax.random.key(1))[0])(p)
        upd, st = jopt.update(grads, st, p)
        return optax.apply_updates(p, upd), st, grads

    tcfg = tstage2.Stage2Config(lbs_impl="gather", mlp_impl="flax", **CFG)
    model = tstage2.make_model(tcfg, device="cpu")
    model.load_state_dict(convert.human_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    model.pose_kick_in_iter = POSE_KICK_IN
    opt = tstage2.make_optimizer(tcfg, model)
    tstep = tstage2.make_train_step(tcfg, model, opt)
    ref_g, hooked = {}, set()

    def take_jax_grad(name):
        def hook(p):
            ref, got = ref_g[name], p.grad.numpy()
            if np.any(ref):
                assert _rel(got, ref)[1] <= 2e-2, (name, _rel(got, ref))
            else:
                assert not np.any(got), name
            p.grad.copy_(torch.tensor(ref))
            hooked.add(name)
        return hook

    for name, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(take_jax_grad(name))
    for it in range(3):
        params, jstate, grads = jstep(params, jstate, it)
        ref_g.update(convert.human_params_to_numpy(
            jax.tree.map(np.asarray, grads)))
        hooked.clear()
        tstep(tbatch, it)
        ref = convert.human_params_to_numpy(jax.tree.map(np.asarray, params))
        got = model.state_dict()
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6,
                                       atol=3e-8, err_msg=f"iter {it} {k}")
        assert hooked == set(ref), (it, sorted(set(ref) - hooked))
        dec = [k for k in ref_g if k.startswith("pose_decoder")]
        assert dec and any(np.any(ref_g[k]) for k in dec) == (
            it >= POSE_KICK_IN), it


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def test_lpips_value_and_input_grad_match_jax():
    """Port LPIPS vs the flax LPIPS at 16 x 16 on the same weights: the
    port's fixed-seed backbone moved into the flax layout (OIHW -> HWIO)
    with non-uniform lin heads, and `convert.lpips_state_dict` bringing it
    back exactly. The value and its gradient in the prediction, f32
    convolutions on both sides (op order only) -> 1e-4 relative."""
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    tm = tlpips.LPIPS(seed=3, device="cpu")
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    jp = {"vgg": {}}
    for k, v in sd.items():
        if k.startswith("vgg."):
            _, name, leaf = k.split(".")
            jp["vgg"].setdefault(name, {})[
                "kernel" if leaf == "weight" else "bias"] = (
                    v.transpose(2, 3, 1, 0) if leaf == "weight" else v)
    for i in range(5):       # non-uniform heads, so a swap cannot pass
        jp[f"lin_{i}"] = rng.uniform(0.1, 1.0, sd[f"lin_{i}"].shape
                                     ).astype(np.float32)
    back = convert.lpips_state_dict(jp)
    assert sorted(back) == sorted(sd)
    for k in sd:
        if not k.startswith("lin_"):
            np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    tm.load_state_dict(back, strict=True)
    jm = jlpips.LPIPS()

    @jax.jit
    def jfn(p, a, b):
        ref, vjp = jax.vjp(lambda aa: jm.apply({"params": p}, aa, b), a)
        return ref, vjp(jnp.ones_like(ref))[0]

    ref, gref = jfn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                    jnp.asarray(y))
    xt = _t(x).requires_grad_()
    val = tm(xt, _t(y))
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(ref),
                               rtol=1e-4)
    assert _rel(xt.grad.numpy(), gref)[0] <= 1e-4
    with pytest.raises(ValueError, match="16x16"):
        tm(_t(x[:, :8, :8]), _t(y[:, :8, :8]))
