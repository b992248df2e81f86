"""The one-hot ('xla') LBS forms of the port's `ops/lbs.py` against the JAX
package's (`hosnerf_tpu/ops/lbs.py`) at G = 8 and 8 of the skeleton's 26
bones (the bone loops are unrolled; JAX's compile time grows with them):
values, and the
gradients of a fixed random cotangent with respect to the points, the
bone transforms and the weight volume. Tolerance: the largest error of
each output and gradient at most 1e-5 of its largest value (f32, the two
sides differ in op order only; the blends divide by the weight sum,
which amplifies the rounding of both sides alike where it is small).
Also: the one-hot forms equal the gather forms on the port's side, and
`inverse_warp`, `bone_weights`, `forward_warp_multi` take impl='xla'."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hosnerf_tpu.core import body as jbody
from hosnerf_tpu.ops import lbs as jlbs
from hosnerf_tpu_torch.ops import lbs as tlbs

TOL = 1e-5   # max abs error over the largest reference value
G, B, N = 8, 8, 300


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    tpose = np.cumsum(rng.normal(scale=0.08, size=(26, 3)), 0).astype(
        np.float32)
    angles = rng.normal(scale=0.3, size=(26, 3)).astype(np.float32)
    lo, hi = tpose[:B].min(0) - 0.3, tpose[:B].max(0) + 0.3
    vol = np.asarray(jbody.approx_gaussian_bone_volumes(tpose, lo, hi, G))
    vol = np.concatenate([vol[:B], vol[-1:]])    # B bones + background
    Rs, Ts = jbody.body_pose_to_body_RTs(angles, tpose)
    m_sR, m_T, m_sR_fwd, m_T_fwd = (np.asarray(a)[:B] for a in
                                    jbody.motion_bases(
        Rs, Ts, jbody.get_canonical_global_tfms(tpose)))
    # points partly outside the volume: the zeros padding is exercised
    pts = rng.uniform(lo - 0.1, hi + 0.1, (N, 3)).astype(np.float32)
    return dict(pts=pts, m_sR=m_sR, m_T=m_T, vol=vol,
                fwd_R=np.stack([m_sR_fwd, m_sR_fwd[::-1]]),
                fwd_T=np.stack([m_T_fwd, -m_T_fwd]),
                lo=lo.astype(np.float32),
                scale=(2.0 / (hi - lo)).astype(np.float32), rng=rng)


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.max(np.abs(got - ref)))
    scale = float(np.max(np.abs(ref)))
    assert err <= TOL * scale, (what, err, scale)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float32), requires_grad=grad)


def _compare(jfn, tfn, args, n_out, rng, diff_args):
    """Values of jfn(*args) and tfn(*args), then the vjp of a random
    cotangent with respect to args[i] for i in diff_args."""
    jfn_jit = jax.jit(jfn)
    jouts = jfn_jit(*args)
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    targs = [_t(a, i in diff_args) for i, a in enumerate(args)]
    touts = tfn(*targs)
    touts = touts if isinstance(touts, tuple) else (touts,)
    for k, (j, t) in enumerate(zip(jouts[:n_out], touts[:n_out])):
        _close(t.detach().numpy(), j, f"output {k}")
    cots = [rng.normal(size=np.shape(j)).astype(np.float32)
            for j in jouts[:n_out]]

    def f(*d):
        full = list(args)
        for i, v in zip(diff_args, d):
            full[i] = v
        out = jfn(*full)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(out[:n_out], cots))

    jgrads = jax.jit(jax.grad(f, argnums=tuple(range(len(diff_args)))))(
        *[jnp.asarray(args[i]) for i in diff_args])
    loss = sum(torch.sum(o * torch.from_numpy(c))
               for o, c in zip(touts[:n_out], cots))
    tgrads = torch.autograd.grad(loss, [targs[i] for i in diff_args])
    for i, jg, tg in zip(diff_args, jgrads, tgrads):
        _close(tg.numpy(), jg, f"gradient {i}")
    return touts


def test_inverse_lbs_onehot_matches_jax(case):
    c = case
    args = (c["pts"], c["m_sR"], c["m_T"], c["vol"], c["lo"], c["scale"])
    _compare(jlbs.inverse_lbs, tlbs.inverse_lbs, args, 3, c["rng"],
             (0, 1, 2, 3))


@pytest.mark.parametrize("fwd", ["forward_lbs", "forward_lbs_gather"])
def test_forward_lbs_matches_jax(case, fwd):
    c = case
    args = (c["pts"], c["fwd_R"][0], c["fwd_T"][0], c["vol"], c["lo"],
            c["scale"])
    _compare(getattr(jlbs, fwd), getattr(tlbs, fwd), args, 2, c["rng"],
             (0, 1, 2, 3))


def test_dispatch_takes_xla_and_matches_jax(case):
    c = case
    geo = (c["vol"], c["lo"], c["scale"])

    def j_inv(*a):
        return jlbs.inverse_warp(*a, impl="xla")

    def t_inv(*a):
        return tlbs.inverse_warp(*a, impl="xla")

    _compare(j_inv, t_inv, (c["pts"], c["m_sR"], c["m_T"]) + geo, 2,
             c["rng"], (0, 1, 3))

    def j_bw(*a):
        return jlbs.bone_weights(*a, impl="xla")

    def t_bw(*a):
        return tlbs.bone_weights(*a, impl="xla")

    _compare(j_bw, t_bw, (c["pts"],) + geo, 1, c["rng"], (0, 1))

    def j_fw(*a):
        return jlbs.forward_warp_multi(*a, impl="xla")

    def t_fw(*a):
        return tlbs.forward_warp_multi(*a, impl="xla")

    _compare(j_fw, t_fw, (c["pts"], c["fwd_R"], c["fwd_T"]) + geo, 2,
             c["rng"], (0, 1, 2, 3))


def test_apply_forward_lbs_matches_jax(case):
    c = case
    w = np.asarray(jlbs.bone_weights(c["pts"], c["vol"], c["lo"], c["scale"],
                                     impl="gather"))
    _compare(jlbs.apply_forward_lbs, tlbs.apply_forward_lbs,
             (w, c["pts"], c["fwd_R"][1], c["fwd_T"][1]), 2, c["rng"],
             (0, 1, 2, 3))


def test_onehot_equals_gather_and_rematerialises(case):
    """The port's one-hot and gather forms agree; the one-hot weights are
    recomputed in the backward (checkpointed), the gradients equal the
    gather form's."""
    c = case
    args = [_t(a, True) for a in (c["pts"], c["m_sR"], c["m_T"], c["vol"])]
    geo = (_t(c["lo"]), _t(c["scale"]))
    x1, f1, w1 = tlbs.inverse_lbs(*args, *geo)
    x2, f2, w2 = tlbs.inverse_lbs_gather(*args, *geo)
    for a, b in ((x1, x2), (f1, f2), (w1, w2)):
        _close(a.detach().numpy(), b.detach().numpy())
    g1 = torch.autograd.grad(x1.sum() + f1.sum(), args)
    g2 = torch.autograd.grad(x2.sum() + f2.sum(), args)
    for a, b in zip(g1, g2):
        _close(a.numpy(), b.numpy())


def test_onehot_needs_square_slices():
    vol = torch.zeros(3, 4, 4, 2)
    with pytest.raises(ValueError, match="square"):
        tlbs.inverse_lbs(torch.zeros(5, 3), torch.eye(3).expand(2, 3, 3),
                         torch.zeros(2, 3), vol, torch.zeros(3),
                         torch.ones(3))
    # bone_weights falls back to the gather form there, as JAX's does
    w = tlbs.bone_weights(torch.zeros(5, 3), vol, torch.zeros(3),
                          torch.ones(3), impl="xla")
    assert w.shape == (5, 2)
