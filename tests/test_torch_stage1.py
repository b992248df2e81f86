"""The port's stage-1 trainer against the JAX package's on the CPU: the
warm-up schedule, the loss and every gradient leaf on a batch of the
port's pipeline, the clipped Adam against optax, and the eval step.

The scene runs at `configs/mini.gin`'s sizes (NeRF MLP 64 wide, proposal
MLP 32, 16 proposal and 8 NeRF samples), read by the port's ginlite, on
64 rays that the port's `ScenePipeline` draws from all train images of
the port's mini capture (per-ray states across its one transition). No
sample jitter on either side. The weights are the port's, built from a
seed and moved into the JAX tree by `scene_params_from_port`; JAX's one
loss-gradient compile (and its forward for the eval step) and the optax
updates run in background threads started with the module.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hosnerf_tpu.models.state import state_index as jstate_index
from hosnerf_tpu.train import schedules as jschedules
from hosnerf_tpu.train import stage1 as jstage1
from hosnerf_tpu_torch import convert
from hosnerf_tpu_torch.config import ginlite
from hosnerf_tpu_torch.data import (batches, scene_loader, scene_pipeline,
                                    synthetic)
from hosnerf_tpu_torch.train import schedules, stage1
from test_torch_scene import _rel, assert_round_trip, scene_params_from_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 50            # train_frac 0.25 of mini.gin's 200 steps: annealing on
RAYS = 64


def mini_config(**kw) -> dict:
    """Stage1Config fields from configs/mini.gin."""
    gin = ginlite.parse_config_files_and_bindings(
        [os.path.join(REPO, "configs", "mini.gin")], warn_unknown=False)
    return dict(max_steps=gin["run.max_steps"],
                grad_max_norm=gin["run.grad_max_norm"],
                near=gin["LitDataNeRF360V2.near"],
                far=gin["LitDataNeRF360V2.far"],
                nerf_netwidth=gin["NeRFMLP.netwidth"],
                prop_netwidth=gin["PropMLP.netwidth"],
                num_prop_samples=gin["MipNeRF360.num_prop_samples"],
                num_nerf_samples=gin["MipNeRF360.num_nerf_samples"], **kw)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _jax_refs(jcfg, jmodel, params, batch, eval_batch, trans):
    """JAX's stage-1 loss, aux and gradients on `batch` at STEP (no rng:
    no jitter), and its eval step's rgb on `eval_batch`, in one compile."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    eb = {k: jnp.asarray(v) for k, v in eval_batch.items()}
    eval_step = jstage1.make_eval_step(jcfg, jmodel, trans)

    @jax.jit
    def run(p):
        train_frac = jnp.clip(STEP / jcfg.max_steps, 0.0, 1.0)
        s_idx = jstate_index(jb["times"], jnp.asarray(trans, jnp.float32))

        def loss_fn(q):
            rend, hist = jmodel.apply({"params": q}, jb, train_frac, True,
                                      s_idx, jcfg.near, jcfg.far, rng=None)
            return jstage1.compute_losses(jcfg, rend, hist, jb["target"])

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return loss, aux, grads, eval_step(p, eb)

    return jax.tree.map(np.asarray, run(params))


@pytest.fixture(scope="module", autouse=True)
def case(_threads, tmp_path_factory):
    """The mini capture (port writer and loader), one pipeline batch and
    one eval chunk, the port's model at mini.gin's sizes and JAX's with
    its weights; JAX's references compiling in the background."""
    root = str(tmp_path_factory.mktemp("stage1"))
    synthetic.write_mini_dataset(os.path.join(root, "cap"), 8, 32)
    scene = scene_loader.load_nerf_360_v2(root, "cap",
                                          write_scaleworld=False)
    trans = np.array([0.5], np.float32)
    pipe = scene_pipeline.ScenePipeline(scene, RAYS, seed=0,
                                        batch_sampler="all_images")
    batch = pipe.sample_train_batch()
    assert len(set(batch["times"].tolist())) > 2
    eval_batch = next(pipe.eval_image_batches(int(scene.i_split[2][0]),
                                              RAYS))
    eval_batch.pop("n_valid")
    fields = mini_config(num_states=len(trans) + 1)
    cfg = stage1.Stage1Config(**fields)
    jcfg = jstage1.Stage1Config(**fields)
    model = stage1.make_model(cfg, device="cpu")
    jmodel = jstage1.make_model(jcfg)
    params = scene_params_from_port(model)
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_jax_refs, jcfg, jmodel, params, batch,
                          eval_batch, trans)
        assert_round_trip(params, convert.scene_params_to_numpy, model)
        yield dict(cfg=cfg, jcfg=jcfg, model=model, params=params,
                   batch=batch, eval_batch=eval_batch, trans=trans, ref=ref)


STEPS = [0, 1, 511, 512, 513, "max", "2max"]


@pytest.mark.parametrize("delay", [512, 0])
@pytest.mark.parametrize("step", STEPS)
def test_warmup_log_lerp_matches_jax(step, delay):
    """The schedule in float32 at the warm-up's ends, max_steps and beyond
    (where it holds lr_final), with and without warm-up: 1e-6 relative
    (XLA's and numpy's float32 exp and sin differ by an ulp)."""
    max_steps = 20_000
    s = {"max": max_steps, "2max": 2 * max_steps}.get(step, step)
    got = schedules.warmup_log_lerp(s, max_steps, 2e-3, 2e-5, delay, 0.01)
    ref = float(jschedules.warmup_log_lerp(s, max_steps, 2e-3, 2e-5, delay,
                                           0.01))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_stage1_loss_and_grads_match_jax(case):
    """The stage-1 loss and its mse and psnr to 1e-5 relative, every
    gradient leaf to 1e-4 relative L2 (f32 through the NeRF MLP and the
    proposal MLPs in another op order), with per-ray states and the
    proposal annealing at train_frac 0.25."""
    model = case["model"]
    loss, aux, grads, _ = case["ref"].result()
    model.zero_grad(set_to_none=True)
    tb = batches.to_device(case["batch"], "cpu")
    got, got_aux = stage1.make_loss_fn(case["cfg"], model, case["trans"])(
        tb, STEP)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    for k in ("mse", "psnr"):
        np.testing.assert_allclose(float(got_aux[k].detach()), float(aux[k]),
                                   rtol=1e-5, err_msg=k)
    ref_g = convert.scene_params_to_numpy(grads)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        if not np.abs(ref_g[name]).any():
            assert not p.grad.abs().any(), name
            continue
        assert _rel(p.grad.numpy(), ref_g[name])[1] <= 1e-4, (
            name, _rel(p.grad.numpy(), ref_g[name]))


def test_stage1_eval_step_matches_jax(case):
    """make_eval_step on one eval chunk (the state of its first ray, no
    jitter, train_frac 1.0): rgb within 1e-4 of its scale."""
    *_, ref_rgb = case["ref"].result()
    rgb = stage1.make_eval_step(case["cfg"], case["model"], case["trans"])(
        batches.to_device(case["eval_batch"], "cpu"))
    assert not rgb.requires_grad and rgb.shape == ref_rgb.shape
    err = np.abs(rgb.numpy() - ref_rgb).max() / np.abs(ref_rgb).max()
    assert err <= 1e-4, err


CLIP_CASES = {"clipped": (1e-3, 20.0), "below_the_norm": (1e-3, 0.5),
              "no_clip": (0.0, 20.0)}


def _grads(model, norm, seed):
    """{name: gradient} of the model's shapes with global norm `norm`
    (entries ~1e-7 at 1e-3: the scale where Adam's eps still counts)."""
    rng = np.random.default_rng(seed)
    g = {n: rng.normal(size=p.shape).astype(np.float32)
         for n, p in model.named_parameters()}
    total = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                        for v in g.values()))
    return {n: (v * (norm / total)).astype(np.float32) for n, v in g.items()}


def _optax_steps(jcfg, params, grads_list):
    opt = jstage1.make_optimizer(jcfg)
    state = opt.init(params)
    upd_fn = jax.jit(opt.update)
    for grads in grads_list:
        upd, state = upd_fn(grads, state, params)
        params = optax.apply_updates(params, upd)
    return convert.scene_params_to_numpy(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def optax_refs(case):
    """For each clip case: three sets of gradients (as port arrays), and
    the parameters after optax's three updates of `make_optimizer`."""
    model = case["model"]
    out = {}
    with ThreadPoolExecutor(3) as pool:
        for name, (max_norm, factor) in CLIP_CASES.items():
            jcfg = dataclasses.replace(case["jcfg"], grad_max_norm=max_norm)
            gl = [_grads(model, factor * 1e-3 * (1 + 0.3 * i), i)
                  for i in range(3)]
            holder = stage1.make_model(case["cfg"], device="cpu")
            trees = []
            for g in gl:
                holder.load_state_dict({k: torch.from_numpy(v)
                                        for k, v in g.items()})
                trees.append(scene_params_from_port(holder))
            out[name] = (gl, pool.submit(_optax_steps, jcfg,
                                         case["params"], trees))
        yield {k: (gl, f.result()) for k, (gl, f) in out.items()}


@pytest.mark.parametrize("name", sorted(CLIP_CASES))
def test_stage1_optimizer_matches_optax(case, optax_refs, name):
    """Three updates of `apply_updates` (clip_by_global_norm, then Adam at
    warmup_log_lerp of the pre-increment count) on given gradients against
    optax's chain: with the global norm above grad_max_norm (clipped),
    below it, and with the clip off (grad_max_norm 0). Every parameter to
    1e-6 relative (1e-9 absolute near zero)."""
    max_norm, _ = CLIP_CASES[name]
    cfg = dataclasses.replace(case["cfg"], grad_max_norm=max_norm)
    model = stage1.make_model(cfg, device="cpu")
    model.load_state_dict(case["model"].state_dict())
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt = stage1.make_optimizer(cfg, model)
    grads_list, ref = optax_refs[name]
    for g in grads_list:
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        stage1.apply_updates(cfg, model, opt)
    assert opt.updates == 3
    moved = 0
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
        moved += int(not torch.equal(v, sd0[k]))
    assert moved == len(sd0)


def test_clip_by_global_norm_is_optax_exactly():
    """The clip alone: (t / norm) * max_norm where the norm reaches
    max_norm, unchanged below it (no epsilon), bit for bit against
    optax's transform on the same float32 leaves."""
    rng = np.random.default_rng(0)
    leaves = [rng.normal(scale=1e-6, size=s).astype(np.float32)
              for s in ((7, 3), (5,), (2, 4, 4))]
    norm = float(np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                             for x in leaves)))
    for max_norm in (norm / 3, norm * 3):
        got = [torch.from_numpy(x.copy()) for x in leaves]
        stage1.clip_by_global_norm(got, max_norm)
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(x) for x in leaves], None)
        for g, r, x in zip(got, ref, leaves):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
            if max_norm > norm:
                np.testing.assert_array_equal(g.numpy(), x)


def test_stage1_jittered_step_is_reproducible(case):
    """With a generator the step jitters its samples: two models from one
    seed take equal steps from equal generator seeds, and another seed
    gives another loss; every loss finite."""
    cfg = case["cfg"]
    tb = batches.to_device(case["batch"], "cpu")
    out = []
    for seed in (3, 3, 4):
        model, opt = stage1.init_state(cfg, seed=0, device="cpu")
        step = stage1.make_train_step(cfg, model, opt, case["trans"])
        aux = step(tb, STEP, torch.Generator().manual_seed(seed))
        out.append((float(aux["loss"]), model.state_dict()))
    assert np.isfinite([o[0] for o in out]).all()
    assert out[0][0] == out[1][0] and out[0][0] != out[2][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def test_stage1_models_default_to_the_card(case):
    """init_state builds on the card unless asked for the CPU; with no
    card it raises instead of falling back."""
    if torch.cuda.is_available():
        model, _ = stage1.init_state(case["cfg"])
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage1.init_state(case["cfg"])
