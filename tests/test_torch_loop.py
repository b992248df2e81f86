"""The port's training loop and checkpoints (`hosnerf_tpu_torch/train/
loop.py`, `train/checkpoints.py`) on the CPU, modelled on
tests/test_loop_resume.py and the checkpoint tests of
tests/test_config_eval_ckpt.py.

Resume is held bit for bit: a run saved after k steps and resumed into
freshly built models (other seeds) ends with the same parameters, Adam
moments, step counts and generator state as the uninterrupted run, for
the stage-1 and the stage-2 step. Lightning `.ckpt` files cross between
the packages key for key: the JAX exporters' files load into the port's
models with strict=True, and the port's files into JAX's importers.
"""

import os

import numpy as np
import pytest
import torch

from hosnerf_tpu.train import checkpoints as jck
from hosnerf_tpu_torch import convert
from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.data.batches import to_device
from hosnerf_tpu_torch.train import checkpoints as ck
from hosnerf_tpu_torch.train import loop, stage1, stage2

from test_torch_scene import scene_params_from_port
from test_torch_stage3 import human_params_from_port

torch.set_num_threads(1)

TINY_SCENE = dict(nerf_netwidth=32, prop_netwidth=16, num_prop_samples=8,
                  num_nerf_samples=4, num_states=2, max_steps=100,
                  near=0.5, far=6.0)
TINY_HUMAN = dict(n_samples=8, cnl_mlp_width=32, nr_mlp_width=16,
                  mweight_volume_size=8, n_patches=1, patch_size=8,
                  num_states=2)


class Counter(torch.nn.Module):
    def __init__(self):
        super().__init__()
        # the step count and the sum of the step indices
        self.p = torch.nn.Parameter(torch.zeros(()), requires_grad=False)
        self.o = torch.nn.Parameter(torch.zeros(()), requires_grad=False)


def _counting_step(model):
    def step_fn(batch, step, gen):
        with torch.no_grad():
            model.p += 1.0
            model.o += step
            torch.rand((), generator=gen)     # one draw per step
        return {"loss": torch.tensor(1.0)}
    return step_fn


def test_loop_saves_full_state_and_resumes(tmp_path):
    logdir = str(tmp_path)
    model = Counter()
    gen = loop.run_training(
        num_steps=5, sample_batch=dict, step_fn=_counting_step(model),
        models={"m": model}, optimizer=None, logdir=logdir,
        checkpoint_every=2, log_every=100, prefetch=0)
    assert float(model.p) == 5.0

    fresh, g = Counter(), torch.Generator().manual_seed(123)
    s = ck.restore_train_state(os.path.join(logdir, "ckpt"), "last",
                               {"m": fresh}, None, g)
    assert s == 5 and float(fresh.p) == 5.0
    assert float(fresh.o) == 10.0          # 0 + 1 + 2 + 3 + 4
    assert torch.equal(g.get_state(), gen.get_state())

    # resume: steps 5..7 run, 0..4 are not repeated
    loop.run_training(
        num_steps=8, start_step=s, sample_batch=dict,
        step_fn=_counting_step(fresh), models={"m": fresh}, optimizer=None,
        logdir=logdir, checkpoint_every=0, log_every=100, generator=g,
        prefetch=0)
    assert float(fresh.p) == 8.0
    assert float(fresh.o) == 10.0 + 5 + 6 + 7
    # metrics.jsonl and the event file were written
    assert os.path.getsize(os.path.join(logdir, "metrics.jsonl")) > 0
    assert any(f.startswith("events.out.tfevents.")
               for f in os.listdir(logdir))


def test_checkpoint_every_saves_the_next_step(tmp_path):
    """save_last every checkpoint_every steps (and at the end) holds
    step + 1 (the next step to run) and the models as that step left
    them."""
    model = Counter()
    seen = []
    orig = ck.BestLastCheckpointer.save_last

    def spy(self, state):
        seen.append((state["step"], float(state["models"]["m"]["p"])))
        return orig(self, state)

    ck.BestLastCheckpointer.save_last = spy
    try:
        loop.run_training(
            num_steps=7, sample_batch=dict, step_fn=_counting_step(model),
            models={"m": model}, optimizer=None, logdir=str(tmp_path),
            checkpoint_every=3, log_every=100, prefetch=0)
    finally:
        ck.BestLastCheckpointer.save_last = orig
    assert seen == [(4, 4.0), (7, 7.0), (7, 7.0)]


def test_progress_fn_schedule_and_empty_trap(tmp_path):
    calls = []

    def progress_fn(step):
        calls.append(step)
        return {"psnr": 10.0, "is_empty_img": step >= 100}

    model = Counter()
    with pytest.raises(loop.EmptyRenderError):
        loop.run_training(
            num_steps=101, sample_batch=dict, step_fn=_counting_step(model),
            models={"m": model}, optimizer=None, logdir=str(tmp_path),
            checkpoint_every=0, log_every=1000, prefetch=0,
            progress_fn=progress_fn, progress_every=40)
    # every progress_every multiple and the reference's step 100, where
    # the empty trap raises
    assert calls == [40, 80, 100]


def test_progress_empty_warns_without_abort(tmp_path, capsys):
    model = Counter()
    loop.run_training(
        num_steps=301, sample_batch=dict, step_fn=_counting_step(model),
        models={"m": model}, optimizer=None, logdir=str(tmp_path),
        checkpoint_every=0, log_every=1000, prefetch=0,
        progress_fn=lambda step: {"is_empty_img": True},
        abort_on_empty=False)
    assert capsys.readouterr().out.count("WARNING: progress render") == 2


def test_val_fn_keeps_the_best(tmp_path):
    """val_fn every val_every steps; 'best' saved only when it improves,
    its value persisted in best_value.json."""
    model = Counter()
    vals = iter([3.0, 5.0, 4.0])
    loop.run_training(
        num_steps=7, sample_batch=dict, step_fn=_counting_step(model),
        models={"m": model}, optimizer=None, logdir=str(tmp_path),
        checkpoint_every=0, log_every=100, prefetch=0,
        val_fn=lambda step: next(vals), val_every=2)
    best = ck.restore_checkpoint(os.path.join(str(tmp_path), "ckpt"), "best")
    assert best["step"] == 5 and float(best["models"]["m"]["p"]) == 5.0
    assert ck.BestLastCheckpointer(
        os.path.join(str(tmp_path), "ckpt")).best_value == 5.0


def test_non_finite_loss_halts(tmp_path):
    model = Counter()
    with pytest.raises(FloatingPointError, match="step 0"):
        loop.run_training(
            num_steps=2, sample_batch=dict,
            step_fn=lambda b, s, g: {"loss": torch.tensor(float("nan"))},
            models={"m": model}, optimizer=None, logdir=str(tmp_path),
            prefetch=0)


def test_prefetcher_overlaps_and_propagates_errors():
    seen = []

    def sample():
        seen.append(len(seen))
        if len(seen) > 3:
            raise ValueError("boom")
        return {"i": len(seen)}

    f = loop.BatchPrefetcher(sample, depth=1)
    assert f.get()["i"] == 1
    assert f.get()["i"] == 2
    assert f.get()["i"] == 3
    with pytest.raises(ValueError, match="boom"):
        f.get()
    f.close()
    assert not f._t.is_alive()


def test_loop_raises_a_worker_error(tmp_path):
    def sample():
        raise OSError("capture missing")

    model = Counter()
    with pytest.raises(OSError, match="capture missing"):
        loop.run_training(
            num_steps=3, sample_batch=sample, step_fn=_counting_step(model),
            models={"m": model}, optimizer=None, logdir=str(tmp_path),
            prefetch=2)


# ---------------------------------------------------------------------------
# bit-exact resume of the real steps
# ---------------------------------------------------------------------------

def _stage1(seed):
    cfg = stage1.Stage1Config(**TINY_SCENE)
    model, opt = stage1.init_state(cfg, seed=seed, device="cpu")
    return {"scene": model}, opt, stage1.make_train_step(cfg, model, opt,
                                                         [0.5])


def _stage2(seed):
    cfg = stage2.Stage2Config(**TINY_HUMAN)
    model, opt = stage2.init_state(cfg, seed=seed, device="cpu")
    return {"human": model}, opt, stage2.make_train_step(cfg, model, opt,
                                                         [0.5])


BATCHES = {
    "stage1": lambda: to_device(synthetic.scene_ray_batch(32, time=0.7),
                                "cpu"),
    "stage2": lambda: to_device(synthetic.human_batch(1, 8, time=0.7,
                                                      grid_size=8), "cpu"),
}
BUILD = {"stage1": _stage1, "stage2": _stage2}


def _assert_same_state(a, b):
    """Two pack_train_state dicts equal bit for bit."""
    assert a["step"] == b["step"] and a["updates"] == b["updates"]
    assert torch.equal(a["generator"], b["generator"])
    for name in a["models"]:
        for k, v in a["models"][name].items():
            assert torch.equal(v, b["models"][name][k]), (name, k)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]


@pytest.mark.parametrize("stage,cut,total", [("stage1", 2, 4),
                                              ("stage2", 1, 3)])
def test_resume_is_bit_exact(tmp_path, stage, cut, total):
    """`total` straight steps == `cut` steps, checkpoint, restore into
    models built from another seed, the rest: parameters, Adam state
    (moments and per-parameter step counts), opt.updates and the loop
    generator, bit for bit (stage 2 takes fewer steps: on the CPU each
    takes seconds, Adam over the weight-volume decoder's weights)."""
    batch = BATCHES[stage]()
    straight = str(tmp_path / "straight")
    models, opt, step = BUILD[stage](0)
    gen = loop.run_training(
        num_steps=total, sample_batch=lambda: batch, step_fn=step,
        models=models, optimizer=opt, logdir=straight, checkpoint_every=0,
        generator=torch.Generator().manual_seed(5), prefetch=2)
    want = ck.pack_train_state(models, opt, total, gen)

    cut_dir = str(tmp_path / "cut")
    models, opt, step = BUILD[stage](0)
    loop.run_training(
        num_steps=cut, sample_batch=lambda: batch, step_fn=step,
        models=models, optimizer=opt, logdir=cut_dir, checkpoint_every=0,
        generator=torch.Generator().manual_seed(5), prefetch=0)
    models, opt, step = BUILD[stage](1)
    gen = torch.Generator().manual_seed(99)
    start = ck.restore_train_state(os.path.join(cut_dir, "ckpt"), "last",
                                   models, opt, gen)
    assert start == cut and opt.updates == cut
    saved = ck.restore_checkpoint(os.path.join(cut_dir, "ckpt"), "last")
    _assert_same_state(ck.pack_train_state(models, opt, cut, gen), saved)
    gen = loop.run_training(
        num_steps=total, start_step=start, sample_batch=lambda: batch,
        step_fn=step, models=models, optimizer=opt, logdir=cut_dir,
        checkpoint_every=0, generator=gen, prefetch=0)
    _assert_same_state(ck.pack_train_state(models, opt, total, gen), want)


# ---------------------------------------------------------------------------
# checkpoints: best/last and the Lightning .ckpt crossing
# ---------------------------------------------------------------------------

def test_best_last_roundtrip(tmp_path):
    model = Counter()
    with torch.no_grad():
        model.p += 7.0
    state = ck.pack_train_state({"m": model}, None, 7)
    c = ck.BestLastCheckpointer(str(tmp_path))
    assert c.save_last(state) == os.path.join(str(tmp_path), "last.pt")
    assert c.maybe_save_best(state, 20.0) is not None
    assert c.maybe_save_best(state, 10.0) is None   # worse: not saved
    assert ck.BestLastCheckpointer(str(tmp_path)).best_value == 20.0
    for name in ("last", "best"):
        got = ck.restore_checkpoint(str(tmp_path), name)
        assert got["step"] == 7 and float(got["models"]["m"]["p"]) == 7.0


@pytest.fixture(scope="module")
def tiny_models():
    """A tiny port scene and human field, and the JAX param trees that
    hold their weights."""
    scene = stage1.make_model(stage1.Stage1Config(**TINY_SCENE), seed=3,
                              device="cpu")
    human = stage2.make_model(stage2.Stage2Config(**TINY_HUMAN), seed=4,
                              device="cpu")
    return {"scene": (scene, scene_params_from_port(scene)),
            "human": (human, human_params_from_port(human))}


EXPORT = {"scene": (jck.export_scene_params, ck.import_scene_params,
                    convert.scene_state_dict, stage1.make_model,
                    stage1.Stage1Config, TINY_SCENE),
          "human": (jck.export_human_params, ck.import_human_params,
                    convert.human_state_dict, stage2.make_model,
                    stage2.Stage2Config, TINY_HUMAN)}


@pytest.mark.parametrize("which", ["scene", "human"])
def test_jax_ckpt_loads_into_the_port(tmp_path, tiny_models, which):
    """JAX export + save_torch_ckpt -> the port's import ->
    load_state_dict(strict=True) equals convert's state_dict of the same
    JAX params, key for key; load_stage_params reads the file too."""
    jexport, imp, to_sd, make, Cfg, sizes = EXPORT[which]
    _, jparams = tiny_models[which]
    path = str(tmp_path / f"{which}.ckpt")
    jck.save_torch_ckpt(path, jexport(jparams))
    fresh = make(Cfg(**sizes), seed=11, device="cpu")
    fresh.load_state_dict(imp(path), strict=True)
    want = to_sd(jparams)
    got = fresh.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert ck.load_stage_params(path, which).keys() == want.keys()


@pytest.mark.parametrize("which", ["scene", "human"])
def test_port_ckpt_loads_into_jax(tmp_path, tiny_models, which):
    """The port's export + save_torch_ckpt -> JAX's importer and
    overlay_params give the JAX tree of the same weights, leaf for leaf."""
    model, jparams = tiny_models[which]
    path = str(tmp_path / f"{which}.ckpt")
    export = (ck.export_scene_params if which == "scene"
              else ck.export_human_params)
    ck.save_torch_ckpt(path, export(model))
    imported = (jck.import_scene_params(path) if which == "scene"
                else jck.import_human_params(path))
    zeros = _map(lambda a: np.zeros_like(np.asarray(a)), jparams)
    merged = jck.overlay_params(zeros, imported)
    for got, want in zip(_leaves(merged), _leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _map(fn, tree):
    return ({k: _map(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_overlay_keeps_missing_and_checks_shapes(tiny_models):
    model, _ = tiny_models["human"]
    fresh = stage2.make_model(stage2.Stage2Config(**TINY_HUMAN), seed=9,
                              device="cpu")
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    part = {k: v for k, v in model.state_dict().items()
            if k.startswith("cnl_mlp.")}
    ck.overlay_params(fresh, {**part, "not.a.key": torch.zeros(3)})
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, part[k] if k in part else before[k]), k
    bad = {"cnl_mlp.output_linear.0.bias": torch.zeros(5)}
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.overlay_params(fresh, bad)


def test_native_checkpoint_feeds_stage3_warm_start(tmp_path, tiny_models):
    """load_stage_params on the port's own checkpoint: the named model's
    state_dict, as a stage-1 or stage-2 run saved it."""
    scene, _ = tiny_models["scene"]
    human, _ = tiny_models["human"]
    ck.save_checkpoint(str(tmp_path), "last", ck.pack_train_state(
        {"scene": scene, "human": human}, None, 3))
    for which, m in (("scene", scene), ("human", human)):
        sd = ck.load_stage_params(str(tmp_path / "last.pt"), which)
        assert all(torch.equal(v, sd[k]) for k, v in m.state_dict().items())
