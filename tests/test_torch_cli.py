"""The port's command line end to end on the CPU (`python -m
hosnerf_tpu_torch.cli.run --device cpu`): the command sequence of
tests/test_cli_pipeline.py on the same fabricated mini capture and the
same gin and yaml sizes, run in-process (stages 2 and 3 for fewer
steps: on the CPU each of their steps takes seconds, most of it the
weight-volume decoder's 1024-channel transposed convolutions and Adam
over their weights).

  stage scene   train -> ckpt/last.pt + cameras_scaleworld.pkl
  stage scene   eval  -> results.json (+ provenance entry) + image dump
  stage scene   render -> camera-path mp4
  stage human   train, 2 steps (a progress eval forced) -> ckpt/last.pt
  stage human   eval  -> results.json + testimgs/allimgs/freeview/tpose
  stage human   render -> the freeview frames
  stage hosnerf train, 1 step, --bkgd_path/--human_path (the two stages'
                own checkpoints)
  stage hosnerf train --max_steps 2 --resume_training True (LR, Adam and
                generator resume)
  stage hosnerf eval, render

No JAX runs here, except one check that the port's parser takes every
flag of the JAX CLI's.
"""

import json
import os
import pickle

import pytest
import torch

from hosnerf_tpu_torch.cli import run
from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.train import checkpoints as ck

from test_cli_pipeline import HUMAN_YAML, SCENE_GIN

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    mini = root / "mini"
    mini.mkdir()
    synthetic.write_mini_dataset(str(mini), n_frames=10, res=32)
    (root / "mini.gin").write_text(SCENE_GIN.format(parent=str(root)))
    # the JAX test's yaml with a progress eval at step 1 of the human run
    (root / "mini.yaml").write_text(HUMAN_YAML.format(mini=str(mini))
                                    .replace("dump_interval: 100000",
                                             "dump_interval: 1"))
    logbase = str(root / "logs")
    common = ["--scene_name", "mini", "--logbase", logbase, "--device",
              "cpu"]
    return {
        "root": root, "mini": mini, "logbase": logbase,
        "scene": ["--stage", "scene", "--ginc", str(root / "mini.gin")]
        + common,
        "human": ["--stage", "human", "--cfg", str(root / "mini.yaml")]
        + common,
        "hosnerf": ["--stage", "hosnerf", "--ginc", str(root / "mini.gin"),
                    "--cfg", str(root / "mini.yaml")] + common}


@pytest.fixture(scope="module")
def scene_run(env):
    assert not (env["mini"] / "cameras_scaleworld.pkl").exists()
    run.main(env["scene"] + ["--run_mode", "train"])
    return os.path.join(env["logbase"], "scene_mini")


@pytest.fixture(scope="module")
def human_run(env):
    run.main(env["human"] + ["--run_mode", "train", "--max_steps", "2"])
    return os.path.join(env["logbase"], "human_mini")


@pytest.fixture(scope="module")
def hosnerf_run(env, scene_run, human_run):
    run.main(env["hosnerf"] + [
        "--run_mode", "train", "--max_steps", "1",
        "--bkgd_path", os.path.join(scene_run, "ckpt", "last.pt"),
        "--human_path", os.path.join(human_run, "ckpt", "last.pt")])
    return os.path.join(env["logbase"], "hosnerf_mini")


def _metrics(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_scene_train(env, scene_run):
    state = ck.restore_checkpoint(os.path.join(scene_run, "ckpt"), "last")
    assert state["step"] == 6 and state["updates"] == 6
    assert set(state["models"]) == {"scene"}
    assert os.path.isfile(os.path.join(scene_run, "config.gin"))
    assert [r["step"] for r in _metrics(scene_run)] == [0, 2, 4]
    # the stage-1 -> stage-3 file handoff
    with open(env["mini"] / "cameras_scaleworld.pkl", "rb") as f:
        sw = pickle.load(f)
    assert "smpl_to_scale_world" in next(iter(sw.values()))


def test_scene_eval_and_render(env, scene_run):
    run.main(env["scene"] + ["--run_mode", "eval"])
    with open(os.path.join(scene_run, "results.json")) as f:
        res = json.load(f)
    assert isinstance(res, list) and len(res) == 4
    assert set(res[0]) == {"train", "val", "test"}   # psnr by split
    assert res[3] == {"lpips_backbone": "random-fixed-seed"}
    assert all(v is not None for v in res[2].values())
    assert any(f.endswith(".png") for f in os.listdir(
        os.path.join(scene_run, "render_model")))
    run.main(env["scene"] + ["--run_mode", "render"])
    assert os.path.isfile(os.path.join(scene_run, "render_video",
                                       "images.mp4"))


def test_human_train_and_eval(env, human_run):
    state = ck.restore_checkpoint(os.path.join(human_run, "ckpt"), "last")
    assert state["step"] == 2 and set(state["models"]) == {"human"}
    # the forced progress eval (dump_interval 1)
    with open(os.path.join(human_run, "results_prog_000001.json")) as f:
        prog = json.load(f)[0]
    assert prog["is_empty_img"] is False and prog["psnr"] is not None
    run.main(env["human"] + ["--run_mode", "eval"])
    with open(os.path.join(human_run, "results.json")) as f:
        hres = json.load(f)
    assert isinstance(hres, list) and len(hres) == 2   # testimgs, allimgs
    assert all(e["psnr"] is not None for e in hres)
    for tag in ("testimgs_vis", "allimgs_vis", "freeview", "tpose_vis"):
        assert any(d.startswith(tag) for d in os.listdir(human_run)), tag
    os.remove(os.path.join(human_run, "freeview", "images.mp4"))
    run.main(env["human"] + ["--run_mode", "render"])
    assert os.path.isfile(os.path.join(human_run, "freeview", "images.mp4"))


def test_hosnerf_warm_start_resume_and_eval(env, scene_run, human_run,
                                             hosnerf_run):
    ckdir = os.path.join(hosnerf_run, "ckpt")
    first = ck.restore_checkpoint(ckdir, "last")
    assert first["step"] == 1 and set(first["models"]) == {"scene", "human"}
    # warm start: the human field's decoder constant and the scene's state
    # embeddings come from the stage runs (Adam moves them only by lr)
    human0 = ck.load_stage_params(os.path.join(human_run, "ckpt", "last.pt"),
                                  "human")
    scene0 = ck.load_stage_params(os.path.join(scene_run, "ckpt", "last.pt"),
                                  "scene")
    for got, want in ((first["models"]["human"], human0),
                      (first["models"]["scene"], scene0)):
        assert got.keys() == want.keys()
        gap = max(float((got[k] - want[k]).abs().max()) for k in want)
        assert gap < 1e-3

    run.main(env["hosnerf"] + ["--run_mode", "train", "--max_steps", "2",
                               "--resume_training", "True"])
    resumed = ck.restore_checkpoint(ckdir, "last")
    assert resumed["step"] == 2 and resumed["updates"] == 2
    adam = resumed["optimizer"]["state"]
    assert adam and all(float(s["step"]) == 2.0 for s in adam.values())
    assert [r["step"] for r in _metrics(hosnerf_run)] == [0]

    run.main(env["hosnerf"] + ["--run_mode", "eval"])
    with open(os.path.join(hosnerf_run, "results.json")) as f:
        cres = json.load(f)
    assert isinstance(cres, list) and len(cres) == 2
    assert all(e["psnr"] is not None for e in cres)
    for tag in ("testimgs_vis", "freeview", "tpose_vis"):
        assert any(d.startswith(tag) for d in os.listdir(hosnerf_run)), tag
    os.remove(os.path.join(hosnerf_run, "freeview", "images.mp4"))
    run.main(env["hosnerf"] + ["--run_mode", "render"])
    assert os.path.isfile(os.path.join(hosnerf_run, "freeview",
                                       "images.mp4"))


def test_cuda_device_without_a_card_raises(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [a for a in env["scene"] if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(args + ["--run_mode", "train"])


def test_parser_takes_every_jax_flag():
    from hosnerf_tpu.cli import run as jrun
    jflags = {a.dest: a for a in jrun.build_parser()._actions}
    flags = {a.dest: a for a in run.build_parser()._actions}
    assert set(jflags) <= set(flags)
    assert set(flags) - set(jflags) == {"device"}
    for dest, a in jflags.items():
        b = flags[dest]
        assert (a.option_strings, a.default, a.required, a.choices) == (
            b.option_strings, b.default, b.required, b.choices), dest


@pytest.mark.parametrize("spec,device,want", [
    (None, "cpu", None), ("auto", "cpu", None), ("auto", "cuda", "bf16"),
    ("f32", "cuda", None), ("bf16", "cpu", "bf16")])
def test_resolve_cdt(spec, device, want):
    assert run._resolve_cdt(spec, device) == want
