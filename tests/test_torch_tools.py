"""The port's chip tools (`hosnerf_tpu_torch/tools/`) on the CPU.

The convergence probe's loop is held against the JAX probe's loop
(`tools/convergence_probe.py`, written out here at tiny widths: the JAX
tool reads sys.argv when imported) for 3 steps of each stage on one mini
capture: the same weights (the port's, moved into the JAX trees by the
inverse converters of tests/test_torch_scene.py and test_torch_stage3.py),
f32 trunks, the same batches from each package's own loaders, and JAX's
jitter draws replayed into the port (stage 1 as
test_torch_scene.py::replay_draws does, stage 2 through
`parallel/mesh.py::rand_rows`). The JAX side runs its dense flax path with
the one-hot ('xla') LBS (the port the same forms), compiled in background
threads started with the module. Then the window comparison on the JAX
package's committed curves, the parity runbook's result handling and
report against the JAX runbook's own functions (which import no JAX), the
stage-3 tools at 1 patch of 8 x 8 rays on the CPU, and the tools' imports
and device rules.
"""

import importlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hosnerf_tpu.data import scene_loader as jscene_loader
from hosnerf_tpu.data import scene_pipeline as jscene_pipeline
from hosnerf_tpu.data.human_dataset import HumanDataset as JHumanDataset
from hosnerf_tpu.train import stage1 as jstage1
from hosnerf_tpu.train import stage2 as jstage2
from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.parallel import mesh
from hosnerf_tpu_torch.train import stage1, stage2
from hosnerf_tpu_torch.tools import convergence_probe as cp
from hosnerf_tpu_torch.tools import parity_runbook as rb
from test_torch_scene import (_jax_level_uniforms, replay_draws,
                              scene_params_from_port)
from test_torch_stage3 import human_params_from_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
SEED = 0
# stage 1 at configs/mini.gin's widths on 64 rays, stage 2 at the stage-3
# tests' tiny widths on one 8 x 8 patch; both f32 trunks
S1 = dict(nerf_netwidth=64, prop_netwidth=32, num_prop_samples=16,
          num_nerf_samples=8, compute_dtype=None)
S1_RAYS = 64
S2 = dict(n_samples=8, cnl_mlp_width=32, nr_mlp_width=16,
          mweight_volume_size=8, compute_dtype=None)
S2_PATCHES, S2_PATCH = 1, 8


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _jax_stage1(path, params):
    """The JAX probe's stage-1 loop at S1 for STEPS steps: (per step
    (loss, psnr), the jitter draws of each step's three levels)."""
    scene = jscene_loader.load_nerf_360_v2(
        os.path.dirname(path), os.path.basename(path), factor=1,
        near=cp.NEAR, far=cp.FAR)
    pipe = jscene_pipeline.ScenePipeline(scene, batch_size=S1_RAYS)
    cfg = jstage1.Stage1Config(max_steps=STEPS, near=cp.NEAR, far=cp.FAR,
                               num_states=2, **S1)
    ds = JHumanDataset(path, mode="train", mweight_volume_size=cp.VOLUME)
    opt = jstage1.make_optimizer(cfg)
    opt_state = opt.init(params)
    step = jax.jit(jstage1.make_train_step(cfg, jstage1.make_model(cfg), opt,
                                           transitions=ds.transitions))
    rng = jax.random.key(1)
    out, draws = [], []
    for i in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in pipe.sample_train_batch().items()}
        rng, sub = jax.random.split(rng)
        draws += [np.asarray(u) for u in _jax_level_uniforms(
            sub, S1_RAYS, cfg.num_levels)]
        params, opt_state, aux = step(params, opt_state, b,
                                      jnp.float32(i), sub)
        out.append((float(aux["loss"]), float(aux["psnr"])))
    return out, draws


def _jax_stage2(path, params):
    """The JAX probe's stage-2 loop at S2 for STEPS steps (its dense flax
    path, one-hot LBS): (per step (loss, psnr of the mse), the jitter
    draws [R, S] of each step)."""
    ds = JHumanDataset(path, mode="train", n_patches=S2_PATCHES,
                       patch_size=S2_PATCH,
                       mweight_volume_size=S2["mweight_volume_size"])
    cfg = jstage2.Stage2Config(n_patches=S2_PATCHES, patch_size=S2_PATCH,
                               lbs_impl="xla", **S2)
    opt = jstage2.make_optimizer(cfg, params)
    opt_state = opt.init(params)
    step = jax.jit(jstage2.make_train_step(cfg, jstage2.make_model(cfg), opt,
                                           transitions=ds.transitions))
    rng = jax.random.key(2)
    out, draws = [], []
    shape = (S2_PATCHES * S2_PATCH ** 2, S2["n_samples"])
    for i in range(STEPS):
        item = ds[i % len(ds)]
        b = {k: jnp.asarray(v) for k, v in item.items() if k != "frame_name"}
        rng, sub = jax.random.split(rng)
        draws.append(np.asarray(jax.random.uniform(
            jax.random.split(sub)[1], shape, dtype=jnp.float32)))
        params, opt_state, aux = step(params, opt_state, None, b,
                                      jnp.float32(i), sub)
        mse = float(aux["mse"])
        out.append((float(aux["loss"]), -10.0 * np.log10(max(mse, 1e-10))))
    return out, draws


@pytest.fixture(scope="module", autouse=True)
def probe_case(_threads, tmp_path_factory):
    """The mini capture, the port's initial weights of both stages (the
    probe builds them from SEED) in JAX trees, and the JAX loops running
    in two background threads from the start of the module."""
    root = str(tmp_path_factory.mktemp("probe"))
    path = os.path.join(root, "mini")
    synthetic.write_mini_dataset(path, n_frames=8, res=32)
    s1 = stage1.make_model(stage1.Stage1Config(num_states=2, **S1),
                           seed=SEED, device="cpu")
    s2 = stage2.make_model(stage2.Stage2Config(
        n_patches=S2_PATCHES, patch_size=S2_PATCH, **S2), seed=SEED,
        device="cpu")
    p1, p2 = scene_params_from_port(s1), human_params_from_port(s2)
    with ThreadPoolExecutor(2) as pool:
        yield dict(path=path,
                   stage1=pool.submit(_jax_stage1, path, p1),
                   stage2=pool.submit(_jax_stage2, path, p2))


# ---------------------------------------------------------------------------
# the stage-3 tools on the CPU, imports and device rules
# ---------------------------------------------------------------------------

SMALL_ARGS = ["--n_patches", "1", "--patch_size", "8", "--small",
              "--device", "cpu"]
QUICK = ["--iters", "1", "--warmup", "0"]
TOOL_RUNS = {
    "grad_parity": ([], ["worst rel diff", "GRAD PARITY: PASS"]),
    "time_step": (QUICK + ["--splits", "none:heavy"],
                  ["split=none:heavy", "ms/step"]),
    "profile_step": (QUICK + ["--k", "1"],
                     ["dispatch noop", "scene fwd+bwd", "human fwd+bwd",
                      "inverse LBS fwd+bwd", "back to back",
                      "each synced", "host share"]),
    "profile_tail": (QUICK, ["loss fwd+bwd (no optimizer)",
                             "optimizer update alone", "loss forward only"]),
    "profile_human": (QUICK, ["inverse_warp pallas", "inverse_warp xla",
                              "bone_weights+2 fwd_lbs", "cnl_mlp",
                              "nr_mlp x3", "embedders",
                              "mweight_vol_decoder"]),
    "fg_density_study": ([], ["fg_alive (>0.005)", "inv_alive",
                              "tile_alive @T=1024",
                              "sorted domain live fraction"]),
}


@pytest.mark.parametrize("name", sorted(TOOL_RUNS))
def test_stage3_tool_runs_on_the_cpu(name, capsys):
    """Each stage-3 tool with --device cpu at 1 patch of 8 x 8 rays (tiny
    widths): exit 0 and its lines printed, each time finite."""
    extra, lines = TOOL_RUNS[name]
    mod = importlib.import_module(f"hosnerf_tpu_torch.tools.{name}")
    assert mod.main(SMALL_ARGS + extra) == 0
    out = capsys.readouterr().out
    assert "'kind': 'cpu'" in out or name == "grad_parity"
    for line in lines:
        assert line in out, (line, out)
    assert "nan" not in out.lower() and "inf " not in out


def test_memcheck_raises_without_the_card():
    """memcheck has no CPU counterpart: asked for the CPU it raises an
    error naming the card."""
    from hosnerf_tpu_torch.tools import memcheck_8patch
    with pytest.raises(RuntimeError, match="CUDA card"):
        memcheck_8patch.main(["--device", "cpu"])


TOOLS = ("common", "convergence_probe", "parity_runbook", "grad_parity",
         "time_step", "memcheck_8patch", "profile_step", "profile_tail",
         "profile_human", "fg_density_study", "pair_count", "ref_flops",
         "bench_mlp", "bench_lbs", "bench_deconv", "bench_lbs_pg",
         "pg_density_study", "pg_window_study", "bench_all")


def test_tools_import_no_jax_and_need_the_card_by_default():
    """In a fresh interpreter that blocks jax and hosnerf_tpu, every tool
    imports; without a card, each stage-3 tool, the probe and each of
    the kernel microbenches, pair-grid studies, ref_flops and bench_all
    called without --device raise (nothing falls back to the CPU)."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'hosnerf_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import importlib, torch
assert not torch.cuda.is_available()
mods = [importlib.import_module('hosnerf_tpu_torch.tools.' + n)
        for n in {TOOLS!r}]
for n in ('grad_parity', 'time_step', 'profile_step', 'profile_tail',
          'profile_human', 'fg_density_study', 'convergence_probe',
          'ref_flops', 'bench_mlp', 'bench_lbs', 'bench_deconv',
          'bench_lbs_pg', 'pg_density_study', 'pg_window_study',
          'bench_all'):
    try:
        importlib.import_module('hosnerf_tpu_torch.tools.' + n).main([])
    except RuntimeError as e:
        assert 'no CUDA device' in str(e), e
    else:
        raise AssertionError(n + ' ran without a card')
print('ok', sorted(m for m in sys.modules
                   if m.split('.')[0] in ('jax', 'hosnerf_tpu')))
"""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok []"), res.stdout


# ---------------------------------------------------------------------------
# the probe's loop against JAX's
# ---------------------------------------------------------------------------

def _check_curve(curve, ref):
    assert [e["step"] for e in curve] == list(range(STEPS))
    for e, (loss, psnr) in zip(curve, ref):
        np.testing.assert_allclose(e["loss"], loss, rtol=1e-4,
                                   err_msg=f"step {e['step']}")
        assert abs(e["psnr"] - psnr) <= 1e-3, (e, psnr)


def test_probe_stage1_loop_matches_jax(probe_case, monkeypatch):
    """3 stage-1 steps of the probe's loop (pipeline batches, the step
    index as the step: the warm-up schedule and train_fraction annealing,
    clipped Adam) on JAX's jitter: each step's loss within 1e-4 relative
    of JAX's, its PSNR within 1e-3 dB."""
    ref, draws = probe_case["stage1"].result()
    replay_draws(monkeypatch, [torch.tensor(u) for u in draws])
    rec = cp.run_stage1(probe_case["path"], STEPS, torch.device("cpu"),
                        SEED, rays=S1_RAYS, log_every=1, **S1)
    _check_curve(rec["curve"], ref)


def test_probe_stage2_loop_matches_jax(probe_case, monkeypatch):
    """3 stage-2 steps of the probe's loop (HumanDataset item i at step i,
    iter i, one state as in the JAX probe) on JAX's jitter, the dense path
    with the one-hot LBS and module MLPs on both sides: each step's loss
    within 1e-4 relative of JAX's, -10 log10(mse) within 1e-3 dB."""
    ref, draws = probe_case["stage2"].result()
    draws = iter(draws)
    monkeypatch.setattr(mesh, "rand_rows",
                        lambda shape, gen, dtype=None: torch.tensor(
                            next(draws)).reshape(shape))
    rec = cp.run_stage2(probe_case["path"], STEPS, torch.device("cpu"),
                        SEED, n_patches=S2_PATCHES, patch_size=S2_PATCH,
                        log_every=1, lbs_impl="xla", mlp_impl="flax", **S2)
    _check_curve(rec["curve"], ref)


# ---------------------------------------------------------------------------
# the window comparison on the JAX package's committed curves
# ---------------------------------------------------------------------------

JAX_WINDOWS = {"stage1": (46.97, 53.10, 64.84),
               "stage2": (32.83, 35.17, 37.62)}


@pytest.mark.parametrize("stage", cp.STAGES)
def test_window_comparison_on_the_jax_curves(stage):
    """The JAX curves' window values are the ones the probe is held to
    (0.01 dB); JAX's curve against itself passes in every window, the
    same curve 3.1 dB lower fails in every window, 2.9 dB lower passes."""
    jax_curve = cp.load_curve(os.path.join(REPO, "tools", "convergence"),
                              stage)
    got = [cp.window_value(stage, jax_curve, lo, hi)
           for lo, hi in cp.WINDOWS]
    np.testing.assert_allclose(got, JAX_WINDOWS[stage], atol=0.01)
    rows, ok = cp.compare(stage, jax_curve, jax_curve)
    assert ok and len(rows) == len(cp.WINDOWS)

    def lowered(db):
        # PSNR - db; mse * 10^(db / 10) lowers -10 log10(mse) by db
        return [dict(e, psnr=e["psnr"] - db,
                     **({"mse": e["mse"] * 10 ** (db / 10)}
                        if "mse" in e else {})) for e in jax_curve]

    rows, ok = cp.compare(stage, lowered(3.1), jax_curve)
    assert not ok and not any(r[-1] for r in rows)
    assert cp.compare(stage, lowered(2.9), jax_curve)[1]


def test_window_needs_the_whole_window():
    """A run that stops inside a window does not cover it: the 1,000-step
    run (logged at 0, 50, ..., 950, 999) covers [500, 1000) only."""
    curve = [{"step": s, "psnr": 40.0, "mse": 1e-4}
             for s in list(range(0, 1000, 50)) + [999]]
    assert cp.window_value("stage1", curve, 500, 1000) == 40.0
    assert cp.window_value("stage1", curve[:-1], 500, 1000) is None
    assert cp.window_value("stage2", curve, 1000, 2000) is None
    rows, ok = cp.compare("stage2", curve, curve)
    assert ok and [r[0] for r in rows] == [(500, 1000)]


def test_probe_json_keeps_the_jax_schema(tmp_path):
    """emit writes the JAX files' keys (curve rounded as JAX rounds it)
    plus the device record."""
    rec = {"stage": "stage2", "steps": 2, "log_every": 1,
           "curve": [{"step": 0, "loss": 0.123456789, "mse": 0.0123456789,
                      "psnr": 19.0849123}],
           "wall_secs": 1.23456, "loss_first3_mean": 0.1234567,
           "loss_last3_mean": 0.1234567, "config": "x",
           "device": {"kind": "cpu"}}
    with open(cp.emit(str(tmp_path), rec)) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "tools", "convergence",
                           "probe_stage2.json")) as f:
        jax_keys = set(json.load(f))
    assert set(got) == jax_keys | {"device"}
    assert got["curve"] == [{"step": 0, "loss": 0.12346, "mse": 0.012346,
                             "psnr": 19.085}]
    assert got["wall_secs"] == 1.2


# ---------------------------------------------------------------------------
# the parity runbook
# ---------------------------------------------------------------------------

def _jax_runbook():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_runbook", os.path.join(REPO, "tools", "parity_runbook.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCENE_RES = [{"test": 24.5, "train": 26.25}, {"test": 0.8125},
             {"test": 0.25, "train": 0.125}, {"lpips_backbone": "random"}]
HUMAN_RES = {"testimgs": {"psnr": 21.5, "ssim": 0.75, "lpips": 0.375,
                          "is_empty_img": False},
             "allimgs": {"psnr": 22.25, "ssim": 0.5, "lpips": 0.25},
             "lpips_backbone": "vgg16"}
HUMAN_LIST = [{"psnr": 20.5, "ssim": 0.625, "lpips": 0.5,
               "lpips_backbone": "random"}, {"psnr": 19.0}]
REF = {"scene": {"test": {"psnr": 24.4, "lpips": 0.2}},
       "human": {"testimgs": {"psnr": 21.0}}}


def _fabricate(logbase, scene="cap"):
    for prefix, res in (("scene", SCENE_RES), ("human", HUMAN_RES),
                        ("hosnerf", HUMAN_LIST)):
        d = os.path.join(logbase, f"{prefix}_{scene}", "eval")
        os.makedirs(d)
        with open(os.path.join(d, "results.json"), "w") as f:
            json.dump(res, f)


def test_runbook_results_match_the_jax_runbook(tmp_path):
    """find_results / _normalize_results on scene (list), human (dict) and
    human full-eval (list of dicts) results.json files equal the JAX
    runbook's."""
    jrb = _jax_runbook()
    _fabricate(str(tmp_path))
    for res in (SCENE_RES, HUMAN_RES, HUMAN_LIST):
        assert rb._normalize_results(res) == jrb._normalize_results(res)
    for prefix in ("scene", "human", "hosnerf"):
        d = str(tmp_path / f"{prefix}_cap")
        assert rb.find_results(d) == jrb.find_results(d)


@pytest.mark.parametrize("with_ref", [False, True])
def test_runbook_report_matches_the_jax_runbook(tmp_path, monkeypatch,
                                                with_ref):
    """Both runbooks' main() with their commands stubbed, on the same
    results files (and reference JSON): PARITY_RUN.md equal line for line,
    the provenance notes and the 0.2 dB verdict included. The port's
    commands drive the port's CLI with --device and warm-start stage 3
    from last.pt where no best.pt exists."""
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps(REF))
    extra = ["--ref_results", str(ref)] if with_ref else []
    texts, cmds = [], []
    for name, mod in (("jax", _jax_runbook()), ("port", rb)):
        logbase = tmp_path / name
        _fabricate(str(logbase))
        calls = []
        monkeypatch.setattr(mod, "sh", lambda a, log, calls=calls:
                            calls.append(a))
        argv = ["--datadir", "/data", "--scene", "cap", "--logbase",
                str(logbase), "--steps1", "5", "--steps2", "5",
                "--steps3", "5"] + extra
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["parity_runbook.py"] + argv)
            mod.main()
        else:
            mod.main(argv + ["--device", "cpu"])
        texts.append((logbase / "PARITY_RUN.md").read_text().replace(
            str(logbase), "<logbase>"))
        cmds.append(calls)
    assert texts[0] == texts[1]
    if with_ref:
        assert "**PSNR parity target (<=0.2 dB): FAIL**" in texts[1]
        assert "NOT metric-grade (backbone=random)" in texts[1]
    port = cmds[1]
    assert len(port) == 6 and all(
        c[1:4] == ["-m", "hosnerf_tpu_torch.cli.run", "--stage"] and
        c[c.index("--device") + 1] == "cpu" for c in port)
    s3 = port[4]
    assert s3[s3.index("--bkgd_path") + 1].endswith(
        os.path.join("scene_cap", "ckpt", "last.pt"))
    assert s3[s3.index("--max_steps") + 1] == "5"
