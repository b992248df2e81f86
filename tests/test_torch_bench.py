"""The port's bench script (`hosnerf_tpu_torch/bench.py`) against the JAX
repo's root `bench.py`, on the CPU.

bench.py is read with `ast` and never imported (importing it sets JAX's
compilation cache): its constants, its analytic FLOP functions (compiled
from their source), its baseline arithmetic and its JSON keys. The port's
bench runs once at `--device cpu --small`; its chained steps are held bit
for bit to `make_train_step` called directly on a fresh state, in a
subprocess started first so that the two runs overlap. No JAX runs.
"""

import ast
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from hosnerf_tpu_torch import bench
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.tools import ref_flops
from hosnerf_tpu_torch.train import stage3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(REPO, "bench.py")
REL = 1e-12          # the trunk and scene terms against bench.py's
LBS_SHARE = 1e-3     # the port's LBS terms against bench.py's one-hot ones
RENAMED = {"model_tflops_xla_only": "model_tflops_counted",
           "model_tflops_pallas": "model_tflops_kernels"}
SMALL_STEPS = 3      # --small: 1 warm-up + 2 timed steps a point

# make_train_step on a fresh state, written out apart from the bench: the
# cell's config, composed_batch, iteration 100 + i and generator 1000 + i
DIRECT = """
import json, torch
torch.set_num_threads(1)
from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.tools.common import SMALL
from hosnerf_tpu_torch.train import stage3
out = {}
for n, ps, kw in ((2, 32, {}), (8, 8, dict(remat="none", scene_remat="none",
                                           human_remat="none"))):
    cfg = stage3.Stage3Config(n_patches=n, patch_size=ps,
                              compute_dtype="bf16", **SMALL, **kw)
    scene, human, opt = stage3.init_state(cfg, seed=0, device="cpu")
    step = stage3.make_train_step(cfg, scene, human, opt)
    batch = {k: torch.as_tensor(v) for k, v in synthetic.composed_batch(
        n, ps, grid_size=cfg.mweight_volume_size).items()}
    out[n] = [float(step(batch, 100.0 + i, torch.Generator().manual_seed(
        1000 + i))["loss"]) for i in range(%d)]
print(json.dumps(out))
""" % SMALL_STEPS


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_bench():
    """bench.py's module AST."""
    with open(JAX_BENCH) as f:
        return ast.parse(f.read())


def _constants(tree):
    """bench.py's module-level constants (literals and arithmetic of
    earlier ones)."""
    ns = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.isupper()):
            ns[node.targets[0].id] = eval(compile(
                ast.Expression(node.value), JAX_BENCH, "eval"), {}, ns)
    return ns


def _function(tree, name):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _terms_function(fn):
    """A copy of `fn` returning {name: value} of the names its return
    expression adds."""
    fn = ast.parse(ast.unparse(fn)).body[0]
    ret = fn.body[-1]
    names = [n.id for n in ast.walk(ret.value) if isinstance(n, ast.Name)]
    ret.value = ast.Dict(keys=[ast.Constant(n) for n in names],
                         values=[ast.Name(n, ast.Load()) for n in names])
    fn.name += "_terms"
    return fn


@pytest.fixture(scope="module")
def jax_flops(jax_bench):
    """bench.py's pallas_flops_per_step and analytic_flops_per_step
    compiled from its source, and pallas_flops_per_step's terms."""
    ns = _constants(jax_bench)
    pallas = _function(jax_bench, "pallas_flops_per_step")
    mod = ast.Module(body=[pallas, _terms_function(pallas),
                           _function(jax_bench, "analytic_flops_per_step")],
                     type_ignores=[])
    exec(compile(ast.fix_missing_locations(mod), JAX_BENCH, "exec"), ns)
    return ns


def _json_dict(tree):
    """The dict literal bench.py's main prints."""
    for node in ast.walk(_function(tree, "main")):
        if (isinstance(node, ast.Call)
                and ast.unparse(node.func) == "json.dumps"):
            return node.args[0]
    raise AssertionError("no json.dumps in bench.py's main")


def _keys(d):
    """Every key of a dict literal, those of its ** parts too."""
    keys = []
    for k, v in zip(d.keys, d.values):
        if k is None:
            for sub in ast.walk(v):
                if isinstance(sub, ast.Dict):
                    keys += [c.value for c in sub.keys
                             if isinstance(c, ast.Constant)]
        else:
            keys.append(k.value)
    return keys


@pytest.fixture(scope="module")
def bench_run():
    """`main(["--device", "cpu", "--small"])`'s stdout, stderr and
    return code, with the direct steps' losses from the subprocess
    started before it; the card settings main sets are put back after."""
    direct = subprocess.Popen(
        [sys.executable, "-c", DIRECT], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    flags = [(torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cudnn, "deterministic"),
             (torch.backends.cudnn, "benchmark")]
    saved = [getattr(m, n) for m, n in flags]
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(["--device", "cpu", "--small"])
    finally:
        for (m, n), v in zip(flags, saved):
            setattr(m, n, v)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        d_out, d_err = direct.communicate(timeout=300)
    assert direct.returncode == 0, d_err[-2000:]
    return {"rc": rc, "stdout": out.getvalue(), "stderr": err.getvalue(),
            "direct": json.loads(d_out.strip().splitlines()[-1])}


def _bench_losses(stderr, n):
    line = [ln for ln in stderr.splitlines()
            if ln.startswith(f"bench: {n}-patch losses ")]
    assert len(line) == 1, stderr
    return json.loads(line[0].split("losses ", 1)[1])


# ---------------------------------------------------------------------------
# constants, configs and FLOP counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "WARMUP", "ITERS", "N_PATCHES", "RAYS", "LIVE_FRACTION",
    "REF_FULL_CPU_SEC", "OURS_FULL_CPU_SEC", "GPU_UPLIFT_BRACKET",
    "REF_STEP_FLOPS", "A100_F32_PEAK"])
def test_constants_equal_bench_py(name, jax_bench):
    assert getattr(bench, name) == _constants(jax_bench)[name]


def test_ref_step_flops_is_ref_flops_count():
    """REF_STEP_FLOPS is tools/ref_flops.py's fwd + bwd count, rounded."""
    total = ref_flops.step_flops()[1]
    assert abs(bench.REF_STEP_FLOPS - total) <= 1e-3 * total


def test_points_are_bench_py_configs():
    """The 2-patch cell and the 8-patch point (bench.py:171, :262-266)."""
    assert bench.point_config(2) == stage3.Stage3Config(
        n_patches=2, compute_dtype="bf16")
    assert bench.point_config(8) == stage3.Stage3Config(
        n_patches=8, compute_dtype="bf16", remat="none", scene_remat="none",
        human_remat="none")
    assert bench.point_config(8, small=True) == stage3.Stage3Config(
        n_patches=8, patch_size=8, compute_dtype="bf16", remat="none",
        scene_remat="none", human_remat="none", **common.SMALL)


CONFIGS = {"default": dict(n_patches=2, compute_dtype="bf16"),
           "small": dict(n_patches=2, compute_dtype="bf16", **common.SMALL)}


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_trunk_and_scene_terms_equal_bench_py(which, jax_flops):
    """The trunk term is bench.py's `mlps`, the scene term bench.py's
    analytic total without its Pallas terms."""
    cfg = stage3.Stage3Config(**CONFIGS[which])
    terms = jax_flops["pallas_flops_per_step_terms"](cfg)
    assert sum(terms.values()) == jax_flops["pallas_flops_per_step"](cfg)
    got = bench.kernel_flops_terms(cfg)["trunks"]
    assert abs(got - terms["mlps"]) <= REL * terms["mlps"]
    scene = (jax_flops["analytic_flops_per_step"](cfg)
             - jax_flops["pallas_flops_per_step"](cfg))
    assert abs(bench.scene_flops_per_step(cfg) - scene) <= REL * scene
    assert bench.analytic_flops_per_step(cfg) == (
        bench.scene_flops_per_step(cfg) + bench.kernel_flops_per_step(cfg))


def test_lbs_terms_leave_out_the_one_hot_products(jax_flops):
    """At the cell (G = 32) the Hopper kernels' taps and blends are under
    LBS_SHARE of bench.py's `inv + fwd_lbs`: those count the TPU
    technique's one-hot [1, G^2] @ [G^2, G] products (G^3 MACs a tap row
    where a gather reads 8 corners), which the port does not do. At the
    test-only G = 8 the one-hot rows are 64x shorter, so the bound holds
    at the cell only."""
    cfg = stage3.Stage3Config(**CONFIGS["default"])
    terms = jax_flops["pallas_flops_per_step_terms"](cfg)
    ours = bench.kernel_flops_terms(cfg)
    n = 2 * 32 ** 2 * 128 * 26
    assert ours["inverse_lbs"] == pytest.approx(
        (bench.OPS_B1_PAIR + bench.OPS_B4_PAIR) * bench.PAIR_DENSITY * n,
        rel=REL)
    assert ours["forward_lbs"] == pytest.approx(
        (bench.OPS_B5F_BONE + bench.OPS_B5B_BONE) * bench.LIVE_FRACTION * n,
        rel=REL)
    share = ((ours["inverse_lbs"] + ours["forward_lbs"])
             / (terms["inv"] + terms["fwd_lbs"]))
    assert 0 < share < LBS_SHARE


# ---------------------------------------------------------------------------
# baseline and tripwire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rays_per_sec", [652.1, 5679.1, 25000.0, 31500.5])
def test_baseline_basis_is_bench_py_arithmetic(rays_per_sec, jax_bench):
    """vs_baseline and baseline_basis equal bench.py:317-365's arithmetic
    (its statements and dict entries evaluated from its source)."""
    ns = _constants(jax_bench)
    main = _function(jax_bench, "main")
    wanted = {"a_lo", "b_cap", "ref_lo", "ref_mid"}
    for node in main.body:
        if isinstance(node, ast.Assign) and wanted & {
                n.id for n in ast.walk(node.targets[0])
                if isinstance(n, ast.Name)}:
            exec(compile(ast.Module([node], []), JAX_BENCH, "exec"), ns)
    ns["rays_per_sec_per_chip"] = rays_per_sec
    d = _json_dict(jax_bench)
    entry = {k.value: v for k, v in zip(d.keys, d.values) if k is not None}

    def value(node):
        return eval(compile(ast.Expression(node), JAX_BENCH, "eval"), ns)

    vs, basis = bench.baseline_basis(rays_per_sec)
    assert vs == value(entry["vs_baseline"])
    assert basis == value(entry["baseline_basis"])


def test_tripwire_refuses_super_peak_rates():
    peak = bench.TRIPWIRE * bench.BF16_PEAK_TFLOPS * 1e12
    assert bench.implied_tflops(0.999 * peak, 1.0) == pytest.approx(
        0.999 * peak / 1e12)
    for flops in (1.001 * peak, math.inf, math.nan):
        with pytest.raises(bench.SuperPeak, match="refusing to report"):
            bench.implied_tflops(flops, 1.0)


def _fake_point(sec8=1.0, fail8=False):
    def run_point(cfg, device, warmup, iters):
        if cfg.n_patches == 8 and fail8:
            raise RuntimeError("8-patch point failed")
        return (sec8 if cfg.n_patches == 8 else 1.0,
                [{"loss": 0.1}] * (warmup + iters), lambda: None)
    return run_point


@pytest.mark.parametrize("case", ["2-patch super-peak", "8-patch super-peak",
                                  "8-patch fails"])
def test_run_fails_rather_than_reports(case, monkeypatch):
    """A super-peak rate at either point, or a failed 8-patch point, fails
    the run (bench.py only logged a failed 8-patch point)."""
    monkeypatch.setattr(bench, "counted_flops", lambda fn: None)
    if case == "2-patch super-peak":
        monkeypatch.setattr(bench, "run_point", _fake_point())
        monkeypatch.setattr(bench, "analytic_flops_per_step",
                            lambda cfg: 1e16)
    else:
        monkeypatch.setattr(bench, "run_point", _fake_point(
            sec8=1e-6, fail8=case == "8-patch fails"))
    want = (RuntimeError, "8-patch point failed") if case == "8-patch fails" \
        else (bench.SuperPeak, "refusing to report")
    with pytest.raises(want[0], match=want[1]):
        bench.run(torch.device("cpu"), small=True)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def test_main_prints_bench_py_keys(bench_run, jax_bench):
    """One JSON line: bench.py's keys (two renamed) and `device`; the
    value, the 8-patch time and every loss finite; the counted source."""
    assert bench_run["rc"] == 0
    lines = bench_run["stdout"].strip().splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    d = _json_dict(jax_bench)
    want = [RENAMED.get(k, k) for k in _keys(d)] + ["device"]
    assert sorted(rec) == sorted(want)
    basis = next(v for k, v in zip(d.keys, d.values)
                 if k is not None and k.value == "baseline_basis")
    assert sorted(rec["baseline_basis"]) == sorted(_keys(basis))
    assert rec["metric"] == "stage3_train_rays_per_sec_per_chip"
    for key in ("value", "sec_per_step", "sec_per_step_8patch",
                "rays_per_sec_8patch", "model_tflops_counted"):
        assert math.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["flops_source"] == bench.COUNTED
    assert rec["hbm_peak_gb_8patch"] is None      # no card memory on the CPU
    assert rec["device"]["kind"] == "cpu"
    for n in (2, 8):
        losses = _bench_losses(bench_run["stderr"], n)
        assert len(losses) == SMALL_STEPS
        assert all(math.isfinite(v) for v in losses)


# the kernels of the stage-3 step's human field (B1-B5), whose launches a
# card run counts
PATH_KERNELS = ("inverse_core_pg_s", "inverse_core_bwd", "fused_embed_trunk",
                "fused_embed_trunk_bwd", "shared_blend_fwd",
                "shared_blend_bwd")


@pytest.mark.parametrize("n", [2, 8])
def test_launch_lines_count_every_kernel(n, bench_run):
    """Each point reports every kernel wrapper's launches over its warm-up,
    timed and counted steps; on CPU tensors the plain versions run, and
    they count nothing."""
    found = [re.match(rf"bench: {n}-patch point: (\d+) steps, launches "
                      r"(\{.*\})$", ln)
             for ln in bench_run["stderr"].splitlines()]
    found = [m for m in found if m]
    assert len(found) == 1, bench_run["stderr"]
    steps, launches = int(found[0][1]), json.loads(found[0][2])
    assert steps == SMALL_STEPS + 1
    assert set(launches) == set(bench.kernel_wrappers())
    assert set(PATH_KERNELS) <= set(launches)
    assert all(v == 0 for v in launches.values()), launches


@pytest.mark.parametrize("n", [2, 8])
def test_chain_matches_direct_steps(n, bench_run):
    """The bench's chained steps give make_train_step's losses on a fresh
    state at the same iterations and generators, bit for bit."""
    assert _bench_losses(bench_run["stderr"], n) == bench_run["direct"][str(n)]


def test_no_card_exits_non_zero_without_jax():
    """Without --device cpu and without a card the run exits non-zero
    naming the missing card; jax and hosnerf_tpu are blocked and never
    asked for."""
    code = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'hosnerf_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.argv = ['bench']
runpy.run_module('hosnerf_tpu_torch.bench', run_name='__main__')
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]
    assert "blocked" not in res.stderr
    assert res.stdout == ""
