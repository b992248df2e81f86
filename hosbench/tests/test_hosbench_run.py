"""CPU rehearsal of the benchmark: every cell through `python -m
hosbench.run --cpu-rehearsal` (tiny widths, the port's plain path), its
last line in the contract's shape; a four-card cell's multi-rank path (a
2-rank gloo group, from a checkout whose BENCHMARK.json adds the
composed.p8.dp4 cell that PERF.md keeps for later); the refusals (no
card, no port, JAX loaded); and the comparison catching the faults a
training cell can have.

    python -m pytest -q hosbench/tests/test_hosbench_run.py
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from hosbench import harness

ROOT = harness.ROOT
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workloads():
    return [w["name"] for w in bench()["workloads"]]


def run_cli(*args, cwd=ROOT, env=None, timeout=900):
    return subprocess.run([sys.executable, "-m", "hosbench.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def last_line(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("traced", [0, 1])
def test_each_cell_rehearses_on_the_cpu(workload, traced):
    proc = run_cli("--workload", workload, "--seed", "3000000021",
                   "--seconds", "1", "--trace", str(traced),
                   "--cpu-rehearsal")
    line = last_line(proc)
    assert list(line)[:5] == list(KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, proc.stderr[-2000:]
    assert line["failed"] == 0 and line["attempted"] >= 5
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["kind"] == "cpu"
    cell = harness.Cell(workload, small=True)
    assert dev["count"] == cell.world
    if traced:
        assert "busy_s" in dev and "window_s" in dev
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer()}
    else:
        assert set(line["metrics"]) == {m["name"]
                                        for m in cell.end_to_end()}
        for m in line["metrics"].values():
            assert m["value"] >= 0 and m["unit"]
    for k, v in line["checks"].items():
        assert v["value"] <= v["limit"], k
        assert f"check {k}" in proc.stderr


def test_the_port_kernel_path_rehearses():
    """The sorted path on the port's plain kernel versions runs through
    the harness (its bf16 LBS taps are not held to the tiny widths'
    limits: see PERF.md)."""
    cell = harness.Cell("composed.p8", small=True)
    cell.s.update(lbs_impl="pallas", mlp_impl="fused")
    res = harness.run(cell, 5, 0.0, False, torch.device("cpu"))
    assert res["everyone"][0]["finite"]
    assert res["everyone"][0]["steps"] >= 1


def test_without_a_card_it_refuses():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = run_cli("--workload", workloads()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0", timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_the_port_it_refuses(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "hosbench"), tmp_path / "hosbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = run_cli("--workload", workloads()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0", "--cpu-rehearsal",
                   cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_jax_loaded_by_the_window_refuses(tmp_path):
    """A run in whose process a module named `jax` (or the JAX package) is
    loaded by the window's close exits non-zero with no result; a module
    named `hosnerf_tpu_torch_x` does not count (whole top-level names)."""
    fake = tmp_path / "jax"
    fake.mkdir()
    (fake / "__init__.py").write_text("")
    code = ("import jax, sys; sys.argv = ['run', '--workload', "
            f"'{workloads()[1]}', '--seed', '2', '--seconds', '0.2', "
            "'--trace', '0', '--cpu-rehearsal']; "
            "from hosbench import run; sys.exit(run.main())")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "jax" in proc.stderr
    sys.modules.setdefault("hosnerf_tpu_torch_x", object())
    try:
        assert harness.forbidden_modules() == []
    finally:
        sys.modules.pop("hosnerf_tpu_torch_x", None)


FAULTS = ("frozen", "half", "control")


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in workloads() for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    """The timed path broken underneath (the update left out; the patch
    or data loss over half the batch) or the reference in fp8 in the
    program's place: `correct` comes out false at the rehearsal's
    limits."""
    cell = harness.Cell(workload, small=True)
    with cell.mod.fault("none" if fault == "control" else fault):
        res = harness.run(cell, 11, 0.0, False, torch.device("cpu"),
                          control="fp8" if fault == "control" else None)
    assert res["correct"] is False, res["compared"]


DP = {"name": "composed.p8.dp4", "config": "hosnerf-backpack",
      "traffic": "p8.dp4", "chips": 4, "why": "rehearsal only"}


@pytest.fixture
def dp_checkout(tmp_path):
    """A copy of the benchmark whose BENCHMARK.json has the four-card
    cell, and the environment that runs it (the port from this
    repository)."""
    b = bench()
    b["workloads"].append(DP)
    b["end_to_end"].append({"name": "dp_rays_per_s", "unit": "rays/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": [DP["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    shutil.copytree(os.path.join(ROOT, "hosbench"), tmp_path / "hosbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ,
               PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    return tmp_path, env


def test_the_multi_rank_path_rehearses(dp_checkout):
    """A four-card cell rehearses as 2 gloo ranks: rank 0 starts the
    other, every rank's readings are held to the reference's
    one-process step on the whole batch."""
    path, env = dp_checkout
    proc = run_cli("--workload", DP["name"], "--seed", "3000000023",
                   "--seconds", "1", "--trace", "1", "--cpu-rehearsal",
                   cwd=path, env=env)
    line = last_line(proc)
    assert line["correct"] is True, proc.stderr[-2000:]
    assert line["device"]["count"] == 2
    proc = run_cli("--workload", DP["name"], "--seed", "5", "--seconds",
                   "1", "--trace", "0", "--cpu-rehearsal", cwd=path, env=env)
    assert set(last_line(proc)["metrics"]) == {"dp_rays_per_s",
                                               "peak_mem_gib", "setup_s"}


def test_the_exchange_left_out_is_not_correct(dp_checkout):
    path, env = dp_checkout
    assert ranks_correct(DP["name"], "noreduce", path, env) is False


RANK = """
import json, sys, torch
from hosbench import harness
from hosnerf_tpu_torch.parallel import distributed
workload, fault, rank, world, init = sys.argv[1:6]
rank, world = int(rank), int(world)
distributed.initialize(init, world, rank, device="cpu")
cell = harness.Cell(workload, small=True)
with cell.mod.fault(fault):
    res = harness.run(cell, 3, 0.0, False, torch.device("cpu"), rank, world)
if rank == 0:
    print(json.dumps({"correct": res["correct"]}))
"""


def ranks_correct(workload, fault, path, env):
    """`correct` of a rehearsal of a multi-rank cell with `fault` planted
    in every rank (the checkout at `path`)."""
    from hosbench.run import free_port
    world = 2
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", RANK, workload, fault,
                               str(r), str(world), init], cwd=path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])["correct"]


def test_calibration_reads_the_look(tmp_path):
    """`hosbench.calibrate` at tiny widths: one record per reading, with
    the compared numbers, both sides' loss terms, the reference's share
    of each gradient outside the image losses, and with `--look` the
    clamp count; a planted fault's record comes out not correct."""
    from hosbench import calibrate
    out = tmp_path / "cal.jsonl"
    assert calibrate.main(["--workload", "composed.p8", "--cpu-rehearsal",
                           "--seeds", "5", "--faults", "frozen:5", "--look",
                           "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["what"], r["seed"]) for r in recs] == [("program", 5),
                                                      ("frozen", 5)]
    prog, frozen = recs
    assert prog["correct"] is True and frozen["correct"] is False
    assert set(prog["terms"]) >= {"mse", "lpips", "cycle", "flow", "loss"}
    assert set(prog["other_share"]) == set(prog["leaves"])
    assert prog["leaves_image"] > 0
    assert prog["clamp"]["samples"] >= prog["clamp"]["body"] > 0
    assert 0 < prog["clamp"]["flow_top10_share"] <= 1
    assert "clamp" not in frozen
