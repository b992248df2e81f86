"""The port's data-parallel path (`hosnerf_tpu_torch/parallel/`,
`entry.py`, the CLI under a process group) on the CPU:

* `shard_batch`, `pad_to_multiple` and `shard_eval_fn`'s blocks against
  the JAX package's helpers on the same numpy batch, JAX's per-device
  shards read off the 8-device CPU mesh that tests/conftest.py makes;
* `initialize`'s environment and argument cases (mirroring
  tests/test_distributed_init.py, `torch.distributed.init_process_group`
  monkeypatched);
* 2 gloo processes against 1 for one tiny step of each stage
  (`entry.dryrun_multidevice`): loss within 2e-6 * max(1, |loss|), every
  parameter's gradient within rel L2 1e-5, every rank's parameters equal
  after the Adam step bit for bit, and a sharded composed-render chunk
  equal to the one-process chunk;
* one step of tests/test_torch_cli.py's stage-2 CLI run under 2 ranks
  (gloo, --device cpu, torchrun's environment variables) against 1: rank
  0's checkpoint and logged loss to the same bounds (the gradients read
  from Adam's first moments, m = 0.1 g after one step).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hosnerf_tpu.parallel import mesh as jmesh
from hosnerf_tpu_torch import entry
from hosnerf_tpu_torch.parallel import distributed, mesh

from test_cli_pipeline import HUMAN_YAML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOSS, TOL_GRAD = 2e-6, 1e-5


def _batch(R=24):
    rng = np.random.default_rng(0)
    return {"rays_o": rng.normal(size=(R, 3)).astype(np.float32),
            "times": rng.uniform(size=(R,)).astype(np.float32),
            "dst_Rs": rng.normal(size=(8, 3, 3)).astype(np.float32),
            "bgcolor": rng.uniform(size=(5,)).astype(np.float32),
            "time": np.float32(0.25),
            "n_valid": 21}


def _jax_shards(batch, n):
    """{key: [device i's block]} of the JAX package's shard_batch over the
    first n CPU devices (replicated arrays: the whole array)."""
    devs = jax.devices()[:n]
    sharded = jmesh.shard_batch(batch, jmesh.make_mesh(devs))
    out = {}
    for k, arr in sharded.items():
        shards = sorted(arr.addressable_shards,
                        key=lambda s: devs.index(s.device))
        out[k] = [np.asarray(s.data) for s in shards]
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_batch_blocks_match_jax(n):
    assert len(jax.devices()) >= n
    batch = _batch()
    ref = _jax_shards(batch, n)
    for r in range(n):
        got = mesh.shard_batch(batch, r, n)
        assert got[mesh.SHARD_KEY] == mesh.RayShard(
            r, n, mesh.batch_digest(batch))
        for k, blocks in ref.items():
            np.testing.assert_array_equal(np.asarray(got[k]), blocks[r],
                                          err_msg=f"{k} rank {r}")
    # the training batches split the ray keys only
    got = mesh.shard_batch(batch, 1, n, keys=mesh.RAY_KEYS)
    np.testing.assert_array_equal(got["dst_Rs"], batch["dst_Rs"])
    np.testing.assert_array_equal(got["rays_o"], ref["rays_o"][1])
    # one rank: the batch as it is, without a mark
    assert mesh.shard_batch(batch, 0, 1) is batch
    assert mesh.shard_of(batch) == mesh.ONE


@pytest.mark.parametrize("n,multiple", [(21, 8), (24, 8), (5, 2), (1, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want, wn = jmesh.pad_to_multiple(x, multiple)
    got, gn = mesh.pad_to_multiple(x, multiple)
    np.testing.assert_array_equal(got, want)
    tgot, tn = mesh.pad_to_multiple(torch.from_numpy(x), multiple)
    np.testing.assert_array_equal(tgot.numpy(), want)
    assert gn == tn == wn == n


@pytest.mark.parametrize("n", [2, 8])
def test_shard_eval_fn_blocks_match_jax(n, monkeypatch):
    """Each rank renders the block of the padded chunk that JAX's
    shard_eval_fn puts on that device; the gathered output is trimmed
    to the chunk."""
    batch = _batch(21)
    padded = {k: (jmesh.pad_to_multiple(v, n)[0] if k in mesh.RAY_KEYS
                  else v) for k, v in batch.items()}
    ref = _jax_shards(padded, n)
    seen = {}
    monkeypatch.setattr(mesh, "_all_gather_rows",
                        lambda x, world: torch.cat([x] * world))
    tb = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    for r in range(n):
        def fn(b, r=r):
            seen[r] = b
            return b["rays_o"] * 2.0
        out = mesh.shard_eval_fn(fn, r, n)(tb)
        assert out.shape == (21, 3)
        for k in ("rays_o", "times"):
            np.testing.assert_array_equal(seen[r][k].numpy(), ref[k][r])
        np.testing.assert_array_equal(seen[r]["dst_Rs"].numpy(),
                                      batch["dst_Rs"])
    fn = lambda b: b["rays_o"]  # noqa: E731
    assert mesh.shard_eval_fn(fn, 0, 1) is fn


def test_rand_rows_is_the_one_process_draw():
    g_full = torch.Generator().manual_seed(3)
    full = torch.rand((8, 5), generator=g_full)
    for r in range(4):
        g = torch.Generator().manual_seed(3)
        with mesh.RayShard(r, 4).draws():
            u = mesh.rand_rows((2, 5), g)
        np.testing.assert_array_equal(u.numpy(), full[2 * r:2 * r + 2])
        # every rank's generator advances as the one-process draw's
        assert torch.equal(g.get_state(), g_full.get_state())
    g = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(mesh.rand_rows((8, 5), g).numpy(), full)


# --------------------------------------------------------------------------
# initialize: environment and arguments
# --------------------------------------------------------------------------

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK")


@pytest.fixture
def captured(monkeypatch):
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: called.append(kw))
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    return called


def test_single_process_is_noop(captured):
    assert distributed.initialize(device="cpu") == torch.device("cpu")
    distributed.initialize(num_processes=1, device="cpu")
    assert captured == []


def test_env_var_resolution(captured, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert distributed.initialize(device="cpu") == torch.device("cpu")
    assert captured == [{"backend": "gloo",
                         "init_method": "tcp://10.0.0.1:1234",
                         "world_size": 4, "rank": 2}]


def test_explicit_args_win(captured, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "ignored")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "7")
    distributed.initialize("host:9999", 2, 1, device="cpu",
                           backend="mpi")
    distributed.initialize("file:///tmp/x", 2, 0, device="cpu")
    assert captured == [
        {"backend": "mpi", "init_method": "tcp://host:9999",
         "world_size": 2, "rank": 1},
        {"backend": "gloo", "init_method": "file:///tmp/x", "world_size": 2,
         "rank": 0}]


def test_cuda_rank_takes_nccl_and_its_card(captured, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.initialize(device="cuda") == torch.device("cuda", 3)
    assert captured[0]["backend"] == "nccl"


def test_no_card_raises_and_init_failure_raises(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize("host:1", 2, 0, device="cuda")

    def fail(**kw):
        raise RuntimeError("nccl init failed")

    monkeypatch.setattr(dist, "init_process_group", fail)
    with pytest.raises(RuntimeError, match="nccl init failed"):
        distributed.initialize("host:1", 2, 0, device="cpu")


def test_single_process_queries():
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.is_primary()
    distributed.barrier()


# --------------------------------------------------------------------------
# 2 gloo processes against 1
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reports():
    return entry.dryrun_multidevice(2, backend="gloo", device="cpu",
                                    threads=1, timeout=300, quiet=True)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_two_ranks_match_one_process(reports, stage):
    for rep in reports:
        r = rep[stage]
        assert r["loss_delta"] <= TOL_LOSS * max(1.0, abs(r["loss_1"])), r
        assert r["max_grad_rel"] <= TOL_GRAD, r
        assert r["params_equal"], r
    assert reports[0][stage]["loss_n"] == reports[1][stage]["loss_n"]


def test_two_ranks_render_the_one_process_chunk(reports):
    for rep in reports:
        assert rep["render"]["max_err"] <= 1e-6, rep["render"]
    assert reports[0]["render"] == reports[1]["render"]


# --------------------------------------------------------------------------
# the CLI under two ranks
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_stage2_two_ranks_match_one(tmp_path):
    from hosnerf_tpu_torch.cli import run
    from hosnerf_tpu_torch.data import synthetic
    mini = tmp_path / "mini"
    mini.mkdir()
    synthetic.write_mini_dataset(str(mini), n_frames=10, res=32)
    (tmp_path / "mini.yaml").write_text(HUMAN_YAML.format(mini=str(mini)))

    def args(logbase):
        return ["--stage", "human", "--cfg", str(tmp_path / "mini.yaml"),
                "--scene_name", "mini", "--logbase", str(logbase),
                "--device", "cpu", "--run_mode", "train", "--max_steps",
                "1"]

    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else [])))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hosnerf_tpu_torch.cli.run"]
        + args(tmp_path / "two"), cwd=tmp_path,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    torch.set_num_threads(1)
    run.main(args(tmp_path / "one"))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]

    one = tmp_path / "one" / "human_mini"
    two = tmp_path / "two" / "human_mini"
    loss = [json.loads(open(d / "metrics.jsonl").readline())["loss"]
            for d in (one, two)]
    assert abs(loss[1] - loss[0]) <= TOL_LOSS * max(1.0, abs(loss[0]))
    assert len(open(two / "metrics.jsonl").readlines()) == 1  # rank 0 only
    a, b = (torch.load(d / "ckpt" / "last.pt", weights_only=False)
            for d in (one, two))
    assert a["step"] == b["step"] == 1
    ma, mb = a["models"]["human"], b["models"]["human"]
    assert ma.keys() == mb.keys()
    for k in ma:
        # one Adam step: every parameter moves by at most its lr
        assert float((ma[k] - mb[k]).abs().max()) <= 2 * 6.7e-4, k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) == len(ma)
    for i in sa:
        g1, g2 = sa[i]["exp_avg"], sb[i]["exp_avg"]
        d = float(torch.linalg.vector_norm((g2 - g1).double()))
        n = float(torch.linalg.vector_norm(g1.double()))
        assert d <= TOL_GRAD * n or d <= 1e-12, (i, d, n)
