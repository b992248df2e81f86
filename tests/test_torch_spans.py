"""The port's spans and counters inside the training step
(`hosnerf_tpu_torch/utils/spans.py`) on the CPU, and the benchmark's
readers of them (`hosbench/span_readers.py`, `hosbench/layers/`).

The stage-3 step runs at tests/test_torch_stage3.py's tiny widths with
`mlp_impl="fused"` and `lbs_impl="pallas"`: on CPU tensors it takes the
sorted path through the kernel entries' plain versions, so the kernel
spans and the row counters record here too. The plain versions launch
nothing; a counting stub stands in for the launches.
"""

import importlib.util
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
from hosnerf_tpu_torch.train import stage1, stage3
from hosnerf_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITER = 60_000
TINY = dict(n_samples=8, cnl_mlp_width=32, nr_mlp_width=16,
            mweight_volume_size=8, n_patches=2, patch_size=4,
            num_prop_samples=8, num_nerf_samples=4, nerf_netwidth=32,
            prop_netwidth=16, near_bkg=0.5, far_bkg=20.0)

# span -> its parent's name, as the step nests them
STAGE3_PARENTS = {
    "step": None, "forward": "step", "backward": "step",
    "optimizer": "step", "scene": "forward", "human.pose": "forward",
    "human.sort": "forward", "human.inverse_lbs": "forward",
    "human.trunks": "forward", "human.forward_lbs": "forward",
    "human.render": "forward", "compose": "forward",
    "loss.image": "forward", "loss.lpips": "loss.image",
    "loss.human": "forward", "B1": "human.inverse_lbs",
    "B2": "human.trunks", "B5": "human.forward_lbs", "B3.bwd": "backward",
    "B4.bwd": "backward", "B5.bwd": "backward"}
STAGE1_PARENTS = {"step": None, "forward": "step", "backward": "step",
                  "optimizer": "step", "scene": "forward",
                  "loss.image": "forward"}

# the CPU-path callee of each kernel entry -> the wrapper it counts for
STUBS = {(cmlp, "embed_trunk_fwd"): cmlp.fused_embed_trunk,
         (cmlp, "embed_trunk_bwd"): cmlp.fused_embed_trunk_bwd,
         (clbs, "inverse_core_plain"): clbs.inverse_core_pg_s,
         (clbs, "inverse_core_bwd_plain"): clbs.inverse_core_bwd}
ENTRY_LAUNCHES = {"B2": "fused_embed_trunk",
                  "B3.bwd": "fused_embed_trunk_bwd",
                  "B1": "inverse_core_pg_s", "B4.bwd": "inverse_core_bwd"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _counting(fn, wrapper):
    def run(*args, **kwargs):
        wrapper.launches += 1
        return fn(*args, **kwargs)
    return run


def _ranges_of(mp, fn):
    """The profiler ranges that fn opens through the spans."""
    names = []
    real = spans._RANGE

    def counted(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    mp.setattr(spans, "_RANGE", counted)
    fn()
    mp.undo()
    return names


def _session(step_fn, iters):
    """Run the steps under a CPU profiler: (records, the names of the
    profiler's events, read from its raw results: parsing them whole takes
    seconds)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for it in iters:
            step_fn(it)
    return spans.records(), {e.name() for e in
                             prof.profiler.kineto_results.events()}


@pytest.fixture(scope="module")
def stage3_runs():
    """One stage-3 step with no profiler (its profiler ranges counted), then
    one session of one step with the counting stubs."""
    cfg = stage3.Stage3Config(**TINY, lbs_impl="pallas", mlp_impl="fused")
    scene, human, opt = stage3.init_state(cfg, seed=0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in synthetic.composed_batch(
        cfg.n_patches, cfg.patch_size,
        grid_size=cfg.mweight_volume_size).items()}
    lpips = lambda a, b: torch.mean((a - b) ** 2, dim=(1, 2, 3))  # noqa
    train = stage3.make_train_step(cfg, scene, human, opt, lpips_apply=lpips)

    def step(it):
        return train(batch, it, torch.Generator().manual_seed(it))

    mp = pytest.MonkeyPatch()
    before, _ = _session(lambda it: None, [])
    ranges = _ranges_of(mp, lambda: step(ITER))
    off = {"records": spans.records(), "before": before, "ranges": ranges}
    for (mod, name), wrapper in STUBS.items():
        mp.setattr(mod, name, _counting(getattr(mod, name), wrapper))
    wrappers = spans.kernel_wrappers()
    n0 = {k: w.launches for k, w in wrappers.items()}
    recs, names = _session(step, [ITER + 1])
    n1 = {k: w.launches for k, w in wrappers.items()}
    mp.undo()
    yield {"off": off, "recs": recs, "names": names,
           "launched": {k: n1[k] - n0[k] for k in n0 if n1[k] != n0[k]}}


def _check_nesting(recs, parents, step_id):
    got = {r["name"] for r in recs}
    assert got == set(parents), got ^ set(parents)
    for r in recs:
        want = parents[r["name"]]
        if want is None:
            assert r["parent"] is None, r["name"]
        else:
            assert recs[r["parent"]]["name"] == want, r["name"]
        assert r["step"] == step_id, r["name"]
        assert r["t0"] <= r["t1"], r["name"]
        assert (r["cpu0"] <= r["cpu1"] if want is None
                else "cpu0" not in r), r["name"]
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["t0"] <= r["t0"] and r["t1"] <= p["t1"], r["name"]


def test_no_profiler_records_nothing(stage3_runs):
    """Without a profiler a step adds no record and opens no range."""
    off = stage3_runs["off"]
    assert off["records"] == off["before"] == []
    assert off["ranges"] == []


def test_stage3_spans_nest_and_carry_the_step(stage3_runs):
    recs = stage3_runs["recs"]
    _check_nesting(recs, STAGE3_PARENTS, ITER + 1)
    assert set(STAGE3_PARENTS) <= stage3_runs["names"]
    for name in ("B3.bwd", "B4.bwd", "B5.bwd"):
        assert any(r["name"] == name for r in recs), name
    # without a card: no event and no card waits
    assert all(r["syncs"] is None and "device_ns" not in r for r in recs)


def test_stage3_launch_deltas_equal_the_wrappers_counts(stage3_runs):
    recs = stage3_runs["recs"]
    (top,) = [r for r in recs if r["parent"] is None]
    assert top["launches"] == stage3_runs["launched"]
    assert stage3_runs["launched"] == {
        "fused_embed_trunk": 4, "fused_embed_trunk_bwd": 4,
        "inverse_core_pg_s": 1, "inverse_core_bwd": 1}
    for r in recs:
        if r["name"] in ENTRY_LAUNCHES:
            assert r["launches"] == {ENTRY_LAUNCHES[r["name"]]: 1}, r
    for name in ("forward", "backward"):
        kids = [r["launches"] for r in recs if r["parent"] is not None
                and recs[r["parent"]]["name"] == name]
        (span,) = [r for r in recs if r["name"] == name]
        summed = {}
        for d in kids:
            for k, v in d.items():
                summed[k] = summed.get(k, 0) + v
        assert span["launches"] == summed, name


def test_stage3_rows(stage3_runs):
    """The sorted domain's rows reach the step's record."""
    (top,) = [r for r in stage3_runs["recs"] if r["parent"] is None]
    n_pad = -(-TINY["n_samples"] * TINY["n_patches"]
              * TINY["patch_size"] ** 2 // clbs.ROW_PAD) * clbs.ROW_PAD
    assert 0 < top["live_rows"] <= top["computed_rows"] == n_pad


def test_stage1_spans_nest_in_a_new_session(stage3_runs, monkeypatch):
    """Stage 1's spans, without a profiler none; a new session (after the
    stage-3 one) holds only its own step."""
    cfg = stage1.Stage1Config(num_prop_samples=8, num_nerf_samples=4,
                              nerf_netwidth=32, prop_netwidth=16,
                              near=0.5, far=20.0)
    model, opt = stage1.init_state(cfg, seed=0, device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in synthetic.scene_ray_batch(32).items()}
    train = stage1.make_train_step(cfg, model, opt)
    before = spans.records()
    assert any(r["name"] == "B1" for r in before)
    assert _ranges_of(monkeypatch, lambda: train(batch, 5)) == []
    assert spans.records() is before
    recs, names = _session(
        lambda it: train(batch, it, torch.Generator().manual_seed(it)), [6])
    _check_nesting(recs, STAGE1_PARENTS, 6)
    assert set(STAGE1_PARENTS) <= names
    assert all(r["launches"] == {} for r in recs)


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


NEW = ("host_step_ms", "host_forward_ms", "host_backward_ms",
       "host_wait_ms", "queue_ms", "card_waits_per_step")


def _reader(name):
    path = os.path.join(ROOT, "hosbench", "layers", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "layer_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records():
    """Two profiled steps of hand-set numbers (ns): walls 10 ms and 14 ms,
    CPU 6 ms and 15 ms, a forward and a backward each."""
    recs = []
    for k, (t0, wall, cpu, q, waits, rows) in enumerate(
            [(0, 10e6, 6e6, 1e6, (1, 2, 0), (60, 100)),
             (20e6, 14e6, 15e6, 3e6, (0, 0, 1), (90, 100))]):
        i = len(recs)
        recs.append({"name": "step", "parent": None, "step": 100 + k,
                     "t0": t0, "t1": t0 + wall, "cpu0": 5e6,
                     "cpu1": 5e6 + cpu, "device_ns": t0 + wall + q,
                     "syncs": waits[0], "device_allocs": waits[1],
                     "device_frees": waits[2], "live_rows": rows[0],
                     "computed_rows": rows[1], "launches": {}})
        recs.append({"name": "forward", "parent": i, "step": 100 + k,
                     "t0": t0, "t1": t0 + 4e6})
        recs.append({"name": "backward", "parent": i, "step": 100 + k,
                     "t0": t0 + 4e6, "t1": t0 + 9e6})
    return recs


EXPECTED = {"host_step_ms": 12.0, "host_forward_ms": 4.0,
            "host_backward_ms": 5.0, "host_wait_ms": 2.0, "queue_ms": 2.0,
            "card_waits_per_step": 2.0, "lbs_useful_share": 75.0}


@pytest.mark.parametrize("name", [n + s for n in NEW for s in ("", ".scene")]
                         + ["lbs_useful_share"])
def test_each_reader_reads_the_records(name, monkeypatch):
    recs = _records()
    monkeypatch.setattr(spans, "records", lambda: recs)
    read = _reader(name).read
    assert read({"steps": 2}) == pytest.approx(
        EXPECTED[name.split(".")[0]])
    assert read({"steps": 3}) is None
    assert read({"steps": 1}) is None


def test_each_new_entry_has_its_reader():
    bench = _bench()
    names = {n + s for n in NEW for s in ("", ".scene")} | {
        "lbs_useful_share"}
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert names <= set(entries)
    for name in names:
        m, reader = entries[name], _reader(name)
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
        assert m["source"] == "host_clock"
        assert m["workloads"] == (["scene.r4096"] if name.endswith(".scene")
                                  else ["composed.p8"])
