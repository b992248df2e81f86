"""The benchmark's analytic counts: the same whichever implementation the
port runs, and the scene term against the port's bench.py.

    python -m pytest -q hosbench/tests/test_hosbench_counts.py
"""

import ast
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hosbench import counts as C
from hosbench import harness, pool
from hosbench import weights as W

ROOT = harness.ROOT


def bench_fn(name):
    """A function of the port's hosnerf_tpu_torch/bench.py, read by ast
    (the module is not imported)."""
    path = os.path.join(ROOT, "hosnerf_tpu_torch", "bench.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns[name]


class Cfg:
    n_patches, patch_size = 2, 32


def full_shapes(config):
    cell = harness.Cell("composed.p8" if config == "hosnerf-backpack"
                        else "scene.r4096")
    return C.shapes_of(cell.mod.weight_specs(cell.s)), cell


def test_scene_term_against_bench_py():
    """bench.py's scene_flops_per_step at 2 patches is 3.84 TFLOP: dominant
    products only, every proposal and NeRF product 3x (forward and
    backward). The benchmark counts the exact layer widths (the NeRF MLP's
    first layer is 568 wide, not 1024, and its skip layer 1,592; the heads
    are 1 + 256 + 283x128 + 3 wide, not 2 x 80): those agree with
    bench.py's dominant products within 10%. In the stage-3 step the
    proposal MLPs take no gradient, so their backward (2 x their forward)
    is left out on purpose."""
    ref = bench_fn("scene_flops_per_step")(Cfg)
    assert ref == pytest.approx(3.84e12, rel=2e-3)
    shapes, cell = full_shapes("hosnerf-backpack")
    rays = 2 * 32 * 32
    trained = C.scene_flops(shapes, rays, 64, 32, prop_trained=True)
    assert trained == pytest.approx(ref, rel=0.10)
    stage3 = C.scene_flops(shapes, rays, 64, 32, prop_trained=False)
    prop_fwd = sum(C.macs(shapes, f"scene.mlps.{i}.") for i in (0, 1)) \
        * rays * 64 * 2.0
    assert trained - stage3 == pytest.approx(2 * prop_fwd, rel=1e-12)
    # the NeRF MLP's exact multiply-adds a sample
    assert C.macs(shapes, "scene.mlps.2.") == (
        568 * 1024 + 4 * 1024 ** 2 + 1592 * 1024 + 2 * 1024 ** 2
        + 1024 + 1024 * 256 + 283 * 128 + 128 * 3)


def test_trunk_macs_are_bench_pys():
    """The trunk multiply-adds a row are bench.py's `trunk_flops` terms;
    bench.py multiplies them by 4 (B3's recompute counted as work) where
    the benchmark takes 3 (forward, input and weight gradients)."""
    shapes, _ = full_shapes("hosnerf-backpack")
    cnl, nr = C.trunk_macs(shapes)
    assert cnl == 127 * 256 + 6 * 256 * 256 + 383 * 256 + 256 * 4
    assert nr == 111 * 128 + 4 * 128 * 128 + 164 * 128 + 128 * 3


def small_cell():
    cell = harness.Cell("composed.p8", small=True)
    return cell


def step_flops(cell, impl, params, batch):
    """(FlopCounterMode's count, the benchmark's count) of one training
    step of the port with `impl` (lbs_impl, mlp_impl)."""
    s = dict(cell.s, lbs_impl=impl[0], mlp_impl=impl[1])
    prog = cell.mod.Program(s, cell.mix, params, torch.device("cpu"))
    with FlopCounterMode(display=False) as fc:
        prog.step(batch, 0, cell.mod.generator(9, 0, "cpu"))
    shapes = C.shapes_of(cell.mod.weight_specs(s))
    ours = cell.mod.step_counts(s, cell.mix, shapes, batch, 9, 0, "cpu")
    return fc.get_total_flops(), ours


def test_counts_do_not_depend_on_the_implementation():
    """The port's kernel path (its plain versions on the CPU) and its
    dense module path count differently under a library-op counter; the
    benchmark's counts of the same step are equal."""
    torch.manual_seed(0)
    cell = small_cell()
    params = W.make(cell.mod.weight_specs(cell.s), 9, "cpu")
    batch = pool.to_device(cell.mod.batches(cell.s, cell.mix, 9)[:1],
                           "cpu")[0]
    fc_k, ours_k = step_flops(cell, ("pallas", "fused"), params, batch)
    fc_d, ours_d = step_flops(cell, ("gather", "flax"), params, batch)
    assert fc_k != fc_d
    assert json.dumps(ours_k, sort_keys=True) == json.dumps(
        ours_d, sort_keys=True)
    assert 0 < ours_k["live"] <= batch["rays_o"].shape[0] * cell.s[
        "n_samples"]
    assert ours_k["live"] <= ours_k["pairs"]


def test_scene_forward_flops_match_the_library_count():
    """The scene's forward products by the benchmark's count against
    FlopCounterMode over the port's SceneField forward (plain nn.Linear
    products; the IPE basis projections are the rest, under 2%)."""
    from hosnerf_tpu_torch.models.scene import SceneField
    cell = harness.Cell("scene.r4096", small=True)
    s = cell.s
    params = W.make(cell.mod.weight_specs(s), 3, "cpu")
    model = SceneField(num_states=2, num_prop_samples=s["num_prop_samples"],
                       num_nerf_samples=s["num_nerf_samples"],
                       nerf_netwidth=s["nerf_netwidth"],
                       prop_netwidth=s["prop_netwidth"], device="cpu")
    W.load(model, W.sub(params, "scene"))
    batch = pool.to_device(cell.mod.batches(s, cell.mix, 3)[:1], "cpu")[0]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(batch, 0.5, False, torch.zeros((), dtype=torch.long), 0.1,
              1e6)
    shapes = C.shapes_of(cell.mod.weight_specs(s))
    rays = batch["rays_o"].shape[0]
    fwd = (sum(C.macs(shapes, f"scene.mlps.{i}.") for i in (0, 1))
           * rays * s["num_prop_samples"]
           + C.macs(shapes, "scene.mlps.2.") * rays * s["num_nerf_samples"]
           ) * 2.0
    assert fwd == pytest.approx(fc.get_total_flops(), rel=0.02)
    assert fwd <= fc.get_total_flops()


def test_roofline_is_the_larger_bound():
    assert C.roofline_s(f32_ops=67e12) == pytest.approx(1.0)
    assert C.roofline_s(bf16_ops=989e12) == pytest.approx(1.0)
    assert C.roofline_s(bf16_ops=989e12, nbytes=2 * 3.35e12) == \
        pytest.approx(2.0)


def test_every_per_layer_metric_has_its_reader():
    """Each per-layer metric of BENCHMARK.json is read by
    `hosbench/layers/<name>.py`, whose LAYER and MOVES are the entry's
    `layer` and `moves`; a reader with nothing to read returns None."""
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    empty = {"steps": 0, "span_s": 0.0, "busy_s": 0.0, "groups": {},
             "b_kernels": {}, "counts": [], "world": 1,
             "per_step_ms": lambda g: None}
    for m in bench["per_layer"]:
        path = os.path.join(ROOT, "hosbench", "layers", f"{m['name']}.py")
        reader = harness.load_module(path, "reader_" + m["name"])
        assert reader.LAYER == m["layer"], m["name"]
        assert reader.MOVES == m["moves"], m["name"]
        assert reader.read(empty) is None, m["name"]
