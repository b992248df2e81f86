"""The benchmark's plain reference against the port's plain path on the
CPU at the tiny widths (`tools/common.py::SMALL`), on the same weights,
batch and jitter; and the reference's imports.

    python -m pytest -q hosbench/tests/test_hosbench_reference.py
"""

import subprocess
import sys

import pytest
import torch

from hosbench import harness, pool
from hosbench import weights as W
from hosbench.reference import compose as ref_compose
from hosbench.reference import train as ref_train
from hosbench.reference.precision import Precision

FORBIDDEN = {"jax", "jaxlib", "flax", "hosnerf_tpu", "hosnerf_tpu_torch"}


def test_the_reference_imports_neither_jax_nor_either_package():
    """Top-level module names compared whole: `hosnerf_tpu_torch` begins
    with `hosnerf_tpu` and is named in its own right."""
    code = ("import sys; import hosbench.reference.train, "
            "hosbench.reference.precision; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(out.stdout.split())
    assert "hosbench" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def ref_grads(cell, params, batch, i, seed):
    s, mix = cell.s, cell.mix
    P = {k: v.clone().requires_grad_(True) for k, v in params.items()
         if not k.startswith("lpips.")}
    gen = cell.mod.generator(seed, i, "cpu")
    if "human" in {k.split(".")[0] for k in P}:
        lp = W.sub(params, "lpips")
        cfg = dict(s, n_patches=mix["n_patches"],
                   patch_size=mix["patch_size"])
        ls = ref_train.stage3_loss(P, lp, batch, s["iteration"] + i, gen,
                                   cfg)
    else:
        ls = ref_train.stage1_loss(W.sub(P, "scene"), batch,
                                   s["iteration"] + i, gen, s)
    names = list(P)
    g = torch.autograd.grad(ls["loss"], [P[k] for k in names],
                            allow_unused=True)
    return ls, {k: t for k, t in zip(names, g) if t is not None}


@pytest.mark.parametrize("workload", ["composed.p8", "scene.r4096"])
def test_reference_step_matches_the_ports_plain_path(workload):
    """One step's loss (1e-5 relative) and every gradient (rel L2 1e-3)
    of the port's dense plain path (gather LBS, module MLPs, f32) against
    the reference's, on the same weights, batch and jitter; the same
    parameters take a gradient on both sides (the stage-3 proposal MLPs
    none)."""
    torch.manual_seed(0)
    cell = harness.Cell(workload, small=True)
    cell.s.update(lbs_impl="gather", mlp_impl="flax", compute_dtype=None)
    cell.s = {k: v for k, v in cell.s.items()
              if not (workload == "scene.r4096" and k in ("lbs_impl",
                                                          "mlp_impl"))}
    seed = 4242
    params = W.make(cell.mod.weight_specs(cell.s), seed, "cpu")
    batch = pool.to_device(cell.mod.batches(cell.s, cell.mix, seed)[:1],
                           "cpu")[0]
    prog = cell.mod.Program(cell.s, cell.mix, params, torch.device("cpu"))
    if hasattr(prog, "human"):
        from hosnerf_tpu_torch.train import stage3
        fn = stage3.make_grad_fn(prog.cfg, prog.scene, prog.human,
                                 lpips_apply=prog.lpips)
    else:
        from hosnerf_tpu_torch.train import stage1
        fn = stage1.make_grad_fn(prog.cfg, prog.model, cell.s["transitions"])
    got = fn(batch, cell.s["iteration"], cell.mod.generator(seed, 0, "cpu"))
    g_port = {k: p.grad for k, p in prog.named_params()
              if p.grad is not None}
    ls, g_ref = ref_grads(cell, params, batch, 0, seed)
    assert float(got["loss"]) == pytest.approx(float(ls["loss"].detach()), rel=1e-5)
    assert set(g_port) == set(g_ref)
    if workload == "composed.p8":
        assert not any(k.startswith("scene.mlps.0.") for k in g_ref)
    worst = max((rel_l2(g_port[k], g_ref[k]), k) for k in g_ref)
    assert worst[0] < 1e-3, worst


def test_fp8_precision_rounds_operands_and_gradients():
    prec = Precision("fp8")
    x = torch.linspace(-1, 1, 1001, requires_grad=True)
    y = prec.operand(x)
    assert 0 < float((y - x).detach().abs().max()) < 0.07
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    g = torch.randn(64, 32)
    w = torch.randn(16, 32, requires_grad=True)
    a = torch.randn(64, 32, requires_grad=True)
    out = prec.linear(a, w)
    out.backward(g[:, :16])
    exact = g[:, :16] @ w.detach()
    assert 1e-4 < rel_l2(a.grad, exact) < 0.2
    assert Precision("f32").operand(x) is x


def test_compose_matches_the_ports_sortless_composite():
    from hosnerf_tpu_torch.ops import merge
    torch.manual_seed(1)
    R, Nb, Nh = 16, 6, 5
    z_b = torch.sort(torch.rand(R, Nb) * 4, -1).values
    z_h = torch.sort(torch.rand(R, Nh) * 4, -1).values
    ob, oh = torch.rand(R, Nb, 4), torch.rand(R, Nh, 4)
    mask = (torch.rand(R, Nh) > 0.3).float()
    d = torch.randn(R, 3)
    rgb, w_h = ref_compose.sortless_composite(z_b, ob, z_h, oh, mask, d)
    port = merge.sortless_composite(z_b, ob, z_h, oh, mask, d)
    assert torch.allclose(rgb, port[0], atol=1e-6)
    assert torch.allclose(w_h, port[3], atol=1e-6)

