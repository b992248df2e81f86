"""The port's kernel microbenches, pair-grid studies, ref_flops and
bench_all (`hosnerf_tpu_torch/tools/`) on the CPU.

The analytic count is held to the JAX repo's `tools/ref_flops.py` exactly;
the pair counts of `tools/pair_count.py`, `pg_density_study` and
`pg_window_study` at 1 patch to the JAX tools' own functions and printed
counts and to `ops/pallas/lbs.py`'s `_build_pairs`, `_group_sort_perm` and
`_sample_support`, on the same points and bone affines (JAX's, as numpy).
The JAX scripts are loaded by path: they read sys.argv[1] when imported,
so sys.argv is [name] while they load. Every new tool runs with --device
cpu at a tiny size.
"""

import importlib
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hosnerf_tpu.core import body as jbody
from hosnerf_tpu.data import synthetic as jsynthetic
from hosnerf_tpu.ops.pallas import lbs as plbs
from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.tools import pair_count as pc
from hosnerf_tpu_torch.tools import pg_density_study as tdensity
from hosnerf_tpu_torch.tools import pg_window_study as twindow
from hosnerf_tpu_torch.tools import ref_flops as tflops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, B = 32, 26
N_PATCHES = 1
DENSITY_TOL = 1e-3   # pair densities, absolute


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _jax_tool(name):
    """The JAX repo's tools/<name>.py as a module: loaded by path with
    sys.argv = [name], the JAX compilation cache setting restored after
    (the scripts set their own)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    argv, cache = sys.argv, jax.config.jax_compilation_cache_dir
    sys.argv = [name]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


@pytest.fixture(scope="module")
def points():
    """The JAX studies' points at 1 patch (human_batch(1, 32,
    grid_size=32), 128 depths a ray) and grid affines, as numpy."""
    b = {k: jnp.asarray(v) for k, v in
         jsynthetic.human_batch(N_PATCHES, 32, grid_size=G).items()}
    t = jnp.linspace(0.0, 1.0, pc.S)
    z = b["near"] * (1 - t)[None, :] + b["far"] * t[None, :]
    pts = (b["rays_o"][:, None, :]
           + b["rays_d"][:, None, :] * z[..., None]).reshape(-1, 3)
    m_sR, m_T, _, _ = jbody.motion_bases(b["dst_Rs"], b["dst_Ts"],
                                         b["cnl_gtfms"])
    s, o = plbs._grid_affine(b["cnl_bbox_min_xyz"], b["cnl_bbox_scale_xyz"],
                             G)
    rg = (m_sR * s[None, :, None]).reshape(B, 9)
    tg = m_T * s[None, :] + o[None, :]
    return {k: np.asarray(v, np.float32) for k, v in
            dict(pts=pts, rg=rg, tg=tg).items()}


def _padded_tables(points):
    _, bpd = plbs._pg_pad_shapes(B, G)
    return (jnp.pad(jnp.asarray(points["rg"]), ((0, bpd - B), (0, 0))),
            jnp.pad(jnp.asarray(points["tg"]), ((0, bpd - B), (0, 0))))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# ref_flops
# ---------------------------------------------------------------------------

def test_ref_flops_equals_the_jax_script(capsys):
    """Every count function and the printed totals, exactly."""
    jref = _jax_tool("ref_flops")
    for n in (1, 7, 2048 * 128):
        for din, dout in ((127, 256), (504 + 64, 1024), (36, 3)):
            assert tflops.linear(n, din, dout) == jref.linear(n, din, dout)
    for args in ((2048 * 64, 4, 256, 4, False), (2048 * 32, 8, 1024, 4,
                                                 True), (100, 6, 64, 3, True)):
        assert tflops.scene_mlp(*args) == jref.scene_mlp(*args)
    for n in (1, 262144):
        assert tflops.human_mlps(n, 2 * n) == jref.human_mlps(n, 2 * n)
    assert tflops.vol_decoder() == jref.vol_decoder()
    for n, res in ((4, 32), (1, 224), (3, 17)):
        assert tflops.lpips_vgg(n, res) == jref.lpips_vgg(n, res)
    jref.main()
    ref = capsys.readouterr().out.splitlines()
    assert tflops.main(["--device", "cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if not ln.startswith(("device:", "  (A100 lines"))]
    assert got == ref
    fwd, total = tflops.step_flops()
    assert f"fwd {fwd/1e12:.3f} TFLOP, fwd+bwd {total/1e12:.3f}" in ref[0]


# ---------------------------------------------------------------------------
# pair counts
# ---------------------------------------------------------------------------

def test_pair_constants_and_points_match_jax(points):
    """TILE_PG, `_pg_pad_shapes`, and the port's production points and
    affines against the JAX tools' (f32 order only: 1e-5 of the scale)."""
    assert pc.TILE_PG == plbs.TILE_PG
    assert clbs.SORT_GROUP == plbs.SORT_GROUP
    assert clbs.SORT_CELLS == plbs.SORT_CELLS
    for b, g in ((26, 32), (26, 16), (24, 32), (28, 32), (3, 64)):
        assert pc.pg_pad_shapes(b, g) == plbs._pg_pad_shapes(b, g)
    pts, rg, tg, _ = pc.production_points(N_PATCHES, "cpu")
    for got, ref in ((pts, points["pts"]), (rg, points["rg"]),
                     (tg, points["tg"])):
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_support_and_morton_order_match_jax(points):
    """`_sample_support` on the same points (mismatches only at f32
    boundaries: at most 1e-4 of the pairs) and the Morton group order of
    `_group_sort_perm`, equal."""
    pts_p, n = plbs._pad_rows(jnp.asarray(points["pts"]), plbs.TILE_PG)
    rgp, tgp = _padded_tables(points)
    ref = np.asarray(plbs._sample_support(pts_p, rgp, tgp, G))[:, :B]
    got = clbs._sample_support(_t(pts_p), _t(points["rg"]), _t(points["tg"]),
                               G).numpy()
    assert (got != ref).mean() <= 1e-4
    perm = pc.rows_of(torch.argsort(clbs._morton_cells(_t(pts_p)),
                                    stable=True))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(plbs._group_sort_perm(pts_p)[0]))


def test_bench_density_matches_build_pairs(points):
    """bench_lbs_pg's density: the Morton order, `_build_pairs`' AABB
    predicate and `_compact_pairs`' count, at TILE_PG (JAX's pairs within
    DENSITY_TOL of the capacity)."""
    pts_p, _ = plbs._pad_rows(jnp.asarray(points["pts"]), plbs.TILE_PG)
    rgp, tgp = _padded_tables(points)
    ngb, bpd = plbs._pg_pad_shapes(B, G)
    perm, _ = plbs._group_sort_perm(pts_p)
    _, _, n_pairs = plbs._build_pairs(pts_p[perm], rgp, tgp, B, bpd, G)
    cap = (pts_p.shape[0] // plbs.TILE_PG) * (bpd // ngb)
    pairs, got_cap = pc.bench_density(_t(points["pts"]), _t(points["rg"]),
                                      _t(points["tg"]), G)
    gap = abs(pairs - int(n_pairs)) / cap
    assert got_cap == cap and gap <= DENSITY_TOL, (pairs, int(n_pairs), gap)


def _parse(pattern, text):
    return [m.groups() for m in re.finditer(pattern, text)]


def test_density_study_matches_the_jax_study(points, capsys):
    """pg_density_study at 1 patch against the JAX study's main() (its
    printed pair counts, which are exact integers) and its
    `sample_support` (the true density): every variant's density and the
    true density within DENSITY_TOL, the group signatures counted as JAX's
    np.unique counts them (within 1e-3 of the groups)."""
    jmod = _jax_tool("pg_density_study")
    jmod.N_PATCHES = N_PATCHES
    jmod.main()
    out = capsys.readouterr().out
    ref = {(name, mode): (int(p), int(c)) for name, mode, p, c in _parse(
        r"(\w+)\s+\+ (\w+)\s*:\s+(\d+)/(\d+)", out)}
    sigs, groups = map(int, _parse(
        r"distinct group signatures: (\d+) / (\d+)", out)[0])
    rgp, tgp = _padded_tables(points)
    true = float(jnp.mean(jmod.sample_support(
        jnp.asarray(points["pts"]), rgp, tgp)[:, :B]))
    res = tdensity.study(N_PATCHES, "cpu")
    assert set(ref) == {k for k in res if isinstance(k, tuple)}
    gaps = {k: abs(res[k][0] - ref[k][0]) / ref[k][1] for k in ref}
    assert all(res[k][1] == ref[k][1] for k in ref)
    assert max(gaps.values()) <= DENSITY_TOL, gaps
    assert abs(res["true density"] - true) <= DENSITY_TOL
    assert res["groups"] == groups
    assert abs(res["signatures"] - sigs) <= 1e-3 * groups
    # the orders differ as JAX's do: the signature sort packs tiles
    assert res["sig", "exact"][0] < res["morton", "exact"][0] \
        < res["morton", "aabb"][0]


def test_window_study_matches_the_jax_study(capsys):
    """pg_window_study at 1 patch against the JAX study's printed lines:
    alive pairs (exact integers, so their density) within DENSITY_TOL of
    the (tile, bone) pairs, each fit share within DENSITY_TOL (JAX prints
    them to 1e-4), the mean ranges within 0.05 + 1e-3 of a cell (JAX
    prints 0.1)."""
    jmod = _jax_tool("pg_window_study")
    jmod.N_PATCHES = N_PATCHES
    jmod.main()
    out = capsys.readouterr().out
    res = twindow.study(N_PATCHES, "cpu")
    blocks = out.split("--- ")[1:]
    assert [b.split(":")[0] for b in blocks] == list(twindow.ORDERS)
    for block in blocks:
        name = block.split(":")[0]
        got = res[name]
        alive = int(_parse(r"alive pairs=(\d+)", block)[0][0])
        n_pairs = alive / float(_parse(r"density ([\d.]+)", block)[0][0])
        assert abs(got["alive"] - alive) / n_pairs <= DENSITY_TOL
        for W, fx, fy, fz, both in _parse(
                r"W=\s*(\d+): fx fits ([\d.]+)%\s+fy ([\d.]+)%\s+fz "
                r"([\d.]+)%\s+fx&fz ([\d.]+)%", block):
            for g, r in zip(got[int(W)], (fx, fy, fz, both)):
                assert abs(g - float(r) / 100) <= DENSITY_TOL, (name, W)
        means = [float(v) for v in _parse(
            r"mean ranges fx=([\d.]+) fy=([\d.]+) fz=([\d.]+)", block)[0]]
        for g, r in zip(got["mean"], means):
            assert abs(g - r) <= 0.05 + 1e-3, (name, got["mean"], means)


def test_pair_count_quad_rule():
    """`n_pairs`: ceil(alive bones / NGB) quads a tile, at least one."""
    alive = torch.zeros(4, B, dtype=torch.bool)
    alive[1, :3] = True          # 1 quad
    alive[2, :5] = True          # 2 quads
    alive[3] = True              # 7 quads
    assert pc.n_pairs(alive, G) == 1 + 1 + 2 + 7
    assert pc.density(alive, G) == (11, 4 * 7)


# ---------------------------------------------------------------------------
# every new tool on the CPU
# ---------------------------------------------------------------------------

QUICK = ["--iters", "1", "--warmup", "0"]
TINY = ["--n_patches", "1", "--patch_size", "8"]
TOOL_RUNS = {
    "ref_flops": ([], ["reference stage-3 step (2048 rays)",
                       "A100 f32 @ MFU 100%"]),
    "bench_mlp": (["--n", "256"] + QUICK,
                  ["cnl fused fwd+bwd", "cnl module fwd+bwd",
                   "nr  fused fwd+bwd", "nr  module fwd+bwd"]),
    "bench_lbs": (["--n", "256"] + QUICK,
                  ["inverse fwd ", "inverse fwd+bwd", "shared fwd",
                   "shared+fwd_lbs fwd+bwd"]),
    "bench_deconv": (["--volume", "4"] + QUICK,
                     ["vol_decoder fwd+bwd [phase]",
                      "vol_decoder fwd+bwd [conv]"]),
    "bench_lbs_pg": (TINY + QUICK,
                     ["rays=64 samples=8192", "(TILE_PG=128)",
                      "(INV_TILE=1024)", "pallas_dense fwd ",
                      "pallas_dense fwd+bwd", "pallas fwd ",
                      "pallas fwd+bwd"]),
    "pg_density_study": (TINY, ["samples=8192", "true (sample,bone)",
                                "distinct group signatures",
                                "morton     + aabb", "mortonsig  + exact"]),
    "pg_window_study": (TINY, ["--- sig:", "--- sigmorton:", "W=24",
                               "mean ranges"]),
    "bench_all": (["--small"] + QUICK,
                  ['"stage": 1', '"stage": 2', '"stage": 3',
                   '"sec_per_step"', '"total_incl_compile"']),
}


@pytest.mark.parametrize("name", sorted(TOOL_RUNS))
def test_bench_tool_runs_on_the_cpu(name, capsys):
    """Each new tool with --device cpu at a tiny size: exit 0, its lines
    printed, every number finite."""
    extra, lines = TOOL_RUNS[name]
    mod = importlib.import_module(f"hosnerf_tpu_torch.tools.{name}")
    assert mod.main(extra + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "'kind': 'cpu'" in out or '"kind": "cpu"' in out
    for line in lines:
        assert line in out, (line, out)
    assert "nan" not in out.lower() and "inf" not in out.lower()
