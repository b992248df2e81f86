"""The hand-written CUDA kernels against their plain versions on the card.

CUDA kernels have no CPU mode, so every test here is marked `cuda` and
skips (inside the `dev` fixture) where torch sees no CUDA device. This
file imports no JAX, so it also runs where JAX is not installed; there,
skip the repo conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.models.human import HumanObjectField
from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
from hosnerf_tpu_torch.tools import blend_bwd_f64
from hosnerf_tpu_torch.utils import card

# shared with tests/test_torch_kernels.py (which holds the plain versions
# against JAX); this file imports no JAX so it runs where JAX is absent
WIDTH = 32

SPECS = {
    # NonRigidMLP (models/human.py::_nr_apply): hannw PE, streamed 75-d
    # condition first, skip [h, embed] before layer 4, 3 outputs
    "nonrigid": dict(kind="hannw", multires=6, aux_mode="stream",
                     aux_first=True, skip_before=4, skip_source="embed",
                     A=75, depth=6, out=3, alpha=3.3),
    # CanonicalMLP: fourier PE, broadcast 64-d state row, skip
    # [input, h] before layer 5, 4 outputs
    "canonical": dict(kind="fourier", multires=10, aux_mode="broadcast",
                      aux_first=False, skip_before=5,
                      skip_source="full_input", A=64, depth=8, out=4,
                      alpha=None),
}


def mlp_case(name, seed=0, n=2048, width=WIDTH):
    """Numpy inputs and flax-oriented ([din, dout]) weights for a spec."""
    sp = SPECS[name]
    rng = np.random.default_rng(seed)
    espec = cmlp.EmbedSpec(sp["kind"], sp["multires"], sp["A"],
                           sp["aux_mode"], sp["aux_first"])
    ex = espec.ex_width

    def dense(din, dout):
        s = np.sqrt(6.0 / (din + dout))
        return (rng.uniform(-s, s, (din, dout)).astype(np.float32),
                rng.uniform(-0.1, 0.1, (dout,)).astype(np.float32))

    layers = []
    for i in range(sp["depth"]):
        if i == 0:
            din = sp["A"] + ex
        elif i == sp["skip_before"]:
            din = width + (ex if sp["skip_source"] == "embed"
                           else ex + sp["A"])
        else:
            din = width
        layers.append(dense(din, width))
    out = dense(width, sp["out"])
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    aux_shape = (n, sp["A"]) if sp["aux_mode"] == "stream" else (sp["A"],)
    aux = rng.normal(size=aux_shape).astype(np.float32)
    kw = {k: sp[k] for k in ("kind", "multires", "aux_mode", "aux_first",
                             "skip_before", "skip_source")}
    return x, aux, sp["alpha"], layers, out, kw


def torch_args(layers, out):
    return ([(torch.from_numpy(w.T.copy()), torch.from_numpy(b))
             for w, b in layers],
            (torch.from_numpy(out[0].T.copy()), torch.from_numpy(out[1])))


pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    card.configure()
    return torch.device("cuda")


def _poison(nbytes: int, device) -> None:
    """Fill then free a large block, so the next allocations reuse
    NaN-filled memory (what a missed write would leave behind)."""
    torch.full((nbytes // 4,), float("nan"), device=device)


@pytest.fixture(scope="module")
def lbs_inputs(dev):
    G, B, S = 32, 26, 64
    nb = synthetic.human_batch(4, 16, grid_size=G)
    b = {k: torch.as_tensor(v, device=dev) for k, v in nb.items()}
    model = HumanObjectField(mweight_volume_size=G, device=dev)
    from hosnerf_tpu_torch.core import body
    m_sR, m_T, _, _ = body.motion_bases(b["dst_Rs"], b["dst_Ts"],
                                        b["cnl_gtfms"])
    with torch.no_grad():
        vol = model.mweight_vol_decoder(b["motion_weights_priors"])
    _, _, rg, tg, vol_qz = clbs.grid_tables(
        m_sR, m_T, vol, b["cnl_bbox_min_xyz"], b["cnl_bbox_scale_xyz"])
    z = b["near"] + (b["far"] - b["near"]) * torch.linspace(
        0, 1, S, device=dev)[None]
    pts = (b["rays_o"][:, None] + b["rays_d"][:, None] * z[..., None]
           ).reshape(-1, 3)
    dom = clbs.bp_prepare(pts, rg, tg, G, B)
    return dom.sort_rows(pts), rg, tg, vol_qz, dom


@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_inverse_kernel_matches_plain(lbs_inputs, prec):
    """Same arithmetic in the same order with round-to-nearest intrinsics:
    the kernel agrees with the plain version to 1e-6 of the scale."""
    pts_s, rg, tg, vol_qz, dom = lbs_inputs
    ref = clbs.inverse_core_plain(pts_s, rg, tg, vol_qz, prec)
    _poison(64 << 20, pts_s.device)
    n0 = clbs.inverse_core_pg_s.launches
    got = clbs.inverse_core_pg_s(pts_s, rg, tg, vol_qz, prec)
    torch.cuda.synchronize()
    assert clbs.inverse_core_pg_s.launches == n0 + 1
    assert torch.isfinite(got).all()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-6 * scale
    dead = int(dom.n_dead_groups) * clbs.SORT_GROUP
    assert dead > 0 and float(got[:dead].abs().max()) == 0.0


@pytest.mark.parametrize("k0", [0, 1, 10 ** 6])
@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("name,width", [("nonrigid", 128),
                                        ("canonical", 256),
                                        ("canonical", 32)])
def test_embed_trunk_kernel_matches_plain(dev, name, width, prec, k0):
    n = 3000                                   # ragged last block
    x, aux, alpha, layers, out, kw = mlp_case(name, n=n, width=width)
    tl, to = torch_args(layers, out)
    tl = [(w.to(dev), b.to(dev)) for w, b in tl]
    to = (to[0].to(dev), to[1].to(dev))
    xt, at = torch.from_numpy(x).to(dev), torch.from_numpy(aux).to(dev)
    espec = cmlp.EmbedSpec(kw["kind"], kw["multires"], aux.shape[-1],
                           kw["aux_mode"], kw["aux_first"])
    ref = cmlp.fused_embed_trunk_plain(
        xt, at, alpha, tl, to, espec=espec, skip_before=kw["skip_before"],
        skip_source=kw["skip_source"], precision=prec)
    _poison(64 << 20, dev)
    got = cmlp.fused_embed_trunk(xt, at, alpha, tl, to, precision=prec,
                                 k0_blocks=torch.tensor([k0], device=dev),
                                 **kw)
    torch.cuda.synchronize()
    first = min(k0, math.ceil(n / 1024) - 1) * 1024
    g, r = got[first:], ref[first:]
    assert torch.isfinite(g).all()
    scale = float(r.abs().max())
    err = (g - r).abs()
    tol = 1e-2 if prec == "bf16" else 1e-5
    assert float(err.max()) <= tol * scale
    assert float((err > 1e-3 * scale).float().mean()) <= 0.05


def _close(got, ref, tol: float, what: str, max_tol=None) -> None:
    """Max error relative to the reference's scale (max_tol, default
    tol), and relative L2 error (tol)."""
    assert torch.isfinite(got).all(), what
    scale = float(ref.abs().max()) + 1e-30
    err = float((got - ref).abs().max())
    l2 = float(torch.linalg.norm(got - ref) / (torch.linalg.norm(ref)
                                                + 1e-30))
    max_tol = tol if max_tol is None else max_tol
    assert err <= max_tol * scale and l2 <= tol, (what, err, scale, l2)


@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_inverse_bwd_kernel_matches_plain(lbs_inputs, prec):
    """B4 vs its plain version: the same rounding points; the sums over
    samples (dvol, drg, dtg) come in another order (dvol in fixed point)
    -> 1e-4 of the scale."""
    pts_s, rg, tg, vol_qz, dom = lbs_inputs
    g = torch.randn(pts_s.shape[0], 4, device=pts_s.device,
                    generator=torch.Generator(pts_s.device).manual_seed(1))
    ref = clbs.inverse_core_bwd_plain(pts_s, rg, tg, vol_qz, g, prec)
    _poison(64 << 20, pts_s.device)
    n0 = clbs.inverse_core_bwd.launches
    got = clbs.inverse_core_bwd(pts_s, rg, tg, vol_qz, g, prec)
    torch.cuda.synchronize()
    assert clbs.inverse_core_bwd.launches == n0 + 1
    for name, a, b in zip(("dpts", "drg", "dtg", "dvol"), got, ref):
        _close(a, b, 1e-4, name)
    dead = int(dom.n_dead_groups) * clbs.SORT_GROUP
    assert float(got[0][:dead].abs().max()) == 0.0


@pytest.mark.parametrize("k0", [0, 2, 10 ** 6])
@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_shared_blend_kernels_match_plain(lbs_inputs, prec, k0):
    """B5 forward and backward vs their plain versions on the sorted
    samples as grid points: forward to 1e-5 of the scale (blend sums in
    another order); backward 1e-4 (sums over samples in another order,
    dvol in fixed point), dpts rows below the clamped k0 * 512 exactly
    0."""
    pts_s, rg, tg, vol_qz, _ = lbs_inputs
    dev = pts_s.device
    G, B = 32, 26
    gen = torch.Generator(dev).manual_seed(2)
    vol_all = vol_qz.reshape(B, G, G, G).permute(2, 1, 0, 3).reshape(
        G * G, B * G).contiguous()
    rmat = torch.randn(B, 24, device=dev, generator=gen) * 0.1
    pts_g = (pts_s @ rg[3].reshape(3, 3).T + tg[3]).contiguous()
    n = pts_g.shape[0]
    first = clbs.first_live_row(k0, n, clbs.TILE_SH)
    k0_t = torch.tensor([k0], device=dev, dtype=torch.int32)
    ref = clbs.shared_blend_plain(pts_g, vol_all, rmat, prec)
    _poison(64 << 20, dev)
    got = clbs.shared_blend_fwd(pts_g, vol_all, rmat, k0_t, prec)
    torch.cuda.synchronize()
    _close(got[first:], ref[first:], 1e-5, "fwd")
    gout = torch.randn(n, 7, device=dev, generator=gen)
    ref = clbs.shared_blend_bwd_plain(pts_g, vol_all, rmat, k0_t, gout, prec)
    _poison(64 << 20, dev)
    got = clbs.shared_blend_bwd(pts_g, vol_all, rmat, k0_t, gout, prec)
    torch.cuda.synchronize()
    for name, a, b in zip(("dpts", "dvol", "drmat"), got, ref):
        _close(a, b, 1e-4, name)
    assert first == 0 or float(got[0][:first].abs().max()) == 0.0


@pytest.mark.parametrize("k0", [0, 1, 10 ** 6])
@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("name,width", [("nonrigid", 128),
                                        ("canonical", 256),
                                        ("canonical", 32)])
def test_embed_trunk_bwd_kernel_matches_plain(dev, name, width, prec, k0):
    """B3 vs its plain version, relative L2 error and max error relative
    to the scale. highest: f32 sums in another order (~1e-6), but among
    ~6e6 pre-activations one may sit within f32 noise of 0 and flip its
    ReLU mask, which moves that row's entries -> 2e-3 L2, 1e-2 max. bf16:
    the same rounding points, but a flipped bf16 rounding of an activation
    or of gc (2^-9) moves single entries, and the fourier PE multiplies
    dx by up to 2^9 (measured on the H100: dx 7e-2 of its max, 1e-2 L2)
    -> 2e-2 L2, 1e-1 max. dx and stream daux rows below the clamped
    k0 * 1024 are exactly 0."""
    n = 3000
    x, aux, alpha, layers, out, kw = mlp_case(name, n=n, width=width)
    tl, to = torch_args(layers, out)
    tl = [(w.to(dev), b.to(dev)) for w, b in tl]
    to = (to[0].to(dev), to[1].to(dev))
    xt, at = torch.from_numpy(x).to(dev), torch.from_numpy(aux).to(dev)
    gout = torch.randn(n, to[0].shape[0], device=dev,
                       generator=torch.Generator(dev).manual_seed(3))
    k0_t = torch.tensor([k0], device=dev, dtype=torch.int32)
    ref = cmlp.fused_embed_trunk_bwd(xt.cpu(), at.cpu(), alpha,
                                     [(w.cpu(), b.cpu()) for w, b in tl],
                                     (to[0].cpu(), to[1].cpu()), gout.cpu(),
                                     precision=prec, k0_blocks=k0, **kw)
    _poison(256 << 20, dev)
    n0 = cmlp.fused_embed_trunk_bwd.launches
    got = cmlp.fused_embed_trunk_bwd(xt, at, alpha, tl, to, gout,
                                     precision=prec, k0_blocks=k0_t, **kw)
    torch.cuda.synchronize()
    assert cmlp.fused_embed_trunk_bwd.launches == n0 + 1
    tol, max_tol = (2e-2, 1e-1) if prec == "bf16" else (2e-3, 1e-2)
    flat_g = [got[0], got[1]] + [t for p in got[2] for t in p] + list(got[3])
    flat_r = [ref[0], ref[1]] + [t for p in ref[2] for t in p] + list(ref[3])
    for i, (a, b) in enumerate(zip(flat_g, flat_r)):
        _close(a.cpu(), b, tol, f"output {i}", max_tol)
    first = min(k0, math.ceil(n / 1024) - 1) * 1024
    assert first == 0 or float(got[0][:first].abs().max()) == 0.0
    if kw["aux_mode"] == "stream" and first:
        assert float(got[1][:first].abs().max()) == 0.0


@pytest.mark.parametrize("k0", [0, 7, 10 ** 6])
@pytest.mark.parametrize("n", [1000, 262143])
@pytest.mark.parametrize("name,width", [("nonrigid", 32),
                                        ("nonrigid", 256),
                                        ("canonical", 128)])
@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_trunk_bf16_kernels_ragged(dev, prec, name, width, n, k0):
    """The wgmma kernels (B2 forward, B3 backward; bf16, and f32 on bf16x3
    pieces) against the plain versions run on the card, at ragged row
    counts (1,000 rows: one partial tile; 262,143: the training shapes
    less one row), k0 at 0, at a live block (7, clamped to 0 for 1,000
    rows) and at the all-dead clamp, on NaN-poisoned outputs, with the
    tolerances of the tests above for the forward (1e-2 of the scale in
    bf16, 1e-5 in f32) and chip_smoke.py's for B3 at these row counts:
    bf16 relative L2 2e-2, and at most 0.1% of entries beyond 1e-1 of the
    scale (one flipped bf16 rounding of gc moves a whole row of dx or
    daux; 262,143 x 75 entries hold a few such rows); f32 2e-3 and 1e-2
    (a ReLU mask flipped by f32 noise moves its row)."""
    bf16 = prec == "bf16"
    x, aux, alpha, layers, out, kw = mlp_case(name, seed=5, n=n, width=width)
    tl, to = torch_args(layers, out)
    tl = [(w.to(dev), b.to(dev)) for w, b in tl]
    to = (to[0].to(dev), to[1].to(dev))
    xt, at = torch.from_numpy(x).to(dev), torch.from_numpy(aux).to(dev)
    espec = cmlp.EmbedSpec(kw["kind"], kw["multires"], aux.shape[-1],
                           kw["aux_mode"], kw["aux_first"])
    first = min(k0, math.ceil(n / 1024) - 1) * 1024
    ref = cmlp.fused_embed_trunk_plain(
        xt, at, alpha, tl, to, espec=espec, skip_before=kw["skip_before"],
        skip_source=kw["skip_source"], precision=prec)
    _poison(512 << 20, dev)
    got = cmlp.fused_embed_trunk(xt, at, alpha, tl, to, precision=prec,
                                 k0_blocks=k0, **kw)
    torch.cuda.synchronize()
    g, r = got[first:], ref[first:]
    assert torch.isfinite(g).all()
    scale = float(r.abs().max())
    err = (g - r).abs()
    assert float(err.max()) <= (1e-2 if bf16 else 1e-5) * scale
    assert float((err > 1e-3 * scale).float().mean()) <= 0.05
    gout = torch.randn(n, to[0].shape[0], device=dev,
                       generator=torch.Generator(dev).manual_seed(6))
    dref = cmlp.fused_embed_trunk_bwd_plain(
        xt, at, alpha, tl, to, gout, espec=espec,
        skip_before=kw["skip_before"], skip_source=kw["skip_source"],
        precision=prec, k0_blocks=k0)
    _poison(1 << 30, dev)
    dgot = cmlp.fused_embed_trunk_bwd(xt, at, alpha, tl, to, gout,
                                      precision=prec, k0_blocks=k0, **kw)
    torch.cuda.synchronize()
    flat_g = [dgot[0], dgot[1]] + [t for p in dgot[2] for t in p] + \
        list(dgot[3])
    flat_r = [dref[0], dref[1]] + [t for p in dref[2] for t in p] + \
        list(dref[3])
    for i, (a, b) in enumerate(zip(flat_g, flat_r)):
        assert torch.isfinite(a).all(), i
        scale = float(b.abs().max()) + 1e-30
        l2 = float(torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-30))
        beyond = float(((a - b).abs() > (1e-1 if bf16 else 1e-2) * scale)
                       .float().mean())
        assert l2 <= (2e-2 if bf16 else 2e-3) and beyond <= 1e-3, \
            (i, l2, beyond)
    assert first == 0 or float(dgot[0][:first].abs().max()) == 0.0


def test_f32_trunk_kernels_run_on_tensor_cores(dev):
    """The f32 ("highest") trunk kernels as built do their products with
    wgmma: the SASS of each (forward, recompute, rows, dW) holds HGMMA,
    and no FMA-tile f32 trunk kernel is left in the libraries."""
    import shutil
    import subprocess

    from hosnerf_tpu_torch.ops.cuda import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not shutil.which(tool):
        pytest.skip("needs cuobjdump from the CUDA toolkit")
    seen = set()
    for lib in ("embed_trunk", "embed_trunk_bwd"):
        _build.load(lib)
        sass = subprocess.run([tool, "-sass", str(_build.target_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for fn in sass.split("Function : ")[1:]:
            name = fn.split(None, 1)[0]
            assert "_f32" not in name, name
            for kernel in ("embed_trunk_x3", "rows_bwd_x3", "dw_x3"):
                if kernel in name:
                    assert "HGMMA" in fn, name
                    seen.add(kernel)
    assert seen == {"embed_trunk_x3", "rows_bwd_x3", "dw_x3"}


def test_autograd_routes_through_kernels(dev):
    """A backward through the differentiable entries launches B1+B4, B2+B3
    and B5 fwd+bwd, and no plain version."""
    G, B = 8, 5
    gen = torch.Generator(dev).manual_seed(4)
    pts = torch.rand(2048, 3, device=dev, generator=gen) * (G - 1)
    rg = torch.eye(3, device=dev).reshape(1, 9).repeat(B, 1).requires_grad_()
    tg = torch.zeros(B, 3, device=dev, requires_grad=True)
    vol = torch.rand(B, G * G, G, device=dev, generator=gen,
                     requires_grad=True)
    counts = lambda: (clbs.inverse_core_pg_s.launches,  # noqa: E731
                      clbs.inverse_core_bwd.launches,
                      clbs.shared_blend_fwd.launches,
                      clbs.shared_blend_bwd.launches,
                      cmlp.fused_embed_trunk.launches,
                      cmlp.fused_embed_trunk_bwd.launches)
    before = counts()
    acc = clbs.inverse_core_pg_s(pts, rg, tg, vol)
    x, aux, alpha, layers, out, kw = mlp_case("nonrigid", n=2048, width=32)
    tl, to = torch_args(layers, out)
    tl = [(w.to(dev).requires_grad_(), b.to(dev)) for w, b in tl]
    y = cmlp.fused_embed_trunk(acc[:, :3].contiguous(),
                               torch.from_numpy(aux).to(dev), alpha, tl,
                               (to[0].to(dev), to[1].to(dev)), **kw)
    vol_all = vol.reshape(B, G, G, G).permute(1, 2, 0, 3).reshape(G * G,
                                                                  B * G)
    z = clbs.shared_blend_core(y.contiguous() + 3.0, vol_all.contiguous(),
                               torch.randn(B, 24, device=dev, generator=gen))
    z.square().sum().backward()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1] * 6
    for t in (rg, tg, vol, tl[0][0]):
        assert t.grad is not None and torch.isfinite(t.grad).all()


# ---------------------------------------------------------------------------
# the dense slice: the four inverse-LBS entries, rows 7, 8 and 12
# ---------------------------------------------------------------------------

INVERSE_ENTRIES = ("inverse_core", "inverse_core_pg", "inverse_core_pgw",
                   "inverse_core_bp")


@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_inverse_entries_match_plain(lbs_inputs, prec):
    """The four inverse cores on the unsorted points (rows as given,
    Morton, signature + Morton, signature order; row 9 is
    `inverse_core_pg`'s Morton route, its default 'sig' route being row
    1's), each one B1 launch through its own count: bit-identical to each other (one per-sample
    computation) and within 1e-6 of the scale of the plain version (B1's
    tolerance), on NaN-poisoned outputs; the backward (B4) to 1e-4 of
    each gradient's scale (sums over samples in another order)."""
    pts_s, rg, tg, vol_qz, dom = lbs_inputs
    pts = dom.unsort(pts_s).contiguous()
    ref = clbs.inverse_core_plain(pts, rg, tg, vol_qz, prec)
    gacc = torch.randn(pts.shape[0], 4, device=pts.device,
                       generator=torch.Generator(pts.device).manual_seed(8))
    dref = clbs.inverse_core_bwd_plain(pts, rg, tg, vol_qz, gacc, prec)
    first = None
    for name in INVERSE_ENTRIES:
        entry = getattr(clbs, name)
        _poison(64 << 20, pts.device)
        n0 = entry.launches
        args = [t.clone().requires_grad_() for t in (pts, rg, tg, vol_qz)]
        kw = {"pg_sort": "morton"} if name == "inverse_core_pg" else {}
        got = entry(*args, prec, **kw)
        torch.cuda.synchronize()
        assert entry.launches == n0 + 1, name
        first = got.detach() if first is None else first
        assert torch.equal(got, first), name
        _close(got.detach(), ref, 1e-6, name)
        got.backward(gacc)
        for what, a, b in zip(("dpts", "drg", "dtg", "dvol"), args, dref):
            _close(a.grad, b, 1e-4, f"{name} {what}")


# B1/B4 edge cases: (n, B, G, kind, k0). kind "mixed": samples in, around
# and far off every bone's grid; "faces": samples at and just past each
# face of bone 0's support box f in (-1 - PG_EPS, G + PG_EPS); "sorted":
# the mixed samples with a far-off third, through bp_prepare, so that the
# domain's k0 (k0 None here) skips a dead prefix. k0 10**6 is the
# all-dead clamp: only the last INV_TILE block is computed.
INV_CASES = {
    "n0": (0, 26, 32, "mixed", 0),
    "n1000": (1_000, 26, 32, "mixed", 0),
    "n262143": (262_143, 26, 32, "mixed", 0),
    "n262143_clamped": (262_143, 26, 32, "mixed", 10 ** 6),
    "sorted_k0": (40_000, 26, 32, "sorted", None),
    "faces": (3_000, 26, 32, "faces", 0),
    "B1_G16": (5_000, 1, 16, "mixed", 0),
    "B32_G32": (5_000, 32, 32, "mixed", 3),
    "B26_G16": (5_000, 26, 16, "sorted", None),
}


def _inverse_case(dev, n, B, G, kind, seed=0):
    """(pts, rg, tg, vol_qz, gacc, k0 of a sorted case or None)."""
    gen = torch.Generator(dev).manual_seed(seed)
    R = (torch.eye(3, device=dev)[None] * (0.8 + 0.4 * torch.rand(
        B, 1, 1, device=dev, generator=gen))
        + 0.1 * torch.randn(B, 3, 3, device=dev, generator=gen))
    t = 4.0 * torch.rand(B, 3, device=dev, generator=gen) - 2.0
    vol_qz = 2.0 * torch.rand(B, G * G, G, device=dev, generator=gen) - 0.5
    pts = -3.0 + (G + 5.0) * torch.rand(n, 3, device=dev, generator=gen)
    pts[::9] += 60.0
    if kind == "faces":
        eps = clbs.PG_EPS
        vals = torch.tensor([-1.0 - 2 * eps, -1.0 - eps / 2, -1.0, 0.0,
                             G - 1.0, G - 1e-3, float(G), G + eps / 2,
                             G + 2 * eps], device=dev)
        f = torch.full((n, 3), G / 2.0 + 0.3, device=dev)
        axis = torch.arange(n, device=dev) % 3
        f[torch.arange(n, device=dev), axis] = vals[
            torch.arange(n, device=dev) // 3 % len(vals)]
        pts = torch.linalg.solve(R[0], (f - t[0]).T).T
    k0 = None
    if kind == "sorted":
        pts[: n // 3] += 90.0
        dom = clbs.bp_prepare(pts, R.reshape(B, 9), t, G, B)
        pts = dom.sort_rows(pts)
        k0 = dom.k0_for(clbs.INV_TILE)
        assert int(k0) >= 1
    gacc = torch.randn(pts.shape[0], 4, device=dev, generator=gen)
    gacc[::4] = 0.0
    return (pts.contiguous(), R.reshape(B, 9).contiguous(), t.contiguous(),
            vol_qz, gacc, k0)


@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("case", sorted(INV_CASES))
def test_inverse_kernels_edge_cases(dev, case, prec):
    """B1 and B4 vs their plain versions on NaN-poisoned outputs: B1 bit
    for bit on the rows from the clamped k0 * INV_TILE on, the rows below
    exactly 0; B4 (dpts from there on, the sums over those rows) at
    chip_smoke's tolerances (relative L2 1e-4, max 1e-4 of the scale in
    f32, 1e-2 in bf16), its dpts rows below exactly 0. One launch count
    per entry call."""
    n, B, G, kind, k0 = INV_CASES[case]
    pts, rg, tg, vol_qz, gacc, dom_k0 = _inverse_case(dev, n, B, G, kind)
    k0 = dom_k0 if k0 is None else torch.tensor([k0], device=dev,
                                                dtype=torch.int32)
    n = pts.shape[0]
    first = clbs.first_live_row(int(k0), n, clbs.INV_TILE) if n else 0
    counts = lambda: (clbs.inverse_core_pg_s.launches,  # noqa: E731
                      clbs.inverse_core_bwd.launches)
    before = counts()
    ref = clbs.inverse_core_plain(pts, rg, tg, vol_qz, prec)
    _poison(64 << 20, dev)
    got = clbs.inverse_core_pg_s(pts, rg, tg, vol_qz, prec, k0_blocks=k0)
    torch.cuda.synchronize()
    assert got.shape == (n, 4) and torch.isfinite(got).all()
    assert not got[:first].any()
    assert torch.equal(got[first:], ref[first:])
    if kind == "sorted":
        assert torch.equal(got, ref)           # the skipped rows are dead
    dref = clbs.inverse_core_bwd_plain(pts[first:], rg, tg, vol_qz,
                                       gacc[first:], prec)
    _poison(64 << 20, dev)
    dgot = clbs.inverse_core_bwd(pts, rg, tg, vol_qz, gacc, prec, k0=k0)
    torch.cuda.synchronize()
    assert not dgot[0][:first].any()
    max_tol = 1e-2 if prec == "bf16" else 1e-4
    for what, a, b in zip(("dpts", "drg", "dtg", "dvol"),
                          (dgot[0][first:],) + tuple(dgot[1:]), dref):
        if n == 0:
            assert a.shape == b.shape and not a.any(), what
        else:
            _close(a, b, 1e-4, what, max_tol)
    assert [a - b for a, b in zip(counts(), before)] == [1, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_inverse_image_matches_plain(dev, prec, dtype):
    """The inverse kernels' corner image, built in one launch, equals
    `inverse_image_plain` bit for bit."""
    vol_qz = torch.randn(26, 32 * 32, 32, device=dev,
                         generator=torch.Generator(dev).manual_seed(9))
    vol_qz = vol_qz.to(dtype)
    got = clbs.inverse_image(vol_qz, prec)
    ref = clbs.inverse_image_plain(vol_qz, prec).reshape(-1)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_shared_core_kernels_match_plain(lbs_inputs, prec):
    """Row 7 forward (one thread per (sample, bone)) to 1e-6 of the scale
    (the plain version's order; nothing sums across samples) and
    backward to 1e-4 (dvol in fixed point), NaN-poisoned outputs."""
    pts_s, rg, tg, vol_qz, _ = lbs_inputs
    dev = pts_s.device
    G, B = 32, 26
    vol_all = vol_qz.reshape(B, G, G, G).permute(2, 1, 0, 3).reshape(
        G * G, B * G).contiguous()
    pts_g = (pts_s @ rg[5].reshape(3, 3).T + tg[5]).contiguous()
    ref = clbs.shared_core_plain(pts_g, vol_all, prec)
    _poison(64 << 20, dev)
    got = clbs.shared_core_fwd(pts_g, vol_all, prec)
    torch.cuda.synchronize()
    _close(got, ref, 1e-6, "fwd")
    assert float(ref.max()) > 0.1
    gw = torch.randn(ref.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(9))
    dref = clbs.shared_core_bwd_plain(pts_g, vol_all, gw, prec)
    _poison(64 << 20, dev)
    n0 = clbs.shared_core_bwd.launches
    dgot = clbs.shared_core_bwd(pts_g, vol_all, gw, prec)
    torch.cuda.synchronize()
    assert clbs.shared_core_bwd.launches == n0 + 1
    for what, a, b in zip(("dpts", "dvol"), dgot, dref):
        _close(a, b, 1e-4, what)


# Edge cases of the shared-tap kernels (rows 5 and 7): (n, B, K, where the
# samples lie, k0[, G = 32]), shared with tools/blend_bwd_f64.py, which
# measures B5's backward on them against the contract in f64.
TAP_CASES = blend_bwd_f64.TAP_CASES
_tap_case = blend_bwd_f64.tap_case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prec", ["bf16", "highest"])
def test_shared_image_matches_plain(dev, prec, dtype):
    """The kernels' volume image, built in one launch, equals
    `shared_image_plain` bit for bit (a cast rounds to nearest, as
    `.to(torch.bfloat16)` does), bone slots past B zero."""
    G, B = 32, 26
    vol_all = torch.randn(G * G, B * G, device=dev,
                          generator=torch.Generator(dev).manual_seed(8))
    vol_all = vol_all.to(dtype)
    got = clbs.shared_image(vol_all, prec)
    ref = clbs.shared_image_plain(vol_all, prec).reshape(-1)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("case", sorted(TAP_CASES))
def test_shared_tap_kernels_edge_cases(dev, case, prec):
    """Rows 5 and 7 (forward and the binned backwards) vs their plain
    versions on edge cases, at chip_smoke.py's tolerances: row 7 forward
    1e-6 of the scale (the plain version's order), B5 forward 1e-5;
    backwards relative L2 1e-4 and max 1e-4 (highest) or 1e-2 (bf16) of
    the scale (sums over bones and samples in another order; in bf16 a
    gradient factor rounded apart by one ulp, see chip_smoke.TOL_BWD).
    One launch count per entry call; dpts rows below the clamped k0 * 512
    exactly 0.

    B5's gw = bf16(dw) once took dw = q rmat^T + g_w in f32, the kernel
    and the plain version (a cuBLAS matmul) each in its own order, so
    `B32_K1-bf16` and `G96-bf16` failed. Measured against the same
    contract in f64 (`tools/blend_bwd_f64.py`, H100, relative L2): in
    B32_K1 the kernel was the further side (dvol 1.0891e-4 against the
    plain version's 4.2172e-5, dpts 9.2064e-5 against 4.8858e-5; the two
    1.0041e-4 apart), in G96 the plain version (dpts 1.6116e-4 against the
    kernel's 8.3816e-8). So both sides now compute dw exactly (f64
    products and sums of its f32 inputs) and round it once, and the bound
    stays 1e-4."""
    n, B, K, kind, k0, *G = TAP_CASES[case]
    pts, vol_all, rmat, gout, gw = _tap_case(dev, n, B, K, kind, *G)
    first = clbs.first_live_row(k0, n, clbs.TILE_SH)
    k0_t = torch.tensor([k0], device=dev, dtype=torch.int32)
    bwd_tol = 1e-2 if prec == "bf16" else 1e-4
    counts = lambda: [f.launches for f in (  # noqa: E731
        clbs.shared_core_fwd, clbs.shared_core_bwd, clbs.shared_blend_fwd,
        clbs.shared_blend_bwd)]
    before = counts()

    ref = clbs.shared_core_plain(pts, vol_all, prec)
    _poison(64 << 20, dev)
    got = clbs.shared_core_fwd(pts, vol_all, prec)
    torch.cuda.synchronize()
    _close(got, ref, 1e-6, "weights fwd")
    dref = clbs.shared_core_bwd_plain(pts, vol_all, gw, prec)
    _poison(64 << 20, dev)
    dgot = clbs.shared_core_bwd(pts, vol_all, gw, prec)
    torch.cuda.synchronize()
    for what, a, b in zip(("dpts", "dvol"), dgot, dref):
        _close(a, b, 1e-4, f"weights bwd {what}", bwd_tol)

    ref = clbs.shared_blend_plain(pts, vol_all, rmat, prec)
    _poison(64 << 20, dev)
    got = clbs.shared_blend_fwd(pts, vol_all, rmat, k0_t, prec)
    torch.cuda.synchronize()
    if first < n:
        _close(got[first:], ref[first:], 1e-5, "blend fwd")
    dref = clbs.shared_blend_bwd_plain(pts, vol_all, rmat, k0_t, gout, prec)
    _poison(64 << 20, dev)
    dgot = clbs.shared_blend_bwd(pts, vol_all, rmat, k0_t, gout, prec)
    torch.cuda.synchronize()
    for what, a, b in zip(("dpts", "dvol", "drmat"), dgot, dref):
        _close(a, b, 1e-4, f"blend bwd {what}", bwd_tol)
    assert first == 0 or float(dgot[0][:first].abs().max()) == 0.0
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 1]
    if kind == "off":
        assert not dgot[1].any()


TRUNK_SPECS = {
    "canonical": (127, 256, 8, dict(skip_before=5, skip_order="input_first",
                                    skip_off=0, skip_width=127), 4),
    "nonrigid": (111, 128, 6, dict(skip_before=4, skip_order="h_first",
                                   skip_off=75, skip_width=36), 3),
}


def _trunk_weights(name, dev, seed=0):
    din, width, depth, kw, dout = TRUNK_SPECS[name]
    gen = torch.Generator().manual_seed(seed)
    layers, prev = [], din
    for i in range(depth):
        k = prev + (kw["skip_width"] if i == kw["skip_before"] else 0)
        layers.append(((torch.randn(width, k, generator=gen) / k ** 0.5).to(dev),
                       (torch.randn(width, generator=gen) * 0.1).to(dev)))
        prev = width
    out = ((torch.randn(dout, width, generator=gen) * 0.05).to(dev),
           (torch.randn(dout, generator=gen) * 0.01).to(dev))
    return din, layers, out, kw


@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("name", sorted(TRUNK_SPECS))
def test_fused_trunk_kernels_match_plain(dev, name, prec):
    """Row 8 (the trunk kernels on raw input rows) forward as B2 (bf16
    1e-2 of the scale and 5% of entries beyond 1e-3; f32 1e-5) and
    backward as B3 (relative L2 2e-2 / 2e-3, max 1e-1 / 1e-2 of the
    scale), dx the full input row including the skip slice, 3,000 rows
    (a ragged last tile), NaN-poisoned outputs."""
    n = 3000
    din, layers, out, kw = _trunk_weights(name, dev)
    x = torch.randn(n, din, device=dev,
                    generator=torch.Generator(dev).manual_seed(10))
    spec = cmlp.TrunkSpec(din, **kw)
    cpu = lambda ts: [t.cpu() for t in ts]  # noqa: E731
    ref = cmlp.fused_trunk_plain(x.cpu(), [cpu(p) for p in layers], cpu(out),
                                 spec=spec, precision=prec)
    _poison(64 << 20, dev)
    n0 = cmlp.fused_trunk.launches
    got = cmlp.fused_trunk(x, layers, out, precision=prec, **kw)
    torch.cuda.synchronize()
    assert cmlp.fused_trunk.launches == n0 + 1
    got = got.cpu()
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    assert torch.isfinite(got).all()
    assert float(err.max()) <= (1e-2 if prec == "bf16" else 1e-5) * scale
    assert float((err > 1e-3 * scale).float().mean()) <= 0.05
    gout = torch.randn(n, out[0].shape[0], device=dev,
                       generator=torch.Generator(dev).manual_seed(11))
    dref = cmlp.fused_trunk_bwd_plain(x.cpu(), [cpu(p) for p in layers],
                                      cpu(out), gout.cpu(), spec=spec,
                                      precision=prec)
    _poison(256 << 20, dev)
    dgot = cmlp.fused_trunk_bwd(x, layers, out, gout, precision=prec, **kw)
    torch.cuda.synchronize()
    tol, max_tol = (2e-2, 1e-1) if prec == "bf16" else (2e-3, 1e-2)
    flat_g = [dgot[0]] + [t for p in dgot[1] for t in p] + list(dgot[2])
    flat_r = [dref[0]] + [t for p in dref[1] for t in p] + list(dref[2])
    for i, (a, b) in enumerate(zip(flat_g, flat_r)):
        assert a.shape == b.shape, i
        _close(a.cpu(), b, tol, f"output {i}", max_tol)


def test_proto_pairgrid_kernel(dev):
    """Row 12 against its plain version and the numpy reference of the
    JAX script, full length and cut to 2 steps (the count a device
    tensor): out to 1e-5 of the scale, dvol exactly; rows of tiles that
    no counted step visits stay NaN (unwritten poisoned memory)."""
    from hosnerf_tpu_torch.tools import proto_pairgrid as pp
    pts, vol, ptile, pbone = pp.case()
    args = [torch.from_numpy(a).to(dev) for a in (ptile, pbone, pts, vol)]
    for n_pairs, written in ((7, pp.N_TILES), (2, 1)):
        ref, ref_dvol = pp.reference(pts, vol, n_pairs)
        # the output is small: poison blocks of its size (the caching
        # allocator serves blocks under 1 MB from a pool of their own)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        blocks = [torch.full((pp.N_TILES * pp.T * pp.G,), float("nan"),
                             device=dev) for _ in range(4)]
        del blocks
        n0 = pp.run.launches
        out, dvol = pp.run(torch.tensor([n_pairs], device=dev), *args,
                           pp.N_TILES)
        torch.cuda.synchronize()
        assert pp.run.launches == n0 + 1
        rows = written * pp.T
        _close(out[:rows].cpu(), torch.from_numpy(ref[:rows]), 1e-5, "out")
        assert torch.isnan(out[rows:]).all()
        assert torch.equal(dvol.cpu(), torch.from_numpy(ref_dvol))


# ---------------------------------------------------------------------------
# the stage-3 composed step
# ---------------------------------------------------------------------------

def _repeat_case(kernel, prec, k0, lbs_inputs):
    """fn() -> the backward's outputs for one kernel of
    test_backward_kernels_repeat_bit_for_bit."""
    dev = lbs_inputs[0].device
    gen = torch.Generator(dev).manual_seed(3)
    if kernel.startswith("b3"):
        name = kernel[3:]
        x, aux, alpha, layers, out, kw = mlp_case(
            name, n=40_000, width=256 if name == "canonical" else 128)
        tl, to = torch_args(layers, out)
        tl = [(w.to(dev), b.to(dev)) for w, b in tl]
        to = tuple(t.to(dev) for t in to)
        xt, at = torch.from_numpy(x).to(dev), torch.from_numpy(aux).to(dev)
        gout = torch.randn(x.shape[0], to[0].shape[0], device=dev,
                           generator=gen)
        k0_t = torch.tensor([k0], dtype=torch.int32, device=dev)
        return lambda: cmlp.fused_embed_trunk_bwd(
            xt, at, alpha, tl, to, gout, precision=prec, k0_blocks=k0_t,
            **kw)
    pts_s, rg, tg, vol_qz, dom = lbs_inputs
    if kernel == "b4":
        g = torch.randn(pts_s.shape[0], 4, device=dev, generator=gen)
        k0_t = torch.tensor([int(dom.k0_for(clbs.INV_TILE)) if k0 else 0],
                            dtype=torch.int32, device=dev)
        return lambda: clbs.inverse_core_bwd(pts_s, rg, tg, vol_qz, g, prec,
                                             k0=k0_t)
    G, B = 32, 26
    vol_all = vol_qz.reshape(B, G, G, G).permute(2, 1, 0, 3).reshape(
        G * G, B * G).contiguous()
    pts_g = (pts_s @ rg[3].reshape(3, 3).T + tg[3]).contiguous()
    n = pts_g.shape[0]
    if kernel == "row7":
        gw = torch.randn(n, B, device=dev, generator=gen)
        return lambda: clbs.shared_core_bwd(pts_g, vol_all, gw, prec)
    K = int(kernel[-1])
    rmat = torch.randn(B, 12 * K, device=dev, generator=gen) * 0.1
    gout = torch.randn(n, 3 * K + 1, device=dev, generator=gen)
    k0_t = torch.tensor([2 * k0], dtype=torch.int32, device=dev)
    return lambda: clbs.shared_blend_bwd(pts_g, vol_all, rmat, k0_t, gout,
                                         prec)


REPEAT_CASES = [(k, z) for k in ("b3_nonrigid", "b3_canonical", "b4",
                                  "b5_k1", "b5_k2") for z in (0, 1)] \
    + [("row7", 0)]


@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("kernel,k0", REPEAT_CASES)
def test_backward_kernels_repeat_bit_for_bit(lbs_inputs, kernel, k0, prec):
    """Every backward kernel, 5 calls on the same inputs, gives the same
    bits every time (torch.equal on every output): B3 (40,000 rows, so
    several rows-kernel CTAs and dW splits), B4, B5 with K = 1 and 2 at
    k0 = 0 and a live k0 (k0 = 1 marks it), row 7. Their sums over
    rows come in fixed orders: per-CTA slots summed in slot order, and
    dvol in fixed point."""
    from hosnerf_tpu_torch.train.checkpoints import state_diff
    fn = _repeat_case(kernel, prec, k0, lbs_inputs)
    first = fn()
    for _ in range(4):
        assert state_diff(first, fn()) == []


def test_stage3_step_on_the_card_repeats_bit_for_bit(dev):
    """Two steps of the stage-3 trainer (the small width of the test
    below, bf16 trunks, LPIPS on its random backbone) from one state and
    generator, run twice under `card.configure()`: every parameter
    and Adam moment equal bit for bit."""
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.train import checkpoints as ck
    from hosnerf_tpu_torch.train import stage3
    card.configure()
    cfg = stage3.Stage3Config(
        n_patches=1, patch_size=16, n_samples=32, cnl_mlp_width=32,
        nr_mlp_width=32, num_prop_samples=16, num_nerf_samples=8,
        nerf_netwidth=64, prop_netwidth=32, compute_dtype="bf16")
    nb = synthetic.composed_batch(1, 16, grid_size=cfg.mweight_volume_size)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in nb.items()}
    lp = lpips.load_weights(lpips.LPIPS(device=dev), quiet=True
                            ).requires_grad_(False)
    states = []
    for _ in range(2):
        scene, human, opt = stage3.init_state(cfg, seed=0, device=dev)
        step = stage3.make_train_step(cfg, scene, human, opt,
                                      lpips_apply=lp)
        gen = torch.Generator().manual_seed(4)
        for i in range(2):
            step(batch, 60_000 + i, gen)
        torch.cuda.synchronize()
        states.append(ck.pack_train_state({"scene": scene, "human": human},
                                          opt, 2, gen))
    assert ck.state_diff(*states) == []


def test_lpips_on_the_card_matches_the_cpu_under_configure(dev, capsys):
    """After `card.configure()` LPIPS (its random VGG16 backbone from seed
    0) of a fixed pair of 64 x 64 images on the card lies within 1e-5
    relative of the same LPIPS on the CPU: its f32 convolutions run in
    f32. The measurement then turns cuDNN's TF32 on for one more call, to
    print what a CLI run took before every entry point called
    configure(), and puts the setting back."""
    from hosnerf_tpu_torch.models import lpips
    rng = np.random.default_rng(11)
    x, y = (rng.uniform(-1.0, 1.0, (1, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    cpu = lpips.LPIPS(device="cpu")
    gpu = lpips.LPIPS(device=dev)
    with torch.no_grad():
        ref = float(cpu(torch.from_numpy(x), torch.from_numpy(y))[0])
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        card.configure()
        got = float(gpu(xd, yd)[0])
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = float(gpu(xd, yd)[0])
        finally:
            torch.backends.cudnn.allow_tf32 = False
    with capsys.disabled():
        print(f"\nLPIPS on the CPU {ref!r}; card under configure() {got!r} "
              f"(rel {abs(got - ref) / abs(ref):.3e}); card with TF32 "
              f"convolutions {tf32!r} (rel {abs(tf32 - ref) / abs(ref):.3e})")
    assert card.settings()["cudnn_allow_tf32"] is False
    assert abs(got - ref) <= 1e-5 * abs(ref)


def test_stage3_step_on_the_card_matches_cpu_plain_path(dev):
    """The stage-3 loss and backward at a small width (1 patch of 16 x 16
    rays, 32 human samples, scene 16/16/8 samples, widths 32-64, f32
    trunks, LPIPS on its random backbone) on the card's kernel path
    against the same sorted path on the plain versions on the CPU, same
    weights and batch: the loss within 1e-3 relative (the kernels'
    summation order and the bf16 taps it moves across rounding
    boundaries), and one loss evaluation plus its backward launches B1,
    B4, B5 forward and backward once each and B2, B3 four times each."""
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.models.state import state_index
    from hosnerf_tpu_torch.train import stage3
    cfg = stage3.Stage3Config(
        n_patches=1, patch_size=16, n_samples=32, cnl_mlp_width=32,
        nr_mlp_width=32, num_prop_samples=16, num_nerf_samples=8,
        nerf_netwidth=64, prop_netwidth=32, perturb=0.0, lbs_impl="pallas",
        mlp_impl="fused")
    nb = synthetic.composed_batch(1, 16, grid_size=cfg.mweight_volume_size)
    scene, human = stage3.make_models(cfg, device="cpu")
    sds = (scene.state_dict(), human.state_dict())
    wrappers = (clbs.inverse_core_pg_s, clbs.inverse_core_bwd,
                clbs.shared_blend_fwd, clbs.shared_blend_bwd,
                cmlp.fused_embed_trunk, cmlp.fused_embed_trunk_bwd)
    losses, launches = [], None
    for device in ("cpu", dev):
        sc, hu = stage3.make_models(cfg, device=device)
        sc.load_state_dict(sds[0], strict=True)
        hu.load_state_dict(sds[1], strict=True)
        batch = {k: torch.as_tensor(v, device=device) for k, v in nb.items()}
        lp = lpips.load_weights(lpips.LPIPS(device=device), quiet=True
                                ).requires_grad_(False)
        before = [w.launches for w in wrappers]
        total, _ = stage3.make_loss_fn(cfg, sc, hu, lp)(
            batch, 60_000, state_index(batch["time"], None))
        total.backward()
        if device != "cpu":
            torch.cuda.synchronize()
            launches = [w.launches - b for w, b in zip(wrappers, before)]
        losses.append(float(total.detach()))
        assert all(torch.isfinite(p.grad).all() for p in hu.parameters()
                   if p.grad is not None)
    assert launches == [1, 1, 1, 1, 4, 4]
    assert abs(losses[1] - losses[0]) <= 1e-3 * abs(losses[0]), losses


# ---------------------------------------------------------------------------
# the trainers fed by the host pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture(dev, tmp_path_factory):
    """A mini capture (16 frames of 64 x 64, one transition) written and
    loaded by the port, with its scaled-world cameras."""
    import os

    from hosnerf_tpu_torch.data import scene_loader
    root = str(tmp_path_factory.mktemp("capture"))
    synthetic.write_mini_dataset(os.path.join(root, "cap"), 16, 64)
    return root, scene_loader.load_nerf_360_v2(root, "cap")


def test_stage1_step_on_the_card(capture):
    """One stage-1 step (bf16 trunks, 1,024 jittered rays pooled from all
    train images, so that both states' rays are in the batch) on the
    card: every loss finite, and every parameter moved."""
    from hosnerf_tpu_torch.data import batches, scene_pipeline
    from hosnerf_tpu_torch.train import stage1
    _, scene = capture
    cfg = stage1.Stage1Config(num_prop_samples=16, num_nerf_samples=8,
                              nerf_netwidth=128, prop_netwidth=64,
                              num_states=2, compute_dtype="bf16")
    pipe = scene_pipeline.ScenePipeline(scene, 1024, seed=0,
                                        batch_sampler="all_images")
    batch = batches.to_device(pipe.sample_train_batch())
    assert batch["times"].min() < 0.5 < batch["times"].max()
    model, opt = stage1.init_state(cfg)
    before = [p.detach().clone() for p in model.parameters()]
    step = stage1.make_train_step(cfg, model, opt, [0.5])
    aux = step(batch, 100, torch.Generator(batch["rays_o"].device
                                           ).manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in aux.values()), aux
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))


def test_data_fed_stage2_step_on_the_card(capture):
    """One stage-2 step on a HumanDataset train item moved by to_device
    (1 patch of 16 x 16 rays, 32 samples, widths 32): finite losses, and
    B1, B4, B5 forward and backward launched once each and B2, B3 four
    times each, as on the synthetic batch."""
    import os

    from hosnerf_tpu_torch.data import batches, human_dataset
    from hosnerf_tpu_torch.train import stage2
    root, _ = capture
    ds = human_dataset.HumanDataset(os.path.join(root, "cap"), n_patches=1,
                                    patch_size=16)
    cfg = stage2.Stage2Config(n_patches=1, patch_size=16, n_samples=32,
                              cnl_mlp_width=32, nr_mlp_width=32,
                              num_states=len(ds.transitions) + 1,
                              lbs_impl="pallas", mlp_impl="fused")
    model, opt = stage2.init_state(cfg)
    step = stage2.make_train_step(cfg, model, opt, ds.transitions)
    wrappers = (clbs.inverse_core_pg_s, clbs.inverse_core_bwd,
                clbs.shared_blend_fwd, clbs.shared_blend_bwd,
                cmlp.fused_embed_trunk, cmlp.fused_embed_trunk_bwd)
    before = [w.launches for w in wrappers]
    losses = step(batches.to_device(ds[1]), 60_000,
                  torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        1, 1, 1, 1, 4, 4]
    assert all(bool(torch.isfinite(v)) for v in losses.values()), losses


def test_spans_count_the_card_waits(dev):
    """Under a CUDA-only profiler the spans count a synchronising call
    (with its line), a cudaMalloc and a cudaFree, map the top-level span's
    end onto the host clock behind a busy card, launch deltas reach the
    kernel entry's span, and the sync debug mode is restored after."""
    from torch.profiler import ProfilerActivity, profile

    from hosnerf_tpu_torch.utils import spans
    x = torch.randn(1000, device=dev)
    G, B = 8, 5
    pts = torch.rand(2048, 3, device=dev) * (G - 1)
    rg = torch.eye(3, device=dev).reshape(1, 9).repeat(B, 1)
    vol = torch.rand(B, G * G, G, device=dev)
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CUDA]):
        with spans.span("step", 3):
            with spans.span("forward"):
                float(x.sum())
                clbs.inverse_core_pg_s(pts, rg, torch.zeros(B, 3, device=dev),
                                       vol)
            with spans.span("backward"):
                y = torch.empty(2 ** 30, device=dev)     # a new segment
                del y
                torch.cuda.empty_cache()
            torch.cuda._sleep(10 ** 8)
    assert torch.cuda.get_sync_debug_mode() == mode
    step, fwd, b1, bwd = spans.records()
    assert [r["name"] for r in (fwd, b1, bwd)] == ["forward", "B1",
                                                   "backward"]
    assert b1["parent"] == 1 and bwd["parent"] == 0
    assert fwd["syncs"] == 1 and len(fwd["sync_sites"]) == 1
    assert b1["launches"] == {"inverse_core_pg_s": 1}
    assert step["syncs"] == 1 and step["step"] == fwd["step"] == 3
    assert step["device_allocs"] >= 1 and step["device_frees"] >= 1
    assert step["device_ns"] - step["t1"] > 1e6      # the card ran behind
    assert "device_ns" not in fwd and "device_allocs" not in fwd


def _no_card_waits(step):
    """Run `step()` once with every synchronising CUDA call an error, then
    once under a CUDA-only profiler; returns the `step` span's record."""
    from torch.profiler import ProfilerActivity, profile

    from hosnerf_tpu_torch.utils import spans
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        step()
    return [r for r in spans.records() if r["name"] == "step"][0]


def test_training_steps_never_wait_on_the_card(dev, capture):
    """After two warm-up steps, a stage-3 step at the 8-patch shapes (8
    patches of 32 x 32 rays, the full widths, bf16 trunks, LPIPS, two
    states) and a stage-1 step (4,096 rays over two states, the full
    widths) make no synchronising CUDA call: none raises under the sync
    debug mode 'error', and the `step` span counts no sync."""
    from hosnerf_tpu_torch.data import batches, scene_pipeline
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.train import stage1, stage3
    cfg = stage3.Stage3Config(n_patches=8, patch_size=32, num_states=2,
                              compute_dtype="bf16")
    scene, human, opt = stage3.init_state(cfg)
    lp = lpips.load_weights(lpips.LPIPS(device=dev), quiet=True
                            ).requires_grad_(False)
    step3 = stage3.make_train_step(cfg, scene, human, opt, [0.25],
                                   lpips_apply=lp)
    frames = [{k: torch.as_tensor(v, device=dev) for k, v in
               synthetic.composed_batch(8, 32, seed=i, time=t,
                                        grid_size=32).items()}
              for i, t in enumerate((0.5, 0.1, 0.7))]
    it = iter(range(100))

    def run3():
        i = next(it)
        step3(frames[i % 3], 60_000 + i,
              torch.Generator().manual_seed(i))

    _, scene1 = capture
    cfg1 = stage1.Stage1Config(num_states=2, compute_dtype="bf16")
    model, opt1 = stage1.init_state(cfg1)
    pipe = scene_pipeline.ScenePipeline(scene1, 4096, seed=0,
                                        batch_sampler="all_images")
    feed = [batches.to_device(pipe.sample_train_batch()) for _ in range(3)]
    step1 = stage1.make_train_step(cfg1, model, opt1, [0.5])

    def run1():
        i = next(it)
        step1(feed[i % 3], 250_000 + i,
              torch.Generator(dev).manual_seed(i))

    for run in (run3, run1):
        run()
        run()
        torch.cuda.synchronize()
        rec = _no_card_waits(run)
        assert rec["syncs"] == 0, rec.get("sync_sites")
