"""The inverse-LBS kernels' volume layout and schedule (B1 and B4,
`hosnerf_tpu_torch/csrc/lbs_inverse.cu`), emulated in plain torch on the
CPU.

Both kernels read the volume from a corner image: entry (b, cx, cy, cz)
holds the 8 corners of the grid cell floor(f) = (cx, cy, cz) - 1, zero
off the grid. B1 walks the bones of a sample in order and takes one
entry per live pair (floor(f) in [-1, G-1] on every axis); B4 adds each
live pair's in-grid dvol shares in fixed point (int64 multiples of 2^-e,
e from the largest |gacc| entry, `clbs.fixed_point_exponent`) to one
accumulator per voxel and converts them to dvol once. Written here as the
kernels' index math does it, the emulations must give: B1 the plain
version bit for bit, B4 the plain version's dvol, dpts, dRg and dTg (f32
sums in another order, relative L2 1e-6). The fixed-point scale is held
to its promise: no int64 overflow at the worst case, the total within one
f32 ulp of the f64 sum. No JAX here: the plain versions are held against
JAX elsewhere (tests/test_torch_kernels.py, tests/test_torch_train.py).
"""

import numpy as np
import pytest
import torch

from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.ops.cuda import mlp as cmlp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _case(G, B, n, seed):
    """Bone affines near the identity, a volume with negative entries,
    samples in, around and far off each bone's grid, and samples at and
    just past each face of bone 0's support box (f = -1 - eps .. G + eps,
    PG_EPS = 1e-5)."""
    rng = np.random.RandomState(seed)
    vol = (rng.rand(B, G * G, G) * 2.0 - 0.5).astype(np.float32)
    R = (np.eye(3)[None] * rng.uniform(0.8, 1.2, (B, 1, 1))
         + rng.normal(0.0, 0.1, (B, 3, 3)))
    t = rng.uniform(-2.0, 2.0, (B, 3))
    pts = rng.uniform(-3.0, G + 2.0, (n, 3))
    pts[::9] += 60.0                                  # far off every grid
    faces = []
    for a in range(3):
        for v in (-1.0 - 2e-5, -1.0 - 5e-6, -1.0, -1.0 + 1e-3, 0.0,
                  G - 1.0, G - 1e-3, float(G), G + 5e-6, G + 2e-5):
            f = np.full(3, G / 2.0 + 0.3)
            f[a] = v
            faces.append(np.linalg.solve(R[0], f - t[0]))
    pts = np.concatenate([pts, np.array(faces)])
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return (f32(pts), f32(R.reshape(B, 9)), f32(t), torch.from_numpy(vol))


def _pairs(pts, rg, tg, b, G):
    """Bone b at every sample, as the kernels compute it: f (affine in the
    plain version's order), the live test, the image cell (floor(f) + 1
    per axis, 0 where dead) and the hat weights at floor(f), floor(f) + 1."""
    x, y, z = pts.unbind(-1)
    r, t = rg[b], tg[b]
    f = [((x * r[3 * c] + y * r[3 * c + 1]) + z * r[3 * c + 2]) + t[c]
         for c in range(3)]
    f0 = [torch.floor(fc) for fc in f]
    live = torch.stack([(c >= -1) & (c <= G - 1) for c in f0]).all(0)
    cell = [torch.where(live, c + 1, 0).long() for c in f0]
    hats = [(torch.clamp_min(1.0 - torch.abs(fc - c), 0.0),
             torch.clamp_min(1.0 - torch.abs(fc - (c + 1)), 0.0))
            for fc, c in zip(f, f0)]
    return f, live, cell, hats


def emulate_b1(pts, rg, tg, vol_qz, precision):
    """B1 over the corner image: per sample, bones in order, one entry per
    live pair, dead pairs skipped."""
    B, _, G = vol_qz.shape
    P = G + 1
    img = clbs.inverse_image(vol_qz, precision).float().reshape(-1, 8)
    rnd = clbs._rounder(precision)
    acc = [torch.zeros(pts.shape[0]) for _ in range(4)]
    for b in range(B):
        f, live, (cx, cy, cz), (hx, hy, hz) = _pairs(pts, rg, tg, b, G)
        v = img[((b * P + cx) * P + cy) * P + cz]
        zc = [torch.zeros_like(f[0]), torch.zeros_like(f[0])]
        for dx in (0, 1):
            for dy in (0, 1):
                w = rnd(hx[dx] * hy[dy])
                for dz in (0, 1):
                    zc[dz] = zc[dz] + w * v[:, 4 * dx + 2 * dy + dz]
        wb = hz[0] * zc[0] + hz[1] * zc[1]
        for c, term in enumerate([wb * f[0], wb * f[1], wb * f[2], wb]):
            acc[c] = torch.where(live, acc[c] + term, acc[c])
    return torch.stack(acc, 1)


# B4's bound of one dvol share over the largest |gacc| entry
# (csrc/lbs_inverse.cu::share_factor)
def b4_share_factor(G):
    return 1.01 * (3.0 * G + 1.0)


def emulate_b4(pts, rg, tg, vol_qz, gacc, precision, first=0):
    """B4 over the corner image, from row `first` on (the rows below are
    dead prefix: dpts 0, nothing added): lane = bone per sample; the
    in-grid dvol shares into int64 accumulators [B, G, G, G] in fixed
    point, then converted. Returns (dpts, drg, dtg, dvol)."""
    B, _, G = vol_qz.shape
    P = G + 1
    n = pts.shape[0]
    img = clbs.inverse_image(vol_qz, precision).float().reshape(-1, 8)
    rnd = clbs._rounder(precision)
    p = pts[first:]
    g = gacc[first:]
    ex = clbs.fixed_point_exponent(
        float(g.abs().max()) if g.numel() else 0.0, b4_share_factor(G), n)
    acc = torch.zeros(B * G ** 3, dtype=torch.int64)
    drg, dtg = torch.zeros(B, 9), torch.zeros(B, 3)
    dpts = torch.zeros(n, 3)
    for b in range(B):
        f, live, (cx, cy, cz), (hx, hy, hz) = _pairs(p, rg, tg, b, G)
        v = img[((b * P + cx) * P + cy) * P + cz]
        gw = ((g[:, 0] * f[0] + g[:, 1] * f[1]) + g[:, 2] * f[2]) + g[:, 3]
        gz = [rnd(gw * hz[0]), rnd(gw * hz[1])]
        dh = (-1.0, 1.0)
        zc, m2, m3 = ([torch.zeros_like(gw), torch.zeros_like(gw)]
                      for _ in range(3))
        for dx in (0, 1):
            for dy in (0, 1):
                w = rnd(hx[dx] * hy[dy])
                wdx = rnd(dh[dx] * hy[dy])
                wdy = rnd(hx[dx] * dh[dy])
                for dz in (0, 1):
                    e = v[:, 4 * dx + 2 * dy + dz]
                    zc[dz] = zc[dz] + w * e
                    m2[dz] = m2[dz] + wdx * e
                    m3[dz] = m3[dz] + wdy * e
                for dz in (0, 1):
                    x, y, z = cx - 1 + dx, cy - 1 + dy, cz - 1 + dz
                    on = live & (x >= 0) & (x < G) & (y >= 0) & (y < G) \
                        & (z >= 0) & (z < G)
                    at = ((b * G + x) * G + y) * G + z
                    acc.index_add_(0, at[on], torch.round(
                        (w * gz[dz])[on].double() * 2.0 ** ex).long())
        wb = hz[0] * zc[0] + hz[1] * zc[1]
        df = [g[:, 0] * wb + gw * (m2[0] * hz[0] + m2[1] * hz[1]),
              g[:, 1] * wb + gw * (m3[0] * hz[0] + m3[1] * hz[1]),
              g[:, 2] * wb + gw * (-1.0 * zc[0] + zc[1])]
        df = [torch.where(live, d, 0.0) for d in df]
        r = rg[b]
        for c in range(3):
            for k in range(3):
                drg[b, 3 * c + k] = torch.sum(df[c] * p[:, k])
            dtg[b, c] = torch.sum(df[c])
        for k in range(3):
            dpts[first:, k] += (df[0] * r[k] + df[1] * r[3 + k]) \
                + df[2] * r[6 + k]
    dvol = (acc.double() * 2.0 ** -ex).float()
    return dpts, drg, dtg, dvol.reshape(B, G * G, G)


def _rel_l2(a, b):
    return float(torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("G", [4, 7])
def test_corner_image_layout(G, prec):
    """Every entry's 8 corners, computed from the flat index as the image
    kernel does, against vol_qz (zero off the grid)."""
    B = 3
    vol_qz = torch.from_numpy(np.random.RandomState(G).rand(
        B, G * G, G).astype(np.float32))
    img = clbs.inverse_image(vol_qz, prec)
    P = G + 1
    assert img.shape == (B * P ** 3 * 8,)
    assert img.dtype == (torch.bfloat16 if prec == "bf16" else torch.float32)
    assert torch.equal(img, clbs.inverse_image_plain(vol_qz, prec).reshape(-1))
    ref = clbs._vol_for(vol_qz, prec)
    cell = torch.arange(B * P ** 3)
    cz, cy, cx, b = cell % P, cell // P % P, cell // P ** 2 % P, cell // P ** 3
    for k in range(8):
        x, y, z = cx - 1 + (k >> 2), cy - 1 + ((k >> 1) & 1), cz - 1 + (k & 1)
        on = (x >= 0) & (x < G) & (y >= 0) & (y < G) & (z >= 0) & (z < G)
        want = torch.where(on, ref[b, (x * G + y).clamp(0, G * G - 1),
                                   z.clamp(0, G - 1)], 0.0)
        assert torch.equal(img.reshape(-1, 8)[:, k], want.to(img.dtype)), k


@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("G,B,n", [(8, 5, 400), (5, 1, 300), (6, 32, 120)])
def test_b1_from_image_matches_plain_exactly(G, B, n, prec):
    pts, rg, tg, vol_qz = _case(G, B, n, seed=G + B)
    ref = clbs.inverse_core_plain(pts, rg, tg, vol_qz, prec)
    got = emulate_b1(pts, rg, tg, vol_qz, prec)
    assert torch.equal(got, ref)
    assert ref[:, 3].abs().max() > 0         # the case samples the volume


@pytest.mark.parametrize("prec", ["bf16", "highest"])
@pytest.mark.parametrize("G,B,n", [(8, 5, 400), (6, 32, 120)])
def test_b4_zpair_fold_matches_plain(G, B, n, prec):
    pts, rg, tg, vol_qz = _case(G, B, n, seed=2 * G + B)
    gacc = torch.from_numpy(np.random.RandomState(3).normal(
        size=(pts.shape[0], 4)).astype(np.float32))
    ref = clbs.inverse_core_bwd_plain(pts, rg, tg, vol_qz, gacc, prec)
    got = emulate_b4(pts, rg, tg, vol_qz, gacc, prec)
    for name, a, b in zip(("dpts", "drg", "dtg", "dvol"), got, ref):
        assert float(b.abs().max()) > 0, name
        assert _rel_l2(a, b) <= 1e-6, name


@pytest.mark.parametrize("G,count", [(32, 262_144), (8, 4096),
                                     (96, 1_048_576)])
def test_fixed_point_scale_cannot_overflow_and_rounds_once(G, count):
    """The scale the LBS backwards take for their dvol sums: `count` shares
    at the bound, all of one sign (the worst case), sum below 2^63 after
    rounding, and the next exponent would not keep the 2^62 margin; random
    shares within the bound, rounded to 2^-e, summed in int64 and
    converted once, lie within one f32 ulp of their f64 sum."""
    rng = np.random.RandomState(G)
    m = float(np.float32(rng.uniform(0.5, 4.0)))
    factor = b4_share_factor(G)
    e = clbs.fixed_point_exponent(m, factor, count)
    bound = m * factor
    q = int(np.rint(bound * 2.0 ** e))
    assert count * q < 2 ** 63 and count * (q + 1) < 2 ** 63
    assert count * bound * 2.0 ** (e + 1) >= 2.0 ** 62
    worst = torch.full((count,), q, dtype=torch.int64).sum()
    assert int(worst) == count * q          # no wrap in torch's int64 sum
    shares = torch.from_numpy(rng.uniform(-bound, bound, count).astype(
        np.float32))
    q = torch.round(shares.double() * 2.0 ** e).to(torch.int64)  # kernel's
    got = float((q.sum().double() * 2.0 ** -e).float())
    want = float(shares.double().sum())
    assert abs(got - want) <= float(np.spacing(np.float32(abs(want))))


def test_domain_k0_leaves_output_unchanged():
    """The sorted domain's k0 (blocks of INV_TILE rows, the trunks' tile):
    every row below it is dead, so storing zeros there (B1's and B4's
    dpts) and adding nothing from them (B4's sums) gives the plain
    versions' results."""
    assert clbs.INV_TILE == cmlp.MLP_TILE
    G, B = 8, 4
    pts, rg, tg, vol_qz = _case(G, B, 1000, seed=11)
    far = torch.from_numpy(np.random.RandomState(12).uniform(
        80.0, 90.0, (2500, 3)).astype(np.float32))
    pts = torch.cat([far[:1200], pts, far[1200:]])
    dom = clbs.bp_prepare(pts, rg, tg, G, B)
    pts_s = dom.sort_rows(pts)
    n_pad = pts_s.shape[0]
    k0 = dom.k0_for(clbs.INV_TILE)
    assert k0.dtype == torch.int32 and int(k0) == 2
    first = clbs.first_live_row(int(k0), n_pad, clbs.INV_TILE)
    assert first <= int(dom.n_dead_groups) * clbs.SORT_GROUP
    ref = clbs.inverse_core_plain(pts_s, rg, tg, vol_qz, "bf16")
    assert torch.equal(emulate_b1(pts_s[first:], rg, tg, vol_qz, "bf16"),
                       ref[first:])
    assert not ref[:first].any()
    gacc = torch.from_numpy(np.random.RandomState(13).normal(
        size=(n_pad, 4)).astype(np.float32))
    dref = clbs.inverse_core_bwd_plain(pts_s, rg, tg, vol_qz, gacc, "bf16")
    got = emulate_b4(pts_s, rg, tg, vol_qz, gacc, "bf16", first=first)
    assert not dref[0][:first].any()
    for name, a, b in zip(("dpts", "drg", "dtg", "dvol"), got, dref):
        assert _rel_l2(a, b) <= 1e-6, name
    # the autograd entry takes k0 and gives the plain results on the CPU
    acc = clbs.inverse_core_pg_s(pts_s, rg, tg, vol_qz, k0_blocks=k0)
    assert torch.equal(acc, ref)
