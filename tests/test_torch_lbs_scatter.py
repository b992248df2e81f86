"""The backward schedule of the shared-tap LBS kernels (row 7 and B5,
`hosnerf_tpu_torch/csrc/lbs_forward.cu`), emulated in plain torch on the
CPU.

The kernels read the volume from a bone-innermost image, bin the live
samples by brick (4x4x4 grid cells, whose taps touch 5^3 voxels; each
brick's rows in row order), sum each brick's dvol in a shared-memory tile
in fixed point (int64 multiples of 2^-e, `clbs.fixed_point_exponent` of
the largest |grad| entry and the share bound), CTA by CTA over chunks of
at most SCATTER_CHUNK samples, and flush the tile into int64 accumulators
that are converted to dvol once; a warp sums each
sample's per-bone shares of dpts. The schedule's index math (brick ids
and origins, tile offsets, flush map), written here as the kernels do it,
must give the dvol, dpts (and B5's drmat) of the plain versions'
`_tap_grads`: f32 sums in another order -> relative L2 1e-6.
No JAX here: the plain versions are held against JAX elsewhere
(tests/test_torch_kernels.py, tests/test_torch_train.py).
"""

import numpy as np
import pytest
import torch

from hosnerf_tpu_torch.ops.cuda import lbs as clbs

# the kernels' schedule (csrc/lbs_forward.cu: kBrick, kSpan, kTileRow,
# kChunk)
BRICK = 4                 # grid cells per brick edge
BRICK_SPAN = BRICK + 1    # voxels per brick edge that its samples' taps touch
TILE_ROW = clbs.MAX_BONES + 1  # floats per voxel row of a brick's dvol tile
SCATTER_CHUNK = 512       # samples per backward CTA at most


def bricks_per_axis(G: int) -> int:
    return -(-G // BRICK)


def has_taps(pts_g, G: int) -> torch.Tensor:
    """[n] bool: whether a sample has any in-grid tap (floor(f) in
    [-1, G-1] on every axis; False for NaN). The backwards bin only these:
    any other sample's weights, dvol shares and dpts are exactly 0."""
    c = torch.floor(pts_g.float())
    return ((c >= -1) & (c <= G - 1)).all(1)


def brick_of(pts_g, G: int) -> torch.Tensor:
    """[n] brick id of samples with taps (`has_taps`), (bz * nb + by) * nb
    + bx, where each axis takes the cell of its lower tap clamped into the
    grid (floor(f) = -1 -> 0) over BRICK: every in-grid tap of the sample
    then lies 0..BRICK voxels past the brick's origin (a partly off-grid
    sample keeps its invalid taps)."""
    c = torch.floor(pts_g.float()).clamp(0, G - 1).long() // BRICK
    nb = bricks_per_axis(G)
    return (c[:, 2] * nb + c[:, 1]) * nb + c[:, 0]


def brick_origin(brick, G: int):
    """(ox, oy, oz): the grid voxel of a brick's tile entry (0, 0, 0)."""
    nb = bricks_per_axis(G)
    return (BRICK * (brick % nb), BRICK * (brick // nb % nb),
            BRICK * (brick // (nb * nb)))


def tile_index(rx, ry, rz, b):
    """Offset of (voxel, bone) in a brick's shared dvol tile:
    [BRICK_SPAN^3 voxels (y, x, z, z fastest)][TILE_ROW], bones innermost
    so that lane b of a warp hits bank b."""
    return ((ry * BRICK_SPAN + rx) * BRICK_SPAN + rz) * TILE_ROW + b


def flush_map(brick: int, G: int, B: int):
    """The flush of one brick's tile into dvol [G*G, B*G], in the kernel's
    order (entry i: rz fastest, then bone, then x, then y): (tile offsets,
    flat dvol offsets), entries past the grid's far faces left out."""
    ox, oy, oz = brick_origin(brick, G)
    i = torch.arange(BRICK_SPAN * BRICK_SPAN * B * BRICK_SPAN)
    rz, t = i % BRICK_SPAN, i // BRICK_SPAN
    b, rxy = t % B, t // B
    rx, ry = rxy % BRICK_SPAN, rxy // BRICK_SPAN
    x, y, z = ox + rx, oy + ry, oz + rz
    keep = (x < G) & (y < G) & (z < G)
    dst = ((y * G + x) * B + b) * G + z
    return tile_index(rx, ry, rz, b)[keep], dst[keep]


def emulate_bwd(pts_g, vol_all, grad, rmat=None, k0=0):
    """The kernels' backward schedule in f32: row 7 (rmat None, grad = gw
    [n, B]) or B5 (grad = gout [n, 3K+1], rows from the clamped k0 * 512
    on). Returns (dpts, dvol [G*G, B*G], drmat or None, chunks)."""
    G, B = clbs._shared_dims(vol_all)
    K = 0 if rmat is None else rmat.shape[1] // 12
    n = pts_g.shape[0]
    first = clbs.first_live_row(k0, n, clbs.TILE_SH) if K else 0
    img = clbs.shared_image_plain(vol_all, "highest").reshape(-1)
    nbricks = bricks_per_axis(G) ** 3
    rows = torch.arange(first, n)
    rows = rows[has_taps(pts_g[first:], G)]
    br = brick_of(pts_g[rows], G)
    assert bool(((br >= 0) & (br < nbricks)).all())
    # the fixed-point exponent (csrc/lbs_forward.cu::tap_scale)
    m = float(grad[rows].abs().max()) if len(rows) else 0.0
    r = float(rmat.abs().max()) if K else 0.0
    ex = clbs.fixed_point_exponent(
        m, 1.02 * (3.0 * K * (3.0 * G + 1.0) * r + 1.0 if K else 1.0), n)
    counts = torch.bincount(br, minlength=nbricks)
    order = rows[torch.argsort(br, stable=True)]
    offs = torch.cumsum(counts, 0) - counts
    chunks = [(b, int(offs[b]) + s, min(int(offs[b]) + s + SCATTER_CHUNK,
                                        int(offs[b] + counts[b])))
              for b in range(nbricks)
              for s in range(0, int(counts[b]), SCATTER_CHUNK)]
    assert len(chunks) <= -(-n // SCATTER_CHUNK) + nbricks  # the grid

    dvol = torch.zeros(G * G * B * G, dtype=torch.int64)
    dpts = torch.zeros(n, 3)
    drmat = torch.zeros(B, 12 * K) if K else None
    bones = torch.arange(B)
    for brick, lo, hi in chunks:
        tile = torch.zeros(BRICK_SPAN ** 3 * TILE_ROW, dtype=torch.int64)
        ox, oy, oz = brick_origin(brick, G)
        rws = order[lo:hi]
        P = pts_g[rws].float()
        tx, ty, tz = (clbs._taps(P[:, a], G) for a in range(3))
        # per sample and bone ("lane"): this bone's 8 taps and zc
        xy = []
        for hx, vx, ix, dhx in tx:
            for hy, vy, iy, dhy in ty:
                xy.append((hx * hy * (vx & vy), vx & vy, iy * G + ix,
                           ix - ox, iy - oy, dhx * hy, hx * dhy))
        v = [[(img[((q * G + iz) * clbs.IMAGE_SLOTS)[:, None] + bones]
               * (m & vz)[:, None].float())
              for _, vz, iz, _ in tz] for _, m, q, *_ in xy]
        zc = [sum(w[:, None] * v[t][dz] for t, (w, *_) in enumerate(xy))
              for dz in range(2)]
        w_b = zc[0] * tz[0][0][:, None] + zc[1] * tz[1][0][:, None]
        e = torch.zeros(len(rws), B, 3)
        if K:
            g = grad[rws].float()
            q = torch.stack([g[:, 3 * k + c] * pj for k in range(K)
                             for c in range(3)
                             for pj in (P[:, 0], P[:, 1], P[:, 2],
                                        torch.ones(len(rws)))], 1)
            # dw exact (f64 of the f32 inputs), rounded once to f32
            q64 = torch.stack([g[:, 3 * k + c].double() * pj.double()
                               for k in range(K) for c in range(3)
                               for pj in (P[:, 0], P[:, 1], P[:, 2],
                                          torch.ones(len(rws)))], 1)
            gw = (q64 @ rmat.double().T + g[:, 3 * K:].double()).float()
            drmat += w_b.T @ q
            for j in range(3):
                e[:, :, j] = w_b * sum(
                    g[:, 3 * k + c, None] * rmat[None, :, 12 * k + 4 * c + j]
                    for k in range(K) for c in range(3))
        else:
            gw = grad[rws].float()
        d = [gw * (hz * vz)[:, None] for hz, vz, _, _ in tz]
        c3 = e
        for t, (w, m, _, rx, ry, cx, cy) in enumerate(xy):
            U = d[0] * v[t][0] + d[1] * v[t][1]
            c3[:, :, 0] += cx[:, None] * U
            c3[:, :, 1] += cy[:, None] * U
            for dz, (_, vz, iz, _) in enumerate(tz):
                ok = m & vz
                rz = iz - oz
                for a in (rx, ry, rz):
                    assert bool(((a[ok] >= 0) & (a[ok] <= BRICK)).all())
                idx = tile_index(rx[:, None], ry[:, None], rz[:, None],
                                      bones[None])
                val = torch.round((w[:, None] * d[dz]).double() * 2.0 ** ex)
                tile.index_add_(0, idx[ok].reshape(-1),
                                val[ok].reshape(-1).long())
        for dz, (_, vz, _, dhz) in enumerate(tz):
            c3[:, :, 2] += gw * (dhz * vz)[:, None] * zc[dz]
        dpts[rws] = c3.sum(1)
        src, dst = flush_map(brick, G, B)
        flushed = torch.zeros_like(tile, dtype=torch.bool)
        flushed[src] = True
        assert not tile[~flushed].any()      # nothing past the grid
        dvol.index_add_(0, dst, tile[src])
    dvol = (dvol.double() * 2.0 ** -ex).float()
    return dpts, dvol.reshape(G * G, B * G), drmat, chunks


def _case(G, B, n, seed, kind):
    rng = np.random.RandomState(seed)
    vol = torch.from_numpy(rng.rand(G * G, B * G).astype(np.float32))
    if kind == "hot":                     # every sample in one voxel
        pts = np.full((n, 3), 0.3 * G) + rng.rand(n, 3) * 0.9
    elif kind == "off":                   # every sample off the grid
        pts = rng.uniform(-40.0, -1.0, size=(n, 3))
        pts[::2] += G + 41.0
    else:  # "mixed": in, partly off and off the grid, on its faces
        pts = rng.uniform(-1.5, G + 0.5, size=(n, 3))
        pts[::7, 0] = G - 1
        pts[1::7, 1] = 0.0
        pts[2::7, 2] = G - 1
    return torch.from_numpy(pts.astype(np.float32)), vol


CASES = [(8, 5, 1500, "mixed"), (6, 3, 700, "mixed"), (32, 26, 700, "mixed"),
         (8, 1, 1100, "hot"), (8, 4, 300, "off"), (4, 32, 200, "mixed")]


def test_has_taps():
    """A sample is binned iff floor(f) lies in [-1, G-1] on every axis;
    the plain weights of every other sample are exactly 0."""
    G = 8
    p = torch.tensor([[-1.0, 0.0, 7.99], [-1.01, 3.0, 3.0],
                      [3.0, 8.0, 3.0], [-0.5, 7.0, -0.999],
                      [float("nan"), 1.0, 1.0]])
    assert has_taps(p, G).tolist() == [True, False, False, True, False]
    pts, vol = _case(G, 4, 300, 0, "mixed")
    w = clbs.shared_core_plain(pts, vol, "highest")
    assert not w[~has_taps(pts, G)].any()


def _close(got, ref, what):
    """Relative L2 error within 1e-6: both sides sum in f32, dvol over up
    to ~1,000 samples of one voxel in another order (its worst entry then
    moves by ~1e-6 of the scale, the L2 by less)."""
    l2 = float(torch.linalg.norm(got - ref) / (torch.linalg.norm(ref)
                                                + 1e-30))
    assert l2 <= 1e-6, (what, l2)


@pytest.mark.parametrize("G,B,n,kind", CASES)
def test_weights_bwd_schedule_matches_plain(G, B, n, kind):
    """Row 7: the binned schedule vs `shared_core_bwd_plain` (f32)."""
    pts, vol = _case(G, B, n, 0, kind)
    gw = torch.from_numpy(np.random.RandomState(1).randn(n, B)
                          .astype(np.float32))
    gw[::5] = 0.0                          # zero gradient rows
    dpts, dvol, _, chunks = emulate_bwd(pts, vol, gw)
    rd, rv = clbs.shared_core_bwd_plain(pts, vol, gw, "highest")
    _close(dpts, rd, "dpts")
    _close(dvol, rv, "dvol")
    if kind == "hot":
        assert len(chunks) == -(-n // SCATTER_CHUNK)
    if kind == "off":
        assert not chunks and not dvol.any() and not dpts.any()


@pytest.mark.parametrize("K,k0", [(2, 0), (2, 1), (1, 10 ** 6)])
@pytest.mark.parametrize("G,B,n,kind", CASES[:2] + CASES[3:4])
def test_blend_bwd_schedule_matches_plain(G, B, n, kind, K, k0):
    """B5: the binned schedule (gw = q rmat^T + g_w per bone, drmat per
    lane, the direct term per bone) vs `shared_blend_bwd_plain` (f32),
    rows below the clamped k0 * 512 not binned and their dpts 0."""
    pts, vol = _case(G, B, n, 2, kind)
    rng = np.random.RandomState(3)
    rmat = torch.from_numpy((0.3 * rng.randn(B, 12 * K)).astype(np.float32))
    gout = torch.from_numpy(rng.randn(n, 3 * K + 1).astype(np.float32))
    gout[1::4] = 0.0
    dpts, dvol, drmat, _ = emulate_bwd(pts, vol, gout, rmat, k0)
    ref = clbs.shared_blend_bwd_plain(pts, vol, rmat, k0, gout, "highest")
    for what, a, b in zip(("dpts", "dvol", "drmat"), (dpts, dvol, drmat),
                          ref):
        _close(a, b, what)
    first = clbs.first_live_row(k0, n, clbs.TILE_SH)
    assert not dpts[:first].any()


def test_image_layout():
    """The image holds vol_all[q, b*G + z] at [q, z, b], zero past B, and
    bf16 rounds as the plain versions' `_vol_for`; `shared_image` gives it
    flat for a CPU tensor."""
    G, B = 6, 5
    vol = torch.randn(G * G, B * G)
    for prec in ("highest", "bf16"):
        img = clbs.shared_image_plain(vol, prec)
        assert img.shape == (G * G, G, clbs.IMAGE_SLOTS)
        ref = clbs._vol_for(vol, prec).reshape(G * G, B, G)
        assert torch.equal(img[:, :, :B], ref.transpose(1, 2))
        assert not img[:, :, B:].any()
        assert torch.equal(clbs.shared_image(vol, prec), img.reshape(-1))


def test_brick_geometry():
    """Brick ids of samples with taps clamp floor(f) = -1 to 0; a
    brick's flush map reaches each in-grid voxel of its span once per bone,
    at the dvol offset of that voxel and bone."""
    G = 10
    p = torch.tensor([[-0.5, 0.0, 9.0], [9.99, 3.99, 4.0],
                      [-1.0, 8.5, 0.2], [3.0, 7.9, 8.2]])
    assert bool(has_taps(p, G).all())
    nb = bricks_per_axis(G)
    assert nb == 3
    assert brick_of(p, G).tolist() == [
        (2 * nb + 0) * nb + 0, (1 * nb + 0) * nb + 2, (0 * nb + 2) * nb + 0,
        (2 * nb + 1) * nb + 0]
    B = 3
    for brick in range(nb ** 3):
        src, dst = flush_map(brick, G, B)
        assert len(set(src.tolist())) == len(src)
        assert len(set(dst.tolist())) == len(dst)
        ox, oy, oz = brick_origin(brick, G)
        span = [min(BRICK_SPAN, G - o) for o in (ox, oy, oz)]
        assert len(dst) == span[0] * span[1] * span[2] * B
        z, rest = dst % G, dst // G
        b, q = rest % B, rest // B
        y, x = q // G, q % G
        for a, o in ((x, ox), (y, oy), (z, oz)):
            assert int(a.min()) >= o and int(a.max()) <= o + BRICK
        rx, ry, rz = x - ox, y - oy, z - oz
        assert torch.equal(src, tile_index(rx, ry, rz, b))
