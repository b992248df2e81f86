"""Inverse LBS in every row order of the JAX package, the all-bone weight
sampling, and fused forward LBS: the liveness sort shared by every
per-sample stage, and the LBS kernels with their plain versions and
gradients.

Counterpart of `hosnerf_tpu/ops/pallas/lbs.py` (`_grid_affine`,
`_sample_support`, `bp_prepare`/`BPDomain`, the inverse cores
`inverse_core`, `inverse_core_pg`, `inverse_core_pgw`, `inverse_core_bp`
and `inverse_core_pg_s` with their VJPs, `shared_core` with its VJP,
`shared_blend_core` with its VJP, `inverse_lbs`, `bone_weights`,
`forward_lbs_multi`).

The TPU's five inverse cores compute one function, acc[n] = (sum_b w_b f_b,
sum_b w_b), with the same bf16 rounding; they differ in how they order the
samples and schedule (tile, bone) pairs for the MXU and scalar prefetch.
The Hopper kernels (`csrc/lbs_inverse.cu`) compute that function per
sample from a corner image of the volume (`inverse_image`), skipping the
(sample, bone) pairs whose cell lies off the grid; they take no tables and
are right for any row order (the sorted path's k0 only lets them skip its
dead prefix). So the cores are entries that put the rows in their own
order around the one kernel pair (forward B1, backward B4), at k0 = 0:
`inverse_core` the rows as given, `inverse_core_pg` `bp_prepare`'s
signature sort at its k0 (the JAX default) or the Morton group sort,
`inverse_core_pgw` the signature + Morton sort, `inverse_core_bp` the
signature sort. The TPU pair
tables (`_build_pairs`, `_build_window_pairs`, `_slot_pairs`,
`_bp_combine`) have no counterpart here, and neither has the windowed
core's NaN on table overflow (`PGW_CAP_QUADS`): it signals a full TPU
table, and there is no table to fill.

Every kernel entry takes a CPU tensor to its plain version and a CUDA
tensor to the kernel; it never falls back from one to the other. The
plain backward versions are written out (not autograd of the plain
forward) because the kernels round derivative taps to bf16 where the TPU
kernels' matmuls do.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from hosnerf_tpu_torch.ops.cuda import _build

PG_EPS = 1e-5      # support widening, as the JAX package's PG_EPS
SORT_GROUP = 8     # consecutive samples sharing one sort key
ROW_PAD = 128      # sorted-domain rows padded to a multiple of this (the
                   # JAX pair tile), so both packages sort the same rows
MAX_SIG_BONES = 31  # the int32 signature holds one bit per bone
TILE_SH = 512      # forward-LBS k0 counts blocks of this many rows
INV_TILE = 1024    # inverse-LBS k0 counts blocks of this many rows (csrc
                   # kTile; the trunks' MLP_TILE, so one k0 serves both)
MAX_BONES = 32     # csrc kMaxBones
SORT_CELLS = 16    # Morton cells per axis, as the JAX package's SORT_CELLS
MORTON_BITS = (SORT_CELLS - 1).bit_length()


def fixed_point_exponent(m: float, factor: float, count: int) -> int:
    """e of the LBS backwards' fixed-point dvol sums, as
    csrc/lbs_common.cuh::fixed_scale chooses it on the card: the largest
    integer with count * m * factor * 2^e < 2^62 (f64 arithmetic in that
    order; m the largest |input gradient| entry, an f32), at most 126 (2^e
    an f32), so `count` shares of at most m * factor, each rounded to an
    integer multiple of 2^-e, sum without overflow in int64 in any
    order."""
    _, ex = math.frexp(float(np.float32(m)) * factor * count)
    return min(62 - ex, 126)


def _grid_affine(bbox_min, bbox_scale, G: int):
    """World -> fractional-grid-index affine f = p * s + o per axis."""
    s = bbox_scale * 0.5 * (G - 1)
    return s, -bbox_min * s


def grid_tables(motion_scale_Rs, motion_Ts, motion_weights_vol, bbox_min,
                bbox_scale):
    """Fold the world->grid affine into the bone transforms and relayout
    the volume for the kernel: returns (s, o, rg [B, 9], tg [B, 3],
    vol_qz [B, G*G, G]) with vol_qz[b, x*G + y, z] = vol[b, z, y, x]."""
    B = motion_weights_vol.shape[0] - 1
    G = motion_weights_vol.shape[1]
    s, o = _grid_affine(bbox_min, bbox_scale, G)
    rg = (motion_scale_Rs * s[None, :, None]).reshape(B, 9)
    tg = motion_Ts * s[None, :] + o[None, :]
    vol_qz = motion_weights_vol[:B].permute(0, 3, 2, 1).reshape(B, G * G, G)
    return s, o, rg.contiguous(), tg.contiguous(), vol_qz.contiguous()


def world_from_grid(acc, s, o):
    """Grid-space accumulator [n, 4] -> (x_skel [n, 3] world, wsum [n, 1])."""
    wsum = acc[:, 3:4]
    m = torch.clamp(wsum, min=1e-4)
    return (acc[:, :3] / m - o[None, :] * (wsum / m)) / s[None, :], wsum


def _sample_support(pts, rg, tg, G: int):
    """[n, B] bool: bone b's trilinear taps at sample p are nonzero iff
    every grid coordinate f = Rg_b p + Tg_b lies in (-1, G); widened by
    PG_EPS like the JAX package."""
    f = torch.einsum("nk,bck->nbc", pts, rg.reshape(-1, 3, 3)) + tg[None]
    return torch.all((f > -1.0 - PG_EPS) & (f < G + PG_EPS), dim=-1)


class BPDomain:
    """Liveness-sorted sample domain. Under the ascending signature sort
    the zero-support groups form a contiguous prefix, so a tile-granular
    consumer skips it with one block offset (`k0_for`), and the exact
    dead/live row boundary is `n_dead_groups * SORT_GROUP`."""

    def __init__(self, n_pad, perm, inv_perm, n, n_dead_groups):
        self.n_pad = n_pad                  # padded sorted-domain rows
        self.perm = perm                    # [n_pad] int64
        self.inv_perm = inv_perm            # [n_pad] int64
        self.n = n                          # true sample count
        self.n_dead_groups = n_dead_groups  # 0-d int64 tensor on device

    def k0_for(self, tile: int) -> torch.Tensor:
        """First live block at a consumer's tile size (floor), as a
        device tensor (no host sync)."""
        return ((self.n_dead_groups * SORT_GROUP) // tile).to(torch.int32)

    def live_row_mask(self) -> torch.Tensor:
        """[n_pad, 1] bool: rows at or after the dead/live boundary."""
        rows = torch.arange(self.n_pad, device=self.perm.device)
        return (rows >= self.n_dead_groups * SORT_GROUP)[:, None]

    def unsort(self, x_s):
        """Sorted-domain rows -> original order, padding stripped."""
        return x_s[self.inv_perm][:self.n]

    def sort_rows(self, x):
        """Original-order [n, ...] -> sorted domain [n_pad, ...]."""
        pad = self.n_pad - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)
        return x[self.perm]


def _pad_points(pts) -> torch.Tensor:
    """pts [n, 3] as f32, zero rows appended to a multiple of ROW_PAD."""
    n = pts.shape[0]
    pts_p = pts.float()
    pad = -(-n // ROW_PAD) * ROW_PAD - n
    if pad:
        pts_p = torch.cat([pts_p, pts_p.new_zeros((pad, 3))], 0)
    return pts_p


def _group_support(pts_p, rg, tg, G: int, n: int) -> torch.Tensor:
    """[n_pad / SORT_GROUP, B] bool: whether any real sample of a group lies
    in a bone's support (padding rows support nothing)."""
    B = rg.shape[0]
    if B > MAX_SIG_BONES:
        raise ValueError(f"signature sort needs B <= {MAX_SIG_BONES}, "
                         f"got {B}")
    sup = _sample_support(pts_p, rg.float(), tg.float(), G)
    sup[n:] = False
    return torch.any(sup.reshape(-1, SORT_GROUP, B), dim=1)


def _signature(g) -> torch.Tensor:
    """Group support bits [n_groups, B] -> int64 signature (bit b = bone b)."""
    bits = torch.arange(g.shape[1], device=g.device, dtype=torch.int64)
    return torch.sum(g.to(torch.int64) << bits[None], dim=1)


def _morton_cells(pts_p) -> torch.Tensor:
    """Morton key of each group's centroid cell (`_group_sort_perm` and
    `_sig_morton_perm` of the JAX package): centroids scaled to
    SORT_CELLS cells per axis over their bounding box; bit i of the x, y
    and z cells goes to key bit 3i + 2, 3i + 1 and 3i."""
    ctr = pts_p.reshape(-1, SORT_GROUP, 3).mean(1)
    lo, hi = ctr.min(0).values, ctr.max(0).values
    qf = (ctr - lo) / torch.clamp(hi - lo, min=1e-9) * SORT_CELLS
    q = torch.clamp(qf.to(torch.int64), 0, SORT_CELLS - 1)
    key = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for i in range(MORTON_BITS):
        key = (key | (((q[:, 0] >> i) & 1) << (3 * i + 2))
               | (((q[:, 1] >> i) & 1) << (3 * i + 1))
               | (((q[:, 2] >> i) & 1) << (3 * i)))
    return key


def _row_perms(gperm):
    """Group permutation -> (perm, inv_perm) over rows, built at group
    level so that unsorting is a gather."""
    inv_gperm = torch.empty_like(gperm)
    inv_gperm[gperm] = torch.arange(gperm.shape[0], device=gperm.device)
    lane = torch.arange(SORT_GROUP, device=gperm.device)[None, :]
    return ((gperm[:, None] * SORT_GROUP + lane).reshape(-1),
            (inv_gperm[:, None] * SORT_GROUP + lane).reshape(-1))


def bp_prepare(pts, rg, tg, G: int, B: int) -> BPDomain:
    """Support test, group signature, stable signature sort and dead-prefix
    count for the sorted domain (counterpart of the JAX `bp_prepare`, which
    additionally builds the TPU pair tables)."""
    n = pts.shape[0]
    with torch.no_grad():
        pts_p = _pad_points(pts)
        g = _group_support(pts_p, rg[:B], tg[:B], G, n)
        perm, inv_perm = _row_perms(torch.argsort(_signature(g),
                                                  stable=True))
        n_dead_groups = g.shape[0] - torch.sum(torch.any(g, dim=1))
    return BPDomain(pts_p.shape[0], perm, inv_perm, n, n_dead_groups)


# ---------------------------------------------------------------------------
# shared plain-version pieces
# ---------------------------------------------------------------------------

def _vol_for(vol, precision: str):
    if precision == "bf16":
        return vol.to(torch.bfloat16)
    if precision == "highest":
        return vol.float()
    raise ValueError(f"unknown precision {precision!r}")


def _round_bf16_f64(t):
    """f64 -> the nearest bf16 value (ties to even), kept in f64: rounded
    once, where `.to(torch.bfloat16)` of an f64 tensor rounds through f32
    first."""
    m, e = torch.frexp(t)
    return torch.ldexp(torch.round(m * 256.0) / 256.0, e)


def _rounder(precision: str, dtype=torch.float32):
    if precision == "bf16":
        if dtype == torch.float64:
            return _round_bf16_f64
        return lambda t: t.to(torch.bfloat16).float()
    if precision == "highest":
        return lambda t: t
    raise ValueError(f"unknown precision {precision!r}")


def _taps(f, G: int):
    """The two linear taps of f along one axis: [(hat weight, in-grid
    mask, clamped index, d(hat)/df)] at floor(f) and floor(f) + 1. The
    derivative is the reference's floor-based one (-1 at the floor, +1
    above it), not the hat's kink; taps outside [0, G-1] do not exist."""
    f0 = torch.floor(f)
    out = []
    for d in (0, 1):
        i = f0 + d
        h = torch.clamp_min(1.0 - torch.abs(f - i), 0.0)
        valid = (i >= 0) & (i <= G - 1)
        out.append((h, valid, i.clamp(0, G - 1).long(),
                    (2.0 * d - 1.0) * valid.float()))
    return out


def _check_cuda(what: str, dev, *named):
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32")


def first_live_row(k0, n: int, tile: int) -> int:
    """Host-side first computed row for a k0 given on the host: k0
    clamped to [0, n_blocks - 1], times the tile (what the kernels
    compute on the device)."""
    n_blocks = -(-n // tile)
    return max(0, min(int(k0), n_blocks - 1)) * tile


def live_rows_mask(k0, n: int, tile: int, device) -> torch.Tensor:
    """[n, 1] bool on the device: rows at or after the clamped k0 * tile,
    from a device k0 without a host sync."""
    n_blocks = -(-n // tile)
    k = torch.as_tensor(k0, device=device).reshape(()).long()
    k = torch.clamp(k, 0, n_blocks - 1)
    return (torch.arange(n, device=device) >= k * tile)[:, None]


def _k0_tensor(k0, device) -> torch.Tensor:
    if k0 is None:
        return torch.zeros(1, dtype=torch.int32, device=device)
    return torch.as_tensor(k0, device=device).reshape(1).to(torch.int32)


# ---------------------------------------------------------------------------
# inverse LBS: forward kernel (B1), backward kernel (B4), plain versions
# ---------------------------------------------------------------------------

def inverse_core_plain(pts_s, rg, tg, vol_qz, precision: str = "bf16"):
    """Plain PyTorch version of the kernel, with the same arithmetic in the
    same order: per bone, f = ((x Rc0 + y Rc1) + z Rc2) + Tc; hat taps
    h = max(0, 1 - |f - i|) at i = floor(f) and floor(f) + 1, zero outside
    [0, G-1]; zc[z] = sum over the 4 xy taps of w_xy * vol; w_b =
    hz0 zc0 + hz1 zc1; acc += (w_b f, w_b). In "bf16" the xy tap product
    w_xy and the volume are rounded to bf16 (the z tap and every sum stay
    f32), the rounding the TPU kernel's bf16 matmul applies; "highest" is
    f32 throughout. Returns acc [n, 4] in grid coordinates."""
    B, QQ, G = vol_qz.shape
    vol = _vol_for(vol_qz, precision).float().reshape(B, QQ * G)
    rnd = _rounder(precision)
    x, y, z = pts_s.float().unbind(-1)
    acc = torch.zeros(pts_s.shape[0], 4, device=pts_s.device)
    rg = rg.float()
    tg = tg.float()
    for b in range(B):
        r, t = rg[b], tg[b]
        f = [((x * r[3 * c] + y * r[3 * c + 1]) + z * r[3 * c + 2]) + t[c]
             for c in range(3)]
        tx, ty, tz = _taps(f[0], G), _taps(f[1], G), _taps(f[2], G)
        zc = [torch.zeros_like(x), torch.zeros_like(x)]
        for hx, vx, ix, _ in tx:
            for hy, vy, iy, _ in ty:
                w = rnd(hx * hy) * (vx & vy)
                base = (ix * G + iy) * G
                for dz, (_, vz, iz, _) in enumerate(tz):
                    zc[dz] = zc[dz] + w * (vol[b][base + iz] * vz)
        wb = tz[0][0] * zc[0] + tz[1][0] * zc[1]
        for c in range(3):
            acc[:, c] = acc[:, c] + wb * f[c]
        acc[:, 3] = acc[:, 3] + wb
    return acc


def inverse_core_bwd_plain(pts_s, rg, tg, vol_qz, gacc,
                           precision: str = "bf16"):
    """Plain version of the inverse-LBS backward (the contract of the TPU
    `_pg_bwd_kernel`, lbs.py:860-956). Per bone, with gw = gx fx + gy fy
    + gz fz + g_w:
      dvol[b, xy, z] += bf16(hx hy) * bf16(gw hz);
      dfx = gx w_b + gw * sum_z hz * sum_xy bf16(dhat(fx) hy) vol, dfy
      likewise, dfz = gz w_b + gw * sum_z dhat(fz) zc;
      dRg[b] += (dfx, dfy, dfz) p^T, dTg[b] += (dfx, dfy, dfz);
      dpts += Rg_b^T (dfx, dfy, dfz).
    (bf16 rounding only in "bf16"; every sum f32.) Samples outside a
    bone's support contribute exactly zero, as the skipped TPU pairs do.
    Returns (dpts [n, 3], drg [B, 9], dtg [B, 3], dvol [B, G*G, G])."""
    B, QQ, G = vol_qz.shape
    vol = _vol_for(vol_qz, precision).float().reshape(B, QQ * G)
    rnd = _rounder(precision)
    p = pts_s.float()
    x, y, z = p.unbind(-1)
    gacc = gacc.float()
    gx, gy, gz, g_w = gacc.unbind(-1)
    rg = rg.float()
    tg = tg.float()
    dpts = torch.zeros_like(p)
    drg = torch.zeros(B, 9, device=p.device)
    dtg = torch.zeros(B, 3, device=p.device)
    dvol = torch.zeros(B, QQ * G, device=p.device)
    for b in range(B):
        r, t = rg[b], tg[b]
        f = [((x * r[3 * c] + y * r[3 * c + 1]) + z * r[3 * c + 2]) + t[c]
             for c in range(3)]
        tx, ty, tz = _taps(f[0], G), _taps(f[1], G), _taps(f[2], G)
        gw = ((gx * f[0] + gy * f[1]) + gz * f[2]) + g_w
        zc = [torch.zeros_like(x), torch.zeros_like(x)]
        m2 = [torch.zeros_like(x), torch.zeros_like(x)]
        m3 = [torch.zeros_like(x), torch.zeros_like(x)]
        for hx, vx, ix, dhx in tx:
            for hy, vy, iy, dhy in ty:
                vxy = vx & vy
                w = rnd(hx * hy) * vxy
                wdx = rnd(dhx * hy) * vxy
                wdy = rnd(hx * dhy) * vxy
                base = (ix * G + iy) * G
                for dz, (hz, vz, iz, _) in enumerate(tz):
                    v = vol[b][base + iz] * vz
                    zc[dz] = zc[dz] + w * v
                    m2[dz] = m2[dz] + wdx * v
                    m3[dz] = m3[dz] + wdy * v
                    dvol[b].index_add_(0, base + iz,
                                       w * rnd(gw * hz) * vz)
        (hz0, _, _, dhz0), (hz1, _, _, dhz1) = tz
        wb = hz0 * zc[0] + hz1 * zc[1]
        df = [gx * wb + gw * (m2[0] * hz0 + m2[1] * hz1),
              gy * wb + gw * (m3[0] * hz0 + m3[1] * hz1),
              gz * wb + gw * (dhz0 * zc[0] + dhz1 * zc[1])]
        for c in range(3):
            for k in range(3):
                drg[b, 3 * c + k] = torch.sum(df[c] * p[:, k])
            dtg[b, c] = torch.sum(df[c])
        for k in range(3):
            dpts[:, k] = dpts[:, k] + ((df[0] * r[k] + df[1] * r[3 + k])
                                       + df[2] * r[6 + k])
    return dpts, drg, dtg, dvol.reshape(B, QQ, G)


def _check_inverse(pts_s, rg, tg, vol_qz):
    B, QQ, G = vol_qz.shape
    n = pts_s.shape[0]
    if QQ != G * G or B > MAX_BONES or B < 1:
        raise ValueError(f"vol_qz must be [B<={MAX_BONES}, G*G, G], got "
                         f"{tuple(vol_qz.shape)}")
    if pts_s.shape != (n, 3) or rg.shape != (B, 9) or tg.shape != (B, 3):
        raise ValueError("pts_s [n, 3], rg [B, 9], tg [B, 3] expected")
    _check_cuda("inverse LBS", pts_s.device, ("pts_s", pts_s), ("rg", rg),
                ("tg", tg))
    if vol_qz.device != pts_s.device:
        raise ValueError(f"vol_qz is on {vol_qz.device}, not {pts_s.device}")
    return B, G, n


def inverse_image_plain(vol_qz, precision: str = "bf16"):
    """The inverse kernels' copy of the volume, [B, G+1, G+1, G+1, 8]:
    entry (b, cx, cy, cz) holds the 8 corners of the grid cell whose lower
    corner is (cx, cy, cz) - 1, corner k = 4 dx + 2 dy + dz at voxel (x, y,
    z) = (cx, cy, cz) - 1 + (dx, dy, dz), i.e. vol_qz[b, x*G + y, z], zero
    off the grid; in the precision's type (bf16 rounds to nearest)."""
    B, _, G = vol_qz.shape
    P = G + 1
    vol = _vol_for(vol_qz, precision).reshape(B, G, G, G)
    pad = vol.new_zeros(B, G + 2, G + 2, G + 2)   # index = voxel + 1
    pad[:, 1:-1, 1:-1, 1:-1] = vol
    return torch.stack([pad[:, dx:dx + P, dy:dy + P, dz:dz + P]
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                       -1)


def inverse_image(vol_qz, precision: str = "bf16"):
    """The image of `inverse_image_plain`, flat. A CPU tensor runs
    `inverse_image_plain`; a CUDA tensor one launch of csrc/lbs_inverse.cu
    (cast, relayout and zero padding), or raises. The autograd forward
    builds it once and keeps it for the backward."""
    if vol_qz.device.type == "cpu":
        return inverse_image_plain(vol_qz, precision).reshape(-1)
    if not vol_qz.is_cuda:
        raise ValueError(f"unsupported device {vol_qz.device}")
    B, _, G = vol_qz.shape
    _rounder(precision)  # raises on an unknown precision
    src = (vol_qz if vol_qz.dtype in (torch.float32, torch.bfloat16)
           else vol_qz.float()).contiguous()
    img = torch.empty(B * (G + 1) ** 3 * 8, device=vol_qz.device,
                      dtype=torch.bfloat16 if precision == "bf16"
                      else torch.float32)
    lib = _lib()
    rc = lib.hosnerf_inverse_image(
        src.data_ptr(), int(src.dtype == torch.bfloat16), img.data_ptr(),
        int(precision == "bf16"), B, G,
        torch.cuda.current_stream(vol_qz.device).cuda_stream)
    _build.check(rc, lib, "inverse_image")
    return img


def _k0_ptr(k0, device):
    """(pointer, tensor kept alive) for a kernel's k0: null for None."""
    if k0 is None:
        return None, None
    t = _k0_tensor(k0, device)
    return t.data_ptr(), t


def _inv_fwd(pts_s, rg, tg, vol_qz, img, k0, B: int, G: int,
             precision: str, entry):
    """B1's launch; builds the volume's image first unless given (after
    the output: a caller's NaN poison reaches the output first). Returns
    (acc, image)."""
    n, dev = pts_s.shape[0], pts_s.device
    out = torch.empty(n, 4, device=dev, dtype=torch.float32)
    img = inverse_image(vol_qz, precision) if img is None else img
    k0_p, k0_t = _k0_ptr(k0, dev)
    lib = _lib()
    rc = lib.hosnerf_inverse_lbs(
        pts_s.data_ptr(), rg.data_ptr(), tg.data_ptr(), img.data_ptr(), k0_p,
        out.data_ptr(), n, B, G, int(precision == "bf16"),
        torch.cuda.current_stream(dev).cuda_stream)
    entry.launches += 1
    _build.check(rc, lib, entry.__name__)
    return out, img


def _inv_bwd(pts_s, rg, tg, vol_qz, img, gacc, k0, B: int, G: int,
             precision: str):
    """B4's launches; builds the volume's image after dpts unless given."""
    n, dev = pts_s.shape[0], pts_s.device
    gacc = gacc.float().contiguous()
    if gacc.shape != (n, 4) or gacc.device != dev:
        raise ValueError("gacc must be [n, 4] on the device of pts_s")
    lib = _lib()
    dpts = torch.empty(n, 3, device=dev, dtype=torch.float32)
    img = inverse_image(vol_qz, precision) if img is None else img
    drg = torch.empty(B, 9, device=dev, dtype=torch.float32)
    dtg = torch.empty(B, 3, device=dev, dtype=torch.float32)
    dvol = torch.empty(B, G * G, G, device=dev, dtype=torch.float32)
    scratch = torch.empty(lib.hosnerf_inverse_bwd_scratch(n, B, G),
                          device=dev, dtype=torch.float32)
    k0_p, k0_t = _k0_ptr(k0, dev)
    rc = lib.hosnerf_inverse_lbs_bwd(
        pts_s.data_ptr(), rg.data_ptr(), tg.data_ptr(), img.data_ptr(),
        gacc.data_ptr(), k0_p, dpts.data_ptr(), drg.data_ptr(),
        dtg.data_ptr(), dvol.data_ptr(), scratch.data_ptr(), n, B, G,
        int(precision == "bf16"), torch.cuda.current_stream(dev).cuda_stream)
    inverse_core_bwd.launches += 1
    _build.check(rc, lib, "inverse_core_bwd")
    return dpts, drg, dtg, dvol


def inverse_core_fwd(pts_s, rg, tg, vol_qz, precision: str = "bf16",
                     entry=None):
    """B1: inverse-LBS accumulation acc [n, 4] over every row. A CPU
    tensor runs `inverse_core_plain`; a CUDA tensor builds the volume's
    image and runs the kernel of csrc/lbs_inverse.cu (or raises), adding
    one to the launch count of `entry`, the inverse core that asked
    (`inverse_core_pg_s` unless named)."""
    if pts_s.device.type == "cpu":
        return inverse_core_plain(pts_s, rg, tg, vol_qz, precision)
    if not pts_s.is_cuda:
        raise ValueError(f"unsupported device {pts_s.device}")
    B, G, _ = _check_inverse(pts_s, rg, tg, vol_qz)
    return _inv_fwd(pts_s, rg, tg, vol_qz, None, None, B, G, precision,
                    entry or inverse_core_pg_s)[0]


def inverse_core_bwd(pts_s, rg, tg, vol_qz, gacc, precision: str = "bf16",
                     k0=None):
    """B4: the inverse-LBS backward, (dpts, drg, dtg, dvol). A CPU tensor
    runs `inverse_core_bwd_plain`; a CUDA tensor builds the volume's image
    and runs the kernels of csrc/lbs_inverse.cu (or raises). k0: first
    live block of INV_TILE rows (a device tensor or int, clamped to
    n_blocks - 1; None for 0), as `inverse_core_pg_s` takes it: the rows
    below it must be dead (no bone's support); their dpts are stored as 0
    and they add nothing. dvol, drg and dtg sum over samples in an order
    no schedule moves (drg/dtg by per-CTA slots summed in order, dvol in
    fixed point): the same inputs on one card give the same bits."""
    if pts_s.device.type == "cpu":
        return inverse_core_bwd_plain(pts_s, rg, tg, vol_qz, gacc, precision)
    if not pts_s.is_cuda:
        raise ValueError(f"unsupported device {pts_s.device}")
    B, G, _ = _check_inverse(pts_s, rg, tg, vol_qz)
    return _inv_bwd(pts_s, rg, tg, vol_qz, None, gacc, k0, B, G, precision)


inverse_core_bwd.launches = 0


class _InverseCore(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pts_s, rg, tg, vol_qz, precision, entry, k0):
        ctx.precision = precision
        if pts_s.device.type == "cpu":
            ctx.save_for_backward(pts_s, rg, tg, vol_qz, None, None)
            return inverse_core_plain(pts_s, rg, tg, vol_qz, precision)
        if not pts_s.is_cuda:
            raise ValueError(f"unsupported device {pts_s.device}")
        B, G, _ = _check_inverse(pts_s, rg, tg, vol_qz)
        out, img = _inv_fwd(pts_s, rg, tg, vol_qz, None, k0, B, G,
                            precision, entry)
        ctx.save_for_backward(pts_s, rg, tg, vol_qz, img, k0)
        return out

    @staticmethod
    def backward(ctx, gacc):
        pts_s, rg, tg, vol_qz, img, k0 = ctx.saved_tensors
        if img is None:
            dpts, drg, dtg, dvol = inverse_core_bwd_plain(
                pts_s, rg, tg, vol_qz, gacc, ctx.precision)
        else:
            B, _, G = vol_qz.shape
            dpts, drg, dtg, dvol = _inv_bwd(pts_s, rg, tg, vol_qz, img,
                                            gacc, k0, B, G, ctx.precision)
        return (dpts, drg.to(rg.dtype), dtg.to(tg.dtype),
                dvol.to(vol_qz.dtype), None, None, None)


def inverse_core_pg_s(pts_s, rg, tg, vol_qz, precision: str = "bf16",
                      k0_blocks=None):
    """Inverse-LBS accumulation over (sorted) samples: acc [n, 4] =
    (sum_b w_b f_b, sum_b w_b) in grid coordinates, dead rows exactly 0.
    pts_s [n, 3] f32; rg [B, 9]; tg [B, 3]; vol_qz [B, G*G, G].
    Differentiable in all four: forward B1, backward B4 (each the plain
    version for CPU tensors, the kernel for CUDA tensors). k0_blocks: the
    sorted domain's first live block of INV_TILE rows (`BPDomain.k0_for`),
    a device tensor or int, clamped to n_blocks - 1. The rows below it
    must be dead (no bone's support): the kernels store them as zeros
    without computing them (the plain versions' arithmetic gives zeros
    there too)."""
    k0 = None if k0_blocks is None else _k0_tensor(k0_blocks, pts_s.device)
    return _InverseCore.apply(pts_s, rg, tg, vol_qz, precision,
                              inverse_core_pg_s, k0)


inverse_core_pg_s.launches = 0


def _in_row_order(order, pts, rg, tg, vol_qz, precision, entry):
    """acc [n, 4] of the rows of pts through B1/B4 in the row order that
    `order(pts_p, rg, tg, G, n)` gives the zero-padded points (a group
    permutation); the result is unsorted back and unpadded."""
    n = pts.shape[0]
    G = vol_qz.shape[-1]
    pts_p = _pad_points(pts)
    with torch.no_grad():
        perm, inv_perm = _row_perms(order(pts_p, rg, tg, G, n))
    acc_s = _InverseCore.apply(pts_p[perm], rg, tg, vol_qz, precision,
                               entry, None)
    return acc_s[inv_perm][:n]


def _morton_order(pts_p, rg, tg, G, n):
    return torch.argsort(_morton_cells(pts_p), stable=True)


def _sig_morton_order(pts_p, rg, tg, G, n):
    key = (_signature(_group_support(pts_p, rg, tg, G, n))
           << (3 * MORTON_BITS)) | _morton_cells(pts_p)
    return torch.argsort(key, stable=True)


def _support_order(pts_p, rg, tg, G, n):
    return torch.argsort(_signature(_group_support(pts_p, rg, tg, G, n)),
                         stable=True)


def inverse_core(pts_g, rg, tg, vol_qz, precision: str = "bf16"):
    """Row 6 (`inverse_core`, the TPU's dense tile schedule): the rows in
    the order given, unpadded. Same contract as `inverse_core_pg_s`."""
    return _InverseCore.apply(pts_g.float().contiguous(), rg, tg, vol_qz,
                              precision, inverse_core, None)


def inverse_core_pg(pts_g, rg, tg, vol_qz, precision: str = "bf16",
                    pg_sort: str = "sig"):
    """The quad pair-grid core (`inverse_core_pg`) in the row order of
    `pg_sort`, the JAX package's HOSNERF_PG_SORT. 'sig' (its default):
    `bp_prepare`'s signature-sorted domain through row 1
    (`inverse_core_pg_s`: B1 forward, B4 backward) at the domain's k0,
    then unsorted, as the JAX default runs `bp_prepare(kind="quad")` and
    `inverse_core_pg_s`. 'morton': row 9, the legacy route (`_pg_legacy`):
    groups of SORT_GROUP samples sorted by the Morton cell of their
    centroid (`_group_sort_perm`), k0 = 0."""
    if pg_sort == "sig":
        B, _, G = vol_qz.shape
        dom = bp_prepare(pts_g, rg, tg, G, B)
        acc_s = inverse_core_pg_s(dom.sort_rows(pts_g.float()), rg, tg,
                                  vol_qz, precision,
                                  k0_blocks=dom.k0_for(INV_TILE))
        return dom.unsort(acc_s)
    if pg_sort != "morton":
        raise ValueError(f"unknown pg_sort {pg_sort!r}")
    return _in_row_order(_morton_order, pts_g, rg, tg, vol_qz, precision,
                         inverse_core_pg)


def inverse_core_pgw(pts_g, rg, tg, vol_qz, precision: str = "bf16"):
    """Row 10 (`inverse_core_pgw`, the TPU's windowed pair grid): groups
    sorted by support signature, then Morton cell (`_sig_morton_perm`)."""
    return _in_row_order(_sig_morton_order, pts_g, rg, tg, vol_qz,
                         precision, inverse_core_pgw)


def inverse_core_bp(pts_g, rg, tg, vol_qz, precision: str = "bf16"):
    """Row 11 (`inverse_core_bp`, the TPU's bone-packed slots): groups
    sorted by support signature (`_support_sort_perm`), dead groups
    first."""
    return _in_row_order(_support_order, pts_g, rg, tg, vol_qz, precision,
                         inverse_core_bp)


for _entry in (inverse_core, inverse_core_pg, inverse_core_pgw,
               inverse_core_bp):
    _entry.launches = 0
PG_CORES = {"quad": inverse_core_pg, "win": inverse_core_pgw,
            "bp": inverse_core_bp}
PG_SORTS = ("sig", "morton")   # the quad core's row orders


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lbs_inverse")
    p = ctypes.c_void_p
    i = ctypes.c_int
    _build.declare(lib, "hosnerf_inverse_bwd_scratch", [i, i, i])
    _build.declare(lib, "hosnerf_inverse_image", [p, i, p, i, i, i, p])
    _build.declare(lib, "hosnerf_inverse_lbs",
                   [p, p, p, p, p, p, i, i, i, i, p])
    _build.declare(lib, "hosnerf_inverse_lbs_bwd",
                   [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p])
    return lib


def inverse_lbs(pts, motion_scale_Rs, motion_Ts, motion_weights_vol,
                cnl_bbox_min_xyz, cnl_bbox_scale_xyz, *,
                precision: str = "bf16", pair_grid: bool = True,
                pg_impl: str = "quad", pg_sort: str = "sig"):
    """Inverse LBS of unsorted points (the JAX `inverse_lbs`): returns
    (x_skel [N, 3], fg_likelihood_mask [N, 1]) in world coordinates.
    pair_grid=False takes `inverse_core`; True the pair-grid core named by
    pg_impl ('quad' `inverse_core_pg` in the row order of pg_sort, 'win'
    `inverse_core_pgw`, 'bp' `inverse_core_bp`; the JAX package reads the
    two from HOSNERF_PG_IMPL and HOSNERF_PG_SORT)."""
    if pair_grid and pg_impl not in PG_CORES:
        raise ValueError(f"unknown pg_impl {pg_impl!r}")
    if pg_sort not in PG_SORTS:
        raise ValueError(f"unknown pg_sort {pg_sort!r}")
    s, o, rg, tg, vol_qz = grid_tables(
        motion_scale_Rs, motion_Ts, motion_weights_vol, cnl_bbox_min_xyz,
        cnl_bbox_scale_xyz)
    if not pair_grid:
        acc = inverse_core(pts, rg, tg, vol_qz, precision)
    elif pg_impl == "quad":
        acc = inverse_core_pg(pts, rg, tg, vol_qz, precision, pg_sort)
    else:
        acc = PG_CORES[pg_impl](pts, rg, tg, vol_qz, precision)
    return world_from_grid(acc, s, o)


# ---------------------------------------------------------------------------
# shared-tap sampling: every bone's weight at one point (row 7 and B5)
# ---------------------------------------------------------------------------

def _blend_dims(vol_all, rmat):
    QQ, BG = vol_all.shape
    G = int(round(QQ ** 0.5))
    B = BG // G
    K = rmat.shape[1] // 12
    if G * G != QQ or B * G != BG or tuple(rmat.shape) != (B, 12 * K):
        raise ValueError(f"vol_all [G*G, B*G] and rmat [B, 12K] expected, "
                         f"got {tuple(vol_all.shape)}, {tuple(rmat.shape)}")
    return G, B, K


def _shared_taps(pts_g, G: int, B: int, rnd, vol):
    """Shared-tap sampling at grid points: the 4 xy taps (bf16(hx hy)
    weight, mask, q = y*G + x, and the x/y tap pieces), the 2 z taps, and
    per bone zc[b][dz] = sum_xy w_xy vol[q, b*G + z] (0 off-grid)."""
    fx, fy, fz = pts_g.to(vol.dtype).unbind(-1)
    tx, ty, tz = _taps(fx, G), _taps(fy, G), _taps(fz, G)
    BG = B * G
    xy = []
    for hx, vx, ix, dhx in tx:
        for hy, vy, iy, dhy in ty:
            vxy = vx & vy
            xy.append(dict(w=rnd(hx * hy) * vxy, q=(iy * G + ix) * BG,
                           m=vxy.float(), hx=hx, hy=hy, dhx=dhx, dhy=dhy))
    flat = vol.reshape(-1)
    zc = []
    for b in range(B):
        row = []
        for _, vz, iz, _ in tz:
            col = b * G + iz
            s = None
            for t in xy:
                c = t["w"] * flat[t["q"] + col]
                s = c if s is None else s + c
            row.append(s * vz)
        zc.append(row)
    return (fx, fy, fz), xy, tz, zc


def _blend_weights(zc, tz, rnd):
    """w [N, B]: w_b = sum_z bf16(zc hz) (the TPU sum_blk matmul)."""
    (hz0, _, _, _), (hz1, _, _, _) = tz
    return torch.stack([rnd(r[0] * hz0) + rnd(r[1] * hz1) for r in zc], 1)


def _tap_grads(xy, tz, zc, gw, vol, G: int, B: int, rnd):
    """Gradients of the shared-tap weights w_b through their taps, given
    gw [n, B] = dL/dw already rounded as the TPU kernels' `expand` matmul
    rounds it: ((dfx, dfy, dfz), dvol [G*G, B*G]) with
      dvol[q_xy, b*G+z] += bf16(hx hy) bf16(gw_b hz);
      U_xy = sum_{b,z} bf16(gw_b hz) bf16(vol); dfx = sum_xy dhat(fx) hy U,
      dfy = sum_xy hx dhat(fy) U, dfz = sum_b gw_b sum_z dhat(fz) zc."""
    dvol = torch.zeros(G * G * B * G, device=gw.device, dtype=gw.dtype)
    flat = vol.reshape(-1)
    U = [torch.zeros_like(gw[:, 0]) for _ in xy]
    dfz = torch.zeros_like(gw[:, 0])
    for b in range(B):
        for dz, (hz, vz, iz, dhz) in enumerate(tz):
            d = rnd(gw[:, b] * hz) * vz
            col = b * G + iz
            for i, t in enumerate(xy):
                dvol.index_add_(0, t["q"] + col, t["w"] * d)
                U[i] = U[i] + d * flat[t["q"] + col]
            dfz = dfz + gw[:, b] * (dhz * zc[b][dz])
    dfx = sum(t["dhx"] * t["hy"] * t["m"] * u for t, u in zip(xy, U))
    dfy = sum(t["hx"] * t["dhy"] * t["m"] * u for t, u in zip(xy, U))
    return (dfx, dfy, dfz), dvol.reshape(G * G, B * G)


# ---------------------------------------------------------------------------
# all-bone weights at shared points: forward and backward kernels (row 7)
# ---------------------------------------------------------------------------

def _shared_dims(vol_all):
    QQ, BG = vol_all.shape
    G = int(round(QQ ** 0.5))
    B = BG // G
    if G * G != QQ or B * G != BG:
        raise ValueError(f"vol_all must be [G*G, B*G], got "
                         f"{tuple(vol_all.shape)}")
    return G, B


def shared_core_plain(pts_g, vol_all, precision: str = "bf16"):
    """Plain version of the all-bone weights (`_shared_fwd_kernel`,
    lbs.py:1608-1626): the 4 xy taps of a point are shared by every bone;
    zc[b, z] = sum_xy bf16(hx hy) bf16(vol[q, b*G+z]) in f32; w_b =
    sum_z bf16(zc hz) in f32 (the second `_mm` rounds its operand).
    pts_g [N, 3] grid coordinates; vol_all [G*G, B*G] with
    vol_all[y*G + x, b*G + z]. Returns w [N, B] f32."""
    G, B = _shared_dims(vol_all)
    rnd = _rounder(precision)
    vol = _vol_for(vol_all, precision).float()
    _, _, tz, zc = _shared_taps(pts_g, G, B, rnd, vol)
    return _blend_weights(zc, tz, rnd)


def shared_core_bwd_plain(pts_g, vol_all, gw, precision: str = "bf16"):
    """Plain version of the all-bone weights' backward
    (`_shared_bwd_kernel`, lbs.py:1629-1671): gw_exp = bf16(gw) (:1656);
    dvol += bf16(onehot)^T bf16(gw_exp hz) (:1660); U = bf16(gw_exp hz)
    bf16(vol)^T (:1664); dfx, dfy, dfz in f32 from the floor-based tap
    derivatives (:1665-1671). Returns (dpts [N, 3], dvol [G*G, B*G])."""
    G, B = _shared_dims(vol_all)
    rnd = _rounder(precision)
    vol = _vol_for(vol_all, precision).float()
    _, xy, tz, zc = _shared_taps(pts_g, G, B, rnd, vol)
    df, dvol = _tap_grads(xy, tz, zc, rnd(gw.float()), vol, G, B, rnd)
    return torch.stack(df, 1), dvol


# ---------------------------------------------------------------------------
# the kernels' volume image and their backward schedule (row 7 and B5)
# ---------------------------------------------------------------------------

IMAGE_SLOTS = MAX_BONES   # bone slots per voxel row of the image (csrc kSlots)


def shared_image_plain(vol_all, precision: str = "bf16"):
    """The kernels' copy of the volume, [G*G, G, IMAGE_SLOTS]: img[q, z, b]
    = vol_all[q, b*G + z] in the precision's type (bf16 rounds to
    nearest), zero for b >= B."""
    G, B = _shared_dims(vol_all)
    vol = _vol_for(vol_all, precision).reshape(G * G, B, G).transpose(1, 2)
    img = vol.new_zeros(G * G, G, IMAGE_SLOTS)
    img[:, :, :B] = vol
    return img


def shared_image(vol_all, precision: str = "bf16"):
    """The image of `shared_image_plain`, flat [G*G*G*IMAGE_SLOTS]. A CPU
    tensor runs `shared_image_plain`; a CUDA tensor one launch of
    csrc/lbs_forward.cu (cast, relayout and pad), or raises. Forward
    entries build it per call and the autograd functions keep it for the
    backward."""
    if vol_all.device.type == "cpu":
        return shared_image_plain(vol_all, precision).reshape(-1)
    if not vol_all.is_cuda:
        raise ValueError(f"unsupported device {vol_all.device}")
    G, B = _shared_dims(vol_all)
    _rounder(precision)  # raises on an unknown precision
    src = (vol_all if vol_all.dtype in (torch.float32, torch.bfloat16)
           else vol_all.float()).contiguous()
    img = torch.empty(G * G * G * IMAGE_SLOTS, device=vol_all.device,
                      dtype=torch.bfloat16 if precision == "bf16"
                      else torch.float32)
    lib = _blend_lib()
    rc = lib.hosnerf_lbs_image(
        src.data_ptr(), int(src.dtype == torch.bfloat16), img.data_ptr(),
        int(precision == "bf16"), B, G,
        torch.cuda.current_stream(vol_all.device).cuda_stream)
    _build.check(rc, lib, "shared_image")
    return img


def _tap_bwd(entry, pts_g, img, grad, rmat, k0_t, B: int, G: int, K: int,
             precision: str):
    """The backward kernels of row 7 (K = 0, grad = gw) and B5 (grad =
    gout): binning passes and the per-brick kernel; counts one launch of
    `entry`. Returns (dpts, dvol [G*G, B*G], drmat or None)."""
    n, dev = pts_g.shape[0], pts_g.device
    lib = _blend_lib()
    dpts = torch.empty(n, 3, device=dev, dtype=torch.float32)
    scratch = torch.empty(lib.hosnerf_shared_tap_scratch(n, B, G, K),
                          device=dev, dtype=torch.int32)
    dvol = torch.empty(G * G, B * G, device=dev, dtype=torch.float32)
    drmat = (torch.empty(B, 12 * K, device=dev, dtype=torch.float32)
             if K else None)
    rc = lib.hosnerf_shared_tap_bwd(
        pts_g.data_ptr(), img.data_ptr(), grad.data_ptr(),
        rmat.data_ptr() if K else None, k0_t.data_ptr() if K else None,
        scratch.data_ptr(), dpts.data_ptr(), dvol.data_ptr(),
        drmat.data_ptr() if K else None, n, B, G, K,
        int(precision == "bf16"), torch.cuda.current_stream(dev).cuda_stream)
    entry.launches += 1
    _build.check(rc, lib, entry.__name__)
    return dpts, dvol, drmat


def _check_shared(pts_g, vol_all):
    G, B = _shared_dims(vol_all)
    n = pts_g.shape[0]
    if pts_g.shape != (n, 3) or B > MAX_BONES:
        raise ValueError(f"kernel takes pts_g [n, 3] and B <= {MAX_BONES}; "
                         f"got {tuple(pts_g.shape)}, B={B}")
    _check_cuda("all-bone weights", pts_g.device, ("pts_g", pts_g))
    if vol_all.device != pts_g.device:
        raise ValueError(f"vol_all is on {vol_all.device}, not "
                         f"{pts_g.device}")
    return G, B, n


def _weights_fwd(pts_g, img, B: int, G: int, precision: str):
    n, dev = pts_g.shape[0], pts_g.device
    w = torch.empty(n, B, device=dev, dtype=torch.float32)
    lib = _blend_lib()
    rc = lib.hosnerf_shared_weights_fwd(
        pts_g.data_ptr(), img.data_ptr(), w.data_ptr(), n, B, G,
        int(precision == "bf16"), torch.cuda.current_stream(dev).cuda_stream)
    shared_core_fwd.launches += 1
    _build.check(rc, lib, "shared_core_fwd")
    return w


def _weights_bwd(pts_g, img, gw, B: int, G: int, precision: str):
    n = pts_g.shape[0]
    gw = gw.float().contiguous()
    if gw.shape != (n, B) or gw.device != pts_g.device:
        raise ValueError(f"gw must be [n, {B}] on the device of pts_g")
    dpts, dvol, _ = _tap_bwd(shared_core_bwd, pts_g, img, gw, None, None, B,
                             G, 0, precision)
    return dpts, dvol


def shared_core_fwd(pts_g, vol_all, precision: str = "bf16"):
    """Row 7 forward: w [N, B]. A CPU tensor runs `shared_core_plain`; a
    CUDA tensor the kernel of csrc/lbs_forward.cu (or raises): one thread
    per sample over the volume's image (`shared_image`)."""
    if pts_g.device.type == "cpu":
        return shared_core_plain(pts_g, vol_all, precision)
    if not pts_g.is_cuda:
        raise ValueError(f"unsupported device {pts_g.device}")
    G, B, _ = _check_shared(pts_g, vol_all)
    return _weights_fwd(pts_g, shared_image(vol_all, precision), B, G,
                        precision)


shared_core_fwd.launches = 0


def shared_core_bwd(pts_g, vol_all, gw, precision: str = "bf16"):
    """Row 7 backward: (dpts [N, 3], dvol [G*G, B*G]). A CPU tensor runs
    `shared_core_bwd_plain`; a CUDA tensor the binned kernels of
    csrc/lbs_forward.cu (or raises). dvol sums in fixed point, in an order
    no schedule moves: the same inputs on one card give the same bits."""
    if pts_g.device.type == "cpu":
        return shared_core_bwd_plain(pts_g, vol_all, gw, precision)
    if not pts_g.is_cuda:
        raise ValueError(f"unsupported device {pts_g.device}")
    G, B, _ = _check_shared(pts_g, vol_all)
    return _weights_bwd(pts_g, shared_image(vol_all, precision), gw, B, G,
                        precision)


shared_core_bwd.launches = 0


class _SharedCore(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pts_g, vol_all, precision):
        ctx.precision = precision
        if pts_g.device.type == "cpu":
            ctx.save_for_backward(pts_g, vol_all, None)
            return shared_core_fwd(pts_g, vol_all, precision)
        G, B, _ = _check_shared(pts_g, vol_all)
        img = shared_image(vol_all, precision)
        ctx.save_for_backward(pts_g, vol_all, img)
        return _weights_fwd(pts_g, img, B, G, precision)

    @staticmethod
    def backward(ctx, gw):
        pts_g, vol_all, img = ctx.saved_tensors
        if img is None:
            dpts, dvol = shared_core_bwd(pts_g, vol_all, gw, ctx.precision)
        else:
            G, B = _shared_dims(vol_all)
            dpts, dvol = _weights_bwd(pts_g, img, gw, B, G, ctx.precision)
        return dpts.to(pts_g.dtype), dvol.to(vol_all.dtype), None


def shared_core(pts_g, vol_all, precision: str = "bf16"):
    """All-bone trilinear weights at shared grid points: w [N, B], with
    its gradient in pts_g and vol_all (row 7: forward and backward
    kernels, plain versions for CPU tensors)."""
    return _SharedCore.apply(pts_g.float().contiguous(), vol_all, precision)


def shared_layout(motion_weights_vol) -> torch.Tensor:
    """vol [B+1, G, G, G] -> vol_all [G*G, B*G], vol_all[y*G + x, b*G + z]
    = vol[b, z, y, x] (the shared-tap kernels' layout)."""
    B = motion_weights_vol.shape[0] - 1
    G = motion_weights_vol.shape[1]
    return motion_weights_vol[:B].permute(2, 3, 0, 1).reshape(
        G * G, B * G).contiguous()


def bone_weights(pts, motion_weights_vol, cnl_bbox_min_xyz,
                 cnl_bbox_scale_xyz, *, precision: str = "bf16"):
    """All-bone weights [N, B] at world points (the JAX `bone_weights`,
    lbs.py:2671-2686): the points move to grid coordinates, then
    `shared_core`."""
    G = motion_weights_vol.shape[1]
    s, o = _grid_affine(cnl_bbox_min_xyz, cnl_bbox_scale_xyz, G)
    pts_g = pts.float() * s[None, :] + o[None, :]
    return shared_core(pts_g, shared_layout(motion_weights_vol), precision)


# ---------------------------------------------------------------------------
# fused forward LBS: forward kernel (B5 fwd), backward kernel (B5 bwd)
# ---------------------------------------------------------------------------

def shared_blend_plain(pts_g, vol_all, rmat, precision: str = "bf16"):
    """Plain version of the fused forward LBS (`_shared_blend_fwd_kernel`,
    lbs.py:1796-1817): per sample the 4 xy taps are shared by every bone;
    zc[b, z] = sum_xy bf16(hx hy) bf16(vol); w_b = sum_z bf16(zc hz);
    A = w rmat (f32); acc_kc = ((P0 A0 + P1 A1) + P2 A2) + A3 at columns
    12k + 4c + j, P = the grid point; out = [acc_0, .., acc_{K-1}, sum w].
    pts_g [N, 3] grid coordinates; vol_all [G*G, B*G] with
    vol_all[y*G + x, b*G + z]; rmat [B, 12K]. Returns [N, 3K + 1]."""
    G, B, K = _blend_dims(vol_all, rmat)
    rnd = _rounder(precision)
    vol = _vol_for(vol_all, precision).float()
    P, _, tz, zc = _shared_taps(pts_g, G, B, rnd, vol)
    w = _blend_weights(zc, tz, rnd)
    A = w @ rmat.float()
    cols = []
    for k in range(K):
        for c in range(3):
            j = 12 * k + 4 * c
            cols.append(((P[0] * A[:, j] + P[1] * A[:, j + 1])
                         + P[2] * A[:, j + 2]) + A[:, j + 3])
    return torch.stack(cols + [w.sum(1)], 1)


def shared_blend_bwd_plain(pts_g, vol_all, rmat, k0, gout,
                           precision: str = "bf16", dtype=torch.float32):
    """Plain version of the fused forward-LBS backward
    (`_shared_blend_bwd_kernel`, lbs.py:1820-1883), on rows from the
    clamped k0 * 512 on (the rows below get dpts 0 and add nothing):
      q[12k+4c+j] = g_kc P_j (P_3 = 1); drmat = w^T q (f32);
      dw = q rmat^T + g_w computed exactly (f64 from the f32 inputs) and
      rounded once, gw = bf16(dw) (the `expand` matmul's rounding point;
      no summation order can move it);
      dvol[q_xy, b*G+z] += bf16(hx hy) bf16(gw_b hz);
      U_xy = sum_{b,z} bf16(gw_b hz) bf16(vol); dfx = sum_xy dhat(fx) hy U,
      dfy = sum_xy hx dhat(fy) U, dfz = sum_b gw_b sum_z dhat(fz) zc;
      dpts = (dfx, dfy, dfz) + sum_kc g_kc A[12k+4c+j].
    dtype=torch.float64 evaluates the same contract in f64 arithmetic,
    each bf16 rounding point rounding its f64 value once: the oracle
    that tells which side's summation order flips a rounding.
    Returns (dpts [N, 3], dvol [G*G, B*G], drmat [B, 12K]) in dtype."""
    G, B, K = _blend_dims(vol_all, rmat)
    rnd = _rounder(precision, dtype)
    n = pts_g.shape[0]
    first = first_live_row(0 if k0 is None else k0, n, TILE_SH)
    vol = _vol_for(vol_all, precision).to(dtype)
    rm = rmat.to(dtype)
    P, xy, tz, zc = _shared_taps(pts_g[first:], G, B, rnd, vol)
    w = _blend_weights(zc, tz, rnd)
    A = w @ rm
    g = gout[first:].to(dtype)
    ones = torch.ones_like(P[0])
    q = torch.stack([g[:, 3 * k + c] * pj for k in range(K)
                     for c in range(3) for pj in (*P, ones)], 1)
    drmat = w.T @ q
    gw = _exact_dw(g, P, rm, K, precision).to(dtype)
    direct = [sum(g[:, 3 * k + c] * A[:, 12 * k + 4 * c + j]
                  for k in range(K) for c in range(3)) for j in range(3)]
    (dfx, dfy, dfz), dvol = _tap_grads(xy, tz, zc, gw, vol, G, B, rnd)
    dpts = torch.zeros(n, 3, device=pts_g.device, dtype=dtype)
    dpts[first:] = torch.stack([dfx + direct[0], dfy + direct[1],
                                dfz + direct[2]], 1)
    return dpts, dvol, drmat


def _exact_dw(g, P, rm, K: int, precision: str):
    """B5's dw = q rmat^T + g_w in f64 from its f32 inputs (each q = g_kc
    P_j and each product exact or within 1e-16), rounded once to the
    precision (bf16 straight from f64; 'highest' keeps f64, which the
    caller's dtype rounds): what the kernel computes."""
    g64, rm64 = g.double(), rm.double()
    q = torch.stack([g64[:, 3 * k + c] * pj.double()
                     for k in range(K) for c in range(3)
                     for pj in (*P, torch.ones_like(P[0]))], 1)
    dw = q @ rm64.T + g64[:, 3 * K:3 * K + 1]
    return _round_bf16_f64(dw) if precision == "bf16" else dw


def _check_blend(pts_g, vol_all, rmat):
    G, B, K = _blend_dims(vol_all, rmat)
    n = pts_g.shape[0]
    if pts_g.shape != (n, 3) or K not in (1, 2) or B > MAX_BONES:
        raise ValueError(f"kernel takes pts_g [n, 3], K in (1, 2), B <= "
                         f"{MAX_BONES}; got {tuple(pts_g.shape)}, K={K}, "
                         f"B={B}")
    _check_cuda("forward LBS", pts_g.device, ("pts_g", pts_g),
                ("rmat", rmat))
    if vol_all.device != pts_g.device:
        raise ValueError(f"vol_all is on {vol_all.device}, not "
                         f"{pts_g.device}")
    return G, B, K, n


def _blend_fwd(pts_g, img, rmat, k0_t, B: int, G: int, K: int,
               precision: str):
    n, dev = pts_g.shape[0], pts_g.device
    out = torch.empty(n, 3 * K + 1, device=dev, dtype=torch.float32)
    lib = _blend_lib()
    rc = lib.hosnerf_shared_blend_fwd(
        pts_g.data_ptr(), img.data_ptr(), rmat.data_ptr(), k0_t.data_ptr(),
        out.data_ptr(), n, B, G, K, int(precision == "bf16"),
        torch.cuda.current_stream(dev).cuda_stream)
    shared_blend_fwd.launches += 1
    _build.check(rc, lib, "shared_blend_fwd")
    return out


def _blend_bwd(pts_g, img, rmat, k0_t, gout, B: int, G: int, K: int,
               precision: str):
    n = pts_g.shape[0]
    gout = gout.float().contiguous()
    if gout.shape != (n, 3 * K + 1) or gout.device != pts_g.device:
        raise ValueError("gout must be [n, 3K + 1] on the device of pts_g")
    return _tap_bwd(shared_blend_bwd, pts_g, img, gout, rmat, k0_t, B, G, K,
                    precision)


def shared_blend_fwd(pts_g, vol_all, rmat, k0=None, precision: str = "bf16"):
    """B5 forward: [N, 3K + 1]. Rows below the clamped k0 * 512 are
    unspecified (the kernel leaves them unwritten). A CPU tensor runs
    `shared_blend_plain` (every row); a CUDA tensor runs the kernel of
    csrc/lbs_forward.cu (or raises)."""
    if pts_g.device.type == "cpu":
        return shared_blend_plain(pts_g, vol_all, rmat, precision)
    if not pts_g.is_cuda:
        raise ValueError(f"unsupported device {pts_g.device}")
    G, B, K, _ = _check_blend(pts_g, vol_all, rmat)
    return _blend_fwd(pts_g, shared_image(vol_all, precision), rmat,
                      _k0_tensor(k0, pts_g.device), B, G, K, precision)


shared_blend_fwd.launches = 0


def shared_blend_bwd(pts_g, vol_all, rmat, k0, gout,
                     precision: str = "bf16"):
    """B5 backward: (dpts [N, 3], dvol [G*G, B*G], drmat [B, 12K]) over
    rows from the clamped k0 * 512 on; dpts rows below it are 0. A CPU
    tensor runs `shared_blend_bwd_plain`; a CUDA tensor the binned kernels
    of csrc/lbs_forward.cu (or raises). dvol sums in fixed point, drmat by
    per-CTA slots over a stable binning, summed in order: the same inputs
    on one card give the same bits."""
    if pts_g.device.type == "cpu":
        return shared_blend_bwd_plain(pts_g, vol_all, rmat, k0, gout,
                                      precision)
    if not pts_g.is_cuda:
        raise ValueError(f"unsupported device {pts_g.device}")
    G, B, K, _ = _check_blend(pts_g, vol_all, rmat)
    return _blend_bwd(pts_g, shared_image(vol_all, precision), rmat,
                      _k0_tensor(k0, pts_g.device), gout, B, G, K,
                      precision)


shared_blend_bwd.launches = 0


class _SharedBlend(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pts_g, vol_all, rmat, k0, precision):
        ctx.precision = precision
        if pts_g.device.type == "cpu":
            ctx.save_for_backward(pts_g, vol_all, rmat, k0, None)
            return shared_blend_fwd(pts_g, vol_all, rmat, k0, precision)
        G, B, K, _ = _check_blend(pts_g, vol_all, rmat)
        img = shared_image(vol_all, precision)
        ctx.save_for_backward(pts_g, vol_all, rmat, k0, img)
        return _blend_fwd(pts_g, img, rmat, k0, B, G, K, precision)

    @staticmethod
    def backward(ctx, gout):
        pts_g, vol_all, rmat, k0, img = ctx.saved_tensors
        if img is None:
            dpts, dvol, drmat = shared_blend_bwd(pts_g, vol_all, rmat, k0,
                                                 gout, ctx.precision)
        else:
            G, B, K = _blend_dims(vol_all, rmat)
            dpts, dvol, drmat = _blend_bwd(pts_g, img, rmat, k0, gout, B, G,
                                           K, ctx.precision)
        return (dpts.to(pts_g.dtype), dvol.to(vol_all.dtype),
                drmat.to(rmat.dtype), None, None)


def shared_blend_core(pts_g, vol_all, rmat, k0=None,
                      precision: str = "bf16"):
    """Fused forward LBS: shared-tap weights + K-set affine blend, with
    its gradient in pts_g, vol_all and rmat (forward B5 fwd, backward B5
    bwd; plain versions for CPU tensors). k0: first live 512-row block
    (a device tensor or int; clamped to n_blocks - 1): the kernel skips
    the rows below it forward and backward and leaves their outputs
    unwritten."""
    k0_t = _k0_tensor(k0, pts_g.device)
    return _SharedBlend.apply(pts_g, vol_all, rmat, k0_t, precision)


@functools.cache
def _blend_lib() -> ctypes.CDLL:
    lib = _build.load("lbs_forward")
    p = ctypes.c_void_p
    i = ctypes.c_int
    _build.declare(lib, "hosnerf_lbs_image", [p, i, p, i, i, i, p])
    _build.declare(lib, "hosnerf_shared_blend_fwd",
                   [p, p, p, p, p, i, i, i, i, i, p])
    _build.declare(lib, "hosnerf_shared_weights_fwd",
                   [p, p, p, i, i, i, i, p])
    _build.declare(lib, "hosnerf_shared_tap_scratch", [i, i, i, i])
    _build.declare(lib, "hosnerf_shared_tap_bwd",
                   [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p])
    return lib


def blend_tables(motion_scale_Rs_fwd, motion_Ts_fwd, motion_weights_vol,
                 bbox_min, bbox_scale):
    """The forward-LBS folds (lbs.py:2646-2660): (s, o, vol_all
    [G*G, B*G] with vol_all[y*G + x, b*G + z] = vol[b, z, y, x], rmat
    [B, 12K] with column 12k + 4c + j holding R' = R diag(1/s) (j < 3) and
    T' = T - R' o (j = 3), the world-output affine of grid inputs)."""
    G = motion_weights_vol.shape[1]
    K = motion_scale_Rs_fwd.shape[0]
    s, o = _grid_affine(bbox_min, bbox_scale, G)
    vol_all = shared_layout(motion_weights_vol)
    Rp = motion_scale_Rs_fwd * (1.0 / s)[None, None, None, :]
    Tp = motion_Ts_fwd - torch.einsum("kbcj,j->kbc", Rp, o)
    rmat = torch.cat([torch.cat([Rp[k, :, c, :], Tp[k, :, c:c + 1]], dim=1)
                      for k in range(K) for c in range(3)], dim=1)
    return s, o, vol_all, rmat.contiguous()


def forward_lbs_multi(pts, motion_scale_Rs_fwd, motion_Ts_fwd,
                      motion_weights_vol, cnl_bbox_min_xyz,
                      cnl_bbox_scale_xyz, *, precision: str = "bf16",
                      k0_blocks=None):
    """Fused forward LBS for K transform sets at shared canonical points:
    (x_deform [K, N, 3], wsum [N, 1]). pts [N, 3] world; Rs_fwd
    [K, B, 3, 3]; Ts_fwd [K, B, 3]. Autograd carries the folds
    (pts_g = pts s + o, rmat) around `shared_blend_core`. k0_blocks: first
    live 512-row block of liveness-sorted points (rows below it come back
    unspecified and must be masked)."""
    s, o, vol_all, rmat = blend_tables(
        motion_scale_Rs_fwd, motion_Ts_fwd, motion_weights_vol,
        cnl_bbox_min_xyz, cnl_bbox_scale_xyz)
    K = motion_scale_Rs_fwd.shape[0]
    pts_g = (pts.float() * s[None, :] + o[None, :]).contiguous()
    out = shared_blend_core(pts_g, vol_all, rmat, k0_blocks, precision)
    wsum = out[:, 3 * K:3 * K + 1]
    m = torch.clamp(wsum, min=1e-4)
    acc = out[:, :3 * K].reshape(-1, K, 3)
    return acc.permute(1, 0, 2) / m[None], wsum
