"""Pair counts of the JAX package's pair-grid inverse LBS: the constants,
the tile predicates and the sort keys that `tools/bench_lbs_pg.py`,
`pg_density_study.py` and `pg_window_study.py` read from
`hosnerf_tpu/ops/pallas/lbs.py`, as the port's own copy. It counts only:
it builds no pair table and runs no kernel.

The TPU kernels visit one (tile of TILE_PG samples, quad of NGB bones)
pair per alive quad; `_compact_pairs` packs each tile's alive bones into
quads, quad 0 forced alive so that every tile's output is written. The
pair density is that count over the capacity n_tiles * BPD / NGB. The
Hopper kernels (`ops/cuda/lbs.py`) take no tables: they skip each
(sample, bone) pair whose cell lies off the grid. These counts say how
much of the TPU schedule's work the port's inputs would keep, at the
TPU's tile and at the port's block of INV_TILE rows.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from hosnerf_tpu_torch.ops.cuda import lbs as clbs

TILE_PG = 128      # samples per pair tile (HOSNERF_TILE_PG's default)
S = 128            # samples per ray of the JAX tools' points


def pg_pad_shapes(B: int, G: int) -> Tuple[int, int]:
    """(NGB, BPD) of `_pg_pad_shapes`: NGB = 128 // G bones per quad; BPD
    the bones padded to a quad multiple with at least one dummy channel."""
    ngb = 128 // G
    bp = -(-B // ngb) * ngb
    return ngb, bp if bp > B else bp + ngb


def capacity(n_tiles: int, B: int, G: int) -> int:
    """The static pair capacity n_tiles * (BPD // NGB)."""
    ngb, bpd = pg_pad_shapes(B, G)
    return n_tiles * (bpd // ngb)


def production_points(n_patches: int, device, patch_size: int = 32,
                      G: int = 32, seed: int = 0):
    """The JAX tools' production-shaped points: the rays of
    `synthetic.human_batch(n_patches, patch_size, grid_size=G)` sampled at
    S evenly spaced depths from near to far, and the grid-space bone
    affines of `core/body.py::motion_bases` (`ops/cuda/lbs.py::
    grid_tables`). Returns (pts [R S, 3], rg [B, 9], tg [B, 3], tables)
    with tables = (m_sR, m_T, bbox_min, bbox_scale)."""
    from hosnerf_tpu_torch.core import body
    from hosnerf_tpu_torch.data import synthetic
    b = {k: torch.as_tensor(v, device=device) for k, v in
         synthetic.human_batch(n_patches, patch_size, seed=seed,
                               grid_size=G).items()}
    t = torch.linspace(0.0, 1.0, S, device=device)
    z = b["near"] * (1 - t)[None, :] + b["far"] * t[None, :]
    pts = (b["rays_o"][:, None, :]
           + b["rays_d"][:, None, :] * z[..., None]).reshape(-1, 3)
    m_sR, m_T, _, _ = body.motion_bases(b["dst_Rs"], b["dst_Ts"],
                                        b["cnl_gtfms"])
    bmin, bscale = b["cnl_bbox_min_xyz"], b["cnl_bbox_scale_xyz"]
    s, o = clbs._grid_affine(bmin, bscale, G)
    B = m_sR.shape[0]
    rg = (m_sR * s[None, :, None]).reshape(B, 9)
    tg = m_T * s[None, :] + o[None, :]
    return pts.float(), rg.float(), tg.float(), (m_sR, m_T, bmin, bscale)


def pad_rows(x, tile: int):
    """(x with zero rows appended to a multiple of `tile`, the true rows)."""
    n = x.shape[0]
    pad = (-n) % tile
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return x, n


def aabb_alive(pts_s, rg, tg, G: int, tile: int = TILE_PG):
    """[n_tiles, B] bool: `_build_pairs`' AABB predicate. Bone b can touch
    a tile iff the interval of its grid coordinates over the tile's
    bounding box meets (-1, G) on every axis (widened by PG_EPS)."""
    p = pts_s.reshape(-1, tile, 3)
    lo, hi = p.min(1).values, p.max(1).values
    R = rg.reshape(-1, 3, 3)
    a = lo[:, None, None, :] * R[None]
    b = hi[:, None, None, :] * R[None]
    fmin = torch.minimum(a, b).sum(-1) + tg[None]
    fmax = torch.maximum(a, b).sum(-1) + tg[None]
    return torch.all((fmax > -1.0 - clbs.PG_EPS)
                     & (fmin < G + clbs.PG_EPS), dim=-1)


def exact_alive(sup, tile: int = TILE_PG):
    """[n_tiles, B] bool: a tile is alive for a bone iff one of its samples
    lies in the bone's exact support (`sup` [n, B], n a tile multiple)."""
    return sup.reshape(-1, tile, sup.shape[1]).any(dim=1)


def n_pairs(alive, G: int) -> int:
    """`_compact_pairs`' pair count of a [n_tiles, B] alive matrix: per
    tile ceil(alive bones / NGB) quads, at least one (quad 0 forced)."""
    ngb = 128 // G
    count = alive.sum(dim=1)
    return int(torch.clamp(-(-count // ngb), min=1).sum())


def density(alive, G: int) -> Tuple[int, int]:
    """(pairs, capacity) of a [n_tiles, B] alive matrix."""
    return n_pairs(alive, G), capacity(alive.shape[0], alive.shape[1], G)


def rows_of(gperm):
    """Group permutation -> row permutation (SORT_GROUP rows a group)."""
    return clbs._row_perms(gperm)[0]


def group_keys(pts_p, sup) -> Dict[str, torch.Tensor]:
    """{'morton', 'sig'}: each SORT_GROUP-row group's Morton key of its
    centroid cell (`_group_sort_perm`'s `_morton3`) and the signature of
    its OR'd support bits (`sup` [n_pad, B], bit b = bone b)."""
    g = sup.reshape(-1, clbs.SORT_GROUP, sup.shape[1]).any(dim=1)
    return {"morton": clbs._morton_cells(pts_p), "sig": clbs._signature(g)}


def group_orders(keys, B: int) -> Dict[str, torch.Tensor]:
    """Group permutations by stable sorts of the keys (jnp.argsort and
    jnp.lexsort are stable): 'morton', 'sig', 'sigmorton' (signature, then
    Morton key), 'mortonsig' (Morton key, then signature)."""
    m, s = keys["morton"], keys["sig"]
    mb = 3 * clbs.MORTON_BITS
    return {"morton": torch.argsort(m, stable=True),
            "sig": torch.argsort(s, stable=True),
            "sigmorton": torch.argsort((s << mb) | m, stable=True),
            "mortonsig": torch.argsort((m << B) | s, stable=True)}


def bench_density(pts, rg, tg, G: int, tile: int = TILE_PG):
    """`tools/bench_lbs_pg.py`'s pair density: the rows padded to `tile`,
    sorted by `_group_sort_perm`'s Morton order, `_build_pairs`' AABB
    predicate. Returns (pairs, capacity)."""
    pts_p, _ = pad_rows(pts, tile)
    gperm = torch.argsort(clbs._morton_cells(pts_p), stable=True)
    return density(aabb_alive(pts_p[rows_of(gperm)], rg, tg, G, tile), G)
