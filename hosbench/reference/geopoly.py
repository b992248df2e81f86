"""Geodesic-polyhedron basis for mip-NeRF 360's lifted encoding
(a frozen copy of the port's `core/geopoly.py`; numpy)."""

from __future__ import annotations

import itertools

import numpy as np


def _sq_dist(mat0: np.ndarray, mat1: np.ndarray | None = None) -> np.ndarray:
    """Pairwise squared distances between the columns of mat0/mat1 [3, N]."""
    if mat1 is None:
        mat1 = mat0
    n0 = np.sum(mat0**2, 0)
    n1 = np.sum(mat1**2, 0)
    return np.maximum(0.0, n0[:, None] + n1[None, :] - 2 * mat0.T @ mat1)


def _tesselate_faces(verts: np.ndarray, faces: np.ndarray, v: int,
                     eps: float = 1e-4) -> np.ndarray:
    """Barycentrically subdivide each face by factor v, project to the sphere,
    and deduplicate coincident vertices."""
    bary = np.array(
        [(i, j, v - i - j) for i in range(v + 1) for j in range(v + 1 - i)],
        dtype=np.float64) / v

    out = []
    for face in faces:
        pts = bary @ verts[face, :]
        pts /= np.sqrt(np.sum(pts**2, 1, keepdims=True))
        out.append(pts)
    out = np.concatenate(out, 0)

    sq = _sq_dist(out.T)
    first = np.array([np.min(np.argwhere(row <= eps)) for row in sq])
    return out[np.unique(first), :]


def generate_basis(base_shape: str = "icosahedron", angular_tesselation: int = 2,
                   remove_symmetries: bool = True, eps: float = 1e-4) -> np.ndarray:
    """Generate a [3, n] basis by tesselating a polyhedron (the same
    vertices, faces and column order as the JAX package's)."""
    if base_shape == "icosahedron":
        a = (np.sqrt(5) + 1) / 2
        verts = np.array([
            (-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a),
            (0, a, 1), (0, a, -1), (0, -a, 1), (0, -a, -1),
            (a, 1, 0), (-a, 1, 0), (a, -1, 0), (-a, -1, 0),
        ]) / np.sqrt(a + 2)
        faces = np.array([
            (0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
            (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3),
            (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6), (0, 1, 6),
            (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11),
        ])
        verts = _tesselate_faces(verts, faces, angular_tesselation, eps)
    elif base_shape == "octahedron":
        verts = np.array(
            [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0)],
            dtype=np.float64)
        corners = np.array(list(itertools.product([-1, 1], repeat=3)))
        pairs = np.argwhere(_sq_dist(corners.T, verts.T) == 2)
        faces = np.sort(np.reshape(pairs[:, 1], [3, -1]).T, 1)
        verts = _tesselate_faces(verts, faces, angular_tesselation, eps)
    else:
        raise ValueError(f"base_shape {base_shape!r} not supported")

    if remove_symmetries:
        match = _sq_dist(verts.T, -verts.T) < eps
        verts = verts[np.any(np.triu(match), axis=1), :]

    basis = verts[:, ::-1]  # xyz -> zyx column order
    return basis.T.astype(np.float32)  # [3, n]
