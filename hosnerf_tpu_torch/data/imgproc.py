"""The image operations of the host pipeline, in numpy and the standard
library, in place of the cv2 calls of the JAX package's data modules.

Each function names the cv2 call it stands in for and gives its result:
PNG read (`cv2.imread`) and write (`cv2.imwrite`), `cv2.resize` (area at
integer factors, bilinear, nearest, Lanczos-4), `cv2.undistort` and
`cv2.Rodrigues` both ways. Colour images are in cv2's BGR channel order,
as cv2 returns them; callers flip to RGB where cv2's callers call
`cvtColor`. JPEG is not decoded here (see `data/scene_loader.py`).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

INTER_NEAREST, INTER_LINEAR, INTER_AREA, INTER_LANCZOS4 = 0, 1, 3, 4

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}        # gray, RGB, RGBA (8 bits each)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, typ = struct.unpack(">I4s", data[pos:pos + 8])
        yield typ, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if typ == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int,
              path: str) -> np.ndarray:
    """The reconstructed bytes [h, w, bpp] of `raw`, h rows of one filter
    byte and w * bpp filtered bytes (PNG spec, section 9)."""
    rows = raw.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    filt = rows[:, 1:].reshape(h, w, bpp)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {ftype.max()}")
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub, Up: whole-row operations; Sub is a running sum of each
        # channel along the row, modulo 256
        out = np.empty_like(filt)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            f = ftype[r]
            if f == 0:
                out[r] = filt[r]
            elif f == 1:
                out[r] = np.cumsum(filt[r], axis=0, dtype=np.uint8)
            else:
                out[r] = filt[r] + prev
            prev = out[r]
        return out
    # Average and Paeth read the reconstructed left neighbour, so a row is
    # not one vector operation. Pixel (r, x) depends on (r, x - 1),
    # (r - 1, x) and (r - 1, x - 1): every pixel of one anti-diagonal
    # r + x = d depends only on earlier ones, so each diagonal is one
    # vector step over rows and channels, whatever each row's filter.
    X = np.zeros((h + 1, w + 1, bpp), np.int32)   # X[r + 1, x + 1] = (r, x)
    F = filt.astype(np.int32)
    ft = ftype.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = X[r + 1, x], X[r, x + 1], X[r, x]
        kind = ft[r][:, None]
        pred = np.where(kind == 1, a, np.where(kind == 2, b, np.where(
            kind == 3, (a + b) >> 1, np.where(kind == 4, _paeth(a, b, c),
                                              0))))
        X[r + 1, x + 1] = (F[r, x] + pred) & 255
    return X[1:, 1:].astype(np.uint8)


def imread_png(path: str, color: bool = False) -> np.ndarray:
    """`cv2.imread(path, cv2.IMREAD_UNCHANGED)` of an 8-bit PNG (color=
    False): [H, W] gray, [H, W, 3] BGR or [H, W, 4] BGRA uint8. With
    color=True, `cv2.imread(path)` (IMREAD_COLOR): always [H, W, 3] BGR,
    gray replicated and alpha dropped. Reads non-interlaced gray, RGB and
    RGBA files with any of the five row filters; raises ValueError on
    palette, gray-alpha, 16-bit, interlaced or transparent-colour
    (tRNS) files."""
    with open(path, "rb") as f:
        data = f.read()
    hdr, idat = None, []
    for typ, body in _chunks(data, path):
        if typ == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif typ == b"IDAT":
            idat.append(body)
        elif typ in (b"PLTE", b"tRNS"):
            raise ValueError(f"{path}: PNG {typ.decode()} chunk "
                             "(palette or transparent colour) not read")
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}: only 8-bit "
                         "non-interlaced gray, RGB and RGBA are read")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes for "
                         f"{w}x{h}x{bpp}")
    img = _unfilter(raw, h, w, bpp, path)
    if bpp == 1:
        img = img[..., 0]
        return np.repeat(img[..., None], 3, -1) if color else img
    if color:
        img = img[..., :3]
    order = [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])
    return np.ascontiguousarray(img[..., order])


def _chunk(typ: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + typ + body
            + struct.pack(">I", zlib.crc32(typ + body) & 0xFFFFFFFF))


def imwrite_png(path: str, img: np.ndarray) -> None:
    """`cv2.imwrite(path, img)` for a PNG path: img uint8 [H, W] gray,
    [H, W, 3] BGR or [H, W, 4] BGRA, stored with row filter 0 (None) at
    zlib level 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"imwrite_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        ctype, px = 0, img[..., None]
    elif img.ndim == 3 and img.shape[-1] in (3, 4):
        ctype = 2 if img.shape[-1] == 3 else 6
        px = img[..., [2, 1, 0] + ([3] if ctype == 6 else [])]
    else:
        raise ValueError(f"imwrite_png: image of shape {img.shape}")
    h, w = px.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, -1)], 1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def _lanczos4_coeffs(x: np.ndarray) -> np.ndarray:
    """cv2's `interpolateLanczos4` for each fractional offset x in [0, 1):
    8 float32 taps at x + 3 - i (i = 0..7), each sin(y) sin(y / 4) /
    (y^2 / 4) in closed form, 1e30 at a zero offset, then normalised by
    the float32 sum of the eight."""
    s45 = 0.70710678118654752440084436210485
    cs = np.array([[1, 0], [-s45, -s45], [0, 1], [s45, -s45], [-1, 0],
                   [s45, s45], [0, -1], [-s45, s45]])
    xf = x.astype(np.float32)
    y0 = -(xf.astype(np.float64) + 3) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.empty(x.shape + (8,), np.float32)
    for i in range(8):
        y0_ = (xf + np.float32(3 - i)).astype(np.float32)
        y = -y0_.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            v = ((cs[i, 0] * s0 + cs[i, 1] * c0) / (y * y)).astype(
                np.float32)
        coeffs[..., i] = np.where(np.abs(y0_) >= np.float32(1e-6), v,
                                  np.float32(1e30))
    total = np.zeros(x.shape, np.float32)
    for i in range(8):
        total = (total + coeffs[..., i]).astype(np.float32)
    return (coeffs * (np.float32(1) / total)[..., None]).astype(np.float32)


def _taps(dst: int, src: int, scale: float, kind: int):
    """Source indices [dst, k] (border replicated) and float32 weights
    [dst, k] along one axis, as cv2's resize sets them up."""
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(np.float32)).astype(np.float32)
    if kind == INTER_LINEAR:
        # cv2 pins the border taps: offset 0 at the first or last pixel
        lo, hi = s < 0, s >= src - 1
        frac = np.where(lo | hi, np.float32(0), frac)
        s = np.where(lo, 0, np.where(hi, src - 1, s))
        idx = np.stack([s, s + 1], -1)
        wts = np.stack([np.float32(1) - frac, frac], -1)
    else:
        idx = s[:, None] + np.arange(-3, 5)[None]
        wts = _lanczos4_coeffs(frac)
    return np.clip(idx, 0, src - 1), wts.astype(np.float32)


def _separable(img: np.ndarray, dsize: Tuple[int, int], sx: float,
               sy: float, kind: int) -> np.ndarray:
    h, w = img.shape[:2]
    dw, dh = dsize
    xi, xw = _taps(dw, w, sx, kind)
    yi, yw = _taps(dh, h, sy, kind)
    # horizontal pass, then vertical, each summed tap by tap in float32
    bshape = (1, dw) + (1,) * (img.ndim - 2)
    tmp = np.zeros((h, dw) + img.shape[2:], np.float32)
    for k in range(xi.shape[1]):
        tmp = tmp + img[:, xi[:, k]] * xw[:, k].reshape(bshape)
    out = np.zeros((dh, dw) + img.shape[2:], np.float32)
    vshape = (dh,) + (1,) * (img.ndim - 1)
    for k in range(yi.shape[1]):
        out = out + tmp[yi[:, k]] * yw[:, k].reshape(vshape)
    return out


def _area(img: np.ndarray, f: int) -> np.ndarray:
    """cv2's fast area resize at integer factor f: the block mean, each
    block summed as cv2's scalar loop does (taps in row-major order, four
    at a time left to right, the fours added to a running sum) times
    1 / f^2; 2x2 blocks of 1- and 4-channel images as its vector loop does
    them, ((a + b) + (c + d)) / 4."""
    h, w = img.shape[:2]
    blocks = img.reshape((h // f, f, w // f, f) + img.shape[2:])
    taps = [blocks[:, i, :, j] for i in range(f) for j in range(f)]
    cn = 1 if img.ndim == 2 else img.shape[2]
    if f == 2 and cn in (1, 4):
        return ((taps[0] + taps[1]) + (taps[2] + taps[3])) * np.float32(0.25)
    total = np.zeros_like(taps[0])
    for k in range(0, len(taps), 4):
        group = taps[k]
        for t in taps[k + 1:k + 4]:
            group = group + t
        total = total + group
    return total * np.float32(1.0 / (f * f))


def resize(img: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
           fx: float = 0.0, fy: float = 0.0,
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """`cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=...)` of a
    float32 [H, W] or [H, W, C] image; dsize is (width, height), or None
    to take round(W * fx) x round(H * fy).

    INTER_AREA: integer downscale factors that divide the image (a block
    mean; other area resizes raise). INTER_LINEAR: half-pixel centres, no
    antialiasing, border replicated (at exactly 2x down cv2 switches to
    the area mean, as here). INTER_NEAREST: source index floor(x * src /
    dst), not half-pixel. INTER_LANCZOS4: 8 taps around each half-pixel
    centre with cv2's normalised coefficients, border replicated."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise ValueError(f"resize takes float32 images, got {img.dtype}")
    h, w = img.shape[:2]
    if dsize is None or tuple(dsize) == (0, 0):
        if not (fx > 0 and fy > 0):
            raise ValueError("resize: give dsize or positive fx and fy")
        dsize = (int(round(w * fx)), int(round(h * fy)))
        inv_x, inv_y = fx, fy
    else:
        inv_x, inv_y = dsize[0] / w, dsize[1] / h
    dw, dh = int(dsize[0]), int(dsize[1])
    if (dw, dh) == (w, h):
        return img.copy()
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    isx, isy = int(round(sx)), int(round(sy))
    area_fast = (abs(sx - isx) < np.finfo(float).eps
                 and abs(sy - isy) < np.finfo(float).eps)
    if interpolation == INTER_LINEAR and area_fast and isx == isy == 2:
        interpolation = INTER_AREA
    if interpolation == INTER_NEAREST:
        xs = np.minimum(np.floor(np.arange(dw) * sx).astype(np.int64), w - 1)
        ys = np.minimum(np.floor(np.arange(dh) * sy).astype(np.int64), h - 1)
        return img[ys][:, xs]
    if interpolation == INTER_AREA:
        if not (area_fast and isx == isy and isx >= 1 and h == dh * isy
                and w == dw * isx):
            raise ValueError(f"resize INTER_AREA from {w}x{h} to {dw}x{dh}: "
                             "only integer factors that divide the image")
        return _area(img, isx)
    if interpolation in (INTER_LINEAR, INTER_LANCZOS4):
        return _separable(img, (dw, dh), sx, sy, interpolation)
    raise ValueError(f"resize: interpolation {interpolation} not supported")


# ---------------------------------------------------------------------------
# undistort
# ---------------------------------------------------------------------------

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS


def _distortion(D: Sequence[float]):
    d = np.zeros(8)
    D = np.asarray(D, np.float64).ravel()
    if D.size not in (4, 5, 8):
        raise ValueError(f"undistort: {D.size} distortion coefficients "
                         "(4, 5 or 8 are read)")
    d[:D.size] = D
    return d


def undistort(img: np.ndarray, K: np.ndarray,
              D: Sequence[float]) -> np.ndarray:
    """`cv2.undistort(img, K, D)` (newCameraMatrix = K) of a float32
    [H, W] or [H, W, C] image: each destination pixel's ray through K^-1
    goes through the forward distortion model (k1, k2, p1, p2[, k3[, k4,
    k5, k6]]) and back through K, the source position is rounded
    to 1/32 pixel as cv2's fixed-point maps round it, and the image is
    sampled bilinearly there with a zero border."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise ValueError(f"undistort takes float32 images, got {img.dtype}")
    h, w = img.shape[:2]
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = _distortion(D)
    ir = np.linalg.inv(K)
    j, i = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64), indexing="xy")
    X = j * ir[0, 0] + i * ir[0, 1] + ir[0, 2]
    Y = j * ir[1, 0] + i * ir[1, 1] + ir[1, 2]
    W = j * ir[2, 0] + i * ir[2, 1] + ir[2, 2]
    x, y = X / W, Y / W
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    iu = np.rint(u * INTER_TAB_SIZE).astype(np.int64)
    iv = np.rint(v * INTER_TAB_SIZE).astype(np.int64)
    sx, sy = iu >> INTER_BITS, iv >> INTER_BITS
    ax = ((iu & (INTER_TAB_SIZE - 1)).astype(np.float32)
          * np.float32(1.0 / INTER_TAB_SIZE))
    ay = ((iv & (INTER_TAB_SIZE - 1)).astype(np.float32)
          * np.float32(1.0 / INTER_TAB_SIZE))
    one = np.float32(1)
    wts = ((one - ay) * (one - ax), (one - ay) * ax, ay * (one - ax), ay * ax)
    # a zero border one pixel wide: taps outside the image read 0
    pad = np.zeros((h + 2, w + 2) + img.shape[2:], np.float32)
    pad[1:-1, 1:-1] = img
    inside = (sx >= -1) & (sx < w) & (sy >= -1) & (sy < h)
    cx = np.clip(sx + 1, 0, w)
    cy = np.clip(sy + 1, 0, h)
    taps = (pad[cy, cx], pad[cy, cx + 1], pad[cy + 1, cx],
            pad[cy + 1, cx + 1])
    ex = (Ellipsis,) + (None,) * (img.ndim - 2)
    out = ((taps[0] * wts[0][ex] + taps[1] * wts[1][ex])
           + (taps[2] * wts[2][ex] + taps[3] * wts[3][ex]))
    return np.where(inside[ex], out, np.float32(0)).astype(np.float32)


# ---------------------------------------------------------------------------
# Rodrigues
# ---------------------------------------------------------------------------

def rodrigues(rvec) -> np.ndarray:
    """`cv2.Rodrigues(rvec)[0]`: the float64 rotation matrix [3, 3] of an
    axis-angle vector, the identity below DBL_EPSILON, else cos(t) I +
    (1 - cos(t)) r r^T + sin(t) [r]x with cv2's order of operations."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = math.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    c1 = 1.0 - c
    r = r * (1.0 / theta)
    rrt = np.outer(r, r)
    r_x = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]],
                    [-r[1], r[0], 0.0]])
    return (c * np.eye(3) + c1 * rrt) + s * r_x


def _orthonormalize(R: np.ndarray) -> np.ndarray:
    """U V^T of R's singular value decomposition as cv2 computes it for
    `Rodrigues`: its one-sided Jacobi sweeps over the columns (rotations
    skipped below 10 DBL_EPSILON of the column norms, so a matrix that is
    orthonormal to a few ulps keeps its columns), then the product summed
    in cv2's order. numpy's SVD gives the same product to an ulp, which
    acos near theta = pi turns into 1e-9 of the angle."""
    n = 3
    At = [[float(R[k, i]) for k in range(n)] for i in range(n)]
    Vt = [[float(i == k) for k in range(n)] for i in range(n)]

    def sq(v):
        s = 0.0
        for x in v:
            s += x * x
        return s

    W = [sq(a) for a in At]
    eps = 10 * np.finfo(np.float64).eps
    for _ in range(30):
        changed = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                Ai, Aj = At[i], At[j]
                a, b, p = W[i], W[j], 0.0
                for k in range(n):
                    p += Ai[k] * Aj[k]
                if abs(p) <= eps * math.sqrt(a * b):
                    continue
                p *= 2
                beta = a - b
                gamma = float(np.hypot(p, beta))
                if beta < 0:
                    s = math.sqrt((gamma - beta) * 0.5 / gamma)
                    c = p / (gamma * s * 2)
                else:
                    c = math.sqrt((gamma + beta) / (gamma * 2))
                    s = p / (gamma * c * 2)
                for M in (At, Vt):
                    Mi, Mj = M[i], M[j]
                    M[i] = [c * x + s * y for x, y in zip(Mi, Mj)]
                    M[j] = [-s * x + c * y for x, y in zip(Mi, Mj)]
                W[i], W[j] = sq(At[i]), sq(At[j])
                changed = True
        if not changed:
            break
    W = [math.sqrt(sq(a)) for a in At]
    for i in range(n - 1):
        j = max(range(i, n), key=lambda k: (W[k], -k))
        if i != j:
            W[i], W[j] = W[j], W[i]
            At[i], At[j] = At[j], At[i]
            Vt[i], Vt[j] = Vt[j], Vt[i]
    tiny = np.finfo(np.float64).tiny
    At = [[x * (1 / w if w > tiny else 0.0) for x in a]
          for a, w in zip(At, W)]
    out = np.empty((n, n))
    for i in range(n):
        for j in range(n):
            s = 0.0
            for k in range(n):
                s += At[k][i] * Vt[k][j]
            out[i, j] = s
    return out


def rodrigues_inverse(R) -> np.ndarray:
    """`cv2.Rodrigues(R)[0]` of a 3x3 rotation matrix, as a float64 [3]
    axis-angle vector: R made orthonormal as cv2 does, then cv2's
    branches: zero for a near-identity, its sign rules near theta = pi,
    and the skew part scaled by theta / (2 sin theta) elsewhere."""
    R = np.asarray(R, np.float64).reshape(3, 3)
    if not (np.all(np.isfinite(R)) and np.abs(R).max() <= 100):
        return np.zeros(3)
    R = _orthonormalize(R)
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = math.sqrt((r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * 0.25)
    c = (R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5
    c = 1.0 if c > 1.0 else -1.0 if c < -1.0 else c
    theta = math.acos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        r = np.array([
            math.sqrt(max((R[0, 0] + 1) * 0.5, 0.0)),
            math.sqrt(max((R[1, 1] + 1) * 0.5, 0.0))
            * (-1.0 if R[0, 1] < 0 else 1.0),
            math.sqrt(max((R[2, 2] + 1) * 0.5, 0.0))
            * (-1.0 if R[0, 2] < 0 else 1.0)])
        if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
                and (R[1, 2] > 0) != (r[1] * r[2] > 0)):
            r[2] = -r[2]
        theta /= math.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
        return r * theta
    vth = 1.0 / (2.0 * s)
    vth *= theta
    return r * vth
