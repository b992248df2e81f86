"""The port's host data pipeline against the JAX package's, and its
stand-ins for cv2 and PyYAML against cv2 and PyYAML, on the CPU.

The JAX package's data modules are numpy with cv2 (no JAX runs here), so
everything is compared exactly (`assert_array_equal`, dtypes included)
unless a test states a tolerance: the config readers, PNG read and write,
the camera, ray and pose functions, the mini capture's files, `SceneData`,
`ScenePipeline` batches and `HumanDataset` items from the same seed. The
resampling functions are held to cv2 within the tolerances stated where
they are used (float32 sums in another order).
"""

import dataclasses
import json
import math
import os
import pickle
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
import yaml

from hosnerf_tpu.config import ginlite as jgin
from hosnerf_tpu.config import yamlcfg as jyaml
from hosnerf_tpu.core import smpl as jsmpl
from hosnerf_tpu.data import cameras as jcam
from hosnerf_tpu.data import human_dataset as jhd
from hosnerf_tpu.data import pose_utils as jpose
from hosnerf_tpu.data import rays as jrays
from hosnerf_tpu.data import scene_loader as jsl
from hosnerf_tpu.data import scene_pipeline as jsp
from hosnerf_tpu.data import synthetic as jsyn
from hosnerf_tpu_torch.config import ginlite, yamlcfg
from hosnerf_tpu_torch.core import smpl
from hosnerf_tpu_torch.data import (batches, cameras, human_dataset,
                                    imgproc, pose_utils, rays,
                                    scene_loader, scene_pipeline, synthetic)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
GIN = sorted(f for f in os.listdir(CONFIGS) if f.endswith(".gin"))
YAML = sorted(f for f in os.listdir(CONFIGS) if f.endswith(".yaml"))
RES, FRAMES = 48, 8


def assert_equal(got, ref, path="batch"):
    """Exact equality of nested dicts, lists and arrays, dtypes and
    Python types included."""
    if isinstance(ref, dict):
        assert sorted(got, key=str) == sorted(ref, key=str), path
        for k in ref:
            assert_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_equal(g, r, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref), (path, type(got), type(ref))
        assert got.dtype == ref.dtype, (path, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert type(got) is type(ref) and got == ref, (path, got, ref)


def scale_err(got, ref):
    """Largest error over the reference's largest magnitude."""
    ref = np.asarray(ref, np.float64)
    return (np.abs(np.asarray(got, np.float64) - ref).max()
            / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# config readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GIN)
def test_ginlite_matches_jax(name):
    """Every gin file of configs/, alone and with bindings on top, to the
    same dict and the same dumped text; the same unknown keys."""
    path = [os.path.join(CONFIGS, name)]
    binds = ["NeRFMLP.netwidth = 128", "run.max_steps = 7",
             "LitData.batch_sampler = 'all_images'"]
    for b in (None, binds):
        got = ginlite.parse_config_files_and_bindings(path, b, False)
        ref = jgin.parse_config_files_and_bindings(path, b, False)
        assert_equal(got, ref)
        assert ginlite.dumps(got) == jgin.dumps(ref)
        assert ginlite.scoped(got, "run") == jgin.scoped(ref, "run")
    typo = dict(got, **{"NeRFMLP.netwidht": 3})
    assert ginlite.warn_unknown_keys(typo) == jgin.warn_unknown_keys(typo)


@pytest.mark.parametrize("name", YAML)
def test_yamlcfg_matches_jax(name):
    """Every yaml file of configs/ to the same tree (types included), and
    make_cfg's merge of the two files and overrides."""
    path = os.path.join(CONFIGS, name)
    assert_equal(dict(yamlcfg.load_yaml(path)), dict(jyaml.load_yaml(path)))
    over = {"patch": {"size": 16}, "train": {"lr": 0.1}, "new": [1, 2]}
    got = yamlcfg.make_cfg(path, os.path.join(CONFIGS, YAML[0]), over)
    ref = jyaml.make_cfg(path, os.path.join(CONFIGS, YAML[0]), over)
    assert got == ref and got.patch.size == 16


# PyYAML 6's answers (YAML 1.1): an exponent needs a dot and a sign; '-.5'
# and '0o17' stay strings; yes/no/on/off are booleans
SCALARS = [
    "1e-3", "1.0e3", "1.0e-3", "1.0E+3", ".5", "-.5", "+.5", "1.", "-1.5",
    "1_000", "1_000.5", "0x1F", "-0x1f", "017", "0o17", "08",
    "0", "-0", "+12", "12e3", "3.14",
    "yes", "no", "On", "off", "OFF", "true", "True", "TRUE", "False", "y",
    "n", "~", "null", "Null", "NULL", "nULL", ".inf", "-.inf", "+.INF",
    ".nan", ".NaN", "abc", "a b  c", "it's", "a#b", "x:y", "-1", "--",
    "auto", "f32", "0.0005", "1.0.0", "'quoted 1'", "'a''b'", "''",
    '"dq x"', '"1e3"', "'yes'", "a # comment",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_match_pyyaml(text):
    """Each scalar as a mapping value and as a flow-sequence entry: the
    same value and type as yaml.safe_load."""
    for src, get in ((f"k: {text}\n", lambda d: d["k"]),
                     (f"k: [{text}, 1]\n", lambda d: d["k"][0])):
        if src.startswith("k: [") and "#" in text:
            continue
        ref, got = get(yaml.safe_load(src)), get(yamlcfg.parse_yaml(src))
        assert type(got) is type(ref), (src, got, ref)
        assert got == ref or (isinstance(ref, float) and math.isnan(ref)
                              and math.isnan(got)), (src, got, ref)


DOCS = {
    "nested": "a:\n  b: 1\n  c: [1, 2, \"x\"]\nd: 2\n",
    "indentless_seq": "a:\n- 1\n- 2\nb: x\n",
    "compact_seq_maps": "- a: 1\n  b: 2\n- c\n- - 1\n  - 2\n",
    "comments_nulls": "a: # c\n  b: 1 # d\n# z\ne:\nf: ~\n",
    "flow": "a: []\nb: [1, 2.5, yes]\nc: [a, b,]\nd: ['x, y', \"z\"]\n",
    "empty": "",
    "only_comment": "# nothing\n",
    "typed_keys": "1: a\ntrue: b\n~: c\n1.5: d\n",
    "quoted_keys": "'k: x': 1\n\"y\": 2\n",
    "nested_item": "a:\n  -\n    b: 1\n  - 2\n",
    "duplicate_key": "a: 1\na: 2\n",
    "deep": "a:\n  b:\n    c:\n      - 1\n      - d: [2]\n",
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_yaml_documents_match_pyyaml(name):
    assert_equal(yamlcfg.parse_yaml(DOCS[name]), yaml.safe_load(DOCS[name]))


REJECTED = {
    "anchor": "a: &x 1\n", "alias": "a: *x\n", "tag": "a: !!str 1\n",
    "literal": "a: |\n  x\n", "folded": "a: >\n  x\n",
    "document": "---\na: 1\n", "two_documents": "a: 1\n---\nb: 2\n",
    "directive": "%YAML 1.1\na: 1\n", "flow_mapping": "a: {b: 1}\n",
    "timestamp": "a: 2001-12-14\n", "multi_line_flow": "a: [1,\n 2]\n",
    "multi_line_plain": "a: b\n  c\n", "mapping_in_value": "a: b: c\n",
    "complex_key": "? a\n: b\n", "tab_indent": "a:\n\tb: 1\n",
    "unclosed_quote": "a: 'x\n", "bare_scalar": "a: 1\nb\n",
    "nested_flow": "a: [[1, 2], [3]]\n", "binary": "a: 0b101\n",
    "base_60_int": "a: 190:20:30\n", "base_60_float": "a: [190:20:30.15]\n",
    "escape": "a: \"dq \\t x\"\n",
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_yaml_rejects_constructs_outside_the_subset(name):
    """Each raises ValueError naming its line."""
    with pytest.raises(ValueError, match=r"line \d+"):
        yamlcfg.parse_yaml(REJECTED[name])


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_image(kind, rng, h=37, w=45):
    """A smooth image (so that the writers choose every filter) of
    `kind` channels: gray [h, w], or [h, w, 3] / [h, w, 4]."""
    ramp = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)
    shape = (h, w) if kind == 1 else (h, w, kind)
    noise = rng.integers(0, 40, shape)
    base = ramp if kind == 1 else ramp[..., None] * np.arange(1, kind + 1)
    return ((base + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("level", [0, 3, 9])
@pytest.mark.parametrize("kind", [1, 3, 4])
def test_png_read_matches_cv2(tmp_path, kind, level):
    """cv2-written gray, RGB and RGBA files (libpng's adaptive filters)
    read bit for bit as cv2.imread reads them, unchanged and as colour."""
    img = _png_image(kind, np.random.default_rng(kind + level))
    p = str(tmp_path / "a.png")
    cv2.imwrite(p, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        assert_equal(imgproc.imread_png(p, color), cv2.imread(p, flag))


def _filter_row(kind, cur, prev, bpp):
    """PNG filter `kind` of one row (PNG spec, section 9), in Python."""
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            p = 0
        elif kind == 1:
            p = a
        elif kind == 2:
            p = b
        elif kind == 3:
            p = (a + b) // 2
        else:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - p) % 256
    return bytes([kind]) + bytes(out)


@pytest.mark.parametrize("kind", [1, 3, 4])
def test_png_read_every_row_filter(tmp_path, kind):
    """A file whose rows use all five filters in a random order (written
    by the test's own encoder) reads as cv2.imread reads it."""
    rng = np.random.default_rng(7)
    img = _png_image(kind, rng, 23, 19)
    px = img[..., None] if kind == 1 else img
    raw = px.reshape(px.shape[0], -1)
    bpp = px.shape[-1]
    rows, prev = [], bytes(raw.shape[1])
    for r in range(raw.shape[0]):
        cur = raw[r].tobytes()
        rows.append(_filter_row(int(rng.integers(0, 5)) if r > 4 else r,
                                cur, prev, bpp))
        prev = cur
    ctype = {1: 0, 3: 2, 4: 6}[kind]
    hdr = struct.pack(">IIBBBBB", px.shape[1], px.shape[0], 8, ctype, 0, 0,
                      0)
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(imgproc.PNG_SIGNATURE + imgproc._chunk(b"IHDR", hdr)
                + imgproc._chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + imgproc._chunk(b"IEND", b""))
    ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert_equal(imgproc.imread_png(p), ref)
    if kind > 1:      # the file holds RGB(A); cv2 hands back BGR(A)
        np.testing.assert_array_equal(ref[..., [2, 1, 0]], img[..., :3])


@pytest.mark.parametrize("kind", [1, 3, 4])
def test_png_writer_read_back_by_cv2(tmp_path, kind):
    """imwrite_png's files read back bit for bit by cv2.imread and by
    imread_png."""
    img = _png_image(kind, np.random.default_rng(kind))
    p = str(tmp_path / "w.png")
    imgproc.imwrite_png(p, img)
    assert_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), img)
    assert_equal(imgproc.imread_png(p), img)


def test_png_reader_refuses_what_it_does_not_decode(tmp_path):
    """16-bit, palette and interlaced files raise ValueError."""
    p16 = str(tmp_path / "16.png")
    cv2.imwrite(p16, np.arange(12, dtype=np.uint16).reshape(3, 4))
    cases = {"16": p16}
    for name, ctype, interlace, extra in (
            ("palette", 3, 0, imgproc._chunk(b"PLTE", bytes(6))),
            ("interlaced", 2, 1, b"")):
        p = str(tmp_path / f"{name}.png")
        with open(p, "wb") as f:
            f.write(imgproc.PNG_SIGNATURE + imgproc._chunk(
                b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, ctype, 0, 0,
                                     interlace)) + extra
                + imgproc._chunk(b"IDAT", zlib.compress(bytes(20)))
                + imgproc._chunk(b"IEND", b""))
        cases[name] = p
    for name, p in cases.items():
        with pytest.raises(ValueError):
            imgproc.imread_png(p)


# ---------------------------------------------------------------------------
# resize, undistort, Rodrigues
# ---------------------------------------------------------------------------

RESIZE = {
    "area_2": (imgproc.INTER_AREA, (32, 24), None),
    "area_4": (imgproc.INTER_AREA, (16, 12), None),
    "linear_down": (imgproc.INTER_LINEAR, (50, 30), None),
    "linear_up": (imgproc.INTER_LINEAR, (100, 70), None),
    "linear_half": (imgproc.INTER_LINEAR, (32, 24), None),
    "linear_fx": (imgproc.INTER_LINEAR, None, 0.75),
    "nearest_down": (imgproc.INTER_NEAREST, (50, 30), None),
    "nearest_up": (imgproc.INTER_NEAREST, (100, 77), None),
    "nearest_fx": (imgproc.INTER_NEAREST, None, 1.3),
}


@pytest.mark.parametrize("channels", [0, 3, 4])
@pytest.mark.parametrize("name", sorted(RESIZE))
def test_resize_matches_cv2(name, channels):
    """Area (factors 2 and 4), bilinear and nearest resizes of a float32
    image with values up to 255: within 1e-5 of 255 of cv2.resize
    (float32 sums in another order); area at factor 2-4 and nearest
    exactly."""
    inter, dsize, f = RESIZE[name]
    rng = np.random.default_rng(3)
    img = (rng.random((48, 64) + ((channels,) if channels else ()))
           * 255).astype(np.float32)
    ref = (cv2.resize(img, dsize, interpolation=inter) if f is None else
           cv2.resize(img, None, fx=f, fy=f, interpolation=inter))
    got = imgproc.resize(img, dsize, f or 0.0, f or 0.0, inter)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= 1e-5 * 255, np.abs(got - ref).max()
    if inter != imgproc.INTER_LINEAR:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", [(24, 36), (96, 72)])
def test_resize_flow_matches_jax(hw):
    """human_dataset.resize_flow (bilinear, u scaled by the height ratio
    and v by the width ratio, as the JAX package keeps them): 1e-5 of
    the flow's scale."""
    flow = np.random.default_rng(1).normal(scale=0.5, size=(48, 48, 2)
                                           ).astype(np.float32)
    ref = jhd.resize_flow(flow.copy(), *hw)
    got = human_dataset.resize_flow(flow.copy(), *hw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert scale_err(got, ref) <= 1e-5


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.3])
def test_resize_lanczos4_matches_cv2(scale):
    """Lanczos-4 at fx = fy = scale (human_dataset's resize_img_scale):
    within 1e-4 of the image's scale."""
    img = (np.random.default_rng(4).random((48, 64, 3)) * 255
           ).astype(np.float32)
    ref = cv2.resize(img, None, fx=scale, fy=scale,
                     interpolation=cv2.INTER_LANCZOS4)
    got = imgproc.resize(img, None, scale, scale, imgproc.INTER_LANCZOS4)
    assert got.shape == ref.shape
    assert scale_err(got, ref) <= 1e-4


@pytest.mark.parametrize("ncoef", [4, 5, 8])
def test_undistort_matches_cv2(ncoef):
    """cv2.undistort with newCameraMatrix = K on a colour and a gray
    float32 image, 4, 5 and 8 coefficients: within 1e-4 of the image's
    scale (cv2 rounds the map to 1/32 pixel, as undistort does)."""
    rng = np.random.default_rng(ncoef)
    K = np.array([[60.0, 0, 33.0], [0, 58.0, 22.0], [0, 0, 1]])
    D = np.array([0.1, -0.05, 0.001, -0.002, 0.01, 0.05, 0.01, 0.001]
                 )[:ncoef]
    for shape in ((48, 64, 3), (48, 64)):
        img = (rng.random(shape) * 255).astype(np.float32)
        ref = cv2.undistort(img, K, D)
        got = imgproc.undistort(img, K, D)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert scale_err(got, ref) <= 1e-4


THETAS = [0.0, 1e-20, 1e-9, 1e-6, 0.3, 2.0, math.pi - 1e-3,
          math.pi - 2e-5, math.pi - 1e-7, math.pi]


@pytest.mark.parametrize("theta", THETAS)
def test_rodrigues_matches_cv2(theta):
    """Both directions against cv2.Rodrigues in float64 to 1e-12, over
    axes and angles down to 0 and up to pi, where cv2 has its own
    branches (and acos(-1 + tiny) turns an ulp into 1e-9)."""
    rng = np.random.default_rng(int(theta * 1000))
    axes = [[1, 0, 0], [0, 0, 1], [1, 2, 3], [-1, 0.5, 0.3]]
    axes += list(rng.normal(size=(4, 3)))
    for ax in axes:
        r = np.asarray(ax, np.float64)
        r = r / np.linalg.norm(r) * theta
        R = cv2.Rodrigues(r)[0]
        assert np.abs(imgproc.rodrigues(r) - R).max() <= 1e-12
        v = cv2.Rodrigues(R)[0].ravel()
        assert np.abs(imgproc.rodrigues_inverse(R) - v).max() <= 1e-12, (
            theta, ax)


# ---------------------------------------------------------------------------
# cameras, rays, pose_utils
# ---------------------------------------------------------------------------

def _poses(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 4, 4))
    for i in range(n):
        out[i, :3, :3] = cv2.Rodrigues(rng.normal(scale=0.6, size=3))[0]
        out[i, :3, 3] = rng.normal(size=3) * 2
        out[i, 3, 3] = 1
    return out


def _geo_case():
    rng = np.random.default_rng(5)
    K = np.array([[40.0, 0, 15.5], [0, 42.0, 11.0], [0, 0, 1]], np.float32)
    E = _poses(1)[0].astype(np.float32)
    bounds = {"min_xyz": np.array([-0.5, -0.7, -0.4]),
              "max_xyz": np.array([0.6, 0.5, 0.3])}
    ro = rng.normal(size=(40, 3)).astype(np.float32) * 2
    rd = rng.normal(size=(40, 3)).astype(np.float32)
    rd[0] = [1e-7, 0, 1]
    rd[1] = -ro[1]
    return K, E, bounds, ro, rd


GEO = {
    "get_camrot": lambda m, K, E, b, ro, rd: m.get_camrot(
        np.array([1.0, 0.3, -2.0], np.float32)),
    "get_camrot_inv": lambda m, K, E, b, ro, rd: m.get_camrot(
        np.array([1.0, 0.3, -2.0], np.float32), np.ones(3, np.float32),
        inv_camera=True),
    "update_extrinsics": lambda m, K, E, b, ro, rd: m.update_extrinsics(
        E, 0.7, np.array([0.1, 0.2, 0.3])),
    "rotate_camera": lambda m, K, E, b, ro, rd: m.rotate_camera_by_frame_idx(
        E, 5, np.array([0.1, 0.2, 0.3]), 20, True),
    "global_tfm": lambda m, K, E, b, ro, rd: m.apply_global_tfm_to_camera(
        E, np.array([0.1, -0.2, 0.3], np.float32),
        np.array([0.5, 0.1, 0.0], np.float32)),
    "rays_KRT": lambda m, K, E, b, ro, rd: m.get_rays_from_KRT(
        9, 11, K, E[:3, :3], E[:3, 3]),
    "rays_KRT_bkg": lambda m, K, E, b, ro, rd: m.get_rays_from_KRT_bkg(
        9, 11, K, E[:3, :3], E[:3, 3]),
    "bbox_dense": lambda m, K, E, b, ro, rd:
        m.rays_intersect_3d_bbox_dense(b, ro, rd),
}
RAYS = {
    "image_rays": lambda m, K, E: m.image_rays(K, E, 9, 11),
    "image_rays_corner": lambda m, K, E: m.image_rays(K, E, 9, 11, False),
    "pixel_rays": lambda m, K, E: m.pixel_rays(
        K, E, 9, 11, np.array([0, 5, 50, 98, 94, 10])),
    "batched": lambda m, K, E: m.batched_image_rays(
        [K, K * 1.1], [E, E.T], [(9, 11), (5, 4)]),
    "ndc": lambda m, K, E: m.convert_to_ndc(
        E[:3, :3] + 3.0, E[:3, :3] - 0.2, (1.5, 2.0), 1.0),
}
POSE = {
    "pca": lambda m, p: m.transform_poses_pca(p),
    "focus": lambda m, p: m.focus_point_fn(p),
    "ellipse": lambda m, p: m.generate_ellipse_path(p, 7, 0.3, 0.1),
    "interp": lambda m, p: m.pose_interp(p, 3),
    "interp_pi": lambda m, p: m.pose_interp(
        np.stack([p[0], p[0] @ np.diag([-1.0, -1.0, 1.0, 1.0]), p[2]]), 2),
}


@pytest.mark.parametrize("name", sorted(GEO))
def test_camera_functions_match_jax(name):
    args = _geo_case()
    assert_equal(GEO[name](cameras, *args), GEO[name](jcam, *args))


@pytest.mark.parametrize("name", sorted(RAYS))
def test_ray_functions_match_jax(name):
    K, E, *_ = _geo_case()
    assert_equal(RAYS[name](rays, K, E), RAYS[name](jrays, K, E))


@pytest.mark.parametrize("name", sorted(POSE))
def test_pose_functions_match_jax(name):
    """Including pose_interp across a relative rotation of exactly pi."""
    p = _poses()
    assert_equal(POSE[name](pose_utils, p.copy()), POSE[name](jpose, p.copy()))


# ---------------------------------------------------------------------------
# the mini capture and the loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The mini capture written by each package's writer (res 48, 8
    frames, one transition) under one parent directory, and the JAX scene
    loader run once on the JAX one, so that it holds
    cameras_scaleworld.pkl."""
    root = str(tmp_path_factory.mktemp("captures"))
    jsyn.write_mini_dataset(os.path.join(root, "jax"), FRAMES, RES)
    synthetic.write_mini_dataset(os.path.join(root, "port"), FRAMES, RES)
    jsl.load_nerf_360_v2(root, "jax")
    return root


def _files(d):
    return sorted(os.path.relpath(os.path.join(a, f), d)
                  for a, _, fs in os.walk(d) for f in fs)


def test_mini_dataset_writers_agree(captures):
    """The same files; images and masks decode (cv2 and imread_png) to
    the same pixels; pickles, .npy, .npz and .json load equal."""
    j, p = (os.path.join(captures, k) for k in ("jax", "port"))
    assert set(_files(p)) == set(_files(j)) - {"cameras_scaleworld.pkl"}
    for f in _files(p):
        a, b = os.path.join(j, f), os.path.join(p, f)
        if f.endswith(".png"):
            ref = cv2.imread(a, cv2.IMREAD_UNCHANGED)
            assert_equal(cv2.imread(b, cv2.IMREAD_UNCHANGED), ref, f)
            assert_equal(imgproc.imread_png(b), ref, f)
        elif f.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert_equal(pickle.load(fb), pickle.load(fa), f)
        elif f.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert_equal(dict(zb), dict(za), f)
        elif f.endswith(".npy"):
            assert_equal(np.load(b), np.load(a), f)
        else:
            with open(a) as fa, open(b) as fb:
                assert json.load(fb) == json.load(fa), f


@pytest.mark.parametrize("factor", [1, 2])
def test_scene_data_matches_jax(captures, factor):
    """load_nerf_360_v2 on the same directory, at factor 1 and 2 (the
    area minification): every SceneData field equal, and the
    cameras_scaleworld.pkl each loader writes."""
    path = os.path.join(captures, "jax", "cameras_scaleworld.pkl")
    ref = jsl.load_nerf_360_v2(captures, "jax", factor=factor)
    with open(path, "rb") as f:
        ref_sw = pickle.load(f)
    got = scene_loader.load_nerf_360_v2(captures, "jax", factor=factor)
    with open(path, "rb") as f:
        assert_equal(pickle.load(f), ref_sw, "cameras_scaleworld")
    for fld in dataclasses.fields(ref):
        assert_equal(getattr(got, fld.name), getattr(ref, fld.name), fld.name)
    assert got.images.shape == (FRAMES, RES // factor, RES // factor, 3)


def test_jpeg_needs_cv2_and_names_the_file(tmp_path, monkeypatch):
    """The JPEG branch imports cv2 only there; without cv2 it raises
    ImportError naming the file."""
    p = str(tmp_path / "frame.jpg")
    with open(p, "wb") as f:
        f.write(b"\xff\xd8")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="frame.jpg"):
        scene_loader._imread01(p)


@pytest.fixture(scope="module")
def scenes(captures):
    return (jsl.load_nerf_360_v2(captures, "jax", write_scaleworld=False),
            scene_loader.load_nerf_360_v2(captures, "jax",
                                          write_scaleworld=False))


@pytest.mark.parametrize("precrop", [False, True])
@pytest.mark.parametrize("mode", ["single_image", "all_images",
                                  "dynamic_batch"])
def test_scene_pipeline_matches_jax(scenes, mode, precrop):
    """Six train batches per sampler mode from the same seed (with the
    centre-crop warm-up over the first three), then one image's eval
    chunks (the last one padded)."""
    ref_p = jsp.ScenePipeline(scenes[0], 96, seed=3, batch_sampler=mode,
                              precrop=precrop, precrop_steps=3)
    got_p = scene_pipeline.ScenePipeline(scenes[1], 96, seed=3,
                                         batch_sampler=mode, precrop=precrop,
                                         precrop_steps=3)
    for i in range(6):
        assert_equal(got_p.sample_train_batch(), ref_p.sample_train_batch(),
                     f"batch {i}")
    assert_equal(list(got_p.eval_image_batches(1, 1000)),
                 list(ref_p.eval_image_batches(1, 1000)))


MODES = ["train", "progress", "movement", "test", "freeview"]


@pytest.mark.parametrize("scaleworld", [False, True])
@pytest.mark.parametrize("mode", MODES + ["tpose"])
def test_human_dataset_matches_jax(captures, mode, scaleworld):
    """Items of every mode from the same seed (train items draw bgcolor
    and patches from the generator in the same order), with and without
    the stage-3 background rays in scaled world."""
    path = os.path.join(captures, "jax")
    kw = dict(mode=mode, patch_size=8, use_scaleworld=scaleworld, seed=1,
              render_frames=4)
    ref_ds, got_ds = jhd.HumanDataset(path, **kw), \
        human_dataset.HumanDataset(path, **kw)
    assert len(got_ds) == len(ref_ds) and got_ds.framelist == ref_ds.framelist
    for i in range(min(len(ref_ds), 3)):
        if mode == "tpose":
            got = got_ds.get_tpose_item(i, resolution=24)
            ref = ref_ds.get_tpose_item(i, resolution=24)
        else:
            got, ref = got_ds[i], ref_ds[i]
        assert_equal(got, ref, f"{mode} item {i}")


def test_smpl_matches_jax(tmp_path):
    """SMPL on fabricated arrays (the repo holds no SMPL model), built
    directly and through from_pkl: rest joints, vertices and posed
    joints equal."""
    rng = np.random.default_rng(2)
    V = 60
    jr = rng.random((24, V))
    w = rng.random((V, 24)) ** 4
    data = {"v_template": rng.normal(size=(V, 3)),
            "shapedirs": rng.normal(scale=0.01, size=(V, 3, 12)),
            "posedirs": rng.normal(scale=0.01, size=(V, 3, 207)),
            "J_regressor": jr / jr.sum(1, keepdims=True),
            "weights": w / w.sum(1, keepdims=True),
            "kintree_table": np.stack([jsmpl.SMPL_24_PARENTS,
                                       np.arange(24)]),
            "f": rng.integers(0, V, (10, 3))}
    p = str(tmp_path / "SMPL_NEUTRAL.pkl")
    with open(p, "wb") as f:
        pickle.dump(data, f)
    pose = rng.normal(scale=0.3, size=72)
    beta = rng.normal(size=10)
    arrays = {k: data[k] for k in ("v_template", "posedirs", "J_regressor",
                                   "weights")}
    arrays["shapedirs"] = data["shapedirs"][..., :10]
    for got_m, ref_m in ((smpl.SMPL.from_pkl(str(tmp_path)),
                          jsmpl.SMPL.from_pkl(str(tmp_path))),
                         (smpl.SMPL(**arrays), jsmpl.SMPL(**arrays))):
        assert_equal(got_m.joints_rest(beta), ref_m.joints_rest(beta))
        assert_equal(got_m(pose, beta), ref_m(pose, beta))


def test_to_device_keeps_dtypes_and_drops_strings():
    """Arrays and numpy scalars become tensors of the same dtype and shape
    (read-only and reversed views too), strings are dropped, other Python
    values pass through; on the CPU only when asked."""
    batch = {"rays_o": np.ones((4, 3), np.float32),
             "mask": np.array([True, False]),
             "idx": np.arange(3, dtype=np.int64),
             "k": np.eye(3)[::-1], "ro": np.broadcast_to(np.ones(3), (2, 3)),
             "time": np.float32(0.25), "frame_name": "frame_000001",
             "n_valid": 7}
    got = batches.to_device(batch, "cpu")
    assert "frame_name" not in got and got["n_valid"] == 7
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, np.generic)):
            assert isinstance(got[k], torch.Tensor), k
            assert got[k].numpy().dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batches.to_device(batch)


def test_pipeline_runs_without_cv2_pyyaml_or_jax(tmp_path):
    """In a fresh interpreter where importing cv2, yaml, jax or the JAX
    package fails: write a mini capture, load it with both loaders
    (scaled-world cameras included), draw batches, move one to the
    device and read every config file; the data-parallel modules, the
    dry-run entry and the timing helpers import too."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('cv2', 'yaml', 'jax', 'hosnerf_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import os
from hosnerf_tpu_torch.config import ginlite, yamlcfg
from hosnerf_tpu_torch.data import (batches, human_dataset, scene_loader,
                                    scene_pipeline, synthetic)
from hosnerf_tpu_torch.train import stage1
from hosnerf_tpu_torch import entry
from hosnerf_tpu_torch.parallel import distributed, mesh
from hosnerf_tpu_torch.utils import benchtools
root = {str(tmp_path)!r}
synthetic.write_mini_dataset(os.path.join(root, 'cap'), 4, 16)
sd = scene_loader.load_nerf_360_v2(root, 'cap', factor=2)
pipe = scene_pipeline.ScenePipeline(sd, 8)
batches.to_device(pipe.sample_train_batch(), 'cpu')
ds = human_dataset.HumanDataset(os.path.join(root, 'cap'), patch_size=4,
                                use_scaleworld=True)
batches.to_device(ds[0], 'cpu')
for f in sorted(os.listdir('configs')):
    p = os.path.join('configs', f)
    if f.endswith('.gin'):
        ginlite.parse_config_files_and_bindings([p])
    else:
        yamlcfg.load_yaml(p)
print(sorted(m for m in sys.modules
             if m.split('.')[0] in ('cv2', 'yaml', 'jax', 'hosnerf_tpu')))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
