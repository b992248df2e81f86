"""360-v2 scene dataset loader (stage 1), host-side numpy (counterpart of
`hosnerf_tpu/data/scene_loader.py`; the same `SceneData` from the same
directory).

Images and masks are read by `data/imgproc.py` (PNG) and minified by its
area resize, with the same pixels as the JAX package's cv2 calls. JPEG
files are decoded by cv2, imported only when a capture holds one; without
cv2 such a capture raises ImportError naming the file.

It preserves the cross-stage contract: writes `cameras_scaleworld.pkl`
mapping each frame's smpl_to_world -> smpl_to_scale_world and
scaleworld_to_camera for stage 3 (nerf_360_v2.py:414-435).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from hosnerf_tpu_torch.data import imgproc, pose_utils

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".PNG", ".JPEG")


def _list_images(d: str):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(_IMG_EXTS)]


def _imread_jpeg(path: str) -> np.ndarray:
    """`cv2.imread(path, IMREAD_UNCHANGED)` of a JPEG: the one format the
    port does not decode itself."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading JPEG captures needs cv2 "
                          "(opencv-python); PNG captures do not") from e
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _imread01(path: str) -> np.ndarray:
    """The image at `path` as float32 in [0, 1]: gray [H, W], colour RGB
    [H, W, 3] (an alpha channel dropped, as cv2's BGR2RGB drops it)."""
    if path.lower().endswith((".jpg", ".jpeg")):
        img = _imread_jpeg(path)
    else:
        img = imgproc.imread_png(path)
    if img.ndim == 3:
        img = img[..., [2, 1, 0]]
    return img.astype(np.float32) / 255.0


def _load_resized(paths, factor: int):
    out = []
    for p in paths:
        img = _imread01(p)
        if factor and factor > 1:
            img = imgproc.resize(img, (img.shape[1] // factor,
                                       img.shape[0] // factor),
                                 interpolation=imgproc.INTER_AREA)
        out.append(img)
    return np.stack(out, 0)


def similarity_from_cameras(c2w: np.ndarray, strict_scaling: bool = False):
    """Similarity transform normalizing OpenCV-convention c2w cameras:
    world-up alignment, center on median closest-approach point, scale by
    median (or max) camera distance (ref: nerf_360_v2.py:294-350)."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    ups = np.sum(R * np.array([0, -1.0, 0]), axis=-1)
    world_up = np.mean(ups, axis=0)
    world_up /= np.linalg.norm(world_up)

    up_camspace = np.array([0.0, -1.0, 0.0])
    c = (up_camspace * world_up).sum()
    cross = np.cross(world_up, up_camspace)
    skew = np.array([[0.0, -cross[2], cross[1]],
                     [cross[2], 0.0, -cross[0]],
                     [-cross[1], cross[0], 0.0]])
    if c > -1:
        R_align = np.eye(3) + skew + (skew @ skew) / (1 + c)
    else:
        R_align = np.diag(np.array([-1.0, 1.0, 1.0]))

    R = R_align @ R
    fwds = np.sum(R * np.array([0, 0.0, 1.0]), axis=-1)
    t = (R_align @ t[..., None])[..., 0]

    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)

    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = R_align

    scale_fn = np.max if strict_scaling else np.median
    scale = 1.0 / scale_fn(np.linalg.norm(t + translate, axis=-1))
    return transform, scale


@dataclasses.dataclass
class SceneData:
    images: np.ndarray            # [N, H, W, 3] float01
    masks: np.ndarray             # [N, H, W] float01 (1 = subject)
    intrinsics: np.ndarray        # [N, 3, 3]
    extrinsics: np.ndarray        # [N, 4, 4] c2w (scaled world)
    image_sizes: np.ndarray       # [N, 2] (h, w)
    near: float
    far: float
    i_split: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    render_poses: np.ndarray      # [M, 4, 4]
    times: np.ndarray             # [N]
    render_times: np.ndarray      # [M]
    bkgrays_sizes: np.ndarray     # [N] background-pixel counts


def load_nerf_360_v2(datadir: str, scene_name: str, factor: int = 0,
                     cam_scale_factor: float = 0.95,
                     near: Optional[float] = None,
                     far: Optional[float] = None,
                     strict_scaling: bool = False,
                     write_scaleworld: bool = True) -> SceneData:
    """Load a HOSNeRF scene capture (LLFF-style 360-v2 layout).

    Expects: poses_bounds.npy, images/, masks/, cameras.pkl (for the
    stage-3 handoff). ref: nerf_360_v2.py:367-488.
    """
    basedir = os.path.join(datadir, scene_name)
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5])  # [N, 3, 5]

    factor = max(int(factor), 1)
    images = _load_resized(_list_images(os.path.join(basedir, "images")),
                           factor)
    masks = _load_resized(_list_images(os.path.join(basedir, "masks")),
                          factor)
    if masks.ndim == 4:
        masks = masks[..., 0]
    num_frame, h, w = images.shape[:3]
    if poses.shape[0] != num_frame:
        raise ValueError(
            f"{num_frame} images vs {poses.shape[0]} poses in {basedir}")

    # update hwf for the factor
    poses[:, 0, 4] = h
    poses[:, 1, 4] = w
    poses[:, 2, 4] = poses[:, 2, 4] / factor
    focal = float(poses[0, 2, 4])

    # LLFF [down right back] -> OpenGL -> OpenCV axis shuffles
    # (ref: nerf_360_v2.py:385-388)
    p34 = poses[:, :3, :4]
    p34 = np.concatenate(
        [p34[:, :, 1:2], -p34[:, :, 0:1], p34[:, :, 2:4]], axis=2)
    p34 = np.concatenate(
        [p34[:, :, 0:1], -p34[:, :, 1:2], -p34[:, :, 2:3], p34[:, :, 3:4]],
        axis=2)

    extrinsics = np.broadcast_to(np.eye(4), (num_frame, 4, 4)).copy()
    extrinsics[:, :3, :4] = p34

    T, sscale = similarity_from_cameras(extrinsics, strict_scaling)
    extrinsics = np.einsum("nij,ki->nkj", extrinsics, T)
    scene_scale = cam_scale_factor * sscale
    extrinsics[:, :3, 3] *= scene_scale
    T_camera_to_scaleworld = extrinsics.copy()

    s = np.eye(4)
    s[:3, :3] *= scene_scale
    T_world_to_scaleworld = s @ T

    # cross-stage handoff (ref: nerf_360_v2.py:414-435)
    cameras_pkl = os.path.join(basedir, "cameras.pkl")
    if write_scaleworld and os.path.exists(cameras_pkl):
        with open(cameras_pkl, "rb") as f:
            cams = pickle.load(f)
        out = {}
        for idx, frame_name in enumerate(cams):
            smpl_to_world = cams[frame_name]["smpl_to_world"]
            out[frame_name] = {
                "intrinsics": cams[frame_name]["intrinsics"],
                "smpl_to_camera": cams[frame_name]["smpl_to_camera"],
                "smpl_to_scale_world": np.asarray(
                    T_world_to_scaleworld @ smpl_to_world, np.float32),
                "scaleworld_to_camera": np.asarray(
                    np.linalg.inv(T_camera_to_scaleworld[idx]), np.float32),
            }
        with open(os.path.join(basedir, "cameras_scaleworld.pkl"),
                  "wb") as f:
            pickle.dump(out, f)

    times = np.linspace(0.0, 1.0, num_frame).astype(np.float32)
    render_poses = pose_utils.pose_interp(extrinsics, 2)
    render_times = np.linspace(0.0, 1.0, len(render_poses)).astype(np.float32)

    # held-out frames: every num_frame//16-th, max 16 (ref: :440-447)
    test_skip = max(num_frame // 16, 1)
    i_test = np.arange(num_frame)[::test_skip][:16]
    if len(i_test) >= num_frame:  # tiny datasets: keep at most half as test
        i_test = i_test[::2][: max(num_frame // 2, 1)]
    i_train = np.array([i for i in range(num_frame) if i not in i_test])
    # the reference's own val split is literally the first two train
    # frames ("temp for visualize", ref nerf_360_v2.py:447) — preserved,
    # so ModelCheckpoint(monitor='val/psnr') semantics match it exactly
    i_val = i_train[:2]
    i_all = np.arange(num_frame)

    intrinsics = np.broadcast_to(
        np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1.0]]),
        (num_frame, 3, 3)).copy()
    image_sizes = np.broadcast_to(np.array([h, w]), (num_frame, 2)).copy()
    bkgrays_sizes = np.sum(masks < 1, axis=(1, 2))

    return SceneData(
        images=images.astype(np.float32),
        masks=masks.astype(np.float32),
        intrinsics=intrinsics.astype(np.float32),
        extrinsics=extrinsics.astype(np.float32),
        image_sizes=image_sizes,
        near=0.0 if near is None else near,
        far=1.0 if far is None else far,
        i_split=(i_train, i_val, i_test, i_all),
        render_poses=render_poses,
        times=times,
        render_times=render_times,
        bkgrays_sizes=bkgrays_sizes,
    )
