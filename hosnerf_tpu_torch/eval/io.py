"""Image/video artifact output and the results.json writer (counterpart of
`hosnerf_tpu/eval/io.py`).

Images are written as PNG by `data/imgproc.py` (the JAX package writes
JPEG through cv2, which the card machine lacks); videos keep the JAX
package's chain, imageio then cv2, each imported only when a video is
written.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from hosnerf_tpu_torch.data import imgproc


def to_8b_image(img01: np.ndarray) -> np.ndarray:
    return (255.0 * np.clip(img01, 0.0, 1.0)).astype(np.uint8)


def store_image(dirpath: str, rgbs: Sequence[np.ndarray],
                prefix: str = "image") -> List[str]:
    """Dump RGB images as PNGs named image000.png...: float images in
    [0, 1] as the pixels of `to_8b_image`, uint8 images as they are (the
    JAX package passes those through `to_8b_image` again, which turns
    every nonzero pixel white)."""
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for i, rgb in enumerate(rgbs):
        rgb = np.asarray(rgb)
        img = rgb if rgb.dtype == np.uint8 else to_8b_image(rgb)
        p = os.path.join(dirpath, f"{prefix}{i:03d}.png")
        imgproc.imwrite_png(p, img[..., ::-1])
        paths.append(p)
    return paths


def store_video(dirpath: str, rgbs: Sequence[np.ndarray],
                fps: int = 20) -> str:
    """<dirpath>/images.mp4 at `fps`: imageio (with its ffmpeg plugin)
    where it is installed, else cv2's VideoWriter; neither installed
    raises ImportError naming the file."""
    os.makedirs(dirpath, exist_ok=True)
    frames = [to_8b_image(np.asarray(r)) for r in rgbs]
    path = os.path.join(dirpath, "images.mp4")
    try:
        import imageio
        imageio.mimwrite(path, frames, fps=fps, quality=8)
        return path
    except Exception:
        pass
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: writing a video needs imageio (with "
                          "imageio-ffmpeg) or cv2 (opencv-python)") from e
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(f[..., ::-1])
    vw.release()
    return path


def tile_images(images: Sequence[np.ndarray],
                imgs_per_row: int = 4) -> np.ndarray:
    """Tile uint8 images into a grid, the last row padded with black."""
    rows = []
    for i in range(0, len(images), imgs_per_row):
        row = list(images[i:i + imgs_per_row])
        while len(row) < imgs_per_row:
            row.append(np.zeros_like(row[0]))
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def write_stats(path: str, *stats: Dict) -> None:
    """results.json: the stats dicts as one JSON list."""
    with open(path, "w") as f:
        json.dump(list(stats), f, indent=2, default=float)
