"""Stage-1 training and eval batches over a loaded SceneData (counterpart
of `hosnerf_tpu/data/scene_pipeline.py`: the same numpy batches from the
same seed, drawing from `np.random.default_rng` in the same order).

Rays are generated lazily per image; the train sampler draws `batch_size`
background rays from one random image per step ('single_image') or from
the pool over all train images. `data/batches.py::to_device` moves a
batch to the card.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from hosnerf_tpu_torch.data import rays as ray_gen
from hosnerf_tpu_torch.data.scene_loader import SceneData


class ScenePipeline:
    """batch_sampler modes mirror the reference's sampler zoo
    (ref: src/data/sampler.py):
      'single_image'   — batch from ONE random image (SingleImageDDPSampler)
      'all_images'     — rays pooled across all train images
                         (MultipleImageDDPSampler:104)
      'dynamic_batch'  — like all_images with per-call image re-draw
                         (MultipleImageDynamicDDPSampler:127; without the
                         precomputed ray pool, the two collapse to the same
                         lazy sampling here)
    `precrop`/`precrop_steps` reproduce the center-crop warmup
    (2nd.../src/data/sampler.py:85-107)."""

    def __init__(self, scene: SceneData, batch_size: int = 4096,
                 seed: int = 0, batch_sampler: str = "single_image",
                 precrop: bool = False, precrop_steps: int = 0):
        self.scene = scene
        self.batch_size = batch_size
        self.batch_sampler = batch_sampler
        self.precrop = precrop
        self.precrop_steps = precrop_steps
        self._step = 0
        self.rng = np.random.default_rng(seed)
        self._ray_cache: Dict[int, tuple] = {}
        # per-image flat indices of background pixels (mask < 1)
        # (ref: interface.py:145-150 background-ray filter)
        self._bkg_idx = [np.flatnonzero(m.reshape(-1) < 1.0)
                         for m in scene.masks]
        counts = np.array([len(self._bkg_idx[i])
                           for i in scene.i_split[0]], np.float64)
        self._train_img_probs = counts / counts.sum()

    def _image_rays(self, i: int):
        if i not in self._ray_cache:
            h, w = self.scene.image_sizes[i]
            self._ray_cache[i] = ray_gen.image_rays(
                self.scene.intrinsics[i], self.scene.extrinsics[i],
                int(h), int(w))
            if len(self._ray_cache) > 8:  # small LRU
                self._ray_cache.pop(next(iter(self._ray_cache)))
        return self._ray_cache[i]

    def _rays_for(self, i: int, sel: np.ndarray):
        """Rays at selected flat pixels: cached full grid when available
        (single_image reuses images across steps), per-pixel generation
        otherwise (pooled modes touch every train image per batch)."""
        if i in self._ray_cache or self.batch_sampler == "single_image":
            rays_o, rays_d, viewdirs, radii = self._image_rays(i)
            return rays_o[sel], rays_d[sel], viewdirs[sel], radii[sel]
        h, w = self.scene.image_sizes[i]
        return ray_gen.pixel_rays(self.scene.intrinsics[i],
                                  self.scene.extrinsics[i], int(h), int(w),
                                  sel)

    def _pick_pixels(self, i: int, n: int) -> np.ndarray:
        h, w = self.scene.image_sizes[i]
        if self.precrop and self._step < self.precrop_steps:
            # center-crop warmup: pixels from the middle half of the image
            hp = self.rng.integers(0, h // 2, n) + h // 4
            wp = self.rng.integers(0, w // 2, n) + w // 4
            return hp * w + wp
        bkg = self._bkg_idx[i]
        return bkg[self.rng.integers(0, len(bkg), n)]

    def sample_train_batch(self) -> Dict[str, np.ndarray]:
        """One device batch of background rays per the sampler mode."""
        self._step += 1
        i_train = self.scene.i_split[0]
        if self.batch_sampler == "single_image":
            images = [int(self.rng.choice(i_train))]
            counts = [self.batch_size]
        else:
            # all_images / dynamic_batch: every ray drawn uniformly from
            # the FULL background-ray pool across ALL train images —
            # image weighted by its bkg-ray count, exactly the draw
            # MultipleImageDDPSampler makes over total_len
            # (ref: sampler.py:104-127). Per-image ray generation below
            # uses pixel_rays (selected pixels only), so touching every
            # train image per batch costs O(batch), not O(images * H * W).
            draws = self.rng.choice(len(i_train), self.batch_size,
                                    p=self._train_img_probs)
            ids, cnts = np.unique(draws, return_counts=True)
            images = [int(i_train[k]) for k in ids]
            counts = cnts.tolist()

        parts = {k: [] for k in ("rays_o", "rays_d", "viewdirs", "radii",
                                 "times", "target")}
        for i, n in zip(images, counts):
            i = int(i)
            sel = self._pick_pixels(i, n)
            rays_o, rays_d, viewdirs, radii = self._rays_for(i, sel)
            parts["rays_o"].append(rays_o)
            parts["rays_d"].append(rays_d)
            parts["viewdirs"].append(viewdirs)
            parts["radii"].append(radii)
            parts["times"].append(
                np.full(n, self.scene.times[i], np.float32))
            parts["target"].append(
                self.scene.images[i].reshape(-1, 3)[sel].astype(np.float32))
        return {k: np.concatenate(v) for k, v in parts.items()}

    def eval_image_batches(self, i: int, chunk: int = 4096
                           ) -> Iterator[Dict[str, np.ndarray]]:
        """Full-image rays in fixed-size chunks (last chunk padded by
        repeating ray 0; consumer trims with `n_valid`)."""
        rays_o, rays_d, viewdirs, radii = self._image_rays(i)
        target = self.scene.images[i].reshape(-1, 3)
        n = rays_o.shape[0]
        time = self.scene.times[i]
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            idx = np.arange(start, end)
            if end - start < chunk:
                idx = np.concatenate(
                    [idx, np.zeros(chunk - (end - start), np.int64)])
            yield {
                "rays_o": rays_o[idx],
                "rays_d": rays_d[idx],
                "viewdirs": viewdirs[idx],
                "radii": radii[idx],
                "times": np.full(chunk, time, np.float32),
                "target": target[idx].astype(np.float32),
                "n_valid": end - start,
            }
