"""Convenience re-exports mirroring the reference's `utils/` +
`core/utils/` surface (counterpart of `hosnerf_tpu/utils/__init__.py`)."""

from hosnerf_tpu_torch.eval.io import (store_image, store_video,  # noqa: F401
                                       tile_images, to_8b_image, write_stats)
from hosnerf_tpu_torch.utils.file_util import list_files, split_path  # noqa: F401
