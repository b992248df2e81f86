"""Host batches to device tensors (with `parallel/mesh.py::shard_batch`
before it, the counterpart of `hosnerf_tpu/parallel/mesh.py::
shard_batch`'s device put)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from hosnerf_tpu_torch.models.layers import resolve_device


def to_device(batch: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The numpy batch `batch` (a ScenePipeline batch or a HumanDataset
    item) on `device`, the card unless the caller names another: every
    array (numpy array or numpy scalar) becomes a tensor of the same dtype
    and shape, copied from pinned host memory with non_blocking=True on
    a CUDA device; strings (`frame_name`) are dropped, as the CLI drops
    them before `shard_batch`; other Python values (`n_valid`,
    `img_height`, `img_width`, a `parallel/mesh.py::shard_batch` mark)
    pass through unchanged.

    One device: under a process group each rank calls this on its share
    of the batch (`shard_batch` first), with its own device."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, str):
            continue
        if isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            if not (a.flags.c_contiguous and a.flags.writeable):
                a = a.copy()
            t = torch.from_numpy(a)
            if cuda:
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        else:
            out[k] = v
    return out
