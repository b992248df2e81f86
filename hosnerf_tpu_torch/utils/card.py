"""The card's library settings: one function sets them for every entry
point of the port (the CLI, the dry-run entry and its workers, the
gradient check, each tool under `tools/`, chip_smoke.py), right after its
arguments are parsed and before it builds a model or touches the card.

    settings = card.configure()   # what torch reads back, see settings()

Without a card it only sets the flags: no device is touched.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

WORKSPACE = ":4096:8"


def configure() -> Dict[str, object]:
    """Set the card's library settings and return `settings()`.

      * TF32 off for f32 products (`cuda.matmul.allow_tf32`) and f32
        convolutions (`cudnn.allow_tf32`): the JAX reference pins its f32
        products at Precision.HIGHEST (`hosnerf_tpu/ops/lbs.py`,
        `models/human.py`, the weight-volume decoder's f32 conv), so the
        port runs f32 products and convolutions in f32 on the card (LPIPS's
        VGG16 among them);
      * cuDNN deterministic, its benchmark search off: one state, batch and
        generator give the same bits on one card, step after step (the
        port's own kernels sum in fixed orders; cuDNN's convolutions, the
        weight-volume decoder's and LPIPS's, take their deterministic
        algorithms);
      * `CUBLAS_WORKSPACE_CONFIG` a fixed workspace (set only where the
        environment does not name one), which cuBLAS's products need to
        repeat: cuBLAS reads it when its first handle is made, so this
        runs before the first product on the card.
    """
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", WORKSPACE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return settings()


def settings() -> Dict[str, object]:
    """The settings as torch reads them back now (a flat dict): what a run
    records beside its numbers."""
    return {
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
