"""Image quality metrics in torch: PSNR, SSIM (gaussian and uniform
windows) and the LPIPS metric (counterpart of `hosnerf_tpu/eval/
metrics.py`).

The gaussian 11/1.5 window is piqa's SSIM (the reference's stage-1
eval), the uniform 7 window skimage's default (stages 2 and 3). Images
are [H, W, C] or [N, H, W, C] tensors in [0, max_val].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log(mse) / math.log(10.0)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_separable(img: torch.Tensor, k1d: torch.Tensor
                        ) -> torch.Tensor:
    """Depthwise separable 'valid' filtering of NCHW images: the 1-D
    kernel along H, then along W, one group per channel."""
    n, c = k1d.shape[0], img.shape[1]
    kh = k1d.reshape(1, 1, n, 1).expand(c, 1, n, 1)
    kw = k1d.reshape(1, 1, 1, n).expand(c, 1, 1, n)
    return F.conv2d(F.conv2d(img, kh, groups=c), kw, groups=c)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         uniform_window: bool = False) -> torch.Tensor:
    """SSIM per image, [N] (N = 1 for an [H, W, C] pair).

    gaussian 11/1.5 matches piqa's defaults; uniform_window=True with
    kernel_size=7 matches skimage's default."""
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    x = pred.permute(0, 3, 1, 2).float()
    y = target.permute(0, 3, 1, 2).float()
    if uniform_window:
        k1d = torch.full((kernel_size,), 1.0 / kernel_size)
    else:
        k1d = torch.from_numpy(_gaussian_kernel(kernel_size, sigma))
    k1d = k1d.to(x.device)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _filter2d_separable(x, k1d)
    mu_y = _filter2d_separable(y, k1d)
    mu_xx = _filter2d_separable(x * x, k1d)
    mu_yy = _filter2d_separable(y * y, k1d)
    mu_xy = _filter2d_separable(x * y, k1d)

    var_x = mu_xx - mu_x ** 2
    var_y = mu_yy - mu_y ** 2
    cov = mu_xy - mu_x * mu_y

    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2))
    return torch.mean(ssim_map, dim=(1, 2, 3))


def make_lpips_metric(lpips_model):
    """callable(img_a01, img_b01) -> scalar LPIPS tensor of
    `models/lpips.py::LPIPS` (its weights, on its device), without
    autograd; inputs [H, W, 3] (or [N, H, W, 3]) in [0, 1], arrays or
    tensors, the mean over N."""
    device = next(lpips_model.parameters()).device

    @torch.no_grad()
    def metric(a, b):
        a = torch.as_tensor(a, device=device, dtype=torch.float32)
        b = torch.as_tensor(b, device=device, dtype=torch.float32)
        if a.ndim == 3:
            a, b = a[None], b[None]
        return torch.mean(lpips_model(a * 2.0 - 1.0, b * 2.0 - 1.0))

    return metric
