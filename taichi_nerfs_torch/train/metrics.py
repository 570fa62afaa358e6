"""Image quality metrics (PSNR / SSIM) on tensors.

Port of the JAX package's ``train/metrics.py``: Wang et al. SSIM with the
torchmetrics defaults (11x11 gaussian window, sigma 1.5, k1=0.01, k2=0.03,
data_range=1).  The depthwise gaussian filter is written as two separable
band-matrix products instead of a convolution: a fp32 ``conv2d`` goes
through cuDNN in TF32 by default, a fp32 matmul does not (while
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default).
"""

from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0):
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(mse / data_range**2)


def _gaussian_1d(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (
        size - 1
    ) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / torch.sum(g)


def _band(n: int, g: torch.Tensor) -> torch.Tensor:
    """(n - k + 1, n) valid-mode filter matrix: row r holds g at r..r+k-1."""
    k = g.shape[0]
    rows = torch.arange(n - k + 1, device=g.device)[:, None]
    cols = torch.arange(n, device=g.device)[None, :]
    off = cols - rows
    inside = (off >= 0) & (off < k)
    return torch.where(inside, g[off.clamp(0, k - 1)], 0.0)


def _filter2d(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Depthwise valid-mode 2D gaussian filter of an (H, W, C) image."""
    H, W, _ = img.shape
    x = img.permute(2, 0, 1)  # (C, H, W)
    x = torch.matmul(_band(H, g), x)  # filter rows
    x = torch.matmul(x, _band(W, g).T)  # filter columns
    return x.permute(1, 2, 0)


def ssim(
    pred: torch.Tensor,
    gt: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
):
    """Mean SSIM over an (H, W, C) image pair."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    g = _gaussian_1d(kernel_size, sigma, pred.device)

    mu_x = _filter2d(pred, g)
    mu_y = _filter2d(gt, g)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _filter2d(pred * pred, g) - mu_xx
    sigma_yy = _filter2d(gt * gt, g) - mu_yy
    sigma_xy = _filter2d(pred * gt, g) - mu_xy
    # fp32 cancellation can make the one-pass variances slightly negative
    # (and |cov| > sqrt(var * var)); project back into the valid region
    sigma_xx = torch.clamp(sigma_xx, min=0.0)
    sigma_yy = torch.clamp(sigma_yy, min=0.0)
    bound = torch.sqrt(sigma_xx * sigma_yy)
    sigma_xy = torch.clamp(sigma_xy, -bound, bound)

    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
    return torch.mean(num / den)
