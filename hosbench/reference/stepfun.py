"""Step-function resampling math for hierarchical (proposal) sampling
(a frozen copy of the port's `core/stepfun.py`, its draws taken
straight from the generator).

The interval search is the JAX package's broadcast-mask form (a masked
max and min over all knots, O(n m) comparisons), not `torch.searchsorted`:
it clamps out-of-range queries to the first and last index and resolves
ties as `a[lo] <= v < a[hi]`. Max and min reductions use `amax` / `amin`,
which share the gradient between tied entries as JAX's reductions do.
Random draws come from an explicit `torch.Generator`; `sample` and
`sample_intervals` also take the uniform draws `u` themselves, so that a
caller can reproduce another sampler's draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hosbench.reference.rays import EPS


def searchsorted(a: torch.Tensor, v: torch.Tensor):
    """For each v, idx_lo / idx_hi in sorted a with a[lo] <= v < a[hi];
    out-of-range queries clamp to the first / last index."""
    i = torch.arange(a.shape[-1], device=a.device)
    v_ge_a = v[..., None, :] >= a[..., :, None]
    idx_lo = torch.amax(torch.where(v_ge_a, i[:, None], i[:1, None]),
                        dim=-2)
    idx_hi = torch.amin(torch.where(~v_ge_a, i[:, None], i[-1:, None]),
                        dim=-2)
    return idx_lo, idx_hi


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on the last axis, batch dimensions broadcast."""
    shape = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(shape + x.shape[-1:]), -1,
                        idx.expand(shape + idx.shape[-1:]))


def inner_outer(t0: torch.Tensor, t1: torch.Tensor, y1: torch.Tensor):
    """Inner and outer bounds of the step function (t1, y1) resampled
    onto the intervals t0."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]),
                     torch.cumsum(y1, dim=-1)], dim=-1)
    idx_lo, idx_hi = searchsorted(t1, t0)
    cy1_lo = _take(cy1, idx_lo)
    cy1_hi = _take(cy1, idx_hi)
    y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
    y0_inner = torch.where(idx_hi[..., :-1] <= idx_lo[..., 1:],
                           cy1_lo[..., 1:] - cy1_hi[..., :-1],
                           torch.zeros_like(cy1_lo[..., 1:]))
    return y0_inner, y0_outer


def lossfun_outer(t, w, t_env, w_env):
    """Proposal ('interlevel') loss."""
    _, w_outer = inner_outer(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + EPS)


def lossfun_distortion(t, w):
    """mip-NeRF 360 distortion loss."""
    ut = (t[..., 1:] + t[..., :-1]) / 2.0
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1),
                           dim=-1)
    loss_intra = torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def weight_to_pdf(t, w):
    return w / torch.clamp(t[..., 1:] - t[..., :-1], min=EPS)


def pdf_to_weight(t, p):
    return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t, w, dilation, domain=(-math.inf, math.inf)):
    """Dilate (by max) a step function."""
    t0 = t[..., :-1] - dilation
    t1 = t[..., 1:] + dilation
    t_dilate = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
    t_dilate = torch.clamp(t_dilate, domain[0], domain[1])
    mask = ((t0[..., None, :] <= t_dilate[..., None])
            & (t1[..., None, :] > t_dilate[..., None]))
    w_dilate = torch.amax(
        torch.where(mask, w[..., None, :], torch.zeros_like(w[..., None, :])),
        dim=-1)[..., :-1]
    return t_dilate, w_dilate


def max_dilate_weights(t, w, dilation, domain, renormalize: bool = False):
    p = weight_to_pdf(t, w)
    t_dilate, p_dilate = max_dilate(t, p, dilation, domain)
    w_dilate = pdf_to_weight(t_dilate, p_dilate)
    if renormalize:
        w_dilate = w_dilate / torch.clamp(
            torch.sum(w_dilate, dim=-1, keepdim=True), min=EPS)
    return t_dilate, w_dilate


def integrate_weights(w):
    """Cumulative weights padded with 0 and 1."""
    cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1.0)
    shape = cw.shape[:-1] + (1,)
    return torch.cat([cw.new_zeros(shape), cw, cw.new_ones(shape)], dim=-1)


def sorted_interp(x, xp, fp):
    """Piecewise-linear interpolation of (xp, fp) at sorted queries x."""
    mask = x[..., None, :] >= xp[..., :, None]
    fp0 = torch.amax(torch.where(mask, fp[..., None], fp[..., :1, None]),
                     dim=-2)
    fp1 = torch.amin(torch.where(~mask, fp[..., None], fp[..., -1:, None]),
                     dim=-2)
    xp0 = torch.amax(torch.where(mask, xp[..., None], xp[..., :1, None]),
                     dim=-2)
    xp1 = torch.amin(torch.where(~mask, xp[..., None], xp[..., -1:, None]),
                     dim=-2)
    offset = torch.clamp(torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0),
                         0.0, 1.0)
    return fp0 + offset * (fp1 - fp0)


def invert_cdf(u, t, w_logits):
    """Invert the CDF of softmax(w_logits) over the knots t; -inf logits
    are empty intervals."""
    w = torch.softmax(w_logits, dim=-1)
    cw = integrate_weights(w)
    return sorted_interp(u, cw, t)


def sample(generator: Optional[torch.Generator], randomized: bool, t,
           w_logits, num_samples: int, single_jitter: bool = False,
           deterministic_center: bool = False,
           u: Optional[torch.Tensor] = None):
    """Draw num_samples points from the step function's CDF. Randomized:
    evenly spaced offsets plus one jitter per ray (single_jitter) or per
    sample, the uniform draws `u` [..., 1 or num_samples] taken as given
    or drawn from `generator`."""
    kw = dict(dtype=t.dtype, device=t.device)
    if not randomized:
        if deterministic_center:
            pad = 1.0 / (2 * num_samples)
            u = torch.linspace(pad, 1.0 - pad - EPS, num_samples, **kw)
        else:
            u = torch.linspace(0.0, 1.0 - EPS, num_samples, **kw)
        u = torch.broadcast_to(u, t.shape[:-1] + (num_samples,))
    else:
        u_max = EPS + (1.0 - EPS) / num_samples
        max_jitter = (1.0 - u_max) / (num_samples - 1) - EPS
        d = 1 if single_jitter else num_samples
        if u is None:
            u = torch.rand(t.shape[:-1] + (d,), generator=generator,
                           device=generator.device, dtype=t.dtype)
        u = (torch.linspace(0.0, 1.0 - u_max, num_samples, **kw)
             + u.to(t.device) * max_jitter)
    return invert_cdf(u, t, w_logits)


def sample_intervals(generator: Optional[torch.Generator], randomized: bool,
                     t, w_logits, num_samples: int,
                     single_jitter: bool = False,
                     domain=(-math.inf, math.inf),
                     u: Optional[torch.Tensor] = None):
    """Sample intervals (num_samples + 1 edges) from the step function,
    the outer edges clamped to `domain`."""
    centers = sample(generator, randomized, t, w_logits, num_samples,
                     single_jitter, deterministic_center=True, u=u)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2.0
    min_val, max_val = domain
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=min_val)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=max_val)
    return torch.cat([first, mid, last], dim=-1)
