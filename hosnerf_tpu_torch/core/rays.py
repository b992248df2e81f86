"""Ray and conical-frustum math of the mip-NeRF 360 scene model
(counterpart of `hosnerf_tpu/core/rays.py`).

The contraction's covariance propagation uses the closed-form Jacobian
(`contract_jacobian`), and the scene's hot path casts, contracts and lifts
in one pass with no [..., 3, 3] intermediates
(`contracted_lifted_gaussians`). The contracted means and covariances are
detached where the JAX package stops their gradients. Every function is
shape-polymorphic over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

# float32 machine epsilon
EPS = 1.1920929e-07


def contract_points(x: torch.Tensor) -> torch.Tensor:
    """The mip-NeRF 360 scene contraction applied to points:
    f(x) = x for ||x|| <= 1, else ((2||x|| - 1) / ||x||^2) x.
    Valid for ||x|| < ~1e18 (||x||^2 must not overflow f32)."""
    x_mag_sq = torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True),
                           min=1e-32)
    x_mag = torch.sqrt(x_mag_sq)
    scale = torch.where(x_mag_sq <= 1.0, 1.0, (2.0 * x_mag - 1.0) / x_mag_sq)
    return scale * x


def contract_jacobian(x: torch.Tensor) -> torch.Tensor:
    """Closed-form Jacobian of `contract_points`, [..., 3, 3]: for
    r = ||x|| > 1 with s(r) = (2r - 1) / r^2, J = s I + s'(r) / r x x^T,
    s'(r) = (2 - 2r) / r^3; J = I for r <= 1."""
    dim = x.shape[-1]
    r_sq = torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True), min=1e-32)
    r = torch.sqrt(r_sq)
    inside = (r_sq <= 1.0)[..., None]
    s = (2.0 * r - 1.0) / r_sq
    c = (2.0 - 2.0 * r) / (r_sq * r_sq)
    eye = torch.eye(dim, dtype=x.dtype, device=x.device)
    outer = x[..., :, None] * x[..., None, :]
    jac_out = s[..., None] * eye + c[..., None] * outer
    return torch.where(inside, eye, jac_out)


def contract(mean: torch.Tensor, cov: torch.Tensor):
    """Contract gaussians (mean [..., 3], cov [..., 3, 3]) into the warped
    domain, the covariance through the closed-form Jacobian. Both outputs
    are detached."""
    jac = contract_jacobian(mean)
    new_mean = contract_points(mean)
    new_cov = torch.einsum("...ij,...jk,...lk->...il", jac, cov, jac)
    return new_mean.detach(), new_cov.detach()


def lift_and_diagonalize(means: torch.Tensor, covs: torch.Tensor,
                         basis: torch.Tensor):
    """Project gaussians onto `basis` [3, n]: (means', diagonal vars')."""
    fn_mean = torch.matmul(means, basis)
    fn_cov_diag = torch.sum(basis * torch.matmul(covs, basis), dim=-2)
    return fn_mean, fn_cov_diag


def expected_sin(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """E[sin(z)] for z ~ N(mean, var)."""
    return torch.exp(-0.5 * var) * torch.sin(mean)


def _scales(min_deg: int, max_deg: int, like: torch.Tensor) -> torch.Tensor:
    return 2.0 ** torch.arange(min_deg, max_deg, dtype=like.dtype,
                               device=like.device)


def integrated_pos_enc(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
                       max_deg: int) -> torch.Tensor:
    """Integrated positional encoding of a diagonal gaussian."""
    scales = _scales(min_deg, max_deg, mean)
    shape = mean.shape[:-1] + (-1,)
    scaled_mean = (mean[..., None, :] * scales[:, None]).reshape(shape)
    scaled_var = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(
        torch.cat([scaled_mean, scaled_mean + 0.5 * math.pi], dim=-1),
        torch.cat([scaled_var, scaled_var], dim=-1))


def contracted_lifted_gaussians(origins, directions, radii, t_vals, basis,
                                ray_shape: str = "cone"):
    """`cast_rays(diag=False)` -> `contract` -> `lift_and_diagonalize` in
    one pass: (lifted_means [..., S, m], lifted_vars [..., S, m]), both
    detached, with no [..., 3, 3] intermediates.

    The frustum covariance is S = r_var I + a d d^T with
    a = t_var - r_var / |d|^2, and the contraction's Jacobian is
    J = s I + c x x^T, so for each basis column p, q = J p = s p + c (x.p) x
    and var_p = p^T J S J p = r_var |q|^2 + a (q.d)^2."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    if ray_shape == "cone":
        mu = (t0 + t1) / 2.0
        hw = (t1 - t0) / 2.0
        denom = torch.clamp(3.0 * mu ** 2 + hw ** 2, min=EPS)
        t_mean = mu + (2.0 * mu * hw ** 2) / denom
        t_var = (hw ** 2 / 3.0
                 - (4.0 / 15.0) * hw ** 4 * (12.0 * mu ** 2 - hw ** 2)
                 / denom ** 2)
        r_var = (mu ** 2 / 4.0 + (5.0 / 12.0) * hw ** 2
                 - (4.0 / 15.0) * hw ** 4 / denom) * radii ** 2
    elif ray_shape == "cylinder":
        t_mean = (t0 + t1) / 2.0
        t_var = (t1 - t0) ** 2 / 12.0
        r_var = torch.broadcast_to(radii ** 2 / 4.0, t_mean.shape)
    else:
        raise ValueError(f"unknown ray_shape {ray_shape!r}")

    d = directions
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True),
                           min=1e-10)
    x = origins[..., None, :] + d[..., None, :] * t_mean[..., None]

    beta = r_var
    alpha = t_var - r_var / d_mag_sq

    r_sq = torch.clamp(torch.sum(x ** 2, dim=-1), min=1e-32)
    r = torch.sqrt(r_sq)
    inside = r_sq <= 1.0
    s = torch.where(inside, 1.0, (2.0 * r - 1.0) / r_sq)
    c = torch.where(inside, 0.0, (2.0 - 2.0 * r) / (r_sq * r_sq))

    xp = torch.matmul(x, basis)                          # [..., S, m]
    dp = torch.matmul(d, basis)                          # [..., m]
    xd = torch.sum(x * d[..., None, :], dim=-1)          # [..., S]
    p_sq = torch.sum(basis * basis, dim=0)               # [m]

    cxp = c[..., None] * xp
    qd = s[..., None] * dp[..., None, :] + cxp * xd[..., None]
    q_sq = (s[..., None] ** 2 * p_sq
            + (2.0 * s * c + c ** 2 * r_sq)[..., None] * xp ** 2)
    lifted_vars = beta[..., None] * q_sq + alpha[..., None] * qd ** 2

    lifted_means = torch.matmul(contract_points(x), basis)
    return lifted_means.detach(), lifted_vars.detach()


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int,
            append_identity: bool = True) -> torch.Tensor:
    """Classic NeRF sinusoidal positional encoding."""
    scales = _scales(min_deg, max_deg, x)
    xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if append_identity:
        return torch.cat([x, four_feat], dim=-1)
    return four_feat


def construct_ray_warps(t_near, t_far):
    """(t_to_s, s_to_t) for the 1/t metric warp."""
    s_near, s_far = 1.0 / t_near, 1.0 / t_far

    def t_to_s(t):
        return (1.0 / t - s_near) / (s_far - s_near)

    def s_to_t(s):
        return 1.0 / (s * s_far + (1.0 - s) * s_near)

    return t_to_s, s_to_t


def lift_gaussian(d, t_mean, t_var, r_var, diag: bool):
    """Lift a 1D gaussian along ray direction `d` into 3D."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True),
                           min=1e-10)
    if diag:
        d_outer_diag = d ** 2
        null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(d, t0, t1, radius, diag: bool):
    """Approximate a conical frustum with a gaussian."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    denom = torch.clamp(3.0 * mu ** 2 + hw ** 2, min=EPS)
    t_mean = mu + (2.0 * mu * hw ** 2) / denom
    t_var = (hw ** 2 / 3.0
             - (4.0 / 15.0) * hw ** 4 * (12.0 * mu ** 2 - hw ** 2)
             / denom ** 2)
    r_var = mu ** 2 / 4.0 + (5.0 / 12.0) * hw ** 2 \
        - (4.0 / 15.0) * hw ** 4 / denom
    return lift_gaussian(d, t_mean, t_var, r_var * radius ** 2, diag)


def cylinder_to_gaussian(d, t0, t1, radius, diag: bool):
    """Approximate a cylinder segment with a gaussian."""
    t_mean = (t0 + t1) / 2.0
    r_var = radius ** 2 / 4.0
    t_var = (t1 - t0) ** 2 / 12.0
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cast_rays(t_vals, origins, directions, radii, ray_shape: str = "cone",
              diag: bool = True):
    """Cast rays as gaussians over the intervals in `t_vals`."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    if ray_shape == "cone":
        gaussian_fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        gaussian_fn = cylinder_to_gaussian
    else:
        raise ValueError(f"unknown ray_shape {ray_shape!r}")
    means, covs = gaussian_fn(directions, t0, t1, radii, diag)
    return means + origins[..., None, :], covs
