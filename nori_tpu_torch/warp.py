"""Square-to-distribution warping functions + densities.

Port of `nori_tpu/warp.py` (reference include/nori/warp.h:27-70),
vectorized over (..., 2) sample tensors and defined on the full domain
(pdfs return 0 outside their support).
"""

from __future__ import annotations

import math

import torch

from nori_tpu_torch.core.vecmath import INV_PI, INV_TWOPI, INV_FOURPI


# -- uniform square ---------------------------------------------------------

def square_to_uniform_square(sample):
    return sample


def square_to_uniform_square_pdf(p):
    inside = torch.all((p >= 0.0) & (p <= 1.0), dim=-1)
    return torch.where(inside, 1.0, 0.0)


# -- 2D tent ----------------------------------------------------------------

def square_to_tent(sample):
    # piecewise inverse CDF of the 1D tent on [-1, 1]
    return torch.where(
        sample < 0.5,
        torch.sqrt(torch.clamp_min(2.0 * sample, 0.0)) - 1.0,
        1.0 - torch.sqrt(torch.clamp_min(2.0 * (1.0 - sample), 0.0)),
    )


def square_to_tent_pdf(p):
    d = torch.clamp_min(1.0 - torch.abs(p), 0.0)
    inside = torch.all(torch.abs(p) <= 1.0, dim=-1)
    return torch.where(inside, d[..., 0] * d[..., 1], 0.0)


# -- uniform disk -----------------------------------------------------------

def square_to_uniform_disk(sample):
    r = torch.sqrt(sample[..., 0])
    theta = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def square_to_uniform_disk_pdf(p):
    inside = torch.sum(p * p, dim=-1) <= 1.0
    return torch.where(inside, INV_PI, 0.0)


# -- uniform sphere ---------------------------------------------------------

def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf(v):
    return torch.full(v.shape[:-1], INV_FOURPI, dtype=v.dtype,
                      device=v.device)


# -- uniform hemisphere (z >= 0) -------------------------------------------

def square_to_uniform_hemisphere(sample):
    z = sample[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_hemisphere_pdf(v):
    return torch.where(v[..., 2] >= 0.0, INV_TWOPI, 0.0)


# -- cosine-weighted hemisphere --------------------------------------------

def square_to_cosine_hemisphere(sample):
    d = square_to_uniform_disk(sample)
    z = torch.sqrt(torch.clamp_min(1.0 - torch.sum(d * d, dim=-1), 0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v):
    return torch.where(v[..., 2] >= 0.0, v[..., 2] * INV_PI, 0.0)


# -- Beckmann distribution * cosine ----------------------------------------

def square_to_beckmann(sample, alpha):
    """Sample a normal from the Beckmann NDF D(m) * cos(theta_m):
    theta = arctan(sqrt(-alpha^2 ln(1 - u1))), phi = 2 pi u2."""
    phi = 2.0 * math.pi * sample[..., 1]
    tan2 = -alpha * alpha * torch.log(
        torch.clamp_min(1.0 - sample[..., 0], 1e-38))
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def square_to_beckmann_pdf(m, alpha):
    """Density of square_to_beckmann wrt solid angle:
    D(m) cos(theta) = exp(-tan^2/alpha^2) / (pi alpha^2 cos^3 theta)."""
    cos_t = m[..., 2]
    safe_cos = torch.clamp_min(cos_t, 1e-9)
    tan2 = (1.0 - cos_t * cos_t) / (safe_cos * safe_cos)
    a2 = alpha * alpha
    d = torch.exp(-tan2 / a2) / (math.pi * a2 * safe_cos ** 3)
    return torch.where(cos_t > 1e-9, d, 0.0)


#: name -> (warp, pdf, output-dim, takes-alpha)
WARPS = {
    "square": (square_to_uniform_square, square_to_uniform_square_pdf, 2, False),
    "tent": (square_to_tent, square_to_tent_pdf, 2, False),
    "disk": (square_to_uniform_disk, square_to_uniform_disk_pdf, 2, False),
    "sphere": (square_to_uniform_sphere, square_to_uniform_sphere_pdf, 3, False),
    "hemisphere": (
        square_to_uniform_hemisphere, square_to_uniform_hemisphere_pdf, 3, False),
    "cosine": (
        square_to_cosine_hemisphere, square_to_cosine_hemisphere_pdf, 3, False),
    "beckmann": (square_to_beckmann, square_to_beckmann_pdf, 3, True),
}
