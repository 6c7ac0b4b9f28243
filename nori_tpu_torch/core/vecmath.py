"""Vector math over batched (..., 3) tensors.

Port of `nori_tpu/core/vecmath.py`.  Everything operates on tensors
whose last axis is the spatial dimension, so a "Vector3f" is any
(..., 3) tensor and a million rays are three (N, 3) tensors.
"""

from __future__ import annotations

import math

import torch

# Epsilon used by the reference for shadow-ray offsets
# (include/nori/common.h: Epsilon = 1e-4).
EPSILON = 1e-4
INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)


def dot(a, b):
    """Batched dot product over the last axis -> (..., ) tensor."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a, eps: float = 0.0):
    """Normalize over the last axis.  With eps>0, guards zero vectors."""
    n2 = torch.sum(a * a, dim=-1, keepdim=True)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return a * (1.0 / torch.sqrt(n2))


def coordinate_system(a):
    """Two unit vectors orthogonal to unit vector ``a`` (branch
    structure of src/common.cpp:260-270, vectorized with `where`)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    cond = torch.abs(ax) > torch.abs(ay)
    one = torch.ones_like(ax)
    zero = torch.zeros_like(ax)
    inv_len_1 = 1.0 / torch.sqrt(torch.where(cond, ax * ax + az * az, one))
    c1 = torch.stack([az * inv_len_1, zero, -ax * inv_len_1], dim=-1)
    inv_len_2 = 1.0 / torch.sqrt(torch.where(cond, one, ay * ay + az * az))
    c2 = torch.stack([zero, az * inv_len_2, -ay * inv_len_2], dim=-1)
    c = torch.where(cond[..., None], c1, c2)
    b = cross(c, a)
    return b, c


# Shading frames: a frame is a tuple of three (..., 3) tensors (s, t, n)
# (reference: include/nori/frame.h:32-145).

def make_frame(n):
    """Frame from a normal (reference frame.h:47-49)."""
    s, t = coordinate_system(n)
    return s, t, n


def to_local(frame, v):
    s, t, n = frame
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)


def to_world(frame, v):
    s, t, n = frame
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]


def reflect_local(wi):
    """Mirror reflection about the z axis in the local shading frame
    (reference src/mirror.cpp:44-48)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def fresnel_dielectric(cos_theta_i, ext_ior, int_ior):
    """Unpolarized dielectric Fresnel reflectance (src/common.cpp:
    271-301): rays arriving from inside (cos<0) swap the IORs; total
    internal reflection returns 1.  ext_ior/int_ior broadcast against
    cos_theta_i."""
    ext = torch.broadcast_to(torch.as_tensor(ext_ior), cos_theta_i.shape)
    intr = torch.broadcast_to(torch.as_tensor(int_ior), cos_theta_i.shape)
    inside = cos_theta_i < 0.0
    eta_i = torch.where(inside, intr, ext)
    eta_t = torch.where(inside, ext, intr)
    ci = torch.abs(cos_theta_i)

    eta = eta_i / eta_t
    sin_t2 = eta * eta * (1.0 - ci * ci)
    tir = sin_t2 > 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - sin_t2, 0.0))
    rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct)
    rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct)
    f = 0.5 * (rs * rs + rp * rp)
    f = torch.where(tir, torch.ones_like(f), f)
    return torch.where(ext == intr, torch.zeros_like(f), f)
