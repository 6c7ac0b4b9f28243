"""Frozen copies of the renderer's sampling and shading formulas.

The counter-based RNG (a PCG hash of (seed, sample id, stream)), the
vector helpers, the warps and the four BSDF models (diffuse, mirror,
dielectric, Beckmann rough plastic), as the renderer's semantics define
them.  They are copied, not imported, so that the reference draws the
same uniforms for the same (seed, sample, decision) as the program and
a change to the program cannot change the yardstick.  BSDF parameters
come per lane as a `Params` tuple gathered from the reference's own
material table (`scene.RefScene.mat`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.scene import DIELECTRIC, DIFFUSE, MICROFACET, MIRROR

_M32 = 0xFFFFFFFF
INV_PI = 1.0 / math.pi
#: measures of a BSDF sample
E_SOLID_ANGLE, E_DISCRETE = 1, 2


class Params(NamedTuple):
    type: torch.Tensor     # (N,) int
    albedo: torch.Tensor   # (N, 3)
    alpha: torch.Tensor    # (N,)
    int_ior: torch.Tensor  # (N,)
    ext_ior: torch.Tensor  # (N,)
    ks: torch.Tensor       # (N,)


class Sample(NamedTuple):
    wo: torch.Tensor
    weight: torch.Tensor
    pdf: torch.Tensor
    measure: torch.Tensor
    eta: torch.Tensor


BSDFParams = Params
BSDFSample = Sample


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    dev = like.device if like is not None else None
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=dev)


def _pcg(x: torch.Tensor) -> torch.Tensor:
    """PCG output hash (Jarzynski & Olano, "Hash Functions for GPU
    Rendering", JCGT 2020) on int64 tensors holding uint32 values."""
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def hash_combine(*ints) -> torch.Tensor:
    """Chain the PCG hash over the inputs; returns int64 tensors
    holding the uint32 hash."""
    like = next((v for v in ints if isinstance(v, torch.Tensor)), None)
    acc = _u32(0x9E3779B9, like)
    for v in ints:
        acc = _pcg((acc + _u32(v, like)) & _M32)
    return _pcg(acc)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(seed, lane, stream) -> torch.Tensor:
    """U[0,1) for each (lane, stream); arguments broadcast."""
    return uniform_from_bits(hash_combine(seed, lane, stream))


def uniform2(seed, lane, stream) -> torch.Tensor:
    """A pair of independent uniforms (2D sample); returns (..., 2).

    Stream ids are offset into a reserved range so a `uniform(s)` call
    never collides with a `uniform2(s')` call for small ids (< 2**16).
    """
    like = lane if isinstance(lane, torch.Tensor) else None
    s = _u32(stream, like)
    u1 = uniform(seed, lane, (s + 0x10000) & _M32)
    u2 = uniform(seed, lane, (s + 0x20000) & _M32)
    return torch.stack([u1, u2], dim=-1)


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


def square_to_uniform_disk(sample):
    r = torch.sqrt(sample[..., 0])
    theta = 2.0 * math.pi * sample[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def square_to_cosine_hemisphere(sample):
    d = square_to_uniform_disk(sample)
    z = torch.sqrt(torch.clamp_min(1.0 - torch.sum(d * d, dim=-1), 0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v):
    return torch.where(v[..., 2] >= 0.0, v[..., 2] * INV_PI, 0.0)


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


def _unit(v, floor):
    return v / torch.clamp_min(
        torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), floor)


def beckmann_d(wh, alpha):
    """Beckmann NDF D(wh); zero below the horizon."""
    cos_t = wh[..., 2]
    safe = torch.clamp_min(cos_t, 1e-8)
    tan2 = (1.0 - cos_t * cos_t) / (safe * safe)
    a2 = alpha * alpha
    d = torch.exp(-tan2 / a2) / (math.pi * a2 * safe ** 4)
    return torch.where(cos_t > 1e-8, d, 0.0)


def _smith_beckmann_g1(wv, wh, alpha):
    """Smith masking term with Walter's rational Beckmann approximation."""
    cos_v = wv[..., 2]
    # chi+ : sidedness of wv wrt the half vector
    chi = (torch.sum(wv * wh, dim=-1) * cos_v) > 0.0
    safe = torch.clamp_min(torch.abs(cos_v), 1e-8)
    tan_v = torch.sqrt(torch.clamp_min(1.0 - cos_v * cos_v, 0.0)) / safe
    b = 1.0 / torch.clamp_min(alpha * tan_v, 1e-8)
    rational = (3.535 * b + 2.181 * b * b) / (1.0 + 2.276 * b + 2.577 * b * b)
    g = torch.where(b < 1.6, rational, 1.0)
    return torch.where(chi, g, 0.0)


def _microfacet_eval(p: BSDFParams, wi, wo):
    """kd/pi + ks * D F G / (4 cos_i cos_o) (pa5 microfacet model)."""
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    wh = _unit(wi + wo, 1e-12)
    d = beckmann_d(wh, p.alpha)
    f = fresnel_dielectric(torch.sum(wh * wi, dim=-1), p.ext_ior, p.int_ior)
    g = (_smith_beckmann_g1(wi, wh, p.alpha)
         * _smith_beckmann_g1(wo, wh, p.alpha))
    spec = p.ks * d * f * g / torch.clamp_min(4.0 * cos_i * cos_o,
                                              1e-12)
    val = p.albedo * INV_PI + spec[..., None]
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    return torch.where(ok[..., None], val, 0.0)


def _microfacet_pdf(p: BSDFParams, wi, wo):
    """ks * D(wh) cos_h jacobian + (1-ks) cos_o / pi."""
    cos_o = wo[..., 2]
    wh = _unit(wi + wo, 1e-12)
    d_pdf = beckmann_d(wh, p.alpha) * torch.abs(wh[..., 2])
    jacobian = 1.0 / torch.clamp_min(
        4.0 * torch.abs(torch.sum(wh * wo, dim=-1)), 1e-12)
    pdf = p.ks * d_pdf * jacobian + (1.0 - p.ks) * cos_o * INV_PI
    return torch.where(cos_o > 0.0, pdf, 0.0)


def eval_bsdf(p: BSDFParams, wi, wo):
    """f(wi, wo) under the solid-angle measure; discrete models -> 0
    (src/diffuse.cpp:35-46, src/mirror.cpp:29)."""
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    front = (cos_i > 0.0) & (cos_o > 0.0)
    diffuse = torch.where(front[..., None], p.albedo * INV_PI, 0.0)
    micro = _microfacet_eval(p, wi, wo)
    t = p.type[..., None]
    return torch.where(
        t == DIFFUSE, diffuse, torch.where(t == MICROFACET, micro, 0.0))


def pdf_bsdf(p: BSDFParams, wi, wo):
    """Density of sample_bsdf wrt solid angle; discrete models -> 0."""
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    front = (cos_i > 0.0) & (cos_o > 0.0)
    diffuse = torch.where(front, cos_o * INV_PI, 0.0)
    micro = torch.where(cos_i > 0.0, _microfacet_pdf(p, wi, wo), 0.0)
    return torch.where(
        p.type == DIFFUSE, diffuse,
        torch.where(p.type == MICROFACET, micro, 0.0))


def sample_bsdf(p: BSDFParams, wi, u_lobe, u2) -> BSDFSample:
    """Importance-sample all models, select by type.

    u_lobe: (N,) uniform driving the discrete lobe choice; u2: (N, 2)
    uniforms for the direction.  Weight convention matches
    BSDF::sample (bsdf.h:71-84): f * cos / pdf, with discrete events
    folding their probability in.
    """
    cos_i = wi[..., 2]
    ones3 = torch.ones_like(wi)

    # --- diffuse: cosine hemisphere, weight = albedo -----------------------
    wo_diff = square_to_cosine_hemisphere(u2)
    w_diff = torch.where((cos_i > 0.0)[..., None], p.albedo, 0.0)
    pdf_diff = square_to_cosine_hemisphere_pdf(wo_diff)

    # --- mirror: deterministic reflection, weight 1 ------------------------
    wo_mirr = reflect_local(wi)
    w_mirr = torch.where((cos_i > 0.0)[..., None], ones3, 0.0)

    # --- dielectric: fresnel-weighted reflect/refract ----------------------
    f = fresnel_dielectric(cos_i, p.ext_ior, p.int_ior)
    inside = cos_i < 0.0
    eta_i = torch.where(inside, p.int_ior, p.ext_ior)
    eta_t = torch.where(inside, p.ext_ior, p.int_ior)
    eta_ratio = eta_i / eta_t
    sin_t2 = eta_ratio * eta_ratio * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t2, 0.0))
    refr_sign = torch.where(cos_i >= 0.0, -1.0, 1.0)
    wo_refr = torch.stack(
        [-wi[..., 0] * eta_ratio, -wi[..., 1] * eta_ratio,
         refr_sign * cos_t], dim=-1)
    reflecting = u_lobe < f
    wo_diel = torch.where(reflecting[..., None], wo_mirr, wo_refr)
    # radiance through the interface scales by (eta_i/eta_t)^2
    # (solid-angle compression); reflection carries weight 1
    w_refr = (eta_ratio * eta_ratio)[..., None] * ones3
    w_diel = torch.where(reflecting[..., None], ones3, w_refr)
    eta_diel = torch.where(reflecting, 1.0, eta_ratio)

    # --- microfacet: ks Beckmann-reflect + (1-ks) cosine -------------------
    pick_spec = u_lobe < p.ks
    # stretch u_lobe back to a fresh uniform for the chosen lobe
    u_re = torch.where(
        pick_spec,
        u_lobe / torch.clamp_min(p.ks, 1e-8),
        (u_lobe - p.ks) / torch.clamp_min(1.0 - p.ks, 1e-8),
    )
    u2m = torch.stack([u_re, u2[..., 1]], dim=-1)
    wh = square_to_beckmann(u2m, torch.clamp_min(p.alpha, 1e-6))
    wo_spec = 2.0 * torch.sum(wi * wh, dim=-1, keepdim=True) * wh - wi
    wo_cos = square_to_cosine_hemisphere(u2m)
    wo_micro = torch.where(pick_spec[..., None], wo_spec, wo_cos)
    pdf_micro = _microfacet_pdf(p, wi, wo_micro)
    f_micro = _microfacet_eval(p, wi, wo_micro)
    ok_micro = (cos_i > 0.0) & (wo_micro[..., 2] > 0.0) & (pdf_micro > 1e-12)
    w_micro = torch.where(
        ok_micro[..., None],
        f_micro * (wo_micro[..., 2]
                   / torch.clamp_min(pdf_micro, 1e-12))[..., None],
        0.0,
    )

    # --- select by type ----------------------------------------------------
    t = p.type
    t3 = t[..., None]
    wo = torch.where(
        t3 == DIFFUSE, wo_diff,
        torch.where(t3 == MIRROR, wo_mirr,
                    torch.where(t3 == DIELECTRIC, wo_diel, wo_micro)))
    weight = torch.where(
        t3 == DIFFUSE, w_diff,
        torch.where(t3 == MIRROR, w_mirr,
                    torch.where(t3 == DIELECTRIC, w_diel, w_micro)))
    pdf = torch.where(
        t == DIFFUSE, pdf_diff, torch.where(t == MICROFACET, pdf_micro, 0.0))
    discrete = (t == MIRROR) | (t == DIELECTRIC)
    measure = torch.where(discrete, E_DISCRETE, E_SOLID_ANGLE).to(torch.int32)
    eta = torch.where(t == DIELECTRIC, eta_diel, 1.0)

    # kill invalid lanes (backside for reflective models)
    dead = (((t == DIFFUSE) | (t == MIRROR) | (t == MICROFACET))
            & (cos_i <= 0.0))
    weight = torch.where(dead[..., None], 0.0, weight)
    return BSDFSample(wo=wo, weight=weight, pdf=pdf, measure=measure, eta=eta)
