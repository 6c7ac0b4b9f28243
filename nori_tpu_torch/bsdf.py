"""BSDF models: host plugin classes + batched tensor functions.

Port of `nori_tpu/bsdf.py`.  The reference defines a virtual BSDF interface (include/nori/bsdf.h:29-112)
with four registered models: diffuse (src/diffuse.cpp), mirror
(src/mirror.cpp), dielectric (src/dielectric.cpp, sample() left to the
assignments) and the Beckmann rough-plastic microfacet model
(src/microfacet.cpp, eval/pdf/sample left to the assignments; semantics
pinned by scenes/pa5/tests/{chi2test,ttest}-microfacet.xml).

Design: instead of virtual dispatch per ray, all BSDF parameters live
in a per-mesh table (`table_arrays`, packed into SceneData.mesh_attr),
hits gather their mesh's row, and `eval/pdf/sample` compute every
model's answer with masked element-wise math, then select by type code.

Directions use the local shading frame with +z = normal, matching
BSDFQueryRecord (bsdf.h:33-63): `wi` points toward the origin of the
path (camera side), `wo` is the sampled continuation.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.registry import register_class
from nori_tpu_torch.core.vecmath import INV_PI, fresnel_dielectric, reflect_local
from nori_tpu_torch import warp

# type codes
DIFFUSE, MIRROR, DIELECTRIC, MICROFACET = 0, 1, 2, 3

#: measures (bsdf.h:38-45)
E_UNKNOWN, E_SOLID_ANGLE, E_DISCRETE = 0, 1, 2


# ---------------------------------------------------------------------------
# Host-side plugin classes (XML-facing)
# ---------------------------------------------------------------------------

class BSDF(NoriObject):
    class_kind = registry.BSDF
    bsdf_type: int = DIFFUSE

    def is_diffuse(self) -> bool:
        return False

    def table_row(self) -> dict:
        """Default parameter row; overridden per model."""
        return {
            "type": self.bsdf_type,
            "albedo": np.zeros(3),
            "alpha": 0.0,
            "int_ior": 1.0,
            "ext_ior": 1.0,
            "ks": 0.0,
        }


@register_class("diffuse")
class Diffuse(BSDF):
    bsdf_type = DIFFUSE

    def __init__(self, props):
        self.albedo = props.get_color("albedo", np.full(3, 0.5))

    def is_diffuse(self):
        return True

    def table_row(self):
        row = super().table_row()
        row.update(type=DIFFUSE, albedo=np.asarray(self.albedo))
        return row

    def to_string(self):
        return f"Diffuse[albedo={self.albedo.tolist()}]"


@register_class("mirror")
class Mirror(BSDF):
    bsdf_type = MIRROR

    def __init__(self, props):
        pass

    def table_row(self):
        row = super().table_row()
        row.update(type=MIRROR, albedo=np.ones(3))
        return row

    def to_string(self):
        return "Mirror[]"


@register_class("dielectric")
class Dielectric(BSDF):
    bsdf_type = DIELECTRIC

    def __init__(self, props):
        # defaults: BK7 glass / air (src/dielectric.cpp:28-34)
        self.int_ior = props.get_float("intIOR", 1.5046)
        self.ext_ior = props.get_float("extIOR", 1.000277)

    def table_row(self):
        row = super().table_row()
        row.update(
            type=DIELECTRIC, albedo=np.ones(3),
            int_ior=self.int_ior, ext_ior=self.ext_ior,
        )
        return row

    def to_string(self):
        return f"Dielectric[intIOR={self.int_ior}, extIOR={self.ext_ior}]"


@register_class("microfacet")
class Microfacet(BSDF):
    bsdf_type = MICROFACET

    def __init__(self, props):
        # defaults match src/microfacet.cpp:27-49
        self.alpha = props.get_float("alpha", 0.1)
        self.int_ior = props.get_float("intIOR", 1.5046)
        self.ext_ior = props.get_float("extIOR", 1.000277)
        self.kd = props.get_color("kd", np.full(3, 0.5))
        # energy-conservation split ks = 1 - max(kd)
        self.ks = 1.0 - float(np.max(self.kd))

    def is_diffuse(self):
        return True

    def table_row(self):
        row = super().table_row()
        row.update(
            type=MICROFACET, albedo=np.asarray(self.kd), alpha=self.alpha,
            int_ior=self.int_ior, ext_ior=self.ext_ior, ks=self.ks,
        )
        return row

    def to_string(self):
        return (
            f"Microfacet[alpha={self.alpha}, intIOR={self.int_ior}, "
            f"extIOR={self.ext_ior}, kd={self.kd.tolist()}, ks={self.ks}]"
        )


# ---------------------------------------------------------------------------
# Per-mesh parameter table and batched evaluation
# ---------------------------------------------------------------------------

def table_arrays(bsdfs) -> dict:
    """Per-mesh BSDF parameter columns as numpy arrays (the JAX
    package's BSDFTable.build, rounded to float32 the same way)."""
    rows = [b.table_row() for b in bsdfs]
    return {
        "type": np.asarray([r["type"] for r in rows], np.int32),
        "albedo": np.stack([r["albedo"] for r in rows]).astype(np.float32),
        "alpha": np.asarray([r["alpha"] for r in rows], np.float32),
        "int_ior": np.asarray([r["int_ior"] for r in rows], np.float32),
        "ext_ior": np.asarray([r["ext_ior"] for r in rows], np.float32),
        "ks": np.asarray([r["ks"] for r in rows], np.float32),
    }


class BSDFParams(NamedTuple):
    """Per-lane gathered parameters."""

    type: torch.Tensor     # (N,) int32
    albedo: torch.Tensor   # (N, 3)
    alpha: torch.Tensor    # (N,)
    int_ior: torch.Tensor  # (N,)
    ext_ior: torch.Tensor  # (N,)
    ks: torch.Tensor       # (N,)


class BSDFSample(NamedTuple):
    wo: torch.Tensor       # (N, 3) sampled direction, local frame
    weight: torch.Tensor   # (N, 3) f * cos / pdf (or discrete weight)
    pdf: torch.Tensor      # (N,) solid-angle pdf (0 for discrete lobes)
    measure: torch.Tensor  # (N,) int32: E_SOLID_ANGLE or E_DISCRETE
    eta: torch.Tensor      # (N,) relative IOR along the sampled direction


def _unit(v, floor):
    return v / torch.clamp_min(
        torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), floor)


# -- Beckmann helpers -------------------------------------------------------

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
    g = _smith_beckmann_g1(wi, wh, p.alpha) * _smith_beckmann_g1(wo, wh, p.alpha)
    spec = p.ks * d * f * g / torch.clamp_min(4.0 * cos_i * cos_o, 1e-12)
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


# -- public batched interface ----------------------------------------------

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
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    w_diff = torch.where((cos_i > 0.0)[..., None], p.albedo, 0.0)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_diff)

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
    wh = warp.square_to_beckmann(u2m, torch.clamp_min(p.alpha, 1e-6))
    wo_spec = 2.0 * torch.sum(wi * wh, dim=-1, keepdim=True) * wh - wi
    wo_cos = warp.square_to_cosine_hemisphere(u2m)
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
    dead = ((t == DIFFUSE) | (t == MIRROR) | (t == MICROFACET)) & (cos_i <= 0.0)
    weight = torch.where(dead[..., None], 0.0, weight)
    return BSDFSample(wo=wo, weight=weight, pdf=pdf, measure=measure, eta=eta)
