"""Vectorized re-evaluation of stored shading-point materials.

Port of `nori_tpu/pathgraph/bsdfgraph.py` (the GPU BSDF library,
src/pbsdf.cu:258-628): evaluates the material stored at a shading
point for an arbitrary NEW incident direction `wi` (world space).  Four
material classes selected by `bsdf_type`:

  'd' diffuse           : diffuse/pi * <wi, shN>
  'o' opaque rough-plastic: Beckmann D * Smith G * F / (4 cos_o) +
                            energy-conserving (1-F)(1-F) diffuse
  'c' rough conductor   : D * G * F_conductor / (4 cos_o)
  't' dielectric        : delta reflect/refract with Fresnel weights

All functions take SoA tensors and are branch-free (`torch.where`).
The returned "bsdf" follows the reference convention: it INCLUDES the
<wi, shN> cosine (bsdfeval_device multiplies diffuseconst by dotWiShN
and divides specular by cos_o only).

For the delta 't' class the reflected and refracted directions are
rebuilt about shN in world space and a query direction counts when
|<wi, dir> - 1| <= 1e-5; see eval_graph_bsdf for the Snell selector.

The sums and norms are written out as the JAX package computes them
(`jnp.sum` over the last axis, `jnp.hypot`), so the CPU results round
as its CPU results do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INV_PI = 1.0 / math.pi


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def _normalize(a):
    return a / torch.clamp_min(_norm(a), 1e-20)[..., None]


def _hypot1(r):
    """hypot(1, r) as jnp.hypot computes it: the larger leg times
    sqrt(1 + (smaller / larger)^2)."""
    r = torch.abs(r)
    hi = torch.clamp_min(r, 1.0)
    lo = torch.clamp_max(r, 1.0)
    x = hi * torch.sqrt(1.0 + torch.square(lo / hi))
    return torch.where(torch.isposinf(r), math.inf, x)


def fresnel_dielectric_ext(cos_theta_i, eta):
    """fresnelDielectricExt (pbsdf.cu:409-431): eta = int/ext ratio.
    Returns (F, cos_theta_t)."""
    scale = torch.where(cos_theta_i > 0.0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_theta_i ** 2) * scale * scale
    tir = cos_t2 <= 0.0
    ci = torch.abs(cos_theta_i)
    ct = torch.sqrt(torch.clamp_min(cos_t2, 0.0))
    rs = (ci - eta * ct) / (ci + eta * ct)
    rp = (eta * ci - ct) / (eta * ci + ct)
    f = 0.5 * (rs * rs + rp * rp)
    f = torch.where(tir, 1.0, f)
    return torch.where(eta == 1.0, 0.0, f), torch.where(
        tir, 0.0, torch.where(cos_theta_i > 0.0, -ct, ct))


def fresnel_conductor_exact(cos_theta_i, eta, k):
    """fresnelConductorExact (pbsdf.cu:354-374); eta/k: (..., 3)."""
    c2 = (cos_theta_i ** 2)[..., None]
    s2 = 1.0 - c2
    s4 = s2 * s2
    t1 = eta * eta - k * k - s2
    a2pb2 = torch.sqrt(torch.clamp_min(t1 * t1 + 4.0 * k * k * eta * eta,
                                       0.0))
    a = torch.sqrt(torch.clamp_min(0.5 * (a2pb2 + t1), 0.0))
    term1 = a2pb2 + c2
    term2 = 2.0 * a * torch.sqrt(torch.clamp_min(c2, 0.0))
    rs2 = (term1 - term2) / torch.clamp_min(term1 + term2, 1e-20)
    term3 = a2pb2 * c2 + s4
    term4 = term2 * s2
    rp2 = rs2 * (term3 - term4) / torch.clamp_min(term3 + term4, 1e-20)
    return 0.5 * (rp2 + rs2)


def beckmann_d(cos_h, roughness):
    """distreval (pbsdf.cu:340-351)."""
    c2 = cos_h * cos_h
    r2 = torch.clamp_min(roughness * roughness, 1e-12)
    expo = (1.0 - c2) / torch.clamp_min(c2 * r2, 1e-20)
    root = (1.0 + expo) * c2
    d = 1.0 / torch.clamp_min(math.pi * r2 * root * root, 1e-20)
    return torch.where(cos_h > 0.0, d, 0.0)


def smith_g1(dot_wh, dot_wn, roughness):
    """smithG1 (pbsdf.cu:432-443): 2 / (1 + hypot(1, a tan))."""
    c2 = dot_wn * dot_wn
    tan_t = torch.sqrt(torch.clamp_min(
        (1.0 - c2) / torch.clamp_min(c2, 1e-20), 0.0))
    root = roughness * tan_t
    g = 2.0 / (1.0 + _hypot1(root))
    g = torch.where(tan_t == 0.0, 1.0, g)
    return torch.where(dot_wh * dot_wn > 0.0, g, 0.0)


def distr_pdf(dot_wo_n, dot_wo_h, dot_wh_n, roughness):
    """distrpdf (pbsdf.cu:445-448): visible-normal density."""
    p = (
        smith_g1(dot_wo_h, dot_wo_n, roughness) * torch.abs(dot_wo_h)
        * beckmann_d(dot_wh_n, roughness)
        / torch.clamp_min(torch.abs(dot_wo_n), 1e-20)
    )
    return torch.where(dot_wo_n == 0.0, 0.0, p)


def _type_code(sps_type):
    """bsdf_type bytes -> int codes 0:'d' 1:'o' 2:'c' 3:'t'."""
    codes = np.zeros(len(sps_type), np.int32)
    raw = np.frombuffer(
        np.ascontiguousarray(sps_type).tobytes(), dtype=np.uint8)
    codes[raw == ord("o")] = 1
    codes[raw == ord("c")] = 2
    codes[raw == ord("t")] = 3
    return codes


#: float32 fields of the SPoint array, then the int32 ones
_F32 = ("pos", "wi", "wi_d", "wo", "shN", "geoN", "diffuse", "specular",
        "eLi", "eLd", "eta", "k", "roughness", "pdf", "rrpdf")
_I32 = ("nidx", "groupIdx")
_GP_FIELDS = _F32 + _I32 + ("type",)


class GraphPoints:
    """SoA mirror of an SPoint array (io.SPOINT_DTYPE) as tensors on one
    device.  `type` holds the int codes of `_type_code`."""

    def __init__(self, sps, device):
        self.n = len(sps)
        self.device = torch.device(device)
        for f in _F32:
            setattr(self, f, self._tensor(sps[f], torch.float32))
        for f in _I32:
            setattr(self, f, self._tensor(sps[f], torch.int32))
        self.type = self._tensor(_type_code(sps["bsdf_type"]), torch.int32)

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def _derived(self, fn):
        g = object.__new__(GraphPoints)
        g.n = None
        g.device = self.device
        for f in _GP_FIELDS:
            setattr(g, f, fn(getattr(self, f)))
        return g

    def gather(self, idx):
        """Every field at the points `idx` (any index shape)."""
        idx = idx.long()
        return self._derived(lambda a: a[idx])

    def expand(self, axis: int):
        """Insert a broadcast axis (positive index) into every field, so
        all-pairs shapes broadcast one gather instead of gathering
        (m, pad, pad) index tensors."""
        assert axis >= 0
        return self._derived(lambda a: a.unsqueeze(axis))


def _delta_dirs(sp, dot_wo_sh, wi, dot_wi_sh):
    """The 't' class's shared terms: (F, cos_t, same_side, align_refl,
    align_refr, eta)."""
    eta0 = sp.eta[..., 0]
    f_t, cos_t_t = fresnel_dielectric_ext(dot_wo_sh, eta0)
    refl_dir = _normalize(2.0 * dot_wo_sh[..., None] * sp.shN - sp.wo)
    same_side = dot_wi_sh * dot_wo_sh >= 0.0
    align_refl = torch.abs(_dot(wi, refl_dir) - 1.0) <= 1e-5
    # refracted direction about shN (Snell, world space).  Entering
    # (cos_t_t < 0) compresses the tangential component by 1/eta,
    # exiting expands it by eta, matching the sampler (bsdf.Dielectric)
    # so a recorded wi always aligns.  The reference kernel's selector
    # is inverted and unsigned (pbsdf.cu:456-461 refract), which would
    # zero every refracted eval.
    scale = torch.where(cos_t_t < 0.0, 1.0 / eta0, eta0)
    refr_dir = _normalize(
        -scale[..., None] * (sp.wo - dot_wo_sh[..., None] * sp.shN)
        + cos_t_t[..., None] * sp.shN)
    align_refr = torch.abs(_dot(wi, refr_dir) - 1.0) <= 1e-5
    return f_t, cos_t_t, same_side, align_refl, align_refr, eta0


def eval_graph_bsdf(sp, wi):
    """bsdfeval_device (pbsdf.cu:464-559) vectorized; sp: GraphPoints
    (possibly gathered or expanded), wi: (..., 3) world incident
    directions broadcasting against it.  Returns (..., 3)."""
    dot_wi_sh = _dot(wi, sp.shN)
    dot_wi_geo = _dot(wi, sp.geoN)
    dot_wo_sh = _dot(sp.wo, sp.shN)

    # ---- 't' dielectric delta -------------------------------------------
    f_t, cos_t_t, same_side, align_refl, align_refr, eta0 = _delta_dirs(
        sp, dot_wo_sh, wi, dot_wi_sh)
    factor = torch.where(cos_t_t < 0.0, 1.0 / eta0, eta0)
    val_t = torch.where(
        same_side[..., None],
        torch.where(align_refl[..., None], sp.specular * f_t[..., None], 0.0),
        torch.where(align_refr[..., None],
                    sp.diffuse * (factor * factor * (1.0 - f_t))[..., None],
                    0.0))

    # ---- common front-face gate for non-delta classes --------------------
    front = ((dot_wi_geo * dot_wi_sh > 0.0) & (dot_wi_sh > 0.0)
             & (dot_wo_sh > 0.0))
    diffuse = sp.diffuse * (INV_PI * dot_wi_sh)[..., None]

    wh = _normalize(wi + sp.wo)
    dot_wh_sh = _dot(wh, sp.shN)
    dot_wo_h = _dot(sp.wo, wh)
    dot_wi_h = _dot(wi, wh)
    d = beckmann_d(dot_wh_sh, sp.roughness)
    g = (smith_g1(dot_wo_h, dot_wo_sh, sp.roughness)
         * smith_g1(dot_wi_h, dot_wi_sh, sp.roughness))

    # 'o' opaque rough plastic
    f_o = fresnel_dielectric_ext(dot_wo_h, torch.full_like(dot_wo_h, 1.5))[0]
    spec_o = sp.specular * (
        f_o * g * d / torch.clamp_min(4.0 * dot_wo_sh, 1e-20))[..., None]
    t1221 = (
        (1.0 - fresnel_dielectric_ext(
            dot_wo_sh, torch.full_like(dot_wo_sh, 1.5))[0])
        * (1.0 - fresnel_dielectric_ext(
            dot_wi_sh, torch.full_like(dot_wi_sh, 1.5))[0]))
    val_o = diffuse * t1221[..., None] + spec_o

    # 'c' rough conductor
    f_c = fresnel_conductor_exact(dot_wo_h, sp.eta, sp.k)
    val_c = f_c * sp.specular * (
        d * g / torch.clamp_min(4.0 * dot_wo_sh, 1e-20))[..., None]
    val_c = torch.where((d == 0.0)[..., None], 0.0, val_c)

    t = sp.type[..., None]
    val = torch.where(
        t == 0, diffuse,
        torch.where(t == 1, val_o, torch.where(t == 2, val_c, 0.0)))
    val = torch.where(front[..., None], val, 0.0)
    return torch.where(t == 3, val_t, val)


def pdf_graph_bsdf(sp, wi):
    """pdf_device (pbsdf.cu:562-628) vectorized.  Returns (...)."""
    dot_wi_sh = _dot(wi, sp.shN)
    dot_wi_geo = _dot(wi, sp.geoN)
    dot_wo_sh = _dot(sp.wo, sp.shN)

    # 't' dielectric
    f_t, _, same_side, align_refl, align_refr, _ = _delta_dirs(
        sp, dot_wo_sh, wi, dot_wi_sh)
    pdf_t = torch.where(
        same_side,
        torch.where(align_refl, f_t, 0.0),
        torch.where(align_refr, 1.0 - f_t, 0.0))

    front = ((dot_wi_geo * dot_wi_sh > 0.0) & (dot_wi_sh > 0.0)
             & (dot_wo_sh > 0.0))
    diffuse = dot_wi_sh * INV_PI

    wh = _normalize(wi + sp.wo)
    dot_wh_sh = _dot(wh, sp.shN)
    dot_wi_h = _dot(wi, wh)
    dot_wo_h = _dot(sp.wo, wh)
    prob = distr_pdf(dot_wo_sh, dot_wo_h, dot_wh_sh, sp.roughness)
    inv_wh_wi = (1.0 / torch.clamp_min(4.0 * torch.abs(dot_wi_h), 1e-20)
                 * torch.sign(dot_wi_h))

    # 'o': lobe probabilities from fresnel/diffuse-albedo split
    p_spec = fresnel_dielectric_ext(
        dot_wo_sh, torch.full_like(dot_wo_sh, 1.5))[0]
    p_diff = torch.amax(sp.diffuse, dim=-1)
    p_spec = p_spec / torch.clamp_min(p_spec + p_diff, 1e-20)
    pdf_o = prob * inv_wh_wi * p_spec + diffuse * (1.0 - p_spec)

    pdf_c = prob * inv_wh_wi

    pdf = torch.where(
        sp.type == 0, diffuse,
        torch.where(sp.type == 1, pdf_o,
                    torch.where(sp.type == 2, pdf_c, 0.0)))
    pdf = torch.where(front, pdf, 0.0)
    return torch.where(sp.type == 3, pdf_t, pdf)
