"""Per-sample radiance and filtered pixel blocks of the reference.

A work item q = pixel * spp + sample keys every random decision of its
path through the counter-based RNG, so the reference computes the very
samples the program computes, one depth at a time over a batch of work
items: camera rays, closest hits, emitted radiance, next-event
estimation with its shadow ray, BSDF sampling, Russian roulette, MIS
weights (path_mis), area-light sampling at the first diffuse
vertex with specular continuation (whitted), or the shading normal
(normals).  `blocks` reconstructs square blocks of pixels from every
sample whose filter footprint reaches them, with the film's Gaussian.

`lowp=True` is the comparison's control: the same reference with the
state a path carries between bounces (throughput and radiance) held in
bfloat16, the step below the float32 the renderer states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import scene as ref_scene
from benchmark.reference import trace
from benchmark.reference.shading import (
    E_DISCRETE, Params, dot, eval_bsdf, make_frame, normalize, pdf_bsdf,
    sample_bsdf, to_local, to_world, uniform, uniform2)

JITTER_STREAM = 0xF000
EPSILON = 1e-4
PATH_MAX_DEPTH = 48
RR_START = 3
RR_MAX = 0.95
WHITTED_MAX_DEPTH = 24
WHITTED_SURVIVAL = 0.95
#: the path tracers the reference has: both MIS (path is its alias)
PATH_MIS = ("path_mis", "path")


class Reference:
    """The plain renderer of one scene description and one traffic mix
    (integrator, spp) on `device`."""

    def __init__(self, desc, traffic: dict, device, lowp: bool = False):
        self.rs = ref_scene.compile_scene(desc, device)
        self.integrator = traffic["integrator"]
        self.spp = int(traffic["spp"])
        self.device = torch.device(device)
        self.lowp = lowp
        if self.integrator not in (*PATH_MIS, "whitted", "normals"):
            raise ValueError(f"no reference for {self.integrator!r}")

    # -- state precision (the control rounds it to bfloat16) -------------
    def _keep(self, x):
        return x.to(torch.bfloat16).to(torch.float32) if self.lowp else x

    # -- camera ------------------------------------------------------------
    def camera_rays(self, q, seed):
        rs = self.rs
        w, h = rs.width, rs.height
        pix = q // self.spp
        jitter = uniform2(seed, q, JITTER_STREAM)
        px = (pix % w).to(torch.float32)
        py = (pix // w).to(torch.float32)
        pos = torch.stack([px, py], dim=-1) + jitter
        s2c, c2w = rs.sample_to_camera, rs.camera_to_world
        inv_size = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32,
                                device=q.device)
        p = pos * inv_size
        xyz0 = torch.stack(
            [p[..., 0], p[..., 1], torch.zeros_like(p[..., 0])], dim=-1)

        def rows(m3, v):
            return (m3[:, 0] * v[..., 0:1] + m3[:, 1] * v[..., 1:2]
                    + m3[:, 2] * v[..., 2:3])

        near_p = rows(s2c[:3, :3], xyz0) + s2c[:3, 3]
        wq = (s2c[3, 0] * xyz0[..., 0] + s2c[3, 1] * xyz0[..., 1]
              + s2c[3, 2] * xyz0[..., 2] + s2c[3, 3])
        near_p = near_p / wq[..., None]
        d_cam = near_p / torch.sqrt(
            torch.sum(near_p * near_p, dim=-1, keepdim=True))
        inv_z = 1.0 / d_cam[..., 2]
        o = torch.broadcast_to(c2w[:3, 3], d_cam.shape).contiguous()
        d = rows(c2w[:3, :3], d_cam)
        d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
        near = torch.tensor(rs.near, dtype=torch.float32, device=q.device)
        far = torch.tensor(rs.far, dtype=torch.float32, device=q.device)
        return jitter, o, d, near * inv_z, far * inv_z

    # -- surface queries -----------------------------------------------------
    def _hit(self, o, d, mint, maxt, active):
        rs = self.rs
        hit = trace.intersect(rs, o, d, mint, maxt, active)
        tri = torch.clamp_min(hit.tri, 0)
        u, v = hit.u, hit.v
        b0 = 1.0 - u - v
        p = rs.v0[tri] + u[:, None] * rs.e1[tri] + v[:, None] * rs.e2[tri]
        p = torch.where(hit.valid[:, None], p, o + hit.t[:, None] * d)
        sh_n = normalize(b0[:, None] * rs.n0[tri] + u[:, None] * rs.n1[tri]
                         + v[:, None] * rs.n2[tri], eps=1e-24)
        mesh = rs.mesh[tri]
        m = rs.mat[mesh]
        params = Params(type=rs.mat_type[mesh], albedo=m[:, 0:3],
                        alpha=m[:, 3], int_ior=m[:, 4], ext_ior=m[:, 5],
                        ks=m[:, 6])
        return hit.valid, hit.t, p, sh_n, params, m[:, 7:10]

    def _occluded(self, p, wo, mint, maxt, active):
        return trace.intersect(self.rs, p, wo, mint, maxt, active,
                               any_hit=True).valid

    def _light_sample(self, u_pick, u2):
        rs = self.rs
        cdf = rs.em_cdf
        idx = torch.sum(u_pick[:, None] >= cdf[1:-1][None, :], dim=-1)
        su = torch.sqrt(torch.clamp_min(u2[..., 0], 0.0))
        b1 = 1.0 - su
        b2 = u2[..., 1] * su
        b0 = 1.0 - b1 - b2
        y = (rs.em_v0[idx] + b1[..., None] * rs.em_e1[idx]
             + b2[..., None] * rs.em_e2[idx])
        n_y = normalize(b0[..., None] * rs.em_n0[idx]
                        + b1[..., None] * rs.em_n1[idx]
                        + b2[..., None] * rs.em_n2[idx], eps=1e-24)
        pdf_area = torch.where(rs.em_area > 0.0, 1.0 / rs.em_area, 0.0)
        return y, n_y, rs.em_le[idx], pdf_area

    @staticmethod
    def _shadow_args(p, y):
        dvec = y - p
        dist = torch.sqrt(torch.clamp_min(torch.sum(dvec * dvec, dim=-1),
                                          1e-24))
        wo = dvec / dist[..., None]
        mint = torch.full(dist.shape, EPSILON, dtype=torch.float32,
                          device=dist.device)
        return wo, dist, mint, dist * (1.0 - 1e-4)

    # -- integrators -------------------------------------------------------
    def radiance(self, q: torch.Tensor, seed):
        """(jitter (N, 2), radiance (N, 3)) of work items q rendered
        with `seed` (an int, or one seed per item)."""
        jitter, o, d, mint, maxt = self.camera_rays(q, seed)
        if self.integrator == "normals":
            live = torch.ones(q.shape, dtype=torch.bool, device=q.device)
            valid, _, _, sh_n, _, _ = self._hit(o, d, mint, maxt, live)
            L = torch.where(valid[:, None], torch.abs(sh_n), 0.0)
            return jitter, self._keep(L)
        if self.integrator == "whitted":
            return jitter, self._whitted(q, seed, o, d, mint, maxt)
        return jitter, self._path_mis(q, seed, o, d, mint, maxt)

    def _whitted(self, q, seed, o, d, mint, maxt):
        n, dev = q.shape[0], q.device
        L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        for depth in range(WHITTED_MAX_DEPTH):
            if not bool(alive.any()):
                break
            valid, _, p, sh_n, params, mesh_le = self._hit(
                o, d, mint, maxt, alive)
            live_hit = alive & valid
            wi_world = -d
            front = dot(sh_n, wi_world) > 0.0
            le = torch.where((valid & front)[:, None], mesh_le, 0.0)
            L = self._keep(L + torch.where(live_hit[:, None], beta * le,
                                           0.0))
            frame = make_frame(sh_n)
            wi_local = to_local(frame, wi_world)
            u_pick = uniform(seed, q, 8 * depth + 1)
            u2 = uniform2(seed, q, 8 * depth + 2)
            y, n_y, le_y, pdf_area = self._light_sample(u_pick, u2)
            wo_w, dist, smint, smaxt = self._shadow_args(p, y)
            cos_y = dot(n_y, -wo_w)
            wo_local = to_local(frame, wo_w)
            f = eval_bsdf(params, wi_local, wo_local)
            g_over_p = torch.where(
                (cos_y > 0.0) & (pdf_area > 0.0),
                wo_local[..., 2] * cos_y
                / torch.clamp_min(dist * dist * pdf_area, 1e-20), 0.0)
            ok = (live_hit & (g_over_p > 0.0)
                  & (torch.amax(beta * f, dim=-1) > 0.0))
            vis = ~self._occluded(p, wo_w, smint, smaxt, ok)
            contrib = beta * f * le_y * (g_over_p * vis)[:, None]
            L = self._keep(L + torch.where(live_hit[:, None], contrib, 0.0))
            u_lobe = uniform(seed, q, 8 * depth + 3)
            u_dir = uniform2(seed, q, 8 * depth + 4)
            s = sample_bsdf(params, wi_local, u_lobe, u_dir)
            u_rr = uniform(seed, q, 8 * depth + 5)
            cont = (live_hit & (s.measure == E_DISCRETE)
                    & (u_rr < WHITTED_SURVIVAL))
            beta = self._keep(torch.where(
                cont[:, None], beta * s.weight / WHITTED_SURVIVAL, beta))
            alive = cont
            o = p
            d = to_world(frame, s.wo)
            mint = torch.full((n,), EPSILON, dtype=torch.float32, device=dev)
            maxt = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
        return L

    def _path_mis(self, q, seed, o, d, mint, maxt):
        n, dev = q.shape[0], q.device
        rs = self.rs
        L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        spec = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_pdf = torch.zeros((n,), dtype=torch.float32, device=dev)
        for depth in range(PATH_MAX_DEPTH):
            if not bool(alive.any()):
                break
            valid, t, p, sh_n, params, mesh_le = self._hit(
                o, d, mint, maxt, alive)
            live_hit = alive & valid
            wi_world = -d
            front = dot(sh_n, wi_world) > 0.0
            le = torch.where((valid & front)[:, None], mesh_le, 0.0)
            # balance heuristic against next-event estimation
            cos_y = dot(sh_n, wi_world)
            p_light_sa = torch.where(
                (rs.em_area > 0.0) & (cos_y > 1e-8),
                (t * t) / (rs.em_area * torch.clamp_min(cos_y, 1e-8)), 0.0)
            w_em = torch.where(
                spec, 1.0,
                prev_pdf / torch.clamp_min(prev_pdf + p_light_sa, 1e-20))
            L = self._keep(L + torch.where(live_hit[:, None],
                                           beta * le * w_em[:, None], 0.0))
            frame = make_frame(sh_n)
            wi_local = to_local(frame, wi_world)
            du = depth * 8
            u_pick = uniform(seed, q, du + 1)
            u2 = uniform2(seed, q, du + 2)
            y, n_y, le_y, pdf_area = self._light_sample(u_pick, u2)
            wo_w, dist, smint, smaxt = self._shadow_args(p, y)
            cos_l = dot(n_y, -wo_w)
            wo_local = to_local(frame, wo_w)
            f = eval_bsdf(params, wi_local, wo_local)
            p_light_sa = torch.where(
                cos_l > 1e-8,
                pdf_area * dist * dist / torch.clamp_min(cos_l, 1e-8), 0.0)
            ok = ((cos_l > 1e-8) & (p_light_sa > 0.0) & live_hit
                  & (torch.amax(beta * f, dim=-1) > 0.0))
            p_b = pdf_bsdf(params, wi_local, wo_local)
            w_l = p_light_sa / torch.clamp_min(p_light_sa + p_b, 1e-20)
            contrib = (beta * f * le_y
                       * (wo_local[..., 2] / torch.clamp_min(p_light_sa, 1e-20)
                          * w_l)[:, None])
            vis = ~self._occluded(p, wo_w, smint, smaxt, ok)
            L = self._keep(L + torch.where((ok & vis)[:, None], contrib, 0.0))
            u_rr = uniform(seed, q, du + 5)
            rr_q = torch.clamp_max(torch.amax(beta, dim=-1), RR_MAX)
            if depth < RR_START:
                rr_q = torch.ones_like(rr_q)
            alive = live_hit & (u_rr < rr_q)
            beta = beta / torch.clamp_min(rr_q, 1e-8)[:, None]
            u_lobe = uniform(seed, q, du + 3)
            u_dir = uniform2(seed, q, du + 4)
            s = sample_bsdf(params, wi_local, u_lobe, u_dir)
            beta = self._keep(beta * s.weight)
            alive = alive & (torch.amax(s.weight, dim=-1) > 0.0)
            spec = s.measure == E_DISCRETE
            prev_pdf = s.pdf
            o = p
            d = to_world(frame, s.wo)
            mint = torch.full((n,), EPSILON, dtype=torch.float32, device=dev)
            maxt = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
        return L

    # -- film --------------------------------------------------------------
    def _filter(self, x):
        f = self.rs.rfilter
        if f["type"] != "gaussian":
            raise ValueError(f"no reference filter {f['type']!r}")
        alpha = -1.0 / (2.0 * f["stddev"] * f["stddev"])
        tail = torch.exp(torch.tensor(alpha * f["radius"] * f["radius"],
                                      dtype=torch.float32, device=x.device))
        return torch.clamp_min(torch.exp(alpha * x * x) - tail, 0.0)

    def blocks(self, items, size: int,
               max_items: int = 1 << 18) -> np.ndarray:
        """(B, size, size, 3) float64 pixel values of blocks given as
        items [(render seed, x0, y0), ...] (top-left corners), each
        reconstructed from every sample whose filter footprint reaches
        it.  All blocks' samples are traced together, max_items work
        items at a time."""
        rs, spp, dev = self.rs, self.spp, self.device
        w, h = rs.width, rs.height
        r = float(rs.rfilter["radius"])
        d_lo, d_hi = math.ceil(-0.5 - r), math.floor(0.5 + r)
        deltas = torch.arange(d_lo, d_hi + 1, device=dev)
        qs, seeds, owner = [], [], []
        for bi, (seed, x0, y0) in enumerate(items):
            xs = torch.arange(max(0, x0 - d_hi), min(w, x0 + size - d_lo),
                              device=dev)
            ys = torch.arange(max(0, y0 - d_hi), min(h, y0 + size - d_lo),
                              device=dev)
            pix = (ys[:, None] * w + xs[None, :]).reshape(-1)
            q = (pix[:, None] * spp
                 + torch.arange(spp, device=dev)[None, :]).reshape(-1)
            qs.append(q)
            seeds.append(torch.full_like(q, int(seed) & 0xFFFFFFFF))
            owner.append(torch.full_like(q, bi))
        q_all, seed_all, owner = (torch.cat(x) for x in (qs, seeds, owner))
        corner = torch.tensor([(x0, y0) for _, x0, y0 in items],
                              dtype=torch.int64, device=dev)
        acc = torch.zeros((len(items) * size * size, 4),
                          dtype=torch.float64, device=dev)
        for c0 in range(0, q_all.numel(), max_items):
            sl = slice(c0, c0 + max_items)
            q, b = q_all[sl], owner[sl]
            jitter, L = self.radiance(q, seed_all[sl])
            sx = (q // spp) % w
            sy = (q // spp) // w
            ax = deltas[None, :] - jitter[:, 0:1] + 0.5
            ay = deltas[None, :] - jitter[:, 1:2] + 0.5
            wx = torch.where(torch.abs(ax) <= r, self._filter(ax), 0.0)
            wy = torch.where(torch.abs(ay) <= r, self._filter(ay), 0.0)
            tx = sx[:, None] + deltas[None, :] - corner[b, 0:1]
            ty = sy[:, None] + deltas[None, :] - corner[b, 1:2]
            wgt = (wy[:, :, None] * wx[:, None, :]).to(torch.float64)
            inside = (((ty >= 0) & (ty < size))[:, :, None]
                      & ((tx >= 0) & (tx < size))[:, None, :])
            idx = (b[:, None, None] * size * size
                   + ty[:, :, None] * size + tx[:, None, :])
            rgba = torch.cat([L, torch.ones_like(L[:, :1])],
                             dim=1).to(torch.float64)
            contrib = wgt[..., None] * rgba[:, None, None, :]
            sel = inside.reshape(-1)
            acc.index_add_(0, idx.reshape(-1)[sel],
                           contrib.reshape(-1, 4)[sel])
        wsum = acc[:, 3:4]
        img = torch.where(wsum > 0, acc[:, :3] / torch.clamp_min(
            wsum, 1e-300), 0.0)
        return img.reshape(len(items), size, size, 3).cpu().numpy()
