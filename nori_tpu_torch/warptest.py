"""warptest: chi^2 verification of sampling warps (CLI).

Port of `nori_tpu/warptest.py`, the CLI half of the reference's
warptest application (src/warptest.cpp:968-1007; test core :121-227):
histogram `1000 * res` samples pushed through a warp (or the
microfacet BRDF) and chi^2-compare against the claimed pdf integrated
over the bins; exit code 0/1 for scripting.  The samples and the pdf
grids are computed on the device, the histograms and the test on the
host.  In place of the nanogui point-cloud view: an interactive
terminal arcball (--view, nori_tpu_torch.tui) and a matplotlib scatter
dump (--plot out.png), with the GUI's point-sampling modes
(src/warptest.cpp:73-77, 283-293): independent | grid ((x+.5)/sqrt(n))
| stratified ((x+xi)/sqrt(n)), and the warped-gridline overlay
(--grid-lines).

Usage:  python -m nori_tpu_torch.warptest <warp> [param] [param2]
            [--plot f.png] [--mode independent|grid|stratified]
            [--grid-lines] [--view] [--device cpu]
  warps: square | tent | disk | sphere | hemisphere | cosine |
         beckmann <alpha> | microfacet <alpha> [cos_theta_i]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nori_tpu_torch import warp as W
from nori_tpu_torch.core import rng
from nori_tpu_torch.testing.hypothesis import chi2_test, integrate_cells_2d

RES = 51  # xres (warptest uses 51); yres = 51 for 2D, 2*res for sphere
SAMPLE_FACTOR = 1000


def _samples(n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    return rng.uniform2(seed, lanes, 0)


def _mode_samples(n: int, mode: str, seed: int = 0,
                  device="cpu") -> torch.Tensor:
    """Unit-square inputs per the GUI sampling modes
    (src/warptest.cpp:283-293)."""
    if mode == "independent":
        return _samples(n, seed, device)
    side = int(np.sqrt(n))
    x, y = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    if mode == "grid":
        jit = np.full((side * side, 2), 0.5)
    else:  # stratified
        jit = rng.uniform2(seed, torch.arange(side * side, dtype=torch.int64),
                           1).numpy()
    u = np.stack([(x.ravel() + jit[:, 0]) / side,
                  (y.ravel() + jit[:, 1]) / side], -1)
    return torch.as_tensor(u, dtype=torch.float32, device=device)


def warp_points(name: str, u: torch.Tensor, param: float = 0.0) -> np.ndarray:
    """Apply a warp (not the BRDF) to explicit unit-square samples."""
    fn, _, _, takes_alpha = W.WARPS[name]
    if takes_alpha:
        return fn(u, param if param > 0 else 0.1).cpu().numpy()
    return fn(u).cpu().numpy()


def grid_lines(name: str, param: float = 0.0, res: int = 8,
               samples_per_edge: int = 64):
    """Polylines of a regular res x res lattice pushed through the
    warp (the GUI's warped-grid visualization)."""
    lines = []
    t = np.linspace(0.0, 1.0, samples_per_edge)
    for i in range(res + 1):
        c = i / res
        for axis in (0, 1):
            if axis == 0:
                u = np.stack([np.full_like(t, c), t], -1)
            else:
                u = np.stack([t, np.full_like(t, c)], -1)
            lines.append(warp_points(
                name, torch.as_tensor(u, dtype=torch.float32), param))
    return lines


def _microfacet(param: float, param2: float, n: int, u, seed: int, device):
    """The microfacet BRDF's sampled directions (valid samples only) and
    its pdf as a function of numpy directions."""
    from nori_tpu_torch.bsdf import Microfacet, pdf_bsdf, sample_bsdf
    from nori_tpu_torch.props import PropertyList
    from nori_tpu_torch.testing.chi2 import bsdf_params_for

    pl = PropertyList()
    pl.set_float("alpha", param if param > 0 else 0.1)
    pl.set_color("kd", np.zeros(3))
    b = Microfacet(pl)
    cos_i = param2 if param2 != 0.0 else 0.7
    sin_i = np.sqrt(max(0.0, 1 - cos_i * cos_i))
    wi = torch.tensor([sin_i, 0.0, cos_i], dtype=torch.float32, device=device)
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    u_lobe = rng.uniform(seed, lanes, 9)
    s = sample_bsdf(bsdf_params_for(b, n, device), wi.expand(n, 3), u_lobe, u)
    pts = s.wo[s.weight.sum(-1) != 0].cpu().numpy()

    def pdf_fn(v):
        m = v.shape[0]
        return pdf_bsdf(bsdf_params_for(b, m, device), wi.expand(m, 3),
                        torch.as_tensor(v, dtype=torch.float32,
                                        device=device)).cpu().numpy()

    return pts, pdf_fn


def run_warp_test(name: str, param: float = 0.0, param2: float = 0.0,
                  seed: int = 0, verbose: bool = True, device=None):
    """chi^2 of one warp on `device` (default: the first CUDA device,
    device.resolve_device); returns (passed, message, points)."""
    from nori_tpu_torch.device import resolve_device

    device = resolve_device(device)
    n = SAMPLE_FACTOR * RES * RES
    u = _samples(n, seed, device)

    if name == "microfacet":
        pts, pdf3 = _microfacet(param, param2, n, u, seed, device)
        dim3 = True
    elif name in W.WARPS:
        fn, pdf, dim, takes_alpha = W.WARPS[name]
        extra = (param if param > 0 else 0.1,) if takes_alpha else ()
        pts = fn(u, *extra).cpu().numpy()

        def pdf3(v):
            return pdf(torch.as_tensor(v, dtype=torch.float32, device=device),
                       *extra).cpu().numpy()

        dim3 = dim == 3
    else:
        raise SystemExit(f"unknown warp '{name}' "
                         f"(known: {sorted(W.WARPS)} + microfacet)")

    if dim3:
        cos_edges = np.linspace(-1, 1, RES + 1)
        phi_edges = np.linspace(0, 2 * np.pi, 2 * RES + 1)
        phi = np.arctan2(pts[:, 1], pts[:, 0])
        phi = np.where(phi < 0, phi + 2 * np.pi, phi)
        obs, _, _ = np.histogram2d(pts[:, 2], phi, bins=[cos_edges, phi_edges])

        def grid_pdf(CT, PH):
            ST = np.sqrt(np.maximum(0.0, 1 - CT ** 2))
            v = np.stack([ST * np.cos(PH), ST * np.sin(PH), CT], -1)
            return pdf3(v.reshape(-1, 3)).reshape(v.shape[:-1])

        exp = integrate_cells_2d(
            grid_pdf, cos_edges, phi_edges, order=17) * n
    else:
        lo, hi = (0.0, 1.0) if name == "square" else (-1.0, 1.0)
        edges = np.linspace(lo, hi, RES + 1)
        obs, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=[edges, edges])

        def grid_pdf(X, Y):
            v = np.stack([X, Y], -1)
            return pdf3(v.reshape(-1, 2)).reshape(v.shape[:-1])

        exp = integrate_cells_2d(grid_pdf, edges, edges, order=17) * n

    passed, msg = chi2_test(obs.ravel(), exp.ravel(), n,
                            min_exp_frequency=5, significance=0.01)
    if verbose:
        print(f"warptest {name}: {msg}")
    return passed, msg, pts


def _plot(path: str, pts, args, lines):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    sub = pts[:: max(1, len(pts) // 20000)]
    is3d = pts.shape[1] == 3
    ax = fig.add_subplot(111, projection="3d" if is3d else None)
    if is3d:
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.5, alpha=0.4)
    else:
        ax.scatter(sub[:, 0], sub[:, 1], s=0.5, alpha=0.4)
        ax.set_aspect("equal")
    for line in lines or ():
        ax.plot(*(line[:, k] for k in range(line.shape[1])),
                lw=0.6, color="crimson", alpha=0.8)
    ax.set_title(f"{args.warp} [{args.mode}] ({len(pts)} samples)")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="warptest")
    ap.add_argument("warp")
    ap.add_argument("param", nargs="?", type=float, default=0.0)
    ap.add_argument("param2", nargs="?", type=float, default=0.0)
    ap.add_argument("--plot", default=None,
                    help="write a point-cloud scatter PNG")
    ap.add_argument("--mode", default="independent",
                    choices=["independent", "grid", "stratified"],
                    help="point sampling mode for --plot and --view")
    ap.add_argument("--grid-lines", action="store_true",
                    help="overlay the warped image of a regular grid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--view", action="store_true",
                    help="interactive terminal point-cloud viewer "
                         "(rotate/zoom keys; the arcball GUI, "
                         "src/warptest.cpp:73-119)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a CUDA "
                         "device the test raises unless this is cpu)")
    args = ap.parse_args(argv)

    passed, _, pts = run_warp_test(args.warp, args.param, args.param2,
                                   args.seed, device=args.device)
    if args.view or args.plot:
        is_warp = args.warp in W.WARPS
        if args.mode != "independent" and is_warp:
            pts = warp_points(args.warp, _mode_samples(64 * 64, args.mode,
                                                       args.seed), args.param)
        lines = (grid_lines(args.warp, args.param)
                 if args.grid_lines and is_warp else None)
        if args.view:
            from nori_tpu_torch.tui import arcball

            arcball(pts, lines=lines,
                    title=f"{args.warp} [{args.mode}] ({len(pts)} samples)")
        if args.plot:
            _plot(args.plot, pts, args, lines)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
