"""chi^2 test plugin: `<test type="chi2test">`.

Port of `nori_tpu/testing/chi2.py` (behaviour of src/chi2test.cpp:
42-226): for each child BSDF, run `testCount` independent tests; each
draws a random incident direction, histograms `sampleCount` BSDF
samples into a (cosThetaResolution x 2*cosThetaResolution) table over
(cos theta, phi), integrates the claimed pdf over each cell for the
expected counts, and applies a Dunn-Sidak-corrected Pearson chi^2
test.  The samples and the pdf on each quadrature grid are computed on
the device in one call each; the binning and the test run on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.registry import register_class, NoriError
from nori_tpu_torch.bsdf import BSDFTable, pdf_bsdf, sample_bsdf
from nori_tpu_torch.testing.hypothesis import (
    chi2_dump, chi2_test, integrate_cells_2d)


def bsdf_params_for(bsdf, n: int, device):
    """A single host BSDF's parameter row, broadcast to n lanes."""
    table = BSDFTable.build([bsdf], device)
    return table.gather(torch.zeros((n,), dtype=torch.int64, device=device))


def pdf_grid_fn(bsdf, wi, device):
    """pdf(wo) of `bsdf` for the incident direction `wi`, as a function
    of numpy (cos theta, phi) grids (float64, any shape) for
    hypothesis.integrate_cells_2d: one device call per grid."""
    wi_t = torch.as_tensor(np.asarray(wi, np.float32), device=device)

    def pdf_fn(ct, ph):
        shape = ct.shape
        st = np.sqrt(np.maximum(0.0, 1.0 - ct * ct))
        wo = np.stack([st * np.cos(ph), st * np.sin(ph), ct],
                      axis=-1).reshape(-1, 3).astype(np.float32)
        m = wo.shape[0]
        vals = pdf_bsdf(bsdf_params_for(bsdf, m, device),
                        wi_t.expand(m, 3), torch.from_numpy(wo).to(device))
        return vals.cpu().numpy().astype(np.float64).reshape(shape)

    return pdf_fn


def run_chi2_bsdf(bsdf, wi, sample_count, cos_res, phi_res,
                  min_exp_frequency, significance, num_tests, seed=0,
                  dump_file=None, device="cpu"):
    """One chi^2 run for one BSDF and one incident direction; returns
    (passed, message).  The uniforms are the JAX package's (numpy
    RandomState(seed)); `wo` is binned on the host.

    dump_file: write the observed/expected tables as a MATLAB debug
    script (chi2test_%i.m, src/chi2test.cpp:179-180)."""
    n = sample_count
    rng = np.random.RandomState(seed)
    u_lobe = torch.from_numpy(rng.rand(n).astype(np.float32)).to(device)
    u2 = torch.from_numpy(rng.rand(n, 2).astype(np.float32)).to(device)
    wi_t = torch.as_tensor(np.asarray(wi, np.float32), device=device)
    s = sample_bsdf(bsdf_params_for(bsdf, n, device), wi_t.expand(n, 3),
                    u_lobe, u2)
    wo = s.wo.cpu().numpy()
    valid = (s.weight != 0).any(dim=-1).cpu().numpy()
    obs = chi2_observed(wo, valid, cos_res, phi_res)

    cos_edges = np.linspace(-1.0, 1.0, cos_res + 1)
    phi_edges = np.linspace(0.0, 2 * np.pi, phi_res + 1)
    exp = integrate_cells_2d(pdf_grid_fn(bsdf, wi, device), cos_edges,
                             phi_edges) * sample_count
    if dump_file:
        chi2_dump(obs, exp, dump_file)
    return chi2_test(obs.ravel(), exp.ravel(), sample_count,
                     min_exp_frequency, significance, num_tests)


def chi2_observed(wo, valid, cos_res: int, phi_res: int) -> np.ndarray:
    """Histogram of the valid sampled directions over (cos theta, phi)
    cells: (cos_res, phi_res) float64 counts."""
    cos_bin = np.clip(
        np.floor((wo[:, 2] * 0.5 + 0.5) * cos_res).astype(np.int64),
        0, cos_res - 1)
    phi = np.arctan2(wo[:, 1], wo[:, 0]) / (2 * np.pi)
    phi = np.where(phi < 0, phi + 1.0, phi)
    phi_bin = np.clip(np.floor(phi * phi_res).astype(np.int64),
                      0, phi_res - 1)
    flat = cos_bin * phi_res + phi_bin
    return np.bincount(flat[valid], minlength=cos_res * phi_res).astype(
        np.float64).reshape(cos_res, phi_res)


@register_class("chi2test")
class ChiSquareTest(NoriObject):
    class_kind = registry.TEST

    def __init__(self, props):
        self.significance = props.get_float("significanceLevel", 0.01)
        self.cos_res = props.get_integer("resolution", 10)
        self.min_exp_frequency = props.get_integer("minExpFrequency", 5)
        self.sample_count = props.get_integer("sampleCount", -1)
        self.test_count = props.get_integer("testCount", 5)
        # the reference writes chi2test_%i.m on every run
        # (src/chi2test.cpp:179-180); dump_dir redirects the files
        self.dump_files = props.get_boolean("dumpFiles", True)
        self.dump_dir = "."
        self.phi_res = 2 * self.cos_res
        if self.sample_count < 0:
            self.sample_count = self.cos_res * self.phi_res * 5000
        self.bsdfs = []

    def add_child(self, child):
        if child.class_kind == registry.BSDF:
            self.bsdfs.append(child)
        else:
            raise NoriError(
                f"ChiSquareTest::add_child(<{child.class_kind}>) not supported"
            )

    def run(self, verbose: bool = True, device=None) -> bool:
        """Run every test on `device` (default: the first CUDA device,
        device.resolve_device); True when all pass."""
        from nori_tpu_torch.device import resolve_device

        device = resolve_device(device)
        passed = total = 0
        rng = np.random.RandomState(0)
        num_tests = self.test_count * len(self.bsdfs)
        for bsdf in self.bsdfs:
            for _ in range(self.test_count):
                total += 1
                cos_theta = rng.rand()
                sin_theta = np.sqrt(max(0.0, 1 - cos_theta ** 2))
                phi = 2 * np.pi * rng.rand()
                wi = np.array([np.cos(phi) * sin_theta,
                               np.sin(phi) * sin_theta, cos_theta])
                dump = (os.path.join(self.dump_dir, f"chi2test_{total}.m")
                        if self.dump_files else None)
                ok, msg = run_chi2_bsdf(
                    bsdf, wi, self.sample_count, self.cos_res, self.phi_res,
                    self.min_exp_frequency, self.significance, num_tests,
                    seed=total, dump_file=dump, device=device)
                if verbose:
                    print(f"[chi2] {bsdf!r} wi_z={cos_theta:.3f}: {msg}")
                passed += int(ok)
        if verbose:
            print(f"Passed {passed}/{total} chi^2 tests.")
        return passed == total

    def to_string(self):
        return (
            f"ChiSquareTest[res={self.cos_res}x{self.phi_res}, "
            f"samples={self.sample_count}, tests={self.test_count}]"
        )
