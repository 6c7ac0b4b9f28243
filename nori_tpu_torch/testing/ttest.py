"""Student's t-test plugin: `<test type="ttest">`.

Port of `nori_tpu/testing/ttest.py` (behaviour of src/ttest.cpp:
58-219).  Two modes:

  1. BSDF mode: child BSDFs + `angles`/`references` strings; the mean
     luminance of sample() weights at each incidence angle must match
     the reference value (scenes/pa5/tests/ttest-microfacet.xml).
  2. Scene mode: child scenes + `references`; the mean luminance of Li
     over `sampleCount` camera rays must match the analytic value
     (the pa4/pa5 test-mesh, test-direct and test-furnace fixtures).

Samples are drawn on the device with the JAX package's RNG streams, the
scene mode compiling each scene on the device and calling the
integrator's li directly; mean and variance reduce in float64 on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject
from nori_tpu_torch.registry import register_class, NoriError
from nori_tpu_torch.bsdf import sample_bsdf
from nori_tpu_torch.core import rng as nrng
from nori_tpu_torch.core.color import luminance
from nori_tpu_torch.core.vecmath import spherical_direction
from nori_tpu_torch.testing.chi2 import bsdf_params_for
from nori_tpu_torch.testing.hypothesis import students_t_test


def _tokenize_floats(s):
    return [float(x) for x in s.replace(",", " ").split()]


def _mean_var(lum: torch.Tensor):
    x = lum.cpu().numpy().astype(np.float64)
    return x.mean(), x.var(ddof=1)


def bsdf_mean(bsdf, angle: float, n: int, seed: int, device):
    """(mean, variance) of the luminance of n sample() weights of `bsdf`
    at incidence `angle` (degrees, in the x-z plane), the uniforms keyed
    by `seed` (streams 0 and 1 of core.rng)."""
    theta = torch.tensor(np.float32(np.deg2rad(angle)), device=device)
    wi = spherical_direction(theta, torch.zeros_like(theta))
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    u_lobe = nrng.uniform(seed, lanes, 0)
    u2 = nrng.uniform2(seed, lanes, 1)
    s = sample_bsdf(bsdf_params_for(bsdf, n, device), wi.expand(n, 3),
                    u_lobe, u2)
    return _mean_var(luminance(s.weight))


def scene_mean(scene, n: int, batches: int, seed: int, device):
    """(mean, variance) of the luminance of Li over n camera rays through
    uniform image positions (stream 7 of core.rng, keyed by `seed`), in
    `batches` batches of n // batches rays."""
    sd = scene.compile(device)
    scene.integrator.preprocess(scene)
    cam = scene.camera
    li = scene.integrator.make_li(scene, device)
    cam_params = cam.ray_params(device)
    size = torch.tensor([cam.width, cam.height], dtype=torch.float32,
                        device=device)
    per = n // batches
    lums = []
    for b in range(batches):
        lanes = torch.arange(b * per, (b + 1) * per, dtype=torch.int64,
                             device=device)
        pos = nrng.uniform2(seed, lanes, 7) * size
        o, d, mint, maxt = type(cam).sample_rays(cam_params, pos)
        L, _ = li(sd, o, d, mint, maxt, seed, lanes)
        lums.append(luminance(L))
    return _mean_var(torch.cat(lums))


@register_class("ttest")
class StudentsTTest(NoriObject):
    class_kind = registry.TEST

    def __init__(self, props):
        self.significance = props.get_float("significanceLevel", 0.01)
        self.angles = _tokenize_floats(props.get_string("angles", ""))
        self.references = _tokenize_floats(props.get_string("references", ""))
        self.sample_count = props.get_integer("sampleCount", 100000)
        # only the defaulted sample count is eligible for the scene-mode
        # batch enlargement below; an explicit sampleCount is honoured
        self.sample_count_explicit = props.has("sampleCount")
        self.bsdfs = []
        self.scenes = []

    def add_child(self, child):
        if child.class_kind == registry.BSDF:
            self.bsdfs.append(child)
        elif child.class_kind == registry.SCENE:
            self.scenes.append(child)
        else:
            raise NoriError(
                f"StudentsTTest::add_child(<{child.class_kind}>) not supported"
            )

    # -- mode 1: BSDF sampling means ---------------------------------------
    def _run_bsdf(self, verbose, device) -> tuple[int, int]:
        if len(self.references) != len(self.angles) * len(self.bsdfs):
            raise NoriError("Mismatched angles/references")
        passed = total = 0
        n = self.sample_count
        for bsdf in self.bsdfs:
            for angle in self.angles:
                reference = self.references[total]
                total += 1
                mean, var = bsdf_mean(bsdf, angle, n, 1234 + total, device)
                ok, msg = students_t_test(mean, var, reference, n,
                                          self.significance,
                                          len(self.references))
                if verbose:
                    print(f"[ttest] angle={angle}: {msg}")
                passed += int(ok)
        return passed, total

    # -- mode 2: scene radiance means --------------------------------------
    def _run_scene(self, verbose, device) -> tuple[int, int]:
        if len(self.references) != len(self.scenes):
            raise NoriError("Mismatched scenes/references")
        passed = total = 0
        for idx, (scene, reference) in enumerate(
                zip(self.scenes, self.references)):
            total += 1
            # scene-mode luminance is heavy-tailed (furnace paths carry
            # luminance in the thousands): a defaulted sample count is
            # quadrupled, in four batches
            n, batches = self.sample_count, 1
            if not self.sample_count_explicit:
                n, batches = 4 * n, 4
            mean, var = scene_mean(scene, n, batches, 4321 + idx, device)
            ok, msg = students_t_test(mean, var, reference, n,
                                      self.significance,
                                      len(self.references))
            if verbose:
                print(f"[ttest] scene {idx} "
                      f"({scene.integrator.plugin_name}): {msg}")
            passed += int(ok)
        return passed, total

    def run(self, verbose: bool = True, device=None) -> bool:
        """Run every test on `device` (default: the first CUDA device,
        device.resolve_device); True when all pass."""
        from nori_tpu_torch.device import resolve_device

        if self.bsdfs and self.scenes:
            raise NoriError("Cannot test BSDFs and scenes at the same time")
        device = resolve_device(device)
        if self.bsdfs:
            passed, total = self._run_bsdf(verbose, device)
        else:
            passed, total = self._run_scene(verbose, device)
        if verbose:
            print(f"Passed {passed}/{total} t-tests.")
        return passed == total

    def to_string(self):
        return (
            f"StudentsTTest[significance={self.significance}, "
            f"samples={self.sample_count}]"
        )
