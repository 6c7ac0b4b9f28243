"""The port's statistical harness against nori_tpu's.

`testing.hypothesis` gives the reference's answers; `run_chi2_bsdf`
gives its expected tables (rtol 1e-5), its verdicts, and observed counts
that differ by few samples (at most 1e-3 of the sample count: torch and
XLA round the sampled directions differently in the last bit); the
t-test plugin gives its means (rtol 1e-5) in BSDF mode and in scene
mode (chip_smoke.py's furnace, both packages on the "scan" backend);
the colour and vector helpers the harness calls agree within 1 ULP (2
where two libm roundings compound), the BSDF table bit for bit; warptest's sample
modes and grid lines match and --plot writes a PNG; the CLI runs a test
root to exit code 0 or 1.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nori_tpu
import nori_tpu_torch
from nori_tpu import config as jax_config
from nori_tpu.core import color as jax_color
from nori_tpu.core import vecmath as jax_vm
from nori_tpu.props import PropertyList as JaxProps
from nori_tpu.registry import create_instance as jax_create
from nori_tpu.testing import chi2 as jax_chi2
from nori_tpu.testing import hypothesis as jax_hyp
from nori_tpu.testing import ttest as jax_ttest

from nori_tpu_torch import config
from nori_tpu_torch import bsdf as torch_bsdf
from nori_tpu_torch.core import color, vecmath
from nori_tpu_torch.props import PropertyList
from nori_tpu_torch.registry import create_instance
from nori_tpu_torch.testing import chi2, hypothesis, ttest

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: microfacet of scenes/pa5/tests/ttest-microfacet.xml and its reference
#: means at five angles (tests/test_bsdf.py)
MICROFACET = dict(alpha=0.1, intIOR=1.5, extIOR=1.000277,
                  kd=(0.1, 0.2, 0.15))
ANGLES = [0, 45, 60, 80, 85]
REFERENCES = [0.207067, 0.215733, 0.247884, 0.430936, 0.519016]


def _bsdf_pair(kind, **params):
    """The same BSDF built by both packages."""
    out = []
    for props, create in ((JaxProps, jax_create), (PropertyList,
                                                   create_instance)):
        pl = props()
        for k, v in params.items():
            if isinstance(v, tuple):
                pl.set_color(k, np.asarray(v, np.float64))
            else:
                pl.set_float(k, v)
        out.append(create(kind, pl))
    return out


def _capture(monkeypatch, module, name):
    """Wrap module.name to record each call's arguments and result."""
    calls = []
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


# -- hypothesis -------------------------------------------------------------

def _gauss_pdf(x, y):
    return np.exp(-((x - 0.3) ** 2 + (y + 0.2) ** 2) / 0.05) / (0.05 * np.pi)


HYPOTHESIS_CASES = {
    "sidak": lambda m: [m.sidak(s, n) for s in (0.01, 0.05)
                        for n in (1, 5, 40)],
    "chi2_test": lambda m: [
        m.chi2_test(np.random.RandomState(s).poisson(50.0, 120),
                    np.full(120, 50.0), 6000, 5, 0.01, n)
        for s in range(3) for n in (1, 10)]
    + [m.chi2_test(np.arange(30.0), np.linspace(0.1, 20.0, 30), 300)],
    "students_t_test": lambda m: [
        m.students_t_test(mean, var, 1.0, 1000, 0.01, 5)
        for mean in (0.9, 1.0, 1.05) for var in (0.0, 0.2)],
    "integrate_cells_2d": lambda m: [m.integrate_cells_2d(
        _gauss_pdf, np.linspace(-1, 1, 7), np.linspace(-1, 1, 9), order=17)],
}


@pytest.mark.parametrize("name", sorted(HYPOTHESIS_CASES))
def test_hypothesis_matches_jax(name):
    ref = HYPOTHESIS_CASES[name](jax_hyp)
    got = HYPOTHESIS_CASES[name](hypothesis)
    for a, b in zip(ref, got):
        if isinstance(a, np.ndarray):
            assert a.tobytes() == b.tobytes()
        else:
            assert a == b


def test_chi2_dump_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    obs, exp = rng.rand(4, 8) * 100, rng.rand(4, 8) * 100
    jax_hyp.chi2_dump(obs, exp, str(tmp_path / "jax.m"))
    hypothesis.chi2_dump(obs, exp, str(tmp_path / "torch.m"))
    assert (tmp_path / "jax.m").read_bytes() == \
        (tmp_path / "torch.m").read_bytes()


# -- chi^2 ------------------------------------------------------------------

@pytest.mark.parametrize("kind, params", [
    ("diffuse", {"albedo": (0.5, 0.5, 0.5)}),
    ("microfacet", dict(MICROFACET)),
    ("microfacet", dict(MICROFACET, alpha=0.5)),
], ids=["diffuse", "microfacet-0.1", "microfacet-0.5"])
def test_run_chi2_bsdf_matches_jax(monkeypatch, kind, params):
    n, res = 20000, 6
    ref_calls = _capture(monkeypatch, jax_chi2, "chi2_test")
    got_calls = _capture(monkeypatch, chi2, "chi2_test")
    jb, tb = _bsdf_pair(kind, **params)
    for seed, cos_t in ((1, 0.8), (2, 0.3)):
        wi = np.array([np.sqrt(1 - cos_t ** 2), 0.0, cos_t])
        jax_chi2.run_chi2_bsdf(jb, wi, n, res, 2 * res, 5, 0.01, 2, seed=seed)
        chi2.run_chi2_bsdf(tb, wi, n, res, 2 * res, 5, 0.01, 2, seed=seed)
    assert len(ref_calls) == len(got_calls) == 2
    for (ra, rv), (ga, gv) in zip(ref_calls, got_calls):
        obs_r, exp_r, obs_g, exp_g = ra[0], ra[1], ga[0], ga[1]
        np.testing.assert_allclose(exp_g, exp_r, rtol=1e-5)
        assert obs_g.sum() == pytest.approx(obs_r.sum(), abs=1e-3 * n)
        assert np.abs(obs_g - obs_r).sum() <= 1e-3 * n
        assert gv[0] == rv[0] and gv[0]


# -- t-test -----------------------------------------------------------------

def test_ttest_bsdf_mode_matches_jax(monkeypatch):
    ref_calls = _capture(monkeypatch, jax_ttest, "students_t_test")
    got_calls = _capture(monkeypatch, ttest, "students_t_test")
    jb, tb = _bsdf_pair("microfacet", **MICROFACET)
    n = 40000
    for mod, b, kw in ((jax_ttest, jb, {}), (ttest, tb, {"device": "cpu"})):
        pl = (JaxProps if mod is jax_ttest else PropertyList)()
        pl.set_string("angles", ", ".join(map(str, ANGLES)))
        pl.set_string("references", ", ".join(map(str, REFERENCES)))
        pl.set_integer("sampleCount", n)
        t = mod.StudentsTTest(pl)
        t.add_child(b)
        assert t.run(verbose=False, **kw)
    assert len(ref_calls) == len(got_calls) == len(ANGLES)
    for (ra, rv), (ga, gv) in zip(ref_calls, got_calls):
        assert ga[0] == pytest.approx(ra[0], rel=1e-5)  # mean
        assert ga[1] == pytest.approx(ra[1], rel=1e-4)  # variance
        assert gv[0] == rv[0]


def _chip_smoke():
    """chip_smoke.py's furnace writers (the repo root is importable)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def _furnace_xml(tmp_path, integrators, references) -> str:
    """A scene-mode t-test of 4,000 rays per furnace scene, written with
    its OBJ to tmp_path; returns the XML's path."""
    cs = _chip_smoke()
    cs.write_furnace(str(tmp_path))
    xml = tmp_path / "furnace.xml"
    xml.write_text(cs.furnace_xml(integrators, references, samples=4000))
    return str(xml)


def test_ttest_scene_mode_matches_jax(tmp_path, monkeypatch):
    """Furnace: Li = 1 / (1 - 0.5) = 2 for path_mis, 1 + 0.5 for whitted.
    Both packages on the scan backend, where they run the same
    function."""
    monkeypatch.setattr(jax_config, "accel_mode", "scan")
    monkeypatch.setattr(config, "accel_mode", "scan")
    ref_calls = _capture(monkeypatch, jax_ttest, "students_t_test")
    got_calls = _capture(monkeypatch, ttest, "students_t_test")
    xml = _furnace_xml(tmp_path, ["whitted", "path_mis"], [1.5, 2.0])
    assert nori_tpu.load_from_xml(xml).run(verbose=False)
    assert nori_tpu_torch.load_from_xml(xml).run(verbose=False, device="cpu")
    assert len(ref_calls) == len(got_calls) == 2
    for (ra, rv), (ga, gv) in zip(ref_calls, got_calls):
        assert ga[0] == pytest.approx(ra[0], rel=1e-5)
        assert ga[3] == ra[3] == 4000
        assert gv[0] == rv[0]


@pytest.mark.parametrize("reference, code", [(2.0, 0), (2.2, 1)])
def test_cli_runs_test_root(tmp_path, capsys, reference, code):
    """A test root through the CLI: exit 0 when every test passes, 1
    when one fails (a furnace held to a wrong mean)."""
    from nori_tpu_torch.main import main

    xml = _furnace_xml(tmp_path, ["path_mats"], [reference])
    assert main([xml, "--device", "cpu"]) == code
    out = capsys.readouterr().out
    assert f"Passed {1 - code}/1 t-tests." in out


def test_cli_runs_chi2_root(tmp_path, capsys, monkeypatch):
    from nori_tpu_torch.main import main

    monkeypatch.chdir(tmp_path)
    xml = tmp_path / "chi2.xml"
    xml.write_text("""<test type="chi2test">
  <integer name="resolution" value="5"/>
  <integer name="sampleCount" value="20000"/>
  <integer name="testCount" value="2"/>
  <boolean name="dumpFiles" value="false"/>
  <bsdf type="diffuse"/>
  <bsdf type="microfacet"><float name="alpha" value="0.5"/></bsdf>
</test>
""")
    assert main([str(xml), "--device", "cpu"]) == 0
    assert "Passed 4/4 chi^2 tests." in capsys.readouterr().out
    assert not list(tmp_path.glob("chi2test_*.m"))


# -- colour, vector and BSDF-table helpers ----------------------------------

def _colours(n=512, seed=1):
    c = np.random.default_rng(seed).random((n, 3)).astype(np.float32) * 1.2
    c[::7, 1] = -0.1
    c[::11, 2] = np.inf
    return c


#: name -> (call on (colour module, vecmath module, colours), ULPs
#: allowed).  Arithmetic agrees within 1 ULP; a product of two libm
#: results (sin * cos) within 2, since torch's and XLA's libm each round
#: within 1.  spherical_direction takes its angles from the two finite
#: columns.
HELPERS = {
    "luminance": (lambda cm, vm, c: cm.luminance(c), 1),
    "is_valid": (lambda cm, vm, c: cm.is_valid(c), 0),
    "spherical_direction": (
        lambda cm, vm, c: vm.spherical_direction(
            abs(c[:, 0]) * 3.0, abs(c[:, 1]) * 6.0), 2),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helpers_match_jax_within_ulps(name):
    fn, ulps = HELPERS[name]
    c = _colours()
    ref = np.asarray(fn(jax_color, jax_vm, jnp.asarray(c)))
    got = fn(color, vecmath, torch.from_numpy(c)).numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    if ulps == 0:
        assert np.array_equal(ref, got)
    else:
        np.testing.assert_array_max_ulp(got, ref, maxulp=ulps)


def test_bsdf_table_matches_jax():
    from nori_tpu.bsdf import BSDFTable as JaxTable

    kinds = [("diffuse", {"albedo": (0.2, 0.4, 0.6)}), ("mirror", {}),
             ("dielectric", {"intIOR": 1.33}), ("microfacet", MICROFACET)]
    pairs = [_bsdf_pair(k, **p) for k, p in kinds]
    ref = JaxTable.build([j for j, _ in pairs])
    got = torch_bsdf.BSDFTable.build([t for _, t in pairs], "cpu")
    ids = np.array([3, 0, 0, 2, 1, 3], np.int32)
    pr, pg = ref.gather(jnp.asarray(ids)), got.gather(torch.from_numpy(ids))
    for f in torch_bsdf.BSDFParams._fields:
        a, b = np.asarray(getattr(pr, f)), getattr(pg, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


# -- warptest ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["independent", "grid", "stratified"])
def test_warptest_mode_samples_match_jax(mode):
    from nori_tpu import warptest as jax_wt
    from nori_tpu_torch import warptest as wt

    ref = np.asarray(jax_wt._mode_samples(32 * 32, mode, seed=1))
    got = wt._mode_samples(32 * 32, mode, seed=1).numpy()
    assert ref.dtype == got.dtype and ref.tobytes() == got.tobytes()


@pytest.mark.parametrize("warp", ["disk", "tent", "sphere", "hemisphere"])
def test_warptest_grid_lines_match_jax(warp):
    """Warps whose lattice edges map to no singularity: the cosine and
    Beckmann lines end on the hemisphere's rim, where z is the square
    root of a last-bit difference (and XLA flushes Beckmann's 1e-38
    clamp to zero at u = 1)."""
    from nori_tpu import warptest as jax_wt
    from nori_tpu_torch import warptest as wt

    ref = jax_wt.grid_lines(warp, 0.3, res=4)
    got = wt.grid_lines(warp, 0.3, res=4)
    assert len(ref) == len(got) == 10
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_warptest_main_plots_and_passes(tmp_path, monkeypatch, capsys):
    """--plot writes a PNG (with the grid mode and grid lines); the chi^2
    verdict gives the exit code.  Fewer samples than the CLI's."""
    from nori_tpu_torch import warptest as wt

    monkeypatch.setattr(wt, "SAMPLE_FACTOR", 50)
    monkeypatch.setattr(wt, "RES", 11)
    out = tmp_path / "disk.png"
    assert wt.main(["disk", "--plot", str(out), "--mode", "grid",
                    "--grid-lines", "--device", "cpu"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert wt.main(["microfacet", "0.3", "--device", "cpu"]) == 0
    assert "ACCEPT" in capsys.readouterr().out
