"""Run the reference's six statistical fixtures with nori_tpu_torch as
one gate.  Counterpart of `scripts/ref_gates.py`.

The reference ships six test-mode XMLs (src/ttest.cpp:58-219,
src/chi2test.cpp:42-226 semantics), under a scenes directory ROOT:

    pa5/tests/ttest-microfacet.xml     5 t-tests
    pa5/tests/test-direct.xml         15 t-tests (scene mode)
    pa5/tests/test-furnace.xml         6 t-tests (scene mode)
    pa5/tests/chi2test-microfacet.xml 15 chi^2 tests
    pa4/tests/test-mesh.xml            5 t-tests (scene mode)
    pa4/tests/test-mesh-furnace.xml    2 t-tests (scene mode)

Each runs through the port's `load_from_xml` and the test root's
`run(verbose=True, device=...)`; on a card the scene-mode t-tests render
through the sweeps (K1, K2).  The pass counts go to REF_GATES_torch.json
at the repository root with the device they were measured on; a fixture
that is not under ROOT is recorded as missing and fails the gate.

Usage (from the repository root):
    python -m nori_tpu_torch.scripts.ref_gates [OUT] [--root ROOT]
        [--scale N] [--device cuda|cpu]

--root defaults to the directory the JAX runner's fixtures are under
(its FIXTURES, read from scripts/ref_gates.py as text), so the default
run looks where that runner looks.  --scale divides the fixtures'
sample counts (reduced strength); the furnace fixtures always run at
full strength.  Exit code 0 when every fixture passes, 1 otherwise, 2
without a CUDA device unless --device cpu is asked for.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_JSON = os.path.join(REPO, "REF_GATES_torch.json")
JAX_RUNNER = os.path.join(REPO, "scripts", "ref_gates.py")

FIXTURES = (
    "pa5/tests/ttest-microfacet.xml",
    "pa5/tests/test-direct.xml",
    "pa5/tests/test-furnace.xml",
    "pa5/tests/chi2test-microfacet.xml",
    "pa4/tests/test-mesh.xml",
    "pa4/tests/test-mesh-furnace.xml",
)


def jax_runner_root(path: str = JAX_RUNNER) -> str | None:
    """The scenes directory the JAX runner's FIXTURES lie under (the
    parent of their pa4/ and pa5/), or None without that script."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "FIXTURES" for t in node.targets):
            # each is ROOT/paN/tests/<name>.xml
            roots = {os.path.dirname(os.path.dirname(os.path.dirname(p)))
                     for p in ast.literal_eval(node.value)}
            return roots.pop() if len(roots) == 1 else None
    return None


def run_fixture(path: str, scale: int = 1, device=None) -> dict:
    """Run one test-mode XML on `device`: {"ok", "passed", "total",
    "seconds"}, or {"error"} when its root is not a test."""
    from nori_tpu_torch import load_from_xml, registry

    t0 = time.time()
    root = load_from_xml(path)
    if root.class_kind != registry.TEST:
        return {"error": f"not a test fixture: kind={root.class_kind}"}
    if scale > 1 and hasattr(root, "sample_count") \
            and "furnace" not in os.path.basename(path):
        # reduced strength: fewer samples only reduce the statistical
        # power of the light-tailed fixtures, and the t-test and chi^2
        # thresholds hold at any N (bins below minExpFrequency are
        # pooled).  The furnace fixtures are exempt: their a = 0.8
        # estimator is heavy-tailed and its prefix means converge from
        # below (the JAX runner measured 4.875 at N = 6k, 4.896 at 12k,
        # 4.906 at 25k and 4.935 at 50k against 5.0), so a reduced run
        # rejects wrongly where the full 100k passes: they always run at
        # full strength.
        root.sample_count = max(1000, int(root.sample_count) // scale)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = root.run(verbose=True, device=device)
    m = re.search(r"Passed (\d+)/(\d+)", buf.getvalue())
    passed, total = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
    return {"ok": bool(ok), "passed": passed, "total": total,
            "seconds": round(time.time() - t0, 1)}


def main(argv=None, fixtures=FIXTURES) -> int:
    """The command line; `fixtures` are the XMLs' paths under --root."""
    ap = argparse.ArgumentParser(prog="ref_gates")
    ap.add_argument("out", nargs="?", default=OUT_JSON)
    ap.add_argument("--root", default=None,
                    help="directory holding pa4/ and pa5/ (default: the "
                         "JAX runner's)")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide fixture sample counts (reduced strength)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; no fallback)")
    args = ap.parse_args(argv)

    import torch

    from nori_tpu_torch.bench import card

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ref_gates: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2
    root = args.root or jax_runner_root()
    if root is None:
        ap.error("no --root given and no scripts/ref_gates.py to take "
                 "it from")
    results = {}
    for rel in fixtures:
        name, path = os.path.basename(rel), os.path.join(root, rel)
        if not os.path.exists(path):
            results[name] = {"error": "fixture missing from checkout"}
        else:
            try:
                results[name] = run_fixture(path, args.scale, device)
            except Exception as e:  # record, keep gating the rest
                results[name] = {"error": str(e)}
        r = results[name]
        print(f"{name}: "
              + (f"{r['passed']}/{r['total']} "
                 f"({'OK' if r['ok'] else 'FAIL'}, {r['seconds']}s)"
                 if "ok" in r else f"ERROR {r['error']}"), flush=True)
    all_ok = all(r.get("ok") for r in results.values())
    artifact = {"device": card(device), "root": root, "scale": args.scale,
                "all_ok": all_ok, "fixtures": results}
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"{'ALL GATES PASS' if all_ok else 'GATE FAILURES'} "
          f"-> {args.out}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
