"""CLI entry point: `python -m nori_tpu_torch scene.xml [-o out]`.

Port of `nori_tpu/main.py` for scene rendering (src/main.cpp:153-211):
an XML argument loads and renders the scene, with any integrator, to
<out>.exr and <out>.png.  Statistical test suites and EXR viewing are
not ported yet and fail with a clear error.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nori_tpu_torch")
    ap.add_argument("input", help="scene .xml")
    ap.add_argument("--spp", type=int, default=None,
                    help="override sample count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default=None, help="output basename")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a CUDA "
                         "device the render raises unless this is cpu)")
    args = ap.parse_args(argv)

    if os.path.splitext(args.input)[1].lower() != ".xml":
        print("Fatal error: expected a scene .xml (EXR viewing is not yet "
              "ported to nori_tpu_torch)")
        return 1

    from nori_tpu_torch import load_from_xml, registry
    from nori_tpu_torch.registry import NoriError
    from nori_tpu_torch.render import render_to_files

    try:
        root = load_from_xml(args.input)
        if root.class_kind != registry.SCENE:
            raise NoriError(f"root object of kind '{root.class_kind}' is "
                            "not yet supported by nori_tpu_torch")
        out = args.output or os.path.splitext(args.input)[0]
        if not args.quiet:
            print(root.to_string())
        img, stats = render_to_files(
            root, out, spp=args.spp, seed=args.seed,
            verbose=not args.quiet, device=args.device)
    except (NoriError, FileNotFoundError) as e:
        print(f"Fatal error: {e}")
        return 1
    print(
        f"Rendered {stats['pixels']} px x {stats['spp']} spp in "
        f"{stats['seconds']:.2f}s on {stats['device']} "
        f"({stats['samples_per_sec'] / 1e6:.2f} Msamples/s, "
        f"{stats['mrays_per_sec']:.2f} Mrays/s) -> {out}.exr / {out}.png"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
