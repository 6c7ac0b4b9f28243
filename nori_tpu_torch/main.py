"""CLI entry point: `python -m nori_tpu_torch <scene.xml | test.xml |
image.exr>`.

Port of `nori_tpu/main.py` (src/main.cpp:153-211): an XML argument
loads and either renders (root = scene, any integrator, to <out>.exr
and <out>.png) or runs a statistical test suite (root = test: chi2test
or ttest; exit code 0 when every test passes, else 1); an EXR argument
is tonemapped to PNG at 2^exposure (the viewer, or --view for the
terminal one).  --device picks the torch device of renders and tests.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nori_tpu_torch")
    ap.add_argument("input", help="scene or test .xml, or image .exr")
    ap.add_argument("--spp", type=int, default=None,
                    help="override sample count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default=None, help="output basename")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--preview", action="store_true",
                    help="write <out>_preview.png after every chunk")
    ap.add_argument("--checkpoint", action="store_true",
                    help="dump/resume render state at <out>.ckpt after "
                         "every chunk (path-family integrators)")
    ap.add_argument("--exposure", type=float, default=0.0,
                    help="EXR viewer mode: scale by 2^exposure before "
                         "the sRGB tonemap (the GUI slider, "
                         "src/gui.cpp:36-42)")
    ap.add_argument("--view", action="store_true",
                    help="terminal display: live half-block film view "
                         "while rendering, interactive exposure-key "
                         "viewer for .exr input (src/gui.cpp:19-132)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a CUDA "
                         "device a render or test raises unless this is "
                         "cpu)")
    args = ap.parse_args(argv)

    ext = os.path.splitext(args.input)[1].lower()
    if ext == ".exr":
        from nori_tpu_torch.bitmap import read_exr, write_png

        img = read_exr(args.input) * (2.0 ** args.exposure)
        out = args.output or os.path.splitext(args.input)[0]
        if args.view:
            from nori_tpu_torch.tui import interactive

            interactive(img, save_base=out + "_view")
            return 0
        write_png(out + ".png", img)
        print(f"Wrote {out}.png")
        return 0
    if ext != ".xml":
        print("Fatal error: unknown file type, expected .xml or .exr")
        return 1

    from nori_tpu_torch import load_from_xml, registry
    from nori_tpu_torch.registry import NoriError
    from nori_tpu_torch.render import render_to_files

    # NoriException-style fatal handling (src/main.cpp:196-199)
    try:
        root = load_from_xml(args.input)
        if root.class_kind == registry.TEST:
            return 0 if root.run(device=args.device) else 1
        if root.class_kind != registry.SCENE:
            raise NoriError(f"root object of kind '{root.class_kind}' "
                            "cannot be executed")
        out = args.output or os.path.splitext(args.input)[0]
        if not args.quiet:
            print(root.to_string())
        img, stats = render_to_files(
            root, out, spp=args.spp, seed=args.seed,
            verbose=not args.quiet and not args.view, device=args.device,
            preview=args.preview, checkpoint=args.checkpoint,
            view=args.view)
    except (NoriError, FileNotFoundError) as e:
        print(f"Fatal error: {e}")
        return 1
    if args.view:
        from nori_tpu_torch.tui import interactive

        # keep the finished film on screen with the exposure keys
        interactive(img, save_base=out + "_view")
    print(
        f"Rendered {stats['pixels']} px x {stats['spp']} spp in "
        f"{stats['seconds']:.2f}s on {stats['device']} "
        f"({stats['samples_per_sec'] / 1e6:.2f} Msamples/s, "
        f"{stats['mrays_per_sec']:.2f} Mrays/s) -> {out}.exr / {out}.png"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
