"""Milliseconds per wavefront step: the window images' render seconds
(the driver's host clock) over their steps."""


def read(ctx):
    steps = sum(im.get("steps") or 0 for im in ctx["images"])
    if not steps:
        return None
    return 1e3 * sum(im["seconds"] for im in ctx["images"]) / steps
