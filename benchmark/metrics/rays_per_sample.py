"""Rays traced per pixel sample over the window's images (a count)."""


def read(ctx):
    n = len(ctx["images"])
    if not n:
        return None
    return sum(im["rays"] for im in ctx["images"]) / (
        n * ctx["samples_per_image"])
