"""Rays traced (closest hit and shadow, the driver's device count) per
second of render time over the window's images, in millions."""


def read(ctx):
    secs = sum(im["seconds"] for im in ctx["images"])
    if secs <= 0:
        return None
    return sum(im["rays"] for im in ctx["images"]) / secs / 1e6
