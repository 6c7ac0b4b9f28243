"""Pixel samples of every image finished in the window over the
window's wall time (host clock, whole images)."""


def read(ctx):
    n = len(ctx["images"])
    if not n or ctx["window_s"] <= 0:
        return None
    return n * ctx["samples_per_image"] / ctx["window_s"]
